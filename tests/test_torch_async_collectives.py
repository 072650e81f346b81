"""Port parity of the overlapped reduce's transports
(``dist.async_collectives``) against the JAX package on the CPU.

Single process: the transport autotuner (cache, ``REPRO_TRANSPORT``, the
model where nothing can be measured, a group of one), its snapshots (the
JAX package's key strings, cross-loaded both ways), the no-axes identity
handles (bitwise JAX's), the tree API, ``group_size`` and
``overlap_depth_for``.

4 spawned ``gloo`` ranks (``test_torch_collectives.run_ranks``) against
the JAX package's 4 host devices (one JAX subprocess for the whole file).
JAX's compressed ring is run op by op (``jax.disable_jit``, the axis
bound by ``jax.vmap(axis_name="data")``, bitwise its eager ``shard_map``
and 6x faster): jitted, XLA turns the codec's ``absmax / 127`` into a
multiply by the f32 reciprocal and contracts the decompress-and-add into
an FMA (2740 of 4 x 2048 outputs an ulp or more apart), while the port's
codec is bitwise JAX's op-by-op codec (``test_torch_collectives``):

  * the dense ring (one bucket and 3) and the compressed ring are
    BITWISE JAX's rings: the same segments, padding, add order and codec;
  * the compressed ring is within ``(2g-2) * max_block_absmax / 254`` of
    ``compressed_psum`` (JAX's own bound, with its x2 slack for partial
    sums above the final sum's absmax);
  * the ``scatter`` chunk functions and the ``psum`` transport are
    within f32 reassociation, ``4 * 2^-23 * sum_r |x_r|``, of JAX's
    (gloo sums in another order than XLA); ``shard_chunk`` is a slice,
    bitwise;
  * every rank ends with the same bits;
  * a collective ``prime_transport_cache`` (over all 4 ranks and over
    the first 2) leaves the same decisions on every rank.
"""
import concurrent.futures
import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.taxonn import QuantPolicy as JQuantPolicy
from repro.core.taxonn import overlap_depth_for as j_overlap_depth_for
from repro.dist import async_collectives as JA
from repro_torch.core.taxonn import QuantPolicy, overlap_depth_for
from repro_torch.dist import async_collectives as TA
from repro_torch.dist.collectives import compressed_psum
from repro_torch.quant.compression import BLOCK
from test_torch_collectives import WORLD, _bitwise, run_jax, run_ranks
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)

ULP = 2.0 ** -23


@pytest.fixture(autouse=True)
def _fresh_caches():
    TA.clear_transport_cache()
    JA.clear_transport_cache()
    yield
    TA.clear_transport_cache()
    JA.clear_transport_cache()


def test_every_public_name_of_the_jax_module_is_ported():
    """The port has each function, class and constant the JAX module
    defines (its imports and ``Array`` aside)."""
    names = [n for n, v in vars(JA).items()
             if not n.startswith("_") and n != "Array"
             and (getattr(v, "__module__", None) == JA.__name__
                  or (n.isupper() and isinstance(v, (int, tuple))))]
    assert {"ring_all_reduce", "AsyncHandle", "TRANSPORTS",
            "tree_all_reduce_wait"} <= set(names)
    missing = [n for n in names if not hasattr(TA, n)]
    assert not missing, missing
    for n in ("BUCKET_BYTES", "MAX_BUCKETS", "TRANSPORTS", "RING_MIN_BYTES"):
        assert getattr(TA, n) == getattr(JA, n)


# ---------------------------------------------------------------------------
# decide_transport: cache, override, model
# ---------------------------------------------------------------------------

def test_decision_is_cached_and_stable():
    first = TA.decide_transport(4 << 20, 4)
    assert first in TA.TRANSPORTS
    assert len(TA.transport_cache_snapshot()) == 1
    for _ in range(5):
        assert TA.decide_transport(4 << 20, 4) == first
    # same power-of-two bucket: a cache hit, no new entry
    assert TA.decide_transport((4 << 20) - 128, 4) == first
    assert len(TA.transport_cache_snapshot()) == 1
    # another group size is another key
    TA.decide_transport(4 << 20, 2)
    assert len(TA.transport_cache_snapshot()) == 2
    assert TA._size_bucket(1) == JA._size_bucket(1) == 4096
    for n in (4097, 1 << 20, (1 << 20) + 1):
        assert TA._size_bucket(n) == JA._size_bucket(n)
    for nb, k in ((0, None), (3 << 20, None), (64 << 20, None), (5, 3),
                  (5, 0)):
        assert TA._num_buckets(nb, k) == JA._num_buckets(nb, k)


def test_repro_transport_override(monkeypatch):
    assert TA.decide_transport(1 << 20, 4) in ("psum", "scatter")
    for forced in TA.TRANSPORTS:
        monkeypatch.setenv("REPRO_TRANSPORT", forced)
        assert TA.decide_transport(1 << 20, 4) == forced
    # the compressed wire format has no scatter split
    assert TA.decide_transport(1 << 20, 4, compressed=True) == "psum"
    monkeypatch.setenv("REPRO_TRANSPORT", "auto")
    assert TA.decide_transport(1 << 20, 4) in TA.TRANSPORTS
    monkeypatch.setenv("REPRO_TRANSPORT", "carrier-pigeon")
    with pytest.raises(ValueError, match="REPRO_TRANSPORT"):
        TA.decide_transport(1 << 20, 4)


def test_model_decides_where_nothing_can_be_measured():
    """No process group here, and the step's own resolution never
    measures: the CPU model gives scatter for dense payloads and psum for
    the compressed format, as JAX's model on its CPU backend."""
    for allow in (False, True):
        TA.clear_transport_cache()
        assert TA.decide_transport(8192, 4, allow_measure=allow) == "scatter"
        assert TA.decide_transport(8192, 4, compressed=True,
                                   allow_measure=allow) == "psum"
        snap = TA.transport_cache_snapshot()
        assert all(v["source"] == "model" and v["us"] == {}
                   for v in snap.values())
    assert TA._model_transport(8192, 4) == JA._model_transport(8192, 4)
    assert TA._resolve_transport("auto", 1 << 22, 4, False) == "scatter"
    assert TA._resolve_transport("scatter", 8, 4, True) == "psum"


def test_single_member_group_is_psum_no_cache():
    assert TA.decide_transport(4 << 20, 1) == "psum"
    assert TA.transport_cache_snapshot() == {}
    leaves = [torch.zeros(64, 64), torch.zeros(3)]
    assert TA.resolve_leaf_transports(leaves, ("data",), num_replicas=1,
                                      transport="ring") == ["psum", "psum"]
    assert TA.resolve_leaf_transports(leaves, ()) == ["psum", "psum"]
    assert TA.transport_cache_snapshot() == {}


def test_prime_and_dump_cache(tmp_path):
    out = TA.prime_transport_cache([1 << 16, (1 << 16) - 5, 1 << 20], g=2)
    assert set(out.values()) <= set(TA.TRANSPORTS)
    assert sorted(out) == [1 << 16, 1 << 20]
    path = tmp_path / "sub" / "cache.json"
    TA.dump_transport_cache(str(path))
    data = json.loads(path.read_text())
    assert data == TA.transport_cache_snapshot()
    assert sorted(data) == ["compressed=False,bytes=1048576,g=2",
                            "compressed=False,bytes=65536,g=2"]
    TA.clear_transport_cache()
    assert TA.load_transport_cache(data) == 2
    assert {k: v["transport"] for k, v in
            TA.transport_cache_snapshot().items()} == {
        k: v["transport"] for k, v in data.items()}
    assert all(v["source"] == "restored:model"
               for v in TA.transport_cache_snapshot().values())
    # installed entries win unless overwritten; malformed ones are skipped
    assert TA.load_transport_cache(data) == 0
    assert TA.load_transport_cache(data, overwrite=True) == 2
    assert TA.load_transport_cache({"nonsense": {}, "compressed=True,"
                                    "bytes=8192,g=4": {"transport": "tcp"},
                                    "compressed=True,bytes=x,g=4": {}}) == 0


def test_snapshots_cross_load_between_the_packages():
    """The keys are the JAX package's strings: a snapshot of either loads
    into the other with the same decisions."""
    JA.decide_transport(4 << 20, 4)
    JA.decide_transport(9000, 2, compressed=True)
    JA.load_transport_cache({"compressed=False,bytes=65536,g=8":
                             {"transport": "ring", "source": "measured",
                              "us": {"ring": 1.5, "psum": 2.0}}})
    jsnap = JA.transport_cache_snapshot()
    assert TA.load_transport_cache(jsnap) == 3
    tsnap = TA.transport_cache_snapshot()
    assert list(tsnap) == list(jsnap)
    for k, v in jsnap.items():
        assert tsnap[k]["transport"] == v["transport"]
        assert tsnap[k]["us"] == v["us"]
    # and the reverse: the port's decisions into the JAX package
    TA.clear_transport_cache()
    JA.clear_transport_cache()
    TA.decide_transport(3 << 20, 4)
    TA.decide_transport(5000, 4, compressed=True)
    TA.load_transport_cache({"compressed=True,bytes=4096,g=2":
                             {"transport": "ring", "source": "measured",
                              "us": {"ring": 3.0, "psum": 4.0}}})
    tsnap = TA.transport_cache_snapshot()
    assert JA.load_transport_cache(json.loads(json.dumps(tsnap))) == 3
    jsnap = JA.transport_cache_snapshot()
    assert list(jsnap) == list(tsnap)
    for k, v in tsnap.items():
        assert jsnap[k]["transport"] == v["transport"]
        assert JA.decide_transport(int(k.split("bytes=")[1].split(",")[0]),
                                   int(k.split("g=")[1]),
                                   compressed="True" in k) == v["transport"]


def test_invalid_transport_argument():
    with pytest.raises(ValueError, match="transport"):
        TA.all_reduce_start(torch.ones(8), ("data",), num_replicas=4,
                            transport="tcp")
    with pytest.raises(ValueError, match="transport"):
        TA.tree_all_reduce_start({"w": torch.ones(8)}, ("data",),
                                 num_replicas=4, transport="tcp")
    # axes named with no process group raise; nothing is skipped
    with pytest.raises(RuntimeError, match="needs a process group"):
        TA.all_reduce_start(torch.ones(8), ("data",), num_replicas=4,
                            transport="ring")


# ---------------------------------------------------------------------------
# identity handles, the tree API, group_size, overlap_depth_for
# ---------------------------------------------------------------------------

def test_no_axes_identity_handle_is_bitwise_jax():
    """No axes (or a group of one): wait(start(x)) is x bitwise; the
    compressed form is the codec round trip times ``num_replicas`` with
    no axes, bitwise JAX's handle."""
    x = np.random.default_rng(0).standard_normal((13, 7)).astype(np.float32)
    tx = torch.from_numpy(x)
    for axes, kw in (((), {}), ((), {"num_replicas": 1}),
                     (("data",), {"num_replicas": 1})):
        for transport in ("auto", "ring", "psum", "scatter"):
            h = TA.all_reduce_start(tx, axes, transport=transport, **kw)
            assert h.kind == "identity" and h.works == ()
            _bitwise(TA.all_reduce_wait(h), x)
    for n in (None, 1, 4):
        got = TA.all_reduce_wait(TA.all_reduce_start(
            tx, (), compressed=True, num_replicas=n))
        want = JA.all_reduce_wait(JA.all_reduce_start(
            jnp.asarray(x), (), compressed=True, num_replicas=n))
        _bitwise(got, want)
        _bitwise(got, compressed_psum(tx, (), num_replicas=n))
    assert TA.ring_all_reduce(tx) is tx


def test_tree_start_wait_roundtrip():
    tree = {"a": torch.ones(4, 4), "b": {"c": torch.arange(5.0)},
            "d": [torch.zeros(2), torch.full((3,), 2.0)]}
    handles = TA.tree_all_reduce_start(tree, ())
    assert all(isinstance(h, TA.AsyncHandle)
               for h in (handles["a"], handles["b"]["c"], handles["d"][1]))
    out = TA.tree_all_reduce_wait(handles)
    assert out["b"]["c"] is tree["b"]["c"] and isinstance(out["d"], list)
    comp = TA.tree_all_reduce_wait(TA.tree_all_reduce_start(
        tree, (), compressed=True, num_replicas=2))
    for k in ("a",):
        _bitwise(comp[k], compressed_psum(tree[k], (), num_replicas=2))


def test_group_size_resolution():
    assert TA.group_size((), None) == 1
    assert TA.group_size(("data",), 8) == 8
    with pytest.raises(ValueError, match="pass num_replicas"):
        TA.group_size(("nonexistent-axis",), None)

    class Mesh:       # the two attributes a DeviceMesh is read through
        mesh_dim_names = ("data", "model")
        shape = (2, 3)
    assert TA.group_size(("data", "model"), mesh=Mesh()) == 6
    from repro_torch.dist import mesh_ctx
    with mesh_ctx(Mesh()):
        assert TA.group_size(("model",)) == 3
        with pytest.raises(ValueError, match="'pipe' not in the ambient "
                                             "mesh \\('data', 'model'\\)"):
            TA.group_size(("pipe",))


def test_overlap_depth_clamps_to_layer_count():
    for depth, n, want in ((2, 6, 2), (2, 2, 2), (2, 1, 1), (5, 3, 3)):
        assert overlap_depth_for(QuantPolicy(overlap_depth=depth), n) == want
        assert j_overlap_depth_for(JQuantPolicy(overlap_depth=depth),
                                   n) == want
    for bad in (0, -1):
        with pytest.raises(ValueError, match="overlap_depth"):
            overlap_depth_for(QuantPolicy(overlap_depth=bad), 4)


# ---------------------------------------------------------------------------
# 4 gloo ranks against JAX's 4 host devices
# ---------------------------------------------------------------------------

def _inputs(rank: int) -> dict:
    """Each rank's own values: ragged sizes (padding), a zero block, a
    bf16 leaf."""
    rng = np.random.default_rng(40 + rank)
    w = (rng.standard_normal((37, 19)) * (rank + 1)).astype(np.float32)
    v = rng.standard_normal(3 * 256 + 5).astype(np.float32)
    v[256:512] = 0.0
    big = (rng.standard_normal((4, 2048)) * 0.1).astype(np.float32)
    return {"w": w, "v": v, "big": big}


RANKS = """
import os
from repro_torch.dist import async_collectives as A
from repro_torch.dist.collectives import compressed_psum, mesh_ctx
from repro_torch.launch.mesh import make_mesh
mine = {k: torch.from_numpy(v) for k, v in _inputs(RANK).items()}
mesh = make_mesh((WORLD,), ("data",))
out = {}
with mesh_ctx(mesh):
    for k, x in mine.items():
        out["ring_" + k] = A.ring_all_reduce(x, ("data",))
        out["ring3_" + k] = A.ring_all_reduce(x, ("data",), num_buckets=3)
        out["cring_" + k] = A.ring_all_reduce(x, ("data",), compressed=True)
        out["cpsum_" + k] = compressed_psum(x, ("data",))
        out["psum_" + k] = A.ring_all_reduce(x, ("data",), transport="psum")
        h = A.all_reduce_start(x, ("data",), transport="scatter")
        assert h.kind == "scatter" and len(h.works) == 1
        out["scatter_" + k] = A.all_reduce_wait(h)
        chunk = A.reduce_scatter_chunk(x, "data", WORLD)
        out["chunk_" + k] = chunk
        out["own_" + k] = A.shard_chunk(x, "data", WORLD)
        out["gathered_" + k] = A.all_gather_chunks(chunk, "data", WORLD,
                                                   x.shape, x.dtype)
    # handles in flight together, waited oldest first (the depth pipeline)
    hs = [A.all_reduce_start(mine[k], ("data",), transport="ring")
          for k in ("w", "v")]
    for k, h in zip(("w", "v"), hs):
        out["late_" + k] = A.all_reduce_wait(h)
    # the tree API: psum leaves in one collective, ring and scatter ones
    # alone, every transport forced and auto (the CPU model: scatter)
    for t in ("psum", "ring", "scatter", "auto"):
        tree = A.tree_all_reduce_wait(A.tree_all_reduce_start(
            {"a": mine["w"], "b": {"c": mine["v"]}}, ("data",),
            transport=t))
        out["tree_" + t + "_w"], out["tree_" + t + "_v"] = (
            tree["a"], tree["b"]["c"])
    # the mesh passed in, no ambient mesh
    out["meshkw_w"] = A.ring_all_reduce(mine["w"], ("data",), mesh=mesh)
    A.clear_transport_cache()
    dec = A.resolve_leaf_transports([mine["w"], mine["big"]], ("data",))
    os.environ["REPRO_TRANSPORT"] = "ring"
    forced = A.resolve_leaf_transports([mine["w"]], ("data",))
    del os.environ["REPRO_TRANSPORT"]
    out["model_decisions"] = np.array(dec + forced)
# the collective measurement: over all four ranks and the first two
A.clear_transport_cache()
primed = A.prime_transport_cache([1 << 14, 3 << 18], WORLD)
primed.update({-k: v for k, v in A.prime_transport_cache(
    [1 << 14], WORLD, compressed=True).items()})
primed.update({k + 1: v for k, v in
               A.prime_transport_cache([1 << 14], 2).items()})
snap = A.transport_cache_snapshot()
out["primed"] = np.array(sorted(f"{k}:{v}" for k, v in primed.items()))
out["snap"] = np.array(json.dumps(snap, sort_keys=True))
np.savez(OUT, **{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                 for k, v in out.items()})
"""

JAX = """
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.dist import async_collectives as A
from repro.dist.collectives import compressed_psum
mesh = jax.make_mesh((WORLD,), ("data",))
ranks = [_inputs(r) for r in range(WORLD)]
out = {}
fns = {
    "ring": lambda x: A.ring_all_reduce(x, ("data",), num_replicas=WORLD),
    "ring3": lambda x: A.ring_all_reduce(x, ("data",), num_replicas=WORLD,
                                         num_buckets=3),
    "cring": lambda x: A.ring_all_reduce(x, ("data",), num_replicas=WORLD,
                                         compressed=True),
    "cpsum": lambda x: compressed_psum(x, ("data",), num_replicas=WORLD),
    "psum": lambda x: lax.psum(x, "data"),
    "chunk": lambda x: A.reduce_scatter_chunk(x, "data", WORLD),
    "own": lambda x: A.shard_chunk(x, "data", WORLD),
}
for k in ranks[0]:
    xs = jnp.stack([jnp.asarray(r[k]) for r in ranks])
    for name, f in fns.items():
        if name == "cring":
            # op by op (no FMA, no reciprocal), the axis bound by vmap:
            # each primitive runs once on the 4 replicas' batch
            with jax.disable_jit():
                out[name + "_" + k] = jax.vmap(f, axis_name="data")(xs)
            continue
        run = jax.jit(jax.shard_map(lambda x, f=f: f(x[0])[None], mesh=mesh,
                                    in_specs=P("data"), out_specs=P("data"),
                                    check_vma=False))
        out[name + "_" + k] = run(xs)
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("async_collectives")
    (root / "t").mkdir()
    (root / "j").mkdir()
    head = f"import json\nWORLD = {WORLD}\n" + inspect.getsource(_inputs)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        jax_run = ex.submit(run_jax, head + JAX, root / "j")
        ranks = ex.submit(run_ranks, head + RANKS, root / "t")
        return ranks.result(), jax_run.result()


KEYS = ("w", "v", "big")


@pytest.mark.parametrize("name", ["ring", "ring3", "cring"])
def test_rings_are_bitwise_the_jax_rings(rank_runs, name):
    ranks, jax_out = rank_runs
    for k in KEYS:
        for r in range(WORLD):
            _bitwise(ranks[r][f"{name}_{k}"], jax_out[f"{name}_{k}"][r])
            _bitwise(ranks[r][f"{name}_{k}"], ranks[0][f"{name}_{k}"])
    if name == "ring":
        for r in range(WORLD):
            for k in ("w", "v"):
                # handles waited after another start, the mesh passed in
                _bitwise(ranks[r]["late_" + k], ranks[r]["ring_" + k])
            _bitwise(ranks[r]["meshkw_w"], ranks[r]["ring_w"])
            _bitwise(ranks[r]["tree_ring_w"], ranks[r]["ring_w"])
            _bitwise(ranks[r]["tree_ring_v"], ranks[r]["ring_v"])


def test_compressed_ring_within_its_bound_of_compressed_psum(rank_runs):
    ranks, jax_out = rank_runs
    g = WORLD
    for k in KEYS:
        exact = np.sum([_inputs(r)[k] for r in range(g)], axis=0)
        flat = exact.reshape(-1)
        blocks = np.pad(flat, (0, (-flat.size) % BLOCK)).reshape(-1, BLOCK)
        bound = 2 * (2 * g - 2) * np.abs(blocks).max() / 254.0
        for r in range(g):
            ring, ref = ranks[r]["cring_" + k], ranks[r]["cpsum_" + k]
            assert np.abs(ring - ref).max() <= bound
            assert np.abs(ring - exact).max() <= bound
        # the port's compressed_psum sums the same codec bytes as JAX's
        sums = [_inputs(r)[k] for r in range(g)]
        parts = [compressed_psum(torch.from_numpy(x), (), num_replicas=1)
                 .numpy() for x in sums]
        tol = g * ULP * np.sum(np.abs(parts), axis=0)
        assert np.all(np.abs(ranks[0]["cpsum_" + k]
                             - jax_out["cpsum_" + k][0]) <= tol)


def _within_reassociation(got, want, parts):
    bound = WORLD * ULP * np.sum(np.abs(np.stack(parts)), axis=0)
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()


@pytest.mark.parametrize("k", KEYS)
def test_psum_and_scatter_transports_match_jax(rank_runs, k):
    ranks, jax_out = rank_runs
    parts = [_inputs(r)[k] for r in range(WORLD)]
    want = jax_out["psum_" + k][0]
    c = -(-parts[0].size // WORLD)
    for r in range(WORLD):
        for name in ("psum", "scatter", "gathered"):
            _within_reassociation(ranks[r][f"{name}_{k}"], want, parts)
            _bitwise(ranks[r][f"{name}_{k}"], ranks[0][f"{name}_{k}"])
        if k in ("w", "v"):
            for t in ("psum", "scatter", "auto"):
                _within_reassociation(ranks[r][f"tree_{t}_{k}"], want, parts)
                _bitwise(ranks[r][f"tree_{t}_{k}"], ranks[0][f"tree_{t}_{k}"])
        # chunk r is rank r's, as JAX's device r's
        assert ranks[r]["chunk_" + k].shape == (c,)
        flat_parts = [np.pad(p.reshape(-1), (0, WORLD * c - p.size))
                      [r * c:(r + 1) * c] for p in parts]
        _within_reassociation(ranks[r]["chunk_" + k],
                              jax_out["chunk_" + k][r], flat_parts)
        _bitwise(ranks[r]["own_" + k], jax_out["own_" + k][r])


def test_model_decisions_and_the_collective_measurement(rank_runs):
    """Inside the mesh the step's resolution reads the model (CPU:
    scatter), REPRO_TRANSPORT forces it; the measured decisions are the
    same on every rank (times all-reduced with MAX), all four ranks
    measuring over g=4 and the first two over g=2."""
    ranks, _ = rank_runs
    for r in range(WORLD):
        assert ranks[r]["model_decisions"].tolist() == [
            "scatter", "scatter", "ring"]
        assert ranks[r]["primed"].tolist() == ranks[0]["primed"].tolist()
        assert str(ranks[r]["snap"]) == str(ranks[0]["snap"])
    snap = json.loads(str(ranks[0]["snap"]))
    assert sorted(snap) == [
        "compressed=False,bytes=1048576,g=4",
        "compressed=False,bytes=16384,g=2",
        "compressed=False,bytes=16384,g=4",
        "compressed=True,bytes=16384,g=4"]
    for key, v in snap.items():
        assert v["source"] == "measured"
        want = ("ring", "psum") if "True" in key else TA.TRANSPORTS
        assert sorted(v["us"]) == sorted(want)
        assert all(t > 0 for t in v["us"].values())
        assert v["transport"] == min(v["us"], key=v["us"].get)
