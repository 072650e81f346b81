"""Port parity of the cross-replica reduction: the int8 block-scaled codec
(``quant.compression``), the tile container (``quant.int8``), the dense
and compressed all-reduce (``dist.collectives``) and the mesh builders
(``launch.mesh``), against the JAX package on the CPU.

The codec, the tile quantizer and every path with no collective (no axes,
``num_replicas`` None, 1 or 4) are elementwise and deterministic: bitwise
the JAX package's.  The multi-rank paths run on 4 spawned ``gloo`` ranks
(a ``file://`` store, one intra-op thread a rank) against the JAX
package's 4-device run in a subprocess
(``--xla_force_host_platform_device_count=4``).  Their sums reduce four
f32 values in another order than XLA's, so they are held to f32
reassociation: |d| <= 4 * 2^-23 * sum_r |x_r| an element.  Every rank
gets the same result bitwise (``compressed_psum`` sums the same gathered
bytes in replica order; the dense sum is gloo's all-reduce).
"""
import concurrent.futures
import inspect
import os
import pathlib
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.collectives import compressed_psum as j_compressed_psum
from repro.quant import compression as JC
from repro.quant import int8 as JI
from repro_torch.dist import collectives as TC
from repro_torch.launch import mesh as TM
from repro_torch.quant import compression as CC
from repro_torch.quant import int8 as TI

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
ULP = 2.0 ** -23


def _bitwise(t, j):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, (t.dtype, j.dtype)
    np.testing.assert_array_equal(t.reshape(-1).view(np.uint8),
                                  j.reshape(-1).view(np.uint8))


# ---------------------------------------------------------------------------
# The codec and the tile container, bitwise
# ---------------------------------------------------------------------------

def _codec_inputs():
    rng = np.random.default_rng(3)
    ragged = (rng.standard_normal(3 * CC.BLOCK + 17) * 5.0).astype(np.float32)
    zero_block = rng.standard_normal((3, 300)).astype(np.float32)
    zero_block.reshape(-1)[CC.BLOCK:2 * CC.BLOCK] = 0.0
    # values at the rounding ties of their block's scale
    ties = np.arange(-130, 131, dtype=np.float32) * 0.5
    return {"ragged": ragged, "zero_block": zero_block, "ties": ties}


@pytest.mark.parametrize("name", ["ragged", "zero_block", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codec_is_bitwise_the_jax_codec(name, dtype):
    x = _codec_inputs()[name]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.to(torch.float32).numpy()).astype(getattr(jnp, dtype))
    tp, ts = CC.compress_int8(tx)
    jp, js = JC.compress_int8(jx)
    _bitwise(tp, jp)
    _bitwise(ts, js)
    if name == "zero_block":
        assert float(ts[1]) == 1.0
    out_t = CC.decompress_int8(tp, ts, x.shape, torch.float32)
    out_j = JC.decompress_int8(jp, js, x.shape, jnp.float32)
    _bitwise(out_t, out_j)
    assert CC.decompress_int8(tp, ts, x.shape, tx.dtype).dtype == tx.dtype
    assert CC.quantized_allreduce_bytes(x.size) == \
        JC.quantized_allreduce_bytes(x.size)


@pytest.mark.parametrize("n", [None, 1, 4])
def test_compressed_psum_without_axes_is_bitwise(n):
    x = np.random.default_rng(2).standard_normal((40, 9)).astype(np.float32)
    got = TC.compressed_psum(torch.from_numpy(x), (), num_replicas=n)
    _bitwise(got, j_compressed_psum(jnp.asarray(x), (), num_replicas=n))
    # and the dense reduction with no axes is the input itself
    _bitwise(TC.dense_psum(torch.from_numpy(x)), x)


@pytest.mark.parametrize("shape,bits", [
    ((300, 200), None), ((300, 200), (2, 5)), ((128, 128), (1, 6)),
    ((7, 130), (4, 10)), ((257, 3), None)])
def test_tile_quantizer_is_bitwise_the_jax_one(shape, bits):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    x[:64, :64] = 0.0                      # an all-zero tile where it fits
    tq = TI.quantize_int8_tiles(torch.from_numpy(x), *(bits or (None, None)))
    jq = JI.quantize_int8_tiles(jnp.asarray(x), *(bits or (None, None)))
    _bitwise(tq.payload, jq.payload)
    _bitwise(tq.scales, jq.scales)
    assert (tq.shape, tq.tile) == (jq.shape, jq.tile)
    _bitwise(tq.dequantize(), jq.dequantize())


@pytest.mark.parametrize("i,f", [(2, 12), (1, 6), (4, 10), (0, 7), (3, 3)])
def test_fxp_int8_scale_and_bounds_match(i, f):
    _bitwise(TI.fxp_int8_scale(i, f), JI.fxp_int8_scale(i, f))
    _bitwise(TI.fxp_int8_scale(torch.tensor(i), torch.tensor(f)),
             JI.fxp_int8_scale(jnp.int32(i), jnp.int32(f)))
    for t, j in zip(TI.fxp_int8_bounds(i, f), JI.fxp_int8_bounds(i, f)):
        _bitwise(t, j)


def test_a_named_axis_with_no_process_group_raises():
    """Naming axes with no process group (or no mesh) does not skip the
    reduction."""
    x = torch.ones(5)
    for fn in (TC.compressed_psum, TC.dense_psum):
        with pytest.raises(RuntimeError, match="needs a process group"):
            fn(x, ("data",))
    with pytest.raises(RuntimeError, match="needs a process group"):
        TC.compressed_psum(x, ("data",), num_replicas=1)
    with pytest.raises(RuntimeError, match="needs the process group"):
        TM.make_debug_mesh(1, 1)


def test_mesh_rules_without_a_process_group():
    assert TM._check_pipe(2, 256, 16) == 8
    for bad in (0, 3):
        with pytest.raises(ValueError):
            TM._check_pipe(bad, 256, 16)
    assert TM.pipe_axis_size(None) == 1


# ---------------------------------------------------------------------------
# 4 gloo ranks against JAX's 4-device run
# ---------------------------------------------------------------------------

RANK_PRELUDE = """
import sys
sys.path.insert(0, {src!r})
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + sys.argv[4],
                        world_size=WORLD, rank=RANK)
"""


def run_ranks(code: str, tmp_path, world: int = WORLD, timeout=300) -> list:
    """Run ``code`` (after ``RANK_PRELUDE``: RANK, WORLD, OUT, an
    initialised gloo group) in ``world`` spawned processes; each saves its
    results with ``np.savez(OUT, ...)``.  Returns each rank's results."""
    script = tmp_path / "rank.py"
    script.write_text(RANK_PRELUDE.format(src=str(ROOT / "src"))
                      + textwrap.dedent(code) + "\ndist.destroy_process_group()\n")
    store = tmp_path / "store"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp_path / f"rank{r}.npz"), str(store)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-3000:] for e in errs)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def run_jax(code: str, tmp_path, devices: int = WORLD, timeout=600) -> dict:
    """Run ``code`` in a JAX subprocess with ``devices`` host devices; it
    saves its results with ``np.savez(OUT, ...)``."""
    out = tmp_path / "jax.npz"
    env = dict(os.environ, PYTHONPATH=f"{ROOT/'src'}:{ROOT/'tests'}",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", f"OUT = {str(out)!r}\n"
                          + textwrap.dedent(code)], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(out))


def _per_rank(rank: int) -> dict:
    """Each rank's own values, and the replicated tree every rank holds."""
    rng = np.random.default_rng(10 + rank)
    shared = np.random.default_rng(99)
    return {"w": (rng.standard_normal((64, 24)) * (rank + 1)).astype(
                np.float32),
            "v": rng.standard_normal(3 * 256 + 5).astype(np.float32),
            "rep_w": shared.standard_normal((32, 16)).astype(np.float32),
            "rep_v": np.linspace(-2.0, 2.0, 300, dtype=np.float32)}


COLLECTIVE_RANKS = """
from repro_torch.dist import collectives as C
from repro_torch.launch import mesh as M
mine = {k: torch.from_numpy(v) for k, v in _per_rank(RANK).items()}
rep = {"w": mine["rep_w"], "v": {"x": mine["rep_v"]}}
mesh = M.make_mesh((WORLD,), ("data",))
out = {}
for name, fn in (("dense", C.dense_psum_tree),
                 ("comp", C.compressed_psum_tree)):
    t = fn(rep, mesh, ("data",))
    out[name + "_rep_w"], out[name + "_rep_v"] = t["w"], t["v"]["x"]
with C.mesh_ctx(mesh):
    for k in ("w", "v"):
        out["dense_" + k] = C.dense_psum(mine[k], ("data",))
        out["comp_" + k] = C.compressed_psum(mine[k], ("data",))
        out["comp1_" + k] = C.compressed_psum(mine[k], ("data",),
                                              num_replicas=1)
# two dimensions: the pairs of a 2 x 2 mesh, and all four through both
grid = M.make_debug_mesh(2, 2)
out["data2"] = C.dense_psum(mine["w"], ("data",), mesh=grid)
out["model2"] = C.compressed_psum(mine["w"], ("model",), mesh=grid)
out["both2"] = C.dense_psum(mine["w"], ("data", "model"), mesh=grid)
out["both2_comp"] = C.compressed_psum(mine["w"], ("data", "model"),
                                      mesh=grid)
out["axes"] = np.array([",".join(grid.mesh_dim_names),
                        ",".join(M.batch_axes(grid))])
out["sizes"] = np.array([M.model_axis_size(grid), M.pipe_axis_size(grid)])
piped = M.make_debug_mesh(1, 2, pipe=2)
pod = M.make_debug_mesh(1, 1, pod=2, pipe=2)
out["piped"] = np.array([",".join(piped.mesh_dim_names),
                         ",".join(pod.mesh_dim_names),
                         ",".join(M.batch_axes(pod))])
out["piped_sizes"] = np.array([M.pipe_axis_size(piped),
                               M.model_axis_size(piped),
                               M.pipe_axis_size(pod)])
np.savez(OUT, **{k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                 for k, v in out.items()})
"""

COLLECTIVE_JAX = """
import jax, jax.numpy as jnp, numpy as np
from jax import lax
from jax.sharding import PartitionSpec as P
from repro.dist.collectives import (compressed_psum, compressed_psum_tree,
                                    dense_psum_tree)
mesh = jax.make_mesh((WORLD,), ("data",))
ranks = [_per_rank(r) for r in range(WORLD)]
rep = {"w": jnp.asarray(ranks[0]["rep_w"]),
       "v": {"x": jnp.asarray(ranks[0]["rep_v"])}}
out = {}
for name, fn in (("dense", dense_psum_tree), ("comp", compressed_psum_tree)):
    t = fn(rep, mesh, ("data",))
    out[name + "_rep_w"], out[name + "_rep_v"] = t["w"], t["v"]["x"]
for k in ("w", "v"):
    xs = jnp.stack([jnp.asarray(r[k]) for r in ranks])
    for name, f in (("dense", lambda x: lax.psum(x, "data")),
                    ("comp", lambda x: compressed_psum(x, ("data",)))):
        run = jax.shard_map(lambda x, f=f: f(x[0])[None], mesh=mesh,
                            in_specs=P("data"), out_specs=P("data"),
                            check_vma=False)
        out[name + "_" + k] = run(xs)
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("collectives")
    (root / "t").mkdir()
    (root / "j").mkdir()
    data = inspect.getsource(_per_rank)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        jax_run = ex.submit(run_jax, f"WORLD = {WORLD}\n" + data
                            + COLLECTIVE_JAX, root / "j")
        ranks = ex.submit(run_ranks, data + COLLECTIVE_RANKS, root / "t")
        return ranks.result(), jax_run.result()


def _within_reassociation(got, want, parts):
    bound = WORLD * ULP * np.sum(np.abs(np.stack(parts)), axis=0)
    err = np.abs(got - want)
    assert np.all(err <= bound), (err.max(), bound.max())


def test_four_rank_psums_match_jax(collective_runs):
    ranks, jax_out = collective_runs
    mine = [_per_rank(r) for r in range(WORLD)]
    for name in ("dense_rep_w", "dense_rep_v", "comp_rep_w", "comp_rep_v",
                 "dense_w", "dense_v", "comp_w", "comp_v"):
        for r in range(WORLD):
            # the same result on every rank, bitwise
            _bitwise(ranks[r][name], ranks[0][name])
        want = jax_out[name]
        if name.endswith(("_w", "_v")) and "rep" not in name:
            want = want[0]                 # replica 0's row of the stack
        k = name.split("_")[-1]
        parts = [m[k] for m in mine]
        if "rep" in name:
            parts = [mine[0]["rep_" + k]] * WORLD
        if name.startswith("comp"):
            parts = [CC.decompress_int8(*CC.compress_int8(torch.from_numpy(
                x)), x.shape).numpy() for x in parts]
        _within_reassociation(ranks[0][name], want, parts)
        if name.startswith("comp"):
            # the compressed sum is the replicas' codec round trips summed
            _within_reassociation(ranks[0][name], np.sum(parts, axis=0),
                                  parts)


def test_one_replica_of_a_named_axis_is_the_codec_round_trip(
        collective_runs):
    ranks, _ = collective_runs
    for r, got in enumerate(ranks):
        for k in ("w", "v"):
            x = torch.from_numpy(_per_rank(r)[k])
            _bitwise(torch.from_numpy(got["comp1_" + k]),
                     TC.compressed_psum(x, (), num_replicas=1))


def test_two_dimension_groups_and_the_mesh_rules(collective_runs):
    """A 2 x 2 ("data", "model") mesh: rank 2d + m.  "data" pairs ranks
    {m, 2 + m}, "model" pairs {2d, 2d + 1}, both reduce all four."""
    ranks, _ = collective_runs
    w = [_per_rank(r)["w"] for r in range(WORLD)]
    dec = [CC.decompress_int8(*CC.compress_int8(torch.from_numpy(x)),
                              x.shape).numpy() for x in w]
    for r, got in enumerate(ranks):
        d, m = divmod(r, 2)
        data = [w[m], w[2 + m]]
        model = [dec[2 * d], dec[2 * d + 1]]
        _within_reassociation(got["data2"], data[0] + data[1], data)
        _within_reassociation(got["model2"], model[0] + model[1], model)
        _within_reassociation(got["both2"], np.sum(w, axis=0), w)
        _within_reassociation(got["both2_comp"], np.sum(dec, axis=0), dec)
        _bitwise(got["both2"], ranks[0]["both2"])
        assert got["axes"].tolist() == ["data,model", "data"]
        assert got["sizes"].tolist() == [2, 1]
        assert got["piped"].tolist() == ["pipe,data,model",
                                         "pod,pipe,data,model", "pod,data"]
        assert got["piped_sizes"].tolist() == [2, 2, 2]
