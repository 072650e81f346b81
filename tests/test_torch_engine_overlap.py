"""The engine's overlapped dW reduce (``QuantPolicy.overlap``,
``overlap_depth``, ``dw_transport``; ``core.taxonn``) and the stacked
update tail (``apply_stacked_updates``) against the port's blocking step
and the JAX package's engine.

One device: for the dense, hybrid, encdec and moe families (``tiny``),
``overlap="on"`` at depths 1-3, dense and ``compress_dw``, is BITWISE the
port's ``overlap="off"`` (params, state, loss; the update stays leaf by
leaf with no axes), and within the per-family engine tests' f32 rule
(``test_torch_engine_jax._grid_close(.., 2e-6, 1e-5, LR * GRID)``, loss
1e-6, grad norm 1e-5 relative) of JAX's jitted overlap-on step.

4 spawned ``gloo`` ranks against JAX's ``shard_map`` step over 4 host
devices, ``tiny("dense")`` as in ``tests/test_torch_engine_dist.py``
(``dw_psum_axes=("data",)``, ``dw_num_replicas=4``): the ring forced at
depths 1 and 2 (dense, and compressed at depth 2), ``scatter`` with
``sgd`` and no clip (the sharded update) and with momentum (the blocking
update), the fused ``psum``.  Rank 0 within 1e-5 of JAX (an (I,F) tie
may move up to 1% of a quantized leaf, ``test_torch_engine_dist._hold``;
in the compressed case a codec step, jitted JAX's codec being a
reciprocal multiply and an FMA away from its op-by-op one,
``tests/test_torch_async_collectives.py``),
the stack leaves bitwise equal across ranks.  ``apply_stacked_updates``
(off, ring, blocking psum, sharded scatter) against JAX's own, on the 4
ranks and with no axes.  The driver's transport priming runs on the
ranks over the 4-rank mesh (the gated ``launch.train.prime_transports``)
and prints JAX's ``transport autotuner (g=4): ...`` line.
"""
import concurrent.futures
import dataclasses
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QuantPolicy as JQP
from repro.core import make_train_step as j_make
from repro.core.steps import default_bits as j_bits
from repro.core.steps import init_train_state as j_init
from repro.core.taxonn import apply_stacked_updates as j_apply
from repro.models import lm as JLM
from repro.optim import Hyper as JHyper
from repro.optim import OptimizerConfig as JOCfg
from repro.optim import init_opt_state as j_opt
from repro_torch.core import (QuantPolicy, StepOptions, default_bits,
                              init_train_state, make_train_step)
from repro_torch.core.taxonn import apply_stacked_updates
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig, init_opt_state
from repro_torch.util.tree import (tree_leaves, tree_leaves_with_path,
                                   tree_unflatten)
from test_models import make_batch, tiny
from test_torch_collectives import WORLD, run_jax, run_ranks
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)
from test_torch_engine import GRID
from test_torch_engine_dist import _hold
from test_torch_engine_jax import _grid_close

LR = 0.05
FAMILIES = ("dense", "hybrid", "encdec", "moe")


def _bitwise(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


# ---------------------------------------------------------------------------
# one device
# ---------------------------------------------------------------------------

def _family(family):
    """JAX's config, the port's, JAX's initial params (numpy) and a batch."""
    jc = tiny(family)
    jp = jax.tree.map(np.asarray, jax.jit(JLM.init_params, static_argnums=1)(
        jax.random.key(0), jc))
    batch = {k: np.array(v) for k, v in make_batch(jc, t=16).items()}
    return jc, ModelConfig(**dataclasses.asdict(jc)), jp, batch


def _port_step(tc, jp, batch, **kw):
    p0 = TLM.params_from_numpy(jp, device="cpu")
    ocfg = OptimizerConfig(kind="momentum")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0, **kw), ocfg,
                           StepOptions(kernel_backend="off"), device="cpu")
    return step(p0, init_train_state(p0, ocfg), batch, Hyper(lr=LR, step=0),
                default_bits(tc))


@pytest.mark.parametrize("family", FAMILIES)
def test_one_device_overlap_is_bitwise_off_and_matches_jax(family):
    jc, tc, jp, batch = _family(family)
    for compress in (False, True):
        off_p, off_s, off_m = _port_step(tc, jp, batch, compress_dw=compress)
        for depth in (1, 2, 3):
            p, s, m = _port_step(tc, jp, batch, compress_dw=compress,
                                 overlap="on", overlap_depth=depth)
            assert all(_bitwise(a, b) for a, b in zip(
                tree_leaves((p, s)), tree_leaves((off_p, off_s)))), (
                family, compress, depth)
            assert _bitwise(m["loss"], off_m["loss"])
            assert float(m["grad_norm"]) == pytest.approx(
                float(off_m["grad_norm"]), rel=1e-6)
    # JAX's overlap-on step (depth 2, jitted) against the port's
    ocfg = JOCfg(kind="momentum")
    jparams = jax.tree.map(jnp.asarray, jp)
    step = jax.jit(j_make(jc, JQP(grad_scale=64.0, kernel_backend="off",
                                  overlap="on", overlap_depth=2), ocfg))
    ref, _, ref_m = step(jparams, j_init(jparams, ocfg),
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         JHyper(lr=jnp.float32(LR), step=jnp.int32(0)),
                         j_bits(jc))
    new, _, m = _port_step(tc, jp, batch, overlap="on", overlap_depth=2)
    assert float(m["loss"]) == pytest.approx(float(ref_m["loss"]), rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(float(ref_m["grad_norm"]),
                                                  rel=1e-5)
    leaves = tree_leaves_with_path(new)
    ref = [np.asarray(x) for x in jax.tree.leaves(ref)]
    assert len(leaves) == len(ref)
    for (k, g), r in zip(leaves, ref):
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        assert _grid_close(g, r, 2e-6, 1e-5, LR * GRID), (
            family, k, np.abs(g - r).max())


def test_overlap_options_are_checked():
    _, tc, jp, batch = _family("dense")
    with pytest.raises(ValueError, match="overlap must be 'off' or 'on'"):
        _port_step(tc, jp, batch, overlap="sometimes")
    with pytest.raises(ValueError, match="overlap"):
        StepOptions(overlap="sometimes")
    with pytest.raises(ValueError, match="transport"):
        StepOptions(transport="tcp")
    # axes named with no mesh: the group size cannot be resolved
    with pytest.raises(ValueError, match="pass num_replicas"):
        _port_step(tc, jp, batch, overlap="on", dw_psum_axes=("data",))


def _stack_dw(stack: list, rank: int) -> list:
    """Rank ``rank``'s dW for each leaf of the stack (numpy, leaf order)."""
    rng = np.random.default_rng(70 + rank)
    return [(rng.standard_normal(x.shape) * 0.1).astype(np.float32)
            for x in stack]


APPLY_CASES = {
    "off": ("momentum", dict()),
    "ring": ("momentum", dict(overlap="on", overlap_depth=2,
                              dw_transport="ring")),
    "psum": ("momentum", dict(overlap="on", dw_transport="psum")),
    "scatter": ("sgd", dict(overlap="on", dw_transport="scatter")),
}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_stacked_updates_without_axes_matches_jax(case):
    """No axes: every schedule is the layer-by-layer update, bitwise the
    port's "off", and within the f32 rule of JAX's own (strict mode: each
    update on the G grid)."""
    jc, tc, jp, _ = _family("dense")
    kind, kw = APPLY_CASES[case]
    p = TLM.params_from_numpy(jp, device="cpu")["blocks"]
    dw = tree_unflatten(p, [torch.from_numpy(x) for x in
                            _stack_dw(jax.tree.leaves(jp["blocks"]), 0)])
    ocfg = OptimizerConfig(kind=kind)
    bits = default_bits(tc)["blocks"]
    pol = QuantPolicy(quantize_updates=True, **kw)
    new, st, gsq = apply_stacked_updates(p, dw, init_opt_state(p, ocfg),
                                         bits, Hyper(lr=LR, step=0), pol,
                                         ocfg)
    off = apply_stacked_updates(p, dw, init_opt_state(p, ocfg), bits,
                                Hyper(lr=LR, step=0),
                                QuantPolicy(quantize_updates=True), ocfg)
    assert all(_bitwise(a, b) for a, b in zip(tree_leaves((new, st, gsq)),
                                              tree_leaves(off)))
    jstk = jax.tree.map(jnp.asarray, jp["blocks"])
    jdw = jax.tree.map(lambda t: jnp.asarray(t.numpy()), dw)
    jocfg = JOCfg(kind=kind)
    jnew, jst, jgsq = jax.jit(lambda a, b, c: j_apply(
        a, b, c, j_bits(jc)["blocks"],
        JHyper(lr=jnp.float32(LR), step=jnp.int32(0)),
        JQP(quantize_updates=True, **kw), jocfg))(jstk, jdw,
                                                   j_opt(jstk, jocfg))
    assert float(gsq) == pytest.approx(float(jgsq), rel=1e-5)
    for g, r in zip(tree_leaves((new, st)), jax.tree.leaves((jnew, jst))):
        assert _grid_close(g.numpy(), np.asarray(r), 2e-6, 1e-5, GRID)


# ---------------------------------------------------------------------------
# 4 gloo ranks against JAX's shard_map step
# ---------------------------------------------------------------------------

# name -> (quantized, optimizer, policy fields)
RANK_CASES = {
    "ring1": (False, "momentum", dict(overlap_depth=1, dw_transport="ring")),
    "ring2": (True, "momentum", dict(overlap_depth=2, dw_transport="ring")),
    "ring2c": (False, "momentum", dict(overlap_depth=2, dw_transport="ring",
                                       compress_dw=True)),
    "scatter_sgd": (True, "sgd", dict(dw_transport="scatter")),
    "scatter_mom": (False, "momentum", dict(dw_transport="scatter")),
    "psum": (True, "momentum", dict(dw_transport="psum")),
}


def _policy(QuantPolicy, quant: bool, **kw):
    """The step's policy (either package's ``QuantPolicy`` class)."""
    if quant:
        return QuantPolicy(grad_scale=64.0, kernel_backend="off", **kw)
    return QuantPolicy(quantize_weights=False, quantize_acts=False,
                       quantize_grads=False, kernel_backend="off", **kw)


RANKS = """
import contextlib, io
from repro_torch.configs import get_config
from repro_torch.core import QuantPolicy, make_train_step
from repro_torch.core.steps import default_bits, init_train_state
from repro_torch.core.taxonn import apply_stacked_updates
from repro_torch.dist import async_collectives as A
from repro_torch.dist import mesh_ctx
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig, init_opt_state
from repro_torch.util.tree import tree_leaves, tree_unflatten
cfg = ModelConfig(**CFG)
d = np.load(IN)
template = lm.init_params(cfg, device="cpu")
n = len(tree_leaves(template))
p0 = tree_unflatten(template, [torch.from_numpy(d[f"p{i}"])
                               for i in range(n)])
rows = slice(RANK * 8 // WORLD, (RANK + 1) * 8 // WORLD)
batch = {k: d[k][rows] for k in ("tokens", "labels")}
mesh = make_mesh((WORLD,), ("data",))
out = {}
with mesh_ctx(mesh):
    for name, (quant, kind, kw) in CASES.items():
        ocfg = OptimizerConfig(kind=kind)
        pol = _policy(QuantPolicy, quant, overlap="on",
                      dw_psum_axes=("data",), dw_num_replicas=WORLD, **kw)
        step = make_train_step(cfg, pol, ocfg, device="cpu")
        p, _, m = step(p0, init_train_state(p0, ocfg), batch,
                       Hyper(lr=LR, step=0), default_bits(cfg, quant))
        out[name + "loss"] = m["loss"].numpy()
        out[name + "gnorm"] = m["grad_norm"].numpy()
        for i, x in enumerate(tree_leaves(p)):
            out[f"{name}p{i}"] = x.numpy()
    # the stacked update tail, each rank's own dW
    stk = p0["blocks"]
    dw = tree_unflatten(stk, [torch.from_numpy(d[f"dw{RANK}_{i}"])
                              for i in range(len(tree_leaves(stk)))])
    bits = default_bits(cfg)["blocks"]
    for name, (kind, kw) in APPLY.items():
        ocfg = OptimizerConfig(kind=kind)
        pol = QuantPolicy(quantize_updates=True, dw_psum_axes=("data",),
                          dw_num_replicas=WORLD, **kw)
        new, st, gsq = apply_stacked_updates(
            stk, dw, init_opt_state(stk, ocfg), bits, Hyper(lr=LR, step=0),
            pol, ocfg)
        out["apply_" + name + "gsq"] = gsq.numpy()
        for i, x in enumerate(tree_leaves((new, st))):
            out[f"apply_{name}{i}"] = x.numpy()
# the driver's gated priming over the 4-rank mesh
rcfg = train._reduce(get_config("qwen1.5-0.5b"))
rparams = lm.init_params(rcfg, device="cpu")
parse = train._parser().parse_args
A.clear_transport_cache()
gates = [train.prime_transports(parse(a), rcfg, rparams, n)
         for a, n in ((["--overlap", "on"], 1), ([], WORLD),
                      (["--overlap", "on", "--transport", "ring"], WORLD))]
assert gates == [None, None, None] and A.transport_cache_snapshot() == {}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    decided = train.prime_transports(parse(["--overlap", "on"]), rcfg,
                                     rparams, WORLD)
out["prime_line"] = np.array(buf.getvalue())
out["prime_snap"] = np.array(repr(sorted(
    (k, v["transport"], v["source"]) for k, v in
    A.transport_cache_snapshot().items())))
out["prime_sizes"] = np.array(sorted({x[0].numel() * 4 for x in
                                      tree_leaves(rparams["blocks"])}))
np.savez(OUT, **out)
"""

JAX = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import QuantPolicy, make_train_step
from repro.core.steps import default_bits, init_train_state
from repro.core.taxonn import apply_stacked_updates
from repro.models import lm
from repro.models.config import ModelConfig
from repro.optim import Hyper, OptimizerConfig, init_opt_state
cfg = ModelConfig(**CFG)
d = np.load(IN)
params = lm.init_params(jax.random.key(0), cfg)
batch = {k: jnp.asarray(d[k]) for k in ("tokens", "labels")}
hyper = Hyper(lr=jnp.float32(LR), step=jnp.int32(0))
mesh = jax.make_mesh((WORLD,), ("data",))
out = {}
for name, (quant, kind, kw) in CASES.items():
    ocfg = OptimizerConfig(kind=kind)
    pol = _policy(QuantPolicy, quant, overlap="on", dw_psum_axes=("data",),
                  dw_num_replicas=WORLD, **kw)
    step = make_train_step(cfg, pol, ocfg)
    bits = default_bits(cfg, quant)
    f = jax.shard_map(lambda p, s, b: step(p, s, b, hyper, bits),
                      mesh=mesh, in_specs=(P(), P(), P("data")),
                      out_specs=(P(), P(), P()), check_vma=False)
    p, _, m = jax.jit(f)(params, init_train_state(params, ocfg), batch)
    out[name + "loss"] = np.asarray(m["loss"])
    out[name + "gnorm"] = np.asarray(m["grad_norm"])
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{name}p{i}"] = np.asarray(x)
# the stacked update tail: each device's own dW (d["dw<r>_<i>"])
stk = jax.tree.map(jnp.asarray, params["blocks"])
leaves, tdef = jax.tree.flatten(stk)
dws = jax.tree.unflatten(tdef, [jnp.stack([jnp.asarray(d[f"dw{r}_{i}"])
                                           for r in range(WORLD)])
                                for i in range(len(leaves))])
bits = default_bits(cfg)["blocks"]
for name, (kind, kw) in APPLY.items():
    ocfg = OptimizerConfig(kind=kind)
    pol = QuantPolicy(quantize_updates=True, dw_psum_axes=("data",),
                      dw_num_replicas=WORLD, **kw)
    f = jax.shard_map(
        lambda s, g, o, pol=pol, ocfg=ocfg: apply_stacked_updates(
            s, jax.tree.map(lambda a: a[0], g), o, bits, hyper, pol, ocfg),
        mesh=mesh, in_specs=(P(), P("data"), P()), out_specs=(P(), P(), P()),
        check_vma=False)
    new, st, gsq = jax.jit(f)(stk, dws, init_opt_state(stk, ocfg))
    out["apply_" + name + "gsq"] = np.asarray(gsq)
    for i, x in enumerate(jax.tree.leaves((new, st))):
        out[f"apply_{name}{i}"] = np.asarray(x)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 gloo ranks and the JAX subprocess, side by side."""
    root = tmp_path_factory.mktemp("engine_overlap")
    jc = tiny("dense")
    params = JLM.init_params(jax.random.key(0), jc)
    arrays = {f"p{i}": np.asarray(x)
              for i, x in enumerate(jax.tree.leaves(params))}
    arrays.update({k: np.asarray(v)
                   for k, v in make_batch(jc, b=8, t=32).items()})
    for r in range(WORLD):
        for i, x in enumerate(_stack_dw(jax.tree.leaves(params["blocks"]),
                                        r)):
            arrays[f"dw{r}_{i}"] = x
    np.savez(root / "in.npz", **arrays)
    head = (f"IN = {str(root / 'in.npz')!r}\nCFG = {dataclasses.asdict(jc)!r}"
            f"\nLR, WORLD = {LR!r}, {WORLD}\nCASES = {RANK_CASES!r}\n"
            f"APPLY = {APPLY_CASES!r}\n" + inspect.getsource(_policy))
    (root / "t").mkdir()
    (root / "j").mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        jax_run = ex.submit(run_jax, head + JAX, root / "j")
        ranks = ex.submit(run_ranks, head + RANKS, root / "t")
        return ranks.result(), jax_run.result(), arrays


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_rank0_overlapped_step_matches_jax_shard_map(runs, case):
    ranks, jax_out, arrays = runs
    quant, _, kw = RANK_CASES[case]
    n = sum(k.startswith("p") for k in arrays)
    # jitted JAX's codec scales by the f32 reciprocal of 127 and fuses the
    # ring's decompress-and-add: a payload may land one codec step away
    # (lr * absmax / 127 on the update), counted as a quantized tie is
    misses = _hold(ranks[0], jax_out, case,
                   quant or kw.get("compress_dw", False), n)
    assert float(ranks[0][case + "gnorm"]) == pytest.approx(
        float(jax_out[case + "gnorm"]), rel=1e-5)
    print(f"{case}: leaves off by more than 1e-5: {misses}")


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_stack_leaves_are_bitwise_equal_across_ranks(runs, case):
    """The stacks' update is reduced; the boundary's is each rank's own."""
    ranks, _, _ = runs
    names = [p for p, _ in tree_leaves_with_path(TLM.init_params(
        ModelConfig(**dataclasses.asdict(tiny("dense"))), device="cpu"))]
    for i, name in enumerate(names):
        same = [np.array_equal(r[f"{case}p{i}"].view(np.uint32),
                               ranks[0][f"{case}p{i}"].view(np.uint32))
                for r in ranks[1:]]
        if name.startswith("blocks/"):
            assert all(same), (case, name)
        else:
            assert not all(same), (case, name)


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_stacked_updates_over_four_ranks_matches_jax(runs, case):
    """Each rank's own dW reduced over the 4 ranks, then the strict-mode
    update (on the G grid: an (I,F) tie may move 1% of a leaf one grid
    step); rank 0 against JAX's, every rank the same bits."""
    ranks, jax_out, _ = runs
    keys = sorted((k for k in jax_out if k.startswith(f"apply_{case}")
                   and not k.endswith("gsq")),
                  key=lambda k: int(k[len(f"apply_{case}"):]))
    assert keys
    assert float(ranks[0][f"apply_{case}gsq"]) == pytest.approx(
        float(jax_out[f"apply_{case}gsq"]), rel=1e-5)
    for k in keys:
        g, r = ranks[0][k], jax_out[k]
        assert g.shape == r.shape
        assert _grid_close(g, r, 1e-5, 0.0, LR * GRID), (
            k, np.abs(g - r).max())
        for rank in ranks[1:]:
            assert np.array_equal(rank[k].view(np.uint8), g.view(np.uint8))


def test_driver_primes_the_transports_over_four_ranks(runs):
    """The driver's gate (``--overlap on``, ``--transport auto``, a data
    group of more than one) measures every dW leaf size's bucket over the
    4-rank mesh and prints JAX's line; every rank the same decisions."""
    ranks, _, _ = runs
    line = str(ranks[0]["prime_line"]).strip()
    m = re.fullmatch(r"\[train\] transport autotuner \(g=4\): (.+)", line)
    assert m, line
    picks = m.group(1).split(", ")
    buckets = sorted({max(4096, 1 << (int(b) - 1).bit_length())
                      for b in ranks[0]["prime_sizes"]})
    assert picks == [f"{b // 1024}kb->{p.split('->')[1]}"
                     for b, p in zip(buckets, picks)]
    assert all(p.split("->")[1] in ("ring", "psum", "scatter")
               for p in picks)
    snap = str(ranks[0]["prime_snap"])
    assert "'measured'" in snap and "'model'" not in snap
    for r in ranks[1:]:
        assert str(r["prime_line"]).strip() == line
        assert str(r["prime_snap"]) == snap
