"""Tensor parallelism over the mesh's "model" axis on spawned gloo ranks:
the port's dense step on its shards against its own one-rank step, and
against the JAX package's ``--model 2`` step.

``tiny("dense")`` (2 layers, d 32, 4 heads over 2 KV heads, d_ff 64,
vocab 128, f32) takes one step from JAX's initial parameters on 2 x 16
tokens.  Each rank holds its shards (``dist.sharding.shard_tree`` of
``param_pspecs``/``opt_pspecs``) under ``dist.mesh_ctx``; the updated
shards are gathered back (``gather_tree``).  Two launches of ranks and
one JAX subprocess run side by side:

* 2 ranks, a ``data=1 x model=2`` mesh (the KV heads sharded with the
  query heads), and 4 ranks, ``data=1 x model=4`` (2 KV heads over 4
  ranks: the KV projections stay replicated and each rank takes the KV
  heads of its own query heads), for the int8, emulate and off backends
  and the quantization legs (off, on, stochastic strict mode), against
  the port's one-rank step on the same rank:
    - the hidden state at the head's input: bitwise on int8 (the
      row-parallel z sum int32 partials, every scale is the logical
      tensor's), within f32 reassociation otherwise;
    - the loss within 1e-6 relative, and equal to 4 decimals (the
      driver's log);
    - the update, on every backend: every leaf of the parameters within
      the engine tests' 1e-5 (``test_torch_engine_dist._hold``; an (I,F)
      tie may move up to 1% of a quantized leaf one grid step), and the
      momentum within the same tolerance in its units (1e-5 / lr: the
      step moves the parameters by lr times the momentum); momentum8's
      state decoded (m_q * m_s) within that, its scales within it over
      127 (``_hold_update``).  On int8 the vocab-parallel head's sum of
      exps reassociates f32, so the G it sends back sits a few ulps from
      the one-rank G: the parameters then differ by at most 6e-8 and one
      m_q payload at an int8 rounding tie moves one step;
    - the same int8 momentum8 step with a planted fault, the optimizer's
      MAX (the row absmax) or SUM (the clip's sum of squares) over the
      model group left out, fails that check;
    - ``optim.apply_update(..., specs=)`` on shards, momentum8 with the
      clip active, is bitwise the logical leaf's update, m_q included;
    - one transformer layer forward and backward with the same input and
      upstream gradient on both sides: on int8 its output, its input's
      gradient and every parameter's gradient (this rank's slice) are
      bitwise, so are the row-parallel z and the column-parallel dx that
      build them; on emulate within 1e-5.
* the autodiff baseline on both meshes (the same parallel layers and
  head under one autograd pass) against its one-rank step, within 1e-5.
* 4 ranks, ``data=2 x model=2`` with ``dw_psum_axes=("data",)`` (each
  data coordinate its half of the batch) against the data-only step of
  the same ranks on a ``data=2 x pipe=2`` mesh (no model axis, one
  stage).
* Rank 0 of the 2-rank mesh against JAX's ``make_train_step`` jitted
  under a 1 x 2 host mesh with the parameters placed by its
  ``param_pspecs`` and the default rules (JAX's ``--model 2`` step), the
  off backend, quantization off, on and stochastic (the same noise: the
  ROADMAP's randomness rule): ``_hold``'s rule.

The refusals of what the model axis does not yet run take a mesh record
in-process (no ranks: they raise before any collective).
"""
import concurrent.futures
import dataclasses
import inspect
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro_torch.models.config import ModelConfig
from test_models import make_batch, tiny
from test_torch_collectives import run_jax, run_ranks
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)
from test_torch_engine_dist import TOL, _hold

LR = 0.01
# (backend, quantization leg, optimizer kind, per-leaf clip)
CASES = (("int8", "on", "momentum8", 1.0), ("int8", "off", "sgd", 0.0),
         ("emulate", "on", "momentum", 1.0), ("off", "on", "momentum", 0.0),
         ("off", "off", "sgd", 0.0), ("off", "stochastic", "momentum", 0.0))
JAX_CASES = tuple(c for c in CASES if c[0] == "off")
# run once more with the optimizer's model-group MAX and SUM left out
FAULT_CASE = CASES[0]
DATA_CASES = (("int8", "on", "momentum", 0.0), ("off", "on", "momentum", 0.0))
# the autodiff baseline (loss_fn through the same parallel layers and head)
AUTODIFF_CASES = (("off", "off", "momentum", 1.0),)


def _tag(case) -> str:
    return "_".join(str(v) for v in case)


def _policy(QuantPolicy, backend, leg, **kw):
    """The step's policy (either package's ``QuantPolicy`` class)."""
    if leg == "off":
        return QuantPolicy(quantize_weights=False, quantize_acts=False,
                           quantize_grads=False, kernel_backend=backend, **kw)
    return QuantPolicy(grad_scale=16.0, kernel_backend=backend,
                       quantize_updates=leg == "stochastic",
                       stochastic=leg == "stochastic", **kw)


RANKS = """
import threading

from repro_torch.core import QuantPolicy, StepOptions, make_train_step
import repro_torch.core.steps as ST
from repro_torch.core.steps import default_bits, init_train_state
from repro_torch.dist import (gather_tree, mesh_ctx, opt_pspecs,
                              param_pspecs, shard_tree)
from repro_torch.dist.sharding import P
from repro_torch.kernels.ops import kernel_backend_ctx
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from repro_torch.util.tree import tree_leaves, tree_map, tree_unflatten

cfg = ModelConfig(**CFG)
d = np.load(IN)
template = lm.init_params(cfg, device="cpu")
n = len(tree_leaves(template))
p0 = tree_unflatten(template, [torch.from_numpy(d[f"p{i}"])
                               for i in range(n)])
full = {k: d[k] for k in ("tokens", "labels")}
RNG = d["rng"]
HEAD = []
_head_fn = ST._head_fn


def recording_head(*a):
    f = _head_fn(*a)

    def g(bnd, xf):
        HEAD.append(xf.detach().clone())
        return f(bnd, xf)
    return g


ST._head_fn = recording_head


def run(case, mesh, batch, engine="taxonn", **kw):
    backend, leg, kind, clip = case
    ocfg = OptimizerConfig(kind=kind, grad_clip=clip)
    step = make_train_step(cfg, _policy(QuantPolicy, backend, leg, **kw),
                           ocfg, StepOptions(kernel_backend=backend,
                                             engine=engine),
                           device="cpu")
    s0 = init_train_state(p0, ocfg)
    args = (batch, Hyper(lr=LR, step=0), default_bits(cfg, leg != "off"),
            RNG if leg == "stochastic" else None)
    if mesh is None:
        p, s, m = step(p0, s0, *args)
    else:
        ps = param_pspecs(cfg, p0, mesh)
        ss = opt_pspecs(cfg, s0, ps, mesh)
        with mesh_ctx(mesh):
            p, s, m = step(shard_tree(p0, ps, mesh), shard_tree(s0, ss, mesh),
                           *args)
            p, s = gather_tree(p, ps, mesh), gather_tree(s, ss, mesh)
    return p, s, float(m["loss"]), HEAD.pop() if HEAD else torch.zeros(())


def save_case(out, tag, res):
    p, s, loss, head = res
    out[tag + "loss"] = np.float64(loss)
    out[tag + "head"] = head.numpy()
    for i, x in enumerate(tree_leaves(p)):
        out[f"{tag}p{i}"] = x.numpy()
    for i, x in enumerate(tree_leaves(s)):
        out[f"{tag}s{i}"] = x.numpy()


def layer_check(backend, mesh, out):
    # one layer forward + backward, the same x and dy on both sides
    lp = lm.layer_params(p0["blocks"], 0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    dy = torch.randn(2, 16, cfg.d_model, generator=g)
    pos = torch.arange(16).expand(2, 16)

    def one(params, thread=False):
        pg = tree_map(lambda w: w.detach().requires_grad_(), params)
        xx = x.clone().requires_grad_()
        with kernel_backend_ctx(backend, "cpu"):
            y, _ = B.transformer_block(pg, xx, cfg, pos)
            (in_thread if thread else lambda f: f())(lambda: y.backward(dy))
        return [y.detach(), xx.grad] + [w.grad for w in tree_leaves(pg)]

    ref = one(lp)
    specs = tree_map(lambda sp: P(*tuple(sp)[1:]),
                     param_pspecs(cfg, p0, mesh)["blocks"])
    with mesh_ctx(mesh):
        got = one(shard_tree(lp, specs, mesh))
        # the backward on a thread of its own, as autograd runs it on CUDA
        thr = one(shard_tree(lp, specs, mesh), thread=True)
    out[f"layer_{backend}_thread_eq"] = np.array(
        [torch.equal(a, b) for a, b in zip(got, thr)])
    ref = ref[:2] + tree_leaves(shard_tree(
        tree_unflatten(lp, ref[2:]), specs, mesh))
    out[f"layer_{backend}_eq"] = np.array([torch.equal(a, b)
                                           for a, b in zip(ref, got)])
    out[f"layer_{backend}_err"] = np.array([float((a - b).abs().max())
                                            for a, b in zip(ref, got)])


def in_thread(fn):
    # autograd runs a CUDA backward on a thread of its own, where the
    # caller's context variables (the ambient mesh) are not set; on the
    # CPU it runs on the caller's thread, so a fresh thread stands in
    err = []

    def body():
        try:
            fn()
        except BaseException as e:        # re-raised on the caller's thread
            err.append(e)
    t = threading.Thread(target=body)
    t.start()
    t.join()
    if err:
        raise err[0]


def head_check(mesh, out):
    # the vocab-parallel head (its chunks recomputed in the backward under
    # activation checkpointing) with its backward on a thread of its own
    # against the backward on the caller's thread: bitwise
    w = lm.head_weight(p0, cfg).detach()
    w = w.chunk(WORLD, dim=1)[mesh.get_local_rank("model")].contiguous()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    labels = torch.from_numpy(full["labels"]).long()
    res = []
    for thread in (False, True):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        with mesh_ctx(mesh):
            loss, _ = lm.ce_from_weight(ww, cfg, xx, labels)
            (in_thread if thread else lambda f: f())(loss.backward)
        res.append([loss.detach(), xx.grad, ww.grad])
    out["head_thread_eq"] = np.array([torch.equal(a, b)
                                      for a, b in zip(*res)])


def opt_check(mesh, out):
    # apply_update on this rank's shards against the logical leaves, with
    # the clip active (its limit between each shard's norm and the logical
    # norm) and a nonzero int8 momentum; the gradients are multiples of
    # 1/16 in [-1, 1], so every sum of squares is exact in f32 and the
    # whole update is bitwise in any order of summation
    import repro_torch.optim.sgd as SGD
    from repro_torch.optim import apply_update
    gen = torch.Generator().manual_seed(2)

    def grid(shape):
        return torch.randint(-16, 17, shape, generator=gen).float() / 16

    leaves = {"col": ((3, 32, 64), P(None, None, "model")),
              "row": ((3, 64, 32), P(None, "model", None)),
              "heads": ((32, 4, 8), P(None, "model", None))}
    for name, (shape, spec) in leaves.items():
        w = torch.randn(shape, generator=gen)
        g = grid(shape)
        st = {"m_q": {"w": torch.randint(-127, 128, shape, generator=gen,
                                         dtype=torch.int8)},
              "m_s": {"w": torch.rand(shape[:-1], generator=gen) / 64}}
        ocfg = OptimizerConfig(kind="momentum8", grad_clip=0.8 * float(
            torch.linalg.vector_norm(g)))
        ps = {"w": spec}
        ss = opt_pspecs(cfg, {"x": st}, {"x": ps}, mesh)["x"]
        want_p, want_s = apply_update({"w": w}, {"w": g}, st,
                                      Hyper(lr=LR, step=0), ocfg)
        want = [want_p["w"], want_s["m_q"]["w"], want_s["m_s"]["w"]]

        def sharded(tag):
            with mesh_ctx(mesh):
                p, s = apply_update(
                    shard_tree({"w": w}, ps, mesh),
                    shard_tree({"w": g}, ps, mesh),
                    shard_tree(st, ss, mesh), Hyper(lr=LR, step=0), ocfg,
                    specs=ps)
                p, s = gather_tree(p, ps, mesh), gather_tree(s, ss, mesh)
            got = [p["w"], s["m_q"]["w"], s["m_s"]["w"]]
            out[f"opt_{name}_{tag}"] = np.array(
                [torch.equal(a, b) for a, b in zip(want, got)])

        sharded("ok")
        # planted faults: the row absmax not MAXed, the clip's sum of
        # squares not SUMmed over the model group
        for fault, fn in (("nomax", "dense_pmax"), ("nopsum", "dense_psum")):
            keep = getattr(SGD, fn)
            setattr(SGD, fn, lambda x, axes: x)
            try:
                sharded(fault)
            finally:
                setattr(SGD, fn, keep)


def run_faulty(case, mesh, batch, fn):
    # the sharded step with one of the optimizer's model-group reductions
    # left out (a planted fault that the step check must catch)
    import repro_torch.optim.sgd as SGD
    keep = getattr(SGD, fn)
    setattr(SGD, fn, lambda x, axes: x)
    try:
        return run(case, mesh, batch)
    finally:
        setattr(SGD, fn, keep)


out = {}
tp = make_mesh((1, WORLD), ("data", "model"))
for case in CASES:
    tag = _tag(case)
    save_case(out, "one" + tag, run(case, None, full))
    save_case(out, "tp" + tag, run(case, tp, full))
for fault, fn in (("nomax", "dense_pmax"), ("nopsum", "dense_psum")):
    save_case(out, fault + _tag(FAULT_CASE),
              run_faulty(FAULT_CASE, tp, full, fn))
opt_check(tp, out)
head_check(tp, out)
for case in AUTODIFF_CASES:
    tag = "ad" + _tag(case)
    save_case(out, "one" + tag, run(case, None, full, engine="autodiff"))
    save_case(out, "tp" + tag, run(case, tp, full, engine="autodiff"))
for backend in ("int8", "emulate"):
    layer_check(backend, tp, out)
if WORLD == 4:
    # data=2 x model=2 against the data-only step of the same ranks
    dm = make_mesh((2, 2), ("data", "model"))
    dp = make_mesh((2, 2), ("data", "pipe"))
    r = dm.get_local_rank("data")
    half = {k: v[r::2] for k, v in full.items()}
    for case in DATA_CASES:
        tag = _tag(case)
        save_case(out, "dm" + tag, run(case, dm, half,
                                       dw_psum_axes=("data",)))
        save_case(out, "dp" + tag, run(case, dp, half,
                                       dw_psum_axes=("data",)))
np.savez(OUT, **out)
"""

JAX = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro.core import QuantPolicy, StepOptions, make_train_step
from repro.core.steps import default_bits, init_train_state
from repro.dist.api import activation_sharding_ctx, make_default_rules
from repro.dist.sharding import param_pspecs, to_named
from repro.models import lm
from repro.models.config import ModelConfig
from repro.optim import Hyper, OptimizerConfig
cfg = ModelConfig(**CFG)
d = np.load(IN)
params = lm.init_params(jax.random.key(0), cfg)
batch = {k: jnp.asarray(d[k]) for k in ("tokens", "labels")}
rng = jax.random.wrap_key_data(jnp.asarray(d["rng"]))
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
with jax.set_mesh(mesh), activation_sharding_ctx(
        make_default_rules(("data",))):
    placed = jax.device_put(params, to_named(param_pspecs(cfg, params, mesh),
                                             mesh))
    for backend, leg, kind, clip in JAX_CASES:
        ocfg = OptimizerConfig(kind=kind, grad_clip=clip)
        step = make_train_step(cfg, _policy(QuantPolicy, backend, leg), ocfg,
                               StepOptions(kernel_backend=backend))
        p, s, m = jax.jit(step)(
            placed, init_train_state(placed, ocfg), batch,
            Hyper(lr=jnp.float32(LR), step=jnp.int32(0)),
            default_bits(cfg, leg != "off"),
            rng if leg == "stochastic" else None)
        tag = "_".join(str(v) for v in (backend, leg, kind, clip))
        out[tag + "loss"] = np.asarray(m["loss"])
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"{tag}p{i}"] = np.asarray(x)
np.savez(OUT, **out)
"""


def _cfgs():
    jc = tiny("dense", vocab_size=128)
    return jc, ModelConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2- and 4-rank launches and the JAX subprocess, side by side."""
    root = tmp_path_factory.mktemp("tp_ranks")
    jc, _ = _cfgs()
    params = JLM.init_params(jax.random.key(0), jc)
    batch = make_batch(jc, b=2, t=16)
    rng = jax.random.fold_in(jax.random.key(1), 3)
    arrays = {f"p{i}": np.asarray(x)
              for i, x in enumerate(jax.tree.leaves(params))}
    arrays.update({k: np.asarray(v) for k, v in batch.items()})
    arrays["rng"] = np.asarray(jax.random.key_data(rng))
    np.savez(root / "in.npz", **arrays)
    head = (f"IN = {str(root / 'in.npz')!r}\nCFG = {dataclasses.asdict(jc)!r}"
            f"\nLR, CASES, JAX_CASES, DATA_CASES, AUTODIFF_CASES = {LR!r}, "
            f"{CASES!r}, {JAX_CASES!r}, {DATA_CASES!r}, {AUTODIFF_CASES!r}\n"
            f"FAULT_CASE = {FAULT_CASE!r}\n"
            + inspect.getsource(_tag) + inspect.getsource(_policy))
    for sub in ("r2", "r4", "j"):
        (root / sub).mkdir()
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        jax_run = ex.submit(run_jax, head + JAX, root / "j", 2)
        two = ex.submit(run_ranks, head + RANKS, root / "r2", 2)
        four = ex.submit(run_ranks, head + RANKS, root / "r4", 4)
        return {2: two.result(), 4: four.result()}, jax_run.result()


def _leaves(res: dict, tag: str, kind: str) -> list:
    return [res[k] for k in sorted((k for k in res
                                    if k.startswith(tag + kind)
                                    and k[len(tag) + 1:].isdigit()),
                                   key=lambda k: int(k[len(tag) + 1:]))]


def _hold_update(got: dict, want: dict, tg: str, tw: str, case):
    """The update of ``got`` (tag ``tg``) against ``want`` (tag ``tw``):
    every parameter leaf within TOL, the momentum within TOL / LR (its
    units: the step moves the parameters by lr times it), up to 1% of a
    quantized leaf's elements one tie away.  momentum8's state is held
    decoded, m_q * m_s within TOL / LR with the same 1% (a payload at an
    int8 rounding tie moves one step), and its scales m_s within
    TOL / LR / 127 (the momentum's tolerance over the payload's range)."""
    quant = case[1] != "off"

    def hold(a, b, tol, what):
        assert a.shape == b.shape, what
        allowed = max(1, b.size // 100) if quant else 0
        misses = int(np.sum(np.abs(a - b) > tol))
        assert misses <= allowed, (what, misses, b.size,
                                   float(np.abs(a - b).max()))

    g, w = _leaves(got, tg, "p"), _leaves(want, tw, "p")
    assert len(g) == len(w) and g
    for i, (a, b) in enumerate(zip(g, w)):
        hold(a, b, TOL, (tg, "p", i))
    g, w = _leaves(got, tg, "s"), _leaves(want, tw, "s")
    assert len(g) == len(w)                          # sgd: no state
    if case[2] != "momentum8":
        for i, (a, b) in enumerate(zip(g, w)):
            hold(a, b, TOL / LR, (tg, "s", i))
        return
    # the state groups' leaves: each group's m_q (int8), then its m_s
    gq, wq = ([x for x in t if x.dtype == np.int8] for t in (g, w))
    gs, ws = ([x for x in t if x.dtype != np.int8] for t in (g, w))
    assert len(gq) == len(gs) == len(wq) == len(ws)
    for i in range(len(gq)):
        hold(gs[i], ws[i], TOL / LR / 127, (tg, "m_s", i))
        hold(gq[i] * gs[i][..., None], wq[i] * ws[i][..., None], TOL / LR,
             (tg, "m_q * m_s", i))


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", CASES, ids=_tag)
def test_sharded_step_against_the_one_rank_step(runs, world, case):
    ranks, _ = runs
    tag = _tag(case)
    for res in ranks[world]:
        one, tp = res["one" + tag + "head"], res["tp" + tag + "head"]
        if case[0] == "int8":
            assert np.array_equal(one.view(np.uint32), tp.view(np.uint32))
        elif case[1] == "off":
            # an (I,F) tie flipped by f32 reassociation in one layer moves
            # the next layer's inputs: compared unquantized only
            np.testing.assert_allclose(tp, one, atol=TOL, rtol=0)
        lo, lt = float(res["one" + tag + "loss"]), float(
            res["tp" + tag + "loss"])
        assert abs(lt - lo) <= 1e-6 * abs(lo), (lo, lt)
        assert f"{lt:.4f}" == f"{lo:.4f}"
    _hold_update(ranks[world][0], ranks[world][0], "tp" + tag, "one" + tag,
                 case)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("what", ("layer_int8", "layer_emulate", "head"))
def test_backward_on_its_own_thread(runs, world, what):
    """On CUDA autograd runs the backward on a thread of its own, where
    the ambient mesh (a context variable) is not set: the parallel units,
    ``_SelectHeads`` and the vocab-parallel head (whose chunks are
    recomputed in the backward) keep the mesh of their forward.  A layer
    forward and backward, and the head's, with the backward on a fresh
    thread: bitwise the backward on the caller's thread."""
    ranks, _ = runs
    for res in ranks[world]:
        assert res[f"{what}_thread_eq"].all(), res[f"{what}_thread_eq"]


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("fault", ("nomax", "nopsum"))
def test_planted_optimizer_fault_fails_the_step_check(runs, world, fault):
    """The int8 momentum8 step with the rowwise absmax left un-MAXed
    ("nomax") or the clip's sum of squares left un-SUMmed ("nopsum") over
    the model group: ``_hold_update`` must refuse it."""
    ranks, _ = runs
    tag = _tag(FAULT_CASE)
    with pytest.raises(AssertionError):
        _hold_update(ranks[world][0], ranks[world][0], fault + tag,
                     "one" + tag, FAULT_CASE)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("leaf", ("col", "row", "heads"))
def test_apply_update_on_shards_is_bitwise(runs, world, leaf):
    """``optim.apply_update(..., specs=)``, momentum8 with the per-leaf
    clip active, on each rank's shard of a leaf sharded on its last
    dimension ("col", whose m_s is replicated), its middle one ("row")
    and a head dimension ("heads"): the gathered parameters, m_q and m_s
    are bitwise the logical leaf's update.  Controls: without the
    clip's SUM every leaf differs; without the absmax's MAX the "col"
    leaf's m_q and m_s differ, and the others, whose rows are whole on
    each rank, do not."""
    ranks, _ = runs
    for res in ranks[world]:
        assert res[f"opt_{leaf}_ok"].all()
        assert not res[f"opt_{leaf}_nopsum"].any()
        nomax = res[f"opt_{leaf}_nomax"]
        assert nomax[0]                  # the parameters need no MAX
        assert nomax.all() != (leaf == "col"), nomax


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("case", AUTODIFF_CASES, ids=_tag)
def test_sharded_autodiff_step_against_the_one_rank_step(runs, world, case):
    """The autodiff baseline under the model axis: the same parallel
    layers and vocab-parallel head under one autograd pass, the shards'
    clip norms summed over the group."""
    ranks, _ = runs
    tag = "ad" + _tag(case)
    res = ranks[world][0]
    lo, lt = float(res["one" + tag + "loss"]), float(res["tp" + tag + "loss"])
    assert abs(lt - lo) <= 1e-6 * abs(lo), (lo, lt)
    _hold_update(res, res, "tp" + tag, "one" + tag, case)


@pytest.mark.parametrize("world", (2, 4))
@pytest.mark.parametrize("backend", ("int8", "emulate"))
def test_layer_products_against_the_unsharded_layer(runs, world, backend):
    ranks, _ = runs
    for res in ranks[world]:
        if backend == "int8":
            assert res[f"layer_{backend}_eq"].all(), res[f"layer_{backend}_err"]
        else:
            assert res[f"layer_{backend}_err"].max() <= TOL


@pytest.mark.parametrize("case", JAX_CASES, ids=_tag)
def test_rank0_matches_the_jax_model2_step(runs, case):
    ranks, jax_out = runs
    tag = _tag(case)
    got = {k[len("tp"):]: v for k, v in ranks[2][0].items()
           if k.startswith("tp" + tag) and "head" not in k}
    n = len(_leaves(jax_out, tag, "p"))
    got = {k: v for k, v in got.items() if not k.startswith(tag + "s")}
    assert n == len(_leaves(got, tag, "p"))
    misses = _hold(got, jax_out, tag, case[1] != "off", n)
    print(f"{tag}: leaves off by more than {TOL}: {misses}")


@pytest.mark.parametrize("case", DATA_CASES, ids=_tag)
def test_data_and_model_axes_compose(runs, case):
    ranks, _ = runs
    tag = _tag(case)
    for res in ranks[4]:
        lo, lt = float(res["dp" + tag + "loss"]), float(res["dm" + tag
                                                             + "loss"])
        assert abs(lt - lo) <= 1e-6 * abs(lo), (lo, lt)
    _hold_update(ranks[4][0], ranks[4][0], "dm" + tag, "dp" + tag, case)


# ---------------------------------------------------------------------------
# What the model axis does not yet run raises by name
# ---------------------------------------------------------------------------

def _model_mesh(m=2):
    """A mesh record with a model axis: enough for the refusals, which
    raise before any collective."""
    return SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, m),
                           get_local_rank=lambda axis: 0)


@pytest.mark.parametrize("what", ("family", "compress_dw", "overlap",
                                  "pipeline"))
def test_refusals_name_the_later_item(what):
    from repro_torch.core import QuantPolicy, StepOptions, make_train_step
    from repro_torch.core.steps import default_bits, init_train_state
    from repro_torch.dist import mesh_ctx
    from repro_torch.models import lm
    from repro_torch.optim import Hyper, OptimizerConfig

    _, tc = _cfgs()
    if what == "family":
        tc = ModelConfig(**dataclasses.asdict(tiny("moe")))
    pol = QuantPolicy(compress_dw=what == "compress_dw",
                      overlap="on" if what == "overlap" else "off")
    opts = (StepOptions(pipeline_schedule="gpipe", pipeline_stages=2,
                        num_microbatches=2) if what == "pipeline"
            else StepOptions())
    ocfg = OptimizerConfig()
    step = make_train_step(tc, pol, ocfg, opts, device="cpu")
    p = lm.init_params(tc, device="cpu")
    batch = {k: np.asarray(v) for k, v in make_batch(tiny(), b=2,
                                                      t=8).items()}
    want = {"family": "the moe family", "compress_dw": "compress_dw",
            "overlap": "overlap='on'", "pipeline": "pipeline_stages > 1"}
    with mesh_ctx(_model_mesh()):
        with pytest.raises(NotImplementedError, match="ROADMAP A11.3c") as e:
            step(p, init_train_state(p, ocfg), batch, Hyper(0.01, 0),
                 default_bits(tc))
    assert want[what] in str(e.value)


def test_serving_and_moe_rowcombine_refuse_a_model_axis():
    from repro_torch.dist import mesh_ctx, perf_options_ctx
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.serving import engine as E

    _, tc = _cfgs()
    p = lm.init_params(tc, device="cpu")
    with mesh_ctx(_model_mesh()):
        with pytest.raises(NotImplementedError, match="ROADMAP A11.3c"):
            E.prefill(p, tc, {"tokens": np.zeros((1, 4), np.int32)}, 8,
                      kernel_backend="off")
    mc = ModelConfig(**dataclasses.asdict(tiny("moe")))
    mp = L.init_moe(torch.Generator().manual_seed(0), mc)
    x = torch.zeros(1, 8, mc.d_model)
    with mesh_ctx(_model_mesh()), perf_options_ctx({"moe_rowcombine"}):
        with pytest.raises(NotImplementedError, match="ROADMAP A11.4"):
            L.moe(mp, x, mc)
    with perf_options_ctx({"moe_rowcombine"}):
        L.moe(mp, x, mc)                # one rank: the plain path
