"""The stage-sharded pipeline step across ranks: stages placed on the
"pipe" dimension of a ``DeviceMesh`` over spawned gloo ranks, and the
pipeline composed with a data axis, against the port's one-rank step and
the JAX package's multi-device steps.

One launch of 4 gloo ranks (``test_torch_collectives.run_ranks``; a
``file://`` store, one intra-op thread a rank) beside one JAX subprocess
with 4 host devices:

* ``tiny("dense")`` (4 layers) and ``tiny("hybrid")`` (4 groups) on a pipe
  mesh of 4 (gpipe, 1f1b, interleaved v = 2) and of 2 x a data axis of 2
  (interleaved v = 2, two virtual stages a rank), quantization off, on and
  stochastic: every rank's step is BITWISE the port's one-rank pipeline
  step (params, state, loss; the hops, the output broadcast and each
  stage's gradient broadcast from its owner move bits, and each stage's
  units and the shared operand's stage sums run in one order on every
  placement), and rank 0 within the dense engine tests' rule
  (``test_torch_engine_dist._hold``: 1e-5, an (I,F) tie on up to 1% of a
  quantized leaf) of JAX's step on its 4-device pipe mesh (JAX's
  ``test_engine_stack_pipe_mesh_exact``, lr 0.05), quantization off, and
  on at the conformance matrix's lr 2e-3 (``LRS``).
* 2 stages over the pipe axis of 4 ranks raise (the JAX package leaves
  such a buffer unpinned).
* JAX's ``test_pipe_axis_composes_with_data_axis``: a data axis of 2
  (ranks {0, 2} and {1, 3} of a 2 x 2 mesh, each with its data
  coordinate's half of the batch), the 1f1b pipeline of 4 stages and 4
  microbatches with ``dw_psum_axes=("data",)``, ``compress_dw`` off and
  on, ``overlap`` off and on: the loss equal to the engine step's on the
  same rank, and rank 0 within 1e-5 of JAX's ``shard_map`` run.
"""
import concurrent.futures
import dataclasses
import inspect

import jax
import numpy as np
import pytest

from repro.models import lm as JLM
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.util.tree import tree_leaves_with_path
from test_models import make_batch, tiny
from test_torch_collectives import run_jax, run_ranks
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)
from test_torch_engine_dist import _hold

# JAX's pipe-mesh test's lr with quantization off; its conformance matrix's
# with it on: at 0.05 one G-grid step of the update on a tie (f32
# reassociation) exceeds the 1e-5 rule, for the engine step too (the
# hybrid's quantized Mamba conv biases: 16 of 512 elements 2.6e-5 away)
LRS = {"off": 0.05, "on": 2e-3, "stochastic": 2e-3}
FAMILIES = ("dense", "hybrid")
LEGS = ("off", "on", "stochastic")
JAX_LEGS = ("off", "on")
# (mesh, schedule, num_virtual); "one" is the one-rank step, no mesh
PLACEMENTS = (("p4", "gpipe", None), ("p4", "1f1b", None),
              ("p4", "interleaved", 2), ("p2", "interleaved", 2))
DATA_CASES = tuple((c, o) for c in (False, True) for o in ("off", "on"))


def _cfg(family):
    if family == "hybrid":
        return tiny("hybrid", num_layers=8, attn_every=2)
    return tiny("dense", num_layers=4)


def _policy(QuantPolicy, leg):
    """The step's policy (either package's ``QuantPolicy`` class)."""
    if leg == "off":
        return QuantPolicy(quantize_weights=False, quantize_acts=False,
                           quantize_grads=False, kernel_backend="off")
    return QuantPolicy(grad_scale=16.0, kernel_backend="off",
                       stochastic=leg == "stochastic")


RANKS = """
import contextlib
from repro_torch.core import QuantPolicy, StepOptions, make_train_step
from repro_torch.core.steps import default_bits, init_train_state
from repro_torch.dist import get_schedule, mesh_ctx
from repro_torch.launch.mesh import make_debug_mesh, make_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from repro_torch.util.tree import tree_leaves, tree_unflatten
d = np.load(IN)
meshes = {"one": None, "p4": make_debug_mesh(1, 1, pipe=4),
          "p2": make_debug_mesh(2, 1, pipe=2)}
out = {}


def step_on(cfg, fam, pol, ocfg, opts, mesh, lr, rows=slice(None)):
    tmpl = lm.init_params(cfg, device="cpu")
    p0 = tree_unflatten(tmpl, [torch.from_numpy(d[f"{fam}_p{i}"])
                               for i in range(len(tree_leaves(tmpl)))])
    batch = {k: d[f"{fam}_{k}"][rows] for k in ("tokens", "labels")}
    step = make_train_step(cfg, pol, ocfg, opts, device="cpu")
    with (mesh_ctx(mesh) if mesh is not None else contextlib.nullcontext()):
        return step(p0, init_train_state(p0, ocfg), batch,
                    Hyper(lr=lr, step=0),
                    default_bits(cfg, pol.quantize_weights),
                    KEY if pol.stochastic else None)


def save(tag, p, s, m):
    out[tag + "loss"] = m["loss"].numpy()
    out[tag + "gnorm"] = m["grad_norm"].numpy()
    for i, x in enumerate(tree_leaves(p)):
        out[f"{tag}p{i}"] = x.numpy()
    for i, x in enumerate(tree_leaves(s)):
        out[f"{tag}s{i}"] = x.numpy()


for fam in FAMILIES:
    cfg = ModelConfig(**CFGS[fam])
    for leg in LEGS:
        pol = _policy(QuantPolicy, leg)
        for mname, sname, v in (("one", "1f1b", None),) + PLACEMENTS:
            opts = StepOptions(pipeline_schedule=get_schedule(
                sname, num_virtual=v), pipeline_stages=4, num_microbatches=4)
            save(f"{fam}_{leg}_{mname}_{sname}_", *step_on(
                cfg, fam, pol, OptimizerConfig(), opts, meshes[mname],
                LRS[leg]))
# 2 stages over a pipe axis of 4 ranks: refused, not left unplaced
from repro_torch.dist import pipeline_apply
try:
    pipeline_apply(torch.ones(2, 3), torch.ones(4, 3),
                   lambda s, h: h * s, meshes["p4"], schedule="1f1b")
    out["uneven"] = np.array("no error")
except ValueError as e:
    out["uneven"] = np.array(str(e))
# the pipeline inside a data axis of two: ranks {0, 2} and {1, 3} (the
# other axis a replica axis: under a "model" axis of two the step would be
# tensor-parallel, which refuses the pipeline)
grid = make_mesh((2, 2), ("data", "replica"))
dcoord = RANK // 2
cfg = ModelConfig(**CFGS["dense"])
for compress, ov in DATA_CASES:
    pol = QuantPolicy(quantize_weights=False, quantize_acts=False,
                      quantize_grads=False, kernel_backend="off",
                      compress_dw=compress, dw_psum_axes=("data",),
                      dw_num_replicas=2, overlap=ov)
    for name, opts in (("engine", StepOptions()),
                       ("pipe", StepOptions(pipeline_schedule="1f1b",
                                            pipeline_stages=4,
                                            num_microbatches=4))):
        save(f"data_{int(compress)}{ov}_{name}_", *step_on(
            cfg, "dense", pol, OptimizerConfig(kind="sgd"), opts, grid,
            0.01, rows=slice(4 * dcoord, 4 * dcoord + 4)))
np.savez(OUT, **out)
"""

JAX = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import QuantPolicy, StepOptions, make_train_step
from repro.core.steps import default_bits, init_train_state
from repro.launch.mesh import make_debug_mesh
from repro.models import lm
from repro.models.config import ModelConfig
from repro.optim import Hyper, OptimizerConfig
d = np.load(IN)
out = {}
mesh = make_debug_mesh(1, 1, pipe=4)
for fam in FAMILIES:
    cfg = ModelConfig(**CFGS[fam])
    params = lm.init_params(jax.random.key(0), cfg)
    batch = {k: jnp.asarray(d[f"{fam}_{k}"]) for k in ("tokens", "labels")}
    for leg in JAX_LEGS:
        pol = _policy(QuantPolicy, leg)
        ocfg = OptimizerConfig()
        step = jax.jit(make_train_step(cfg, pol, ocfg, StepOptions(
            pipeline_schedule="1f1b", pipeline_stages=4,
            num_microbatches=4)))
        with jax.set_mesh(mesh):
            p, _, m = step(params, init_train_state(params, ocfg), batch,
                           Hyper(lr=jnp.float32(LRS[leg]),
                                 step=jnp.int32(0)),
                           default_bits(cfg, pol.quantize_weights))
        tag = f"{fam}_{leg}_"
        out[tag + "loss"] = np.asarray(m["loss"])
        for i, x in enumerate(jax.tree.leaves(p)):
            out[f"{tag}p{i}"] = np.asarray(x)
cfg = ModelConfig(**CFGS["dense"])
params = lm.init_params(jax.random.key(0), cfg)
batch = {k: jnp.asarray(d[f"dense_{k}"]) for k in ("tokens", "labels")}
dmesh = jax.make_mesh((2,), ("data",))
bits = default_bits(cfg, enabled=False)
hyper = Hyper(lr=jnp.float32(0.01), step=jnp.int32(0))
for compress, ov in DATA_CASES:
    pol = QuantPolicy(quantize_weights=False, quantize_acts=False,
                      quantize_grads=False, kernel_backend="off",
                      compress_dw=compress, dw_psum_axes=("data",),
                      dw_num_replicas=2, overlap=ov)
    ocfg = OptimizerConfig(kind="sgd")
    step = make_train_step(cfg, pol, ocfg, StepOptions(
        pipeline_schedule="1f1b", pipeline_stages=4, num_microbatches=4))
    f = jax.shard_map(lambda p, s, b: step(p, s, b, hyper, bits),
                      mesh=dmesh, in_specs=(P(), P(), P("data")),
                      out_specs=(P(), P(), P()), check_vma=False)
    p, _, m = jax.jit(f)(params, init_train_state(params, ocfg), batch)
    tag = f"data_{int(compress)}{ov}_"
    out[tag + "loss"] = np.asarray(m["loss"])
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{tag}p{i}"] = np.asarray(x)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4 gloo ranks and the JAX subprocess, side by side."""
    root = tmp_path_factory.mktemp("engine_pipeline_ranks")
    arrays = {}
    for fam in FAMILIES:
        jc = _cfg(fam)
        for i, x in enumerate(jax.tree.leaves(JLM.init_params(
                jax.random.key(0), jc))):
            arrays[f"{fam}_p{i}"] = np.asarray(x)
        for k, v in make_batch(jc, b=8, t=32 if fam == "dense" else 16
                               ).items():
            arrays[f"{fam}_{k}"] = np.asarray(v)
    np.savez(root / "in.npz", **arrays)
    cfgs = {f: dataclasses.asdict(_cfg(f)) for f in FAMILIES}
    key = np.asarray(jax.random.key_data(jax.random.key(3)))
    head = (f"IN = {str(root / 'in.npz')!r}\nCFGS = {cfgs!r}\n"
            f"LRS = {LRS!r}\nFAMILIES = {FAMILIES!r}\nLEGS = {LEGS!r}\n"
            f"JAX_LEGS = {JAX_LEGS!r}\nPLACEMENTS = {PLACEMENTS!r}\n"
            f"DATA_CASES = {DATA_CASES!r}\nKEY = np.array({key.tolist()!r},"
            f" dtype=np.uint32)\n" + inspect.getsource(_policy))
    (root / "t").mkdir()
    (root / "j").mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        jax_run = ex.submit(run_jax, "import numpy as np\n" + head + JAX,
                            root / "j")
        ranks = ex.submit(run_ranks, head + RANKS, root / "t")
        return ranks.result(), jax_run.result()


def _keys(res: dict, tag: str) -> list:
    return sorted(k for k in res if k.startswith(tag) and k != tag + "loss")


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("family", FAMILIES)
def test_every_rank_is_bitwise_the_one_rank_step(runs, family, leg):
    ranks, _ = runs
    one = f"{family}_{leg}_one_1f1b_"
    for r, res in enumerate(ranks):
        for mname, sname, _ in PLACEMENTS:
            tag = f"{family}_{leg}_{mname}_{sname}_"
            keys = _keys(res, tag)
            assert len(keys) == len(_keys(ranks[0], one))
            for k in keys + [tag + "loss"]:
                a, b = res[k], ranks[0][one + k[len(tag):]]
                assert a.shape == b.shape and np.array_equal(
                    np.atleast_1d(a).view(np.uint8),
                    np.atleast_1d(b).view(np.uint8)), (r, tag, k)


@pytest.mark.parametrize("leg", JAX_LEGS)
@pytest.mark.parametrize("family", FAMILIES)
def test_rank0_matches_jax_on_a_pipe_mesh(runs, family, leg):
    ranks, jax_out = runs
    n = sum(k.startswith(f"{family}_{leg}_") and k.split("_")[-1][0] == "p"
            and k.split("_")[-1][1:].isdigit() for k in jax_out)
    names = [p for p, _ in tree_leaves_with_path(TLM.init_params(
        ModelConfig(**dataclasses.asdict(_cfg(family))), device="cpu"))]
    assert n == len(names)
    got = {f"{family}_{leg}_" + k[len(f"{family}_{leg}_p4_1f1b_"):]: v
           for k, v in ranks[0].items()
           if k.startswith(f"{family}_{leg}_p4_1f1b_")}
    misses = _hold(got, jax_out, f"{family}_{leg}_", leg != "off", n)
    print(f"{family} {leg}: leaves off by more than 1e-5: {misses}")


@pytest.mark.parametrize("compress,overlap", DATA_CASES)
def test_pipe_composes_with_a_data_axis(runs, compress, overlap):
    ranks, jax_out = runs
    tag = f"data_{int(compress)}{overlap}_"
    for res in ranks:
        assert res[tag + "pipe_loss"] == res[tag + "engine_loss"]
        assert np.isfinite(res[tag + "pipe_gnorm"])
    got = {tag + k[len(tag + "pipe_"):]: v for k, v in ranks[0].items()
           if k.startswith(tag + "pipe_")}
    n = sum(k.startswith(tag + "p") and k[len(tag) + 1:].isdigit()
            for k in jax_out)
    assert n and got[tag + "loss"] == pytest.approx(
        float(jax_out[tag + "loss"]), abs=1e-5)
    for i in range(n):
        g, w = got[f"{tag}p{i}"], jax_out[f"{tag}p{i}"]
        assert g.shape == w.shape
        assert np.abs(g - w).max() < 1e-5, (compress, overlap, i)


def test_stages_the_pipe_axis_does_not_divide_raise(runs):
    ranks, _ = runs
    for res in ranks:
        assert str(res["uneven"]) == ("1f1b: num_stages=2 does not divide "
                                      "over the pipe axis of 4 ranks")
