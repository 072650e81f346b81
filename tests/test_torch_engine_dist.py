"""The engine's cross-replica dW reduction (``QuantPolicy.compress_dw``,
``dw_psum_axes``, ``dw_num_replicas``) against the JAX package's engine.

``tiny("dense")`` (2 layers, d 32, f32) takes one step on a batch of 8 x
32 tokens from JAX's initial parameters, with ``kernel_backend="off"``:

  * on 4 spawned ``gloo`` ranks (2 rows each, one intra-op thread a rank,
    the ambient mesh ``dist.mesh_ctx``) against the JAX package's
    ``shard_map`` of the same step over 4 host devices (in_specs P() for
    the parameters and state, P("data") for the batch, out_specs P()),
    with ``dw_psum_axes=("data",)``, ``dw_num_replicas=4``, ``compress_dw``
    False and True, unquantized (``tests/test_overlap.py``'s policy) and
    quantized (``QuantPolicy(grad_scale=64)``, bits on);
  * with ``compress_dw`` and no axes (the codec round trip of one device,
    as the JAX driver's ``--compress-dw`` runs it) against JAX's jitted
    single-device step.

What the JAX step does, and the port mirrors: only the stacks' dW is
reduced (``backward_stack``); the embedding, head and norm updates use
each replica's own gradient, and ``out_specs=P()`` hands back replica 0's
values.  So rank 0 is held to JAX's output, and the stack leaves are
bitwise equal across the ranks while the boundary leaves are not.

Tolerances: rank 0's loss and every parameter within 1e-5 of JAX's (f32
sums of four replicas in another order than XLA's, far below 1e-5 at
these magnitudes).  In the quantized cases an element whose G sits at an
(I,F) rounding tie may land one grid step away, which moves the weights
it touches by lr * |x| * 2^-12 / grad_scale: at most 1% of a leaf's
elements may then miss 1e-5 (ROADMAP's parity rules); the misses are
counted and the count asserted.
"""
import concurrent.futures
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

from repro.models import lm as JLM
from repro_torch.core import QuantPolicy, make_train_step
from repro_torch.core.steps import default_bits, init_train_state
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from repro_torch.util.tree import tree_leaves, tree_leaves_with_path
from test_models import make_batch, tiny
from test_torch_collectives import WORLD, run_jax, run_ranks

LR, TOL = 0.01, 1e-5
CASES = [(q, c) for q in (False, True) for c in (False, True)]


def _policy(QuantPolicy, quant: bool, **kw):
    """The step's policy (either package's ``QuantPolicy`` class)."""
    if quant:
        return QuantPolicy(grad_scale=64.0, kernel_backend="off", **kw)
    return QuantPolicy(quantize_weights=False, quantize_acts=False,
                       quantize_grads=False, kernel_backend="off", **kw)


RANKS = """
from repro_torch.core import QuantPolicy, make_train_step
from repro_torch.core.steps import default_bits, init_train_state
from repro_torch.dist import mesh_ctx
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Hyper, OptimizerConfig
from repro_torch.util.tree import tree_leaves, tree_unflatten
cfg = ModelConfig(**CFG)
d = np.load(IN)
template = lm.init_params(cfg, device="cpu")
n = len(tree_leaves(template))
p0 = tree_unflatten(template, [torch.from_numpy(d[f"p{i}"])
                               for i in range(n)])
rows = slice(RANK * 8 // WORLD, (RANK + 1) * 8 // WORLD)
batch = {k: d[k][rows] for k in ("tokens", "labels")}
ocfg = OptimizerConfig()
mesh = make_mesh((WORLD,), ("data",))
out = {}
for quant, compress in CASES:
    pol = _policy(QuantPolicy, quant, compress_dw=compress,
                  dw_psum_axes=("data",), dw_num_replicas=WORLD)
    step = make_train_step(cfg, pol, ocfg, device="cpu")
    with mesh_ctx(mesh):
        p, _, m = step(p0, init_train_state(p0, ocfg), batch,
                       Hyper(lr=LR, step=0), default_bits(cfg, quant))
    tag = f"{int(quant)}{int(compress)}"
    out[tag + "loss"] = m["loss"].numpy()
    for i, x in enumerate(tree_leaves(p)):
        out[f"{tag}p{i}"] = x.numpy()
np.savez(OUT, **out)
"""

JAX = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import QuantPolicy, make_train_step
from repro.core.steps import default_bits, init_train_state
from repro.models import lm
from repro.models.config import ModelConfig
from repro.optim import Hyper, OptimizerConfig
cfg = ModelConfig(**CFG)
d = np.load(IN)
params = lm.init_params(jax.random.key(0), cfg)
for i, x in enumerate(jax.tree.leaves(params)):
    assert np.array_equal(np.asarray(x), d[f"p{i}"])
batch = {k: jnp.asarray(d[k]) for k in ("tokens", "labels")}
ocfg = OptimizerConfig()
state = init_train_state(params, ocfg)
hyper = Hyper(lr=jnp.float32(LR), step=jnp.int32(0))
mesh = jax.make_mesh((WORLD,), ("data",))
out = {}
for quant, compress in CASES:
    pol = _policy(QuantPolicy, quant, compress_dw=compress,
                  dw_psum_axes=("data",), dw_num_replicas=WORLD)
    step = make_train_step(cfg, pol, ocfg)
    bits = default_bits(cfg, quant)
    f = jax.shard_map(lambda p, s, b: step(p, s, b, hyper, bits),
                      mesh=mesh, in_specs=(P(), P(), P("data")),
                      out_specs=(P(), P(), P()), check_vma=False)
    p, _, m = jax.jit(f)(params, state, batch)
    tag = f"{int(quant)}{int(compress)}"
    out[tag + "loss"] = np.asarray(m["loss"])
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"{tag}p{i}"] = np.asarray(x)
# compress_dw with no axes: the codec round trip on one device
for quant in (False, True):
    step = jax.jit(make_train_step(cfg, _policy(QuantPolicy, quant,
                                                compress_dw=True), ocfg))
    p, _, m = step(params, state, batch, hyper, default_bits(cfg, quant))
    out[f"solo{int(quant)}loss"] = np.asarray(m["loss"])
    for i, x in enumerate(jax.tree.leaves(p)):
        out[f"solo{int(quant)}p{i}"] = np.asarray(x)
np.savez(OUT, **out)
"""


def _cfgs():
    jc = tiny("dense")
    return jc, ModelConfig(**dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """JAX's initial parameters and the batch, as the npz both sides read."""
    root = tmp_path_factory.mktemp("engine_dist")
    jc, _ = _cfgs()
    params = JLM.init_params(jax.random.key(0), jc)
    batch = make_batch(jc, b=8, t=32)
    arrays = {f"p{i}": np.asarray(x)
              for i, x in enumerate(jax.tree.leaves(params))}
    arrays.update({k: np.asarray(v) for k, v in batch.items()})
    np.savez(root / "in.npz", **arrays)
    return root, arrays


@pytest.fixture(scope="module")
def runs(inputs):
    """The 4 gloo ranks and the JAX subprocess, side by side."""
    root, _ = inputs
    jc, _ = _cfgs()
    head = (f"IN = {str(root / 'in.npz')!r}\nCFG = {dataclasses.asdict(jc)!r}"
            f"\nLR, WORLD, CASES = {LR!r}, {WORLD}, {CASES!r}\n"
            + inspect.getsource(_policy))
    (root / "t").mkdir()
    (root / "j").mkdir()
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        jax_run = ex.submit(run_jax, head + JAX, root / "j")
        ranks = ex.submit(run_ranks, head + RANKS, root / "t")
        return ranks.result(), jax_run.result()


def _misses(got, want) -> int:
    return int(np.sum(np.abs(got - want) > TOL))


def _hold(got: dict, want: dict, tag: str, quant: bool, n: int):
    """Rank 0 (or the one-device port step) against JAX: the loss, and
    each leaf within TOL, up to 1% of a quantized leaf's elements one tie
    away.  Returns the misses of each leaf."""
    assert abs(float(got[tag + "loss"]) - float(want[tag + "loss"])) <= TOL
    misses = []
    for i in range(n):
        g, w = got[f"{tag}p{i}"], want[f"{tag}p{i}"]
        assert g.shape == w.shape
        misses.append(_misses(g, w))
        allowed = max(1, w.size // 100) if quant else 0
        assert misses[-1] <= allowed, (tag, i, misses[-1], w.size,
                                       np.abs(g - w).max())
    return misses


@pytest.mark.parametrize("quant,compress", CASES)
def test_rank0_matches_the_jax_shard_map_step(runs, inputs, quant, compress):
    ranks, jax_out = runs
    n = sum(k.startswith("p") for k in inputs[1])
    tag = f"{int(quant)}{int(compress)}"
    misses = _hold(ranks[0], jax_out, tag, quant, n)
    print(f"{tag}: leaves off by more than {TOL}: {misses}")


@pytest.mark.parametrize("quant,compress", CASES)
def test_stack_leaves_are_bitwise_equal_across_ranks(runs, quant, compress):
    """The stacks' update is reduced; the boundary's is each rank's own."""
    ranks, _ = runs
    _, tc = _cfgs()
    names = [p for p, _ in tree_leaves_with_path(
        TLM.init_params(tc, device="cpu"))]
    tag = f"{int(quant)}{int(compress)}"
    for i, name in enumerate(names):
        same = [np.array_equal(r[f"{tag}p{i}"].view(np.uint32),
                               ranks[0][f"{tag}p{i}"].view(np.uint32))
                for r in ranks[1:]]
        if name.startswith("blocks/"):
            assert all(same), name
        else:
            assert not all(same), name   # each replica's own shard


@pytest.mark.parametrize("quant", [False, True])
def test_compress_dw_without_axes_matches_jax_one_device(runs, inputs,
                                                         quant):
    _, jax_out = runs
    _, arrays = inputs
    torch.set_num_threads(1)
    _, tc = _cfgs()
    n = sum(k.startswith("p") for k in arrays)
    template = TLM.init_params(tc, device="cpu")
    from repro_torch.util.tree import tree_unflatten
    p0 = tree_unflatten(template, [torch.tensor(arrays[f"p{i}"])
                                   for i in range(n)])
    ocfg = OptimizerConfig()
    step = make_train_step(tc, _policy(QuantPolicy, quant, compress_dw=True),
                           ocfg, device="cpu")
    batch = {k: np.array(arrays[k]) for k in ("tokens", "labels")}
    p, _, m = step(p0, init_train_state(p0, ocfg), batch,
                   Hyper(lr=LR, step=0), default_bits(tc, quant))
    tag = f"solo{int(quant)}"
    got = {tag + "loss": m["loss"].numpy()}
    got.update({f"{tag}p{i}": x.numpy()
                for i, x in enumerate(tree_leaves(p))})
    _hold(got, jax_out, tag, quant, n)
    # and the codec moved the update: the step without it differs
    plain = make_train_step(tc, _policy(QuantPolicy, quant), ocfg,
                            device="cpu")
    q, _, _ = plain(p0, init_train_state(p0, ocfg), batch,
                    Hyper(lr=LR, step=0), default_bits(tc, quant))
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                     tree_leaves(q)))
