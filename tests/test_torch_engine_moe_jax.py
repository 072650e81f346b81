"""Port parity of the TaxoNN layer engine on the moe family against the JAX
package's engine (``repro.core``): one step of the port's taxonn step
against JAX's, on JAX's weights, for the config and batch of
``tests/test_torch_engine_moe.py`` (kept apart from it so that each file
stays about a minute on the CPU), with the load-balance aux seeded in each
layer's VJP on both sides.

The step: momentum, ``QuantPolicy(grad_scale=64)``, ``default_bits``, lr
0.05; backends off and int8 (plain versions), and one step with
stochastic rounding under the same key (``util.prng`` draws JAX's noise)
on the off backend.  Stochastic rounding differs from JAX's where f32
reassociation moves G across the noise (ROADMAP, "Randomness"): on this
batch 3 of the 2048 elements of the G that the top layer hands down land
one grid step (2^-14 there) from JAX's.  Under int8 the next dense units
quantize their dz by its absmax, so one such element that moves a maximum
moves every int8 payload of that operand, and the first layer's attention
weights then differ from JAX's on up to 27% of their elements.  The moe
int8 stochastic step is held bitwise to a second run of itself instead
(``tests/test_torch_engine_moe.py`` on the CPU, ``chip_smoke.py``'s moe
phase on the card); the dense family's against JAX in
``tests/test_torch_engine_stochastic.py``.
JAX runs op by op (``jax.disable_jit``): jitted, its int8 rescale rounds
``acc * (s_x * s_w)`` one ulp from the op-by-op formula (ROADMAP, "Facts
about the reference"), and on this batch that ulp moves an activation
across an (I,F) rounding tie in the first layer, which shifts every
gradient after it by up to 2e-3 (1.7e-4 on the new weights).  Op by op,
JAX compiles each primitive once a process (~40 s for the first step, the
rest reuse them).

Tolerances (``tests/test_torch_engine.py``'s f32 rule): f32 sums in other
orders, |d| <= 2e-6 + 1e-5|ref|, or one more lr*2^-12 on at most 1% of the
elements (a G element at an (I,F) rounding tie may land one grid step
away); loss, aux and the total loss rel 1e-6, grad_norm rel 1e-5.
"""
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_engine import GRID  # noqa: E402
from test_torch_engine_jax import _grid_close  # noqa: E402
from test_torch_engine_moe import (_batch, _cfgs, _jparams,  # noqa: E402
                                   _leaves, _tparams)
from test_torch_engine_moe import _one_thread  # noqa: E402,F401 (autouse)

from repro.core import QuantPolicy as JQP  # noqa: E402
from repro.core import make_train_step as j_make  # noqa: E402
from repro.core.steps import default_bits as j_bits  # noqa: E402
from repro.core.steps import init_train_state as j_init  # noqa: E402
from repro.optim import Hyper as JHyper  # noqa: E402
from repro.optim import OptimizerConfig as JOCfg  # noqa: E402
from repro_torch.core import (QuantPolicy, StepOptions,  # noqa: E402
                              default_bits, init_train_state,
                              make_train_step)
from repro_torch.optim import Hyper, OptimizerConfig  # noqa: E402

LR = 0.05


def _key():
    return jax.random.key_data(jax.random.key(7))


@functools.lru_cache(maxsize=None)
def _jax_step(backend, stochastic):
    """JAX's new params (numpy) and metrics after one quantized step, op by
    op."""
    jc, _ = _cfgs()
    jp = jax.tree.map(jnp.asarray, _jparams())
    ocfg = JOCfg(kind="momentum")
    with jax.disable_jit():
        step = j_make(jc, JQP(grad_scale=64.0, kernel_backend=backend,
                              stochastic=stochastic), ocfg)
        new, _, m = step(jp, j_init(jp, ocfg),
                         {k: jnp.asarray(v) for k, v in _batch().items()},
                         JHyper(lr=jnp.float32(LR), step=jnp.int32(0)),
                         j_bits(jc), *([_key()] if stochastic else []))
    return ([np.asarray(x) for x in jax.tree.leaves(new)],
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("backend,stochastic", [("off", False),
                                                ("int8", False),
                                                ("off", True)])
def test_taxonn_step_matches_jax_quantized(backend, stochastic):
    """One quantized momentum step with the aux seeded, on both engines:
    every new leaf, the router and the expert stacks included, within the
    f32 rule; the loss, the aux, the total and the gradient norm."""
    _, tc = _cfgs()
    p0 = _tparams()
    ref, ref_m = _jax_step(backend, stochastic)
    ocfg = OptimizerConfig(kind="momentum")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0,
                                           stochastic=stochastic), ocfg,
                           StepOptions(kernel_backend=backend), device="cpu")
    new, _, m = step(p0, init_train_state(p0, ocfg), _batch(),
                     Hyper(lr=LR, step=0), default_bits(tc),
                     np.asarray(_key()) if stochastic else None)
    for k, rel in (("loss", 1e-6), ("aux", 1e-6), ("loss_total", 1e-6),
                   ("grad_norm", 1e-5)):
        assert float(m[k]) == pytest.approx(ref_m[k], rel=rel), k
    assert ref_m["aux"] > 0
    leaves = _leaves(new)
    assert len(leaves) == len(ref)
    for (k, g), r in zip(leaves, ref):
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        assert _grid_close(g, r, 2e-6, 1e-5, LR * GRID), (
            k, np.abs(g - r).max())
