"""Port parity of the TaxoNN layer engine on the ssm and hybrid families
against the JAX package's engine (``repro.core``) with quantization on:
one step of the port's taxonn step against JAX's, on JAX's weights, for
the configs and batches of ``tests/test_torch_engine_ssm.py`` (kept apart
from it so that each file stays well under a minute on the CPU).

The step: momentum, ``QuantPolicy(grad_scale=64)``, ``default_bits`` (the
hybrid's units are its groups: the shared block and the group's Mamba2
weights take the group's weight format, A_log and dt_bias too), lr 0.05,
JAX jitted; backends off and int8 (plain versions), and one int8 hybrid
step with stochastic rounding under the same key (``util.prng`` draws
JAX's noise).

Tolerances (``tests/test_torch_engine.py``'s f32 rule): f32 sums in other
orders, |d| <= 2e-6 + 1e-5|ref|, or one more lr*2^-12 on at most 1% of the
elements (a G element at an (I,F) rounding tie may land one grid step
away); loss rel 1e-6, grad_norm rel 1e-5.  A bf16 twin is not held here:
JAX run op by op takes 21 s (ssm) to 71 s (hybrid) a step on the CPU.
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
from test_torch_engine_ssm import (_batch, _cfgs, _jparams,  # noqa: E402
                                   _leaves, _tparams)
from test_torch_engine_ssm import _one_thread  # noqa: E402,F401 (autouse)

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
def _jax_step(family, backend, stochastic):
    """JAX's new params (numpy) and metrics after one quantized step."""
    jc, _ = _cfgs(family)
    jp = _jparams(family)
    ocfg = JOCfg(kind="momentum")
    step = jax.jit(j_make(jc, JQP(grad_scale=64.0, kernel_backend=backend,
                                  stochastic=stochastic), ocfg))
    new, _, m = step(jp, j_init(jp, ocfg),
                     {k: jnp.asarray(v) for k, v in _batch().items()},
                     JHyper(lr=jnp.float32(LR), step=jnp.int32(0)),
                     j_bits(jc), *([_key()] if stochastic else []))
    return ([np.asarray(x) for x in jax.tree.leaves(new)],
            {k: float(v) for k, v in m.items()})


@pytest.mark.parametrize("family,backend,stochastic", [
    ("ssm", "off", False), ("ssm", "int8", False),
    ("hybrid", "off", False), ("hybrid", "int8", False),
    ("hybrid", "int8", True)])
def test_taxonn_step_matches_jax_quantized(family, backend, stochastic):
    _, tc = _cfgs(family)
    p0 = _tparams(family)
    ref, ref_m = _jax_step(family, backend, stochastic)
    ocfg = OptimizerConfig(kind="momentum")
    step = make_train_step(tc, QuantPolicy(grad_scale=64.0,
                                           stochastic=stochastic), ocfg,
                           StepOptions(kernel_backend=backend), device="cpu")
    new, _, m = step(p0, init_train_state(p0, ocfg), _batch(),
                     Hyper(lr=LR, step=0), default_bits(tc),
                     np.asarray(_key()) if stochastic else None)
    assert float(m["loss"]) == pytest.approx(ref_m["loss"], rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(ref_m["grad_norm"],
                                                  rel=1e-5)
    assert float(m["tokens"]) == ref_m["tokens"]
    leaves = _leaves(new)
    assert len(leaves) == len(ref)
    for (k, g), r in zip(leaves, ref):
        g = g.numpy()
        assert g.shape == r.shape and g.dtype == r.dtype, k
        assert _grid_close(g, r, 2e-6, 1e-5, LR * GRID), (
            k, np.abs(g - r).max())
