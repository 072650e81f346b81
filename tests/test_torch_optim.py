"""Port parity of ``repro_torch.optim`` against the JAX package's
``repro.optim``: ``apply_update`` for sgd, momentum, momentum8 and adam
(with and without weight decay and gradient clipping) over 3 steps, and
the learning-rate schedules.

The parameter tree mimics one engine layer slice and the boundary group: a
stacked [L, 8, 6] matrix, a [6] vector (a norm scale, whose momentum8
scale is a scalar) and a [5, 7] matrix.  Weights and gradients are numpy
arrays from a seed, handed to both frameworks.

Tolerance: both sides run the same f32 operations in the same order, one
at a time (JAX eagerly, so XLA fuses nothing), so the results agree to
|d| <= 1e-7 + 1e-6 |ref| (observed bitwise for sgd and momentum; adam's
bias correction ``beta ** t`` may round an ulp apart between the two
pow implementations).  momentum8's int8 buffers must agree exactly, except
where an ulp of m_new lands on a half-step tie: at most one int8 step, on
at most 1% of the elements.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import Hyper as JHyper
from repro.optim import OptimizerConfig as JCfg
from repro.optim import apply_update as j_apply
from repro.optim import constant_schedule as j_const
from repro.optim import cosine_schedule as j_cos
from repro.optim import init_opt_state as j_init
from repro_torch.optim import Hyper as THyper
from repro_torch.optim import OptimizerConfig as TCfg
from repro_torch.optim import apply_update as t_apply
from repro_torch.optim import constant_schedule as t_const
from repro_torch.optim import cosine_schedule as t_cos
from repro_torch.optim import init_opt_state as t_init
from repro_torch.util.tree import tree_leaves, tree_map

SHAPES = {"blocks": {"w": (3, 8, 6)}, "norm": (6,), "head": (5, 7)}


def _tree(rng, scale):
    def make(shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"blocks": {"w": make(SHAPES["blocks"]["w"])},
            "norm": make(SHAPES["norm"]), "head": make(SHAPES["head"])}


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_j(tree):
    return tree_map(jnp.asarray, tree)


def _close(t, j, what):
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype and t.shape == j.shape, what
    np.testing.assert_allclose(t, j, atol=1e-7, rtol=1e-6, err_msg=what)


@pytest.mark.parametrize("kind", ["sgd", "momentum", "momentum8", "adam"])
@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (0.01, 0.5)])
@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
def test_apply_update_three_steps(kind, wd, clip, lr_kind):
    rng = np.random.default_rng(0)
    p = _tree(rng, 0.5)
    tc = TCfg(kind=kind, weight_decay=wd, grad_clip=clip)
    jc = JCfg(kind=kind, weight_decay=wd, grad_clip=clip)
    tp, jp = _to_t(p), _to_j(p)
    ts, js = t_init(tp, tc), j_init(jp, jc)
    for step in range(3):
        g = _tree(rng, 0.1)
        lr = 0.05 / (step + 1)
        th = THyper(lr=lr if lr_kind == "float" else torch.tensor(
            lr, dtype=torch.float32), step=step)
        jh = JHyper(lr=jnp.float32(lr), step=jnp.int32(step))
        tp, ts = t_apply(tp, _to_t(g), ts, th, tc)
        jp, js = j_apply(jp, _to_j(g), js, jh, jc)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        _close(a, b, f"{kind} params")
    assert sorted(ts) == sorted(js)
    for name in ts:
        for a, b in zip(tree_leaves(ts[name]), jax.tree.leaves(js[name])):
            if a.dtype == torch.int8:
                d = np.abs(a.numpy().astype(np.int32)
                           - np.asarray(b).astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 0.01, name
            else:
                _close(a, b, f"{kind} state {name}")


def test_init_opt_state_shapes():
    p = _to_t(_tree(np.random.default_rng(1), 1.0))
    for kind in ("sgd", "momentum", "momentum8", "adam"):
        ts = t_init(p, TCfg(kind=kind))
        js = j_init(_to_j(tree_map(lambda t: t.numpy(), p)), JCfg(kind=kind))
        assert sorted(ts) == sorted(js)
        for name in ts:
            for a, b in zip(tree_leaves(ts[name]), jax.tree.leaves(js[name])):
                assert tuple(a.shape) == b.shape
                assert str(a.dtype).split(".")[-1] == str(b.dtype)
    with pytest.raises(ValueError):
        t_init(p, TCfg(kind="lamb"))


def test_schedules_match():
    for t, j in ((t_const(0.1), j_const(0.1)),
                 (t_cos(3e-3, 10, 100), j_cos(3e-3, 10, 100)),
                 (t_cos(1.0, 0, 7, 0.25), j_cos(1.0, 0, 7, 0.25))):
        assert [t(s) for s in range(120)] == [j(s) for s in range(120)]
