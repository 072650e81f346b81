"""Port parity of ``dist/pipeline.py``: the schedules' tick tables (the
cost model, copied from the JAX package) and ``pipeline_apply``, the
stage-sharded tick loop under autograd, on one rank.

The tick tables, bubbles, peaks and summaries are plain Python and numpy:
equal to ``repro.dist.pipeline``'s over the grid of JAX's
``test_tick_tables_valid`` and ``test_bubble_ordering_and_closed_forms``,
and the errors carry JAX's texts.  ``pipeline_apply`` on a tanh stack
(JAX's ``test_pipeline_matches_sequential_and_differentiates``): every
schedule bitwise the port's sequential reference, the gradients within
f32 tolerance of sequential autograd and bitwise across the schedules;
against JAX's ``pipeline_apply`` on the same numpy inputs, values and
gradients within f32 tolerance.  The placement over a "pipe" dimension of
several ranks is tested on spawned gloo ranks in
``tests/test_torch_engine_pipeline_ranks.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import pipeline as JP
from repro_torch.dist import pipeline as TP
from test_torch_encdec import _one_thread  # noqa: E402,F401 (autouse)

# (spec, num_virtual, S, M): JAX's tick-table grid (every S, M of
# test_tick_tables_valid under each schedule that fits) and its bubble grid
# (S in 2, 3, 4, 8; M in 2S, 2S+1, 4S, 32; gpipe and 1f1b)
_TABLE_SM = ((2, 4), (2, 8), (4, 8), (4, 16), (8, 16), (8, 32), (3, 7),
             (1, 1), (4, 1))
_SPECS = (("gpipe", None), ("1f1b", None), ("interleaved", 2),
          ("interleaved", 4))
GRID = sorted({(spec, v, S, M) for S, M in _TABLE_SM for spec, v in _SPECS
               if v is None or S % v == 0}
              | {(spec, None, S, M) for S in (2, 3, 4, 8)
                 for M in (2 * S, 2 * S + 1, 4 * S, 32)
                 for spec in ("gpipe", "1f1b")}, key=str)


@pytest.mark.parametrize("spec,v,S,M", GRID)
def test_tick_tables_equal_jax(spec, v, S, M):
    t = TP.get_schedule(spec, num_virtual=v)
    j = JP.get_schedule(spec, num_virtual=v)
    tp, jp = t.plan(S, M), j.plan(S, M)
    np.testing.assert_array_equal(tp.fwd_tick, jp.fwd_tick)
    np.testing.assert_array_equal(tp.bwd_tick, jp.bwd_tick)
    for f in ("num_ticks", "busy_slots", "bubble", "num_devices",
              "num_virtual", "peak_activation_microbatches"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert t.bubble_fraction(S, M) == j.bubble_fraction(S, M)
    assert t.peak_activation_bytes(S, M, 1234) == \
        j.peak_activation_bytes(S, M, 1234)
    assert t.summary(S, M) == j.summary(S, M)
    np.testing.assert_array_equal(t.stage_of_slot(S), j.stage_of_slot(S))
    for a, b in zip(TP._slot_maps(t, S), JP._slot_maps(j, S)):
        np.testing.assert_array_equal(a, b)
    assert TP.bubble_fraction(S, M) == JP.bubble_fraction(S, M)


def _raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("case", [
    lambda P: P.get_schedule("1f1b", num_virtual=2),
    lambda P: P.get_schedule("gpipe", num_virtual=3),
    lambda P: P.get_schedule("2f2b"),
    lambda P: P.get_schedule("interleaved", num_virtual=2).validate(5, 4),
    lambda P: P.get_schedule("interleaved", num_virtual=0).validate(4),
    lambda P: P.get_schedule("gpipe").validate(0, 4),
    lambda P: P.get_schedule("1f1b").validate(4, 0),
    lambda P: P.GPipeSchedule(num_virtual=2).validate(4),
    lambda P: P.OneFOneBSchedule(num_virtual=2).plan(4, 4),
], ids=["1f1b-virtual", "gpipe-virtual", "unknown", "uneven", "virtual-0",
        "no-stages", "no-microbatches", "gpipe-class", "1f1b-class"])
def test_schedule_errors_carry_jax_texts(case):
    """JAX's ``test_uneven_virtual_stages_raise`` and the rest of the
    validation: the same ValueError texts."""
    assert _raises(lambda: case(TP)) == _raises(lambda: case(JP))


def test_get_schedule_passes_a_schedule_through():
    s = TP.get_schedule("interleaved", num_virtual=2)
    assert TP.get_schedule(s) is s
    assert TP.get_schedule(s, num_virtual=4).num_virtual == 4
    assert TP.get_schedule(None).name == "gpipe"
    assert tuple(TP.SCHEDULES) == tuple(JP.SCHEDULES)


# ---------------------------------------------------------------------------
# pipeline_apply on a tanh stack
# ---------------------------------------------------------------------------

LPS, MB, D = 2, 2, 16


def _data(S, M):
    rng = np.random.default_rng(S * 100 + M)
    w = (rng.standard_normal((S, LPS, D, D)) * D ** -0.5).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    return w, x


def _body(stage_w, h):
    for i in range(stage_w.shape[0]):
        h = torch.tanh(h @ stage_w[i])
    return h


def _seq(w, x):
    """The port's sequential reference: each microbatch through the
    stages in order."""
    outs = []
    for m in range(x.shape[0]):
        h = x[m]
        for s in range(w.shape[0]):
            h = _body(w[s], h)
        outs.append(h)
    return torch.stack(outs)


def _j_body(stage_w, h):
    for i in range(stage_w.shape[0]):
        h = jnp.tanh(h @ stage_w[i])
    return h


SCHEDULES = (("gpipe", None), ("1f1b", None), ("interleaved", 2))


@pytest.mark.parametrize("S,M", [(4, 8), (4, 2), (3, 1), (1, 5), (6, 4)])
def test_pipeline_matches_sequential_and_differentiates(S, M):
    w, x = _data(S, M)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    wg = tw.clone().requires_grad_()
    ref = _seq(wg, tx)
    g_ref, = torch.autograd.grad(torch.sum(ref ** 2), wg)
    j_got = np.asarray(JP.pipeline_apply(jnp.asarray(w), jnp.asarray(x),
                                         _j_body, schedule="gpipe"))
    j_grad = np.asarray(jax.grad(lambda w_: jnp.sum(JP.pipeline_apply(
        w_, jnp.asarray(x), _j_body, schedule="gpipe") ** 2))(
            jnp.asarray(w)))
    grads = []
    for spec, v in SCHEDULES + (() if S % 3 else (("interleaved", 3),)):
        if v is not None and S % v:
            continue
        sched = TP.get_schedule(spec, num_virtual=v)
        wg = tw.clone().requires_grad_()
        got = TP.pipeline_apply(wg, tx, _body, schedule=sched)
        assert torch.equal(got, ref.detach()), spec
        g, = torch.autograd.grad(torch.sum(got ** 2), wg)
        np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got.detach().numpy(), j_got, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(g.numpy(), j_grad, rtol=1e-4, atol=1e-5)
        grads.append(g)
    assert all(torch.equal(g, grads[0]) for g in grads)


def test_pipeline_value_tree_and_shared_operand():
    """A tree value (the activation, an f32 accumulator and an integer
    microbatch index) and a shared operand: every stage adds to the
    accumulator and reads the shared weight; the shared gradient is the
    stages' sum."""
    S, M = 4, 3
    w, x = _data(S, M)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.standard_normal((D, D)).astype(np.float32))
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)

    def body(p, v, sh):
        h = _body(p, v["h"]) @ sh * 0.5
        return {"h": h, "acc": v["acc"] + torch.sum(h), "m": v["m"]}

    def run(pipe):
        wg, ug = tw.clone().requires_grad_(), u.clone().requires_grad_()
        val = {"h": tx, "acc": torch.zeros(M), "m": torch.arange(M)}
        if pipe:
            out = TP.pipeline_apply(wg, val, body, schedule="1f1b",
                                    shared=(ug,))
        else:
            rows = []
            for m in range(M):
                v = {k: a[m] for k, a in val.items()}
                for s in range(S):
                    v = body(wg[s], v, ug)
                rows.append(v)
            out = {k: torch.stack([r[k] for r in rows]) for k in val}
        loss = torch.sum(out["h"] ** 2) + torch.sum(out["acc"])
        return out, torch.autograd.grad(loss, (wg, ug))

    (o1, g1), (o2, g2) = run(True), run(False)
    assert torch.equal(o1["m"], torch.arange(M))
    for k in ("h", "acc"):
        torch.testing.assert_close(o1[k], o2[k], rtol=1e-6, atol=1e-6)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
