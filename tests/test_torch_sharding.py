"""``dist.sharding`` and ``dist.api`` against the JAX package, with no
ranks: the twins of ``tests/test_dist_api.py`` and of the one-device cases
of ``tests/test_perf_options.py``.

* Specs: the port's ``param_pspecs``, ``opt_pspecs``, ``batch_pspecs``
  and ``decode_state_pspecs`` equal JAX's entry for entry, leaf for leaf,
  for ``tiny(family)`` of every family and every full config (JAX's
  shapes through ``jax.eval_shape``, the port's from an initialization on
  the meta device), on a ``data x model`` mesh record with model 1, 2, 4
  and 8 (a ``SimpleNamespace``, as ``test_seq_parallel_never_steals_
  vocab_axis`` takes one).
* Rules: ``make_default_rules`` and ``_spec_for`` over a grid of tags,
  ranks, shapes and meshes; ``perf_options_ctx`` scopes and raises as
  JAX's; ``constrain`` returns ``x`` itself.
* Shards: ``shard_tree`` at every coordinate, joined along each spec's
  model dimension, is the tree bitwise (``gather_tree`` joins them over
  ranks in ``tests/test_torch_tp_ranks.py``).
* The perf-option legs against JAX on the CPU: ``ce_bf16`` within JAX's
  3% of the f32 loss (and close to JAX's own bf16 head), ``flash_attn``
  at T = 1040 within f32 tolerance of JAX's and of the full path,
  ``seq_parallel`` the plain loss.
* The int32 epilogues: each plain version's int32 sums, rescaled once,
  are bitwise its rescaling version; a product split over K (the
  row-parallel forward) or N (the column-parallel dx) with the logical
  scales sums to the unsplit product bitwise; the modes' tune-cache keys
  are their own.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as JC
from repro.core.steps import init_train_state as j_init_state
from repro.dist import api as JA
from repro.dist import sharding as JS
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.optim import OptimizerConfig as JOCfg
from repro.serving.engine import init_decode_state as j_decode_state
from repro_torch import configs as TC
from repro_torch.core.steps import init_train_state as t_init_state
from repro_torch.dist import api as TA
from repro_torch.dist import sharding as TS
from repro_torch.kernels import common as KC
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels.bp_gstep import bp_gstep
from repro_torch.kernels.fxp_matmul import fxp_matmul
from repro_torch.models import layers as TL
from repro_torch.models import lm as TLM
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig as TOCfg
from repro_torch.serving.engine import init_decode_state as t_decode_state
from test_models import FAMILIES, make_batch, tiny

MODEL_SIZES = (1, 2, 4, 8)
CONFIGS = ([("tiny", f) for f in FAMILIES]
           + [("full", a) for a in JC.ARCH_NAMES])


def _mesh(m: int, data: int = 2, pod: int = 0):
    names = (("pod",) if pod else ()) + ("data", "model")
    shape = ({"pod": pod} if pod else {}) | {"data": data, "model": m}
    return SimpleNamespace(axis_names=names, shape=shape)


@functools.lru_cache(maxsize=None)
def _configs(kind: str, name: str):
    if kind == "tiny":
        jc = tiny(name)
        return jc, ModelConfig(**dataclasses.asdict(jc))
    return JC.get_config(name), TC.get_config(name)


@functools.lru_cache(maxsize=None)
def _shapes(kind: str, name: str):
    """JAX's parameter, momentum8 state and decode state shapes, and the
    port's (meta tensors)."""
    jc, tc = _configs(kind, name)
    jp = jax.eval_shape(lambda: JLM.init_params(jax.random.key(0), jc))
    js = jax.eval_shape(lambda: j_init_state(jp, JOCfg(kind="momentum8")))
    jd = jax.eval_shape(lambda: j_decode_state(jc, 4, 32))
    tp = TLM.init_params(tc, device="meta")
    ts = t_init_state(tp, TOCfg(kind="momentum8"))
    td = t_decode_state(tc, 4, 32, device="meta")
    return (jp, js, jd), (tp, ts, td)


def _jax_flat(specs) -> dict:
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda x: isinstance(x, JP)):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(s)
    return out


def _port_flat(specs, pre: str = "") -> dict:
    if isinstance(specs, dict):
        out = {}
        for k in sorted(specs):
            out.update(_port_flat(specs[k], f"{pre}{k}/"))
        return out
    assert isinstance(specs, TS.P), specs
    return {pre[:-1]: tuple(specs)}


@pytest.mark.parametrize("m", MODEL_SIZES)
@pytest.mark.parametrize("kind,name", CONFIGS)
def test_specs_equal_jax_leaf_for_leaf(kind, name, m):
    (jp, js, jd), (tp, ts, td) = _shapes(kind, name)
    jc, tc = _configs(kind, name)
    mesh = _mesh(m)
    jpp, tpp = JS.param_pspecs(jc, jp, mesh), TS.param_pspecs(tc, tp, mesh)
    assert _port_flat(tpp) == _jax_flat(jpp)
    assert (_port_flat(TS.opt_pspecs(tc, ts, tpp, mesh))
            == _jax_flat(JS.opt_pspecs(jc, js, jpp, mesh)))
    assert (_port_flat(TS.decode_state_pspecs(tc, td, mesh))
            == _jax_flat(JS.decode_state_pspecs(jc, jd, mesh)))
    batch = make_batch(jc, b=4, t=16)
    tb = {k: torch.empty(v.shape, device="meta") for k, v in batch.items()}
    for data in (2, 4, 3):
        bm = _mesh(m, data=data, pod=2 if data == 4 else 0)
        assert (_port_flat(TS.batch_pspecs(tb, bm))
                == _jax_flat(JS.batch_pspecs(batch, bm)))
    if kind == "tiny" and name == "dense" and m == 2:
        # the placements the JAX test names, and the placement records
        assert tpp["embed"] == TS.P("model", None)
        assert tpp["blocks"]["attn"]["wq"] == TS.P(None, None, "model", None)
        assert tpp["blocks"]["attn"]["wo"] == TS.P(None, "model", None, None)
        assert tpp["blocks"]["mlp"]["w_down"] == TS.P(None, "model", None)
        named = TS.to_named(tpp, mesh)
        assert named["embed"] == TS.Placement(mesh, TS.P("model", None))
        assert all(pl.spec == TS.P() for pl in _leaves_of(
            TS.replicated(tpp, mesh)))


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    return [tree]


# ---------------------------------------------------------------------------
# Rules, perf options, constrain
# ---------------------------------------------------------------------------

def _norm_rules(rules: dict, unconstrained) -> dict:
    return {k: "UNCONSTRAINED" if v is unconstrained else v
            for k, v in rules.items()}


@pytest.mark.parametrize("batch_axes", (("data",), ("pod", "data")))
@pytest.mark.parametrize("seq_parallel", (False, True))
def test_rules_tables_equal_jax(batch_axes, seq_parallel):
    j = JA.make_default_rules(batch_axes, seq_parallel=seq_parallel)
    t = TA.make_default_rules(batch_axes, seq_parallel=seq_parallel)
    assert _norm_rules(t, TA.UNCONSTRAINED) == _norm_rules(
        j, JA.UNCONSTRAINED)


TAGS = ("btd", "btv", "bv", "lnshd", "lns", "becd", "btf", "bte", "bthk",
        "d", "tv")
SHAPES = ((4, 8, 128), (3, 6, 10), (8, 16, 32, 4, 2), (2, 4), (6,),
          (4, 4, 4, 4), (16, 8, 12, 2, 64))


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("seq_parallel", (False, True))
def test_spec_for_equals_jax(tag, seq_parallel):
    for pod, data, m in ((0, 2, 2), (0, 1, 4), (2, 2, 2), (0, 4, 1),
                         (0, 3, 8)):
        mesh = _mesh(m, data=data, pod=pod)
        for baxes in (("data",), ("pod", "data") if pod else ("data",)):
            jr = JA.make_default_rules(baxes, seq_parallel=seq_parallel)
            tr = TA.make_default_rules(baxes, seq_parallel=seq_parallel)
            for shape in SHAPES:
                j = JA._spec_for(tag, len(shape), jr, mesh, shape)
                t = TA._spec_for(tag, len(shape), tr, mesh, shape)
                if j is None:
                    assert t is None
                    continue
                want = tuple("U" if e is JA.UNCONSTRAINED else e for e in j)
                got = tuple("U" if e is TA.UNCONSTRAINED else e for e in t)
                assert got == want, (tag, shape, mesh.shape)


def test_seq_parallel_never_steals_vocab_axis():
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 2})
    rules = TA.make_default_rules(("data",), seq_parallel=True)
    assert TA._spec_for("btv", 3, rules, mesh, (4, 8, 128)) == \
        TS.P("data", None, "model")
    assert TA._spec_for("btd", 3, rules, mesh, (4, 8, 128)) == \
        TS.P("data", "model", None)


def test_perf_options_scope_and_raise_as_jax():
    assert TA.KNOWN_PERF_OPTS == JA.KNOWN_PERF_OPTS
    assert not TA.perf_opt("ce_bf16")
    with TA.perf_options_ctx({"ce_bf16", "seq_parallel"}):
        assert TA.perf_opt("ce_bf16") and TA.perf_opt("seq_parallel")
        assert not TA.perf_opt("moe_rowcombine")
        with TA.perf_options_ctx({"flash_attn"}):
            assert TA.perf_opt("flash_attn") and TA.perf_opt("ce_bf16")
        assert not TA.perf_opt("flash_attn")
    assert not TA.perf_opt("ce_bf16")
    with pytest.raises(ValueError) as t_err:
        with TA.perf_options_ctx({"not_a_real_option"}):
            pass
    with pytest.raises(ValueError) as j_err:
        with JA.perf_options_ctx({"not_a_real_option"}):
            pass
    assert str(t_err.value) == str(j_err.value)


def test_constrain_returns_x_itself():
    x = torch.arange(12.0).reshape(3, 4)
    assert TA.constrain(x, "btd") is x
    with TA.activation_sharding_ctx(TA.make_default_rules(("data",))):
        assert TA.current_rules()["v"] == "model"
        assert TA.constrain(x, "btd") is x
    assert TA.current_rules() is None
    assert TA.model_axis_size_ctx() == 1


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("family", ("dense", "moe", "hybrid"))
def test_shards_join_back_bitwise(family, m):
    _, tc = _configs("tiny", family)
    params = TLM.init_params(tc, seed=3, device="cpu")
    mesh = _mesh(m)
    specs = TS.param_pspecs(tc, params, mesh)
    shards = [TS.shard_tree(params, specs, mesh, index=r) for r in range(m)]

    def join(path_specs, *parts):
        d = TS.model_dim(path_specs)
        if d is None:
            assert all(torch.equal(p, parts[0]) for p in parts)
            return parts[0]
        assert all(p.shape[d] * m == parts[0].shape[d] * m for p in parts)
        return torch.cat(parts, dim=d)

    def walk(s, *trees):
        if isinstance(s, dict):
            return {k: walk(s[k], *(t[k] for t in trees)) for k in s}
        return join(s, *trees)

    joined = walk(specs, *shards)
    for (k, a), (_, b) in zip(_flat(params), _flat(joined)):
        assert torch.equal(a, b), k
    one = _mesh(1)
    assert TS.gather_tree(params, TS.param_pspecs(tc, params, one),
                          one) is params


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       f"{pre}{k}/")]
    return [(pre, tree)]


# ---------------------------------------------------------------------------
# The perf-option legs against JAX
# ---------------------------------------------------------------------------

def _port_params(jc, jp):
    tc = ModelConfig(**dataclasses.asdict(jc))
    return tc, TLM.params_from_numpy(jax.tree.map(np.asarray, jp),
                                     device="cpu")


def test_ce_bf16_within_jax_limit():
    jc = tiny("dense", compute_dtype="bfloat16")
    jp = JLM.init_params(jax.random.key(0), jc)
    batch = make_batch(jc, t=32)
    tc, tp = _port_params(jc, jp)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    j_f32 = float(JLM.loss_fn(jp, jc, batch)[0])
    with JA.perf_options_ctx({"ce_bf16"}):
        j_bf16 = float(JLM.loss_fn(jp, jc, batch)[0])
    t_f32 = float(TLM.loss_fn(tp, tc, tb)[0])
    with TA.perf_options_ctx({"ce_bf16"}):
        t_bf16 = float(TLM.loss_fn(tp, tc, tb)[0])
    assert abs(t_bf16 - j_f32) < 0.03 * abs(j_f32), (t_bf16, j_f32)
    assert abs(t_bf16 - t_f32) < 0.03 * abs(t_f32)
    assert abs(t_bf16 - j_bf16) < 1e-3 * abs(j_bf16), (t_bf16, j_bf16)
    assert t_bf16 != t_f32          # the leg changes the head


def test_flash_attn_chunks_above_1024():
    jc = tiny("dense")
    jp = JL.init_attention(jax.random.key(2), jc)
    x = jax.random.normal(jax.random.key(3), (1, 1040, jc.d_model))
    pos = jnp.broadcast_to(jnp.arange(1040), (1, 1040))
    tc = ModelConfig(**dataclasses.asdict(jc))
    tp = TLM.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    tx = torch.from_numpy(np.asarray(x))
    tpos = torch.from_numpy(np.asarray(pos))
    with JA.perf_options_ctx({"flash_attn"}):
        j = np.asarray(JL.attention(jp, x, jc, pos))
    full = TL.attention(tp, tx, tc, tpos).numpy()
    with TA.perf_options_ctx({"flash_attn"}):
        t = TL.attention(tp, tx, tc, tpos).numpy()
    np.testing.assert_allclose(t, j, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(t, full, atol=2e-5, rtol=1e-5)
    assert not np.array_equal(t, full)      # the chunked path ran


def test_seq_parallel_is_the_plain_loss():
    jc = tiny("dense")
    jp = JLM.init_params(jax.random.key(0), jc)
    batch = make_batch(jc, t=32)
    tc, tp = _port_params(jc, jp)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    base = TLM.loss_fn(tp, tc, tb)[0]
    with TA.perf_options_ctx({"seq_parallel"}), TA.activation_sharding_ctx(
            TA.make_default_rules(("data",), seq_parallel=True)):
        sp = TLM.loss_fn(tp, tc, tb)[0]
    assert torch.equal(base, sp)
    assert abs(float(sp) - float(JLM.loss_fn(jp, jc, batch)[0])) < 1e-5


# ---------------------------------------------------------------------------
# The int32 epilogues
# ---------------------------------------------------------------------------

def _payloads(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)


@pytest.mark.parametrize("m,k,n", ((16, 256, 48), (33, 100, 7), (1, 64, 5)))
def test_int32_modes_rescale_to_the_rescaling_versions(m, k, n):
    qx, qw, qg = _payloads((m, k), 1), _payloads((k, n), 2), _payloads(
        (m, n), 3)
    scale = torch.tensor(3.0517578e-05 * 0.7, dtype=torch.float32)
    acc = ref.int8_payload_ref(qx, qw, None, out_bits=None)
    assert acc.dtype == torch.int32
    want = ref.int8_payload_ref(qx, qw, scale, out_bits=None)
    assert torch.equal(kops.rescale_int32(acc, scale), want)
    assert torch.equal(fxp_matmul(qx, qw, out_bits=None, datapath="int8",
                                  int32_out=True), acc)
    acc_g = ref.bp_gstep_payload_ref(qg, qw, None, None, g_bits=None,
                                     act="identity")
    want_g = ref.bp_gstep_payload_ref(qg, qw, None, scale, g_bits=None,
                                      act="identity")
    assert torch.equal(kops.rescale_int32(acc_g, scale), want_g)
    assert torch.equal(bp_gstep(qg, qw, None, g_bits=None, act="identity",
                                datapath="int8", int32_out=True), acc_g)
    with pytest.raises(ValueError):
        fxp_matmul(qx, qw, datapath="int8", int32_out=True)  # out_bits set
    with pytest.raises(ValueError):
        bp_gstep(qg, qw, None, act="identity", datapath="int8",
                 int32_out=True)                            # g_bits set


@pytest.mark.parametrize("parts", (2, 4))
def test_split_products_sum_to_the_unsplit_product(parts):
    """The row-parallel forward (K split) and the column-parallel dx (N
    split), each share's absmax taken to the logical tensor's max, sum
    their int32 partials to the one-rank product bitwise."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(24, 64, generator=g)
    w = torch.randn(64, 40, generator=g)
    dz = torch.randn(24, 40, generator=g)
    xs, ws = x.chunk(parts, dim=1), w.chunk(parts, dim=0)
    amax = lambda ts: (lambda _: max(t.abs().max() for t in ts))  # noqa: E731
    acc, scale = None, None
    for xp, wp in zip(xs, ws):
        a, scale = kops.dense_fwd_partial(xp, wp, "int8", rx=amax(xs),
                                          rw=amax(ws))
        acc = a if acc is None else acc + a
    assert torch.equal(kops.rescale_int32(acc, scale),
                       kops.dense_fwd(x, w, "int8"))
    wn, dzn = w.chunk(parts, dim=1), dz.chunk(parts, dim=1)
    acc = None
    for dp, wp in zip(dzn, wn):
        a, scale = kops.dense_bwd_dx_partial(dp, wp, "int8", rdz=amax(dzn),
                                             rw=amax(wn))
        acc = a if acc is None else acc + a
    assert torch.equal(kops.rescale_int32(acc, scale),
                       kops.dense_bwd_dx(dz, w, "int8"))
    # the scales left local: the shares no longer sum to it
    acc = sum(kops.dense_fwd_partial(xp, wp, "int8")[0]
              for xp, wp in zip(xs, ws))
    assert not torch.equal(kops.rescale_int32(acc, scale),
                           kops.dense_fwd(x, w, "int8"))


def test_int32_modes_have_their_own_tune_keys():
    from repro_torch.kernels import bp_gstep as GS
    from repro_torch.kernels import fxp_matmul as FM
    KC.clear_tune_cache()
    try:
        p32 = FM.tuned_plan(1024, 512, 1024, 132, "int32", 1, 1)
        p8 = FM.tuned_plan(1024, 512, 1024, 132, "int8", 1, 1)
        g32 = GS.tuned_plan(1024, 512, 1408, 132, "int32")
        g8 = GS.tuned_plan(1024, 512, 1408, 132, "int8")
        assert p32 == p8 and g32 == g8
        snap = KC.tune_cache_snapshot()
        assert "kind=fxp_matmul,m=1024,n=1024,k=512,dp=int32,xb=1,wb=1" in snap
        assert "kind=bp_gstep,m=1024,n=512,k=1408,dp=int32" in snap
        assert len(snap) == 4
        KC.clear_tune_cache()
        assert KC.load_tune_cache(snap) == 4
    finally:
        KC.clear_tune_cache()
