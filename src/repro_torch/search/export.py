"""Train -> serve export: turn a searched ``BitPlan`` into the serving
engine's int8 configuration, with a provable numerics contract (port of
``search/export.py``).

The contract has three parts, each checked bit for bit by
``verify_train_serve_parity``:

1. **Grid embedding** — a train-time (I,F) format with bitwidth <= 8
   embeds into int8 *exactly*: payload is the fixed-point integer ``k``,
   scale is ``2^-F``, so ``dequantize(quantize_int8_fxp(x_q)) == x_q``
   for any ``x_q`` already on the (I,F) grid.  Wider formats keep their
   8 MSBs: the serve-side value equals train-time quantization at the
   effective format ``(I, F - shift)`` — the precision loss is exactly
   "drop ``shift`` low fractional bits", nothing else.
2. **KV cache** — the per-token absmax rule used by the paged int8 pool
   (``serving.engine.quant_kv_rows``) is restated here
   (``kv_reference``) and held bitwise equal, so the exported config
   documents precisely what the serving cache stores.
3. **Decode prologue** — the fused int8 decode prologue consumes
   weights quantized by the rule exported here
   (``export_prologue_weights``): ``decode_prologue`` under the int8
   backend (the CUDA kernel on the card) is bitwise equal to the plain
   version (``prologue_plain``) fed those exported payloads.

The checks run on the card unless the caller names another ``device``.
Their keys are ``util.prng`` keys (JAX's threefry): the grid-embedding
inputs are JAX's ``uniform`` draws bit for bit; the KV and prologue
inputs are normal draws from a CPU ``torch.Generator`` seeded with the
key's words (the port does not reproduce ``jax.random.normal``), the same
on every device.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import torch

from repro_torch import resolve_device
from repro_torch.quant.fixed_point import quantize
from repro_torch.quant.int8 import (dequantize_int8, int8_spec,
                                    quantize_int8_absmax, quantize_int8_fxp,
                                    transport_bits)
from repro_torch.search.plan import BitPlan
from repro_torch.util import prng

SERVE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class LayerQuant:
    """One layer's serve-side quantization: either the exact (I,F) grid
    ("fxp", bitwidth <= 8) or dynamic per-tensor absmax ("absmax")."""

    layer: int
    i_bits: int
    f_bits: int
    mode: str          # "fxp" | "absmax"
    scale: float       # int8 scale for fxp mode (2^(shift-F))
    qmin: int
    qmax: int
    shift: int         # dropped low fractional bits (0 = exact embedding)

    @property
    def exact(self) -> bool:
        return self.shift == 0

    @property
    def eff_f_bits(self) -> int:
        """Fractional bits that survive the int8 embedding."""
        return self.f_bits - self.shift


@dataclasses.dataclass(frozen=True)
class ServeQuantPlan:
    """The serving-side rendering of a trained ``BitPlan``."""

    layers: Tuple[LayerQuant, ...]
    cache_dtype: str = "int8"      # ServeConfig.cache_dtype
    kernel_backend: str = "int8"   # kernel datapath for the prologue

    def serve_config_kwargs(self) -> dict:
        """kwargs to splat into ``serving.ServeConfig``."""
        return {"cache_dtype": torch.int8}

    def to_json(self) -> dict:
        return {
            "schema": SERVE_SCHEMA,
            "cache_dtype": self.cache_dtype,
            "kernel_backend": self.kernel_backend,
            "kv_rule": "per-token absmax: scale=max(|row|,1e-8)/127, "
                       "payload=clip(round(x/scale),-127,127)",
            "layers": [dataclasses.asdict(lq) for lq in self.layers],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ServeQuantPlan":
        if obj.get("schema", 1) != SERVE_SCHEMA:
            raise ValueError(f"unknown ServeQuantPlan schema {obj.get('schema')}")
        layers = tuple(
            LayerQuant(layer=int(l["layer"]), i_bits=int(l["i_bits"]),
                       f_bits=int(l["f_bits"]), mode=str(l["mode"]),
                       scale=float(l["scale"]), qmin=int(l["qmin"]),
                       qmax=int(l["qmax"]), shift=int(l["shift"]))
            for l in obj["layers"])
        return cls(layers=layers, cache_dtype=str(obj["cache_dtype"]),
                   kernel_backend=str(obj["kernel_backend"]))


def to_serve_plan(plan: BitPlan) -> ServeQuantPlan:
    """Render each layer's trained (I,F) format as its int8 serving rule."""
    layers = []
    for idx, (i_b, f_b) in enumerate(plan.formats()):
        if i_b > 7:
            raise ValueError(
                f"layer {idx} format ({i_b},{f_b}): I > 7 cannot keep its "
                f"MSBs in int8 (effective F would be negative)")
        spec = int8_spec(i_b, f_b)
        mode = "fxp" if transport_bits((i_b, f_b)) is not None else "absmax"
        layers.append(LayerQuant(
            layer=idx, i_bits=i_b, f_bits=f_b, mode=mode, scale=spec.scale,
            qmin=spec.qmin, qmax=spec.qmax, shift=spec.shift))
    return ServeQuantPlan(layers=tuple(layers))


def save_serve_plan(sp: ServeQuantPlan, path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(sp.to_json(), f, indent=2, sort_keys=True)
        f.write("\n")


def load_serve_plan(path: str) -> ServeQuantPlan:
    with open(path) as f:
        return ServeQuantPlan.from_json(json.load(f))


# ---------------------------------------------------------------------------
# The exported numerics rules (restated independently of the engine)
# ---------------------------------------------------------------------------

def kv_reference(x: torch.Tensor):
    """The exported KV-cache rule — must stay bitwise equal to
    ``serving.engine.quant_kv_rows``."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=(1, 2))
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[:, None, None]), -127, 127)
    return q.to(torch.int8), scale


def export_prologue_weights(attn_params: dict):
    """The exported decode-prologue weight rule: per-tensor absmax int8 on
    the 2D-reshaped QKV projections, scales stacked [3] — exactly what
    ``kernels.decode_prologue`` computes internally under the int8 backend.

    Returns ``(qwq, qwk, qwv, wscales)`` ready for ``prologue_plain``.
    """
    wq, wk, wv = attn_params["wq"], attn_params["wk"], attn_params["wv"]
    d, h, hd = wq.shape
    hkv = wk.shape[1]
    qwq, swq = quantize_int8_absmax(wq.reshape(d, h * hd))
    qwk, swk = quantize_int8_absmax(wk.reshape(d, hkv * hd))
    qwv, swv = quantize_int8_absmax(wv.reshape(d, hkv * hd))
    return qwq, qwk, qwv, torch.stack([swq, swk, swv])


def serve_layer_quant(x: torch.Tensor, lq: LayerQuant):
    """Apply one exported layer rule to a tensor: (payload, scale)."""
    if lq.mode == "fxp":
        return quantize_int8_fxp(x, lq.i_bits, lq.f_bits)
    return quantize_int8_absmax(x)


# ---------------------------------------------------------------------------
# The conformance checks
# ---------------------------------------------------------------------------

def _uniform(key, shape, minval: float, maxval: float, dev):
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` bit for
    bit: ``max(minval, u * (maxval - minval) + minval)`` with the product
    and the sum rounded once, as XLA contracts them into one FMA (exact in
    f64: a 24-bit u times a 2-bit span plus minval fits in 53 bits)."""
    u = prng.uniform(key, shape, device=dev).to(torch.float64)
    lo = torch.tensor(minval, dtype=torch.float32).item()
    span = (torch.tensor(maxval, dtype=torch.float32)
            - torch.tensor(minval, dtype=torch.float32)).item()
    return torch.clamp_min((u * span + lo).to(torch.float32), lo)


def _normal(key, shape, dev):
    """Standard normal draws of ``shape`` from a CPU generator seeded with
    the key's two words, on ``dev``."""
    k0, k1 = (int(w) for w in prng.as_key(key))
    gen = torch.Generator()
    gen.manual_seed((k0 << 32) | k1)
    return torch.randn(shape, generator=gen).to(dev)


def check_grid_embedding(plan: BitPlan, key=None, device=None) -> dict:
    """Part 1 of the contract, per layer of the plan.

    For tensors already on the train-time (I,F) grid, the serve-side
    dequantized value must equal train-time quantization at the effective
    format (I, F - shift) bitwise — and the tensor itself when the format
    embeds exactly (bitwidth <= 8).
    """
    dev = resolve_device(device)
    key = key if key is not None else prng.key(0)
    max_diff_msb = 0.0
    max_diff_exact = 0.0
    for idx, (i_b, f_b) in enumerate(plan.formats()):
        spec = int8_spec(i_b, f_b)
        k = prng.fold_in(key, idx)
        # span the representable range including saturation edges
        x = _uniform(k, (512,), -1.5 * 2.0 ** i_b, 1.5 * 2.0 ** i_b, dev)
        x_q = quantize(x, i_b, f_b)
        payload, scale = quantize_int8_fxp(x_q, i_b, f_b)
        deq = dequantize_int8(payload, scale)
        want = quantize(x_q, i_b, f_b - spec.shift)
        max_diff_msb = max(max_diff_msb,
                           float(torch.max(torch.abs(deq - want))))
        if spec.exact:
            max_diff_exact = max(max_diff_exact,
                                 float(torch.max(torch.abs(deq - x_q))))
    return {"grid_msb_max_diff": max_diff_msb,
            "grid_exact_max_diff": max_diff_exact,
            "ok": max_diff_msb == 0.0 and max_diff_exact == 0.0}


def check_kv_parity(key=None, rows: int = 64, heads: int = 4,
                    head_dim: int = 16, device=None) -> dict:
    """Part 2: exported KV rule == the engine's, payloads and scales."""
    from repro_torch.serving import engine

    dev = resolve_device(device)
    key = key if key is not None else prng.key(1)
    x = 3.0 * _normal(key, (rows, heads, head_dim), dev)
    q_eng, s_eng = engine.quant_kv_rows(x)
    q_exp, s_exp = kv_reference(x)
    payload_diff = int(torch.max(torch.abs(
        q_eng.to(torch.int32) - q_exp.to(torch.int32))))
    scale_diff = float(torch.max(torch.abs(s_eng - s_exp)))
    return {"kv_payload_max_diff": payload_diff,
            "kv_scale_max_diff": scale_diff,
            "ok": payload_diff == 0 and scale_diff == 0.0}


def check_prologue_parity(key=None, device=None) -> dict:
    """Part 3: ``decode_prologue`` under the int8 backend (one launch of the
    CUDA kernel on the card) == ``prologue_plain`` fed weights quantized by
    the exported rule, bitwise."""
    from repro_torch.kernels import decode_prologue as DP
    from repro_torch.kernels import ops as kops
    from repro_torch.models.config import ModelConfig

    dev = resolve_device(device)
    key = key if key is not None else prng.key(2)
    cfg = ModelConfig(name="bit-export-parity", family="dense", num_layers=1,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=64,
                      vocab_size=64, compute_dtype="float32")
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = [prng.fold_in(key, i) for i in range(5)]
    norm = {"scale": 1.0 + 0.1 * _normal(ks[0], (d,), dev)}
    attn = {"wq": _normal(ks[1], (d, h, hd), dev) * 0.1,
            "wk": _normal(ks[2], (d, hkv, hd), dev) * 0.1,
            "wv": _normal(ks[3], (d, hkv, hd), dev) * 0.1}
    x = _normal(ks[4], (3, 1, d), dev)
    pos = torch.tensor([0, 5, 17], dtype=torch.int32, device=dev)

    qwq, qwk, qwv, wscales = export_prologue_weights(attn)
    want = DP.prologue_plain(
        x[:, 0, :], norm["scale"], qwq, qwk, qwv, None, pos, wscales=wscales,
        use_rope=bool(cfg.use_rope), theta=float(cfg.rope_theta),
        eps=float(cfg.norm_eps), h=h, hkv=hkv, hd=hd)

    with kops.kernel_backend_ctx("int8", dev):
        got = DP.decode_prologue(norm, attn, x, cfg, pos)

    diffs = [float(torch.max(torch.abs(g[:, 0] - w)))
             for g, w in zip(got, want)]
    return {"prologue_max_diff": max(diffs), "ok": max(diffs) == 0.0}


def verify_train_serve_parity(plan: BitPlan, key=None, device=None) -> dict:
    """Run all three conformance checks; ``result['ok']`` is the verdict."""
    dev = resolve_device(device)
    key = key if key is not None else prng.key(plan.seed)
    out = {}
    out.update(check_grid_embedding(plan, prng.fold_in(key, 0), dev))
    grid_ok = out.pop("ok")
    out.update(check_kv_parity(prng.fold_in(key, 1), device=dev))
    kv_ok = out.pop("ok")
    out.update(check_prologue_parity(prng.fold_in(key, 2), dev))
    prologue_ok = out.pop("ok")
    out["grid_ok"] = grid_ok
    out["kv_ok"] = kv_ok
    out["prologue_ok"] = prologue_ok
    out["ok"] = grid_ok and kv_ok and prologue_ok
    return out


def assert_parity(plan: BitPlan, key=None, device=None) -> dict:
    res = verify_train_serve_parity(plan, key, device)
    if not res["ok"]:
        raise AssertionError(f"train<->serve parity violated: {res}")
    return res
