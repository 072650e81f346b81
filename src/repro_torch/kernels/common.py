"""Shared plain-PyTorch helpers of the kernels (port of ``kernels/common.py``).

``kq`` is the in-kernel fixed-point round (round half to even, saturating);
``act_fn``/``act_deriv`` are the paper's activation and derivation units;
``int8_dot`` is the exact int8 x int8 -> int32 product.  The TPU's two-slot
DMA helper ``db_step`` has no counterpart here: on Hopper, overlap of copies
with compute lives inside each CUDA kernel.

The tune cache (``tuned`` and the snapshot/load/dump API that
``kernels.ops`` exports) holds each kernel's launch decisions; it lives
here, beside ``sm_count``, so that every kernel wrapper reaches it without
importing ``ops``.
"""
from __future__ import annotations

import json
import os

import torch


def kq(x: torch.Tensor, i_bits: int, f_bits: int) -> torch.Tensor:
    """Round-to-nearest-even fixed-point quantize with saturation."""
    step = 2.0 ** (-f_bits)
    qmax = 2.0 ** (i_bits + f_bits) - 1
    qmin = -(2.0 ** (i_bits + f_bits))
    k = torch.clamp(torch.round(x.to(torch.float32) / step), qmin, qmax)
    return k * step


def maybe_kq(x: torch.Tensor, bits) -> torch.Tensor:
    """kq with ``bits=None`` meaning passthrough (unquantized datapath)."""
    return x if bits is None else kq(x, *bits)


def int8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M,K] x int8 [K,N] -> int32 [M,N].

    The product runs in float64 on either device: every partial sum is an
    integer of magnitude <= 127^2 * K < 2^53, so it is exact in any
    summation order.  (CUDA has no integer matmul, and the CPU's int32
    matmul is not a BLAS call: 3-5x slower at the engine's shapes.)
    """
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


_GELU_C = 0.7978845608028654  # sqrt(2/pi)
_GELU_A = 0.044715

# activation name -> the integer code the CUDA kernels take
ACT_CODES = {"identity": 0, "relu": 1, "sigmoid": 2, "tanh": 3, "silu": 4,
             "gelu": 5}


def act_fn(z: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.clamp_min(z, 0.0)
    if kind == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-z))
    if kind == "tanh":
        return torch.tanh(z)
    if kind == "silu":
        return z / (1.0 + torch.exp(-z))
    if kind == "gelu":  # tanh approximation
        return 0.5 * z * (1.0 + torch.tanh(_GELU_C * (z + _GELU_A * z * z * z)))
    if kind == "identity":
        return z
    raise ValueError(kind)


def act_deriv(z: torch.Tensor, kind: str) -> torch.Tensor:
    """The derivation unit f'(z) from the pre-activation."""
    if kind == "relu":
        return (z > 0).to(torch.float32)
    if kind == "sigmoid":
        s = 1.0 / (1.0 + torch.exp(-z))
        return s * (1.0 - s)
    if kind == "tanh":
        t = torch.tanh(z)
        return 1.0 - t * t
    if kind == "silu":
        s = 1.0 / (1.0 + torch.exp(-z))
        return s * (1.0 + z * (1.0 - s))
    if kind == "gelu":
        u = _GELU_C * (z + _GELU_A * z * z * z)
        t = torch.tanh(u)
        du = _GELU_C * (1.0 + 3.0 * _GELU_A * z * z)
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    if kind == "identity":
        return torch.ones_like(z)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# argument checks shared by the kernel wrappers
# ---------------------------------------------------------------------------

def bits_args(bits) -> tuple:
    """An optional (I,F) format as the CUDA launchers take it: (on, I, F)."""
    return (0, 0, 0) if bits is None else (1, int(bits[0]), int(bits[1]))


def check_operands(name: str, datapath: str, tensors, scale,
                   need_scale: bool = True):
    """Check the operand dtypes of ``datapath`` (int8 payloads, or f32 for
    emulate).  Returns the int8 datapath's scale as an f32 tensor on the
    operands' device (a Python float becomes one), None for emulate and
    where no scale is needed (an int32 mode)."""
    want = {"int8": torch.int8, "emulate": torch.float32}.get(datapath)
    if want is None:
        raise ValueError(f"{name}: unknown datapath {datapath!r}")
    bad = [t.dtype for t in tensors if t.dtype != want]
    if bad:
        raise TypeError(f"{name}: the {datapath} datapath takes {want} "
                        f"operands, got {bad}")
    if datapath == "emulate" or not need_scale:
        return None
    if scale is None:
        raise ValueError(f"{name}: the int8 datapath needs its scale")
    return torch.as_tensor(scale, dtype=torch.float32,
                           device=tensors[0].device)


def cuda_device(name: str, tensors) -> torch.device:
    """The one CUDA device that all of a kernel's operands lie on; raises
    when they are elsewhere or not contiguous (no fallback)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise RuntimeError(f"{name}: operands on "
                           f"{sorted({str(t.device) for t in tensors})}; "
                           "the kernel takes one CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    return dev


_N_SM: dict = {}


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev`` (the K/token splits' target)."""
    if dev not in _N_SM:
        _N_SM[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _N_SM[dev]


def lr_args(lr, device) -> tuple:
    """A learning rate as the CUDA launchers take it: ``(value, None)`` for
    a Python number, passed by value, or ``(0.0, f32 [1] tensor on the
    device)`` for a tensor, which the kernel reads there (no host sync)."""
    if isinstance(lr, torch.Tensor):
        return 0.0, lr.to(device=device, dtype=torch.float32).reshape(1)
    return float(lr), None


# ---------------------------------------------------------------------------
# The tune cache: each kernel's launch decisions
# ---------------------------------------------------------------------------
#
# A decision is the launch that a kernel's own ``_plan`` picks for a shape:
# fxp_matmul's ``Plan``, bp_gstep's ``Plan``, sgd_dw_update's ``(kind, per,
# s)``, bp_fused_unit's and decode_prologue's ``Plan``, paged_attention's
# chunk count.  The plans read the card's SM count, and the emulate
# datapath's split partial sums are added in f32, so the bits of an emulate
# result depend on the split count.  The key is the kernel, the shape, the
# datapath and the element sizes, NOT the SM count: each entry records the
# SM count it was derived for beside its ``source``, and a restored entry
# is replayed on any card, so a resumed run launches the original run's
# split counts.  The kinds are named after the port's kernels; the JAX
# package's kinds (``JAX_TUNE_KINDS``) budget a TPU core's VMEM and are
# skipped on load, as the JAX loader skips these.

TUNE_KINDS = {
    # kind: (key fields, decision length; 0 = an int).  The matmul kernels'
    # key is the product [m, k] @ [k, n] they compute: fxp_matmul X @ W,
    # bp_gstep G @ Wᵀ ([t, dout] @ [dout, din]), sgd_dw_update Xᵀ @ G
    # ([din, t] @ [t, dout]).  dp: the datapath; xb, wb: element sizes.
    "fxp_matmul": (("m", "n", "k", "dp", "xb", "wb"), 6),
    "bp_gstep": (("m", "n", "k", "dp"), 6),
    "sgd_dw_update": (("m", "n", "k", "dp"), 3),
    "bp_fused_unit": (("t", "din", "dout", "dp"), 5),
    "decode_prologue": (("b", "d", "h", "hkv", "hd", "dp", "xb"), 7),
    "paged_attention": (("n", "bs", "m", "hkv", "hd", "g", "item"), 0),
}
JAX_TUNE_KINDS = ("blocks", "fused", "paged", "prologue")
# "int32": the int8 product's int32 mode (fxp_matmul, bp_gstep), whose
# decisions are the int8 datapath's, under keys of their own
DATAPATHS = ("emulate", "int8", "int32")
# the SM count decisions are derived for where no card is present: an H100
# SXM's (the CPU tests and a CPU run's priming)
DEFAULT_SM_COUNT = 132

# (kind, *key) -> {"decision": ..., "source": str, "sm": int or None}
_TUNE_CACHE: dict = {}
_TUNE_STATS = {"hits": 0, "misses": 0}
_TUNE_ENV_LOADED = False


def default_sm_count() -> int:
    """The current CUDA device's SM count, or ``DEFAULT_SM_COUNT``
    without a card."""
    if torch.cuda.is_available():
        return sm_count(torch.device("cuda", torch.cuda.current_device()))
    return DEFAULT_SM_COUNT


def _maybe_load_env_cache() -> None:
    """One-shot lazy load of REPRO_TUNE_CACHE (a ``dump_tune_cache``
    file)."""
    global _TUNE_ENV_LOADED
    if _TUNE_ENV_LOADED:
        return
    _TUNE_ENV_LOADED = True
    path = os.environ.get("REPRO_TUNE_CACHE", "").strip()
    if path:
        with open(path) as f:
            snap = json.load(f)
        n = load_tune_cache(snap)
        print(f"[kernels] loaded {n} tune-cache decision(s) from {path}",
              flush=True)


def tuned(kind: str, key: tuple, n_sm: int, derive):
    """The decision of ``kind`` for ``key``: the cached one where there is
    one (a restored entry wins whatever SM count it was derived for), else
    ``derive()``, recorded as computed for ``n_sm`` SMs."""
    _maybe_load_env_cache()
    ent = _TUNE_CACHE.get((kind,) + key)
    if ent is not None:
        _TUNE_STATS["hits"] += 1
        return ent["decision"]
    _TUNE_STATS["misses"] += 1
    decision = derive()
    _TUNE_CACHE[(kind,) + key] = {"decision": decision, "source": "computed",
                                  "sm": int(n_sm)}
    return decision


def tune_cache_stats() -> dict:
    """Entries, and the lookups that hit or missed since the last
    ``clear_tune_cache``."""
    return dict(_TUNE_STATS, entries=len(_TUNE_CACHE))


def tune_key(kind: str, key: tuple) -> str:
    """The snapshot key, e.g. ``"kind=bp_gstep,m=1024,n=896,k=4864,
    dp=int8"``."""
    fields = TUNE_KINDS[kind][0]
    return ",".join(["kind=" + kind]
                    + [f"{f}={a}" for f, a in zip(fields, key)])


def _plain(d):
    """A decision as JSON and msgpack take it: tuples become lists."""
    if isinstance(d, (tuple, list)):
        return [_plain(v) for v in d]
    return d


def _decision(d, length: int):
    """A snapshot's decision back as the tuples ``tuned`` hands out;
    raises ValueError or TypeError on a malformed one."""
    if length == 0:
        if isinstance(d, bool) or not isinstance(d, int):
            raise TypeError(f"decision {d!r} is not an int")
        return d
    if not isinstance(d, list) or len(d) != length:
        raise ValueError(f"decision {d!r} is not a list of {length}")
    out = []
    for v in d:
        if isinstance(v, list):
            if not all(isinstance(u, int) and not isinstance(u, bool)
                       for u in v):
                raise TypeError(f"decision field {v!r}")
            v = tuple(v)
        elif not isinstance(v, (int, str)):
            raise TypeError(f"decision field {v!r}")
        out.append(v)
    return tuple(out)


def tune_cache_snapshot() -> dict:
    """Copy of the cache with JSON-friendly keys (``tune_key``) and
    values ``{"decision", "source", "sm"}``."""
    _maybe_load_env_cache()
    snap = {}
    for key in sorted(_TUNE_CACHE, key=repr):
        ent = _TUNE_CACHE[key]
        snap[tune_key(key[0], key[1:])] = {
            "decision": _plain(ent["decision"]), "source": ent["source"],
            "sm": ent["sm"]}
    return snap


def dump_tune_cache(path: str) -> None:
    """Persist the cache as JSON; point REPRO_TUNE_CACHE at the file to
    preload a later process."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(tune_cache_snapshot(), f, indent=2, sort_keys=True)


def foreign_tune_entries(snapshot: dict) -> int:
    """How many entries of ``snapshot`` are the JAX package's kinds (which
    ``load_tune_cache`` skips)."""
    n = 0
    for skey in snapshot or {}:
        parts = dict(p.split("=", 1) for p in str(skey).split(",")
                     if "=" in p)
        n += parts.get("kind") in JAX_TUNE_KINDS
    return n


def load_tune_cache(snapshot: dict, *, overwrite: bool = False) -> int:
    """Inverse of ``tune_cache_snapshot``: install persisted decisions
    (from a checkpoint's resume ``extra``, a serve snapshot or a dump) so
    that a resumed run replays the original run's launches.  Existing
    entries win unless ``overwrite``; restored rows carry
    ``restored:<original source>`` provenance and the SM count they were
    derived for.  Returns the number of entries installed; malformed
    entries and the JAX package's kinds are skipped."""
    n = 0
    for skey, entry in (snapshot or {}).items():
        try:
            parts = dict(p.split("=", 1) for p in skey.split(","))
            kind = parts.pop("kind")
            fields, length = TUNE_KINDS[kind]
            key = tuple(parts[f] if f == "dp" else int(parts[f])
                        for f in fields)
            if "dp" in fields and key[fields.index("dp")] not in DATAPATHS:
                raise ValueError(f"datapath in {skey!r}")
            decision = _decision(entry["decision"], length)
            sm = entry.get("sm")
            sm = None if sm is None else int(sm)
            source = f"restored:{entry.get('source', '?')}"
        except (KeyError, ValueError, AttributeError, TypeError):
            continue
        if not overwrite and (kind,) + key in _TUNE_CACHE:
            continue
        _TUNE_CACHE[(kind,) + key] = {"decision": decision, "source": source,
                                      "sm": sm}
        n += 1
    return n


def clear_tune_cache() -> None:
    _TUNE_CACHE.clear()
    _TUNE_STATS.update(hits=0, misses=0)
