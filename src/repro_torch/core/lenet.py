"""The paper's LeNet-class evaluation network on the kernel datapath (port
of ``core/lenet.py``).

This is Fig. 3 made literal: a 5-layer MLP classifier whose train step runs
every SGD-unit frame through the fused kernels --

    forward            fxp_matmul      (per-layer (I,F) MACs)
    head G seed        bp_gstep        (Eq. 8 against W_out)
    hidden frames      bp_fused_unit   (Eq. 8 + Eq. 9 + Eq. 1, one pass)
    input/head update  sgd_dw_update   (Eq. 9 + Eq. 1 fused)

Layers are unrolled in Python, so each layer carries its own static (I,F)
design point, as the chip loads a Table-I schedule into its per-layer
format registers.  Three backends share the math: ``off`` (the plain
oracles of ``kernels.ref``), ``emulate`` (the kernels, f32 MACs) and
``int8`` (int8 operands with int32 accumulators); ``auto`` is int8 on CUDA
and off on the CPU.  The step runs on one device, the card unless the
caller names another, and keeps its metrics there: it calls no ``.item()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs.lenet5 import LeNetConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.lm import params_from_numpy

__all__ = ["LeNetBits", "init_lenet_params", "lenet_bits", "lenet_bits_off",
           "lenet_bits_table", "make_lenet_train_step", "params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class LeNetBits:
    """Per-layer static (I,F) design points (None entries = full precision).

    ``w``/``a``/``g`` each hold ``num_layers`` tuples: weights, activations
    (layer inputs), gradients (the G chain) -- the three tensor classes the
    paper quantizes (Table I).
    """

    w: tuple
    a: tuple
    g: tuple

    @property
    def num_layers(self) -> int:
        return len(self.w)


def lenet_bits(num_layers: int, weight=(2, 12), act=(4, 10),
               grad=(2, 12)) -> LeNetBits:
    return LeNetBits(w=(weight,) * num_layers, a=(act,) * num_layers,
                     g=(grad,) * num_layers)


def lenet_bits_off(num_layers: int) -> LeNetBits:
    return LeNetBits(w=(None,) * num_layers, a=(None,) * num_layers,
                     g=(None,) * num_layers)


def lenet_bits_table(points: Sequence[tuple]) -> LeNetBits:
    """One (I,F) per layer applied to all three classes (Table-I style)."""
    pts = tuple(tuple(p) for p in points)
    return LeNetBits(w=pts, a=pts, g=pts)


def init_lenet_params(cfg: LeNetConfig, seed: int = 0, device=None) -> dict:
    """f32 masters in the JAX package's layout -- ``w_in`` [in, hidden],
    ``hidden`` [L-2, hidden, hidden], ``w_out`` [hidden, classes] -- each
    N(0, 1/fan_in), drawn from a ``torch.Generator`` on ``device`` (CUDA
    unless the caller names another; raises when CUDA is absent)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed))

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32) * fan_in ** -0.5

    h = cfg.hidden
    return {"w_in": normal((cfg.input_dim, h), cfg.input_dim),
            "hidden": normal((cfg.num_layers - 2, h, h), h),
            "w_out": normal((h, cfg.num_classes), h)}


def make_lenet_train_step(cfg: LeNetConfig, bits: Optional[LeNetBits] = None,
                          kernel_backend: str = "auto", device=None):
    """Build ``step(params, batch, lr) -> (params, metrics)``.

    ``batch`` = (x [B, input_dim] f32, y [B] int), tensors or numpy arrays,
    moved to the step's device; ``lr`` a float or a scalar tensor.  SGD only
    (the paper's optimizer); the update is fused into the backward kernels.
    ``metrics`` holds ``loss`` and ``acc`` as device scalars.  ``device``
    defaults to CUDA and raises when CUDA is absent; ``kernel_backend``
    defaults to ``auto``: int8 on CUDA, the plain oracles on the CPU.
    """
    dev = resolve_device(device)
    backend = kops.resolve_backend(kernel_backend, dev)
    bits = bits or lenet_bits_off(cfg.num_layers)
    if bits.num_layers != cfg.num_layers:
        raise ValueError(f"{bits.num_layers} bit points for "
                         f"{cfg.num_layers} layers")
    n_layers, n_hidden = cfg.num_layers, cfg.num_layers - 2
    datapath = "int8" if backend == "int8" else "emulate"

    def _mm(x, w, li):
        if backend == "off":
            return kref.fxp_matmul_ref(x, w, xa_bits=bits.a[li],
                                       w_bits=bits.w[li], out_bits=None,
                                       act="identity")
        return kops.fxp_matmul_op(x, w, xa_bits=bits.a[li], w_bits=bits.w[li],
                                  out_bits=None, act="identity",
                                  datapath=datapath)

    def _gstep(g, w, z, li):
        if backend == "off":
            return kref.bp_gstep_ref(g, w, z, g_bits=bits.g[li], act="relu")
        nxt = li + 1 < n_layers
        return kops.bp_gstep_op(g, w, z, g_bits=bits.g[li], act="relu",
                                datapath=datapath,
                                g_in_bits=bits.g[li + 1] if nxt else None,
                                w_bits=bits.w[li + 1] if nxt else None)

    def _dw_update(x, g, w, lr, li):
        if backend == "off":
            return kref.sgd_dw_update_ref(x, g, w, lr, w_bits=None)
        return kops.sgd_dw_update_op(x, g, w, lr, w_bits=None,
                                     datapath=datapath, xa_bits=bits.a[li],
                                     g_in_bits=bits.g[li])

    def _frame(g, w, x, z, lr, li):
        """The layer-li TDM frame: consumes G_{z_li}, produces
        (G_{z_{li-1}}, W_li_new)."""
        if backend == "off":
            return kref.bp_fused_unit_ref(
                g, w, x, z, lr, g_bits=bits.g[li - 1], w_bits=bits.w[li],
                w_out_bits=None, act="relu")
        return kops.bp_fused_unit_op(
            g, w, x, z, lr, g_bits=bits.g[li - 1], w_bits=bits.w[li],
            w_out_bits=None, act="relu", datapath=datapath,
            g_in_bits=bits.g[li], xa_bits=bits.a[li])

    def step(params, batch, lr):
        x = torch.as_tensor(batch[0], dtype=torch.float32, device=dev)
        y = torch.as_tensor(batch[1], device=dev).long()
        bsz = x.shape[0]

        # ---- forward: cache every pre-activation (the Z registers) -------
        zs, hs = [], []
        h = x
        for i in range(n_hidden + 1):
            w = params["w_in"] if i == 0 else params["hidden"][i - 1]
            z = _mm(h, w, i)
            h = torch.clamp_min(z, 0.0)
            zs.append(z)
            hs.append(h)
        logits = _mm(h, params["w_out"], n_layers - 1)

        ls = torch.log_softmax(logits, dim=-1)
        loss = -ls.gather(1, y[:, None]).mean()
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        onehot = torch.nn.functional.one_hot(y, cfg.num_classes)
        dlogits = (torch.softmax(logits, dim=-1) - onehot) / bsz

        # ---- backward: the G chain, one fused frame per hidden layer -----
        # head: Eq. 8 seed against W_out + its fused update
        g = _gstep(dlogits, params["w_out"], zs[-1], n_layers - 2)
        new_w_out = _dw_update(hs[-1], dlogits, params["w_out"], lr,
                               n_layers - 1)
        new_hidden = [None] * n_hidden
        for i in reversed(range(n_hidden)):
            g, new_hidden[i] = _frame(g, params["hidden"][i], hs[i], zs[i],
                                      lr, i + 1)
        new_w_in = _dw_update(x, g, params["w_in"], lr, 0)

        new_params = {
            "w_in": new_w_in,
            "hidden": torch.stack(new_hidden) if new_hidden
            else params["hidden"],
            "w_out": new_w_out,
        }
        return new_params, {"loss": loss, "acc": acc}

    return step
