"""Per-layer (I,F) bitwidth sensitivity sweep via short seeded probes (port
of ``search/sensitivity.py``).

The sweep answers the question: *which* per-layer format does a model
actually need?  For each contiguous layer-group it trains short probes
over an ascending candidate grid — all other groups pinned at a wide safe
format — and picks the narrowest candidate whose probe loss lands within
``target`` of the f32 baseline.  The assembled plan is then probed once
end-to-end and escalated (narrowest group widened one grid step at a
time) until it meets the target too.

Cost model: every quantizer in ``quant.fixed_point`` takes its bitwidths
as tensors, so the whole sweep — baseline, every candidate, every
escalation round — reuses ONE step object.  A sweep is ``(groups x grid +
2 + escalations)`` short trainings.

Determinism: probes consume a precomputed batch list from the
deterministic synthetic dataset, params come from a fixed seed (or from
``params0``), every probe restarts from those params (the steps are
functional and leave them as they were), and rounding is
round-to-nearest-even — the same ``SweepConfig`` always yields the same
``BitPlan``.  The JAX package draws its initial weights with
``jax.random.normal``, which the port does not reproduce bit for bit:
``params0`` (a numpy or tensor tree, e.g. the JAX package's weights
through numpy) starts the port's probes from given weights instead of its
own seeded ones.

The probes run on the card unless the caller names another ``device``;
the LM probes' step resolves ``kernel_backend`` "auto" to int8 on CUDA, so
they launch the engine's kernels.  The LeNet probe's MLP body is
``relu(x @ w)`` in plain PyTorch, as the JAX package's is ``x @ w`` outside
any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.lenet5 import CONFIG as LENET
from repro_torch.core.steps import (StepOptions, default_bits, init_train_state,
                                    make_train_step, num_scan_units)
from repro_torch.core.taxonn import QuantPolicy, backward_stack, forward_stack
from repro_torch.data import SyntheticClassificationDataset, SyntheticLMDataset
from repro_torch.optim import Hyper, OptimizerConfig, apply_update, init_opt_state
from repro_torch.quant.fixed_point import BitSchedule, schedule_from_formats
from repro_torch.search.plan import BitPlan, GroupChoice, layer_groups

# Ascending-bitwidth candidate ladder.  Includes sub-int8 points (bitwidth
# <= 8 exports to serving int8 exactly — see search.export) and the paper's
# Table-I neighborhood at the wide end.
DEFAULT_GRID: Tuple[Tuple[int, int], ...] = (
    (1, 3), (1, 5), (2, 6), (2, 8), (2, 10), (2, 12),
)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Knobs of a sensitivity sweep."""

    grid: Tuple[Tuple[int, int], ...] = DEFAULT_GRID
    num_groups: int = 0          # <= 0: one group per layer
    target: float = 0.08         # allowed probe-loss delta vs f32 baseline
    probe_steps: int = 120       # train steps per probe
    batch: int = 128
    lr: float = 0.05
    seed: int = 0
    safe_format: Tuple[int, int] = (4, 16)  # pin for not-under-test groups
    max_escalations: int = 4

    def sorted_grid(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(sorted(self.grid, key=lambda p: (p[0] + p[1], p[1])))


def _on_device(tree, dev):
    """A numpy or tensor tree as a dict of tensors on ``dev`` (a tensor
    already there is used as it is: the probes never write into it)."""
    if isinstance(tree, dict):
        return {k: _on_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def _lr32(lr: float) -> float:
    """The lr rounded to f32, as the JAX package hands it to its step."""
    return float(np.float32(lr))


def _tail_mean(losses: List[float]) -> float:
    """The probe loss: the mean over the final quarter of the steps."""
    tail = max(1, len(losses) // 4)
    return float(sum(losses[-tail:]) / tail)


# ---------------------------------------------------------------------------
# LeNet-class probe (the engine's stack primitives over a plain MLP body)
# ---------------------------------------------------------------------------

def _init_mlp(seed, d_in, d_h, d_out, n_hidden):
    """Seeded normal weights, scaled by fan-in^-1/2 as the JAX package's,
    drawn on the CPU (so every device's sweep starts from the same ones)."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen) * fan_in ** -0.5
    return {"w_in": normal((d_in, d_h), d_in),
            "hidden": normal((n_hidden, d_h, d_h), d_h),
            "w_out": normal((d_h, d_out), d_h)}


def _make_mlp_step(policy: QuantPolicy, ocfg: OptimizerConfig, dev):
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def body(w, x, b_l):
        return torch.relu(x @ w), zero

    def step(params, opt, batch, hyper, bits):
        x, y = batch
        w_in = params["w_in"].detach().requires_grad_()
        with torch.enable_grad():
            h0 = torch.relu(x @ w_in)

        h_final, caches, _ = forward_stack(body, params["hidden"],
                                           h0.detach(), bits, policy)

        w_out = params["w_out"].detach().requires_grad_()
        hf = h_final.detach().requires_grad_()
        with torch.enable_grad():
            ls = torch.log_softmax(hf @ w_out, dim=-1)
            loss = -torch.mean(torch.gather(ls, 1, y[:, None]))
            seed = torch.tensor(policy.grad_scale, dtype=torch.float32,
                                device=dev)
            d_wout, G = torch.autograd.grad(loss, (w_out, hf), seed)

        G0, new_hidden, new_opt_h, _, _ = backward_stack(
            body, params["hidden"], opt["hidden"], caches, bits, G, hyper,
            policy, ocfg, 0.0)

        (d_win,) = torch.autograd.grad(h0, (w_in,), G0)
        inv = 1.0 / policy.grad_scale
        with torch.no_grad():
            new_win, new_opt_in = apply_update(
                params["w_in"], d_win * inv, opt["w_in"], hyper, ocfg)
            new_wout, new_opt_out = apply_update(
                params["w_out"], d_wout * inv, opt["w_out"], hyper, ocfg)
        return ({"w_in": new_win, "hidden": new_hidden, "w_out": new_wout},
                {"w_in": new_opt_in, "hidden": new_opt_h,
                 "w_out": new_opt_out}, loss.detach())
    return step


def make_lenet_probe(sweep: SweepConfig, *, device=None, params0=None
                     ) -> Tuple[Callable[[BitSchedule], float], int]:
    """Build ``probe(schedule) -> loss`` over the LeNet-class MLP on
    ``device`` (CUDA unless named).

    Returns ``(probe, num_layers)``.  The probe closes over one step, one
    set of initial params (``params0``, or ``_init_mlp``'s from the seed)
    and one precomputed batch list, so repeated calls (the whole sweep) are
    deterministic in the schedule alone.  The probe loss is the mean over
    the final quarter of steps (smoother than the last step, still
    end-of-probe).
    """
    dev = resolve_device(device)
    n_hidden = LENET.num_layers - 2
    ds = SyntheticClassificationDataset(
        input_dim=LENET.input_dim, num_classes=LENET.num_classes,
        n_train=8192, n_test=2048, noise=3.5)
    batches = [
        (torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev).long())
        for xb, yb in ds.train_batches(sweep.batch, sweep.probe_steps,
                                       sweep.seed)
    ]
    if params0 is None:
        params0 = _init_mlp(sweep.seed, LENET.input_dim, LENET.hidden,
                            LENET.num_classes, n_hidden)
    params0 = _on_device(params0, dev)
    ocfg = OptimizerConfig(kind="sgd")
    opt0 = {k: init_opt_state(v, ocfg) for k, v in params0.items()}
    # One quantize-capable policy for every probe: the f32 baseline is the
    # same step with ``enabled=0.0`` in the schedule.
    policy = QuantPolicy(grad_scale=64.0)
    step = _make_mlp_step(policy, ocfg, dev)
    lr = _lr32(sweep.lr)

    def probe(schedule: BitSchedule) -> float:
        schedule = schedule.to(dev)
        params, opt = params0, opt0
        losses: List[float] = []
        for i, b in enumerate(batches):
            params, opt, loss = step(params, opt, b, Hyper(lr=lr, step=i),
                                     schedule)
            losses.append(float(loss))
        return _tail_mean(losses)

    return probe, n_hidden


# ---------------------------------------------------------------------------
# Shared selection loop
# ---------------------------------------------------------------------------

def select_plan(probe: Callable[[BitSchedule], float], num_layers: int,
                sweep: SweepConfig,
                log: Optional[Callable[[str], None]] = None) -> BitPlan:
    """Greedy per-group selection + whole-plan validation/escalation."""
    say = log or (lambda s: None)
    grid = sweep.sorted_grid()
    groups = layer_groups(num_layers, sweep.num_groups)
    probes = 0

    baseline = probe(schedule_from_formats(
        [sweep.safe_format] * num_layers, enabled=False))
    probes += 1
    say(f"baseline loss {baseline:.4f} (target +{sweep.target:.3f})")

    # chosen[g] = index into grid for group g
    chosen: List[int] = []
    records: List[GroupChoice] = []
    for g, layers in enumerate(groups):
        pick, pick_loss, met = len(grid) - 1, float("inf"), False
        for ci, (i_b, f_b) in enumerate(grid):
            fmts = [sweep.safe_format] * num_layers
            for layer in layers:
                fmts[layer] = (i_b, f_b)
            loss = probe(schedule_from_formats(fmts))
            probes += 1
            say(f"  group {g} {layers} ({i_b},{f_b}) -> {loss:.4f}")
            if loss <= baseline + sweep.target:
                pick, pick_loss, met = ci, loss, True
                break
            pick, pick_loss = ci, loss  # fall through to widest
        records.append(GroupChoice(
            group=g, layers=layers, i_bits=grid[pick][0],
            f_bits=grid[pick][1], probe_loss=pick_loss, met_target=met))
        chosen.append(pick)

    def assembled(idx: List[int]):
        fmts = [None] * num_layers
        for g, layers in enumerate(groups):
            for layer in layers:
                fmts[layer] = grid[idx[g]]
        return fmts

    final = probe(schedule_from_formats(assembled(chosen)))
    probes += 1
    say(f"assembled plan loss {final:.4f}")

    # Per-group probes can interact; escalate the narrowest group until
    # the assembled plan itself meets the target (or nothing can widen).
    for _ in range(sweep.max_escalations):
        if final <= baseline + sweep.target:
            break
        widenable = [g for g in range(len(groups))
                     if chosen[g] < len(grid) - 1]
        if not widenable:
            break
        g = min(widenable,
                key=lambda k: (sum(grid[chosen[k]]), -records[k].probe_loss))
        chosen[g] += 1
        say(f"  escalate group {g} -> {grid[chosen[g]]}")
        final = probe(schedule_from_formats(assembled(chosen)))
        probes += 1
        say(f"  plan loss {final:.4f}")

    groups_out = tuple(
        dataclasses.replace(records[g], i_bits=grid[chosen[g]][0],
                            f_bits=grid[chosen[g]][1])
        for g in range(len(groups)))
    return BitPlan(
        num_layers=num_layers, groups=groups_out, baseline_loss=baseline,
        final_loss=final, target=sweep.target, seed=sweep.seed, grid=grid,
        probe_steps=sweep.probe_steps, probes=probes)


def run_sweep(sweep: SweepConfig = SweepConfig(),
              log: Optional[Callable[[str], None]] = None, *, device=None,
              params0=None) -> BitPlan:
    """Full sensitivity sweep on the LeNet-class config (the paper's
    workload)."""
    probe, n_hidden = make_lenet_probe(sweep, device=device, params0=params0)
    return select_plan(probe, n_hidden, sweep, log=log)


# ---------------------------------------------------------------------------
# Sweep over a full transformer config (the --bit-search driver path)
# ---------------------------------------------------------------------------

def make_lm_probe(cfg, ocfg: Optional[OptimizerConfig] = None,
                  sweep: SweepConfig = SweepConfig(), *, seq_len: int = 64,
                  grad_scale: float = 64.0, device=None, params0=None,
                  kernel_backend: Optional[str] = None
                  ) -> Tuple[Callable[[BitSchedule], float], int]:
    """Build ``probe(schedule) -> loss`` over a real model config's main
    block stack, and return ``(probe, num_layers)``: ``run_sweep_lm``'s
    probe (the JAX package builds it inside ``run_sweep_lm``).

    Probes run through ``make_train_step`` (the TaxoNN engine) with the
    candidate schedule installed on ``bits['blocks']``.  One step object
    serves every probe: bitwidths are runtime data.  ``params0`` (numpy or
    tensor tree) replaces ``lm.init_params(cfg, seed=sweep.seed)``;
    ``kernel_backend`` (default: the policy's "auto", int8 on CUDA and off
    on the CPU) lets a CPU sweep run the int8 plain versions that a card's
    sweep runs as kernels.  The probes sweep the engine's units (the
    hybrid's are its groups).  Families other than dense, moe, ssm and
    hybrid raise ``NotImplementedError`` (ROADMAP A9) in
    ``make_train_step``, before their encoder frames or patch embeddings
    would be drawn.
    """
    from repro_torch.models import lm

    dev = resolve_device(device)
    ocfg = ocfg or OptimizerConfig(kind="sgd")
    policy = QuantPolicy(grad_scale=grad_scale)
    step = make_train_step(cfg, policy, ocfg,
                           StepOptions(kernel_backend=kernel_backend),
                           device=dev)
    n = num_scan_units(cfg)
    base_bits = default_bits(cfg, enabled=True)

    ds = SyntheticLMDataset(cfg.vocab_size, seq_len, sweep.batch,
                            seed=sweep.seed)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in ds.batch_at(i).items()}
               for i in range(sweep.probe_steps)]

    params0 = (lm.init_params(cfg, seed=sweep.seed, device=dev)
               if params0 is None else _on_device(params0, dev))
    opt0 = init_train_state(params0, ocfg)
    lr = _lr32(sweep.lr)

    def probe(schedule: BitSchedule) -> float:
        bits = dict(base_bits)
        bits["blocks"] = schedule
        params, opt = params0, opt0
        losses: List[float] = []
        for i, b in enumerate(batches):
            params, opt, metrics = step(params, opt, b, Hyper(lr=lr, step=i),
                                        bits)
            losses.append(float(metrics["loss"]))
        return _tail_mean(losses)

    return probe, n


def run_sweep_lm(cfg, ocfg: Optional[OptimizerConfig] = None,
                 sweep: SweepConfig = SweepConfig(), *, seq_len: int = 64,
                 grad_scale: float = 64.0,
                 log: Optional[Callable[[str], None]] = None, device=None,
                 params0=None, kernel_backend: Optional[str] = None
                 ) -> BitPlan:
    """Sensitivity sweep over the main block stack of a real model config
    (the --bit-search driver path): ``make_lm_probe``'s probe through
    ``select_plan``."""
    probe, n = make_lm_probe(cfg, ocfg, sweep, seq_len=seq_len,
                             grad_scale=grad_scale, device=device,
                             params0=params0, kernel_backend=kernel_backend)
    return select_plan(probe, n, sweep, log=log)
