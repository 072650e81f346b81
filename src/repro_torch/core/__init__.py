"""Training on the kernels (port of ``core/``): the paper's LeNet-5 step
(``core.lenet``) and the layer engine (``core.taxonn``: the G-chain with
per-layer fused updates, and the grad taps of the stage-sharded pipeline;
``core.steps``: the train step over every model family, the engine's or
the pipeline's)."""
from repro_torch.core.lenet import (
    LeNetBits,
    init_lenet_params,
    lenet_bits,
    lenet_bits_off,
    lenet_bits_table,
    make_lenet_train_step,
    params_from_numpy,
)
from repro_torch.core.steps import (
    StepOptions,
    default_bits,
    init_train_state,
    make_eval_step,
    make_train_step,
    pipeline_exec_capabilities,
)
from repro_torch.core.taxonn import (
    QuantPolicy,
    apply_stacked_updates,
    backward_stack,
    default_bits_for,
    forward_stack,
    grad_tap,
    grad_tap_stochastic,
    overlap_depth_for,
)

__all__ = [
    "LeNetBits", "QuantPolicy", "StepOptions", "apply_stacked_updates",
    "backward_stack", "default_bits", "default_bits_for", "forward_stack",
    "grad_tap", "grad_tap_stochastic", "init_lenet_params",
    "init_train_state", "lenet_bits", "lenet_bits_off", "lenet_bits_table",
    "make_eval_step", "make_lenet_train_step", "make_train_step",
    "overlap_depth_for", "params_from_numpy", "pipeline_exec_capabilities",
]
