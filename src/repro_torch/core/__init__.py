"""Training on the kernels (port of ``core/``).  So far the paper's LeNet-5
step (``core.lenet``); the layer engine (``taxonn``, ``steps``) comes with
the dense-engine slice."""
from repro_torch.core.lenet import (
    LeNetBits,
    init_lenet_params,
    lenet_bits,
    lenet_bits_off,
    lenet_bits_table,
    make_lenet_train_step,
    params_from_numpy,
)

__all__ = [
    "LeNetBits", "init_lenet_params", "lenet_bits", "lenet_bits_off",
    "lenet_bits_table", "make_lenet_train_step", "params_from_numpy",
]
