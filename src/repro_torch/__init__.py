"""TaxoNN reproduction ported to PyTorch and CUDA (NVIDIA Hopper, sm_90a).

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout (``repro_torch.kernels.fxp_matmul`` is the counterpart of
``repro.kernels.fxp_matmul``) and imports nothing of it, nor of JAX.

Every Pallas kernel on a ported path is a CUDA C++ kernel written by hand
under ``csrc/``, compiled by ``nvcc`` on first use (``_build``) and bound
with ``ctypes``.  Each kernel wrapper runs its plain PyTorch version only for
tensors on the CPU; a CUDA tensor launches the kernel or raises.

Entry points (``launch.serve``, ``core.make_train_step``,
``core.make_lenet_train_step``, ``models.lm.init_params``) run on the card
unless the caller asks for ``device="cpu"``, and raise when CUDA is
absent.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises rather than carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
