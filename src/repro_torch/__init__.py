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

# The first call in a process of one of MKL's vector-math functions (exp,
# log, ... of a CPU float tensor, which PyTorch hands to MKL's VML) sets
# MKL up.  When that first call is split over the intra-op threads, its
# result now and then differs (tools/cpu_bitwise_processes.py: 8 of 600
# fresh 2-thread processes), which broke the train driver's bitwise
# resume, whose runs are separate processes.  A first call on one thread
# settles it (0 of 600).
torch.exp(torch.zeros(1))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises rather than carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
