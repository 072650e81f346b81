"""The paper's own evaluation network (port of ``configs/lenet5.py``): the
LeNet-class 5-layer classifier of its MNIST / CIFAR10 / SVHN experiments
(Fig. 5, Table I), as a 5-layer MLP: 784 -> 256 -> 256 -> 256 -> 256 -> 10.
Not in ``ARCH_MODULES``, as the JAX package's registry does not list it;
``core.lenet`` trains it."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LeNetConfig:
    name: str = "lenet5"
    input_dim: int = 784          # 28x28 (MNIST/SVHN); 1024*3 for CIFAR10
    hidden: int = 256
    num_layers: int = 5
    num_classes: int = 10


CONFIG = LeNetConfig()
