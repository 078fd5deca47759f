"""The paper's own CNN (§IV) — used by the FL simulation layer.

Conv2D(32, 3x3, ReLU) -> MaxPool(2x2) -> Flatten -> Dense(64, ReLU)
-> Dense(n_classes, softmax).  Input (32,32,3) for CIFAR-10/100 and
(28,28,3) for Fashion-MNIST (grayscale pre-processed to 3 channels).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperCNNConfig:
    name: str = "paper-cnn"
    input_hw: int = 32             # 32 for CIFAR, 28 for Fashion-MNIST
    channels: int = 3
    conv_filters: int = 32
    dense_units: int = 64
    n_classes: int = 10

    @property
    def flat_dim(self) -> int:
        h = self.input_hw - 2      # valid 3x3 conv
        h = h // 2                 # 2x2 maxpool
        return h * h * self.conv_filters


CIFAR10 = PaperCNNConfig(name="paper-cnn-cifar10", input_hw=32, n_classes=10)
CIFAR100 = PaperCNNConfig(name="paper-cnn-cifar100", input_hw=32,
                          n_classes=100)
FASHION = PaperCNNConfig(name="paper-cnn-fashion", input_hw=28, n_classes=10)
