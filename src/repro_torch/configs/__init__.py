from .paper_cnn import CIFAR10, CIFAR100, FASHION, PaperCNNConfig

__all__ = ["CIFAR10", "CIFAR100", "FASHION", "PaperCNNConfig"]
