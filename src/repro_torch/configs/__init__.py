from .paper_cnn import CIFAR10, CIFAR100, FASHION, PaperCNNConfig
from .registry import ARCH_IDS, UNPORTED_ARCH_IDS, get_config, list_archs

__all__ = ["ARCH_IDS", "CIFAR10", "CIFAR100", "FASHION", "PaperCNNConfig",
           "UNPORTED_ARCH_IDS", "get_config", "list_archs"]
