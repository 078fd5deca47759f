from .federated import (partition_dirichlet, partition_iid,
                        partition_powerlaw, user_fractions, validate_shards)
from .synthetic import ImageDataset, make_image_classification

__all__ = ["ImageDataset", "make_image_classification",
           "partition_dirichlet", "partition_iid", "partition_powerlaw",
           "user_fractions", "validate_shards"]
