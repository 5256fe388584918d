from .dense import Dense, dense_bn_relu
from .init import init_weights
from .norm import MaskedBatchNorm

__all__ = ["Dense", "MaskedBatchNorm", "dense_bn_relu", "init_weights"]
