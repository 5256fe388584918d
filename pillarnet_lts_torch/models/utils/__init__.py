from .dense import Dense, dense_bn_relu
from .init import init_weights
from .norm import MaskedBatchNorm, MaskedGroupNorm, build_norm, get_norm_kwargs

__all__ = ["Dense", "MaskedBatchNorm", "MaskedGroupNorm", "build_norm",
           "dense_bn_relu", "get_norm_kwargs", "init_weights"]
