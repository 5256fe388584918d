from .init import init_weights
from .norm import MaskedBatchNorm

__all__ = ["MaskedBatchNorm", "init_weights"]
