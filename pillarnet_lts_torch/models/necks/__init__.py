from .rpn import RPNV1, RPNV2

__all__ = ["RPNV1", "RPNV2"]
