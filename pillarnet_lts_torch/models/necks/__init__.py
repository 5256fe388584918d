from .rpn import RPNG, RPNGV2, RPNV1, RPNV2

__all__ = ["RPNG", "RPNGV2", "RPNV1", "RPNV2"]
