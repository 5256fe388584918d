from .pillarnet import PillarNet

__all__ = ["PillarNet"]
