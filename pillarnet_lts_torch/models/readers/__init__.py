from .dynamic_pillar_encoder import DynamicPFE

__all__ = ["DynamicPFE"]
