from .point_head import PointHead

__all__ = ["PointHead"]
