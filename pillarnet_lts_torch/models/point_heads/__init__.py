from .point_head import PointHead, assign_point_targets_2d, point_cls_loss

__all__ = ["PointHead", "assign_point_targets_2d", "point_cls_loss"]
