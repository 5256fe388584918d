from .center_head import CenterHead

__all__ = ["CenterHead"]
