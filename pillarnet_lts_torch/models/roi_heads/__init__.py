from . import roi_head_template
from .roi_heads import RoIHead, RoIMIXHead

__all__ = ["RoIHead", "RoIMIXHead", "roi_head_template"]
