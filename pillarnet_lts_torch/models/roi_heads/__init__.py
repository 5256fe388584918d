from . import proposal_target_layer, roi_head_template
from .roi_heads import RoIHead, RoIMIXHead

__all__ = ["RoIHead", "RoIMIXHead", "proposal_target_layer",
           "roi_head_template"]
