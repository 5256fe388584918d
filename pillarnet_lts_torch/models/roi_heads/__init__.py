from . import mlp_layers, proposal_target_layer, roi_head_template
from .roi_heads import RoIFFNHead, RoIHead, RoIMIXHead

__all__ = ["RoIFFNHead", "RoIHead", "RoIMIXHead", "mlp_layers",
           "proposal_target_layer", "roi_head_template"]
