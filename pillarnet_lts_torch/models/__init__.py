"""Model zoo of the port; importing it registers every ported module."""

from . import (backbones, bbox_heads, detectors, necks,  # noqa: F401
               point_heads, readers, roi_heads, second_stage)
from .builder import build_detector

__all__ = ["build_detector"]
