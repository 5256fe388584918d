"""Model zoo of the port; importing it registers every ported module."""

from . import backbones, bbox_heads, detectors, necks, readers  # noqa: F401
from .builder import build_detector

__all__ = ["build_detector"]
