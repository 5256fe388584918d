"""Model registries of the port (same names as the JAX package's)."""

from ..utils.registry import Registry, build_from_cfg

__all__ = ["BACKBONES", "DETECTORS", "HEADS", "NECKS", "POINT_HEAD",
           "READERS", "ROI_HEAD", "SECOND_STAGE", "Registry",
           "build_from_cfg"]

READERS = Registry("reader")
BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
DETECTORS = Registry("detector")
SECOND_STAGE = Registry("second_stage")
ROI_HEAD = Registry("roi_head")
POINT_HEAD = Registry("point_head")
