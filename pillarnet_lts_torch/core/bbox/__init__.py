"""Numpy box geometry of the host pipeline."""

from . import box_np_ops

__all__ = ["box_np_ops"]
