"""Point, box and NMS ops of the port, each with its Hopper kernel (CUDA
tensors) and plain PyTorch version (CPU tensors). Importing the package
registers the kernels' custom ops (`library.py`, namespace `pillarnet`).

The box ops the JAX package exports from its `ops/__init__.py` without a
Pallas kernel (`point_in_box.py`, `roiaware_pool.py`) are torch ops on
either device, exported here under the JAX names."""

from . import library  # noqa: F401
from .point_in_box import points_in_rbbox_device
from .roiaware_pool import (points_in_boxes_batch, points_in_boxes_index,
                            roiaware_pool3d)

__all__ = ["points_in_rbbox_device", "points_in_boxes_batch",
           "points_in_boxes_index", "roiaware_pool3d"]
