"""Point, box and NMS ops of the port, each with its Hopper kernel (CUDA
tensors) and plain PyTorch version (CPU tensors). Importing the package
registers the kernels' custom ops (`library.py`, namespace `pillarnet`)."""

from . import library  # noqa: F401
