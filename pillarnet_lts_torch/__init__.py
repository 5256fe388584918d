"""PillarNet-LTS on PyTorch and CUDA (NVIDIA Hopper).

A port of `pillarnet_lts_tpu` (JAX on a TPU), which stays the reference.
This package reads the same `configs/`, loads the JAX package's weights
(`runtime/convert.py`) and returns the same padded detections. Every Pallas
kernel of the ported path has a hand-written CUDA kernel under `csrc/`,
built with nvcc for sm_90a at first use; on CPU tensors the same functions
run their plain PyTorch versions. The package never imports JAX.
"""

__version__ = "0.1.0"
