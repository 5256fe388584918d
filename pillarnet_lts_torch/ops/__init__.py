"""Point, box and NMS ops of the port, each with its Hopper kernel (CUDA
tensors) and plain PyTorch version (CPU tensors)."""
