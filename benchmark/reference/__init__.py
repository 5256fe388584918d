"""The benchmark's plain reference: the detector, its decode and rotated
NMS in plain PyTorch, with nothing of the system under test imported."""
