"""Training augmentations of the host pipeline: global and per-object
noise and the GT-AUG database sampler."""

from . import augment

__all__ = ["augment"]
