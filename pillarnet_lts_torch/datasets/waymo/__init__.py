from .waymo import WaymoDataset

__all__ = ["WaymoDataset"]
