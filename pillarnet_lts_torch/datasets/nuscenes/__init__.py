from .nuscenes import NuScenesDataset

__all__ = ["NuScenesDataset"]
