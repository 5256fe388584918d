"""Datasets, pipelines and the data loader of the port; importing
registers every dataset and pipeline stage by its class name."""

from . import pipelines  # noqa: F401  (registration)
from .builder import build_dataset
from .collate import collate_batch
from .demo import DemoDataset
from .loader import DataLoader
from .nuscenes import NuScenesDataset
from .registry import DATASETS, PIPELINES
from .synth import SynthDataset, synth_points_realistic, synth_scene
from .waymo import WaymoDataset

__all__ = ["DATASETS", "DataLoader", "DemoDataset", "NuScenesDataset",
           "PIPELINES", "SynthDataset", "WaymoDataset", "build_dataset",
           "collate_batch", "synth_points_realistic", "synth_scene"]
