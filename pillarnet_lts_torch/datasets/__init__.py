"""Synthetic inputs and the training data path of the port."""

from .collate import DataLoader, collate_batch
from .synth import SynthDataset, synth_points_realistic, synth_scene

__all__ = ["DataLoader", "SynthDataset", "collate_batch",
           "synth_points_realistic", "synth_scene"]
