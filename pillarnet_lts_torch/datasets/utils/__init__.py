"""Offline dataset tools: the GT-AUG database."""

from .create_gt_database import create_groundtruth_database

__all__ = ["create_groundtruth_database"]
