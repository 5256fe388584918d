"""Synthetic inputs for the port's smoke run, profiles and tests."""

from .synth import synth_points_realistic

__all__ = ["synth_points_realistic"]
