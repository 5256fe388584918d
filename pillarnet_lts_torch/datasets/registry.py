"""Dataset and pipeline-stage registries (the JAX package's names)."""

from ..utils.registry import Registry

DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")
