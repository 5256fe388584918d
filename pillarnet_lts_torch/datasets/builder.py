from ..utils.registry import build_from_cfg
from .registry import DATASETS


def build_dataset(cfg, default_args=None):
    """The dataset of a config's `data.train` / `data.val` / `data.test`."""
    return build_from_cfg(cfg, DATASETS, default_args)
