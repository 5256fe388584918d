"""Pipeline composition (the JAX package's `pipelines/compose.py`)."""

from ...utils.registry import build_from_cfg
from ..registry import PIPELINES


class Compose:
    """Stages from config dicts (by `type`) or callables, run in order on
    (res, info); a stage returning res None ends the pipeline."""

    def __init__(self, transforms):
        self.transforms = []
        for transform in transforms:
            if isinstance(transform, dict):
                self.transforms.append(build_from_cfg(transform, PIPELINES))
            elif callable(transform):
                self.transforms.append(transform)
            else:
                raise TypeError(f"transform must be callable or dict, "
                                f"got {transform}")

    def __call__(self, res, info):
        for t in self.transforms:
            res, info = t(res, info)
            if res is None:
                return None, None
        return res, info
