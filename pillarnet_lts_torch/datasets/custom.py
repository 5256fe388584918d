"""Dataset base class (the JAX package's `datasets/custom.py`).

One addition: a dataset owns its random draws. `sample_rng(idx)` is the
generator of sample `idx`, `np.random.RandomState([seed, idx])`, and
`seed` is set by the loader (`set_seed`) from its own seed and epoch. The
JAX package draws the same things from numpy's global state.
"""

import numpy as np

from .pipelines import Compose


class PointCloudDataset:
    NumPointFeatures = -1

    def __init__(self, root_path, info_path, pipeline=None, test_mode=False,
                 class_names=None, seed=0, **kwargs):
        self._info_path = info_path
        self._root_path = root_path
        self._class_names = class_names
        self.test_mode = test_mode
        self.seed = seed
        self.pipeline = None if pipeline is None else Compose(pipeline)

    def __len__(self):
        raise NotImplementedError

    def get_sensor_data(self, idx):
        raise NotImplementedError

    def __getitem__(self, idx):
        return self.get_sensor_data(idx)

    def set_seed(self, seed):
        """The seed of every later sample's draws (`sample_rng`)."""
        self.seed = seed

    def sample_rng(self, idx):
        return np.random.RandomState([self.seed, idx])

    def evaluation(self, detections, output_dir=None, testset=False,
                   device="cuda"):
        raise NotImplementedError
