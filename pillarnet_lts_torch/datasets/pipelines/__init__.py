"""Host-side (numpy) data pipeline stages; importing registers each
under its class name in `datasets.registry.PIPELINES`."""

from .compose import Compose
from .formating import Reformat
from .loading import LoadPointCloudAnnotations, LoadPointCloudFromFile
from .noop import Empty
from .preprocess import AssignLabel, Preprocess
from .test_aug import DoubleFlip

__all__ = ["AssignLabel", "Compose", "DoubleFlip", "Empty",
           "LoadPointCloudAnnotations", "LoadPointCloudFromFile",
           "Preprocess", "Reformat"]
