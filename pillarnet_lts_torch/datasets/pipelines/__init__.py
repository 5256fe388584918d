"""Host-side (numpy) data pipeline stages of the port's training path."""

from .formating import Reformat
from .preprocess import AssignLabel, Preprocess

__all__ = ["AssignLabel", "Preprocess", "Reformat"]
