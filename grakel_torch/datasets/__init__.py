"""Dataset loading (TU-format), registry, and synthetic generation."""

from .base import (Bunch, dataset_metadata, fetch_dataset, get_dataset_info,
                   read_data)
from .testing import generate_dataset

__all__ = ["fetch_dataset", "read_data", "get_dataset_info",
           "dataset_metadata", "generate_dataset", "Bunch"]
