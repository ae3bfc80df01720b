"""Data layer (port of ``madm_tpu/data``): the paired dataset with rare-class
sampling, the multi-target variant and the loaders; images decode through
the native C++ decoder (``native``) where it builds, else PIL."""

from .dataset import CrossModalityDataset, get_rcs_class_probs
from .loader import TestLoader, TrainLoader, build_d2_test_dataloader, build_d2_train_dataloader
from .multi_modality import MultiModalityDataset

__all__ = [
    "CrossModalityDataset",
    "MultiModalityDataset",
    "get_rcs_class_probs",
    "TrainLoader",
    "TestLoader",
    "build_d2_train_dataloader",
    "build_d2_test_dataloader",
]
