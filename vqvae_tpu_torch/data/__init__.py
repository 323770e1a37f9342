from .codes import CodesDataset, VanillaCodesDataset, get_code_loaders
from .datasets import CIFAR10_MEAN, CIFAR10_STD, DatasetSplit, load_dataset
from .loader import DataLoader, get_data_loaders

__all__ = [
    "load_dataset",
    "DatasetSplit",
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "DataLoader",
    "get_data_loaders",
    "CodesDataset",
    "VanillaCodesDataset",
    "get_code_loaders",
]
