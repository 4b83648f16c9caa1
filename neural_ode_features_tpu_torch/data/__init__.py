from .batches import Batches
from .datasets import DATASETS, dataset_spec, load_dataset

__all__ = ["load_dataset", "dataset_spec", "DATASETS", "Batches"]
