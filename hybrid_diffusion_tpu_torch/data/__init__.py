from .registry import (
    DATASET_REGISTRY,
    UNDERWATER_DATASETS,
    ATMOSPHERIC_DATASETS,
    dataset_splits,
    list_images,
    split_data,
    load_image,
)
from .datasets import PairedImageDataset, SyntheticPairedDataset, make_dataset
from .pipeline import BatchLoader, shard_for_host
