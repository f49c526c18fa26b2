"""Datasets, the loader and device prefetch, image preprocessing, and the
synthetic Carvana-like data generator."""

from tpu_unet_torch.data.loading import (
    BasicDataset,
    CarvanaDataset,
    RawCarvanaDataset,
    RawDataset,
    load_image,
    preprocess,
    preprocess_mask,
    random_split_indices,
    unique_mask_values,
)
from tpu_unet_torch.data.prefetch import DataLoader, collate, prefetch_to_device
from tpu_unet_torch.data.synthetic import make_synthetic_carvana, synth_batch, synth_sample

__all__ = [
    "BasicDataset",
    "CarvanaDataset",
    "DataLoader",
    "RawCarvanaDataset",
    "RawDataset",
    "collate",
    "load_image",
    "make_synthetic_carvana",
    "prefetch_to_device",
    "preprocess",
    "preprocess_mask",
    "random_split_indices",
    "synth_batch",
    "synth_sample",
    "unique_mask_values",
]
