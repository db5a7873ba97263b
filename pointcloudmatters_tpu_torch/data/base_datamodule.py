"""Train, validation and test datasets and their loaders (port of
``pointcloudmatters_tpu/data/base_datamodule.py``).

Keeps the reference's choice of the point-cloud collate where the dataset's
repr or class name holds "pcd". With ``pin_memory`` (the shipped configs
set it) and a CUDA device present, the loader's threads hand over each
collated batch as tensors in page-locked memory, which the trainer copies to
the card without blocking; without a CUDA device there is nothing to pin
for and the batch stays numpy, as torch's own loader does. Under data
parallelism each process's loader yields its rank's block of every global
batch (``loader.py``), and the trainer copies it to the process's own card.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from pointcloudmatters_tpu_torch.data.collate import default_collate, padded_pcd_collate_fn
from pointcloudmatters_tpu_torch.data.loader import DataLoader

__all__ = ["BaseDataModule", "pin"]


def pin(tree):
    """Every array of a nested batch as a tensor in page-locked memory."""
    if isinstance(tree, Mapping):
        return {k: pin(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [pin(v) for v in tree]
    if isinstance(tree, (np.ndarray, np.generic)):
        tree = torch.as_tensor(tree)
    return tree.pin_memory() if torch.is_tensor(tree) else tree


def _pinned(collate_fn, batch):
    return pin(collate_fn(batch))


class BaseDataModule:
    def __init__(
        self,
        train: Any = None,
        val: Any = None,
        test: Any = None,
        batch_size_train: int = 16,
        batch_size_val: int = 1,
        batch_size_test: int = 1,
        num_workers: int = 0,
        pin_memory: bool = True,
        pad_multiple: int = 512,
        seed: int = 0,
    ):
        self.data_train = train
        self.data_val = val
        self.data_test = test
        self.batch_size_train = batch_size_train
        self.batch_size_val = batch_size_val
        self.batch_size_test = batch_size_test
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self.pad_multiple = pad_multiple
        self.seed = seed

    def setup(self, stage: str | None = None) -> None:
        pass

    def _collate_for(self, dataset):
        if hasattr(dataset, "_collate_fn"):
            collate = dataset._collate_fn
        elif ("pcd" not in repr(dataset).lower()
              and "pcd" not in type(dataset).__name__.lower()):
            collate = default_collate
        else:
            collate = functools.partial(padded_pcd_collate_fn, pad_multiple=self.pad_multiple)
        if self.pin_memory and torch.cuda.is_available():
            return functools.partial(_pinned, collate)
        return collate

    def _loader(self, dataset, batch_size, shuffle):
        return DataLoader(
            dataset,
            batch_size=batch_size,
            shuffle=shuffle,
            num_workers=self.num_workers,
            collate_fn=self._collate_for(dataset),
            drop_last=shuffle,  # every training batch of one shape
            seed=self.seed,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader(self.data_train, self.batch_size_train, shuffle=True)

    def val_dataloader(self) -> DataLoader | None:
        if self.data_val is None:
            return None
        return self._loader(self.data_val, self.batch_size_val, shuffle=False)

    def test_dataloader(self) -> DataLoader | None:
        if self.data_test is None:
            return None
        return self._loader(self.data_test, self.batch_size_test, shuffle=False)
