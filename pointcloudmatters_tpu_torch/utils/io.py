"""File reading of the data layer (port of ``pointcloudmatters_tpu/utils/io.py``'s
``load_json`` and ``load_h5_data``)."""

from __future__ import annotations

import json

__all__ = ["load_json", "load_h5_data"]


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_h5_data(data) -> dict:
    """Recursively materialise an HDF5 group, or any nested mapping whose
    leaves can be sliced, into nested dicts of numpy arrays."""
    return {k: load_h5_data(v) if hasattr(v, "keys") else v[:]
            for k, v in ((k, data[k]) for k in data.keys())}
