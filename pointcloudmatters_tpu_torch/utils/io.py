"""File reading of the data layer (port of ``pointcloudmatters_tpu/utils/io.py``'s
``load_json``, ``load_h5_data``, ``save_npz_dict`` and ``load_npz_dict``)."""

from __future__ import annotations

import json

import numpy as np

__all__ = ["load_json", "load_h5_data", "save_npz_dict", "load_npz_dict"]


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_h5_data(data) -> dict:
    """Recursively materialise an HDF5 group, or any nested mapping whose
    leaves can be sliced, into nested dicts of numpy arrays."""
    return {k: load_h5_data(v) if hasattr(v, "keys") else v[:]
            for k, v in ((k, data[k]) for k in data.keys())}


def save_npz_dict(path: str, tree: dict) -> None:
    """Save a nested dict of arrays as a flat npz with '/'-joined keys."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    np.savez(path, **flat)


def load_npz_dict(path: str) -> dict:
    """The nested dict :func:`save_npz_dict` saved."""
    out: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return out
