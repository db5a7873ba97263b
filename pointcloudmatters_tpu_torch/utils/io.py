"""File reading and writing (port of ``pointcloudmatters_tpu/utils/io.py``):
json, HDF5, pickle, npy and npz."""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

__all__ = ["load_json", "save_json", "load_h5_data", "load_pickle", "save_pickle", "load_npy",
           "save_npz_dict", "load_npz_dict", "load_numpy_pickle", "listdir"]


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def save_json(obj, path: str, **kwargs) -> None:
    """``obj`` as JSON; ``kwargs`` go to ``json.dump`` (``indent=``...)."""
    with open(path, "w") as f:
        json.dump(obj, f, **kwargs)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_npy(path: str, allow_pickle: bool = True):
    return np.load(path, allow_pickle=allow_pickle)


def listdir(path: str) -> list[str]:
    """The names in the directory ``path``, sorted."""
    return sorted(os.listdir(path))


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


def load_numpy_pickle(path: str):
    """An object saved by ``np.save`` with pickling (the RLBench processed
    episodes)."""
    obj = np.load(path, allow_pickle=True)
    if isinstance(obj, np.ndarray) and obj.dtype == object:
        return obj.item()
    return obj
