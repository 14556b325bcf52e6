"""Compute a costly module fixture of the port's tests once per pytest
session, across pytest-xdist workers.

Under ``--dist load`` a module-scoped fixture runs on every worker that gets
one of its module's tests; the port's frame fixtures (a JAX jit of the whole
frame beside the port's frame) take minutes each. ``session_cached`` lets the
first worker compute the value and save it, as numpy arrays, in the
session's shared temporary directory (the parent of every worker's
``basetemp``), under an ``fcntl`` lock; the other workers wait on the lock
and load it. Torch tensors come back as CPU torch tensors, JAX arrays as
numpy arrays. Without xdist the value is simply computed.
"""

from __future__ import annotations

import copy
import dataclasses
import fcntl
import os
import pickle

import numpy as np
import torch


class _Tensor:
    """A torch tensor, saved as its numpy array."""

    def __init__(self, array: np.ndarray):
        self.array = array


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return _Tensor(obj.detach().cpu().numpy())
    if obj is None or isinstance(obj, (bool, int, float, str, np.ndarray, np.generic)):
        return obj
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(_to_numpy(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        out = copy.copy(obj)
        for f in dataclasses.fields(obj):
            object.__setattr__(out, f.name, _to_numpy(getattr(obj, f.name)))
        return out
    if hasattr(obj, "__array__"):   # a JAX array
        return np.asarray(obj)
    raise TypeError(f"cannot cache a {type(obj).__name__}")


def _from_numpy(obj):
    if isinstance(obj, _Tensor):
        return torch.from_numpy(obj.array)
    if isinstance(obj, dict):
        return {k: _from_numpy(v) for k, v in obj.items()}
    if type(obj) in (list, tuple):
        return type(obj)(_from_numpy(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            object.__setattr__(obj, f.name, _from_numpy(getattr(obj, f.name)))
    return obj


def session_cached(tmp_path_factory, name: str, compute):
    """compute() once per session across xdist workers; see the module
    docstring."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = root / f"{name}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(_to_numpy(compute()), f)
            os.replace(tmp, path)
        with open(path, "rb") as f:
            value = pickle.load(f)
    return _from_numpy(value)
