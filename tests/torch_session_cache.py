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

``jax_native_order_ready`` makes sure that the JAX package's cluster builds,
the oracle of the port's exterior and glass tests, order the triangles with
its C++ BVH builder and not with its numpy fallback.

``share_cores_between_workers``, called by every port test module when it is
imported, gives torch's intra-op pool one xdist worker's share of the cores.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import fcntl
import os
import pickle
import time

import numpy as np
import pytest
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


@contextlib.contextmanager
def _session_lock(tmp_path_factory, name: str):
    """Hold the ``fcntl`` lock ``name`` shared by the session's xdist workers
    (in the parent of every worker's ``basetemp``); yields that directory.
    Without xdist there is one process and no lock."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        yield None
        return
    root = tmp_path_factory.getbasetemp().parent
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield root


def session_cached(tmp_path_factory, name: str, compute):
    """compute() once per session across xdist workers; see the module
    docstring."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return compute()
    with _session_lock(tmp_path_factory, name) as root:
        path = root / f"{name}.pkl"
        if not path.exists():
            tmp = root / f"{name}.tmp"
            with open(tmp, "wb") as f:
                pickle.dump(_to_numpy(compute()), f)
            os.replace(tmp, path)
        with open(path, "rb") as f:
            value = pickle.load(f)
    return _from_numpy(value)


def share_cores_between_workers():
    """Under pytest-xdist, cap torch's intra-op threads at this worker's
    share of the cores (at least one); without xdist, change nothing.

    torch's default is a thread per core in every process. With six workers
    on eight cores that oversubscribes the cores: the threads spin after
    each parallel region and wait in its barriers, which slows the port's
    tests and the JAX tests that share the cores with them."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is not None:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))


def jax_native_order_ready(tmp_path_factory, tries: int = 20, wait_s: float = 0.5):
    """Load the JAX package's C++ BVH order builder in this process and
    return it; fail the test if it cannot be loaded.

    ``nrdsample_tpu.native`` compiles its builder, when the cached library is
    older than the source, into one shared temporary path. Workers that
    compile at once race on it; a loser's ``os.replace`` raises, the loader
    caches ``None`` for the life of the process, and ``ops/cluster`` then
    orders the triangles with numpy, which differs from the C++ order (and
    from the port's) on the exterior. Under the session's lock this drops a
    cached ``None`` and loads again, waiting while another process still
    compiles."""
    from nrdsample_tpu import native as jnative

    with _session_lock(tmp_path_factory, "jax_native_order"):
        for _ in range(tries):
            if jnative._LIBS.get("bvh_builder", True) is None:
                del jnative._LIBS["bvh_builder"]
            lib = jnative.get_lib()
            if lib is not None:
                return lib
            time.sleep(wait_s)
    pytest.fail("the JAX package's C++ BVH builder (nrdsample_tpu/native/bvh_builder.cpp) did "
                "not load: its cluster builds would fall back to the numpy order, which is not "
                "the oracle of the port's tests")
