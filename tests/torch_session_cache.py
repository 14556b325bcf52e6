"""Compute a costly module fixture of the port's tests once per pytest
session, across pytest-xdist workers.

Under ``--dist load`` a module-scoped fixture runs on every worker that gets
one of its module's tests; the port's frame fixtures (a JAX jit of the whole
frame beside the port's frame) take minutes each. ``session_cached`` lets the
first worker compute the value and save it, as numpy arrays, in the
session's shared temporary directory (the parent of every worker's
``basetemp``), under an ``fcntl`` lock; the other workers load it, and one
that finds it being computed first computes a value that its own tests or
another module's (``declare``) need and no worker has started. Torch tensors come back as CPU torch tensors, JAX arrays as
numpy arrays. Without xdist the value is simply computed.

``jax_native_order_ready`` makes sure that the JAX package's cluster builds,
the oracle of the port's exterior and glass tests, order the triangles with
its C++ BVH builder and not with its numpy fallback.

``share_cores_between_workers``, called by every port test module when it is
imported, gives torch's intra-op pool one xdist worker's share of the cores,
and points JAX's persistent compilation cache at a directory of the session
that all its workers share: a program one worker compiled (the JAX oracles
of the port's tests, the same module fixture on two workers under ``--dist
load``) is loaded by the others instead of compiled again (programs that
compile in a second or more: JAX's default). Each session starts with an
empty cache. An entry is written to a temporary file of its own and renamed
into place, so a worker sees no entry or a whole one, never one that another
worker is still writing.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import fcntl
import os
import pickle
import tempfile
import time
import traceback

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


def _save_once(root, name: str, compute):
    """Save compute()'s value as ``name`` unless it is saved already; the
    caller holds ``name``'s lock."""
    path = root / f"{name}.pkl"
    if not path.exists():
        tmp = root / f"{name}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(_to_numpy(compute()), f)
        os.replace(tmp, path)
    return path


def _save_if_free(root, name: str, compute) -> bool:
    """Compute and save ``name`` if no worker holds its lock; False if one
    does."""
    with open(root / f"{name}.lock", "w") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return False
        _save_once(root, name, compute)
        return True


_DECLARED: dict = {}


def declare(name: str, compute, native_order: bool = False):
    """Declare, when a test module is imported, a value that its fixtures
    fetch with ``session_cached(..., name, ...)``: compute(tmp_path_factory)
    gives it (after ``jax_native_order_ready`` with ``native_order``). Every
    xdist worker imports every test module, so each knows all declared
    values; a worker that finds the value it needs being computed by another
    computes a declared one that no worker has saved or started, the last
    declared first, rather than wait idle on the lock."""
    _DECLARED[name] = (compute, native_order)


def _declared(tmp_path_factory) -> dict:
    def run(fn, native_order):
        if native_order:
            jax_native_order_ready(tmp_path_factory)
        return fn(tmp_path_factory)

    return {k: (lambda fn=fn, n=n: run(fn, n)) for k, (fn, n) in _DECLARED.items()}


def session_cached(tmp_path_factory, name: str, compute, others: dict | None = None):
    """compute() once per session across xdist workers; see the module
    docstring. ``others``, {name: compute} of the values the same tests need
    besides this one, and then the values other modules ``declare``, let a
    worker that finds this value being computed by another worker compute
    one of those that no worker has saved or started, rather than wait idle
    on the lock."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        return compute()
    root = tmp_path_factory.getbasetemp().parent
    candidates = dict(others or {})
    # the values declared last first: their modules run last (collection
    # order), so computing them now shortens the run's tail
    for k, fn in reversed(_declared(tmp_path_factory).items()):
        candidates.setdefault(k, fn)
    pending = [(k, fn) for k, fn in candidates.items() if k != name]
    while pending and not _save_if_free(root, name, compute):
        other, fn = pending.pop(0)
        if not (root / f"{other}.pkl").exists():
            try:
                _save_if_free(root, other, fn)
            except Exception:   # noqa: BLE001 -- the value's own tests compute it and report
                traceback.print_exc()
    with _session_lock(tmp_path_factory, name):
        with open(_save_once(root, name, compute), "rb") as f:
            value = pickle.load(f)
    return _from_numpy(value)


def share_cores_between_workers():
    """Under pytest-xdist, cap torch's intra-op threads at this worker's
    share of the cores (at least one) and share JAX's compiled programs
    with the session's other workers (``_share_jax_compiles``); without
    xdist, change nothing.

    torch's default is a thread per core in every process. With six workers
    on eight cores that oversubscribes the cores: the threads spin after
    each parallel region and wait in its barriers, which slows the port's
    tests and the JAX tests that share the cores with them."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is not None:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(workers)))
        _share_jax_compiles()


def _share_jax_compiles():
    """Under xdist, a JAX compilation cache in the temporary directory,
    named by the session's run id (the same on every worker of the
    session), whose entries are written atomically (``_atomic_file_cache``).
    Its size limit stays unset: a limit turns on a file lock and a scan of
    the directory at every write, which made the port's tests take three
    times as long."""
    import jax
    from jax._src import compilation_cache

    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None or jax.config.jax_compilation_cache_dir:
        return
    path = os.path.join(tempfile.gettempdir(), f"nrdsample-jax-cache-{run}")
    compilation_cache.get_file_cache = lambda p: (_atomic_file_cache(p), p)
    jax.config.update("jax_compilation_cache_dir", path)


def _atomic_file_cache(path: str):
    """JAX's file cache with no size limit, whose ``put`` writes an entry
    to a file named by this process and renames it into place: JAX's own
    writes the entry's file in place, and a reader on another worker can
    find it half written."""
    from jax._src import lru_cache

    class AtomicFileCache(lru_cache.LRUCache):
        def put(self, key: str, val: bytes) -> None:
            final = self.path / f"{key}{lru_cache._CACHE_SUFFIX}"
            if final.exists():
                return
            part = final.with_name(f".{final.name}.{os.getpid()}.part")
            part.write_bytes(val)
            os.replace(part, final)

    return AtomicFileCache(path, max_size=-1)


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
