"""Host C++ helpers of the port, loaded with ``ctypes``.

``bvh_builder.cpp`` (the binned-SAH triangle order of ``ops/cluster``) is
compiled with ``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``nrdsample_tpu_torch/_build/``, named by a hash of the source and the flags,
so an edit rebuilds. A failed compile raises with the compiler's message:
there is no quiet fallback, since the numpy version orders large scenes
differently (``scene/bvh.build_order`` is the plain version the tests use).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def build() -> str:
    """Compile ``bvh_builder.cpp`` unless a library of the same source and
    flags exists; returns its path."""
    src = os.path.join(_DIR, "bvh_builder.cpp")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"libbvh_builder_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, src, "-o", so], capture_output=True,
                                  text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the BVH order builder needs a C++ compiler") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src} ({proc.returncode}):\n{proc.stderr}")
        os.replace(so, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        p = ctypes.c_void_p
        lib.build_bvh_order.argtypes = [p, p, ctypes.c_int64, ctypes.c_int, p]
        lib.build_bvh_order.restype = ctypes.c_int
        _lib = lib
    return _lib


def build_order(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int) -> np.ndarray:
    """The triangle permutation (int64, order[new] = old) of the binned-SAH
    build over (n, 3) triangle AABBs: the order of ``scene/bvh.build_order``,
    computed by ``bvh_builder.cpp``."""
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    n = len(tri_min)
    order = np.empty(n, np.int64)
    if n == 0:
        return order
    depth = _load().build_bvh_order(tri_min.ctypes.data, tri_max.ctypes.data, n, leaf_size,
                                    order.ctypes.data)
    if depth < 0:
        raise RuntimeError(f"build_bvh_order rejected n={n}, leaf_size={leaf_size}")
    return order
