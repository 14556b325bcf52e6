"""Host C++ helpers of the port, loaded with ``ctypes``.

- ``bvh_builder.cpp``: the binned-SAH triangle order of ``ops/cluster``;
- ``gltf_decode.cpp``: the glTF loader's strided accessor decode,
  area-weighted vertex-normal accumulation and PNG scanline unfiltering
  (``scene/gltf``).

Each is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``nrdsample_tpu_torch/_build/``, named by a hash of the source and the flags,
so an edit rebuilds. A failed compile raises with the compiler's message:
there is no quiet fallback (the numpy versions, ``scene/bvh.build_order`` and
``scene/gltf``'s strided view and ``np.add.at`` sums, are the plain versions
the tests hold these to; the numpy BVH order differs on large scenes).
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

_libs: dict = {}


def build(name: str = "bvh_builder") -> str:
    """Compile ``<name>.cpp`` unless a library of the same source and flags
    exists; returns its path."""
    src = os.path.join(_DIR, f"{name}.cpp")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, src, "-o", so], capture_output=True,
                                  text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: {src} needs a C++ compiler") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src} ({proc.returncode}):\n{proc.stderr}")
        os.replace(so, out)
    return out


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(build(name))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        if name == "bvh_builder":
            lib.build_bvh_order.argtypes = [p, p, i64, i32, p]
            lib.build_bvh_order.restype = i32
        else:
            for fn in (lib.gltf_decode_f32, lib.gltf_decode_i64):
                fn.argtypes = [p, i64, i64, i64, i64, i32, i32, p]
                fn.restype = i32
            lib.gltf_accumulate_normals.argtypes = [p, i64, p, i64, p]
            lib.gltf_accumulate_normals.restype = i32
            lib.png_unfilter.argtypes = [p, i64, i64, i32, p]
            lib.png_unfilter.restype = i32
        _libs[name] = lib
    return _libs[name]


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
    depth = _load("bvh_builder").build_bvh_order(tri_min.ctypes.data, tri_max.ctypes.data, n,
                                                 leaf_size, order.ctypes.data)
    if depth < 0:
        raise RuntimeError(f"build_bvh_order rejected n={n}, leaf_size={leaf_size}")
    return order


def decode_accessor(buf: bytes, offset: int, stride: int, count: int, ncomp: int,
                    comp_type: int, as_index: bool = False) -> np.ndarray:
    """``count`` elements of ``ncomp`` components of glTF component type
    ``comp_type`` (5120 BYTE .. 5126 FLOAT), the first at byte ``offset`` of
    ``buf`` and one every ``stride`` bytes, widened to a (count, ncomp)
    float32 array (int64 with ``as_index``) by ``gltf_decode.cpp``. Raises
    ValueError on a bad type, a stride below the element or an accessor past
    the buffer's end."""
    raw = np.frombuffer(buf, np.uint8)
    lib = _load("gltf_decode")
    out = np.empty((count, ncomp), np.int64 if as_index else np.float32)
    fn = lib.gltf_decode_i64 if as_index else lib.gltf_decode_f32
    rc = fn(raw.ctypes.data, raw.size, offset, stride, count, ncomp, comp_type, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"glTF accessor rejected (rc {rc}): offset {offset}, stride {stride}, "
                         f"count {count}, {ncomp} x type {comp_type}, buffer {raw.size} B")
    return out


def accumulate_normals(verts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, not normalized: each (ntri, 3) index
    triangle adds cross(v1 - v0, v2 - v0) to its three corners, in triangle
    order (``gltf_decode.cpp``). (nv, 3) float32; raises ValueError on an
    index out of range."""
    verts = np.ascontiguousarray(verts, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty((len(verts), 3), np.float32)
    rc = _load("gltf_decode").gltf_accumulate_normals(verts.ctypes.data, len(verts),
                                                      idx.ctypes.data, len(idx), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"vertex index out of range in accumulate_normals (rc {rc})")
    return out


def png_unfilter(filtered: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The (height, row_bytes) uint8 scanlines of a non-interlaced 8-bit PNG
    from its inflated IDAT stream (a filter-type byte before each row),
    reconstructed by ``gltf_decode.cpp``. Raises ValueError on a short stream
    or an unknown filter type."""
    raw = np.frombuffer(filtered, np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {raw.size} B, {height} rows of {row_bytes} need "
                         f"{height * (row_bytes + 1)}")
    out = np.empty((height, row_bytes), np.uint8)
    rc = _load("gltf_decode").png_unfilter(raw.ctypes.data, height, row_bytes, bpp,
                                           out.ctypes.data)
    if rc != 0:
        raise ValueError(f"PNG scanlines rejected (rc {rc}): unknown filter type")
    return out
