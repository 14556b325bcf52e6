"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``
(all started together) and linked into one shared library with a plain C
interface under ``nrdsample_tpu_torch/_build/`` at first use (named by a hash
of the sources and the ``csrc/*.cuh`` headers, so an edit rebuilds), then
loaded with ``ctypes``. ``--fmad=false`` keeps the
kernels' arithmetic the unfused sequence of the plain PyTorch versions; no
fast-math flag is given, so ``1.0f / det`` stays IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    # origin, direction, p0, e1, e2, n_tris, t_max (nullable), t_max scalar,
    # n_rays, t, u, v, tri, stream
    "nrd_dense_hit": [_P, _P, _P, _P, _P, _I32, _P, _F32, _I64, _P, _P, _P, _P, _P],
    # origin, direction, p0, e1, e2, intensity, n_tris, n_rays, out, stream
    "nrd_emissive_probe": [_P, _P, _P, _P, _P, _P, _I32, _I64, _P, _P],
    # origin, direction, t_max, order, keys, slab, n_clusters, n_packets,
    # any_hit, t, u, v, tri, stream
    "nrd_packet_hit": [_P, _P, _P, _P, _P, _P, _I32, _I64, _I32, _P, _P, _P, _P, _P],
    # the same and need_uv after any_hit
    "nrd_packet_hit_stream": [_P, _P, _P, _P, _P, _P, _I32, _I64, _I32, _I32, _P, _P, _P, _P,
                              _P],
    # img, h, w, c, pos, n, out, stream
    "nrd_bilinear_sample": [_P, _I32, _I32, _I32, _P, _I64, _P, _P],
    # hist illum, moments, view_z, normal, frames; illum, view_z, normal, mv,
    # confidence (nullable), max_frames (device scalar), h, w, threshold,
    # anti_firefly; out illum, moments, frames, variance; stream
    "nrd_relax_taccum": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _I32, _F32, _I32,
                         _P, _P, _P, _P, _P],
    # illum, variance, view_z, normal, h, w, step, phi_l, phi_n, phi_d; out
    # illum, variance; stream
    "nrd_relax_atrous": [_P, _P, _P, _P, _I32, _I32, _I32, _F32, _F32, _F32, _P, _P, _P],
    # cur, prev, mv_d, wide (nullable), reset_mix, h, w, sigma_scale, base_mix,
    # out, stream
    "nrd_taa_resolve": [_P, _P, _P, _P, _P, _I32, _I32, _F32, _F32, _P, _P],
}

_lib = None
BUILD_SECONDS = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def sources(suffixes=(".cu",)) -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(suffixes))


def build(verbose: bool = False) -> str:
    """Compile the kernels unless a library built from the same sources
    and headers exists; returns its path."""
    global BUILD_SECONDS
    srcs = sources()
    h = hashlib.sha256()
    for s in sources((".cu", ".cuh")):
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"libnrd_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        # one nvcc per source, all at once, then one link
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        procs = [subprocess.Popen([nvcc, *compile_flags, *(["-Xptxas", "-v"] if verbose else []),
                                   "-c", "-o", o, s], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [(p, *p.communicate()) for p in procs]
        failed = [err for p, _, err in logs if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", so, *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        if verbose:
            print("".join(err for _, _, err in logs), end="")
        os.replace(so, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built and loaded on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaGetLastError() code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def check_no_grad(name: str, *tensors) -> None:
    """Raise if any input needs a gradient: the kernels have no backward
    yet, and a result that silently drops the gradient would be wrong."""
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no backward: an input requires grad")


def check_tensor(name: str, x, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous tensor of ``dtype`` and ``shape`` on
    ``device``: the kernels read raw pointers with this layout."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
