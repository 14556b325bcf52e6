"""RELAX temporal accumulation on the card: the wrapper of
``csrc/relax_taccum.cu``, the port of the Pallas kernel
``nrdsample_tpu/denoise/taccum_pallas.py:_taccum_kernel``
(``taccum_variance_pallas``). Its plain version is ``relax.taccum_plain``;
``relax.taccum`` picks one of the two by the device of the planes.

The TPU kernel gathers the history with a tent stencil valid only below a
displacement bound of 4 pixels, with an XLA fallback beyond it; one direct
bilinear gather on the card serves every displacement, so neither the bound
nor the fallback carries over.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.denoise import common
from nrdsample_tpu_torch.ops import _kernels

#: launches of the taccum kernel (incremented once per launch)
LAUNCHES = 0


def taccum_variance_cuda(hist_illum, hist_moments, hist_view_z, hist_normal, hist_frames,
                         illum, view_z, normal, mv, max_frames, threshold: float,
                         anti_firefly: bool, reset=False, confidence=None):
    """Launch the taccum kernel on (H, W, C) float32 planes of one CUDA
    device: the history (illum 3, moments 2, view_z, normal 3, frames) and
    the current frame (illum 3, view_z, normal 3, mv 3, optional confidence).
    ``max_frames`` is a number or a 0-d tensor, read by the kernel on the
    device; ``reset`` (a bool or a 0-d bool tensor) zeroes the confidence.
    Returns (acc_illum (H, W, 3), acc_moments (H, W, 2), frames (H, W),
    variance (H, W))."""
    global LAUNCHES
    ins = {"hist_illum": (hist_illum, 3), "hist_moments": (hist_moments, 2),
           "hist_view_z": (hist_view_z, 0), "hist_normal": (hist_normal, 3),
           "hist_frames": (hist_frames, 0), "illum": (illum, 3), "view_z": (view_z, 0),
           "normal": (normal, 3), "mv": (mv, 3)}
    _kernels.check_no_grad("taccum_variance_cuda", *(t for t, _ in ins.values()), confidence)
    dev = illum.device
    if dev.type != "cuda":
        raise ValueError(f"taccum_variance_cuda needs CUDA tensors, got {dev}")
    h, w = view_z.shape
    f32 = torch.float32
    args = {}
    for name, (t, c) in ins.items():
        t = t.contiguous()
        _kernels.check_tensor(name, t, f32, (h, w, c) if c else (h, w), dev)
        args[name] = t
    if reset is not False:
        confidence = torch.where(common.reset_mask(reset, view_z), 0.0,
                                 1.0 if confidence is None else confidence)
    if confidence is not None:
        confidence = confidence.expand(h, w).contiguous()
        _kernels.check_tensor("confidence", confidence, f32, (h, w), dev)
    mf = torch.as_tensor(max_frames, dtype=f32, device=dev).reshape(())
    out_illum = torch.empty((h, w, 3), dtype=f32, device=dev)
    out_moments = torch.empty((h, w, 2), dtype=f32, device=dev)
    out_frames = torch.empty((h, w), dtype=f32, device=dev)
    out_var = torch.empty((h, w), dtype=f32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrd_relax_taccum(
            *(args[k].data_ptr() for k in ins),
            None if confidence is None else confidence.data_ptr(), mf.data_ptr(), h, w,
            float(threshold), int(bool(anti_firefly)), out_illum.data_ptr(),
            out_moments.data_ptr(), out_frames.data_ptr(), out_var.data_ptr(), stream)
    _kernels.check(rc, "nrd_relax_taccum")
    LAUNCHES += 1
    return out_illum, out_moments, out_frames, out_var
