"""The TAA resolve on the card: the wrapper of ``csrc/taa_resolve.cu``, the
port of the Pallas kernel ``nrdsample_tpu/denoise/taa_pallas.py:_taa_kernel``
(``taa_resolve_pallas``). Its plain version is ``taa.resolve_tail``;
``taa.resolve`` picks one of the two by the device of the planes.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.ops import _kernels

#: launches of the TAA resolve kernel (incremented once per launch)
LAUNCHES = 0


def taa_resolve_cuda(cur, prev, mv_d, wide_mask, reset_mix, sigma_scale: float,
                     base_mix: float):
    """Launch the resolve on float32 planes of one CUDA device: cur and prev
    (H, W, 3), mv_d (H, W, 2), wide_mask (H, W) or None (no 5x5
    neighbourhood), reset_mix (H, W). Returns (H, W, 3)."""
    global LAUNCHES
    _kernels.check_no_grad("taa_resolve_cuda", cur, prev, mv_d, wide_mask, reset_mix)
    dev = cur.device
    if dev.type != "cuda":
        raise ValueError(f"taa_resolve_cuda needs CUDA tensors, got {dev}")
    h, w = cur.shape[:2]
    f32 = torch.float32
    planes = {"cur": (cur, (h, w, 3)), "prev": (prev, (h, w, 3)), "mv_d": (mv_d, (h, w, 2)),
              "reset_mix": (reset_mix, (h, w))}
    if wide_mask is not None:
        planes["wide_mask"] = (wide_mask, (h, w))
    args = {}
    for name, (t, shape) in planes.items():
        t = t.contiguous()
        _kernels.check_tensor(name, t, f32, shape, dev)
        args[name] = t
    out = torch.empty((h, w, 3), dtype=f32, device=dev)
    wide = args.get("wide_mask")
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrd_taa_resolve(args["cur"].data_ptr(), args["prev"].data_ptr(),
                                 args["mv_d"].data_ptr(), None if wide is None else wide.data_ptr(),
                                 args["reset_mix"].data_ptr(), h, w, float(sigma_scale),
                                 float(base_mix), out.data_ptr(), stream)
    _kernels.check(rc, "nrd_taa_resolve")
    LAUNCHES += 1
    return out
