"""History gathers on the card: the wrapper of ``csrc/bilinear_sample.cu``,
the port of the Pallas kernel ``nrdsample_tpu/ops/reproject.py:_vertical_kernel``
(``reproject_bounded``), and the dispatchers the denoisers call. The plain
version is ``mathlib/filtering.sample_bilinear``.

The TPU kernel is a tent-weighted stencil valid only below a static
displacement bound, picked by a runtime cond; one direct gather on the card
computes the same function for any displacement, so neither the bound nor the
tiers carry over.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.mathlib import filtering
from nrdsample_tpu_torch.ops import _kernels

#: launches of the bilinear gather kernel (incremented once per launch)
LAUNCHES = 0


def sample_bilinear_cuda(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Launch the bilinear gather kernel: img (H, W) or (H, W, C) and pos
    (..., 2) contiguous float32 on one CUDA device. Returns (...) or
    (..., C). Raises on an input that requires grad: the kernel has no
    backward."""
    global LAUNCHES
    _kernels.check_no_grad("sample_bilinear_cuda", img, pos)
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"sample_bilinear_cuda needs CUDA tensors, got {dev}")
    if img.dim() not in (2, 3) or pos.dim() < 1 or pos.shape[-1] != 2:
        raise ValueError(f"expected img (H, W[, C]) and pos (..., 2), got {tuple(img.shape)} "
                         f"and {tuple(pos.shape)}")
    f32 = torch.float32
    h, w = img.shape[0], img.shape[1]
    c = img.shape[2] if img.dim() == 3 else 1
    _kernels.check_tensor("img", img, f32, img.shape, dev)
    _kernels.check_tensor("pos", pos, f32, pos.shape, dev)
    n = pos.numel() // 2
    out = torch.empty(pos.shape[:-1] + img.shape[2:], dtype=f32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.nrd_bilinear_sample(img.data_ptr(), h, w, c, pos.data_ptr(), n,
                                     out.data_ptr(), stream)
    _kernels.check(rc, "nrd_bilinear_sample")
    LAUNCHES += 1
    return out


def sample_bilinear_auto(img: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge bilinear sample of img at pos [..., 2] (any leading
    batch, such as a tap axis): the kernel for CUDA tensors, the plain
    version for CPU tensors. Where an input requires grad (REBLUR's
    specular history is gathered at a virtual motion that depends on the
    roughness) the kernel runs forward and the plain version's autograd
    gives the gradient, as the JAX package differentiates its XLA gather;
    the launch is the same."""
    if img.device.type == "cuda":
        if torch.is_grad_enabled() and (img.requires_grad or pos.requires_grad):
            return _kernels.with_plain_backward(
                lambda i, p: sample_bilinear_cuda(i.contiguous(), p.contiguous()),
                filtering.sample_bilinear, img, pos)
        return sample_bilinear_cuda(img.contiguous(), pos.contiguous())
    if img.device.type == "cpu":
        return filtering.sample_bilinear(img, pos)
    raise ValueError(f"no bilinear gather for device {img.device}")


def sample_bicubic_auto(img: torch.Tensor, pos: torch.Tensor, sharpness: float = 0.66):
    """5-tap no-corners bicubic whose taps go through ``sample_bilinear_auto``
    (five kernel launches on the card)."""
    return filtering.sample_bicubic_no_corners(img, pos, sharpness,
                                               bilinear_fn=sample_bilinear_auto)
