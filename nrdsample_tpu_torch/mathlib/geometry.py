"""Geometry helpers — ml.hlsli ``Geometry::*`` equivalents + ray offsets.

Vector ops are written per component, not as ``sum``/``einsum`` over the
trailing axis, so the order of every add is fixed and the same on the CPU
and on the card.

``clip`` / ``clip_min`` / ``clip_max`` are the clamps of every gradient path:
they give JAX's tie rule (``jnp.clip`` / ``maximum`` / ``minimum``), where a
bare ``torch.clamp`` passes the whole gradient at ``x == bound``. ``absolute``
is ``torch.abs`` with ``jnp.abs``'s derivative at 0 (+1, where PyTorch's is 0).
"""

from __future__ import annotations

import torch


def _tie_weights(a, b, out):
    """JAX's ``_balanced_eq`` for out = max(a, b) or min(a, b): the share of
    the gradient each input takes, halved where both equal the result. A NaN
    input takes none."""
    ea, eb = a == out, b == out
    return ea / (1.0 + eb.to(out.dtype)), eb / (1.0 + ea.to(out.dtype))


def _sum_to(g, shape):
    """Reduce a broadcast gradient back to ``shape``."""
    if tuple(g.shape) == tuple(shape):
        return g
    lead = g.dim() - len(shape)
    g = g.sum(dim=tuple(range(lead))) if lead else g
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and g.shape[i] != 1)
    return g.sum(dim=dims, keepdim=True) if dims else g


class _Clip(torch.autograd.Function):
    """min(max(x, lo), hi) with JAX's gradient: each of max and min splits
    the gradient evenly between the operands that equal its result, so
    x == bound passes 0.5, as ``jnp.clip`` does. lo and hi are tensors of
    x's dtype or None."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        m = x if lo is None else torch.maximum(x, lo)
        out = m if hi is None else torch.minimum(m, hi)
        ctx.save_for_backward(x, lo, hi, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, lo, hi, out = ctx.saved_tensors
        m = x if lo is None else torch.maximum(x, lo)
        g_m, g_hi = (g, None) if hi is None else (g * w for w in _tie_weights(m, hi, out))
        g_x, g_lo = (g_m, None) if lo is None else (g_m * w for w in _tie_weights(x, lo, m))
        grads = []
        for t, gt in ((x, g_x), (lo, g_lo), (hi, g_hi)):
            need = t is not None and gt is not None and ctx.needs_input_grad[len(grads)]
            grads.append(_sum_to(gt, t.shape) if need else None)
        return tuple(grads)


def clip(x, lo=None, hi=None):
    """``torch.clamp(x, lo, hi)`` with ``jnp.clip``'s gradient (0.5 at a
    tie, not 1; NaN in, NaN out). Where nothing requires grad it is
    ``torch.clamp`` itself: the same single launch and the same bits. lo /
    hi: a number, a tensor or None."""
    if not (torch.is_grad_enabled()
            and any(isinstance(t, torch.Tensor) and t.requires_grad for t in (x, lo, hi))):
        return torch.clamp(x, lo, hi)

    def bound(b):
        return None if b is None else torch.as_tensor(b, dtype=x.dtype, device=x.device)

    return _Clip.apply(x, bound(lo), bound(hi))


class _Abs(torch.autograd.Function):
    """|x| with JAX's derivative: +1 where x >= 0, else -1."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0.0, g, -g)


def absolute(x):
    """``torch.abs(x)`` with ``jnp.abs``'s gradient: at x == 0 the gradient
    passes whole (PyTorch's abs passes none), which matters wherever two
    equal values meet in |a - b| (a stencil's equal luminances or depths).
    Where x does not require grad it is ``torch.abs`` itself."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Abs.apply(x)
    return torch.abs(x)


def clip_min(x, lo):
    """``torch.clamp_min`` with ``jnp.maximum``'s gradient; see ``clip``."""
    return clip(x, lo, None)


def clip_max(x, hi):
    """``torch.clamp_max`` with ``jnp.minimum``'s gradient; see ``clip``."""
    return clip(x, None, hi)


def dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def length(v, eps: float = 1e-15):
    """Gradient-safe |v| (sqrt of a clamped argument)."""
    return torch.sqrt(clip_min(dot3(v, v), eps * eps))


def normalize(v, eps: float = 1e-15):
    """v x 1/sqrt(|v|^2), the sqrt and the reciprocal each rounded once, so
    that the card and the CPU give the same bits: the CPU's ``torch.rsqrt``
    is that, the card's is an approximation (within 2 ULPs), so the card
    takes ``torch.sqrt`` and ``torch.reciprocal``, both IEEE there."""
    n2 = clip_min(dot3(v, v)[..., None], eps * eps)
    inv = torch.reciprocal(torch.sqrt(n2)) if n2.is_cuda else torch.rsqrt(n2)
    return v * inv


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def rotate_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors [..., 3] by the upper 3x3 of a (4, 4) or (3, 3) matrix."""
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [m[i, 0] * vx + m[i, 1] * vy + m[i, 2] * vz for i in range(3)], dim=-1
    )


def affine_transform(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) affine matrix to points [..., 3]."""
    return rotate_vector(m, p) + m[:3, 3]


def orthonormal_basis(n: torch.Tensor):
    """Right-handed TBN around unit normal n (Frisvad / Pixar revised).
    Returns (t, b) with n = t x b."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -torch.reciprocal(s + nz)
    bv = nx * ny * a
    t = torch.stack([1.0 + s * nx * nx * a, s * bv, -s * nx], dim=-1)
    b = torch.stack([bv, s + ny * ny * a, -ny], dim=-1)
    return t, b


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return v - 2.0 * dot3(v, n)[..., None] * n


def refract(v: torch.Tensor, n: torch.Tensor, eta) -> torch.Tensor:
    """Refract the incident v (pointing into the surface) about n, with eta =
    n_i / n_t (a scalar or a per-ray tensor); 0 on total internal
    reflection."""
    eta = torch.as_tensor(eta, dtype=v.dtype, device=v.device)
    cos_i = -dot3(v, n)
    sin2_t = (eta * eta) * clip_min(1.0 - cos_i * cos_i, 0.0)
    cos_t = torch.sqrt(clip_min(1.0 - sin2_t, 0.0) + 1e-12)
    r = eta[..., None] * v + (eta * cos_i - cos_t)[..., None] * n
    return torch.where((sin2_t > 1.0)[..., None], 0.0, r)


def offset_ray(p: torch.Tensor, n: torch.Tensor, view_z, unproject, offset_pixels: float):
    """Self-intersection offset along the normal: pixels of world size at
    the hit's depth, clamped to 1e-5."""
    w = absolute(view_z) * unproject * offset_pixels
    w = clip_min(w, 1e-5)
    return p + n * w[..., None]


def smoothstep(a, b, x):
    """Hermite smoothstep that also takes decreasing edges (a > b)."""
    d = b - a
    if isinstance(d, torch.Tensor):
        tiny = torch.where(d >= 0, 1e-15, -1e-15)
        d = torch.where(absolute(d) < 1e-15, tiny, d)
    elif abs(d) < 1e-15:
        d = 1e-15 if d >= 0 else -1e-15
    t = clip((x - a) / d, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def pow01(x, e):
    """x^e on [0, 1], zero (with a finite gradient) at 0."""
    xc = clip(x, 0.0, 1.0)
    safe = torch.pow(clip_min(xc, 1e-9), e)
    return torch.where(xc <= 0.0, 0.0, safe)


def sqrt01(x):
    xc = clip(x, 0.0, 1.0)
    return torch.where(xc <= 0.0, 0.0, torch.sqrt(clip_min(xc, 1e-12)))


def positive_rcp(x, eps: float = 1e-15):
    return torch.reciprocal(clip_min(x, eps))
