"""The backward of the three denoiser kernels (RELAX taccum, RELAX à-trous,
TAA resolve). On CUDA tensors ``relax.taccum``, ``relax.atrous`` and
``taa.resolve`` run the kernel forward and differentiate the plain version
(``_kernels.with_plain_backward``), as the JAX package's ``custom_vjp``
backwards differentiate their XLA references. Here, on numpy-seeded 24x32
planes, the same Function runs with the plain version as its forward, and
its gradient for a random cotangent is held against ``jax.vjp`` of the
function that the JAX backward differentiates:
``taccum_pallas._reference_impl`` (with the reset folded into the
confidence plane, as ``taccum_fused_auto`` folds it),
``relax.atrous_iteration`` and ``taa.resolve_tail``. An input that the port
does not differentiate (a mask, the depth the disocclusion test compares)
gets None, which must match JAX's zeros.

Tolerance 1e-4 abs/rel: the gradients sum tens of float32 terms, and
XLA's exp and pow differ from PyTorch's by a few ULPs.

At points where the function has no derivative the port takes JAX's
conventions, and the tests count those points:

- à-trous: a tap whose normal term ``clip(dot(n_tap, n), 0, 1)`` is
  exactly 1 (the centre tap of a unit normal, and taps clamped onto it at
  the border) is a tie of the clamp. ``geometry.clip`` passes half of the
  gradient there, as XLA's ``clip`` (a max and a min) does, where a bare
  ``torch.clamp`` would pass all of it. Off the ties every component of
  the normal's gradient agrees; at a tie the pixel agrees within the
  tolerance of its largest component.
- TAA: the CIELAB distance ``|d|`` is exactly 0 wherever the history lies
  inside its clamp window. JAX's vjp is NaN there (sqrt's infinite
  derivative times 0), and its multiplicative selects carry the NaN into
  the gradient of every current-colour pixel. The port takes the
  subgradient 0 there and stays finite. On planes whose history is clamped
  at every pixel (|d| > 0 everywhere) the two agree in full.

The ``cuda`` cases run the dispatchers on the card with inputs that
require grad: the forward must launch the kernel and equal the plain
version within 1e-6, and the gradient must equal the plain version's
autograd gradient within 1e-6 (the backward runs that same plain code)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.denoise import relax as jrelax, taa as jtaa, taccum_pallas
from nrdsample_tpu_torch.denoise import atrous_cuda, common, relax, taa, taa_cuda, taccum_cuda
from nrdsample_tpu_torch.mathlib import color, geometry as geo
from nrdsample_tpu_torch.ops import _kernels
from test_torch_relax import _planes as relax_planes
from test_torch_taa import _planes as taa_planes
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

H, W = 24, 32
GRAD_TOL = 1e-4
KERNEL_TOL = 1e-6
HIST = ("illum", "moments", "view_z", "normal", "frames")


def _cotangents(outs, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*o.shape).astype(np.float32) for o in outs]


def _torch_grads(plain, arrays, seed):
    """(outputs, gradients) of the Function with ``plain`` as its forward and
    backward; a None gradient (an input the output does not depend on
    differentiably) as zeros."""
    ts = [None if a is None else torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = _kernels.with_plain_backward(plain, plain, *ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cts = _cotangents(outs, seed)
    given = [t for t in ts if t is not None]
    grads = iter(torch.autograd.grad(outs, given, [torch.from_numpy(c) for c in cts],
                                     allow_unused=True))
    out = []
    for a, t in zip(arrays, ts):
        g = None if t is None else next(grads)
        out.append(None if a is None else np.zeros_like(a) if g is None else g.numpy())
    return cts, out


def _jax_grads(fn, arrays, cts):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in arrays))
    ct = tuple(jnp.asarray(c) for c in cts)
    return [np.asarray(g) for g in vjp(ct if len(ct) > 1 else ct[0])]


def _bad(got, want):
    """Elements outside the tolerance (NaN counts as outside)."""
    return ~(np.abs(got - want) <= GRAD_TOL * (1.0 + np.abs(want)))


@pytest.mark.parametrize("seed,mv_scale,anti_ff,max_frames,reset,use_conf", [
    (0, 0.8, True, 30.0, False, False),
    (5, 2.4, False, 12.0, False, True),
    (2, 0.8, True, 30.0, True, True),
])
def test_taccum_backward_matches_jax_reference(seed, mv_scale, anti_ff, max_frames, reset,
                                               use_conf):
    hist, illum, vz, n, mv, conf = relax_planes(seed, mv_scale)
    arrays = [hist[k] for k in HIST] + [illum, vz, n, mv, conf if use_conf else None]
    s = relax.RelaxSettings(enable_anti_firefly=anti_ff,
                            max_accumulated_frames=torch.tensor(max_frames))
    js = jrelax.RelaxSettings(enable_anti_firefly=anti_ff, max_accumulated_frames=max_frames)

    def plain(hi, hm, hz, hn, hf, il, z, nn, m, c):
        return relax.taccum_plain(relax.RelaxHistory(hi, hm, hz, hn, hf), il, z, nn, m, s, reset, c)

    def reference(*a):
        c = a[9] if use_conf else jnp.ones((H, W), jnp.float32)
        return taccum_pallas._reference_impl(*a[:9], c * jnp.where(reset, 0.0, 1.0), js)

    cts, got = _torch_grads(plain, arrays, seed + 100)
    want = _jax_grads(reference, [a for a in arrays if a is not None], cts)
    for name, g, w in zip(HIST + ("illum", "view_z", "normal", "mv", "confidence"), got, want):
        assert not _bad(g, w).any(), f"{name}: max |diff| {np.abs(g - w).max()}"


@pytest.mark.parametrize("step", [1, 4])
def test_atrous_backward_matches_jax_reference_except_at_clamp_ties(step):
    _, illum, vz, n, _, conf = relax_planes(3)
    arrays = [illum, conf * 0.5, vz, n]
    s = relax.RelaxSettings()
    cts, got = _torch_grads(lambda *t: relax.atrous_iteration(*t, step, s), arrays, step)
    want = _jax_grads(lambda *a: jrelax.atrous_iteration(*a, step, jrelax.RelaxSettings()),
                      arrays, cts)
    tn = torch.from_numpy(n)
    ties = torch.zeros((H, W), dtype=torch.bool)
    for dy, dx in common.stencil_taps(1):
        ties |= geo.dot3(common.shifted(tn, dy * step, dx * step), tn) == 1.0
    ties = ties.numpy()
    for name, g, w in zip(("illum", "variance", "view_z"), got, want):
        assert not _bad(g, w).any(), f"{name}: max |diff| {np.abs(g - w).max()}"
    off = _bad(got[3], want[3]).any(-1)
    # 376 of the 768 pixels hold a tie at either step; off the ties every
    # component agrees
    assert int(ties.sum()) == 376
    assert not (off & ~ties).any(), f"normal differs off the ties at {np.argwhere(off & ~ties)}"
    # at the ties the port takes JAX's rule (half of the gradient; a bare
    # torch.clamp is off by ~0.5 of the pixel's scale at the median tie):
    # within GRAD_TOL of the pixel's largest |JAX| component, the
    # tie term's factor phi_normal amplifying the ULPs of pow
    err = np.abs(got[3] - want[3]).max(-1) / (1.0 + np.abs(want[3]).max(-1))
    assert err[ties].max() <= GRAD_TOL, f"normal at the ties: max rel diff {err[ties].max()}"


def _clamped_history_planes(seed):
    """cur in [0.4, 0.6], so every clamp window lies inside [0.2, 0.8]
    (sigma of values in a 0.2-wide range is at most 0.1, times 2); each
    history channel in [0.15, 0.2) or (0.8, 0.85], outside every window:
    |d| > 0 at every pixel."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    low = rs.rand(H, W, 3) > 0.5
    prev = np.where(low, 0.15 + 0.05 * rs.rand(H, W, 3), 0.85 - 0.05 * rs.rand(H, W, 3))
    return {"cur": (0.4 + 0.2 * rs.rand(H, W, 3)).astype(f32), "prev": prev.astype(f32),
            "mv_d": ((rs.rand(H, W, 2) * 2 - 1) * 3.0).astype(f32),
            "wide": (rs.rand(H, W) > 0.7).astype(f32), "reset": (rs.rand(H, W) > 0.9).astype(f32)}


def _jnd_zero(p):
    """Pixels where the plain resolve's CIELAB distance is exactly 0."""
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    mu, sigma = taa._moments(t["cur"], 1)
    mu5, sigma5 = taa._moments(t["cur"], 2)
    wm = (t["wide"] > 0.5)[..., None]
    mu, sigma = torch.where(wm, mu5, mu), torch.where(wm, sigma5, sigma)
    cl = torch.minimum(torch.maximum(t["prev"], mu - sigma * 2.0), mu + sigma * 2.0)
    d = color.rgb_to_lab(t["prev"].clamp(0.0, 1.0)) - color.rgb_to_lab(cl.clamp(0.0, 1.0))
    return (geo.dot3(d, d) == 0.0).numpy()


@pytest.mark.parametrize("planes,use_wide", [("clamped history", True),
                                             ("clamped history", False),
                                             ("random", True)])
def test_taa_backward_matches_jax_reference(planes, use_wide):
    p = _clamped_history_planes(11) if planes == "clamped history" else taa_planes(12)
    wide = p["wide"] if use_wide else None
    arrays = [p["cur"], p["prev"], p["mv_d"], wide, p["reset"]]
    cts, got = _torch_grads(lambda *t: taa.resolve_tail(*t, 2.0, 0.1), arrays, 7)

    def reference(c, pr, m, *rest):
        wf, rm = rest if use_wide else (None, rest[0])
        return jtaa.resolve_tail(c, pr, m, wf, rm, 2.0, 0.1)

    want = _jax_grads(reference, [a for a in arrays if a is not None], cts)
    got = [g for g in got if g is not None]
    names = ("cur", "prev", "mv_d") + (("wide",) if use_wide else ()) + ("reset_mix",)
    assert all(np.isfinite(g).all() for g in got)
    zero = _jnd_zero(p)
    if planes == "clamped history":
        assert not zero.any()
        for name, g, w in zip(names, got, want):
            assert not _bad(g, w).any(), f"{name}: max |diff| {np.abs(g - w).max()}"
        return
    # 673 of the 768 pixels have |d| = 0: JAX's prev gradient is NaN at
    # exactly those, its cur gradient everywhere; elsewhere the two agree
    nan_px = np.isnan(want[1]).any(-1)
    assert int(zero.sum()) == 673 and np.array_equal(nan_px, zero)
    assert np.isnan(want[0]).all()
    assert not _bad(got[1], want[1])[~zero].any()
    for name, g, w in zip(names[2:], got[2:], want[2:]):
        assert not _bad(g, w).any(), f"{name}: max |diff| {np.abs(g - w).max()}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_case(kernel, dev):
    """(module of the launch count, dispatcher call, plain call, inputs) on
    270x480 card planes that require grad."""
    if kernel == "taa_resolve":
        p = taa_planes(6, h=270, w=480)
        t = [torch.from_numpy(p[k]).to(dev).requires_grad_()
             for k in ("cur", "prev", "mv_d", "wide", "reset")]
        return (taa_cuda, lambda *a: taa.resolve(*a, 2.0, 0.1),
                lambda *a: taa.resolve_tail(*a, 2.0, 0.1), t)
    hist, illum, vz, n, mv, conf = relax_planes(4, 2.4, h=270, w=480)
    s = relax.RelaxSettings(max_accumulated_frames=torch.tensor(31.0, device=dev))
    if kernel == "relax_atrous":
        t = [torch.from_numpy(a).to(dev).requires_grad_() for a in (illum, conf * 0.5, vz, n)]
        return (atrous_cuda, lambda *a: relax.atrous(*a, 2, s),
                lambda *a: relax.atrous_iteration(*a, 2, s), t)
    t = [torch.from_numpy(a).to(dev).requires_grad_()
         for a in [hist[k] for k in HIST] + [illum, vz, n, mv, conf]]

    def call(fn):
        return lambda *a: fn(relax.RelaxHistory(*a[:5]), *a[5:9], s, False, a[9])

    return taccum_cuda, call(relax.taccum), call(relax.taccum_plain), t


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["relax_taccum", "relax_atrous", "taa_resolve"])
def test_dispatcher_backward_matches_plain_autograd_on_card(cuda_device, kernel):
    counter, dispatch, plain, t = _card_case(kernel, cuda_device)
    before = counter.LAUNCHES
    got = dispatch(*t)
    assert counter.LAUNCHES == before + 1
    want = plain(*t)
    got, want = [x if isinstance(x, tuple) else (x,) for x in (got, want)]
    g = torch.Generator(device="cpu").manual_seed(3)
    cts = [torch.randn(o.shape, generator=g).to(cuda_device) for o in want]
    for a, b in zip(got, want):
        assert bool(((a - b).abs() <= KERNEL_TOL + KERNEL_TOL * b.abs()).all())
    ga = torch.autograd.grad(got, t, cts, allow_unused=True)
    gb = torch.autograd.grad(want, t, cts, allow_unused=True)
    for a, b in zip(ga, gb):
        assert (a is None) == (b is None)
        if a is not None:
            assert bool(((a - b).abs() <= KERNEL_TOL + KERNEL_TOL * b.abs()).all())
