"""The port's RELAX against the JAX package's, on numpy-seeded 24x32 planes:
the plain temporal accumulation (anti-firefly, accumulation, variance)
against the Pallas taccum kernel in interpret mode below its 3-pixel motion
bound and against its XLA reference above it, the plain à-trous iteration
against the Pallas à-trous kernel in interpret mode, and ``relax.denoise``
against JAX's over two frames.

Tolerances: 2e-5 abs/rel against the Pallas kernels (their tent-stencil
gather sums 81 weighted taps where the port blends 4, the bound of the JAX
package's own parity tests), 1e-5 against XLA (it contracts multiply-adds
into FMAs and evaluates exp and pow by a few ULPs differently). The ``cuda``
cases hold the taccum and à-trous kernels against their plain versions on
the card within 1e-6 and skip where there is none."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.denoise import atrous_pallas, relax as jrelax, taccum_pallas
from nrdsample_tpu_torch.denoise import atrous_cuda, relax, taccum_cuda

H, W = 24, 32
PALLAS_TOL = 2e-5
XLA_TOL = 1e-5
KERNEL_TOL = 1e-6


def _planes(seed, mv_scale=0.8, h=H, w=W):
    """(hist leaves, illum, view_z, normal, mv, confidence) as numpy."""
    rs = np.random.RandomState(seed)
    f32 = np.float32
    illum = rs.rand(h, w, 3).astype(f32) * 3.0
    vz = (1.0 + rs.rand(h, w) * 5.0).astype(f32)
    n = rs.randn(h, w, 3).astype(f32) * 0.3 + np.array([0, 0, 1.0], f32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    mv = ((rs.rand(h, w, 3).astype(f32) * 2 - 1) * np.array([mv_scale, mv_scale, 0.01], f32))
    hist = {"illum": rs.rand(h, w, 3).astype(f32) * 2.0, "moments": rs.rand(h, w, 2).astype(f32),
            "view_z": (vz * (1.0 + rs.randn(h, w) * 0.005)).astype(f32), "normal": n,
            "frames": (rs.rand(h, w) * 20).astype(f32)}
    conf = rs.rand(h, w).astype(f32)
    return hist, illum, vz, n, mv.astype(f32), conf


def _jax(hist, *planes):
    return jrelax.RelaxHistory(**{k: jnp.asarray(v) for k, v in hist.items()}), \
        *(jnp.asarray(p) for p in planes)


def _torch(hist, *planes, device="cpu"):
    return relax.RelaxHistory(**{k: torch.from_numpy(v).to(device) for k, v in hist.items()}), \
        *(torch.from_numpy(p).to(device) for p in planes)


def _close(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.cpu().numpy(), np.asarray(w), rtol=tol, atol=tol,
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("mv_scale", [0.0, 0.8, 2.4])
def test_taccum_plain_matches_pallas_interpret(mv_scale):
    hist, illum, vz, n, mv, _ = _planes(0, mv_scale)
    s = relax.RelaxSettings()
    jh, ji, jz, jn, jm = _jax(hist, illum, vz, n, mv)
    want = taccum_pallas.taccum_variance_pallas(jh, ji, jz, jn, jm, jrelax.RelaxSettings(),
                                                jnp.ones((H, W), jnp.float32), interpret=True)
    th, ti, tz, tn, tm = _torch(hist, illum, vz, n, mv)
    _close(relax.taccum_plain(th, ti, tz, tn, tm, s), want, PALLAS_TOL)


def test_taccum_plain_confidence_no_firefly_matches_pallas_interpret():
    hist, illum, vz, n, mv, conf = _planes(5)
    jh, ji, jz, jn, jm, jc = _jax(hist, illum, vz, n, mv, conf)
    want = taccum_pallas.taccum_variance_pallas(
        jh, ji, jz, jn, jm, jrelax.RelaxSettings(enable_anti_firefly=False,
                                                 max_accumulated_frames=12), jc, interpret=True)
    th, ti, tz, tn, tm, tc = _torch(hist, illum, vz, n, mv, conf)
    s = relax.RelaxSettings(enable_anti_firefly=False, max_accumulated_frames=torch.tensor(12.0))
    _close(relax.taccum_plain(th, ti, tz, tn, tm, s, confidence=tc), want, PALLAS_TOL)


@pytest.mark.parametrize("mv_scale,reset", [(6.0, False), (20.0, False), (0.8, True)])
def test_taccum_plain_matches_reference_at_large_motion_and_reset(mv_scale, reset):
    """Beyond the Pallas kernel's displacement bound (and under a reset) the
    JAX package takes its XLA reference; the port's one gather serves all."""
    hist, illum, vz, n, mv, conf = _planes(2, mv_scale)
    jh, ji, jz, jn, jm, jc = _jax(hist, illum, vz, n, mv, conf)
    want = jax.jit(taccum_pallas.taccum_fused_auto, static_argnums=5)(
        jh, ji, jz, jn, jm, jrelax.RelaxSettings(), reset=jnp.bool_(reset), confidence=jc)
    th, ti, tz, tn, tm, tc = _torch(hist, illum, vz, n, mv, conf)
    got = relax.taccum_plain(th, ti, tz, tn, tm, relax.RelaxSettings(), reset=reset, confidence=tc)
    _close(got, want, XLA_TOL)
    if reset:
        assert float(got[2].max()) == 1.0


@pytest.mark.parametrize("step", [1, 4])
def test_atrous_plain_matches_pallas_interpret(step):
    _, illum, vz, n, _, conf = _planes(3)
    var = conf * 0.5
    want = atrous_pallas.atrous_iteration_pallas(
        jnp.asarray(illum), jnp.asarray(var), jnp.asarray(vz), jnp.asarray(n), step,
        jrelax.RelaxSettings(), interpret=True)
    got = relax.atrous_iteration(*(torch.from_numpy(a) for a in (illum, var, vz, n)), step,
                                 relax.RelaxSettings())
    _close(got, want, PALLAS_TOL)


def test_denoise_matches_jax_over_two_frames():
    """Two frames threaded through each package's history, with a
    confidence plane; the history keeps the first à-trous output."""
    hist, illum, vz, n, mv, conf = _planes(7)
    jh, jz, jn, jm, jc = _jax(hist, vz, n, mv, conf)
    th, tz, tn, tm, tc = _torch(hist, vz, n, mv, conf)
    rs = np.random.RandomState(8)
    jdenoise = jax.jit(jrelax.denoise, static_argnums=5)
    for _ in range(2):
        il = rs.rand(H, W, 3).astype(np.float32) * 2.0
        jout, jh = jdenoise(jh, jnp.asarray(il), jz, jn, jm,
                            jrelax.RelaxSettings(max_accumulated_frames=31), confidence=jc)
        tout, th = relax.denoise(th, torch.from_numpy(il), tz, tn, tm,
                                 relax.RelaxSettings(max_accumulated_frames=torch.tensor(31.0)),
                                 confidence=tc)
        _close([tout], [jout], XLA_TOL)
        for leaf in ("illum", "moments", "frames"):
            _close([getattr(th, leaf)], [getattr(jh, leaf)], XLA_TOL)


def test_kernel_wrappers_refuse_cpu_and_grad():
    hist, illum, vz, n, mv, conf = _planes(1)
    th, ti, tz, tn, tm = _torch(hist, illum, vz, n, mv)
    args = (th.illum, th.moments, th.view_z, th.normal, th.frames, ti, tz, tn, tm, 31.0, 0.02, True)
    with pytest.raises(ValueError):
        taccum_cuda.taccum_variance_cuda(*args)
    with pytest.raises(ValueError):
        atrous_cuda.atrous_iteration_cuda(ti, tz, tz, tn, 1, 4.0, 64.0, 1.0)
    ti.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        taccum_cuda.taccum_variance_cuda(*args[:5], ti, *args[6:])
    with pytest.raises(NotImplementedError):
        atrous_cuda.atrous_iteration_cuda(ti, tz, tz, tn, 1, 4.0, 64.0, 1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _kernel_close(got, want):
    for g, w in zip(got, want):
        assert bool(((g - w).abs() <= KERNEL_TOL + KERNEL_TOL * w.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mv_scale,use_conf,reset", [(2.4, False, False), (20.0, True, False),
                                                     (0.8, True, True)])
def test_taccum_kernel_matches_plain_on_card(cuda_device, mv_scale, use_conf, reset):
    hist, illum, vz, n, mv, conf = _planes(4, mv_scale, h=270, w=480)
    th, ti, tz, tn, tm, tc = _torch(hist, illum, vz, n, mv, conf, device=cuda_device)
    tc = tc if use_conf else None
    s = relax.RelaxSettings(max_accumulated_frames=torch.tensor(31.0, device=cuda_device))
    before = taccum_cuda.LAUNCHES
    got = relax.taccum(th, ti, tz, tn, tm, s, reset, tc)
    assert taccum_cuda.LAUNCHES == before + 1
    _kernel_close(got, relax.taccum_plain(th, ti, tz, tn, tm, s, reset, tc))


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_atrous_kernel_matches_plain_on_card(cuda_device, step):
    _, illum, vz, n, _, conf = _planes(6, h=270, w=480)
    planes = [torch.from_numpy(a).to(cuda_device) for a in (illum, conf * 0.5, vz, n)]
    before = atrous_cuda.LAUNCHES
    got = relax.atrous(*planes, step, relax.RelaxSettings())
    assert atrous_cuda.LAUNCHES == before + 1
    _kernel_close(got, relax.atrous_iteration(*planes, step, relax.RelaxSettings()))
