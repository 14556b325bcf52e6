"""The port's denoiser building blocks against the JAX package's, on
numpy-seeded 24x32 planes: the bilinear and bicubic filters and their
dispatch, the shared stencil helpers, the hit-distance reconstruction, SIGMA
and each step of REBLUR, threaded over 3 frames. Float32 results agree
within 1e-5 abs/rel (XLA contracts multiply-adds into FMAs and evaluates pow
and exp differently from torch by a few ULPs). The blue-noise sample is
bit for bit.

The ``cuda`` case holds the bilinear gather kernel against its plain version
on the card and skips where there is none."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.denoise import checkerboard as jcb, common as jcommon, reblur as jreblur
from nrdsample_tpu.denoise import sigma as jsigma
from nrdsample_tpu.mathlib import bluenoise as jbluenoise, filtering as jfiltering
from nrdsample_tpu.ops import reproject as jreproject
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.denoise import checkerboard, common, reblur, sigma
from nrdsample_tpu_torch.mathlib import bluenoise, filtering
from nrdsample_tpu_torch.ops import reproject
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

TOL = 1e-5
H, W = 24, 32


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _planes(seed):
    """A frame's worth of G-buffer-like planes as numpy arrays."""
    rs = np.random.RandomState(seed)
    n = rs.randn(H, W, 3).astype(np.float32)
    n[..., 2] = np.abs(n[..., 2]) + 1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    mv = np.concatenate([rs.uniform(-3.0, 3.0, (H, W, 2)),
                         rs.uniform(-0.02, 0.02, (H, W, 1))], -1).astype(np.float32)
    view_z = rs.uniform(1.0, 10.0, (H, W)).astype(np.float32)
    view_z[:4, :6] = 1e5                                 # sky
    hitdist = rs.uniform(0.0, 4.0, (H, W)).astype(np.float32)
    hitdist[rs.uniform(size=(H, W)) < 0.4] = 0.0         # the unsampled lobe
    return {
        "illum": (rs.gamma(1.0, 0.5, (H, W, 3)) * (rs.uniform(size=(H, W, 1)) < 0.98)
                  + 40.0 * (rs.uniform(size=(H, W, 1)) > 0.995)).astype(np.float32),
        "hitdist": hitdist, "view_z": view_z, "normal": n, "mv": mv,
        "roughness": rs.uniform(0.0, 1.0, (H, W)).astype(np.float32),
        "shadow": (rs.uniform(size=(H, W)) < 0.7).astype(np.float32),
        "shadow_hit_dist": np.where(rs.uniform(size=(H, W)) < 0.3,
                                    rs.uniform(0.1, 5.0, (H, W)), 0.0).astype(np.float32),
    }


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _pos(seed, shape, disp):
    rs = np.random.RandomState(seed)
    pc = np.stack(np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5), -1)
    return (pc + rs.uniform(-disp, disp, shape + (2,))).astype(np.float32)


@pytest.mark.parametrize("channels", [None, 3, 9])
@pytest.mark.parametrize("disp", [0.4, 3.0, 40.0])
def test_bilinear_and_bicubic_match_jax(channels, disp):
    rs = np.random.RandomState(channels or 1)
    img = rs.randn(*((H, W) if channels is None else (H, W, channels))).astype(np.float32)
    jimg, timg = _both(img)
    jpos, tpos = _both(_pos(2, (H, W), disp))
    _close(filtering.sample_bilinear(timg, tpos), jfiltering.sample_bilinear(jimg, jpos))
    _close(reproject.sample_bilinear_auto(timg, tpos), jreproject.sample_bilinear_auto(jimg, jpos))
    if channels is not None:
        _close(filtering.sample_bicubic_no_corners(timg, tpos),
               jfiltering.sample_bicubic_no_corners(jimg, jpos))
        _close(reproject.sample_bicubic_auto(timg, tpos), jreproject.sample_bicubic_auto(jimg, jpos))


def test_bilinear_batched_taps_match_jax():
    img = np.random.RandomState(3).randn(H, W, 3).astype(np.float32)
    pos = np.stack([_pos(s, (H, W), 14.0) for s in range(8)])     # (8, H, W, 2)
    (jimg, timg), (jpos, tpos) = _both(img), _both(pos)
    got = reproject.sample_bilinear_auto(timg, tpos)
    assert tuple(got.shape) == (8, H, W, 3)
    _close(got, jreproject.sample_bilinear_auto(jimg, jpos))


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, -1), (-2, 3), (8, -8), (-30, 40)])
def test_shifted_matches_jax(dy, dx):
    img = np.random.RandomState(4).randn(H, W, 5).astype(np.float32)
    jimg, timg = _both(img)
    assert np.array_equal(common.shifted(timg, dy, dx).numpy(), np.asarray(jcommon.shifted(jimg, dy, dx)))
    assert np.array_equal(common.shifted(timg[..., 0], dy, dx).numpy(),
                          np.asarray(jcommon.shifted(jimg[..., 0], dy, dx)))


def test_common_helpers_match_jax():
    p = _planes(5)
    j = {k: jnp.asarray(v) for k, v in p.items()}
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    assert common.stencil_taps(2) == jcommon.stencil_taps(2)
    assert np.array_equal(common.pixel_positions(H, W).numpy(), np.asarray(jcommon.pixel_positions(H, W)))
    for bicubic in (False, True):
        _close(common.reproject(t["illum"], t["mv"][..., :2], bicubic),
               jcommon.reproject(j["illum"], j["mv"][..., :2], bicubic))
    _close(common.anti_firefly(t["illum"]), jcommon.anti_firefly(j["illum"]))
    mv_far = t["mv"][..., :2] * 4.0
    assert np.array_equal(common.in_screen(mv_far, H, W).numpy(),
                          np.asarray(jcommon.in_screen(jnp.asarray(mv_far.numpy()), H, W)))
    prev_z = t["view_z"] * 1.015
    prev_n = torch.roll(t["normal"], 1, 0)
    for normals in (False, True):
        extra = (t["normal"], prev_n) if normals else ()
        jextra = (j["normal"], jnp.asarray(prev_n.numpy())) if normals else ()
        got = common.disocclusion_weight(t["view_z"], t["mv"][..., 2], prev_z, *extra)
        want = jcommon.disocclusion_weight(j["view_z"], j["mv"][..., 2],
                                           jnp.asarray(prev_z.numpy()), *jextra)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert 0.0 < float(got.mean()) < 1.0


def test_hitdist_reconstruct_matches_jax():
    hd = _planes(6)["hitdist"]
    hd[10:14, 10:14] = 0.0
    _close(checkerboard.hitdist_reconstruct_3x3(torch.from_numpy(hd)),
           jcb.hitdist_reconstruct_3x3(jnp.asarray(hd)))


def test_blue2_bit_exact():
    idx = np.arange(0, 200 * 97, 7, dtype=np.int32)
    for frame in (0, 1, 37, 5000):
        for dim in (501, 10_205):
            want = np.asarray(jbluenoise.blue2(jnp.asarray(idx), 97, jnp.int32(frame), dim))
            got = bluenoise.blue2(torch.from_numpy(idx), 97, torch.tensor(frame, dtype=torch.int32), dim)
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), want)


def _np_leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _hist_close(got, want):
    for k, v in _np_leaves(want).items():
        _close(getattr(got, k), v)


def test_sigma_denoise_over_three_frames():
    jh = jsigma.SigmaHistory.create(H, W)
    th = convert.history_from_numpy({"frame_index": np.int32(0), "sigma": _np_leaves(jh)},
                                    device="cpu").sigma
    tan_sun, unproj = np.float32(0.00465), np.float32(0.0364)
    j_denoise = jax.jit(lambda h, *a: jsigma.denoise(h, *a[:4], jnp.float32(tan_sun),
                                                     jnp.float32(unproj), a[4]))
    for frame in range(3):
        p = _planes(10 + frame)
        jargs = [jnp.asarray(p[k]) for k in ("shadow", "shadow_hit_dist", "view_z", "mv")]
        targs = [torch.from_numpy(p[k]) for k in ("shadow", "shadow_hit_dist", "view_z", "mv")]
        jout, jh = j_denoise(jh, *jargs, jnp.int32(frame))
        tout, th = sigma.denoise(th, *targs, torch.tensor(tan_sun), torch.tensor(unproj),
                                 torch.tensor(frame, dtype=torch.int32))
        _close(tout, jout)
        _hist_close(th, jh)
    assert 0.0 < float(tout.mean()) < 1.0 and float(th.frames.max()) == 3.0


def _reblur_settings():
    js = jreblur.ReblurSettings(max_accumulated_frames=jnp.float32(31.0),
                                max_fast_accumulated_frames=jnp.float32(6.2))
    ts = reblur.ReblurSettings(max_accumulated_frames=torch.tensor(31.0),
                               max_fast_accumulated_frames=torch.tensor(6.2))
    return js, ts


@pytest.mark.parametrize("is_spec", [False, True])
def test_reblur_steps_over_three_frames(is_spec):
    """accumulate, history_fix (inside it), adaptive_blur and stabilize, each
    compared on the same inputs, with the history threaded as the frame
    threads it."""
    js, ts = _reblur_settings()
    jh = jreblur.ReblurHistory.create(H, W)
    th = convert.history_from_numpy({"frame_index": np.int32(0), "reblur_diff": _np_leaves(jh)},
                                    device="cpu").reblur_diff
    unproj = np.float32(0.0364)
    # the JAX steps jitted once each (eager JAX compiles every primitive)
    j_acc = jax.jit(lambda h, i, hd, z, n, mv, reset: jreblur.accumulate(
        h, jcommon.anti_firefly(i), hd, z, n, mv, js, reset=reset))
    j_blur = jax.jit(lambda acc, hd, z, n, r, f, fi: jreblur.adaptive_blur(
        acc, hd, z, n, r, f, fi, js, is_spec, jnp.float32(unproj)))
    j_stab = jax.jit(lambda b, fast, f: jreblur.stabilize(b, fast, f, js))
    for frame in range(3):
        p = _planes(20 + frame)
        j = {k: jnp.asarray(v) for k, v in p.items()}
        t = {k: torch.from_numpy(v) for k, v in p.items()}
        jacc = j_acc(jh, j["illum"], j["hitdist"], j["view_z"], j["normal"], j["mv"],
                     jnp.bool_(frame == 1))
        tacc = reblur.accumulate(th, common.anti_firefly(t["illum"]), t["hitdist"], t["view_z"],
                                 t["normal"], t["mv"], ts, reset=frame == 1)
        for g, w in zip(tacc, jacc):
            _close(g, w)
        acc, fast, hd, frames = (torch.from_numpy(np.array(a)) for a in jacc)
        jb = j_blur(jacc[0], jacc[2], j["view_z"], j["normal"], j["roughness"], jacc[3],
                    jnp.int32(frame))
        tb = reblur.adaptive_blur(acc, hd, t["view_z"], t["normal"], t["roughness"], frames,
                                  torch.tensor(frame), ts, is_spec, torch.tensor(unproj))
        for g, w in zip(tb, jb):
            _close(g, w)
        blurred = torch.from_numpy(np.array(jb[0]))
        jst = j_stab(jb[0], jacc[1], jacc[3])
        tst = reblur.stabilize(blurred, fast, frames, ts)
        for g, w in zip(tst, jst):
            _close(g, w)
        jh = jreblur.ReblurHistory(illum=jst[0], fast_illum=jacc[1], hitdist=jb[1],
                                   view_z=j["view_z"], normal=j["normal"], frames=jst[1])
        th = reblur.ReblurHistory(**{k: torch.from_numpy(np.array(v))
                                     for k, v in _np_leaves(jh).items()})
    assert float(frames.max()) > 1.0


def test_history_fix_matches_jax():
    js, ts = _reblur_settings()
    p = _planes(30)
    frames = np.random.RandomState(31).uniform(0.0, 5.0, (H, W)).astype(np.float32)
    fast = np.random.RandomState(32).uniform(0.0, 1.0, (H, W, 3)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (p["illum"], fast, p["view_z"], p["normal"], frames)]
    targs = [torch.from_numpy(a) for a in (p["illum"], fast, p["view_z"], p["normal"], frames)]
    want = jax.jit(lambda *a: jreblur.history_fix(*a, js))(*jargs)
    for g, w in zip(reblur.history_fix(*targs, ts), want):
        _close(g, w)


def test_specular_virtual_mv_matches_jax():
    jc = jlook_at([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], fov_y_deg=50.0)
    prev = np.array(jc.view_to_world)
    prev[:3, 3] += np.float32([0.05, -0.02, 0.01])
    jc = dataclasses.replace(jc, view_to_world_prev=jnp.asarray(prev))
    tc = convert.camera_from_numpy(_np_leaves(jc), device="cpu")
    p = _planes(40)
    rs = np.random.RandomState(41)
    x = rs.uniform([-3, -3, 0], [3, 3, 2], (H, W, 3)).astype(np.float32)
    eye = np.asarray(jc.view_to_world)[:3, 3]
    vdir = (x - eye) / np.linalg.norm(x - eye, axis=-1, keepdims=True)
    miss = rs.uniform(size=(H, W)) < 0.1
    jargs = [jnp.asarray(a) for a in (x, vdir.astype(np.float32), p["hitdist"], p["roughness"], p["mv"])]
    targs = [torch.from_numpy(np.array(a)) for a in (x, vdir.astype(np.float32), p["hitdist"],
                                                      p["roughness"], p["mv"])]
    want = jreblur.specular_virtual_mv(jc, *jargs, W, H, miss=jnp.asarray(miss))
    got = reblur.specular_virtual_mv(tc, *targs, W, H, miss=torch.from_numpy(miss))
    _close(got, want)


def test_gather_wrapper_refuses_cpu_tensors():
    img = torch.zeros(4, 4, 3)
    pos = torch.zeros(4, 4, 2)
    with pytest.raises(ValueError):
        reproject.sample_bilinear_cuda(img, pos)
    before = reproject.LAUNCHES
    assert torch.equal(reproject.sample_bilinear_auto(img, pos), filtering.sample_bilinear(img, pos))
    assert reproject.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [None, 3, 9])
def test_bilinear_kernel_matches_plain_on_card(cuda_device, channels):
    g = torch.Generator(device="cpu").manual_seed(channels or 1)
    shape = (512, 512) if channels is None else (512, 512, channels)
    img = torch.randn(shape, generator=g).to(cuda_device)
    # a leading batch of whole 128-position runs (the bicubic's tap axis) and
    # one of 3,003 positions, whose last run is ragged
    for lead in ((4, 512, 512), (3, 1001)):
        for disp in (3.0, 20.0, 600.0):
            pos = (torch.rand(*lead, 2, generator=g) * 512
                   + (torch.rand(*lead, 2, generator=g) - 0.5) * 2 * disp).to(cuda_device)
            got = reproject.sample_bilinear_cuda(img, pos)
            want = filtering.sample_bilinear(img, pos)
            assert torch.equal(got, want), (lead, disp)

