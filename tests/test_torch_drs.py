"""Dynamic resolution scaling (``pipeline/drs.py``) and adaptive accumulation
(``pipeline/adaptive.py``) of the port against the JAX package's.

The cases of tests/test_drs.py hold for the port, and: the controller's
decisions equal JAX's frame by frame on scripted frame times; ``render_size``
and ``bucket_cfg`` are equal; the resampling weights equal
``jax.image.resize``'s within 1e-6 (downscale and upscale, "linear" with its
antialiasing, "nearest"), and ``resize_history`` resamples every leaf of a
RELAX + SIGMA + TAA + SHARC + confidence history (and a REFERENCE one, whose
leaves are flat) as JAX's does, within 1e-6, to the leaves' shapes of a
fresh history of the new size; the adaptive caps are equal."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu import config as jconfig
from nrdsample_tpu.pipeline import adaptive as jadaptive, drs as jdrs, frame as jframe
from nrdsample_tpu_torch import config, convert
from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import adaptive, drs, frame
from nrdsample_tpu_torch.scene import procedural
from nrdsample_tpu_torch.scene.types import look_at
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

RESIZE_TOL = 1e-6
SLOTS = ("reference", "relax_diff", "relax_spec", "reblur_diff", "reblur_spec", "sigma", "taa",
         "sharc", "confidence", "l1", "neural_rr")


# ---- tests/test_drs.py, through the port ----


def test_controller_steps_down_when_over_budget():
    c = drs.DrsController(target_ms=10.0)
    assert c.scale == 1.0
    for _ in range(12):
        c.update(25.0)
    assert c.scale < 1.0


def test_controller_steps_back_up_with_headroom():
    c = drs.DrsController(target_ms=10.0)
    c.index = 3
    for _ in range(12):
        c.update(2.0)
    assert c.scale > drs.BUCKETS[3]


def test_controller_holds_at_target():
    c = drs.DrsController(target_ms=10.0)
    c.index = 1
    for _ in range(20):
        c.update(9.5)
    assert c.index == 1


def test_render_size_alignment():
    w, h = drs.render_size(1920, 1080, 0.75)
    assert w % 8 == 0 and h % 8 == 0
    assert abs(w - 1440) <= 8 and abs(h - 810) <= 8


@pytest.mark.parametrize("target,start", [(10.0, 0), (16.7, 2), (33.3, 4), (5.0, 1)])
def test_controller_decisions_equal_jax(target, start):
    rs = np.random.RandomState(int(target * 10) + start)
    times = np.concatenate([rs.uniform(2.0, 40.0, 40), np.full(10, 60.0), np.full(15, 1.0),
                            target * rs.uniform(0.8, 1.2, 20)])
    got, want = drs.DrsController(target), jdrs.DrsController(target, start_index=start)
    got.index = start
    for ms in times:
        assert got.update(float(ms)) == want.update(float(ms))
        assert (got.index, got.ema_ms, got._cooldown) == (want.index, want.ema_ms, want._cooldown)


def test_render_size_and_bucket_cfg_equal_jax():
    for w, h in ((1920, 1080), (2560, 1440), (48, 32), (17, 9)):
        for s in drs.BUCKETS:
            assert drs.render_size(w, h, s) == jdrs.render_size(w, h, s)
    for kw in (dict(width=1920, height=1080), dict(width=64, height=48, output_width=96,
                                                   output_height=72)):
        for s in drs.BUCKETS:
            got = drs.bucket_cfg(RenderConfig(**kw), s)
            want = jdrs.bucket_cfg(jconfig.RenderConfig(**kw), s)
            for f in ("width", "height", "output_width", "output_height", "enable_post"):
                assert getattr(got, f) == getattr(want, f), (kw, s, f)


@pytest.mark.parametrize("m,n", [(48, 24), (40, 35), (35, 40), (24, 48), (1080, 544), (7, 3),
                                 (3, 7), (1, 4)])
def test_resize_weights_equal_jax(m, n):
    """The weights along one axis: resizing the identity gives them."""
    from jax._src.image import scale as jscale

    want = np.asarray(jscale.compute_weight_mat(m, n, n / m, 0.0, jscale._fill_triangle_kernel,
                                                True))
    got = drs.linear_weights(m, n)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RESIZE_TOL, atol=RESIZE_TOL)
    # floating leaves resize linearly, integer ones by the nearest sample
    for method, dtype in (("linear", np.float32), ("nearest", np.int32)):
        eye = np.eye(m, dtype=dtype)
        want_img = np.asarray(jax.image.resize(jnp.asarray(eye), (m, n), method=method))
        got_img = drs._resize_plane(torch.from_numpy(eye).T.contiguous(), (n, m)).T
        np.testing.assert_allclose(got_img.numpy(), want_img, rtol=RESIZE_TOL, atol=RESIZE_TOL)
    np.testing.assert_array_equal(
        drs.nearest_indices(m, n).numpy(),
        np.asarray(jax.image.resize(jnp.arange(m, dtype=jnp.int32), (n,), method="nearest")))


def _random_history(cfg):
    """The JAX package's History of cfg with every leaf filled from a seed
    (integers and booleans too), as numpy leaves for ``convert``."""
    rs = np.random.RandomState(cfg.width * 7 + cfg.height)
    h = jframe.History.create(cfg)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return rs.rand(*a.shape) > 0.5
        if np.issubdtype(a.dtype, np.integer):
            return rs.randint(0, 50, a.shape).astype(a.dtype)
        return rs.uniform(-2.0, 3.0, a.shape).astype(a.dtype)

    h = jax.tree_util.tree_map(fill, h)
    leaves = {k: None if getattr(h, k) is None else {
        f.name: np.asarray(getattr(getattr(h, k), f.name))
        for f in dataclasses.fields(getattr(h, k))} for k in SLOTS}
    leaves["frame_index"] = np.asarray(h.frame_index)
    return h, leaves


def _configs(jax_side: bool, w, h):
    mod = jconfig if jax_side else config
    relax = mod.RenderConfig(width=w, height=h, denoiser=mod.Denoiser.RELAX, use_taa=True,
                             use_sharc=True, use_confidence=True, sharc_capacity=64,
                             use_l1_cache=True)
    reference = mod.RenderConfig(width=w, height=h, denoiser=mod.Denoiser.REFERENCE)
    return {"relax": relax, "reference": reference}


@pytest.mark.parametrize("kind", ["relax", "reference"])
@pytest.mark.parametrize("sizes", [((48, 40), (24, 24)), ((24, 24), (48, 40)), ((40, 32), (40, 16))],
                         ids=["down", "up", "one-axis"])
def test_resize_history_equals_jax(kind, sizes):
    (ow, oh), (nw, nh) = sizes
    jold, jnew = _configs(True, ow, oh)[kind], _configs(True, nw, nh)[kind]
    old, new = _configs(False, ow, oh)[kind], _configs(False, nw, nh)[kind]
    jh, leaves = _random_history(jold)
    want = jdrs.resize_history(jh, jold, jnew)
    got = drs.resize_history(convert.history_from_numpy(leaves, device="cpu"), old, new)
    fresh = frame.History.create(new, "cpu")
    n_resized = 0
    for k in SLOTS + ("frame_index",):
        if getattr(want, k) is None:
            assert getattr(got, k) is None
            continue
        if k == "frame_index":
            assert int(got.frame_index) == int(want.frame_index)
            continue
        for f in dataclasses.fields(getattr(want, k)):
            w_leaf = np.asarray(getattr(getattr(want, k), f.name))
            g_leaf = getattr(getattr(got, k), f.name)
            assert tuple(g_leaf.shape) == w_leaf.shape == tuple(
                getattr(getattr(fresh, k), f.name).shape), (k, f.name)
            g = g_leaf.numpy()
            if k == "sharc" and f.name == "keys":
                w_leaf = w_leaf.astype(np.int64)
            else:
                assert g.dtype == w_leaf.dtype, (k, f.name)
            np.testing.assert_allclose(g, w_leaf, rtol=RESIZE_TOL, atol=RESIZE_TOL,
                                       err_msg=f"{k}.{f.name}")
            n_resized += g_leaf.shape != np.asarray(getattr(getattr(jh, k), f.name)).shape
    assert n_resized >= (8 if kind == "relax" else 1)


def test_two_bucket_frames_with_history_resize():
    """tests/test_drs.py's two-bucket run through the port: two frames at
    the full bucket, a switch to half with the history resampled (its tree
    and leaf shapes those of a fresh history), two more frames; the display
    stays at the pinned 32x32, finite, and the frame counter counts all
    four."""
    ctx, scene = traversal.build_context(procedural.cornell_box(), device="cpu")
    cam = look_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0, device="cpu")
    settings = config.Settings()
    base = RenderConfig(width=32, height=32, rpp=1, bounce_num=1,
                        tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.RELAX,
                        use_taa=True)
    cfg_a, cfg_b = drs.bucket_cfg(base, 1.0), drs.bucket_cfg(base, 0.5)
    assert (cfg_b.width, cfg_b.height) == (16, 16)
    assert (cfg_b.output_width, cfg_b.output_height) == (32, 32)
    hist = frame.History.create(cfg_a, "cpu")
    out = None
    for i, cfg in enumerate((cfg_a, cfg_a, cfg_b, cfg_b)):
        if i == 2:
            hist = drs.resize_history(hist, cfg_a, cfg_b)
            ref = frame.History.create(cfg_b, "cpu")
            for k in SLOTS:
                assert (getattr(hist, k) is None) == (getattr(ref, k) is None)
                if getattr(ref, k) is not None:
                    for f in dataclasses.fields(getattr(ref, k)):
                        assert (getattr(getattr(hist, k), f.name).shape
                                == getattr(getattr(ref, k), f.name).shape)
        out, hist = frame.render_frame(ctx, scene, cam, cfg, settings, hist)
    assert out["display"].shape == (32, 32, 3)
    assert bool(torch.isfinite(out["display"]).all())
    assert int(hist.frame_index) == 4


# ---- pipeline/adaptive.py ----


def test_adaptive_caps_equal_jax():
    for ms in (0.5, 4.0, 8.26, 16.7, 33.3, 100.0, 1000.0):
        assert adaptive.max_accumulated_frames(ms) == jadaptive.max_accumulated_frames(ms)
        for now, prev in ((1.0, 1.0), (2.0, 1.0), (0.0, 5.0)):
            assert adaptive.emission_reset_factor(now, prev, ms) == pytest.approx(
                jadaptive.emission_reset_factor(now, prev, ms), rel=1e-12)
    timer, jtimer = adaptive.FrameTimer(), jadaptive.FrameTimer()
    prev = jprev = None
    for i, ms in enumerate((40.0, 12.0, 12.0, 90.0, 5.0, 16.0)):
        emission = 1.0 + (i == 3) * 4.0
        s = config.make_settings("cpu", emission_intensity=emission)
        js = jconfig.Settings(emission_intensity=jnp.float32(emission))
        got = adaptive.update(s, prev, timer.update(ms))
        want = jadaptive.update(js, jprev, jtimer.update(ms))
        assert got.max_accumulated_frame_num.dtype == torch.int32
        assert got.max_accumulated_frame_num.device == s.max_accumulated_frame_num.device
        assert int(got.max_accumulated_frame_num) == int(want.max_accumulated_frame_num)
        prev, jprev = got, want
    assert frame._max_acc(got).dtype == torch.float32
