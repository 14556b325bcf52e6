"""The port's kitchen frame against the JAX package's: bench.py:78-85's
kitchen (156 triangles, dense traversal) at 64x40, FULL_PROBABILISTIC, one
bounce, sun 35 degrees, RELAX for both signals with SIGMA for the shadow, the
SH resolve, TAA, the SHARC radiance cache (capacity 1 << 16 in both
packages) and the history-confidence plane, over 3 frames. The scene,
camera and settings go to the port through ``convert``.

The tolerance is the frame tolerance of PERF.md §2: per plane at most 0.5% of
pixels off by more than 1e-3 * (1 + |ref|), and image means within 1e-3
relative. The RELAX, SIGMA, TAA and confidence histories are held to the
same tolerance; the SHARC keys must be equal in 99.5% of the slots (a
position on a voxel or LOD boundary may land in the neighbouring cell when
the two packages round its last ULP differently)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import Denoiser as JDenoiser, NrdMode as JNrdMode
from nrdsample_tpu.config import RenderConfig as JRenderConfig, Settings as JSettings
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.denoise import atrous_cuda, taa_cuda, taccum_cuda
from nrdsample_tpu_torch.ops import dense_cuda, reproject
from nrdsample_tpu_torch.pipeline import bench_configs, frame
from torch_session_cache import session_cached, share_cores_between_workers

share_cores_between_workers()

OUTLIER_FRAC = 0.005
MEAN_REL = 1e-3
W, H = 64, 40
FRAMES = 3
CAPACITY = 1 << 16
PLANES = ["color", "final", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal"]
COUNTERS = (dense_cuda, reproject, taccum_cuda, atrous_cuda, taa_cuda)


def _np_leaves(obj):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _np_leaves(v)
        elif v is None or isinstance(v, bool):
            out[f.name] = v
        else:
            out[f.name] = np.asarray(v)
    return out


def _outlier_frac(ref, got):
    ref = np.asarray(ref, np.float64).reshape(ref.shape[0], -1)
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    return (np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))).any(-1).mean()


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_frame_kitchen", _frames)


def _frames():
    """([(JAX outputs, port outputs)] per frame, JAX history, port history,
    kernel launches during the port's run)."""
    spec = bench_configs.CONFIGS["kitchen1080"]
    jscene0 = jproc.kitchen()
    jctx, jscene = jtraversal.build_context(jscene0)
    eye, target, fov = spec["cam"]
    jc = jlook_at(eye, target, fov_y_deg=fov, aspect=W / H)
    js = JSettings(sun_elevation=jnp.float32(35.0))
    jcfg = JRenderConfig(width=W, height=H, rpp=1, bounce_num=1, denoiser=JDenoiser.RELAX,
                         nrd_mode=JNrdMode.SH, use_taa=True, use_sharc=True,
                         use_confidence=True, sharc_capacity=CAPACITY)
    fn = jax.jit(lambda sc, c, st, h: jframe.render_frame(jctx, sc, c, jcfg, st, h))

    ctx, scene, _, cfg, _ = bench_configs.setup("kitchen1080", "cpu", width=W, height=H,
                                                 sharc_capacity=CAPACITY)
    cam = convert.camera_from_numpy(_np_leaves(jc), device="cpu")
    settings = convert.settings_from_numpy(_np_leaves(js), device="cpu")
    jh, h = jframe.History.create(jcfg), frame.History.create(cfg, "cpu")
    before = [m.LAUNCHES for m in COUNTERS]
    pairs = []
    for _ in range(FRAMES):
        jout, jh = fn(jscene, jc, js, jh)
        out, h = frame.render_frame(ctx, scene, cam, cfg, settings, h)
        pairs.append(({k: np.asarray(jout[k]) for k in PLANES}, out))
    launched = [m.LAUNCHES - b for m, b in zip(COUNTERS, before)]
    return pairs, jh, h, launched


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", PLANES)
def test_kitchen_frame_matches_jax(frames, index, plane):
    want, got = frames[0][index]
    g = got[plane]
    assert g.dtype == torch.float32 and tuple(g.shape) == want[plane].shape
    assert bool(torch.isfinite(g).all())
    assert _outlier_frac(want[plane], g.numpy()) <= OUTLIER_FRAC


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", ["color", "final"])
def test_kitchen_frame_mean_matches_jax(frames, index, plane):
    want, got = frames[0][index]
    w, g = float(want[plane].mean()), float(got[plane].mean())
    assert abs(g - w) <= MEAN_REL * abs(w) and g > 0.0


@pytest.mark.parametrize("slot", ["relax_diff", "relax_spec", "sigma", "taa", "confidence"])
def test_kitchen_history_matches_jax(frames, slot):
    _, jh, h, _ = frames
    assert int(h.frame_index) == int(jh.frame_index) == FRAMES
    want = _np_leaves(getattr(jh, slot))
    got = getattr(h, slot)
    for leaf, w in want.items():
        g = getattr(got, leaf)
        assert tuple(g.shape) == w.shape, leaf
        if w.ndim == 0:
            assert int(g) == int(w), leaf
            continue
        assert g.dtype == torch.float32, leaf
        assert _outlier_frac(w, g.numpy()) <= OUTLIER_FRAC, leaf
    if slot.startswith("relax"):
        assert float(got.frames.max()) == float(FRAMES)


def test_kitchen_sharc_matches_jax(frames):
    _, jh, h, _ = frames
    want = np.asarray(jh.sharc.keys).astype(np.int64)
    got = h.sharc.keys.numpy()
    assert got.dtype == np.int64 and got.shape == (CAPACITY,)
    assert (want != 0).sum() > 0 and (got != 0).sum() > 0
    assert (got != want).mean() <= 0.005
    same = (got == want) & (want != 0)
    for leaf in ("resolved", "last_seen"):
        w = np.asarray(getattr(jh.sharc, leaf))[same]
        g = getattr(h.sharc, leaf).numpy()[same]
        assert _outlier_frac(w, g) <= OUTLIER_FRAC, leaf


def test_cpu_kitchen_frame_launches_no_kernel(frames):
    """On CPU tensors every kernel's plain version runs."""
    assert frames[3] == [0] * len(COUNTERS)
