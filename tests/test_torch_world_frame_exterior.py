"""The port's exterior frame against the JAX package's: bench.py:86-96's
exterior720 configuration on the small exterior (3,196 opaque triangles in 25
clusters, 1,488 glass triangles in 12, 674 emitters) at 64x40,
FULL_PROBABILISTIC, one bounce, sun 30 degrees, RELAX for both signals with
SIGMA, TAA and the SHARC radiance cache with its FULL through-glass pass
(capacity 1 << 16 in both packages), traced through ``build_scene_contexts``:
the sun-shadow translucency march, the glass delta chains and the glass
overlay, over 3 frames. The scene is built by each package's own builder (the
two are equal leaf for leaf, tests/test_torch_world_exterior_scene.py); camera and
settings go to the port through ``convert``.

The tolerance is the frame tolerance of PERF.md §2: per plane at most 0.5% of
pixels off by more than 1e-3 * (1 + |ref|), and image means within 1e-3
relative; the glass mask must be equal. The RELAX, SIGMA and TAA histories
are held to the same tolerance; the SHARC keys must be equal in 99.5% of the
slots.

The slice-4 test files are named ``test_torch_world_*`` so that they sort
after the other port files: the suite runs files in name order, and its
time limit then cuts these, the most costly, first."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import Denoiser as JDenoiser
from nrdsample_tpu.config import RenderConfig as JRenderConfig, Settings as JSettings
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.denoise import atrous_cuda, taa_cuda, taccum_cuda
from nrdsample_tpu_torch.ops import dense_cuda, emissive_probe, packet, reproject
from nrdsample_tpu_torch.pipeline import bench_configs, frame
from torch_session_cache import (declare, jax_native_order_ready, session_cached,
                                 share_cores_between_workers)

share_cores_between_workers()

OUTLIER_FRAC = 0.005
MEAN_REL = 1e-3
W, H = 64, 40
FRAMES = 3
CAPACITY = 1 << 16
SMALL = dict(cobbles=8, tree_count=6, tree_res=8, lamp_count=4)
PLANES = ["color", "final", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal"]
COUNTERS = (dense_cuda, emissive_probe, packet, reproject, taccum_cuda, atrous_cuda, taa_cuda)


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
    jax_native_order_ready(tmp_path_factory)
    return session_cached(tmp_path_factory, "torch_frame_exterior", _frames)


declare("torch_frame_exterior", lambda _: _frames(), native_order=True)


def _frames():
    """([(JAX outputs, port outputs)] per frame, JAX history, port history,
    kernel launches during the port's run)."""
    spec = bench_configs.CONFIGS["exterior720"]
    jctxs, jscene = jtraversal.build_scene_contexts(jproc.exterior(**SMALL))
    eye, target, fov = spec["cam"]
    jc = jlook_at(eye, target, fov_y_deg=fov, aspect=W / H)
    js = JSettings(sun_elevation=jnp.float32(30.0))
    jcfg = JRenderConfig(width=W, height=H, rpp=1, bounce_num=1, denoiser=JDenoiser.RELAX,
                         use_sharc=True, use_taa=True, sharc_capacity=CAPACITY)
    fn = jax.jit(lambda sc, c, st, h: jframe.render_frame(jctxs, sc, c, jcfg, st, h))

    ctxs, scene, _, cfg, _ = bench_configs.setup("exterior720", "cpu", scene_kw=SMALL, width=W,
                                                  height=H, sharc_capacity=CAPACITY)
    cam = convert.camera_from_numpy(_np_leaves(jc), device="cpu")
    settings = convert.settings_from_numpy(_np_leaves(js), device="cpu")
    jh, h = jframe.History.create(jcfg), frame.History.create(cfg, "cpu")
    before = [m.LAUNCHES for m in COUNTERS] + [packet.STREAM_LAUNCHES]
    pairs = []
    for _ in range(FRAMES):
        jout, jh = fn(jscene, jc, js, jh)
        out, h = frame.render_frame(ctxs, scene, cam, cfg, settings, h)
        pairs.append(({k: np.asarray(jout[k]) for k in PLANES + ["glass_mask"]}, out))
    after = [m.LAUNCHES for m in COUNTERS] + [packet.STREAM_LAUNCHES]
    return pairs, jh, h, [a - b for a, b in zip(after, before)]


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", PLANES)
def test_exterior_frame_matches_jax(frames, index, plane):
    want, got = frames[0][index]
    g = got[plane]
    assert g.dtype == torch.float32 and tuple(g.shape) == want[plane].shape
    assert bool(torch.isfinite(g).all())
    assert _outlier_frac(want[plane], g.numpy()) <= OUTLIER_FRAC


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", ["color", "final"])
def test_exterior_frame_mean_matches_jax(frames, index, plane):
    want, got = frames[0][index]
    w, g = float(want[plane].mean()), float(got[plane].mean())
    assert abs(g - w) <= MEAN_REL * abs(w) and g > 0.0


@pytest.mark.parametrize("index", range(FRAMES))
def test_exterior_glass_mask_matches_jax(frames, index):
    want, got = frames[0][index]
    g = got["glass_mask"]
    assert g.dtype == torch.bool and int(g.sum()) > 0
    np.testing.assert_array_equal(g.numpy(), want["glass_mask"])


@pytest.mark.parametrize("slot", ["relax_diff", "relax_spec", "sigma", "taa"])
def test_exterior_history_matches_jax(frames, slot):
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


def test_exterior_sharc_matches_jax(frames):
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


def test_cpu_exterior_frame_launches_no_kernel(frames):
    """On CPU tensors every kernel's plain version runs, the streaming
    packet kernel's included."""
    assert frames[3] == [0] * (len(COUNTERS) + 1)
