"""The port's REBLUR frame against the JAX package's: the shader balls at
grid 2 (1,762 triangles, so cluster-mode traversal), 32x32, two bounces,
FULL_PROBABILISTIC, sun 45 degrees with shadows, REBLUR with SIGMA, over 3
frames. The scene, camera and settings go to the port through ``convert``.

The tolerance is the frame tolerance of tests/test_torch_frame.py: per plane
at most 0.5% of pixels off by more than 1e-3 * (1 + |ref|), and image means
within 1e-3 relative. The histories of REBLUR's two signals and of SIGMA are
held to the same tolerance."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import Denoiser as JDenoiser, RenderConfig as JRenderConfig
from nrdsample_tpu.config import Settings as JSettings
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.config import Denoiser, RenderConfig
from nrdsample_tpu_torch.ops import packet, reproject, traversal
from nrdsample_tpu_torch.pipeline import frame
from torch_session_cache import declare, session_cached, share_cores_between_workers

share_cores_between_workers()

# one worker runs the whole file under --dist loadgroup (pytest.ini's
# default); under --dist load the frame fixture is shared through
# torch_session_cache instead
pytestmark = pytest.mark.xdist_group("torch_frame_reblur")

OUTLIER_FRAC = 0.005
MEAN_REL = 1e-3
RES = 32
FRAMES = 3
PLANES = ["color", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal"]


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
    ref = np.asarray(ref, np.float64).reshape(RES * RES, -1)
    got = np.asarray(got, np.float64).reshape(RES * RES, -1)
    return (np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))).any(-1).mean()


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_frame_reblur", _frames)


declare("torch_frame_reblur", lambda _: _frames())


def _frames():
    """([(JAX outputs, port outputs)] per frame, JAX history, port history,
    port kernel launches during the run)."""
    jscene0 = jproc.shader_balls(grid=2, sphere_res=12)
    jctx, jscene = jtraversal.build_context(jscene0)
    jc = jlook_at([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], fov_y_deg=50.0)
    js = JSettings(sun_elevation=jnp.float32(45.0))
    jcfg = JRenderConfig(width=RES, height=RES, rpp=1, bounce_num=2, denoiser=JDenoiser.REBLUR)
    fn = jax.jit(lambda sc, c, st, h: jframe.render_frame(jctx, sc, c, jcfg, st, h))
    ctx, scene = traversal.build_context(convert.scene_from_numpy(_np_leaves(jscene0), device="cpu"),
                                         device="cpu")
    cam = convert.camera_from_numpy(_np_leaves(jc), device="cpu")
    settings = convert.settings_from_numpy(_np_leaves(js), device="cpu")
    cfg = RenderConfig(width=RES, height=RES, rpp=1, bounce_num=2, denoiser=Denoiser.REBLUR)
    jh, h = jframe.History.create(jcfg), frame.History.create(cfg, "cpu")
    before = (packet.LAUNCHES, reproject.LAUNCHES)
    pairs = []
    for _ in range(FRAMES):
        jout, jh = fn(jscene, jc, js, jh)
        out, h = frame.render_frame(ctx, scene, cam, cfg, settings, h)
        pairs.append(({k: np.asarray(jout[k]) for k in PLANES}, out))
    launched = (packet.LAUNCHES - before[0], reproject.LAUNCHES - before[1])
    return pairs, jh, h, launched


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", PLANES)
def test_reblur_frame_matches_jax(frames, index, plane):
    want, got = frames[0][index]
    g = got[plane]
    assert g.dtype == torch.float32 and tuple(g.shape) == want[plane].shape
    assert bool(torch.isfinite(g).all())
    assert _outlier_frac(want[plane], g.numpy()) <= OUTLIER_FRAC


@pytest.mark.parametrize("index", range(FRAMES))
def test_reblur_frame_mean_matches_jax(frames, index):
    want, got = frames[0][index]
    w, g = float(want["color"].mean()), float(got["color"].mean())
    assert abs(g - w) <= MEAN_REL * abs(w) and g > 0.0


@pytest.mark.parametrize("slot", ["reblur_diff", "reblur_spec", "sigma"])
def test_reblur_history_matches_jax(frames, slot):
    _, jh, h, _ = frames
    assert int(h.frame_index) == int(jh.frame_index) == FRAMES
    want = _np_leaves(getattr(jh, slot))
    got = getattr(h, slot)
    for leaf, w in want.items():
        g = getattr(got, leaf)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, leaf
        assert _outlier_frac(w, g.numpy()) <= OUTLIER_FRAC, leaf
    if slot != "sigma":
        assert float(got.frames.max()) > 1.0


def test_cpu_frame_launches_no_kernel(frames):
    """On CPU tensors every query takes the plain versions."""
    assert frames[3] == (0, 0)
