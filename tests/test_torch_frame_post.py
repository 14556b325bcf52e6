"""Whole frames of the output end of the frame, the port against a JAX jit
of the JAX package's frame, at 32x32 on the Cornell box over two frames:

- ``relax_post``: RELAX + SIGMA, TAA and SHARC, then the post chain to
  48x48 (the learned SR network, NIS, the split screen at 0.5), the
  validation overlay and the TAA-weight debug view;
- ``neural``: the learned recurrent denoiser of the RR slot.

The tolerance is the frame tolerance of PERF.md §2, per pixel of each plane
(``color``, ``final``, ``display``, ``debug``): at most 0.5% of the pixels
off by more than 1e-3 * (1 + |ref|), and the image means within 1e-3
relative. ``relax_post``'s second frame also feeds the debug-view parity
tests (tests/test_torch_debug_views.py) with its G-buffer and SHARC cache.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu import config as jconfig
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe
from nrdsample_tpu.post import neural_sr as jneural_sr
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import config, convert
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import frame
from torch_session_cache import session_cached, share_cores_between_workers

share_cores_between_workers()

OUTLIER_FRAC = 0.005
MEAN_REL = 1e-3
RES = 32
OUT_RES = 48
FRAMES = 2
PLANES = ("color", "final", "display", "debug")
#: RenderConfig fields of each case, by the names of both packages' enums
CASES = {
    "relax_post": dict(denoiser="RELAX", use_taa=True, use_sharc=True, sharc_capacity=1 << 12,
                       enable_post=True, output_width=OUT_RES, output_height=OUT_RES,
                       use_neural_sr=True, use_nis=True, use_validation_overlay=True,
                       on_screen="TAA_WEIGHT"),
    "neural": dict(denoiser="NEURAL"),
}
SETTINGS = dict(sun_elevation=-30.0, disable_shadows=1, separator=0.5)


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


def _cfg_kw(module, case):
    kw = dict(CASES[case])
    kw["denoiser"] = module.Denoiser[kw["denoiser"]]
    if "on_screen" in kw:
        kw["on_screen"] = module.OnScreen[kw["on_screen"]]
    return dict(width=RES, height=RES, **kw)


def _frames(case):
    """[(JAX planes, port planes)] per frame, plus what the debug-view tests
    read: the JAX frame's G-buffer, composed colour and SHARC cache, and the
    camera position; and the port's RR history flag."""
    jctx, jscene = jtraversal.build_context(jproc.cornell_box())
    jc = jlook_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0)
    js = jconfig.Settings(**{k: jnp.asarray(v, jnp.int32 if isinstance(v, int) else jnp.float32)
                             for k, v in SETTINGS.items()})
    jcfg = jconfig.RenderConfig(**_cfg_kw(jconfig, case))
    # the JAX package caches its SR weights at the first call (lru_cache): a
    # first call inside the trace below would cache tracers, which leak into
    # every later test of this process that loads them
    jneural_sr.load_weights()
    fn = jax.jit(lambda sc, c, st, h: jframe.render_frame(jctx, sc, c, jcfg, st, h))
    ctx, scene = traversal.build_context(convert.scene_from_numpy(_np_leaves(jscene), device="cpu"),
                                         device="cpu")
    cam = convert.camera_from_numpy(_np_leaves(jc), device="cpu")
    settings = convert.settings_from_numpy(_np_leaves(js), device="cpu")
    cfg = config.RenderConfig(**_cfg_kw(config, case))
    jh, h = jframe.History.create(jcfg), frame.History.create(cfg, "cpu")
    pairs = []
    for _ in range(FRAMES):
        jout, jh = fn(jscene, jc, js, jh)
        out, h = frame.render_frame(ctx, scene, cam, cfg, settings, h)
        pairs.append(({k: None if jout[k] is None else np.asarray(jout[k]) for k in PLANES},
                      {k: out[k] for k in PLANES}))
    extra = {
        "gbuffer": {k: np.asarray(v) for k, v in jout["gbuffer"].items() if v is not None},
        "composed": np.asarray(jout["color"]),
        "sharc": None if jh.sharc is None else _np_leaves(jh.sharc),
        "cam_pos": np.asarray(jc.position),
        "rr_valid": None if h.neural_rr is None else int(h.neural_rr.valid),
        "jax_rr_valid": None if jh.neural_rr is None else int(jh.neural_rr.valid),
    }
    return pairs, extra


def cached_frames(tmp_path_factory, case):
    """The session-cached ``_frames(case)``; a worker that finds it being
    computed computes the other case meanwhile."""
    computes = {f"torch_frame_post_{c}": (lambda c=c: _frames(c)) for c in CASES}
    name = f"torch_frame_post_{case}"
    return session_cached(tmp_path_factory, name, computes[name], others=computes)


@pytest.fixture(scope="module", params=sorted(CASES))
def post_frames(request, tmp_path_factory):
    return request.param, cached_frames(tmp_path_factory, request.param)


def _pixels(a):
    a = np.asarray(a, np.float64)
    return a.reshape(-1, a.shape[-1])


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", PLANES)
def test_post_frame_matches_jax(post_frames, index, plane):
    case, (pairs, _) = post_frames
    want, got = pairs[index]
    if want[plane] is None:
        assert got[plane] is None
        return
    g = got[plane]
    assert g.dtype == torch.float32 and tuple(g.shape) == want[plane].shape
    assert bool(torch.isfinite(g).all())
    ref, val = _pixels(want[plane]), _pixels(g.numpy())
    bad = (np.abs(ref - val) > 1e-3 * (1.0 + np.abs(ref))).any(-1).mean()
    assert bad <= OUTLIER_FRAC
    w, m = float(ref.mean()), float(val.mean())
    assert abs(m - w) <= MEAN_REL * abs(w) and m > 0.0


def test_post_frame_outputs(post_frames):
    """Which outputs each case has, their shapes and ranges, and the RR
    history."""
    case, (pairs, extra) = post_frames
    got = pairs[-1][1]
    if case == "relax_post":
        assert tuple(got["display"].shape) == (OUT_RES, OUT_RES, 3)
        assert 0.0 <= float(got["display"].min()) and float(got["display"].max()) <= 1.0
        assert tuple(got["debug"].shape) == (RES * RES, 3)
        # the TAA weight of a valid history lies in [0.1, 1]
        assert 0.1 - 1e-6 <= float(got["debug"].min()) and float(got["debug"].max()) <= 1.0
        assert extra["rr_valid"] is None
    else:
        assert got["display"] is None and got["debug"] is None
        assert torch.equal(got["final"], got["color"])
        assert extra["rr_valid"] == extra["jax_rr_valid"] == 1
