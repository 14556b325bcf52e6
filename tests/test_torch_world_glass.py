"""The port's glass path against the JAX package's: ``refract`` and the
dielectric Fresnel term, the sun-shadow translucency march through glass
layers, the FULL-mode glass walk of the SHARC probes and the FULL probe
trace, and the glass delta chains of TraceTransparent.

Scenes are built by the JAX package's builders and handed to the port
through ``convert``: the two tinted panes of ``tests/test_shadow_translucency.py``,
the 45-degree mirror pane of ``tests/test_sharc_full.py`` and the glass
Cornell box of ``tests/test_glass_sharc.py``. Elementwise functions agree
within 1e-6 (XLA:CPU may contract a multiply-add into an FMA); traced
quantities are held to the frame tolerance of PERF.md §2 (at most 0.5% of
rays off by more than 1e-3 (1 + |ref|)), masks exactly.

The slice-4 test files are named ``test_torch_world_*`` so that they sort
after the other port files: the suite runs files in name order, and its
time limit then cuts these, the most costly, first."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu import config as jcfgmod
from nrdsample_tpu.config import RenderConfig as JRenderConfig, Settings as JSettings
from nrdsample_tpu.mathlib import geometry as jgeo
from nrdsample_tpu.ops import sharc as jsharc, traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe
from nrdsample_tpu.render import sharc_update as jsharc_update, trace_transparent as jtt
from nrdsample_tpu.scene import camera as jcamera, procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import convert
from nrdsample_tpu_torch.config import RenderConfig
from nrdsample_tpu_torch.mathlib import geometry as geo
from nrdsample_tpu_torch.ops import sharc, traversal
from nrdsample_tpu_torch.pipeline import frame
from nrdsample_tpu_torch.render import sharc_update, trace_transparent as tt
from torch_session_cache import jax_native_order_ready, share_cores_between_workers

share_cores_between_workers()

OUTLIER_FRAC = 0.005


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


def _both(jscene, tmp_path_factory):
    """(JAX SceneContexts, scene), (port SceneContexts, scene) of one scene."""
    jax_native_order_ready(tmp_path_factory)
    port = traversal.build_scene_contexts(convert.scene_from_numpy(_np_leaves(jscene), device="cpu"),
                                          device="cpu")
    return jtraversal.build_scene_contexts(jscene), port


def _outlier_frac(ref, got):
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    got = np.asarray(got, np.float64).reshape(len(ref), -1)
    return (np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))).any(-1).mean()


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_refract_matches_jax():
    rs = np.random.RandomState(0)
    n = _unit(rs, 4000)
    v = _unit(rs, 4000)
    v = np.where((v * n).sum(-1, keepdims=True) > 0, -v, v)   # incident: into the surface
    for eta in (np.float32(1.5), rs.uniform(0.3, 3.0, 4000).astype(np.float32)):
        want = np.asarray(jgeo.refract(jnp.asarray(v), jnp.asarray(n), jnp.asarray(eta)))
        got = geo.refract(torch.from_numpy(v), torch.from_numpy(n), torch.from_numpy(np.asarray(eta)))
        tir = ~np.any(want != 0.0, axis=-1)
        assert tir.sum() > 100
        np.testing.assert_array_equal(got.numpy()[tir], 0.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_fresnel_dielectric_matches_jax():
    rs = np.random.RandomState(1)
    cos_i = rs.uniform(-1.0, 1.0, 5000).astype(np.float32)
    eta = rs.choice(np.float32([1.5, 1.0 / 1.5, 12.0, 1.0 / 12.0]), 5000).astype(np.float32)
    want = np.asarray(jtt._fresnel_dielectric(jnp.asarray(cos_i), jnp.asarray(eta)))
    got = tt._fresnel_dielectric(torch.from_numpy(cos_i), torch.from_numpy(eta)).numpy()
    assert (want == 1.0).sum() > 100 and ((want > 0.0) & (want < 1.0)).sum() > 1000
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _two_pane_scene(tint=(0.5, 0.8, 1.0), pane_size=100.0):
    """White floor at z=0, two tinted glass panes at z=1 and z=2."""
    parts = [(*jproc.make_plane([0, 0, z], [pane_size, pane_size]), None, int(z > 0))
             for z in (0.0, 1.0, 2.0)]
    mats = {"base_color": [[0.8, 0.8, 0.8], list(tint)], "metalness": [0.0, 0.0],
            "roughness": [0.5, 0.0], "emission": [[0, 0, 0], [0, 0, 0]], "ior": [1.5, 1.5],
            "flags": [jcfgmod.FLAG_NON_TRANSPARENT, jcfgmod.FLAG_TRANSPARENT]}
    return jproc._assemble(parts, mats)


def test_shadow_translucency_march_matches_jax(tmp_path_factory):
    """Straight-up rays (translucency (0.9 tint)^2, first layer at 0.9, as
    the JAX package's analytic test) and 2,000 random upward rays from the
    floor, some grazing."""
    (jctxs, jscene), (ctxs, scene) = _both(_two_pane_scene(), tmp_path_factory)
    assert ctxs.transparent.tri_offset == jctxs.transparent.tri_offset > 0
    rs = np.random.RandomState(2)
    n = 2000
    sxo = np.concatenate([np.stack([np.linspace(-2, 2, 8), np.zeros(8), np.full(8, 0.1)], -1),
                          rs.uniform([-5, -5, 0.05], [5, 5, 0.5], (n, 3))]).astype(np.float32)
    d = _unit(rs, n)
    d[:, 2] = np.abs(d[:, 2]) + 0.05
    sdir = np.concatenate([np.tile([[0.0, 0.0, 1.0]], (8, 1)), d / np.linalg.norm(d, axis=-1,
                                                                                   keepdims=True)])
    sdir = sdir.astype(np.float32)
    cfg = RenderConfig(width=4, height=4)
    want = jframe._shadow_translucency_march(jctxs.transparent, jscene, JRenderConfig(width=4, height=4),
                                             jnp.asarray(sxo), jnp.asarray(sdir))
    got = frame._shadow_translucency_march(ctxs.transparent, scene, cfg, torch.from_numpy(sxo),
                                           torch.from_numpy(sdir))
    np.testing.assert_allclose(got[0].numpy()[:8], np.tile((0.9 * np.float32([0.5, 0.8, 1.0])) ** 2,
                                                           (8, 1)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy()[:8], 0.9, rtol=1e-4, atol=1e-3)
    for w, g in zip(want, got):
        assert _outlier_frac(w, g.numpy()) <= OUTLIER_FRAC
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)
    assert (got[0].numpy()[:, 0] < 0.99).mean() > 0.9


def _mirror_pocket_scene():
    """A 45-degree glass pane of IOR 12 in front of the camera, and a ceiling
    pocket reachable only through the reflected ray (tests/test_sharc_full.py)."""
    s = 3.0
    v = np.array([[-s, -s, -s], [s, -s, -s], [s, s, s], [-s, s, s]], np.float32)
    i = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    ceil_v, ceil_i = jproc.make_plane([0, 0, 4.0], [6.0, 6.0])
    mats = {"base_color": [[0.8, 0.8, 0.8], [1.0, 1.0, 1.0]], "metalness": [0.0, 0.0],
            "roughness": [0.8, 0.0], "emission": [[0, 0, 0], [0, 0, 0]], "ior": [1.5, 12.0],
            "flags": [jcfgmod.FLAG_NON_TRANSPARENT | jcfgmod.FLAG_STATIC,
                      jcfgmod.FLAG_TRANSPARENT | jcfgmod.FLAG_STATIC]}
    return jproc._assemble([(ceil_v, ceil_i, None, 0), (v, i, None, 1)], mats)


@pytest.fixture(scope="module")
def mirror_pocket(tmp_path_factory):
    (jctxs, jscene), (ctxs, scene) = _both(_mirror_pocket_scene(), tmp_path_factory)
    jcam = jlook_at([0.0, -4.0, 0.0], [0.0, 4.0, 0.0], fov_y_deg=25.0)
    cam = convert.camera_from_numpy(_np_leaves(jcam), device="cpu")
    js = JSettings(sun_elevation=jnp.float32(45.0))
    settings = convert.settings_from_numpy(_np_leaves(js), device="cpu")
    kw = dict(width=60, height=60, rpp=1, bounce_num=1, use_sharc=True, sharc_capacity=1 << 14)
    return (jctxs, jscene, jcam, js, JRenderConfig(**kw)), (ctxs, scene, cam, settings,
                                                            RenderConfig(**kw))


def test_delta_walk_matches_jax(mirror_pocket):
    """Camera rays walked through the glass pane (both reflections and
    refractions, IOR 12): the same post-glass rays."""
    (jctxs, jscene, jcam, _, jcfg), (ctxs, scene, cam, _, cfg) = mirror_pocket
    pix = np.arange(3600, dtype=np.int32)
    o, d, _ = jcamera.camera_rays(jcam, 60, 60, jnp.asarray(pix), jnp.int32(3), sample_dim=7)
    o, d = np.array(o), np.array(d)
    want = jsharc_update._delta_walk(jctxs, jscene, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(pix), jnp.int32(3), jcfg.delta_bounce_num)
    got = sharc_update._delta_walk(ctxs, scene, torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(pix), torch.tensor(3, dtype=torch.int32),
                                   cfg.delta_bounce_num)
    moved = np.any(np.asarray(want[1]) != d, axis=-1)
    assert moved.mean() > 0.5
    for w, g in zip(want, got):
        assert _outlier_frac(w, g.numpy()) <= OUTLIER_FRAC


def test_full_probe_trace_matches_jax(mirror_pocket):
    """The FULL probe trace (through glass) and the update pass with it: the
    probe records and the cache keys as the JAX package's; the cache fills
    only through the glass, as in tests/test_sharc_full.py."""
    (jctxs, jscene, jcam, js, jcfg), (ctxs, scene, cam, settings, cfg) = mirror_pocket
    want = jsharc_update._trace_probe_paths(jctxs, jscene, jcam, jcfg, js, jnp.int32(3), mode="full")
    got = sharc_update._trace_probe_paths(ctxs, scene, cam, cfg, settings,
                                          torch.tensor(3, dtype=torch.int32), mode="full")
    assert bool(got[3]["alive"].any())
    for w, g in zip(want[:3] + (want[4],), got[:3] + (got[4],)):
        assert _outlier_frac(w, g.numpy()) <= OUTLIER_FRAC
    for k in ("x", "n", "l"):
        w, g = np.asarray(want[3][k]), got[3][k].numpy()
        assert _outlier_frac(w.reshape(-1, 3), g.reshape(-1, 3)) <= OUTLIER_FRAC, k
    np.testing.assert_array_equal(got[3]["alive"].numpy(), np.asarray(want[3]["alive"]))

    jstate = jsharc.SharcState.create(jcfg.sharc_capacity, jnp.float32)
    jstate, _ = jax.jit(lambda st: jsharc_update.sharc_update_pass(
        jctxs, jscene, jcam, jcfg, js, jnp.int32(3), st))(jstate)
    state, _ = sharc_update.sharc_update_pass(
        ctxs, scene, cam, cfg, settings, torch.tensor(3, dtype=torch.int32),
        sharc.SharcState.create(cfg.sharc_capacity, cfg.dtype, "cpu"))
    want_keys = np.asarray(jstate.keys).astype(np.int64)
    got_keys = state.keys.numpy()
    assert (got_keys != 0).sum() > 20
    assert (got_keys != want_keys).mean() <= 0.005


def test_trace_transparent_color_matches_jax(tmp_path_factory):
    """The glass delta chains of the glass Cornell box (one 2N wavefront,
    the deferred end shadow with the sun on) against the JAX package's, from
    the same opaque hit distances."""
    (jctxs, jscene), (ctxs, scene) = _both(jproc.cornell_box_glass(), tmp_path_factory)
    assert ctxs.transparent.mode == "dense" and ctxs.transparent.tri_offset > 0
    res = 32
    jcam = jlook_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0)
    cam = convert.camera_from_numpy(_np_leaves(jcam), device="cpu")
    js = JSettings(sun_elevation=jnp.float32(45.0))
    settings = convert.settings_from_numpy(_np_leaves(js), device="cpu")
    jcfg, cfg = JRenderConfig(width=res, height=res), RenderConfig(width=res, height=res)
    pix = jnp.arange(res * res, dtype=jnp.int32)
    o, d, _ = jcamera.camera_rays(jcam, res, res, pix, jnp.int32(2))
    hit = jtraversal.closest_hit(jctxs.opaque, o, d)
    primary_t = np.array(jnp.where(hit["tri"] >= 0, hit["t"], jtraversal.T_MAX))
    want = jax.jit(lambda t: jtt.trace_transparent_color(
        jctxs, jscene, jcam, jcfg, js, jnp.int32(2), {"primary_t": t}, pix))(jnp.asarray(primary_t))
    got = tt.trace_transparent_color(ctxs, scene, cam, cfg, settings,
                                     torch.tensor(2, dtype=torch.int32),
                                     {"primary_t": torch.from_numpy(primary_t)},
                                     torch.arange(res * res, dtype=torch.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 50 < int(got[1].sum()) < res * res
    assert _outlier_frac(want[0], got[0].numpy()) <= OUTLIER_FRAC
    assert float(got[0][got[1]].mean()) > 0.0
