"""Textures, normal maps and the alpha test of the port (``scene/textures.py``,
``render/raycone.py``, ``render/gbuffer.decode_hit``'s texture branch,
``ops/traversal.closest_hit_alpha``) against the JAX package's.

The cases of tests/test_textures.py and tests/test_normal_map.py run through
both packages on the same numpy inputs (the port's scenes go to the JAX
package leaf by leaf): their own assertions hold for the port, and its values
agree with JAX's. Texture sets are built bit-equal; a sample, a ray-cone mip
and decode_hit's props agree within 1e-5 abs/rel (DECODE_TOL, the bound of
tests/test_torch_trace.py: XLA and torch round a log2, a sqrt or an rsqrt a
few ULPs apart). Alpha-tested hits agree in tri on at least 99% of the
rays (a ray through a shared edge is a tie that XLA's fused arithmetic and
the port's unfused one may break apart, tests/test_torch_trace.py) and in
t/u/v within 1e-5 where tri agrees, in dense and in cluster mode.

A textured, normal-mapped, alpha-tested kitchen (box-projected uvs, the
``procedural_maps`` of ``scene/textures``) renders two RELAX frames at 48x48
through both packages' render_frame, held to the frame tolerance of PERF.md
§2 (per plane at most 0.5% of pixels off by more than 1e-3 * (1 + |ref|),
image means within 1e-3 relative). The gradients of an L2 image loss with
respect to every mip level's texels (REFERENCE, 24x24, two bounces) agree
with ``jax.grad``'s entry by entry within GRAD_TOL of the level's largest
|JAX entry|. Both JAX computations are session-cached."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu import config as jconfig
from nrdsample_tpu.config import Denoiser as JDenoiser, RenderConfig as JRenderConfig
from nrdsample_tpu.config import Settings as JSettings, TracingMode as JTracingMode
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import frame as jframe
from nrdsample_tpu.render import gbuffer as jgbuffer, raycone as jraycone
from nrdsample_tpu.scene import textures as jtex
from nrdsample_tpu.scene import types as jtypes
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import config, convert
from nrdsample_tpu_torch.config import Denoiser, RenderConfig, TracingMode
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.pipeline import bench_configs, frame
from nrdsample_tpu_torch.render import gbuffer, raycone
from nrdsample_tpu_torch.scene import procedural, textures as tex
from nrdsample_tpu_torch.scene.types import Materials, build_triangle_soa, look_at, make_scene
from torch_session_cache import (declare, jax_native_order_ready, session_cached,
                                 share_cores_between_workers)

share_cores_between_workers()

DECODE_TOL = 1e-5
TIE_FRAC = 0.01          # rays whose hit triangle may differ: edge ties, as in test_torch_trace.py
OUTLIER_FRAC = 0.005
MEAN_REL = 1e-3
GRAD_TOL = 1e-4          # of the level's largest |JAX entry|, as tests/test_torch_grad.py
FW, FH, FRAMES = 48, 48, 2
GRES = 24
GRAD_UV_SCALE = 0.1      # a coarse uv chart: the camera rays' cones reach level 0 at 24x24
KITCHEN_TEX = dict(res=64, seed=3, alpha_materials=(4,))   # the counter tops
PLANES = ["color", "diff_radiance", "spec_radiance", "shadow", "view_z", "normal"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_scene(scene):
    """The JAX package's Scene of the same arrays as the port's CPU scene."""
    def leaves(obj, cls):
        return cls(**{f.name: jnp.asarray(getattr(obj, f.name).detach().numpy())
                      for f in dataclasses.fields(cls)})

    ts = scene.textures
    return jtypes.Scene(
        tris=leaves(scene.tris, jtypes.TriangleSoA),
        materials=leaves(scene.materials, jtypes.Materials),
        emissive_tris=jnp.asarray(scene.emissive_tris.numpy()),
        emissive_count=jnp.asarray(scene.emissive_count.numpy()),
        has_emissive=scene.has_emissive, has_alpha_test=scene.has_alpha_test,
        textures=None if ts is None else jtex.TextureSet(
            levels=[jnp.asarray(lv.detach().numpy()) for lv in ts.levels]))


def _assert_close(got, want, what, tol=DECODE_TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _checker(res, c0=0.0, c1=1.0):
    y, x = np.mgrid[0:res, 0:res]
    return np.where(((x // 8) + (y // 8)) % 2 == 0, c0, c1).astype(np.float32)


def _both_sets(per_material, res):
    """(port, JAX) TextureSets of the same maps; their levels are equal."""
    got, want = tex.build_texture_set(per_material, res=res), jtex.build_texture_set(per_material,
                                                                                       res=res)
    assert got.n_mips == want.n_mips and got.base_res == want.base_res
    for a, b in zip(got.levels, want.levels):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return got, want


def _sample_both(sets, mat, uv, mip):
    got = tex.sample(sets[0], _t(mat), _t(uv), _t(mip))
    want = jtex.sample(sets[1], jnp.asarray(mat), jnp.asarray(uv), jnp.asarray(mip))
    _assert_close(got, want, "sample")
    return got.numpy()


# ---- tests/test_textures.py, through both packages ----


def test_build_and_sample_base_mip():
    img = np.stack([_checker(64)] * 3, axis=-1)
    sets = _both_sets([{"base_color": img}], 64)
    assert sets[0].n_mips == 7
    uv = np.array([[4.5 / 64, 4.5 / 64], [12.5 / 64, 4.5 / 64]], np.float32)
    out = _sample_both(sets, np.zeros(2, np.int32), uv, np.zeros(2, np.float32))
    np.testing.assert_allclose(out[0, :3], 0.0, atol=1e-5)
    np.testing.assert_allclose(out[1, :3], 1.0, atol=1e-5)


def test_highest_mip_is_mean():
    sets = _both_sets([{"base_color": np.stack([_checker(32)] * 3, axis=-1)}], 32)
    out = _sample_both(sets, np.zeros(1, np.int32), np.array([[0.3, 0.7]], np.float32),
                       np.full(1, 99.0, np.float32))
    np.testing.assert_allclose(out[0, :3], 0.5, atol=1e-5)


def test_trilinear_between_mips():
    sets = _both_sets([{"base_color": np.stack([_checker(32)] * 3, axis=-1)}], 32)
    uv, mat = np.array([[0.26, 0.26]], np.float32), np.zeros(1, np.int32)
    v0, v1, vh = (_sample_both(sets, mat, uv, np.array([m], np.float32)) for m in (2.0, 3.0, 2.5))
    np.testing.assert_allclose(vh, 0.5 * (v0 + v1), atol=1e-5)


def test_multi_material_stacking():
    sets = _both_sets([{"base_color": np.zeros((8, 8, 3), np.float32)},
                       {"base_color": np.ones((8, 8, 3), np.float32)}], 8)
    out = _sample_both(sets, np.array([0, 1], np.int32), np.full((2, 2), 0.5, np.float32),
                       np.zeros(2, np.float32))
    np.testing.assert_allclose(out[0, :3], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[1, :3], 1.0, atol=1e-6)


def _mip_both(widths, world, uva, ndv, res=128):
    got = raycone.texture_mip(_t(widths), _t(world), _t(uva), _t(ndv), res)
    want = jraycone.texture_mip(jnp.asarray(widths), jnp.asarray(world), jnp.asarray(uva),
                                jnp.asarray(ndv), res)
    _assert_close(got, want, "texture_mip")
    return got.numpy()


def test_raycone_mip_monotone_in_distance():
    m = _mip_both(np.array([0.1, 0.4, 1.6], np.float32), np.ones(3, np.float32),
                  np.full(3, 0.01, np.float32), np.ones(3, np.float32))
    assert m[0] <= m[1] <= m[2]
    assert m[2] - m[0] == pytest.approx(4.0, abs=0.3)


def test_raycone_grazing_blurrier():
    args = (np.array([0.01], np.float32), np.array([1.0], np.float32),
            np.array([0.01], np.float32))
    assert _mip_both(*args, np.array([0.1], np.float32))[0] > _mip_both(*args, np.ones(1, np.float32))[0]


def _two_quad_scene(alpha_map, base_color=None):
    """Front alpha-tested quad at y=0, solid back quad at y=2 (the port's
    CPU scene)."""
    verts = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
                      [-2, 2, -2], [2, 2, -2], [2, 2, 2], [-2, 2, 2]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]] * 2, np.float32)
    tris = build_triangle_soa(verts, idx, None, uvs, np.array([0, 0, 1, 1], np.int32))
    mats = Materials(
        base_color=torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]), metalness=torch.zeros(2),
        roughness=torch.full((2,), 0.5), emission=torch.zeros(2, 3), ior=torch.full((2,), 1.5),
        flags=torch.tensor([config.FLAG_NON_TRANSPARENT | config.FLAG_ALPHA_TEST,
                            config.FLAG_NON_TRANSPARENT], dtype=torch.int32))
    m0 = {"alpha": alpha_map}
    if base_color is not None:
        m0["base_color"] = base_color
    return dataclasses.replace(make_scene(tris, mats),
                               textures=tex.build_texture_set([m0, {}], res=32),
                               has_alpha_test=True)


def _alpha_hits_both(scene, o, d):
    """closest_hit_alpha of both packages on the same rays; tri equal, t/u/v
    within DECODE_TOL. Returns the port's hits and the JAX scene."""
    ctx, sc = traversal.build_context(scene, device="cpu")
    jctx, jsc = jtraversal.build_context(_jax_scene(scene))
    got = traversal.closest_hit_alpha(ctx, sc, _t(o), _t(d))
    want = jtraversal.closest_hit_alpha(jctx, jsc, jnp.asarray(o), jnp.asarray(d))
    same = got["tri"].numpy() == np.asarray(want["tri"])
    assert same.mean() >= 1.0 - TIE_FRAC, f"tri differs on {int((~same).sum())} rays"
    for k in ("t", "u", "v"):
        _assert_close(got[k].numpy()[same], np.asarray(want[k])[same], k)
    return got, (jctx, jsc), (ctx, sc)


def test_alpha_test_passthrough_and_block():
    alpha = np.ones((32, 32), np.float32)
    alpha[:, :16] = 0.0
    o = np.array([[-0.5, -3.0, 0.0], [0.5, -3.0, 0.0]], np.float32)
    d = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    got = _alpha_hits_both(_two_quad_scene(alpha), o, d)[0]
    assert float(got["t"][0]) == pytest.approx(5.0, abs=1e-3)
    assert float(got["t"][1]) == pytest.approx(3.0, abs=1e-3)
    # seeded rays through both halves, from both sides
    rs = np.random.RandomState(0)
    o = np.concatenate([rs.uniform(-1.5, 1.5, (256, 3)) * [1, 0, 1] + [0, -3, 0],
                        rs.uniform(-1.5, 1.5, (256, 3)) * [1, 0, 1] + [0, 1, 0]]).astype(np.float32)
    d = np.concatenate([np.tile([[0, 1, 0]], (256, 1)), np.tile([[0, -1, 0]], (256, 1))])
    d = (d + rs.randn(512, 3) * 0.05).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = _alpha_hits_both(_two_quad_scene(alpha), o, d)[0]
    assert int((got["tri"] >= 2).sum()) > 50 and int(((got["tri"] >= 0) & (got["tri"] < 2)).sum()) > 50


def test_alpha_test_disabled_when_flag_missing():
    scene = dataclasses.replace(_two_quad_scene(np.zeros((32, 32), np.float32)),
                                has_alpha_test=False)
    got = _alpha_hits_both(scene, np.array([[0.0, -3.0, 0.0]], np.float32),
                           np.array([[0.0, 1.0, 0.0]], np.float32))[0]
    assert float(got["t"][0]) == pytest.approx(3.0, abs=1e-3)


def _decode_both(scene_pair, hit, o, d, **kw):
    """decode_hit of both packages on the same hit (the JAX one's arrays)."""
    (jscene, scene) = scene_pair
    sun = np.array([0.0, 0.0, 1.0], np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want = jgbuffer.decode_hit(jscene, {k: jnp.asarray(v) for k, v in hit.items()},
                               jnp.asarray(o), jnp.asarray(d), jnp.asarray(sun), 0.01, **jkw)
    got = gbuffer.decode_hit(scene, {k: _t(v) for k, v in hit.items()}, _t(o), _t(d), _t(sun),
                             torch.tensor(0.01), with_tangent=True,
                             **{k: _t(v) for k, v in kw.items()})
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.dtype == {"b": torch.bool, "i": torch.int32, "f": torch.float32}[w.dtype.kind], k
        _assert_close(v, w, k)
    return got


def test_textured_decode_hit_modulates_base_color():
    grad = np.zeros((32, 32, 3), np.float32)
    grad[:, :, 0] = np.linspace(0, 1, 32)[None, :]
    scene = _two_quad_scene(np.ones((32, 32), np.float32), base_color=grad)
    o = np.array([[0.9, -3.0, 0.0]], np.float32)
    d = np.array([[0.0, 1.0, 0.0]], np.float32)
    _, (jctx, jsc), (ctx, sc) = _alpha_hits_both(scene, o, d)
    hit = {k: np.asarray(v) for k, v in jtraversal.closest_hit(jctx, jnp.asarray(o),
                                                               jnp.asarray(d)).items()}
    props = _decode_both((jsc, sc), hit, o, d, cone_width=np.array([1e-3], np.float32))
    bc = props["base_color"].numpy()[0]
    assert bc[0] == pytest.approx(0.95, abs=0.05) and bc[2] == pytest.approx(0.0, abs=1e-4)


# ---- tests/test_normal_map.py, through both packages ----


def _quad_scene(normal_map=None, tangents=None):
    """Unit quad in the XY plane (z=0), uvs aligned so T=+X, B=+Y, N=+Z."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    tris = build_triangle_soa(verts, idx, nrm, uvs, np.zeros(2, np.int32), tangents=tangents)
    mats = Materials(base_color=torch.full((1, 3), 0.8), metalness=torch.zeros(1),
                     roughness=torch.full((1,), 0.7), emission=torch.zeros(1, 3),
                     ior=torch.full((1,), 1.5), flags=torch.ones(1, dtype=torch.int32))
    scene = make_scene(tris, mats)
    if normal_map is not None:
        scene = dataclasses.replace(scene, textures=tex.build_texture_set([{"normal": normal_map}],
                                                                          res=8))
    return _jax_scene(scene), scene


def _quad_decode(pair, **kw):
    hit = {"tri": np.array([0], np.int32), "u": np.array([0.4], np.float32),
           "v": np.array([0.3], np.float32), "t": np.array([2.0], np.float32)}
    return _decode_both(pair, hit, np.array([[0.5, 0.4, 2.0]], np.float32),
                        np.array([[0.0, 0.0, -1.0]], np.float32), **kw)


def test_uv_derived_tangent_matches_chart():
    props = _quad_decode(_quad_scene())
    np.testing.assert_allclose(props["tangent"].numpy()[0], [1.0, 0.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(props["n"].numpy()[0], [0, 0, 1], atol=1e-5)


def test_explicit_gltf_style_tangents_win():
    tang = np.tile(np.array([[0, 1, 0, 1]], np.float32), (4, 1))
    props = _quad_decode(_quad_scene(tangents=tang))
    np.testing.assert_allclose(props["tangent"].numpy()[0], [0, 1, 0], atol=1e-5)


def test_degenerate_uv_falls_back():
    args = (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32), np.array([[0, 1, 2]], np.int32),
            None, np.zeros((3, 2), np.float32), np.zeros(1, np.int32))
    got, want = build_triangle_soa(*args), jtypes.build_triangle_soa(*args)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)))
    t = got.t0.numpy()[0]
    assert abs(np.linalg.norm(t) - 1.0) < 1e-5 and abs(t @ np.array([0, 0, 1.0])) < 1e-5


def test_analytic_perturbed_normal():
    nx, ny = 0.3, -0.2
    nm = np.zeros((8, 8, 2), np.float32)
    nm[..., 0], nm[..., 1] = (nx + 1.0) / 2.0, (ny + 1.0) / 2.0
    props = _quad_decode(_quad_scene(normal_map=nm))
    expected = np.array([nx, ny, np.sqrt(1.0 - nx * nx - ny * ny)], np.float32)
    np.testing.assert_allclose(props["n"].numpy()[0], expected, atol=2e-2)
    assert abs(float(props["n"][0] @ props["tangent"][0])) < 1e-4


def test_toggle_disables_perturbation():
    props = _quad_decode(_quad_scene(normal_map=np.full((8, 8, 2), 0.9, np.float32)),
                         use_normal_map=np.int32(0))
    np.testing.assert_allclose(props["n"].numpy()[0], [0, 0, 1], atol=1e-5)


def test_local_curvature_from_map():
    nm = np.full((8, 8, 2), 0.5, np.float32)
    nm[..., 0] = 0.75                                   # Nlocal.x = 0.5
    props = _quad_decode(_quad_scene(normal_map=nm), cone_width=np.array([0.05], np.float32))
    assert float(props["curvature"][0]) == pytest.approx(10.0, rel=0.1)


def test_flat_map_is_identity():
    props = _quad_decode(_quad_scene(normal_map=np.full((8, 8, 2), 0.5, np.float32)))
    np.testing.assert_allclose(props["n"].numpy()[0], [0, 0, 1], atol=1e-5)


def test_bumped_plane_changes_image():
    """A ground plane with a strong ripple normal map renders finite and
    differs from the flat render by more than 2% (test_normal_map.py's
    bound); the port's decode of the plane's camera hits matches JAX's."""
    v, i = procedural.make_box([0, 0, -0.25], [8, 8, 0.5])
    tris = build_triangle_soa(v, i, None, None, np.zeros(len(i), np.int32))
    mats = Materials(base_color=torch.full((1, 3), 0.8), metalness=torch.zeros(1),
                     roughness=torch.full((1,), 0.7), emission=torch.zeros(1, 3),
                     ior=torch.full((1,), 1.5), flags=torch.ones(1, dtype=torch.int32))
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    ripple = np.stack([0.5 + 0.4 * np.sin(xx * 1.3), 0.5 + 0.4 * np.sin(yy * 1.3)], -1)
    scene = dataclasses.replace(make_scene(tris, mats), textures=tex.build_texture_set(
        [{"normal": ripple.astype(np.float32)}], res=32))
    ctx, sc = traversal.build_context(scene, device="cpu")
    cam = look_at(eye=[0, -4, 3], target=[0, 0, 0], fov_y_deg=50.0, device="cpu")
    cfg = RenderConfig(width=32, height=32, rpp=1, bounce_num=1,
                       tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.REFERENCE)

    def render(use_nm):
        s = config.make_settings("cpu", sun_elevation=50.0, use_normal_map=use_nm)
        return frame.render_frame(ctx, sc, cam, cfg, s, frame.History.create(cfg, "cpu"))[0]["color"]

    bumped, flat = render(1), render(0)
    assert bool(torch.isfinite(bumped).all())
    diff = float((bumped - flat).abs().mean() / (flat.abs().mean() + 1e-9))
    assert diff > 0.02, f"normal map had no visible effect: {diff}"
    rs = np.random.RandomState(1)
    o = np.tile(np.array([[0.0, -4.0, 3.0]], np.float32), (256, 1))
    d = (rs.uniform(-0.4, 0.4, (256, 3)) + [0.0, 0.8, -0.6]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jctx, jsc = jtraversal.build_context(_jax_scene(scene))
    hit = {k: np.asarray(v) for k, v in jtraversal.closest_hit(jctx, jnp.asarray(o),
                                                               jnp.asarray(d)).items()}
    _decode_both((jsc, sc), hit, o, d, cone_width=np.full(256, 0.01, np.float32),
                 use_normal_map=np.int32(1))


# ---- the port's sample, decode_hit and alpha test on a textured scene ----


def test_sample_matches_jax_on_seeded_inputs():
    """Wrap addressing (uv outside [0, 1)), mips below 0 and above the top,
    every material."""
    per = tex.procedural_maps(3, 32, seed=5, alpha_materials=(2,))
    sets = _both_sets(per, 32)
    rs = np.random.RandomState(2)
    uv = rs.uniform(-2.0, 3.0, (4096, 2)).astype(np.float32)
    mip = rs.uniform(-1.0, 7.0, 4096).astype(np.float32)
    _sample_both(sets, rs.randint(0, 3, 4096).astype(np.int32), uv, mip)
    got = tex.sample_alpha(sets[0], _t(np.arange(4096) % 3), _t(uv))
    want = jtex.sample_alpha(sets[1], jnp.asarray(np.arange(4096) % 3), jnp.asarray(uv))
    _assert_close(got, want, "sample_alpha")


def _textured_kitchen(uv_scale=0.5):
    return tex.textured_scene(procedural.kitchen(), uv_scale=uv_scale, **KITCHEN_TEX)


def test_decode_hit_props_match_jax_on_a_textured_scene():
    """The textured, normal-mapped, alpha-tested kitchen: alpha-tested camera
    hits, then every prop of decode_hit with a ray cone and the normal map
    on, and with it off."""
    scene = _textured_kitchen()
    eye, target, fov = bench_configs.CONFIGS["kitchen1080"]["cam"]
    cam = look_at(eye, target, fov_y_deg=fov, device="cpu")
    from nrdsample_tpu_torch.scene import camera
    o, d, _ = camera.camera_rays(cam, 32, 32, torch.arange(1024, dtype=torch.int32),
                                 torch.tensor(0))
    o, d = o.numpy(), d.numpy()
    got, (jctx, jsc), (ctx, sc) = _alpha_hits_both(scene, o, d)
    hit = {k: np.asarray(v) for k, v in jtraversal.closest_hit_alpha(
        jctx, jsc, jnp.asarray(o), jnp.asarray(d)).items()}
    cone = (0.002 * hit["t"]).astype(np.float32)
    for use_nm in (1, 0):
        props = _decode_both((jsc, sc), hit, o, d, cone_width=cone, use_normal_map=np.int32(use_nm))
    assert float(props["mip"].max()) > 0.5 and bool((props["curvature"] >= 0).all())
    # some rays passed a cut-out of the alpha-tested counter tops (material 4)
    plain = traversal.closest_hit(ctx, _t(o), _t(d))
    assert int((plain["tri"] != got["tri"]).sum()) > 0


def test_closest_hit_alpha_in_cluster_mode(tmp_path_factory):
    """shader_balls grid 2 (13 clusters) with an alpha-tested material:
    the alpha rounds re-trace through the plain cluster scan, as the JAX
    package's through its XLA scan."""
    jax_native_order_ready(tmp_path_factory)
    scene = tex.textured_scene(procedural.shader_balls(grid=2, sphere_res=12), res=64, seed=1,
                               alpha_materials=(1, 2))
    rs = np.random.RandomState(4)
    o = (rs.uniform(-1, 1, (2048, 3)) * [6, 1, 1] + [0, -9, 3]).astype(np.float32)
    d = (rs.uniform(-0.3, 0.3, (2048, 3)) + [0, 1, -0.3]).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got, _, (ctx, sc) = _alpha_hits_both(scene, o, d)
    assert ctx.mode == "cluster"
    plain = traversal.closest_hit(ctx, _t(o), _t(d))
    assert int((plain["tri"] != got["tri"]).sum()) > 10 and int((got["tri"] >= 0).sum()) > 1000


# ---- a textured frame and the texels' gradients, against JAX ----


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _kitchen_inputs(w, h, uv_scale=0.5):
    scene = _textured_kitchen(uv_scale)
    eye, target, fov = bench_configs.CONFIGS["kitchen1080"]["cam"]
    jc = jlook_at(eye, target, fov_y_deg=fov, aspect=w / h)
    js = JSettings(sun_elevation=jnp.float32(35.0))
    return scene, jc, js


def _jax_frames():
    scene, jc, js = _kitchen_inputs(FW, FH)
    jctx, jscene = jtraversal.build_context(_jax_scene(scene))
    jcfg = JRenderConfig(width=FW, height=FH, rpp=1, bounce_num=1, denoiser=JDenoiser.RELAX)
    fn = jax.jit(lambda sc, h: jframe.render_frame(jctx, sc, jc, jcfg, js, h))
    jh, outs = jframe.History.create(jcfg), []
    for _ in range(FRAMES):
        jout, jh = fn(jscene, jh)
        outs.append({k: np.asarray(jout[k]) for k in PLANES})
    return outs


def _jax_grads():
    scene, jc, js = _kitchen_inputs(GRES, GRES, GRAD_UV_SCALE)
    jctx, jscene = jtraversal.build_context(_jax_scene(scene))
    jcfg = JRenderConfig(width=GRES, height=GRES, rpp=1, bounce_num=2, importance_samples=4,
                         tracing_mode=JTracingMode.FULL_PROBABILISTIC, denoiser=JDenoiser.REFERENCE)

    def loss(levels):
        sc = dataclasses.replace(jscene, textures=jtex.TextureSet(levels=levels))
        color = jframe.render_frame(jctx, sc, jc, jcfg, js, jframe.History.create(jcfg))[0]["color"]
        return jnp.sum(color * color)

    value, grads = jax.jit(jax.value_and_grad(loss))(list(jscene.textures.levels))
    return {"loss": float(value), "grads": [np.asarray(g) for g in grads]}


_JAX = {"torch_tex_frames": _jax_frames, "torch_tex_grads": _jax_grads}
for _name, _fn in _JAX.items():
    declare(_name, lambda _, fn=_fn: fn())


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_tex_frames", _jax_frames, others=_JAX)


@pytest.fixture(scope="module")
def jax_grads(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_tex_grads", _jax_grads, others=_JAX)


@pytest.fixture(scope="module")
def port_frames():
    scene, jc, js = _kitchen_inputs(FW, FH)
    ctx, sc = traversal.build_context(scene, device="cpu")
    cam = convert.camera_from_numpy(_leaves(jc), device="cpu")
    settings = convert.settings_from_numpy(_leaves(js), device="cpu")
    cfg = RenderConfig(width=FW, height=FH, rpp=1, bounce_num=1, denoiser=Denoiser.RELAX)
    h, outs = frame.History.create(cfg, "cpu"), []
    for _ in range(FRAMES):
        out, h = frame.render_frame(ctx, sc, cam, cfg, settings, h)
        outs.append(out)
    return outs


def _outlier_frac(ref, got):
    ref = np.asarray(ref, np.float64).reshape(ref.shape[0], -1)
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    return (np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))).any(-1).mean()


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", PLANES)
def test_textured_frame_matches_jax(jax_frames, port_frames, index, plane):
    want, got = jax_frames[index][plane], port_frames[index][plane]
    assert tuple(got.shape) == want.shape and bool(torch.isfinite(got).all())
    assert _outlier_frac(want, got.numpy()) <= OUTLIER_FRAC
    if plane == "color":
        w, g = float(want.mean()), float(got.mean())
        assert abs(g - w) <= MEAN_REL * abs(w) and g > 0.0


@pytest.fixture(scope="module")
def port_grads():
    scene, jc, js = _kitchen_inputs(GRES, GRES, GRAD_UV_SCALE)
    ctx, sc = traversal.build_context(scene, device="cpu")
    cam = convert.camera_from_numpy(_leaves(jc), device="cpu")
    settings = convert.settings_from_numpy(_leaves(js), device="cpu")
    cfg = RenderConfig(width=GRES, height=GRES, rpp=1, bounce_num=2, importance_samples=4,
                       tracing_mode=TracingMode.FULL_PROBABILISTIC, denoiser=Denoiser.REFERENCE)
    levels = [lv.clone().requires_grad_() for lv in sc.textures.levels]
    sc = dataclasses.replace(sc, textures=tex.TextureSet(levels))
    color = frame.render_frame(ctx, sc, cam, cfg, settings, frame.History.create(cfg, "cpu"))[0]["color"]
    loss = (color * color).sum()
    return float(loss.detach()), torch.autograd.grad(loss, levels)


def test_textured_loss_matches_jax(jax_grads, port_grads):
    assert abs(port_grads[0] - jax_grads["loss"]) <= 1e-5 * jax_grads["loss"]


@pytest.mark.parametrize("level", range(7))
def test_texel_gradients_match_jax(jax_grads, port_grads, level):
    """Every entry of the level's texel gradient within GRAD_TOL of the
    level's largest |JAX entry| (the coarse levels are reached by the
    bounces' wide cones, the alpha channel by nothing)."""
    got, want = port_grads[1][level].numpy(), jax_grads["grads"][level]
    assert len(port_grads[1]) == len(jax_grads["grads"]) == 7
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = float(np.abs(want).max())
    assert scale > 0.0 and not got[..., 3].any() and not want[..., 3].any()
    off = np.abs(got - want) > GRAD_TOL * scale
    assert not off.any(), (f"level {level}: {int(off.sum())} entries off, max |diff| "
                           f"{np.abs(got - want).max()} of {scale}")
