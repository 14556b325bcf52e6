"""The record corpus's render branches of the port against the JAX package:
the stress tests and sanitization, the occlusion modes, hair/SSS, the
checkerboard (HALF) resolve, the L1 cache and the PSR walk.

Elementwise functions take the same seeded numpy inputs in both packages
and must agree within 1e-6 (abs and rel; NaN where the JAX package has
NaN). Functions that trace rays (the PSR walk and the trace around it) are
held to the frame tolerance of PERF.md §2: per plane at most 0.5% of the
pixels off by more than 1e-3 * (1 + |ref|). The rest are the intent of the
JAX package's own tests (test_psr.py, test_stress.py, test_checkerboard.py,
test_nrd_modes.py, test_hair_sss.py) as port cases."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu import config as jconfig
from nrdsample_tpu.config import RenderConfig as JRenderConfig, Settings as JSettings
from nrdsample_tpu.denoise import checkerboard as jcb, occlusion as jocc
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.render import (gbuffer as jgbuffer, hair_sss as jhair, l1cache as jl1,
                                  lighting as jlighting, stress as jstress,
                                  trace_opaque as jtrace)
from nrdsample_tpu.scene import camera as jcam, procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import config
from nrdsample_tpu_torch.config import Denoiser, NrdMode, RenderConfig, TracingMode, make_settings
from nrdsample_tpu_torch.denoise import checkerboard, occlusion
from nrdsample_tpu_torch.mathlib import rng
from nrdsample_tpu_torch.ops import intersect, traversal
from nrdsample_tpu_torch.pipeline import frame
from nrdsample_tpu_torch.render import gbuffer, hair_sss, l1cache, lighting, stress, trace_opaque
from nrdsample_tpu_torch.scene import camera, procedural
from nrdsample_tpu_torch.scene.types import look_at
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

TOL = 1e-6
OUTLIER_FRAC = 0.005
RES = 32
N = 4096


def _close(got, want, tol=TOL):
    """got (torch) equals want (JAX) within tol abs and rel, NaN where NaN."""
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
    if g.dtype == np.bool_ or np.issubdtype(g.dtype, np.integer):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, equal_nan=True)


def _outlier_frac(ref, got):
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    bad = np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))
    both_inf = ~np.isfinite(ref) & ~np.isfinite(got)
    return (bad & ~both_inf).any(-1).mean()


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- stress tests and sanitization ----

def _seeded_gbuffer(n, seed):
    rs = np.random.RandomState(seed)
    gb = {k: rs.uniform(-0.2, 4.0, (n, 3)).astype(np.float32)
          for k in ("diff_radiance", "spec_radiance", "direct_lighting", "emission")}
    gb["diff_radiance"][rs.rand(n) < 0.05, 1] = np.nan
    gb["emission"][rs.rand(n) < 0.05, 2] = np.inf
    view_z = rs.uniform(0.1, 50.0, n).astype(np.float32)
    view_z[rs.rand(n) < 0.2] = 1e5
    view_z[rs.rand(n) < 0.03] = np.nan
    gb["view_z"] = view_z
    for k in ("diff_hitdist", "spec_hitdist", "shadow", "shadow_hit_dist"):
        v = rs.uniform(0.0, 5.0, n).astype(np.float32)
        v[rs.rand(n) < 0.05] = np.inf
        gb[k] = v
    gb["material_id"] = (rs.rand(n) < 0.3).astype(np.float32)
    return gb


STRESS_CASES = {
    "drs": dict(use_drs_stress_test=True),
    "inf": dict(use_inf_stress_test=True),
    "firefly": dict(use_firefly_test=True),
    "material_id": dict(use_material_id_test=True),
    "all": dict(use_drs_stress_test=True, use_inf_stress_test=True, use_firefly_test=True,
                use_material_id_test=True),
}


@pytest.mark.parametrize("case", sorted(STRESS_CASES))
def test_apply_stress_tests_matches_jax(case):
    w, h = 64, 64
    gb = _seeded_gbuffer(w * h, 1)
    pix = np.arange(w * h, dtype=np.int32)
    kw = STRESS_CASES[case]
    want = jstress.apply_stress_tests({k: jnp.asarray(v) for k, v in gb.items()},
                                      JRenderConfig(width=w, height=h, **kw),
                                      JSettings(resolution_scale=jnp.float32(0.7)),
                                      jnp.asarray(pix), jnp.int32(3))
    got = stress.apply_stress_tests({k: _t(v) for k, v in gb.items()},
                                    RenderConfig(width=w, height=h, **kw),
                                    make_settings("cpu", resolution_scale=0.7), _t(pix),
                                    torch.tensor(3, dtype=torch.int32))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("scale", [1.0, 0.75, 0.5, 0.3])
def test_rect_mask_matches_jax(scale):
    w, h = 40, 24
    pix = np.arange(w * h, dtype=np.int32)
    want = jstress.rect_mask(JRenderConfig(width=w, height=h),
                             JSettings(resolution_scale=jnp.float32(scale)), jnp.asarray(pix))
    got = stress.rect_mask(RenderConfig(width=w, height=h),
                           make_settings("cpu", resolution_scale=scale), _t(pix))
    _close(got, want)


def test_is_valid_radiance_matches_jax():
    c = np.array([[1.0, 2.0, 3.0], [np.nan, 0.0, 0.0], [np.inf, 1.0, 1.0],
                  [-1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], np.float32)
    _close(stress.is_valid_radiance(_t(c)), jstress.is_valid_radiance(jnp.asarray(c)))
    _close(stress.is_valid_radiance(_t(c[:, 0])), jstress.is_valid_radiance(jnp.asarray(c[:, 0])))
    assert stress.is_valid_radiance(_t(c)).tolist() == [True, False, False, False, True]


@pytest.mark.parametrize("scale", [1.0, 0.6])
def test_sanitize_gbuffer_matches_jax(scale):
    w, h = 64, 48
    gb = _seeded_gbuffer(w * h, 2)
    pix = np.arange(w * h, dtype=np.int32)
    want = jstress.sanitize_gbuffer({k: jnp.asarray(v) for k, v in gb.items()},
                                    JRenderConfig(width=w, height=h),
                                    JSettings(resolution_scale=jnp.float32(scale)),
                                    jnp.asarray(pix))
    got = stress.sanitize_gbuffer({k: _t(v) for k, v in gb.items()},
                                  RenderConfig(width=w, height=h),
                                  make_settings("cpu", resolution_scale=scale), _t(pix))
    for k in want:
        _close(got[k], want[k])
    for k in ("diff_radiance", "spec_radiance", "direct_lighting", "emission", "view_z"):
        assert bool(torch.isfinite(got[k]).all())


def _cornell(**cfg_kw):
    ctx, scene = traversal.build_context(procedural.cornell_box(), device="cpu")
    cam = look_at([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], fov_y_deg=39.0, device="cpu")
    kw = dict(width=RES, height=RES, rpp=1, bounce_num=1, denoiser=Denoiser.RELAX)
    kw.update(cfg_kw)
    return ctx, scene, cam, RenderConfig(**kw)


def _render(ctx, scene, cam, cfg, settings):
    return frame.render_frame(ctx, scene, cam, cfg, settings, frame.History.create(cfg, "cpu"))[0]


def test_drs_garbage_contained_by_sanitization():
    """NaN written outside the DRS rect, then sanitized: the frame is finite
    and equals the sanitized frame with no garbage written."""
    settings = make_settings("cpu", sun_elevation=-30.0, disable_shadows=1, resolution_scale=0.75)
    out = _render(*_cornell(use_drs_stress_test=True, use_sanitization=True), settings)
    clean = _render(*_cornell(use_sanitization=True), settings)
    assert bool(torch.isfinite(out["color"]).all())
    torch.testing.assert_close(out["color"], clean["color"], rtol=0.0, atol=1e-5)


def test_garbage_without_sanitization_propagates():
    """Without sanitization the NaN outside the rect reaches the output."""
    settings = make_settings("cpu", sun_elevation=-30.0, disable_shadows=1, resolution_scale=0.75)
    out = _render(*_cornell(use_drs_stress_test=True), settings)
    assert not bool(torch.isfinite(out["color"]).all())


def test_firefly_injection_and_magnitude():
    """Pixels under the 0.4% firefly mask carry 10^4 times the clean indirect
    signal, the others the clean one; the denoised output stays finite."""
    settings = make_settings("cpu", sun_elevation=-30.0, disable_shadows=1)
    out = _render(*_cornell(use_firefly_test=True), settings)
    clean = _render(*_cornell(), settings)
    d, d2 = out["gbuffer"]["diff_radiance"], clean["gbuffer"]["diff_radiance"]
    spike = rng.uniform1(torch.arange(RES * RES, dtype=torch.int32), torch.tensor(0), 555) < 0.004
    assert int(spike.sum()) > 0
    torch.testing.assert_close(d[~spike], d2[~spike], rtol=0.0, atol=1e-6)
    torch.testing.assert_close(d[spike], d2[spike] * 10000.0, rtol=1e-5, atol=0.0)
    assert bool(torch.isfinite(out["diff_radiance"]).all())


def test_material_id_stripes():
    out = _render(*_cornell(use_material_id_test=True), make_settings("cpu", sun_elevation=-30.0))
    mid = out["gbuffer"]["material_id"].reshape(RES, RES)
    assert set(mid.unique().tolist()) <= {0.0, 1.0}
    assert bool((mid[0] != mid[8]).all())


# ---- occlusion modes ----

def test_occlusion_functions_match_jax():
    rs = np.random.RandomState(3)
    hd = rs.uniform(0.0, 40.0, N).astype(np.float32)
    vz = rs.uniform(-30.0, 30.0, N).astype(np.float32)
    bdir, nrm = _unit(rs, N), _unit(rs, N)
    nh_w = jocc.norm_hitdist(jnp.asarray(hd), jnp.asarray(vz))
    nh = occlusion.norm_hitdist(_t(hd), _t(vz))
    _close(nh, nh_w)
    _close(occlusion.occlusion_from_hitdist(nh), jocc.occlusion_from_hitdist(nh_w))
    _close(occlusion.directional_occlusion(nh, _t(bdir), _t(nrm)),
           jocc.directional_occlusion(nh_w, jnp.asarray(bdir), jnp.asarray(nrm)))
    gb = {k: rs.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
          for k in ("direct_lighting", "emission", "diff_factor", "spec_factor")}
    d_occ, s_occ, sh = (rs.uniform(0.0, 1.0, N).astype(np.float32) for _ in range(3))
    _close(occlusion.compose_occlusion({k: _t(v) for k, v in gb.items()}, _t(d_occ), _t(s_occ), _t(sh)),
           jocc.compose_occlusion({k: jnp.asarray(v) for k, v in gb.items()}, jnp.asarray(d_occ),
                                  jnp.asarray(s_occ), jnp.asarray(sh)))
    assert occlusion.norm_hitdist(torch.tensor([0.0, 1.0, 5.0]), torch.full((3,), 2.0)).tolist()[0] == 0.0


@pytest.mark.parametrize("denoiser", [Denoiser.RELAX, Denoiser.REBLUR])
def test_occlusion_mode_renders_ao(denoiser):
    """OCCLUSION: the denoised planes are occlusion in [0, 1] with some
    variation; DIRECTIONAL_OCCLUSION gives another image, also finite."""
    settings = make_settings("cpu", sun_elevation=-30.0, disable_shadows=1)
    out = _render(*_cornell(nrd_mode=NrdMode.OCCLUSION, denoiser=denoiser), settings)
    occ = out["diff_radiance"]
    assert bool(torch.isfinite(out["color"]).all())
    assert float(occ.min()) >= 0.0 and float(occ.max()) <= 1.0 + 1e-5 and float(occ.std()) > 1e-3
    out2 = _render(*_cornell(nrd_mode=NrdMode.DIRECTIONAL_OCCLUSION, denoiser=denoiser), settings)
    assert bool(torch.isfinite(out2["color"]).all())
    assert not torch.allclose(out["color"], out2["color"])


# ---- hair and subsurface scattering ----

def test_hair_sss_functions_match_jax():
    """The BCSDF and the sampled direction within 1e-5: their Gaussian
    exp(-z^2 / 2) of asin's output multiplies the last-ULP differences of
    the two libraries' asin by up to z^2 (2.8e-6 relative seen on 2 of
    12,288 values); the profile and the wrap term within 1e-6."""
    rs = np.random.RandomState(4)
    wi, wo, tng = _unit(rs, N), _unit(rs, N), _unit(rs, N)
    bc = rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    rough = rs.uniform(0.0, 1.0, N).astype(np.float32)
    _close(hair_sss.hair_bcsdf_eval(_t(wi), _t(wo), _t(tng), _t(bc), _t(rough)),
           jhair.hair_bcsdf_eval(jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(tng),
                                 jnp.asarray(bc), jnp.asarray(rough)), tol=1e-5)
    rnd = rs.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    d, w = hair_sss.hair_sample(_t(rnd), _t(wo), _t(tng), _t(rough))
    dw, ww = jhair.hair_sample(jnp.asarray(rnd), jnp.asarray(wo), jnp.asarray(tng),
                               jnp.asarray(rough))
    _close(d, dw, tol=1e-5)
    _close(w, ww)
    r = rs.uniform(0.0, 3.0, N).astype(np.float32)
    _close(hair_sss.burley_profile(_t(r), 0.3), jhair.burley_profile(jnp.asarray(r), 0.3))
    ndl = rs.uniform(-1.0, 1.0, N).astype(np.float32)
    for sd in (0.0, 0.3, 0.8):
        _close(hair_sss.sss_wrap_diffuse(_t(ndl), _t(bc), sd),
               jhair.sss_wrap_diffuse(jnp.asarray(ndl), jnp.asarray(bc), sd))


def test_burley_profile_normalizes():
    r = torch.linspace(1e-4, 10.0, 20000)
    dr = float(r[1] - r[0])
    assert float((2.0 * np.pi * r * hair_sss.burley_profile(r, 0.3)).sum()) * dr == pytest.approx(
        1.0, abs=0.02)


@pytest.mark.parametrize("with_tangent", [True, False])
def test_hair_sss_lighting_matches_jax(with_tangent):
    """direct_sun_lighting with flags (hair, skin, neither), with the hit's
    tangent and with the orthonormal-basis fallback."""
    rs = np.random.RandomState(5)
    n, v, tng = _unit(rs, N), _unit(rs, N), _unit(rs, N)
    bc = rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    metal = rs.uniform(0.0, 1.0, N).astype(np.float32)
    rough = rs.uniform(0.02, 1.0, N).astype(np.float32)
    flags = rs.choice([jconfig.FLAG_NON_TRANSPARENT, jconfig.FLAG_HAIR, jconfig.FLAG_SKIN,
                       jconfig.FLAG_HAIR | jconfig.FLAG_SKIN], N).astype(np.int32)
    sun = np.float32([0.3, -0.4, 0.866])
    sun /= np.linalg.norm(sun)
    got = lighting.direct_sun_lighting(_t(n), _t(v), _t(bc), _t(metal), _t(rough), _t(sun), 0.005,
                                       flags=_t(flags), tangent=_t(tng) if with_tangent else None)
    want = jlighting.direct_sun_lighting(
        jnp.asarray(n), jnp.asarray(v), jnp.asarray(bc), jnp.asarray(metal), jnp.asarray(rough),
        jnp.asarray(sun), 0.005, flags=jnp.asarray(flags),
        tangent=jnp.asarray(tng) if with_tangent else None)
    _close(got, want, tol=1e-5)
    plain = lighting.direct_sun_lighting(_t(n), _t(v), _t(bc), _t(metal), _t(rough), _t(sun), 0.005)
    other = torch.from_numpy((flags & (jconfig.FLAG_HAIR | jconfig.FLAG_SKIN)) == 0)
    assert torch.equal(got[other], plain[other]) and not torch.allclose(got[~other], plain[~other])


def test_decode_hit_tangent_matches_jax():
    jscene = jtraversal.build_context(jproc.shader_balls(grid=1, sphere_res=16))[1]
    ctx, scene = traversal.build_context(procedural.shader_balls(grid=1, sphere_res=16), device="cpu")
    assert ctx.mode == "dense"
    jc = jlook_at([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], fov_y_deg=50.0)
    cam = look_at([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], fov_y_deg=50.0, device="cpu")
    pix = np.arange(RES * RES, dtype=np.int32)
    o, d, _ = camera.camera_rays(cam, RES, RES, _t(pix), torch.tensor(0))
    hit = traversal.closest_hit(ctx, o, d)
    sun = config.sun_direction(config.Settings())
    props = gbuffer.decode_hit(scene, hit, o, d, sun, 0.005, with_tangent=True)
    jprops = jgbuffer.decode_hit(jscene, {k: jnp.asarray(v.numpy()) for k, v in hit.items()},
                                 jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                 jnp.asarray(sun.numpy()), 0.005)
    assert int((~props["miss"]).sum()) > 100
    _close(props["tangent"], jprops["tangent"], tol=1e-5)


# ---- the checkerboard (HALF) resolve ----

@pytest.mark.parametrize("frame_index", [0, 1, 6])
def test_checkerboard_mask_and_resolve_match_jax(frame_index):
    h, w = 24, 40
    cb = checkerboard.checkerboard_mask(h, w, torch.tensor(frame_index, dtype=torch.int32))
    cbw = jcb.checkerboard_mask(h, w, jnp.int32(frame_index))
    _close(cb, cbw)
    rs = np.random.RandomState(frame_index)
    for shape in ((h, w), (h, w, 3)):
        img = rs.uniform(0.0, 3.0, shape).astype(np.float32)
        _close(checkerboard.resolve(_t(img), cb), jcb.resolve(jnp.asarray(img), cbw))
        _close(checkerboard.resolve(_t(img), ~cb), jcb.resolve(jnp.asarray(img), ~cbw))
    px = torch.arange(w, dtype=torch.int32)
    py = torch.arange(h, dtype=torch.int32)
    assert torch.equal(cb, rng.checkerboard(px[None, :], py[:, None], frame_index).to(torch.bool))


def test_resolve_fills_holes_exactly():
    cb = checkerboard.checkerboard_mask(8, 8, torch.tensor(0))
    img = torch.where(cb[..., None], 2.0, 0.0) * torch.ones(8, 8, 3)
    torch.testing.assert_close(checkerboard.resolve(img, cb), torch.full((8, 8, 3), 2.0))


def test_half_mode_renders_without_holes():
    """HALF tracing with RELAX: finite, and no checkerboard left in the
    image (the two parities' means of the interior within 25%)."""
    out = _render(*_cornell(bounce_num=2, tracing_mode=TracingMode.HALF),
                  make_settings("cpu", sun_elevation=-30.0, disable_shadows=1))
    img = out["color"].reshape(RES, RES, 3)
    assert bool(torch.isfinite(img).all())
    cb = checkerboard.checkerboard_mask(RES, RES, torch.tensor(0))[4:-4, 4:-4]
    interior = img[4:-4, 4:-4].mean(-1)
    m0, m1 = float(interior[cb].mean()), float(interior[~cb].mean())
    assert abs(m0 - m1) / max(m0, m1) < 0.25


# ---- the L1 cache ----

def _l1_inputs(seed):
    """Cameras (JAX, port) whose previous frame looks from the side, hits
    on the plane y = 0 with random normals, and a history whose depth plane
    is that plane's view-z from the previous camera (with random sun-side
    signs), so that many reprojections are accepted."""
    rs = np.random.RandomState(seed)
    w, h, aspect = 40, 24, 40 / 24
    eye, target = [0.2, -3.0, 1.2], [0.0, 0.0, 1.0]
    prev_eye = [0.35, -3.1, 1.25]
    jc = jlook_at(eye, target, fov_y_deg=45.0, aspect=aspect)
    prev = jlook_at(prev_eye, target, fov_y_deg=45.0, aspect=aspect)
    jc = dataclasses.replace(jc, view_to_world_prev=prev.view_to_world)
    cam = look_at(eye, target, fov_y_deg=45.0, aspect=aspect, device="cpu")
    cam = dataclasses.replace(cam, view_to_world_prev=_t(np.array(prev.view_to_world)))
    n = 2000
    x = np.stack([rs.uniform(-0.8, 0.8, n), np.zeros(n), rs.uniform(0.5, 1.6, n)], -1)
    props = {"x": x.astype(np.float32), "n": _unit(rs, n), "miss": rs.rand(n) < 0.1,
             "curvature": rs.uniform(0.0, 3.0, n).astype(np.float32),
             "roughness": rs.uniform(0.0, 1.0, n).astype(np.float32)}
    v2w = np.asarray(prev.view_to_world, np.float64)
    tan = float(np.asarray(prev.tan_half_fov_y))
    u = (np.arange(w) + 0.5) / w
    v = (np.arange(h) + 0.5) / h
    dv = np.stack(np.broadcast_arrays(((u * 2 - 1) * tan * aspect)[None, :],
                                      ((1 - v * 2) * tan)[:, None], 1.0), -1)
    dw = dv @ v2w[:3, :3].T
    depth = -v2w[1, 3] / dw[..., 1]          # view-z where the texel's ray meets y = 0
    packed = rs.uniform(0.0, 2.0, (h, w, 7)).astype(np.float32)
    packed[..., 0] = depth * np.where(rs.rand(h, w) < 0.5, -1.0, 1.0)
    pix = rs.randint(0, w * h, n).astype(np.int32)
    sun = np.float32([0.3, -0.4, 0.866])
    sun /= np.linalg.norm(sun)
    return jc, cam, props, packed, pix, sun


def _close_but_steps(got, want):
    """Within 1e-6 but on 0.5% of the values, and those within the frame
    tolerance: the camera transforms of the two packages (XLA's dot, the
    port's per-component sum) differ in the last ULP, and the view-z
    agreement weight is a linear step of slope 200 on their difference."""
    g, w = got.numpy(), np.asarray(want)
    far = ~np.isclose(g, w, rtol=TOL, atol=TOL)
    assert far.reshape(len(g), -1).any(-1).mean() <= OUTLIER_FRAC
    assert _outlier_frac(w, g) <= OUTLIER_FRAC


@pytest.mark.parametrize("valid", [0, 1])
def test_l1_reprojection_matches_jax(valid):
    jc, cam, props, packed, pix, sun = _l1_inputs(6)
    jh = jl1.L1History(packed=jnp.asarray(packed), valid=jnp.int32(valid))
    h = l1cache.L1History(packed=_t(packed), valid=torch.tensor(valid, dtype=torch.int32))
    jp = {k: jnp.asarray(v) for k, v in props.items()}
    tp = {k: _t(v) for k, v in props.items()}
    want = jl1.reproject_irradiance(jh, jc, jp, jnp.asarray(pix), 40, 24, jnp.asarray(sun),
                                    jnp.float32(0.9))
    got = l1cache.reproject_irradiance(h, cam, tp, _t(pix), 40, 24, _t(sun), torch.tensor(0.9))
    for g, w in zip(got, want):
        _close_but_steps(g, w)
    assert (int((got[2] > 0).sum()) > 50) == bool(valid)
    want = jl1.radiance_from_previous_frame(jh, jc, jp, jnp.asarray(pix), 40, 24,
                                            jnp.asarray(sun), jnp.float32(0.9))
    got = l1cache.radiance_from_previous_frame(h, cam, tp, _t(pix), 40, 24, _t(sun),
                                               torch.tensor(0.9))
    for g, w in zip(got, want):
        _close_but_steps(g, w)


def test_l1_update_history_matches_jax():
    rs = np.random.RandomState(7)
    h, w = 24, 40
    cd, cs = (rs.uniform(0.0, 3.0, (h * w, 3)).astype(np.float32) for _ in range(2))
    vz = rs.uniform(-20.0, 20.0, h * w).astype(np.float32)
    nrm = _unit(rs, h * w)
    sun = np.float32([0.0, 0.6, 0.8])
    jc = jlook_at([0.0, -3.0, 1.0], [0.0, 0.0, 1.0])
    cam = look_at([0.0, -3.0, 1.0], [0.0, 0.0, 1.0], device="cpu")
    want = jl1.update_history(jc, jnp.asarray(cd), jnp.asarray(cs), jnp.asarray(vz),
                              jnp.asarray(nrm), jnp.asarray(sun), h, w)
    got = l1cache.update_history(cam, _t(cd), _t(cs), _t(vz), _t(nrm), _t(sun), h, w)
    _close(got.packed, want.packed)
    assert int(got.valid) == int(want.valid) == 1
    fresh = l1cache.L1History.create(h, w, device="cpu")
    jfresh = jl1.L1History.create(h, w)
    _close(fresh.packed, jfresh.packed)
    assert int(fresh.valid) == int(jfresh.valid) == 0


# ---- the PSR walk ----

MIRROR_CAM = dict(eye=[0.0, -4.0, 2.5], target=[0.0, 0.0, 0.5], fov_y_deg=45.0)


@pytest.fixture(scope="module")
def mirror():
    jctx, jscene = jtraversal.build_context(jproc.mirror_room(), mode="dense")
    ctx, scene = traversal.build_context(procedural.mirror_room(), mode="dense", device="cpu")
    return (jctx, jscene), (ctx, scene)


def _primary(ctx, scene, cam, settings):
    pix = torch.arange(RES * RES, dtype=torch.int32)
    o, d, _ = camera.camera_rays(cam, RES, RES, pix, torch.tensor(0, dtype=torch.int32))
    sun = config.sun_direction(settings)
    tan_sun = torch.tan(torch.deg2rad(settings.sun_angular_diameter * 0.5))
    props = gbuffer.decode_hit(scene, traversal.closest_hit(ctx, o, d), o, d, sun, tan_sun)
    return props, sun, tan_sun


@pytest.mark.parametrize("bounces", [1, 2])
def test_psr_walk_matches_jax(mirror, bounces):
    (jctx, jscene), (ctx, scene) = mirror
    jc, cam = jlook_at(**MIRROR_CAM), look_at(**MIRROR_CAM, device="cpu")
    js = JSettings(sun_elevation=jnp.float32(50.0), disable_shadows=jnp.int32(1))
    settings = make_settings("cpu", sun_elevation=50.0, disable_shadows=1)
    jcfg = JRenderConfig(width=RES, height=RES, psr_bounce_num=bounces)
    cfg = RenderConfig(width=RES, height=RES, psr_bounce_num=bounces)
    pix = jnp.arange(RES * RES, dtype=jnp.int32)
    jo, jd, _ = jcam.camera_rays(jc, RES, RES, pix, jnp.int32(0))
    jsun = jconfig.sun_direction(js)
    jtan = jnp.tan(jnp.deg2rad(js.sun_angular_diameter * 0.5))
    jprops = jgbuffer.decode_hit(jscene, jtraversal.closest_hit(jctx, jo, jd), jo, jd, jsun, jtan)
    want = jtrace.psr_walk(jctx, jscene, jcfg, js, jnp.int32(0), pix, jprops, None, jc, jsun,
                           jtan, jcam.unproject_scale(jc, RES))
    props, sun, tan_sun = _primary(ctx, scene, cam, settings)
    got = trace_opaque.psr_walk(ctx, scene, cfg, settings, cam, props, sun, tan_sun,
                                camera.unproject_scale(cam, RES))
    delta = trace_opaque.is_delta(props)
    assert np.array_equal(delta.numpy(), np.asarray(jtrace.is_delta(jprops)))
    assert int(delta.sum()) > 100
    for g, w in zip(got[1:], want[1:]):
        assert _outlier_frac(w, g.numpy()) <= OUTLIER_FRAC
    for k in ("x", "n", "t", "base_color", "roughness", "lemi"):
        assert _outlier_frac(want[0][k], got[0][k].numpy()) <= OUTLIER_FRAC, k
    assert np.array_equal(np.asarray(want[0]["miss"]), got[0]["miss"].numpy())


def _trace(ctx, scene, cam, psr):
    cfg = RenderConfig(width=RES, height=RES, psr_bounce_num=psr)
    return trace_opaque.trace_opaque(ctx, scene, cam, cfg,
                                     make_settings("cpu", sun_elevation=50.0, disable_shadows=1),
                                     torch.tensor(0, dtype=torch.int32))


def test_psr_trace_matches_jax(mirror):
    """trace_opaque with the walk: the virtual view-z, position, unfolded
    normal, motion, PSR throughput and emission against the JAX trace,
    with the camera moved since the previous frame."""
    (jctx, jscene), (ctx, scene) = mirror
    prev = dict(MIRROR_CAM, eye=[0.4, -4.0, 2.5])
    jc = dataclasses.replace(jlook_at(**MIRROR_CAM), view_to_world_prev=jlook_at(**prev).view_to_world)
    cam = dataclasses.replace(look_at(**MIRROR_CAM, device="cpu"),
                              view_to_world_prev=look_at(**prev, device="cpu").view_to_world)
    want = jtrace.trace_opaque(jctx, jscene, jc, JRenderConfig(width=RES, height=RES, psr_bounce_num=2),
                               JSettings(sun_elevation=jnp.float32(50.0),
                                         disable_shadows=jnp.int32(1)), jnp.int32(0))
    got = _trace(ctx, scene, cam, 2)
    for k in ("view_z", "primary_x", "normal", "mv", "mv_world", "primary_t", "psr_throughput",
              "l_psr", "diff_radiance", "spec_radiance"):
        assert _outlier_frac(want[k], got[k].numpy()) <= OUTLIER_FRAC, k


def test_psr_virtual_placement_and_normal(mirror):
    """Mirror pixels move to the virtual point: farther than the mirror,
    below its plane, on the camera ray; pixels that see the box's bottom in
    the mirror export the unfolded normal +z."""
    _, (ctx, scene) = mirror
    cam = look_at(**MIRROR_CAM, device="cpu")
    gb0, gb1 = _trace(ctx, scene, cam, 0), _trace(ctx, scene, cam, 1)
    vz0, vz1 = gb0["view_z"], gb1["view_z"]
    psr_px = ((vz1 - vz0).abs() > 1e-3) & torch.isfinite(vz0) & torch.isfinite(vz1)
    assert int(psr_px.sum()) > 10
    assert bool((vz1[psr_px] > vz0[psr_px] + 1e-3).all())
    x_virt = gb1["primary_x"]
    assert bool((x_virt[psr_px, 2] < 1e-3).all())
    _, d, _ = camera.camera_rays(cam, RES, RES, torch.arange(RES * RES, dtype=torch.int32),
                                 torch.tensor(0))
    off = torch.nn.functional.normalize(x_virt[psr_px] - cam.view_to_world[:3, 3], dim=-1)
    assert float(torch.linalg.cross(off, d[psr_px]).abs().max()) < 1e-3
    bottom = psr_px & (x_virt[:, 0].abs() < 0.45) & (x_virt[:, 1].abs() < 0.45) & (x_virt[:, 2] < -0.5)
    assert int(bottom.sum()) > 4
    assert bool((gb1["normal"][bottom, 2] > 0.9).all())


def test_dense_scan_chunks_equal_the_loop():
    """The plain dense scan gives the same bits whether it tests a chunk of
    triangles a step or loops over them one at a time (a chunk of one, the
    size it takes at the kernel comparisons' millions of rays)."""
    tr = procedural.cornell_box_glass().tris
    rs = np.random.RandomState(8)
    o = _t(rs.uniform(-0.9, 0.9, (3000, 3)).astype(np.float32) + np.float32([0, 0, 1]))
    d = _t(_unit(rs, 3000))
    tm = _t(rs.uniform(0.1, 3.0, 3000).astype(np.float32))
    for t_max in (intersect.T_MAX, tm):
        a = intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2, t_max)
        old = intersect.CHUNK_PAIRS
        intersect.CHUNK_PAIRS = 1
        try:
            b = intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2, t_max)
        finally:
            intersect.CHUNK_PAIRS = old
        assert int((a["tri"] >= 0).sum()) > 1000
        for k in a:
            assert torch.equal(a[k], b[k]), k
