"""The port's hit decode, emissive-IS reservoir and TraceOpaque pass against
the JAX package's, on the same scenes, cameras and settings.

decode_hit is fed the same hits on both sides and agrees within 1e-5
abs/rel (sky pow/exp2 and rsqrt differ by a few float32 ULPs between XLA
and torch). The reservoir and the full trace make discrete choices (lobe,
reservoir take, edge hits) that an ULP can flip, so per output plane at most
0.5% of pixels may differ by more than 1e-3 * (1 + |ref|).

Pixels whose primary ray is an exact tie — it meets two triangles at the
same float64 distance, i.e. passes through a shared edge — are left out of
that count: there float32 rounding alone picks the triangle, and XLA's fused
code (FMA contraction, reciprocal multiplies) rounds differently from the
port's unfused arithmetic. On the 24x24 Cornell box, whose symmetric pixel
grid puts 3 of 576 rays on the wall/ceiling edges, their share is bounded
by 1%."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu import config as jconfig
from nrdsample_tpu.denoise.reblur import spec_magic_curve as jspec_magic_curve
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline.replay import cfg_from_render
from nrdsample_tpu.render import emissive_is as jem, gbuffer as jgbuffer, trace_opaque as jtrace
from nrdsample_tpu.scene import camera as jcam, procedural as jproc
from nrdsample_tpu.scene.types import look_at as jlook_at
from nrdsample_tpu_torch import config, convert
from nrdsample_tpu_torch.denoise.reblur import spec_magic_curve
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.render import emissive_is, gbuffer, trace_opaque
from nrdsample_tpu_torch.scene import camera
from torch_session_cache import session_cached, share_cores_between_workers

share_cores_between_workers()

OUTLIER_FRAC = 0.005
DECODE_TOL = 1e-5

SETUPS = {
    # scene, camera (eye, target, fov), settings: the bench's cornell256 and
    # kitchen configs (the kitchen with the sun up and shadows on)
    "cornell": (jproc.cornell_box, ([0.0, -3.2, 1.0], [0.0, 0.0, 1.0], 39.0),
                dict(sun_elevation=jnp.float32(-30.0), disable_shadows=jnp.int32(1))),
    "kitchen": (jproc.kitchen, ([0.0, -1.6, 1.6], [0.0, 1.5, 1.2], 65.0),
                dict(sun_elevation=jnp.float32(35.0))),
}


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


def _setup(name):
    scene_fn, (eye, target, fov), skw = SETUPS[name]
    jctx, jscene = jtraversal.build_context(scene_fn())
    jc = jlook_at(eye=eye, target=target, fov_y_deg=fov)
    js = jconfig.Settings(**skw)
    ctx, scene = traversal.build_context(convert.scene_from_numpy(_np_leaves(jscene), device="cpu"),
                                         device="cpu")
    return (jctx, jscene, jc, js), (ctx, scene, convert.camera_from_numpy(_np_leaves(jc), device="cpu"),
                                    convert.settings_from_numpy(_np_leaves(js), device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _outlier_frac(ref, got, skip=None):
    """Share of pixels (rows) off by more than 1e-3 * (1 + |ref|); rows in
    ``skip`` count as agreeing."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    bad = (np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))).reshape(ref.shape[0], -1).any(-1)
    if skip is not None:
        bad &= ~skip
    return bad.mean()


def _primary(name, res=16):
    (jctx, jscene, jc, js), port = _setup(name)
    pix = jnp.arange(res * res, dtype=jnp.int32)
    o, d, _ = jcam.camera_rays(jc, res, res, pix, jnp.int32(2))
    hit = jtraversal.closest_hit(jctx, o, d)
    sun = jconfig.sun_direction(js)
    tan_sun = jnp.tan(jnp.deg2rad(js.sun_angular_diameter * 0.5))
    return (jctx, jscene, jc, js), port, (pix, o, d, hit, sun, tan_sun)


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_decode_hit_matches(name):
    (_, jscene, _, js), (_, scene, _, s), (pix, o, d, hit, sun, tan_sun) = _primary(name)
    want = jgbuffer.decode_hit(jscene, hit, o, d, sun, tan_sun, False, js.emission_intensity,
                               forced_material=js.forced_material,
                               emission_scale_cubes=js.emission_intensity_cubes)
    got = gbuffer.decode_hit(scene, {k: _t(v) for k, v in hit.items()}, _t(o), _t(d), _t(sun),
                             _t(tan_sun), False, s.emission_intensity,
                             forced_material=s.forced_material,
                             emission_scale_cubes=s.emission_intensity_cubes)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.dtype == {"b": torch.bool, "i": torch.int32, "f": torch.float32}[w.dtype.kind], k
        np.testing.assert_allclose(v.numpy(), w, rtol=DECODE_TOL, atol=DECODE_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["cornell", "kitchen"])
def test_reservoir_sample_direction_matches(name):
    (_, jscene, _, js), (_, scene, _, s), (pix, o, d, hit, sun, tan_sun) = _primary(name)
    props = jgbuffer.decode_hit(jscene, hit, o, d, sun, tan_sun)
    is_diffuse = np.random.RandomState(5).uniform(size=pix.shape[0]) < 0.5
    jem_set = jem.build_emissive_set(jscene, js.emission_intensity)
    want_ray, want_mult = jem.reservoir_sample_direction(
        props, jem_set, jnp.asarray(is_diffuse), pix, jnp.int32(2), 10_152, 16, 0.95,
        spec_k_scale=jspec_magic_curve(props["roughness"]))
    tprops = {k: _t(v) for k, v in props.items()}
    em = emissive_is.build_emissive_set(scene, s.emission_intensity)
    got_ray, got_mult = emissive_is.reservoir_sample_direction(
        tprops, em, torch.from_numpy(is_diffuse), _t(pix), torch.tensor(2, dtype=torch.int32),
        10_152, 16, 0.95, spec_k_scale=spec_magic_curve(tprops["roughness"]))
    assert got_ray.dtype == torch.float32 and got_mult.dtype == torch.float32
    assert _outlier_frac(want_ray, got_ray.numpy()) <= OUTLIER_FRAC
    assert _outlier_frac(want_mult, got_mult.numpy()) <= OUTLIER_FRAC
    assert (np.asarray(want_mult) != 1.0).any()  # some candidates saw a light


def _t64(o, d, tris, j):
    """Float64 Möller-Trumbore distance of ray (o, d) to triangle j."""
    p0, e1, e2 = (tris[k][j].astype(np.float64) for k in ("p0", "e1", "e2"))
    pv = np.cross(d.astype(np.float64), e2)
    return float(e2 @ np.cross(o.astype(np.float64) - p0, e1)) / float(e1 @ pv)


def _primary_ties(want_tri, got_tri, origin, direction, tris):
    """Pixels whose primary triangles differ only by an exact tie."""
    ties = np.zeros(len(got_tri), bool)
    for i in np.nonzero(want_tri != got_tri)[0]:
        a, b = int(got_tri[i]), int(want_tri[i])
        if a >= 0 and b >= 0:
            ta, tb = _t64(origin[i], direction[i], tris, a), _t64(origin[i], direction[i], tris, b)
            ties[i] = abs(ta - tb) <= 1e-6 * max(abs(ta), 1.0)
    return ties


@pytest.fixture(scope="module", params=["cornell", "kitchen"])
def traced(request, tmp_path_factory):
    return session_cached(tmp_path_factory, f"torch_trace_{request.param}",
                          lambda: _traced(request.param))


def _traced(name):
    """(name, JAX gbuffer, port gbuffer, tie pixels) of trace_opaque at
    24x24, frame 3."""
    res, frame = 24, 3
    (jctx, jscene, jc, js), (ctx, scene, tc, s) = _setup(name)
    jcfg = cfg_from_render({}, res=res)
    fn = jax.jit(lambda sc, c, st: jtrace.trace_opaque(jctx, sc, c, jcfg, st, jnp.int32(frame)))
    want = jax.tree.map(np.asarray, fn(jscene, jc, js))
    frame_t = torch.tensor(frame, dtype=torch.int32)
    got = trace_opaque.trace_opaque(ctx, scene, tc, config.RenderConfig(width=res, height=res), s,
                                    frame_t)
    o, d, _ = camera.camera_rays(tc, res, res, torch.arange(res * res, dtype=torch.int32), frame_t)
    tris = {k: getattr(scene.tris, k).numpy() for k in ("p0", "e1", "e2")}
    ties = _primary_ties(want["tri"], got["tri"].numpy(), o.numpy(), d.numpy(), tris)
    assert ties.mean() <= 0.01
    return name, want, got, ties


PLANES = ["view_z", "mv", "normal", "roughness", "metalness", "base_color", "material_id",
          "direct_lighting", "emission", "shadow", "shadow_hit_dist", "miss", "primary_x",
          "primary_t", "uv", "tri", "flags", "curvature", "diff_radiance", "spec_radiance",
          "diff_hitdist", "spec_hitdist", "diff_factor", "spec_factor", "diff_dir", "spec_dir"]


@pytest.mark.parametrize("plane", PLANES)
def test_trace_opaque_planes_match(traced, plane):
    name, want, got, ties = traced
    w, g = np.asarray(want[plane]), got[plane]
    assert g.dtype == {"b": torch.bool, "i": torch.int32, "f": torch.float32}[w.dtype.kind]
    assert tuple(g.shape) == w.shape
    assert _outlier_frac(w, g.numpy(), ties) <= OUTLIER_FRAC, f"{name}: {plane}"


def test_trace_opaque_shadow_ray_matches(traced):
    name, want, got, ties = traced
    for w, g in zip(want["shadow_ray"], got["shadow_ray"]):
        assert _outlier_frac(w, g.numpy(), ties) <= OUTLIER_FRAC, name
