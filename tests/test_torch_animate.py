"""The animate path of the port (``scene/animation.py``, ``scene/instances.py``,
the ``dynamics`` of ``trace_opaque`` / ``render_frame``, ``pipeline/animate.py``)
against the JAX package's, on the same inputs.

The cases of tests/test_instances.py hold for the port, and: the orbit pool
of a seed is the JAX package's bit for bit; orbit transforms, the sun and
camera drivers, ``transform_scene`` and the refit's boxes, blocks, slab and
supercluster boxes (dense and cluster mode) agree within 1e-6 * (1 + |x|);
``prev_position``, rotations included, within 1e-5; closest hits on the
moved geometry agree in ``tri`` except on ties proven in float64 (t within
1e-6 relative on both triangles); stage 1 treats the refit's padding
(3e37) as the build's (inf); ``decode_hit``'s instance scales, with and
without textures, within 1e-5; and three animated RELAX frames at 48x48 with
three cubes, the motion plane of the moving cubes included, within the frame
tolerance of PERF.md §2 (per plane at most 0.5% of pixels off by more than
1e-3 * (1 + |ref|)). Both packages animate the same pool and instance ids:
the JAX package's are carried across (``convert``). The JAX frames are
session-cached."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.config import Denoiser as JDenoiser, RenderConfig as JRenderConfig
from nrdsample_tpu.config import Settings as JSettings, TracingMode as JTracingMode
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.pipeline import adaptive as jadaptive, frame as jframe
from nrdsample_tpu.render import gbuffer as jgbuffer
from nrdsample_tpu.scene import animation as janimation, instances as jinstances
from nrdsample_tpu.scene import procedural as jproc, textures as jtex, types as jtypes
from nrdsample_tpu_torch import config, convert
from nrdsample_tpu_torch.ops import cluster, packet, traversal
from nrdsample_tpu_torch.pipeline import adaptive, animate, frame
from nrdsample_tpu_torch.render import gbuffer
from nrdsample_tpu_torch.scene import animation, instances, textures
from torch_session_cache import (declare, jax_native_order_ready, session_cached,
                                 share_cores_between_workers)

share_cores_between_workers()

XF_TOL = 1e-6          # x 1 + |x|
PREV_TOL = 1e-5
DECODE_TOL = 1e-5      # tests/test_torch_trace.py's bound
OUTLIER_FRAC = 0.005
FRAME_RES, FRAME_CUBES, FRAMES = 48, 3, 3
MOVE_CUBES = 70        # 852 triangles: dense mode, or 7 clusters and one padded slot
PLANES = ["color", "final", "diff_radiance", "spec_radiance", "view_z", "normal", "mv"]


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, tol, what=""):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_array_less(np.abs(got - want), tol * (1.0 + np.abs(want)) + 1e-30,
                                 err_msg=what)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def _scene_leaves(scene):
    out = {"tris": _leaves(scene.tris), "materials": _leaves(scene.materials),
           "emissive_tris": np.asarray(scene.emissive_tris),
           "emissive_count": np.asarray(scene.emissive_count),
           "has_emissive": scene.has_emissive}
    for k in ("tri_instance", "instance_scales"):
        if getattr(scene, k) is not None:
            out[k] = np.asarray(getattr(scene, k))
    return out


def _jax_cubes(n):
    """cli.cmd_animate's scene through the JAX package: (scene, ids)."""
    parts_v, parts_i, mats_id, inst_id = [], [], [], []
    gv, gi = jproc.make_box([0, 0, -1.0], [30, 30, 0.5])
    parts_v.append(gv)
    parts_i.append(gi)
    mats_id += [0] * len(gi)
    inst_id += [0] * len(gi)
    off = len(gv)
    for k in range(n):
        cv, ci = jproc.make_box([0, 0, 0], [0.8, 0.8, 0.8])
        parts_v.append(cv)
        parts_i.append(ci + off)
        mats_id += [1 + (k % 3)] * len(ci)
        inst_id += [1 + k] * len(ci)
        off += len(cv)
    tris = jtypes.build_triangle_soa(np.concatenate(parts_v), np.concatenate(parts_i), None, None,
                                     np.array(mats_id, np.int32))
    mats = jtypes.Materials(
        base_color=np.array([[0.55, 0.55, 0.55], [0.8, 0.25, 0.2], [0.2, 0.6, 0.85],
                             [0.9, 0.75, 0.2]], np.float32),
        metalness=np.array([0.0, 0.1, 0.6, 0.9], np.float32),
        roughness=np.array([0.8, 0.4, 0.3, 0.2], np.float32),
        emission=np.zeros((4, 3), np.float32), ior=np.full(4, 1.5, np.float32),
        flags=np.full(4, 1, np.int32))
    return jtypes.make_scene(tris, mats), np.array(inst_id, np.int32)


def _jax_transforms(pool, t):
    return jnp.concatenate([jinstances.identity_transforms(1),
                            janimation.orbit_transforms(pool, jnp.float32(t))], axis=0)


class _Both:
    """The cubes scene of ``n`` cubes built by both packages in ``mode``,
    with the JAX pool and instance ids carried across to the port."""

    def __init__(self, n, mode):
        jscene, ids = _jax_cubes(n)
        self.jctx, jscene = jtraversal.build_context(jscene, mode=mode)
        self.jinst = jinstances.assign_instance_ids(jscene, ids, self.jctx)
        self.jpool = janimation.generate_orbit_pool(n, extent=6.0, seed=3)
        scene, port_ids = animate.cubes_scene(n)
        np.testing.assert_array_equal(port_ids, ids)
        self.ctx, scene = traversal.build_context(scene, mode=mode, device="cpu")
        own = instances.assign_instance_ids(scene, port_ids, self.ctx)
        self.inst = convert.instanced_scene_from_numpy(
            {"scene": _scene_leaves(jscene), "instance_id": np.asarray(self.jinst.instance_id),
             "n_instances": self.jinst.n_instances}, device="cpu")
        np.testing.assert_array_equal(own.instance_id.numpy(), self.inst.instance_id.numpy())
        assert own.n_instances == self.inst.n_instances == n + 1
        for k in ("p0", "e1", "e2", "n0"):
            np.testing.assert_array_equal(getattr(scene.tris, k).numpy(),
                                          getattr(self.inst.scene.tris, k).numpy())
        self.pool = convert.orbit_pool_from_numpy(_leaves(self.jpool), device="cpu")

    def at(self, t):
        """(port world, port refit ctx, JAX world, JAX refit ctx) at t."""
        m = animate.transforms(self.pool, t)
        world = instances.transform_scene(self.inst, m)
        jm = _jax_transforms(self.jpool, t)
        jworld = jinstances.transform_scene(self.jinst, jm)
        return (world, instances.refit_context(self.ctx, world), jworld,
                jinstances.refit_context(self.jctx, jworld))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jax_native_order_ready(tmp_path_factory)
    return {mode: _Both(MOVE_CUBES, mode) for mode in ("dense", "cluster")}


# ---- scene/animation.py ----


def test_orbit_pool_is_the_jax_pool():
    for n, extent, seed in ((16, 10.0, 0), (512, 6.0, 3)):
        got = animation.generate_orbit_pool(n, extent, seed, device="cpu")
        want = janimation.generate_orbit_pool(n, extent, seed)
        for k, v in _leaves(want).items():
            np.testing.assert_array_equal(getattr(got, k).numpy(), v, err_msg=k)


@pytest.mark.parametrize("t", [0.0, 0.7, 5.3, 41.0])
def test_orbit_transforms_match_jax(t):
    pool = janimation.generate_orbit_pool(64, 6.0, 3)
    got = animation.orbit_transforms(convert.orbit_pool_from_numpy(_leaves(pool), "cpu"), t)
    _close(got, janimation.orbit_transforms(pool, jnp.float32(t)), XF_TOL)
    # rigid: each rotation is the pool's scale times an orthonormal matrix
    rot = got[..., :3] / torch.from_numpy(np.array(pool.scale))[:, None, None]
    _close(rot @ rot.transpose(-1, -2), torch.eye(3).expand(64, 3, 3), 1e-5)


def test_orbit_positions_return_after_a_period():
    pool = animation.generate_orbit_pool(16, seed=3, device="cpu")
    pa = animation.orbit_transforms(pool, 0.0)[..., 3]
    pb = animation.orbit_transforms(pool, float(pool.period[0]))[..., 3]
    assert animation.orbit_transforms(pool, 0.0).shape == (16, 3, 4)
    np.testing.assert_allclose(pa[0].numpy(), pb[0].numpy(), atol=1e-3)


def test_sun_camera_and_nine_brothers_match_jax():
    for t in (0.0, 3.0, 17.5):
        got, want = animation.animate_sun(-147.0, 45.0, t), janimation.animate_sun(
            -147.0, 45.0, jnp.float32(t))
        for a, b in zip(got, want):
            _close(a, b, XF_TOL)
        for mode in (1, 2, 3):
            eye = [0.0, -3.0, 1.0]
            _close(animation.emulate_camera_motion(torch.tensor(eye), t, mode=mode),
                   janimation.emulate_camera_motion(jnp.asarray(eye), jnp.float32(t), mode=mode),
                   XF_TOL)
    az0, _ = animation.animate_sun(-147.0, 45.0, 0.0)
    assert float(az0) == pytest.approx(-147.0, abs=1e-4)
    vecs = ([0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0])
    got = animation.nine_brothers_transforms(*(torch.tensor(v) for v in vecs))
    want = janimation.nine_brothers_transforms(*(jnp.asarray(v) for v in vecs))
    _close(got, want, XF_TOL)
    np.testing.assert_allclose(got[4, :, 3].numpy(), [0.0, 3.0, 0.0], atol=1e-5)


# ---- scene/instances.py ----


@pytest.mark.parametrize("mode", ["dense", "cluster"])
@pytest.mark.parametrize("t", [0.0, 2.5])
def test_transform_and_refit_match_jax(both, mode, t):
    b = both[mode]
    world, ctx2, jworld, jctx2 = b.at(t)
    for f in ("p0", "e1", "e2", "n0", "n1", "n2", "t0", "t1", "t2"):
        _close(getattr(world.tris, f), getattr(jworld.tris, f), XF_TOL, f)
        if f[0] in "nt" and t > 0:
            real = np.linalg.norm(_np(getattr(b.inst.scene.tris, f)), axis=-1) > 0  # not padding
            np.testing.assert_allclose(
                np.linalg.norm(_np(getattr(world.tris, f)), axis=-1)[real], 1.0, atol=1e-5)
    assert ctx2.mode == mode and ctx2.order is b.ctx.order and ctx2.emissive is None
    if mode == "dense":
        assert ctx2.tris is world.tris
        return
    cs, jcs = ctx2.clusters, jctx2.clusters
    for f in ("bounds_min", "bounds_max", "p0_b", "e1_b", "e2_b", "slab", "super_min", "super_max"):
        _close(getattr(cs, f), getattr(jcs, f), XF_TOL, f)
    assert cs.count == 7 and cs.super_min.shape == (1, 3)
    assert cs.slab.shape == (8 * 16, 128) and ctx2.tri_offset == 0


def test_refit_padding_is_stage_one_neutral(both):
    """The build pads boxes with inf, the refit (as the JAX package's) with
    3e37. At the rest pose both give the same cluster and supercluster
    boxes and slab, and the flat and the supercluster stage 1 the same
    worklists and hits. A padded slot by itself (an empty box over zero
    triangles) is entered alike under both paddings and never hit."""
    b = both["cluster"]
    rest = instances.refit_context(b.ctx, instances.transform_scene(
        b.inst, instances.identity_transforms(MOVE_CUBES + 1, device="cpu")))
    built, refit = b.ctx.clusters, rest.clusters
    for f in ("bounds_min", "bounds_max", "slab", "super_min", "super_max", "p0_b"):
        assert torch.equal(getattr(built, f), getattr(refit, f)), f
    rs = np.random.RandomState(4)
    o = torch.from_numpy(rs.uniform(-8, 8, (1024, 3)).astype(np.float32) + np.float32([0, 0, 6]))
    d = torch.nn.functional.normalize(torch.from_numpy(rs.randn(1024, 3).astype(np.float32)), dim=-1)
    tm = torch.full((1024,), traversal.T_MAX)
    for stage1 in (packet._block_worklists, packet._block_worklists_super):
        a, b_ = stage1(o, d, built, tm), stage1(o, d, refit, tm)
        assert torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1])
    hits = [cluster.closest_hit_clustered(cs, o, d) for cs in (built, refit)]
    assert all(torch.equal(hits[0][k], hits[1][k]) for k in hits[0])
    assert int((hits[0]["tri"] >= 0).sum()) > 100

    # one more cluster slot, padded: its box empty, its triangles zero
    def padded(cs, big):
        z = torch.zeros((1, 128, 3))
        cat = lambda a, v: torch.cat([a, v])   # noqa: E731
        return cluster.ClusterSet(
            bounds_min=cat(cs.bounds_min, torch.full((1, 3), big)),
            bounds_max=cat(cs.bounds_max, torch.full((1, 3), -big)),
            p0_b=cat(cs.p0_b, z), e1_b=cat(cs.e1_b, z), e2_b=cat(cs.e2_b, z),
            slab=torch.cat([cs.slab[:cs.count * 16], torch.zeros(16, 128),
                            cs.slab[cs.count * 16:]])[:cs.slab.shape[0]],
            super_min=cs.super_min, super_max=cs.super_max)

    sets = [padded(built, float("inf")), padded(refit, instances.PAD_BOUND)]
    entry = [cluster._cluster_entry(o, d, cs.bounds_min, cs.bounds_max, tm) for cs in sets]
    assert torch.equal(entry[0], entry[1])
    for cs in sets:
        got = cluster.closest_hit_clustered(cs, o, d)
        assert all(torch.equal(got[k], hits[0][k]) for k in got)
        assert torch.equal(cluster.any_hit_clustered(cs, o, d, tm),
                           cluster.any_hit_clustered(built, o, d, tm))
    flat = [packet._block_worklists(o, d, cs, tm) for cs in sets]
    assert torch.equal(flat[0][0], flat[1][0]) and torch.equal(flat[0][1], flat[1][1])


def test_prev_position_matches_jax(both):
    b = both["dense"]
    rs = np.random.RandomState(7)
    m_prev, m_curr = animate.transforms(b.pool, 1.0), animate.transforms(b.pool, 1.5)
    # a rotation and a non-uniform scale on two instances as well
    rot = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    m_curr[1, :, :3] = rot
    m_curr[2, :, :3] = torch.diag(torch.tensor([2.0, 0.5, 1.5]))
    tri = torch.from_numpy(rs.randint(-1, b.inst.instance_id.shape[0], 4096).astype(np.int32))
    x = torch.from_numpy(rs.uniform(-10, 10, (4096, 3)).astype(np.float32))
    got = instances.prev_position(b.inst, m_curr, m_prev, x, tri)
    want = jinstances.prev_position(b.jinst, jnp.asarray(m_curr.numpy()),
                                    jnp.asarray(m_prev.numpy()), jnp.asarray(x.numpy()),
                                    jnp.asarray(tri.numpy()))
    _close(got, want, PREV_TOL)
    assert torch.equal(got[tri < 0], x[tri < 0])


def test_prev_position_tracks_motion():
    """tests/test_instances.py's cases through the port: a translated box
    maps back by the motion, the static ground keeps its points, a miss
    passes through, and a rotation is undone."""
    scene, ids = animate.cubes_scene(1)
    ctx, scene = traversal.build_context(scene, mode="dense", device="cpu")
    inst = instances.assign_instance_ids(scene, ids, ctx)
    box_tri = int(np.nonzero(ids == 1)[0][0])
    ground_tri = int(np.nonzero(ids == 0)[0][0])
    m_prev = instances.identity_transforms(2, device="cpu")
    m_curr = instances.identity_transforms(2, device="cpu")
    m_curr[1, 0, 3] = 2.0
    xp = instances.prev_position(inst, m_curr, m_prev, torch.tensor([[2.5, 0.0, 0.0]]),
                                 torch.tensor([box_tri], dtype=torch.int32))
    np.testing.assert_allclose(xp[0].numpy(), [0.5, 0.0, 0.0], atol=1e-5)
    xg = torch.tensor([[5.0, 1.0, -1.75]])
    for tri in (ground_tri, -1):
        xp = instances.prev_position(inst, m_curr, m_prev, xg,
                                     torch.tensor([tri], dtype=torch.int32))
        np.testing.assert_allclose(xp[0].numpy(), xg[0].numpy(), atol=1e-6)
    rot = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    m_curr = instances.identity_transforms(2, device="cpu")
    m_curr[1, :, :3] = rot
    p_local = torch.tensor([0.5, 0.25, 0.1])
    xp = instances.prev_position(inst, m_curr, m_prev, (rot @ p_local)[None],
                                 torch.tensor([box_tri], dtype=torch.int32))
    np.testing.assert_allclose(xp[0].numpy(), p_local.numpy(), atol=1e-5)


def _t64(o, d, p0, e1, e2):
    """Float64 Moller-Trumbore distance of a ray to a triangle."""
    o, d, p0, e1, e2 = (np.asarray(a, np.float64) for a in (o, d, p0, e1, e2))
    pv = np.cross(d, e2)
    return float(e2 @ np.cross(o - p0, e1)) / float(e1 @ pv)


@pytest.mark.parametrize("mode", ["dense", "cluster"])
def test_hits_on_moved_geometry_match_jax(both, mode):
    """Rays into the moved cubes hit what the JAX package's refit context
    hits: tri equal, or a tie proven in float64; the boxes moved (the hits
    differ from the rest pose's)."""
    b = both[mode]
    world, ctx2, jworld, jctx2 = b.at(3.0)
    rs = np.random.RandomState(11)
    n = 2048
    o = np.tile(np.float32([0.0, -16.0, 8.0]), (n, 1))
    d = rs.uniform([-0.45, 1.0, -0.8], [0.45, 1.0, -0.2], (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = traversal.closest_hit(ctx2, torch.from_numpy(o), torch.from_numpy(d))
    want = jtraversal.closest_hit(jctx2, jnp.asarray(o), jnp.asarray(d))
    gt, wt = got["tri"].numpy(), np.asarray(want["tri"])
    np.testing.assert_array_equal(gt >= 0, wt >= 0)
    tris = {k: _np(getattr(world.tris, k)) for k in ("p0", "e1", "e2")}
    for i in np.nonzero(gt != wt)[0]:
        ta, tb = (_t64(o[i], d[i], *(tris[k][j] for k in ("p0", "e1", "e2"))) for j in (gt[i], wt[i]))
        assert abs(ta - tb) <= 1e-6 * max(abs(tb), 1.0), (i, gt[i], wt[i], ta, tb)
    same = gt == wt
    _close(got["t"].numpy(), want["t"], XF_TOL)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k].numpy()[same], np.asarray(want[k])[same], atol=1e-4)
    cube_hits = int((b.inst.instance_id.numpy()[np.clip(gt, 0, None)] > 0)[gt >= 0].sum())
    assert cube_hits > 50
    rest = traversal.closest_hit(b.ctx, torch.from_numpy(o), torch.from_numpy(d))["tri"].numpy()
    assert (rest != gt).mean() > 0.05


@pytest.mark.parametrize("textured", [False, True], ids=["plain", "textured"])
def test_decode_hit_instance_scales_match_jax(both, textured):
    """The per-instance material scales of decode_hit (and, textured, the
    normal map's second fetch at the uv times normalUvScale) against JAX."""
    b = both["dense"]
    rs = np.random.RandomState(5)
    scales = rs.uniform(0.3, 1.5, (MOVE_CUBES + 1, 10)).astype(np.float32)
    scene, ids = animate.cubes_scene(MOVE_CUBES)
    scene = dataclasses.replace(scene, tri_instance=torch.from_numpy(ids),
                                instance_scales=torch.from_numpy(scales))
    if textured:
        scene = textures.textured_scene(scene, res=16, seed=2)
    ctx, scene = traversal.build_context(scene, mode="dense", device="cpu")
    js = dict(_scene_leaves(scene))
    jscene = jtypes.Scene(
        tris=jtypes.TriangleSoA(**{k: jnp.asarray(v) for k, v in js["tris"].items()}),
        materials=jtypes.Materials(**{k: jnp.asarray(v) for k, v in js["materials"].items()}),
        emissive_tris=jnp.asarray(js["emissive_tris"]),
        emissive_count=jnp.asarray(js["emissive_count"]),
        tri_instance=jnp.asarray(ids), instance_scales=jnp.asarray(scales),
        textures=None if not textured else jtex.TextureSet(
            levels=[jnp.asarray(lv.numpy()) for lv in scene.textures.levels]))
    n = 1024
    o = np.tile(np.float32([0.0, -16.0, 8.0]), (n, 1))
    d = rs.uniform([-0.45, 1.0, -0.8], [0.45, 1.0, -0.2], (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = traversal.closest_hit(ctx, torch.from_numpy(o), torch.from_numpy(d))
    sun = torch.tensor([0.3, -0.4, 0.866])
    cone = torch.full((n,), 0.01)
    got = gbuffer.decode_hit(scene, hit, torch.from_numpy(o), torch.from_numpy(d), sun, 0.01,
                             cone_width=cone, use_normal_map=1.0)
    want = jgbuffer.decode_hit(jscene, {k: jnp.asarray(v.numpy()) for k, v in hit.items()},
                               jnp.asarray(o), jnp.asarray(d), jnp.asarray(sun.numpy()),
                               jnp.float32(0.01), cone_width=jnp.asarray(cone.numpy()),
                               use_normal_map=jnp.float32(1.0))
    for k in ("base_color", "roughness", "metalness", "lemi", "n", "curvature"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=DECODE_TOL,
                                   atol=DECODE_TOL, err_msg=k)
    # the scales reach the result: without them the base colour differs
    plain = gbuffer.decode_hit(dataclasses.replace(scene, instance_scales=None), hit,
                               torch.from_numpy(o), torch.from_numpy(d), sun, 0.01,
                               cone_width=cone, use_normal_map=1.0)
    assert not torch.equal(plain["base_color"], got["base_color"])
    if textured:
        assert not torch.equal(plain["n"], got["n"])


# ---- three animated frames, against the JAX package ----


def _frame_settings(jax_side: bool):
    """Settings(sun_elevation=55) after one adaptive step at a 40 ms frame."""
    if jax_side:
        return jadaptive.update(JSettings(sun_elevation=jnp.float32(55.0)), None, 40.0)
    return adaptive.update(config.make_settings("cpu", sun_elevation=55.0), None, 40.0)


def _jax_frames(tmp_path_factory):
    jax_native_order_ready(tmp_path_factory)
    jscene, ids = _jax_cubes(FRAME_CUBES)
    jctx, jscene = jtraversal.build_context(jscene, mode="cluster")
    jinst = jinstances.assign_instance_ids(jscene, ids, jctx)
    pool = janimation.generate_orbit_pool(FRAME_CUBES, extent=6.0, seed=3)
    cam = jtypes.look_at(eye=[0.0, -16.0, 8.0], target=[0.0, 0.0, 1.0], fov_y_deg=45.0)
    cfg = JRenderConfig(width=FRAME_RES, height=FRAME_RES, rpp=1, bounce_num=1,
                        tracing_mode=JTracingMode.FULL_PROBABILISTIC, denoiser=JDenoiser.RELAX)

    @jax.jit
    def step(t, t_prev, hist, settings):
        m_curr, m_prev = _jax_transforms(pool, t), _jax_transforms(pool, t_prev)
        world = jinstances.transform_scene(jinst, m_curr)
        return jframe.render_frame(jinstances.refit_context(jctx, world), world, cam, cfg,
                                   settings, hist, dynamics=(jinst, m_curr, m_prev))

    hist, settings, outs = jframe.History.create(cfg), _frame_settings(True), []
    for f in range(FRAMES):
        t, t_prev = animate.frame_times(f)
        out, hist = step(jnp.float32(t), jnp.float32(t_prev), hist, settings)
        planes = {k: np.asarray(out[k]) for k in PLANES if k != "mv"}
        planes["mv"] = np.asarray(out["gbuffer"]["mv"])
        outs.append(planes)
    return {"frames": outs, "instance_id": np.asarray(jinst.instance_id),
            "scene": _scene_leaves(jscene), "pool": _leaves(pool)}


declare("torch_animate_frames", _jax_frames, native_order=True)


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_animate_frames",
                          lambda: _jax_frames(tmp_path_factory))


@pytest.fixture(scope="module")
def port_frames(jax_frames):
    anim = animate.build(FRAME_CUBES, device="cpu")
    np.testing.assert_array_equal(anim.inst.instance_id.numpy(), jax_frames["instance_id"])
    anim = dataclasses.replace(
        anim, pool=convert.orbit_pool_from_numpy(jax_frames["pool"], "cpu"),
        inst=convert.instanced_scene_from_numpy(
            {"scene": jax_frames["scene"], "instance_id": jax_frames["instance_id"],
             "n_instances": FRAME_CUBES + 1}, "cpu"))
    cfg = animate.render_config(FRAME_RES, "relax")
    hist, settings, outs = frame.History.create(cfg, "cpu"), _frame_settings(False), []
    assert int(settings.max_accumulated_frame_num) == 12
    for f in range(FRAMES):
        out, hist = animate.render(anim, cfg, settings, hist, *animate.frame_times(f))
        outs.append(dict({k: out[k] for k in PLANES if k != "mv"}, mv=out["gbuffer"]["mv"]))
    return outs


def _outlier_frac(ref, got):
    ref = np.asarray(ref, np.float64).reshape(ref.shape[0], -1)
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    return (np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))).any(-1).mean()


@pytest.mark.parametrize("index", range(FRAMES))
@pytest.mark.parametrize("plane", PLANES)
def test_animated_frame_matches_jax(jax_frames, port_frames, index, plane):
    want, got = jax_frames["frames"][index][plane], port_frames[index][plane]
    assert tuple(got.shape) == want.shape and bool(torch.isfinite(got).all())
    assert _outlier_frac(want, got.numpy()) <= OUTLIER_FRAC


def test_moving_cubes_have_their_own_motion(port_frames):
    """The camera stands still: in the first frame (t_prev = t) nothing
    moves; from the second the motion vectors are zero on the ground and
    not on the moving cubes."""
    mv = port_frames[1]["mv"].numpy()
    moving = np.abs(mv[:, :2]).max(axis=-1) > 1e-3
    assert 0 < moving.sum() < 0.5 * len(mv)
    assert np.abs(port_frames[0]["mv"].numpy()[:, :2]).max() < 1e-3
