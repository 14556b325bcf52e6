"""The warp walk of the two packet kernels (``csrc/packet_walk.cuh``, shared by
``csrc/packet_hit_stream.cu`` and the resident ``csrc/packet_hit.cu``)
against the plain scan: on the small exterior (3,196 opaque and 1,488 glass
triangles clustered together: 37 clusters) with the supercluster stage 1
forced, as exterior720 takes it, and on the small shader balls (1,792
triangles, 14 clusters) with the flat stage 1, as shaderballs512 takes it
to the resident kernel.

``_walk`` is a test-only PyTorch model of the kernels' walk: groups of rays
(32, a warp, or 128, the whole packet) walk their packet's worklist from
``packet.worklists`` in order; a group stops when the next key is at or past
its largest best t, in any-hit mode also once its rays are all blocked. With
``cull`` (the kernels' walk) a ray tests a cluster only while its entry into
the cluster's box (``cluster._cluster_entry``) is below its best t, and a
blocked ray tests nothing in any-hit mode; without it (the packet walk of
the resident kernel's first design) every ray of the group tests every
cluster the group visits. Hits fold in with a strict t < best, the first in
walk order winning. A group that tests a cluster counts group size x 128
ray/triangle tests, what the card executes.

Three ray sets of 4,096 per scene: the camera's rays at 64x64 (exterior720's
camera on the exterior, the shader-ball view of the card-vs-CPU frame on the
balls), a divergent set (origins all over the scene, random directions,
half with a short t_max) re-binned by morton order as the frame does, and
the any-hit mode on that set. The model of the walk must agree with the
plain scan under the rule of ``tests/test_torch_world_exterior_scene.py``
(hit/miss equal, ``tri`` equal except float64-proven ties, t within 1e-6),
and make no more tests than the packet walk. The ``cuda`` cases hold the
kernels themselves against the plain scan on the same rays and worklists
(the resident kernel also with ``need_uv=False``: zero u/v, the same t and
tri), and skip where there is no card.

The slice-4 and later test files are named ``test_torch_world_*`` so that
they sort after the other port files."""

import numpy as np
import pytest
import torch

from nrdsample_tpu_torch.ops import cluster, intersect, packet
from nrdsample_tpu_torch.pipeline import bench_configs
from nrdsample_tpu_torch.scene import camera, procedural
from nrdsample_tpu_torch.scene.types import look_at
from torch_session_cache import session_cached, share_cores_between_workers

share_cores_between_workers()

SMALL = dict(cobbles=8, tree_count=6, tree_res=8, lamp_count=4)
N_RAYS = 4096
T_MAX = intersect.T_MAX


@pytest.fixture(scope="module")
def small_exterior():
    """(ClusterSet, padded triangles as numpy planes) of the small exterior,
    all 4,684 triangles in one set."""
    cs, tris, _ = cluster.build_clusters(procedural.exterior(**SMALL).tris)
    assert cs.count == 37
    return cs, {k: getattr(tris, k).numpy() for k in ("p0", "e1", "e2")}


def _ray_sets(cs, cam_view, lo, hi, t_short: float, seed: int):
    """{name: (origin, direction, t_max, any_hit)} in packet order: the rays
    of the camera (eye, target, fov) at 64x64, and a divergent set with
    origins uniform in the box [lo, hi] and half of its t_max uniform in
    [0.5, t_short]."""
    eye, target, fov = cam_view
    w, h = 64, N_RAYS // 64
    cam = look_at(eye, target, fov_y_deg=fov, aspect=w / h, device="cpu")
    co, cd, _ = camera.camera_rays(cam, w, h, torch.arange(N_RAYS, dtype=torch.int32),
                                   torch.tensor(0))
    rs = np.random.RandomState(seed)
    vo = rs.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    vd = rs.randn(N_RAYS, 3).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    vtm = np.where(rs.uniform(size=N_RAYS) < 0.5, np.float32(T_MAX),
                   rs.uniform(0.5, t_short, N_RAYS)).astype(np.float32)
    vo, vd, vtm = (torch.from_numpy(a) for a in (vo, vd, vtm))
    perm = torch.sort(packet._morton_sort_keys(vo, vd, cs), stable=True).indices
    vo, vd, vtm = vo[perm].contiguous(), vd[perm].contiguous(), vtm[perm].contiguous()
    return {"camera": (co.contiguous(), cd.contiguous(), torch.full((N_RAYS,), T_MAX), False),
            "divergent": (vo, vd, vtm, False),
            "any_hit": (vo, vd, vtm, True)}


def _walk(cs, o, d, tm, order, keys, group: int, cull: bool, any_hit: bool):
    """The model of the walk; returns (dict(t, u, v, tri), tests)."""
    r, c = order.shape[0] * packet.BLOCK_RAYS, order.shape[1]
    n_groups = r // group
    entry = cluster._cluster_entry(o, d, cs.bounds_min, cs.bounds_max, tm)   # (R, C)
    pk = torch.arange(n_groups) * group // packet.BLOCK_RAYS
    rays = torch.arange(r).reshape(n_groups, group)
    tmg = tm.reshape(n_groups, group)
    bt, bu, bv = tmg.clone(), torch.zeros_like(tmg), torch.zeros_like(tmg)
    bi = torch.full((n_groups, group), -1, dtype=torch.int32)
    alive = torch.ones(n_groups, dtype=torch.bool)
    tests = 0
    for i in range(c):
        alive &= keys[pk, i] < bt.amax(dim=1)
        if any_hit:
            alive &= (bt >= tmg).any(dim=1)
        cid = order[pk, i].long()
        if cull:
            e = entry[rays, cid[:, None]]
            active = (e < T_MAX) & (e < bt) & ~(any_hit & (bt < tmg))
        else:
            active = torch.ones_like(bt, dtype=torch.bool)
        active &= alive[:, None]
        g = torch.nonzero(active.any(dim=1)).flatten()
        if len(g) == 0:
            if not alive.any():
                break
            continue
        tests += len(g) * group * cluster.CLUSTER_SIZE
        gr, gc = rays[g], cid[g]
        ox, oy, oz = (o[gr, k][..., None] for k in range(3))
        dx, dy, dz = (d[gr, k][..., None] for k in range(3))
        planes = [p[gc][:, None, :, k] for p in (cs.p0_b, cs.e1_b, cs.e2_b) for k in range(3)]
        t, u, v, hit = intersect.mt_intersect(ox, oy, oz, dx, dy, dz, *planes)
        hit = hit & active[g][..., None] & (t < bt[g][..., None])
        t = torch.where(hit, t, torch.inf)
        arg = torch.argmin(t, dim=-1, keepdim=True)   # the first of equal t: walk order
        tmin = torch.gather(t, -1, arg)[..., 0]
        closer = tmin < bt[g]
        bt[g] = torch.where(closer, tmin, bt[g])
        bu[g] = torch.where(closer, torch.gather(u, -1, arg)[..., 0], bu[g])
        bv[g] = torch.where(closer, torch.gather(v, -1, arg)[..., 0], bv[g])
        tri = (gc[:, None] * cluster.CLUSTER_SIZE + arg[..., 0]).to(torch.int32)
        bi[g] = torch.where(closer, tri, bi[g])
    res = {"t": bt.flatten(), "u": bu.flatten(), "v": bv.flatten(), "tri": bi.flatten()}
    return res, tests


def _t64(o, d, tris, j):
    p0, e1, e2 = (tris[k][j].astype(np.float64) for k in ("p0", "e1", "e2"))
    pv = np.cross(d.astype(np.float64), e2)
    return float(e2 @ np.cross(o.astype(np.float64) - p0, e1)) / float(e1 @ pv)


def _assert_agree(got, want, o, d, tm, tris, any_hit):
    """The rule of tests/test_torch_world_exterior_scene.py; in any-hit mode
    the blocked flags equal the plain any-hit scan's."""
    got = {k: v.cpu() for k, v in got.items()}
    if any_hit:
        assert torch.equal((got["tri"] >= 0) & (got["t"] < tm), want)
        return
    gt, wt = got["tri"].numpy(), want["tri"].numpy()
    np.testing.assert_array_equal(gt >= 0, wt >= 0)
    on, dn = o.numpy(), d.numpy()
    for i in np.nonzero(gt != wt)[0]:
        ta, tb = _t64(on[i], dn[i], tris, int(gt[i])), _t64(on[i], dn[i], tris, int(wt[i]))
        assert abs(ta - tb) <= 1e-6 * max(abs(ta), 1.0), f"ray {i}: not a tie ({ta} vs {tb})"
    np.testing.assert_allclose(got["t"].numpy(), want["t"].numpy(), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def walks(small_exterior, tmp_path_factory):
    """Per ray set: the rays, the supercluster worklists, the plain scan's
    result and the two walks' (result, tests); computed once per session."""
    return session_cached(tmp_path_factory, "torch_warp_walk",
                          lambda: _exterior_walks(small_exterior[0]))


def _walks(cs, ray_sets):
    """Per ray set: the rays, stage 1's worklists, the plain scan's result and
    the two walks' (result, tests)."""
    out = {}
    for name, (o, d, tm, any_hit) in ray_sets.items():
        order, keys = packet.worklists(o, d, cs, tm)
        plain = (cluster.any_hit_clustered(cs, o, d, tm) if any_hit
                 else cluster.closest_hit_clustered(cs, o, d, tm))
        out[name] = dict(rays=(o, d, tm), any_hit=any_hit, order=order, keys=keys,
                         plain=plain,
                         warp=_walk(cs, o, d, tm, order, keys, 32, True, any_hit),
                         packet=_walk(cs, o, d, tm, order, keys, 128, False, any_hit))
    return out


def _exterior_walks(cs):
    # 37 clusters above 16: the supercluster stage 1, as exterior720 takes it
    flat_max = packet.FLAT_WORKLIST_MAX_C
    packet.FLAT_WORKLIST_MAX_C = 16
    try:
        return _walks(cs, _ray_sets(cs, bench_configs.CONFIGS["exterior720"]["cam"],
                                    [-40.0, -40.0, 0.05], [40.0, 40.0, 15.0], 30.0, 11))
    finally:
        packet.FLAT_WORKLIST_MAX_C = flat_max


@pytest.fixture(scope="module")
def shader_balls():
    """(ClusterSet, padded triangles as numpy planes) of the small shader
    balls: 14 clusters, the flat stage 1."""
    cs, tris, _ = cluster.build_clusters(procedural.shader_balls(grid=2, sphere_res=12).tris)
    assert cs.count == 14
    return cs, {k: getattr(tris, k).numpy() for k in ("p0", "e1", "e2")}


@pytest.fixture(scope="module")
def ball_walks(shader_balls, tmp_path_factory):
    """``walks`` on the small shader balls; computed once per session."""
    cs = shader_balls[0]
    view = ([0.0, -9.0, 4.5], [0.0, 0.0, 0.8], 50.0)   # the card-vs-CPU frame's
    return session_cached(tmp_path_factory, "torch_warp_walk_balls",
                          lambda: _walks(cs, _ray_sets(cs, view, [-3.0, -3.0, 0.02],
                                                       [3.0, 3.0, 1.8], 10.0, 12)))


SETS = ["camera", "divergent", "any_hit"]


def _assert_walk_agrees(w, tris):
    o, d, tm = w["rays"]
    got = w["warp"][0]
    assert int((got["tri"] >= 0).sum()) > N_RAYS // 8
    _assert_agree(got, w["plain"], o, d, tm, tris, w["any_hit"])


@pytest.mark.parametrize("name", SETS)
def test_warp_walk_agrees_with_plain_scan(walks, small_exterior, name):
    _assert_walk_agrees(walks[name], small_exterior[1])


def _assert_fewer_tests(w, tris, label):
    """The per-ray cull and the per-warp stop only drop tests. The packet
    walk itself agrees with the plain scan too (it was the resident kernel's
    first walk)."""
    warp_tests, packet_tests = w["warp"][1], w["packet"][1]
    print(f"[warp walk] {label}: {warp_tests} tests, packet walk {packet_tests} "
          f"({packet_tests / warp_tests:.2f}x)")
    assert 0 < warp_tests <= packet_tests
    o, d, tm = w["rays"]
    _assert_agree(w["packet"][0], w["plain"], o, d, tm, tris, w["any_hit"])


@pytest.mark.parametrize("name", SETS)
def test_warp_walk_makes_no_more_tests_than_packet_walk(walks, small_exterior, name):
    _assert_fewer_tests(walks[name], small_exterior[1], name)


@pytest.mark.parametrize("name", SETS)
def test_resident_walk_agrees_with_plain_scan(ball_walks, shader_balls, name):
    """The walk of the resident kernel on the flat stage 1's worklists."""
    _assert_walk_agrees(ball_walks[name], shader_balls[1])


@pytest.mark.parametrize("name", SETS)
def test_resident_walk_makes_no_more_tests_than_packet_walk(ball_walks, shader_balls, name):
    _assert_fewer_tests(ball_walks[name], shader_balls[1], f"shader balls {name}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS)
def test_streaming_kernel_agrees_with_plain_scan_on_card(cuda_device, walks, small_exterior,
                                                          name):
    """The kernel on the card, on the same rays and worklists."""
    cs, tris = small_exterior
    w = walks[name]
    o, d, tm = w["rays"]
    dev = cuda_device
    before = packet.STREAM_LAUNCHES
    got = packet.launch_stream(cs.to(dev), o.to(dev), d.to(dev), tm.to(dev), w["order"].to(dev),
                               w["keys"].to(dev), w["any_hit"], not w["any_hit"])
    assert packet.STREAM_LAUNCHES == before + 1
    _assert_agree(got, w["plain"], o, d, tm, tris, w["any_hit"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS)
def test_resident_kernel_agrees_with_plain_scan_on_card(cuda_device, ball_walks, shader_balls,
                                                        name):
    """The resident kernel on the card, on the same rays and worklists; with
    need_uv=False it gives the same t and tri and zero u/v."""
    cs, tris = shader_balls
    w = ball_walks[name]
    o, d, tm = w["rays"]
    dev = cuda_device
    args = (cs.to(dev), o.to(dev), d.to(dev), tm.to(dev), w["order"].to(dev), w["keys"].to(dev),
            w["any_hit"])
    before = packet.LAUNCHES
    got = packet.launch(*args)
    no_uv = packet.launch(*args, need_uv=False)
    assert packet.LAUNCHES == before + 2
    _assert_agree(got, w["plain"], o, d, tm, tris, w["any_hit"])
    for k in ("t", "tri"):
        assert torch.equal(no_uv[k], got[k])
    assert not bool(no_uv["u"].any()) and not bool(no_uv["v"].any())
