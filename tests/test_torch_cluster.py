"""The port's cluster-mode traversal against the JAX package's: the cluster
build, the packet kernel's stage 1, and the plain closest and any hit (the
versions the packet kernel is held to on the card).

Scenes: the shader balls at grid 2 (1,762 triangles, 14 clusters, so cluster
mode by default) and the Cornell box forced into cluster mode (36 triangles
padded to one 128-triangle cluster). The build and stage 1 are exact. The
hits are compared on 2,000 numpy-seeded rays: hit/miss equal on every ray,
``tri`` equal except where a float64 recompute proves an exact tie (the
packet walk, the per-ray scan and XLA's FMA-contracted arithmetic break such
ties differently), and t/u/v within 1e-5.

Cases marked ``cuda`` hold the packet kernel against the plain version on
the card and skip where there is none."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.ops import cluster as jcluster, packet as jpacket, traversal as jtraversal
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu_torch.ops import cluster, intersect, packet, traversal
from nrdsample_tpu_torch.scene import procedural
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

TOL = 1e-5
SCENES = {"shader_balls": lambda m: m.shader_balls(grid=2, sphere_res=12),
          "cornell_box": lambda m: m.cornell_box()}


@pytest.fixture(scope="module")
def builds():
    """{scene: (JAX (ClusterSet, tris, order), port (ClusterSet, tris, order))}."""
    return {name: (jcluster.build_clusters(make(jproc).tris),
                   cluster.build_clusters(make(procedural).tris))
            for name, make in SCENES.items()}


def _rays(n, seed):
    rs = np.random.RandomState(seed)
    o = rs.uniform([-3.0, -3.0, 0.05], [3.0, 3.0, 3.0], (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.where(rs.uniform(size=n) < 0.5, np.float32(intersect.T_MAX),
                  rs.uniform(0.2, 3.0, n)).astype(np.float32)
    return o, d, tm


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_build_clusters_matches_jax(builds, scene):
    (jcs, jtris, jorder), (cs, tris, order) = builds[scene]
    np.testing.assert_array_equal(order, np.asarray(jorder))
    for f in ("bounds_min", "bounds_max", "super_min", "super_max", "slab", "p0_b", "e1_b", "e2_b"):
        got, want = getattr(cs, f).numpy(), np.asarray(getattr(jcs, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in dataclasses.fields(tris):
        np.testing.assert_array_equal(getattr(tris, f.name).numpy(),
                                      np.asarray(getattr(jtris, f.name)), err_msg=f.name)
    assert cs.count == -(-len(order) // cluster.CLUSTER_SIZE)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_morton_keys_match_jax(builds, scene):
    (jcs, _, _), (cs, _, _) = builds[scene]
    o, d, _ = _rays(2000, 1)
    want = np.asarray(jpacket._morton_sort_keys(jnp.asarray(o), jnp.asarray(d), jcs))
    got = packet._morton_sort_keys(torch.from_numpy(o), torch.from_numpy(d), cs)
    assert got.dtype == torch.int64 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_block_worklists_match_jax(builds, scene):
    (jcs, _, _), (cs, _, _) = builds[scene]
    o, d, tm = _rays(2048, 2)
    jorder, jkeys, jcount = jpacket._block_worklists(jnp.asarray(o), jnp.asarray(d), jcs,
                                                     jnp.asarray(tm), 128)
    order, keys = packet._block_worklists(torch.from_numpy(o), torch.from_numpy(d), cs,
                                          torch.from_numpy(tm))
    assert order.dtype == torch.int32 and keys.dtype == torch.float32
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys))
    np.testing.assert_array_equal((keys < np.inf).sum(1).numpy(), np.asarray(jcount))
    assert np.asarray(jcount).max() > (0 if cs.count == 1 else 1)


def _t64(o, d, tris, j):
    """Float64 Möller-Trumbore distance of ray (o, d) to triangle j."""
    p0, e1, e2 = (tris[k][j].astype(np.float64) for k in ("p0", "e1", "e2"))
    pv = np.cross(d.astype(np.float64), e2)
    return float(e2 @ np.cross(o.astype(np.float64) - p0, e1)) / float(e1 @ pv)


def _assert_hits_agree(got, want, o, d, tris):
    """Hit/miss equal on every ray; tri equal except on float64-proven exact
    ties; t/u/v within TOL where tri is equal, t within TOL everywhere."""
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["tri"] >= 0, want["tri"] >= 0)
    differ = np.nonzero(got["tri"] != want["tri"])[0]
    assert len(differ) <= 0.01 * len(o)
    for i in differ:
        ta, tb = _t64(o[i], d[i], tris, int(got["tri"][i])), _t64(o[i], d[i], tris, int(want["tri"][i]))
        assert abs(ta - tb) <= 1e-6 * max(abs(ta), 1.0), f"ray {i}: not a tie ({ta} vs {tb})"
    np.testing.assert_allclose(got["t"], want["t"], rtol=TOL, atol=TOL)
    same = got["tri"] == want["tri"]
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_closest_hit_matches_clustered_jax(builds, scene):
    (jcs, jtris, _), (cs, tris, _) = builds[scene]
    o, d, tm = _rays(2000, 3)
    want = jcluster.closest_hit_clustered(jcs, jtris, *(jnp.asarray(a) for a in (o, d, tm)))
    got = cluster.closest_hit_clustered(cs, *(torch.from_numpy(a) for a in (o, d, tm)))
    assert got["tri"].dtype == torch.int32 and got["t"].dtype == torch.float32
    got = {k: v.numpy() for k, v in got.items()}
    assert (got["tri"] >= 0).sum() > 200
    _assert_hits_agree(got, want, o, d, {k: getattr(tris, k).numpy() for k in ("p0", "e1", "e2")})
    miss = got["tri"] < 0
    np.testing.assert_array_equal(got["t"][miss], tm[miss])


def test_plain_closest_hit_matches_packet_kernel(builds):
    """Against the JAX package's packet kernel in interpret mode (block 128,
    hoisted loop), without and with morton re-binning. Interpreting costs
    ~10 s a call on the CPU, so one call covers both: its first 1,024 rays
    are the seeded rays in their own order, the next 1,024 the same rays in
    the order of JAX's morton keys (a stable sort of ``_morton_sort_keys``,
    which the port matches bit for bit), which is what ``sort=True`` feeds
    the kernel."""
    (jcs, _, _), (cs, tris, _) = builds["shader_balls"]
    o, d, tm = _rays(1024, 3)
    perm = np.argsort(np.asarray(jpacket._morton_sort_keys(jnp.asarray(o), jnp.asarray(d), jcs)),
                      kind="stable")
    both = [np.concatenate([a, a[perm]]) for a in (o, d, tm)]
    res = jpacket.closest_hit_packet(jcs, *(jnp.asarray(a) for a in both), interpret=True,
                                     hoist=True)
    res = {k: np.asarray(v) for k, v in res.items()}
    unsorted = {k: v[:1024] for k, v in res.items()}
    resorted = {k: np.empty_like(v[1024:]) for k, v in res.items()}
    for k in res:
        resorted[k][perm] = res[k][1024:]
    got = cluster.closest_hit_clustered(cs, *(torch.from_numpy(a) for a in (o, d, tm)))
    got = {k: v.numpy() for k, v in got.items()}
    assert (got["tri"] >= 0).sum() > 100
    tris_np = {k: getattr(tris, k).numpy() for k in ("p0", "e1", "e2")}
    for want in (unsorted, resorted):
        _assert_hits_agree(got, want, o, d, tris_np)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plain_any_hit_matches_jax(builds, scene):
    (jcs, jtris, _), (cs, _, _) = builds[scene]
    o, d, tm = _rays(2000, 4)
    want = jcluster.any_hit_clustered(jcs, jtris, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    got = cluster.any_hit_clustered(cs, *(torch.from_numpy(a) for a in (o, d, tm)))
    assert got.dtype == torch.bool and 0 < int(got.sum()) < len(o)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunking_changes_no_result():
    cs, _, _ = cluster.build_clusters(procedural.shader_balls(grid=2, sphere_res=12).tris)
    o, d, tm = (torch.from_numpy(a) for a in _rays(1000, 5))
    whole = cluster.closest_hit_clustered(cs, o, d, tm)
    parts = cluster.closest_hit_clustered(cs, o, d, tm, ray_chunk=128)
    for k in whole:
        assert torch.equal(whole[k], parts[k])


def test_cluster_context_matches_jax_context():
    """build_context picks cluster mode above 1024 triangles, reorders and
    pads the scene as the JAX package does, and its queries run the plain
    versions on CPU rays without launching the kernel."""
    jctx, jscene = jtraversal.build_context(jproc.shader_balls(grid=2, sphere_res=12))
    ctx, scene = traversal.build_context(procedural.shader_balls(grid=2, sphere_res=12),
                                         device="cpu")
    assert ctx.mode == jctx.mode == "cluster" and ctx.clusters.count == 14
    np.testing.assert_array_equal(ctx.order, np.asarray(jctx.order))
    np.testing.assert_array_equal(scene.emissive_tris.numpy(), np.asarray(jscene.emissive_tris))
    np.testing.assert_array_equal(scene.tris.p0.numpy(), np.asarray(jscene.tris.p0))
    o, d, tm = (torch.from_numpy(a) for a in _rays(600, 6))
    before = packet.LAUNCHES
    a = traversal.closest_hit(ctx, o, d, tm)
    b = cluster.closest_hit_clustered(ctx.clusters, o, d, tm)
    for k in a:
        assert torch.equal(a[k], b[k])
    blocked, t = traversal.any_hit_t(ctx, o, d, tm)
    assert torch.equal(blocked, (b["tri"] >= 0) & (b["t"] < tm))
    assert torch.equal(traversal.any_hit(ctx, o, d, tm), cluster.any_hit_clustered(ctx.clusters, o, d, tm))
    assert packet.LAUNCHES == before


def test_packet_wrapper_refuses_cpu_tensors():
    cs, _, _ = cluster.build_clusters(procedural.cornell_box().tris)
    o, d, tm = (torch.from_numpy(a) for a in _rays(10, 7))
    with pytest.raises(ValueError):
        packet.closest_hit_packet_cuda(cs, o, d, tm)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["coherent", "sorted", "any_hit"])
def test_packet_kernel_matches_plain_on_card(cuda_device, mode):
    ctx, scene = traversal.build_context(procedural.shader_balls(grid=2, sphere_res=12),
                                         device=cuda_device)
    o, d, tm = (torch.from_numpy(a).to(cuda_device) for a in _rays(50_000, 8))
    want = cluster.closest_hit_clustered(ctx.clusters, o, d, tm)
    if mode == "any_hit":
        got = traversal.any_hit(ctx, o, d, tm)
        assert torch.equal(got, (want["tri"] >= 0) & (want["t"] < tm))
        return
    got = packet.closest_hit_packet_cuda(ctx.clusters, o, d, tm, sort=mode == "sorted")
    tris = {k: getattr(scene.tris, k).cpu().numpy() for k in ("p0", "e1", "e2")}
    _assert_hits_agree({k: v.cpu().numpy() for k, v in got.items()},
                       {k: v.cpu() for k, v in want.items()}, o.cpu().numpy(), d.cpu().numpy(), tris)
