"""The port's exterior scene and its traversal set-up against the JAX
package's: the C++ BVH order, ``procedural.exterior``,
``build_scene_contexts`` (the opaque and transparent ranges, their offsets,
the merged triangles and the emissive remap), the emissive ClusterSet, the
supercluster stage 1 of the packet kernels, and one call of the JAX
streaming packet kernel in interpret mode against the port's plain scan.

Scenes: the small exterior (``SMALL``: 3,196 opaque triangles in 25
clusters, 1,488 glass triangles in 12, 674 emitters; the stage-1 and hit
tests cluster all 4,684 triangles, 37 clusters) and the exterior at its
defaults (176,932 opaque triangles). The builds and stage 1 are exact; hits
are held as ``tests/test_torch_cluster.py`` holds them (hit/miss equal,
``tri`` equal except float64-proven ties, t within 1e-4 against the
interpret-mode kernel).

Cases marked ``cuda`` hold the streaming kernel against the plain scan on
the card, also on every ray where it differs from the resident kernel, and
skip where there is none.

The slice-4 test files are named ``test_torch_world_*`` so that they sort
after the other port files: the suite runs files in name order, and its
time limit then cuts these, the most costly, first."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.ops import cluster as jcluster, packet as jpacket, traversal as jtraversal
from nrdsample_tpu.render import emissive_is as jemissive_is
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu_torch import native
from nrdsample_tpu_torch.ops import cluster, intersect, packet, traversal
from nrdsample_tpu_torch.render import emissive_is
from nrdsample_tpu_torch.scene import bvh, procedural
from torch_session_cache import jax_native_order_ready, share_cores_between_workers

share_cores_between_workers()

SMALL = dict(cobbles=8, tree_count=6, tree_res=8, lamp_count=4)
SIZES = {"small": SMALL, "default": {}}


@functools.lru_cache(maxsize=None)
def _scenes(size):
    """(JAX scene, port scene) of one size, built once per worker."""
    return jproc.exterior(**SIZES[size]), procedural.exterior(**SIZES[size])


@functools.lru_cache(maxsize=None)
def _contexts(size):
    """(JAX (SceneContexts, scene), port (SceneContexts, scene)) of one size."""
    jscene, scene = _scenes(size)
    return (jtraversal.build_scene_contexts(jscene),
            traversal.build_scene_contexts(scene, device="cpu"))


def _rays(n, seed):
    rs = np.random.RandomState(seed)
    o = rs.uniform([-40.0, -40.0, 0.05], [40.0, 40.0, 15.0], (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    # the first quarter: coherent packets of camera-like rays
    q = n // 4
    o[:q] = np.float32([0.0, -45.0, 6.0])
    d[:q] = d[:q] * 0.05 + np.float32([0.0, 1.0, -0.05])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = np.where(rs.uniform(size=n) < 0.5, np.float32(intersect.T_MAX),
                  rs.uniform(0.5, 30.0, n)).astype(np.float32)
    return o, d, tm


@pytest.mark.parametrize("size", sorted(SIZES))
def test_exterior_matches_jax(size):
    """Leaf for leaf, with the same RandomState draws."""
    want, got = _scenes(size)
    for part in ("tris", "materials"):
        for f in dataclasses.fields(getattr(want, part)):
            g = getattr(getattr(got, part), f.name).numpy()
            w = np.asarray(getattr(getattr(want, part), f.name))
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    np.testing.assert_array_equal(got.emissive_tris.numpy(), np.asarray(want.emissive_tris))
    assert int(got.emissive_count) == int(want.emissive_count) > 512
    assert got.has_emissive and want.has_emissive


def test_native_order_equals_numpy_order_on_shader_balls():
    """The C++ builder and its plain numpy version give one order where the
    float32 split sweep does not round differently (13,250 triangles)."""
    tris = procedural.shader_balls(grid=3, sphere_res=24).tris
    p0, e1, e2 = (getattr(tris, k).numpy() for k in ("p0", "e1", "e2"))
    tmin = np.minimum(np.minimum(p0, p0 + e1), p0 + e2)
    tmax = np.maximum(np.maximum(p0, p0 + e1), p0 + e2)
    np.testing.assert_array_equal(native.build_order(tmin, tmax, 8),
                                  bvh.build_order(tmin, tmax, 8))


def test_jax_native_order_ready_drops_a_cached_none(tmp_path_factory, monkeypatch):
    """A process whose JAX loader cached ``None`` (it lost the compile race)
    gets the C++ builder back from the helper, and keeps it."""
    from nrdsample_tpu import native as jnative

    monkeypatch.setitem(jnative._LIBS, "bvh_builder", None)
    assert jnative.get_lib() is None
    lib = jax_native_order_ready(tmp_path_factory)
    assert lib is not None and jnative.get_lib() is lib
    assert jnative.build_order(np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32)) is not None


@pytest.mark.parametrize("size", sorted(SIZES))
def test_scene_contexts_match_jax(size, tmp_path_factory):
    """Both ranges' modes, orders, offsets and ClusterSets, the merged
    triangles and the emissive remap equal the JAX package's exactly; on
    the default exterior this is the order of the C++ builder over 176,932
    opaque triangles, where the numpy build orders 168 triangles otherwise."""
    jax_native_order_ready(tmp_path_factory)
    (jctxs, jscene), (ctxs, scene) = _contexts(size)
    for jctx, ctx in ((jctxs.opaque, ctxs.opaque), (jctxs.transparent, ctxs.transparent)):
        assert ctx.mode == jctx.mode == "cluster" and ctx.tri_offset == jctx.tri_offset
        np.testing.assert_array_equal(ctx.order, np.asarray(jctx.order))
        for f in ("bounds_min", "bounds_max", "super_min", "super_max", "slab"):
            np.testing.assert_array_equal(getattr(ctx.clusters, f).numpy(),
                                          np.asarray(getattr(jctx.clusters, f)), err_msg=f)
    assert ctxs.transparent.tri_offset == ctxs.opaque.tris.count > 0
    for f in dataclasses.fields(scene.tris):
        np.testing.assert_array_equal(getattr(scene.tris, f.name).numpy(),
                                      np.asarray(getattr(jscene.tris, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(scene.emissive_tris.numpy(), np.asarray(jscene.emissive_tris))
    # the emissive ClusterSet is built on the card only, as JAX builds it on the TPU only
    assert ctxs.opaque.emissive is None and getattr(jctxs.opaque, "emissive", None) is None


def test_emissive_cluster_set_matches_jax(monkeypatch, tmp_path_factory):
    """The emissive ClusterSet and its luminance, against the JAX package's
    build on the TPU path."""
    jscene, scene = _scenes("small")
    jax_native_order_ready(tmp_path_factory)
    monkeypatch.setattr(jtraversal, "_tpu_platform", lambda: True)
    want = jemissive_is.build_emissive_clusters(jscene)
    cs, lum = emissive_is.emissive_cluster_set(scene)
    assert cs.count == want["clusters"].count == 6
    for f in ("bounds_min", "bounds_max", "slab"):
        np.testing.assert_array_equal(getattr(cs, f).numpy(), np.asarray(getattr(want["clusters"], f)))
    np.testing.assert_array_equal(lum.numpy(), np.asarray(want["base_lum"]))
    assert emissive_is.build_emissive_clusters(scene, "cpu") is None


def test_cpu_probe_of_many_emitters_matches_jax():
    """More than 512 emitters on the CPU: the dense plain probe (in chunks)
    against the JAX package's dense probe."""
    jscene, scene = _scenes("small")
    # rays from near the street's centre towards the four lamps and the sign
    rs = np.random.RandomState(1)
    targets = np.float32([[36, 0, 4.2], [0, 36, 4.2], [-36, 0, 4.2], [0, -36, 4.2], [0, -50.4, 3.6]])
    o = rs.uniform([-2.0, -2.0, 3.0], [2.0, 2.0, 5.0], (3000, 3)).astype(np.float32)
    d = targets[rs.randint(0, 5, 3000)] + rs.randn(3000, 3).astype(np.float32) * 0.4 - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    want = np.asarray(jemissive_is.light_probe(jemissive_is.build_emissive_set(jscene),
                                               jnp.asarray(o), jnp.asarray(d)))
    got = emissive_is.light_probe(emissive_is.build_emissive_set(scene), torch.from_numpy(o),
                                  torch.from_numpy(d)).numpy()
    assert (want > 0).sum() > 10
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def small_clusters(tmp_path_factory):
    jscene, scene = _scenes("small")
    jax_native_order_ready(tmp_path_factory)
    jcs, _, _ = jcluster.build_clusters(jscene.tris)
    cs, tris, _ = cluster.build_clusters(scene.tris)
    return jcs, cs, tris


def test_super_worklists_match_jax(small_clusters, monkeypatch):
    """With FLAT_WORKLIST_MAX_C lowered below the small exterior's 37
    clusters, stage 1 takes the supercluster path in both packages; the
    port's (order, keys) equal JAX's ``_block_worklists_super`` on every
    entry, the T_MAX padding included."""
    jcs, cs, _ = small_clusters
    monkeypatch.setattr(packet, "FLAT_WORKLIST_MAX_C", 16)
    o, d, tm = _rays(4096, 2)
    jorder, jkeys, jcount = jpacket._block_worklists_super(jnp.asarray(o), jnp.asarray(d), jcs,
                                                          jnp.asarray(tm), 128)
    order, keys = packet.worklists(torch.from_numpy(o), torch.from_numpy(d), cs,
                                   torch.from_numpy(tm))
    jkeys = np.asarray(jkeys)
    live = jkeys < intersect.T_MAX
    assert live.sum() > 500 and np.asarray(jcount).max() > 1
    np.testing.assert_array_equal(order.numpy()[live], np.asarray(jorder)[live])
    np.testing.assert_array_equal(keys.numpy(), jkeys)


def test_super_worklists_conservative(small_clusters):
    """Every cluster the flat exact stage 1 lists, the supercluster stage 1
    lists too, with a key no larger (a lower bound of the same entry)."""
    _, cs, _ = small_clusters
    o, d, tm = (torch.from_numpy(a) for a in _rays(4096, 3))
    fo, fk = packet._block_worklists(o, d, cs, tm)
    so, sk = packet._block_worklists_super(o, d, cs, tm)
    n_flat = 0
    for b in range(fo.shape[0]):
        flat = {int(c): float(k) for c, k in zip(fo[b], fk[b]) if k < intersect.T_MAX}
        sup = {int(c): float(k) for c, k in zip(so[b], sk[b]) if k < intersect.T_MAX}
        assert set(flat) <= set(sup), b
        assert all(sup[c] <= k for c, k in flat.items()), b
        n_flat += len(flat)
    assert n_flat > 100


def _t64(o, d, tris, j):
    p0, e1, e2 = (tris[k][j].astype(np.float64) for k in ("p0", "e1", "e2"))
    pv = np.cross(d.astype(np.float64), e2)
    return float(e2 @ np.cross(o.astype(np.float64) - p0, e1)) / float(e1 @ pv)


def _assert_hits_agree(got, want, o, d, tris, tol, max_share=0.01):
    np.testing.assert_array_equal(got["tri"] >= 0, want["tri"] >= 0)
    differ = np.nonzero(got["tri"] != want["tri"])[0]
    assert len(differ) <= max_share * len(o)
    for i in differ:
        ta = _t64(o[i], d[i], tris, int(got["tri"][i]))
        tb = _t64(o[i], d[i], tris, int(want["tri"][i]))
        assert abs(ta - tb) <= 1e-6 * max(abs(ta), 1.0), f"ray {i}: not a tie ({ta} vs {tb})"
    np.testing.assert_allclose(got["t"], want["t"], rtol=tol, atol=tol)


def test_plain_scan_matches_streaming_kernel(small_clusters, monkeypatch):
    """One call of the JAX package's streaming packet kernel in interpret
    mode (its supercluster stage 1 forced by a lowered FLAT_WORKLIST_MAX_C)
    against the port's plain scan on 512 rays."""
    jcs, cs, tris = small_clusters
    monkeypatch.setattr(jpacket, "FLAT_WORKLIST_MAX_C", 16)
    o, d, tm = _rays(512, 4)
    want = jpacket.closest_hit_packet(jcs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                                      interpret=True, stream=True)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = cluster.closest_hit_clustered(cs, torch.from_numpy(o), torch.from_numpy(d),
                                        torch.from_numpy(tm))
    got = {k: v.numpy() for k, v in got.items()}
    assert (got["tri"] >= 0).sum() > 100
    _assert_hits_agree(got, want, o, d, {k: getattr(tris, k).numpy() for k in ("p0", "e1", "e2")},
                       1e-4)


def test_streaming_wrapper_refuses_cpu_tensors(small_clusters):
    _, cs, _ = small_clusters
    o, d, tm = (torch.from_numpy(a) for a in _rays(256, 5))
    with pytest.raises(ValueError):
        packet.closest_hit_packet_cuda(cs, o, d, tm, stream=True)
    with pytest.raises(ValueError):
        packet.launch_stream(cs, o, d, tm, *packet.worklists(o, d, cs, tm))


def test_stream_dispatch_follows_the_slab_size():
    """The JAX package's rule: the streaming kernel for slabs above
    PACKET_VMEM_LIMIT (exterior720's 67.7 MB), the resident one below."""
    assert packet.PACKET_VMEM_LIMIT == jtraversal.PACKET_VMEM_LIMIT == 48 << 20
    assert packet.FLAT_WORKLIST_MAX_C == jpacket.FLAT_WORKLIST_MAX_C
    cs, _, _ = cluster.build_clusters(procedural.cornell_box().tris)
    assert packet.vmem_table_bytes(cs) == 8 * 16 * 128 * 4   # one supercluster of slab
    assert 132_224 * 128 * 4 > packet.PACKET_VMEM_LIMIT


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["coherent", "sorted", "any_hit"])
def test_streaming_kernel_matches_plain_on_card(cuda_device, small_clusters, monkeypatch, mode):
    """The streaming kernel, behind the supercluster stage 1, against the
    plain scan on the card."""
    _, cs, tris = small_clusters
    cs = cs.to(cuda_device)
    monkeypatch.setattr(packet, "FLAT_WORKLIST_MAX_C", 16)
    o, d, tm = (torch.from_numpy(a).to(cuda_device) for a in _rays(50_048, 6))
    want = cluster.closest_hit_clustered(cs, o, d, tm)
    before = packet.STREAM_LAUNCHES
    if mode == "any_hit":
        got = packet.closest_hit_packet_cuda(cs, o, d, tm, sort=True, any_hit=True, stream=True,
                                             need_uv=False)
        assert torch.equal((got["tri"] >= 0) & (got["t"] < tm), (want["tri"] >= 0) & (want["t"] < tm))
    else:
        got = packet.closest_hit_packet_cuda(cs, o, d, tm, sort=mode == "sorted", stream=True)
        _assert_hits_agree({k: v.cpu().numpy() for k, v in got.items()},
                           {k: v.cpu().numpy() for k, v in want.items()}, o.cpu().numpy(),
                           d.cpu().numpy(), {k: getattr(tris, k).numpy() for k in ("p0", "e1", "e2")},
                           1e-6)
    assert packet.STREAM_LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_streaming_kernel_differs_from_resident_kernel_only_where_right_on_card(
        cuda_device, small_clusters, any_hit):
    """On the same worklists the two kernels run the same walk
    (csrc/packet_walk.cuh), so their results are identical on every ray;
    the kernels' own cases hold them against the plain scan."""
    _, cs, _ = small_clusters
    cs = cs.to(cuda_device)
    o, d, tm = (torch.from_numpy(a).to(cuda_device) for a in _rays(50_048, 7))
    order, keys = packet._block_worklists_super(o, d, cs, tm)
    a = packet.launch_stream(cs, o, d, tm, order, keys, any_hit, not any_hit)
    b = packet.launch(cs, o, d, tm, order, keys, any_hit, not any_hit)
    for k in ("t", "u", "v", "tri"):
        assert torch.equal(a[k], b[k]), k