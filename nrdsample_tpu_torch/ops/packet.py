"""Packet traversal on the card: stage 1 in PyTorch and the wrappers of the
two packet kernels, ``csrc/packet_hit.cu`` (the port of the resident Pallas
kernel ``nrdsample_tpu/ops/packet.py:_packet_kernel``) and
``csrc/packet_hit_stream.cu`` (the port of the HBM-streaming
``_packet_kernel_stream``). The plain versions are
``ops/cluster.closest_hit_clustered`` and ``any_hit_clustered``;
``ops/traversal`` picks by the rays' device.

Rays are grouped into 128-ray packets. Stage 1 gives each packet one cluster
worklist: every cluster some ray of the packet may enter, sorted by a lower
bound of the packet's entry distance. Up to ``FLAT_WORKLIST_MAX_C`` clusters
the bound is exact (every ray against every cluster box); above, it is
hierarchical (exact per-ray entries into the 8-cluster superclusters, refined
by a per-packet interval test of each cluster), as in the JAX package. The
kernel runs one thread block per packet and walks that list until the next
entry is past every ray's best hit. The streaming kernel takes slabs larger
than ``PACKET_VMEM_LIMIT``, the JAX package's rule.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.ops import _kernels
from nrdsample_tpu_torch.ops.cluster import (CLUSTER_SIZE, SUPER_SIZE, T_MAX, ClusterSet,
                                             _cluster_entry)

BLOCK_RAYS = 128            # rays per packet: one thread per ray
FLAT_WORKLIST_MAX_C = 2048  # above this stage 1 is hierarchical (superclusters)
#: slab bytes above which the streaming kernel runs (the JAX package's
#: traversal.PACKET_VMEM_LIMIT; the H100's L2 holds 50 MB)
PACKET_VMEM_LIMIT = 48 << 20
_CID_BITS = 14              # cluster-id bits in the packed sort key
MAX_CLUSTERS = (1 << _CID_BITS) - 1
_STAGE1_BYTES = 64 << 20    # bytes of one (rays, C) entry matrix chunk
_STAGE1_SUPER_ENTRIES = 1 << 24   # (packets, C) entries of one hierarchical stage-1 chunk

#: launches of the resident packet kernel (incremented once per launch)
LAUNCHES = 0
#: launches of the streaming packet kernel
STREAM_LAUNCHES = 0


def _sort_worklists(key, hit):
    """(order, keys_sorted) from (nb, C) per-packet keys through ONE int32
    sort: the key's float bits with the low 14 bits cleared, OR the cluster
    id. The reconstructed keys are lower bounds of the true ones, so the
    kernel's pruning may stop a hair later, never earlier. A miss is +inf
    before the masking (T_MAX would be rounded down below real keys)."""
    c = key.shape[1]
    mask = (1 << _CID_BITS) - 1
    key = torch.where(hit, torch.clamp_min(key, 0.0), torch.inf)
    cid = torch.arange(c, dtype=torch.int32, device=key.device)
    packed = (key.contiguous().view(torch.int32) & ~mask) | cid
    packed = torch.sort(packed, dim=1).values
    return (packed & mask).contiguous(), (packed & ~mask).view(torch.float32).contiguous()


def _block_min_entry(origin, direction, bounds_min, bounds_max, t_max, block: int):
    """(nb, C): per packet, the min over its rays of the exact entry
    distances, in chunks of packets to bound the (rays, C) matrix."""
    nb = origin.shape[0] // block
    c = bounds_min.shape[0]
    chunk = max(1, _STAGE1_BYTES // (block * c * 4)) * block
    parts = []
    for a in range(0, nb * block, chunk):
        e = _cluster_entry(origin[a:a + chunk], direction[a:a + chunk], bounds_min,
                           bounds_max, t_max[a:a + chunk])
        parts.append(e.reshape(-1, block, c).amin(dim=1))
    return torch.cat(parts)


def _block_worklists(origin, direction, cs: ClusterSet, t_max, block: int = BLOCK_RAYS):
    """Stage 1: per-packet worklists (order (nb, C) int32, keys (nb, C) f32)."""
    block_near = _block_min_entry(origin, direction, cs.bounds_min, cs.bounds_max, t_max, block)
    hit = block_near < T_MAX
    return _sort_worklists(torch.where(hit, block_near, T_MAX), hit)


def _block_worklists_interval_parts(origin, direction, cs: ClusterSet, t_max,
                                    block: int = BLOCK_RAYS):
    """Per-packet interval test of every cluster box: (hit (nb, C) bool,
    lower bound of the entry distance (nb, C)). The packet's origins and
    directions are bounded per axis; an axis whose direction interval spans
    zero bounds nothing."""
    nb = origin.shape[0] // block
    ob = origin.reshape(nb, block, 3)
    db = direction.reshape(nb, block, 3)
    o_lo, o_hi = ob.amin(dim=1), ob.amax(dim=1)      # (nb, 3)
    d_lo, d_hi = db.amin(dim=1), db.amax(dim=1)
    t_cap = t_max.reshape(nb, block).amax(dim=1)     # (nb,)
    big = T_MAX
    c = cs.count
    tnear_lb = torch.zeros((nb, c), dtype=torch.float32, device=origin.device)
    tfar_ub = torch.full((nb, c), T_MAX, dtype=torch.float32, device=origin.device)
    for k in range(3):
        bmin = cs.bounds_min[None, :, k]              # (1, C)
        bmax = cs.bounds_max[None, :, k]
        a_lo = bmin - o_hi[:, k:k + 1]                # interval of (b - o)
        a_hi = bmax - o_lo[:, k:k + 1]
        dl, dh = d_lo[:, k:k + 1], d_hi[:, k:k + 1]
        same_sign = (dl > 1e-12) | (dh < -1e-12)      # (nb, 1)
        i_lo = 1.0 / torch.where(torch.abs(dh) < 1e-12, 1e-12, dh)
        i_hi = 1.0 / torch.where(torch.abs(dl) < 1e-12, 1e-12, dl)
        p1, p2, p3, p4 = a_lo * i_lo, a_lo * i_hi, a_hi * i_lo, a_hi * i_hi
        lo_k = torch.where(same_sign, torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                           -big)
        hi_k = torch.where(same_sign, torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)),
                           big)
        tnear_lb = torch.maximum(tnear_lb, lo_k)
        tfar_ub = torch.minimum(tfar_ub, hi_k)
    hit = (tnear_lb <= tfar_ub) & (tnear_lb < t_cap[:, None])
    return hit, torch.clamp_min(tnear_lb, 0.0)


def _block_worklists_super(origin, direction, cs: ClusterSet, t_max, block: int = BLOCK_RAYS):
    """Hierarchical stage 1 for more than FLAT_WORKLIST_MAX_C clusters: the
    exact per-ray entry into each supercluster (8 clusters), minimised over
    the packet, and the per-packet interval test of each cluster. A cluster
    is listed where both hit, keyed by the larger of the two lower bounds.
    Chunked over packets so that the (packets, C) intermediates stay near
    64 MB each. Returns (order, keys) as ``_block_worklists``."""
    c = cs.count
    nb = origin.shape[0] // block
    chunk = max(1, _STAGE1_SUPER_ENTRIES // c) * block
    orders, keys = [], []
    for a in range(0, nb * block, chunk):
        o, d, tm = origin[a:a + chunk], direction[a:a + chunk], t_max[a:a + chunk]
        near_s = _block_min_entry(o, d, cs.super_min, cs.super_max, tm, block)   # (nb', Cs)
        super_key = torch.repeat_interleave(near_s, SUPER_SIZE, dim=1)[:, :c]
        hit_i, lb_i = _block_worklists_interval_parts(o, d, cs, tm, block)
        hit = (super_key < T_MAX) & hit_i
        order_c, keys_c = _sort_worklists(torch.where(hit, torch.maximum(super_key, lb_i), T_MAX),
                                          hit)
        orders.append(order_c)
        keys.append(keys_c)
    return torch.cat(orders), torch.cat(keys)


def vmem_table_bytes(cs: ClusterSet) -> int:
    """Bytes of the cluster slab: what the JAX package holds against
    PACKET_VMEM_LIMIT to pick the streaming kernel."""
    return int(cs.slab.shape[0]) * CLUSTER_SIZE * 4


def worklists(origin, direction, cs: ClusterSet, t_max, block: int = BLOCK_RAYS):
    """Stage 1 as the JAX package picks it: flat up to FLAT_WORKLIST_MAX_C
    clusters, hierarchical above."""
    if cs.count <= FLAT_WORKLIST_MAX_C:
        return _block_worklists(origin, direction, cs, t_max, block)
    return _block_worklists_super(origin, direction, cs, t_max, block)


def _morton_sort_keys(origin, direction, cs: ClusterSet):
    """Ray-coherence key: direction octant (high bits) + 10-bit-per-axis
    morton code of the origin within the scene bounds. The JAX package's
    uint32 arithmetic, in int64 masked to 32 bits (torch's CPU uint32 has no
    shifts)."""
    lo = cs.bounds_min.amin(dim=0)
    hi = cs.bounds_max.amax(dim=0)
    q = torch.clamp((origin - lo) / torch.clamp_min(hi - lo, 1e-6), 0.0, 1.0)
    q = (q * 1023.0).to(torch.int64)

    def spread(a):
        a = (a | (a << 16)) & 0x030000FF
        a = (a | (a << 8)) & 0x0300F00F
        a = (a | (a << 4)) & 0x030C30C3
        return (a | (a << 2)) & 0x09249249

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    octant = ((direction[:, 0] > 0).to(torch.int64) * 4 + (direction[:, 1] > 0).to(torch.int64) * 2
              + (direction[:, 2] > 0).to(torch.int64))
    return ((octant << 30) & 0xFFFFFFFF) | (morton >> 2)


def closest_hit_packet_cuda(cs: ClusterSet, origin, direction, t_max=T_MAX, sort: bool = False,
                            any_hit: bool = False, stream: bool | None = None,
                            need_uv: bool = True) -> dict:
    """Launch a packet kernel on CUDA rays: dict(t, u, v, tri), t = t_max and
    tri = -1 on a miss. ``sort`` re-bins the rays by direction octant and
    origin morton code first (divergent bounce and shadow waves) and puts the
    results back in the callers' order. ``any_hit`` lets a packet stop once
    every ray is blocked inside its t_max; a blocked ray then reports some
    blocker, not the closest. ``stream`` picks the streaming kernel (True),
    the resident one (False) or, with None, the streaming one when the slab
    is larger than PACKET_VMEM_LIMIT. ``need_uv=False`` lets the streaming
    kernel skip u/v (returned as zeros); the resident kernel always tracks
    them."""
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_packet_cuda needs CUDA tensors, got {dev}")
    c = cs.count
    if c > MAX_CLUSTERS:
        raise ValueError(f"{c} clusters > {MAX_CLUSTERS}: the packed worklist sort key holds "
                         f"{_CID_BITS} bits of cluster id")
    if stream is None:
        stream = vmem_table_bytes(cs) > PACKET_VMEM_LIMIT
    r = origin.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    if sort:
        perm = torch.sort(_morton_sort_keys(origin, direction, cs), stable=True).indices
        res = closest_hit_packet_cuda(cs, origin[perm], direction[perm], t_max[perm],
                                      any_hit=any_hit, stream=stream, need_uv=need_uv)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(r, device=dev)
        return {k: v[inv] for k, v in res.items()}
    pad = (-r) % BLOCK_RAYS
    if pad:
        # padded rays have t_max 0: they enter no cluster and hit nothing
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, origin.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)])
        t_max = torch.cat([t_max, t_max.new_zeros(pad)])
    t_max = t_max.contiguous()
    order, keys = worklists(origin, direction, cs, t_max)
    if stream:
        res = launch_stream(cs, origin, direction, t_max, order, keys, any_hit, need_uv)
    else:
        res = launch(cs, origin, direction, t_max, order, keys, any_hit)
    return {k: v[:r] for k, v in res.items()}


def _launch(symbol: str, cs: ClusterSet, origin, direction, t_max, order, keys, *flags) -> dict:
    """Check the inputs of a packet kernel and launch it: (R, 3) rays with R
    a multiple of 128, (R,) t_max and stage 1's (R / 128, C) worklists, all
    contiguous on one CUDA device. Returns dict(t, u, v, tri) of (R,)
    tensors."""
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"{symbol} needs CUDA tensors, got {dev}")
    f32 = torch.float32
    r, c = origin.shape[0], cs.count
    if r % BLOCK_RAYS:
        raise ValueError(f"{r} rays: the packet kernels take whole packets of {BLOCK_RAYS}")
    check = _kernels.check_tensor
    check("origin", origin, f32, (r, 3), dev)
    check("direction", direction, f32, (r, 3), dev)
    check("t_max", t_max, f32, (r,), dev)
    check("order", order, torch.int32, (r // BLOCK_RAYS, c), dev)
    check("keys", keys, f32, (r // BLOCK_RAYS, c), dev)
    check("slab", cs.slab, f32, (cs.slab.shape[0], 128), dev)
    t = torch.empty(r, dtype=f32, device=dev)
    u = torch.empty(r, dtype=f32, device=dev)
    v = torch.empty(r, dtype=f32, device=dev)
    tri = torch.empty(r, dtype=torch.int32, device=dev)
    lib = _kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, symbol)(origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
                                  order.data_ptr(), keys.data_ptr(), cs.slab.data_ptr(), c,
                                  r // BLOCK_RAYS, *flags, t.data_ptr(), u.data_ptr(),
                                  v.data_ptr(), tri.data_ptr(), stream)
    _kernels.check(rc, symbol)
    return {"t": t, "u": u, "v": v, "tri": tri}


def launch(cs: ClusterSet, origin, direction, t_max, order, keys, any_hit: bool = False) -> dict:
    """The resident kernel (``csrc/packet_hit.cu``) alone on stage 1's
    worklists; see ``_launch`` for the inputs."""
    global LAUNCHES
    res = _launch("nrd_packet_hit", cs, origin, direction, t_max, order, keys, int(any_hit))
    LAUNCHES += 1
    return res


def launch_stream(cs: ClusterSet, origin, direction, t_max, order, keys, any_hit: bool = False,
                  need_uv: bool = True) -> dict:
    """The streaming kernel (``csrc/packet_hit_stream.cu``) alone on stage 1's
    worklists; see ``_launch`` for the inputs."""
    global STREAM_LAUNCHES
    res = _launch("nrd_packet_hit_stream", cs, origin, direction, t_max, order, keys,
                  int(any_hit), int(need_uv))
    STREAM_LAUNCHES += 1
    return res
