"""Packet traversal on the card: stage 1 in PyTorch and the wrapper of
``csrc/packet_hit.cu``, the port of the resident Pallas kernel
``nrdsample_tpu/ops/packet.py:_packet_kernel`` (``closest_hit_packet``,
``any_hit_packet``). The plain versions are ``ops/cluster.closest_hit_clustered``
and ``any_hit_clustered``; ``ops/traversal`` picks by the rays' device.

Rays are grouped into 128-ray packets. Stage 1 gives each packet one cluster
worklist: every cluster some ray of the packet enters, sorted by the
packet's nearest entry distance. The kernel runs one thread block per packet
and walks that list until the next entry is past every ray's best hit.
"""

from __future__ import annotations

import torch

from nrdsample_tpu_torch.ops import _kernels
from nrdsample_tpu_torch.ops.cluster import T_MAX, ClusterSet, _cluster_entry

BLOCK_RAYS = 128            # rays per packet: one thread per ray
FLAT_WORKLIST_MAX_C = 2048  # above this the JAX package's stage 1 is hierarchical
_CID_BITS = 14              # cluster-id bits in the packed sort key
_STAGE1_BYTES = 64 << 20    # bytes of one (rays, C) entry matrix chunk

#: launches of the packet kernel (incremented once per launch)
LAUNCHES = 0


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
                            any_hit: bool = False) -> dict:
    """Launch the packet kernel on CUDA rays: dict(t, u, v, tri), t = t_max
    and tri = -1 on a miss. ``sort`` re-bins the rays by direction octant and
    origin morton code first (divergent bounce and shadow waves) and puts the
    results back in the callers' order. ``any_hit`` lets a packet stop once
    every ray is blocked inside its t_max; a blocked ray then reports some
    blocker, not the closest."""
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_packet_cuda needs CUDA tensors, got {dev}")
    c = cs.count
    if c > FLAT_WORKLIST_MAX_C:
        raise NotImplementedError(
            f"{c} clusters > {FLAT_WORKLIST_MAX_C}: the supercluster stage 1 and the streaming "
            "packet kernel are ported in slice 4 (exterior720)")
    r = origin.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(r)
    if sort:
        perm = torch.sort(_morton_sort_keys(origin, direction, cs), stable=True).indices
        res = closest_hit_packet_cuda(cs, origin[perm], direction[perm], t_max[perm],
                                      any_hit=any_hit)
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(r, device=dev)
        return {k: v[inv] for k, v in res.items()}
    pad = (-r) % BLOCK_RAYS
    if pad:
        # padded rays have t_max 0: they enter no cluster and hit nothing
        origin = torch.cat([origin, origin.new_zeros((pad, 3))])
        direction = torch.cat([direction, origin.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)])
        t_max = torch.cat([t_max, t_max.new_zeros(pad)])
    order, keys = _block_worklists(origin, direction, cs, t_max.contiguous())
    res = launch(cs, origin, direction, t_max.contiguous(), order, keys, any_hit)
    return {k: v[:r] for k, v in res.items()}


def launch(cs: ClusterSet, origin, direction, t_max, order, keys, any_hit: bool = False) -> dict:
    """The kernel alone: (R, 3) rays with R a multiple of 128, (R,) t_max,
    and stage 1's (R / 128, C) worklists, all contiguous on one CUDA
    device. Returns dict(t, u, v, tri) of (R,) tensors."""
    global LAUNCHES
    dev = origin.device
    f32 = torch.float32
    r, c = origin.shape[0], cs.count
    if r % BLOCK_RAYS:
        raise ValueError(f"{r} rays: the packet kernel takes whole packets of {BLOCK_RAYS}")
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
        rc = lib.nrd_packet_hit(origin.data_ptr(), direction.data_ptr(), t_max.data_ptr(),
                                order.data_ptr(), keys.data_ptr(), cs.slab.data_ptr(), c,
                                r // BLOCK_RAYS, int(any_hit), t.data_ptr(), u.data_ptr(),
                                v.data_ptr(), tri.data_ptr(), stream)
    _kernels.check(rc, "nrd_packet_hit")
    LAUNCHES += 1
    return {"t": t, "u": u, "v": v, "tri": tri}
