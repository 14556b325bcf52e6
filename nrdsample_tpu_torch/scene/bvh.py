"""The host BVH builder (counterpart of ``nrdsample_tpu/scene/bvh.py``): a
binned-SAH binary build over triangle AABBs, collapsed to an 8-wide flat
array layout (BVH8) for the "bvh8" traversal mode (``ops/traversal.py``).
Leaves hold contiguous triangle ranges (the triangles are reordered by the
build's permutation). ``build_order`` is the permutation alone: the plain
numpy version of ``native/bvh_builder.cpp``, which ``ops/cluster.build_clusters``
uses. The two agree on small scenes; on large ones float32 rounding in the
C++ split sweep picks other splits, and the JAX package orders by the C++
builder too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LEAF_SIZE = 4          # max triangles per leaf
WIDTH = 8              # children per node
_LEAF_COUNT_BITS = 4   # leaf meta: count in the low bits (<= 15)

# child_meta encoding (int32):
#   -1    an empty slot
#   >= 0  an internal child: its node index
#   <= -2 a leaf: -(2 + (start << 4 | count))
EMPTY = -1

_NBINS = 16


def _encode_leaf(start: int, count: int) -> int:
    if not 0 < count <= (1 << _LEAF_COUNT_BITS) - 1:
        raise ValueError(f"a leaf of {count} triangles")
    return -(2 + ((start << _LEAF_COUNT_BITS) | count))


def decode_leaf(meta):
    """(start, count) of leaf metas (numpy arrays or torch tensors)."""
    v = -meta - 2
    return v >> _LEAF_COUNT_BITS, v & ((1 << _LEAF_COUNT_BITS) - 1)


@dataclasses.dataclass
class BVH8:
    """Flat 8-wide BVH: node i's children are child_*[i]."""

    child_min: torch.Tensor   # (N, 8, 3) float32
    child_max: torch.Tensor   # (N, 8, 3) float32
    child_meta: torch.Tensor  # (N, 8) int32

    @property
    def num_nodes(self) -> int:
        return self.child_meta.shape[0]

    def to(self, device) -> "BVH8":
        return BVH8(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def _build_binary(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int):
    """(nodes, order) of the binary binned-SAH build: nodes is a dict of
    arrays (bmin, bmax, left, right, start, count; an internal node has
    start -1, a leaf left -1), ``order`` (int64, order[new] = old) the
    triangle permutation that makes every leaf's range contiguous."""
    t = len(tri_min)
    centroid = 0.5 * (tri_min + tri_max)
    order = np.arange(t, dtype=np.int64)
    bmins, bmaxs, lefts, rights, starts, counts = [], [], [], [], [], []

    def alloc():
        for lst, v in ((bmins, None), (bmaxs, None), (lefts, -1), (rights, -1), (starts, -1),
                       (counts, 0)):
            lst.append(v)
        return len(bmins) - 1

    root = alloc()
    stack = [(root, 0, t)]
    while stack:
        ni, lo, hi = stack.pop()
        ids = order[lo:hi]
        bmins[ni] = tri_min[ids].min(axis=0)
        bmaxs[ni] = tri_max[ids].max(axis=0)
        n = hi - lo
        if n <= leaf_size:
            starts[ni], counts[ni] = lo, n
            continue
        c = centroid[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        ext = cmax - cmin
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:
            mid = lo + n // 2
        else:
            # binned SAH
            scale = _NBINS * (1.0 - 1e-6) / ext[axis]
            bin_idx = ((c[:, axis] - cmin[axis]) * scale).astype(np.int32)
            bin_idx = np.clip(bin_idx, 0, _NBINS - 1)
            bin_count = np.bincount(bin_idx, minlength=_NBINS)
            binmin = np.full((_NBINS, 3), np.inf, np.float32)
            binmax = np.full((_NBINS, 3), -np.inf, np.float32)
            for b in range(_NBINS):
                if bin_count[b]:
                    sel = bin_idx == b
                    binmin[b] = tri_min[ids[sel]].min(axis=0)
                    binmax[b] = tri_max[ids[sel]].max(axis=0)
            # sweep
            lmin = np.minimum.accumulate(binmin, axis=0)
            lmax = np.maximum.accumulate(binmax, axis=0)
            rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_count)
            rcnt = np.cumsum(bin_count[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = area(lmin, lmax)[: _NBINS - 1] * lcnt[: _NBINS - 1] + area(
                rmin[1:], rmax[1:]
            ) * rcnt[1:]
            valid = (lcnt[: _NBINS - 1] > 0) & (rcnt[1:] > 0)
            if not valid.any():
                mid = lo + n // 2
            else:
                cost = np.where(valid, cost, np.inf)
                split_bin = int(np.argmin(cost))
                go_left = bin_idx <= split_bin
                left_ids = ids[go_left]
                right_ids = ids[~go_left]
                order[lo : lo + len(left_ids)] = left_ids
                order[lo + len(left_ids) : hi] = right_ids
                mid = lo + len(left_ids)
        if mid == lo or mid == hi:
            mid = lo + n // 2
            # re-sort by centroid for a median split
            ids = order[lo:hi]
            key = centroid[ids][:, axis]
            order[lo:hi] = ids[np.argsort(key, kind="stable")]
        li, ri = alloc(), alloc()
        lefts[ni], rights[ni] = li, ri
        stack.append((ri, mid, hi))
        stack.append((li, lo, mid))

    nodes = {"bmin": np.asarray(bmins, np.float32), "bmax": np.asarray(bmaxs, np.float32),
             "left": np.asarray(lefts, np.int64), "right": np.asarray(rights, np.int64),
             "start": np.asarray(starts, np.int64), "count": np.asarray(counts, np.int64)}
    return nodes, order


def build_order(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int) -> np.ndarray:
    """The triangle permutation (int64, order[new] = old) of the binary
    binned-SAH build over triangle AABBs (``_build_binary``'s)."""
    return _build_binary(tri_min, tri_max, leaf_size)[1]


def _collapse(nodes) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The binary tree as 8-wide nodes: each wide node gathers up to WIDTH
    binary subtrees, opening the internal entry of the largest surface area
    first. Returns (child_min (N, 8, 3), child_max (N, 8, 3), child_meta
    (N, 8))."""
    bmin, bmax = nodes["bmin"], nodes["bmax"]
    left, right = nodes["left"], nodes["right"]
    start, count = nodes["start"], nodes["count"]
    is_leaf = left < 0
    out_min, out_max, out_meta = [], [], []

    def alloc():
        out_min.append(np.zeros((WIDTH, 3), np.float32))
        out_max.append(np.zeros((WIDTH, 3), np.float32))
        out_meta.append(np.full(WIDTH, EMPTY, np.int32))
        return len(out_meta) - 1

    work = [(alloc(), 0)]
    while work:
        wi, bi = work.pop()
        slots = [bi]
        while len(slots) < WIDTH:
            best, best_a = -1, -1.0
            for k, s in enumerate(slots):
                if not is_leaf[s]:
                    d = np.maximum(bmax[s] - bmin[s], 0)
                    a = d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
                    if a > best_a:
                        best, best_a = k, a
            if best < 0:
                break
            s = slots.pop(best)
            slots.extend([left[s], right[s]])
        for k, s in enumerate(slots):
            out_min[wi][k] = bmin[s]
            out_max[wi][k] = bmax[s]
            if is_leaf[s]:
                out_meta[wi][k] = _encode_leaf(int(start[s]), int(count[s]))
            else:
                ci = alloc()
                out_meta[wi][k] = ci
                work.append((ci, s))
    return np.stack(out_min), np.stack(out_max), np.stack(out_meta)


def build_bvh8(tri_p0, tri_e1, tri_e2, leaf_size: int = LEAF_SIZE, device="cpu"):
    """(BVH8 on ``device``, order): a BVH8 over the triangles (p0, e1, e2)
    (numpy arrays or tensors), and the int64 permutation to apply to every
    per-triangle array so that leaf ranges are contiguous."""
    p0 = np.asarray(_numpy(tri_p0), np.float32)
    p1 = p0 + np.asarray(_numpy(tri_e1), np.float32)
    p2 = p0 + np.asarray(_numpy(tri_e2), np.float32)
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    # a small pad for degenerate and axis-aligned triangles
    pad = 1e-6 * np.maximum(1.0, np.abs(tri_max) + np.abs(tri_min))
    tri_min -= pad
    tri_max += pad
    nodes, order = _build_binary(tri_min, tri_max, leaf_size)
    bvh = BVH8(*(torch.from_numpy(a).to(device) for a in _collapse(nodes)))
    return bvh, order


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def reorder_tris(tris, order: np.ndarray):
    """The TriangleSoA with the BVH permutation applied to every field."""
    idx = torch.from_numpy(order.astype(np.int64))
    return type(tris)(**{f.name: getattr(tris, f.name)[idx.to(getattr(tris, f.name).device)]
                         for f in dataclasses.fields(tris)})


def max_depth_estimate(bvh: BVH8) -> int:
    """The longest root-to-leaf path (for sizing the traversal stack)."""
    meta = bvh.child_meta.cpu().numpy()
    depth = {0: 1}
    best = 1
    work = [0]
    while work:
        n = work.pop()
        for m in meta[n]:
            if m >= 0:
                depth[int(m)] = depth[n] + 1
                best = max(best, depth[int(m)])
                work.append(int(m))
    return best
