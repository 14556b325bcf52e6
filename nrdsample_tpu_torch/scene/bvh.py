"""The triangle order of a binary binned-SAH BVH build on the host
(counterpart of ``nrdsample_tpu/scene/bvh.py:_build_binary``): the plain
numpy version of ``native/bvh_builder.cpp``, which ``ops/cluster.build_clusters``
uses. The two agree on small scenes; on large ones float32 rounding in the
C++ split sweep picks other splits, and the JAX package orders by the C++
builder too.
"""

from __future__ import annotations

import numpy as np

_NBINS = 16


def build_order(tri_min: np.ndarray, tri_max: np.ndarray, leaf_size: int) -> np.ndarray:
    """The triangle permutation (int64, order[new] = old) of a binary
    binned-SAH build over triangle AABBs that makes every leaf's triangles
    contiguous. The JAX package's ``_build_binary`` without its node list:
    the splits, and so the order, are the same."""
    t = len(tri_min)
    centroid = 0.5 * (tri_min + tri_max)
    order = np.arange(t, dtype=np.int64)
    stack = [(0, t)]
    while stack:
        lo, hi = stack.pop()
        ids = order[lo:hi]
        n = hi - lo
        if n <= leaf_size:
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
            counts = np.bincount(bin_idx, minlength=_NBINS)
            binmin = np.full((_NBINS, 3), np.inf, np.float32)
            binmax = np.full((_NBINS, 3), -np.inf, np.float32)
            for b in range(_NBINS):
                if counts[b]:
                    sel = bin_idx == b
                    binmin[b] = tri_min[ids[sel]].min(axis=0)
                    binmax[b] = tri_max[ids[sel]].max(axis=0)
            # sweep
            lmin = np.minimum.accumulate(binmin, axis=0)
            lmax = np.maximum.accumulate(binmax, axis=0)
            rmin = np.minimum.accumulate(binmin[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(binmax[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            rcnt = np.cumsum(counts[::-1])[::-1]

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
        stack.append((mid, hi))
        stack.append((lo, mid))
    return order
