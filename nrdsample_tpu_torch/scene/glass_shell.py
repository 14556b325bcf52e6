"""Inner glass shells (counterpart of ``nrdsample_tpu/scene/glass_shell.py``;
AddInnerGlassSurfaces, NRDSample.cpp:2243-2278): every transparent group of
triangles is duplicated, scaled slightly toward its centroid and flipped, so
that refraction sees two interfaces (air to glass, glass to air) and
absorption gets a real path length. The scene is a flat triangle soup, so an
"instance" is the transparent group sharing a material id. Host numpy, run
before ``build_context``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch import config
from nrdsample_tpu_torch.scene.types import Scene, TriangleSoA


def add_inner_glass_surfaces(scene: Scene, thickness: float = 0.05) -> Scene:
    """Append inward-scaled, flipped copies of all transparent triangles.
    thickness: relative inset (0.05 = 5% toward the group centroid)."""
    tr = {f.name: getattr(scene.tris, f.name).cpu().numpy() for f in dataclasses.fields(TriangleSoA)}
    flags = scene.materials.flags.cpu().numpy()
    mat = tr["material"]
    is_trans = (flags[mat] & config.FLAG_TRANSPARENT) != 0
    if not is_trans.any():
        return scene

    idx = np.nonzero(is_trans)[0]
    p0, e1, e2 = tr["p0"][idx], tr["e1"][idx], tr["e2"][idx]

    # per-material-group centroid (the instance's proxy)
    group = mat[idx]
    centers = np.zeros((int(mat.max()) + 1, 3), np.float32)
    for g in np.unique(group):
        sel = group == g
        pts = np.concatenate([p0[sel], p0[sel] + e1[sel], p0[sel] + e2[sel]])
        centers[g] = pts.mean(axis=0)
    c = centers[group]

    s = 1.0 - thickness
    # scale all three corners toward the centroid; swapping e1 and e2 flips
    # the winding (inward-facing normals for the inner shell)
    p0n = c + (p0 - c) * s
    p1n = c + (p0 + e1 - c) * s
    p2n = c + (p0 + e2 - c) * s
    new = {
        "p0": p0n.astype(np.float32),
        "e1": (p2n - p0n).astype(np.float32),
        "e2": (p1n - p0n).astype(np.float32),
        "n0": -tr["n0"][idx], "n1": -tr["n2"][idx], "n2": -tr["n1"][idx],
        "uv0": tr["uv0"][idx], "uv1": tr["uv2"][idx], "uv2": tr["uv1"][idx],
        "material": mat[idx],
        "world_area": tr["world_area"][idx] * s * s,
        # the inner shell keeps its tangents, t1 and t2 swapped with the winding
        "t0": tr["t0"][idx], "t1": tr["t2"][idx], "t2": tr["t1"][idx],
        "bitan_sign": -tr["bitan_sign"][idx],
    }
    dev = scene.tris.p0.device
    tris = TriangleSoA(**{k: torch.from_numpy(np.concatenate([tr[k], new[k]], axis=0)).to(dev)
                          for k in tr})
    return dataclasses.replace(scene, tris=tris)
