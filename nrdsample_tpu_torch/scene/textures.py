"""Material textures (counterpart of ``nrdsample_tpu/scene/textures.py``):
one stacked mip pyramid for all materials, sampled with a ray-cone mip.

Every material's maps are resampled on the host to one power-of-two
resolution and packed per texel as 10 channels: [0:4] base colour and
alpha, [4:8] occlusion, roughness, metalness, emissive luma, [8:10] the
tangent-space normal's XY in [-1, 1] (0 is flat; Z is rebuilt at shade
time). ``levels[l]`` is the (M, res >> l, res >> l, 10) box-filtered level
l, down to 1x1. Each level is a tensor of its own, so gradients reach every
level's texels. Addressing wraps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch.mathlib import geometry as geo

CHANNELS = 10


@dataclasses.dataclass
class TextureSet:
    """The mip pyramid of every material: ``levels[l]`` is (M, h >> l, w >> l,
    10) float32."""

    levels: list

    @property
    def n_mips(self) -> int:
        return len(self.levels)

    @property
    def base_res(self) -> int:
        return self.levels[0].shape[1]

    def to(self, device) -> "TextureSet":
        return TextureSet([lv.to(device) for lv in self.levels])


def _box_downsample(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[0] // 2, img.shape[1] // 2
    return img[: 2 * h, : 2 * w].reshape(h, 2, w, 2, -1).mean(axis=(1, 3))


def _resize_pow2(img: np.ndarray, res: int) -> np.ndarray:
    """Nearest-neighbour resize to (res, res, C) on the host."""
    h, w = img.shape[:2]
    yi = (np.arange(res) * h // res).clip(0, h - 1)
    xi = (np.arange(res) * w // res).clip(0, w - 1)
    return np.ascontiguousarray(img[yi][:, xi], dtype=np.float32)


def build_texture_set(per_material: list, res: int = 128) -> TextureSet:
    """The TextureSet of a list of per-material dicts of numpy images in
    [0, 1], each optional: ``base_color`` (h, w, 3 | 4; a fourth channel is
    the alpha), ``alpha``, ``occlusion``, ``roughness``, ``metalness`` and
    ``emissive`` (h, w[, C]), and ``normal`` (h, w, 2 | 3) in the [0, 1]
    image convention (0.5 flat) or already signed in [-1, 1]. A missing map
    is a constant 1 (it multiplies the material constants at shade time), a
    missing normal map flat. Built on the host as the JAX package builds it;
    the levels are CPU tensors."""
    if res <= 0 or res & (res - 1):
        raise ValueError(f"texture res must be a power of two, got {res}")
    mats = []
    for m in per_material or [{}]:
        m = m or {}

        def fetch(key, ch):
            img = m.get(key)
            if img is None:
                return np.full((res, res, ch), 1.0, np.float32)
            img = np.asarray(img, np.float32)
            if img.ndim == 2:
                img = img[..., None]
            if img.shape[-1] < ch:
                img = np.repeat(img, ch, axis=-1)[..., :ch]
            return _resize_pow2(img[..., :ch], res)

        rgb = fetch("base_color", 3)
        alpha = fetch("alpha", 1)
        bc = m.get("base_color")
        if bc is not None and np.asarray(bc).ndim == 3 and np.asarray(bc).shape[-1] == 4:
            alpha = _resize_pow2(np.asarray(bc, np.float32)[..., 3:4], res)
        nrm = m.get("normal")
        if nrm is None:
            nxy = np.zeros((res, res, 2), np.float32)
        else:
            nrm = np.asarray(nrm, np.float32)[..., :2]
            if nrm.min() >= 0.0:   # [0, 1] image convention -> [-1, 1]
                nrm = nrm * 2.0 - 1.0
            nxy = _resize_pow2(nrm, res)
        mats.append(np.concatenate([rgb, alpha, fetch("occlusion", 1), fetch("roughness", 1),
                                    fetch("metalness", 1), fetch("emissive", 1), nxy], axis=-1))
    levels = [np.stack(mats)]
    while levels[-1].shape[1] > 1:
        levels.append(np.stack([_box_downsample(x) for x in levels[-1]]))
    return TextureSet([torch.from_numpy(np.ascontiguousarray(lv, np.float32)) for lv in levels])


def constant_texture_set(n_materials: int, res: int = 4) -> TextureSet:
    """All-ones maps and flat normals for ``n_materials`` materials."""
    return build_texture_set([{} for _ in range(n_materials)], res=res)


def _fetch_bilinear(flat: torch.Tensor, offset, size, mat, uv) -> torch.Tensor:
    """Bilinear taps with wrap addressing from levels flattened into one
    (texels, 10) table: the level of each ray starts at row ``offset`` and is
    ``size`` x ``size`` texels a material (per-ray int64 tensors, or ints).
    Returns (N, 10)."""
    x = uv[..., 0] * size - 0.5
    y = uv[..., 1] * size - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    base = offset + mat * (size * size)

    def tap(yy, xx):
        return flat[base + torch.remainder(yy, size) * size + torch.remainder(xx, size)]

    c00 = tap(y0, x0)
    c01 = tap(y0, x0 + 1)
    c10 = tap(y0 + 1, x0)
    c11 = tap(y0 + 1, x0 + 1)
    return (c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
            + c10 * (1 - fx) * fy + c11 * fx * fy)


def sample(ts: TextureSet, mat: torch.Tensor, uv: torch.Tensor, mip) -> torch.Tensor:
    """Trilinear sample: (N,) material ids, (N, 2) uv, (N,) continuous mip
    (clamped to the pyramid). Returns (N, 10). Each ray fetches its two
    levels floor(mip) and floor(mip) + 1 (the last level twice at the top)
    with bilinear taps and blends them; the JAX package fetches every level
    and selects those two, the same function."""
    n_mips = ts.n_mips
    mip = geo.clip(torch.as_tensor(mip, dtype=torch.float32, device=uv.device), 0.0, n_mips - 1.0)
    mip = mip.expand(uv.shape[:-1])
    l0 = torch.floor(mip).to(torch.int64)
    frac = (mip - l0.to(torch.float32))[..., None]
    l1 = torch.clamp_max(l0 + 1, n_mips - 1)
    # the levels as one table, a row per texel; gradients reach each level
    flat = torch.cat([lv.reshape(-1, CHANNELS) for lv in ts.levels])
    sizes = [lv.shape[1] for lv in ts.levels]
    offsets = np.cumsum([0] + [lv.shape[0] * s * s for lv, s in zip(ts.levels, sizes)])[:-1]
    size_of = torch.tensor(sizes, dtype=torch.int64, device=uv.device)
    offset_of = torch.from_numpy(offsets.astype(np.int64)).to(uv.device)
    mat = mat.to(torch.int64)
    out0 = _fetch_bilinear(flat, offset_of[l0], size_of[l0], mat, uv)
    out1 = _fetch_bilinear(flat, offset_of[l1], size_of[l1], mat, uv)
    return out0 * (1.0 - frac) + out1 * frac


def sample_alpha(ts: TextureSet, mat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The alpha of the alpha test: bilinear at mip min(3, n - 1). (N,)."""
    lv = ts.levels[min(3, ts.n_mips - 1)]
    return _fetch_bilinear(lv.reshape(-1, CHANNELS), 0, lv.shape[1], mat.to(torch.int64), uv)[..., 3]


def box_uvs(scene, scale: float = 1.0):
    """``scene`` with a box-projected uv chart: each triangle's corners
    projected on the two world axes across its geometric normal's largest
    component, times ``scale``, and the tangents that chart gives
    (``types.uv_tangents``). For scenes built without uvs (the procedural
    ones), which a texture would otherwise cover with one texel."""
    from nrdsample_tpu_torch.scene.types import uv_tangents

    tr = scene.tris
    p0, e1, e2 = (getattr(tr, k).detach().cpu().numpy() for k in ("p0", "e1", "e2"))
    axis = np.argmax(np.abs(np.cross(e1, e2)), axis=-1)
    cols = np.array([[1, 2], [0, 2], [0, 1]])[axis]             # the two other axes
    rows = np.arange(len(p0))[:, None]
    uvs = [(p[rows, cols] * scale).astype(np.float32) for p in (p0, p0 + e1, p0 + e2)]
    tang, sign = uv_tangents(e1, e2, *uvs)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(tr.p0.device)
    tris = dataclasses.replace(tr, uv0=f(uvs[0]), uv1=f(uvs[1]), uv2=f(uvs[2]), t0=f(tang),
                               t1=f(tang), t2=f(tang), bitan_sign=f(sign))
    return dataclasses.replace(scene, tris=tris)


def _value_noise(rs: np.random.RandomState, res: int, cells: int) -> np.ndarray:
    """(res, res) noise in [0, 1]: a (cells + 1)^2 random lattice, bilinear."""
    lattice = rs.rand(cells + 1, cells + 1)
    x = np.arange(res) * cells / res
    i, f = x.astype(np.int64), x - x.astype(np.int64)
    rows = lattice[i] * (1 - f)[:, None] + lattice[i + 1] * f[:, None]
    return (rows[:, i] * (1 - f)[None, :] + rows[:, i + 1] * f[None, :]).astype(np.float32)


def procedural_maps(n_materials: int, res: int = 256, seed: int = 0,
                    alpha_materials=()) -> list:
    """Per-material maps for ``build_texture_set``, made from ``seed``: a
    two-colour checker of 16 squares a side modulated by value noise for the
    base colour, value-noise roughness (0.3-1) and metalness (0-0.5), a
    rippled normal map, and for each of ``alpha_materials`` a cut-out alpha:
    four slats a side at alpha 1 with gaps of alpha 0 between them, coarse
    enough to stay cut out at the alpha test's mip 3 from ``res`` 64 up."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / res
    checker = ((np.floor(x * 16) + np.floor(y * 16)) % 2)[..., None]
    out = []
    for m in range(n_materials):
        c0, c1 = rs.uniform(0.2, 1.0, 3), rs.uniform(0.2, 1.0, 3)
        noise = _value_noise(rs, res, 8)[..., None]
        maps = {
            "base_color": ((c0 * (1 - checker) + c1 * checker) * (0.6 + 0.4 * noise)),
            "roughness": 0.3 + 0.7 * _value_noise(rs, res, 8),
            "metalness": 0.5 * _value_noise(rs, res, 4),
            "normal": np.stack([0.5 + 0.3 * np.sin(x * 2 * np.pi * (4 + m)),
                                0.5 + 0.3 * np.sin(y * 2 * np.pi * (3 + m))], -1),
        }
        if m in alpha_materials:
            maps["alpha"] = ((x * 4) % 1 >= 0.5).astype(np.float32)
        out.append({k: np.asarray(v, np.float32) for k, v in maps.items()})
    return out


def textured_scene(scene, res: int = 256, seed: int = 0, alpha_materials=(), uv_scale=0.5):
    """``scene`` with a box uv chart (``box_uvs``), the ``procedural_maps``
    of its materials at ``res`` and FLAG_ALPHA_TEST on ``alpha_materials``."""
    from nrdsample_tpu_torch import config as cfgmod

    n = scene.materials.flags.shape[0]
    flags = scene.materials.flags.clone()
    for m in alpha_materials:
        flags[m] |= cfgmod.FLAG_ALPHA_TEST
    scene = box_uvs(scene, uv_scale)
    ts = build_texture_set(procedural_maps(n, res, seed, alpha_materials), res=res)
    return dataclasses.replace(scene, materials=dataclasses.replace(scene.materials, flags=flags),
                               textures=ts.to(scene.tris.p0.device),
                               has_alpha_test=bool(len(alpha_materials)))
