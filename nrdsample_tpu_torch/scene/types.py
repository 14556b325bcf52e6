"""Flat-array (SoA) scene representation (counterpart of
``nrdsample_tpu/scene/types.py``): dataclasses of tensors with ``to(device)``.

Mesh assembly (``build_triangle_soa``, ``make_scene``) is host numpy code
that gives the same arrays as the JAX package's builders."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nrdsample_tpu_torch.device import resolve


def _to(obj, device):
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v):
            v = v.to(device)
        kw[f.name] = v
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass
class Materials:
    """Per-material parameter arrays."""

    base_color: torch.Tensor   # (M, 3)
    metalness: torch.Tensor    # (M,)
    roughness: torch.Tensor    # (M,)
    emission: torch.Tensor     # (M, 3)
    ior: torch.Tensor          # (M,)
    flags: torch.Tensor        # (M,) int32 FLAG_* bits

    def to(self, device) -> "Materials":
        return _to(self, device)


@dataclasses.dataclass
class TriangleSoA:
    """World-space triangle SoA: p0/e1/e2 for intersection, the rest for
    shading."""

    p0: torch.Tensor    # (T, 3)
    e1: torch.Tensor    # (T, 3) = p1 - p0
    e2: torch.Tensor    # (T, 3) = p2 - p0
    n0: torch.Tensor    # (T, 3) vertex normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor   # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    material: torch.Tensor    # (T,) int32
    world_area: torch.Tensor  # (T,)
    t0: torch.Tensor    # (T, 3) vertex tangents
    t1: torch.Tensor
    t2: torch.Tensor
    bitan_sign: torch.Tensor  # (T,)

    @property
    def count(self) -> int:
        return self.p0.shape[0]

    def to(self, device) -> "TriangleSoA":
        return _to(self, device)


@dataclasses.dataclass
class Scene:
    """A renderable scene. ``emissive_tris`` lists the emissive triangles,
    padded with -1 to a static size; ``emissive_count`` is a 0-d int32.

    ``textures`` is the ``scene/textures.TextureSet`` of the materials (None
    for constant materials), and ``has_alpha_test`` says that a material
    carries FLAG_ALPHA_TEST. ``tri_instance`` (T,) int32 and
    ``instance_scales`` (I, 10) [baseColor.xyz, metalness, emission.xyz,
    roughness, normalUv.xy] scale the materials per instance where both are
    set (``scene/instances.transform_scene`` sets them)."""

    tris: TriangleSoA
    materials: Materials
    emissive_tris: torch.Tensor   # (E,) int32, -1 padded
    emissive_count: torch.Tensor  # () int32
    has_emissive: bool = False
    textures: object = None
    has_alpha_test: bool = False
    tri_instance: object = None
    instance_scales: object = None

    @property
    def num_tris(self) -> int:
        return self.tris.count

    def to(self, device) -> "Scene":
        return _to(self, device)


@dataclasses.dataclass
class Camera:
    """Camera state incl. previous-frame matrix and jitter. View space:
    x right, y up, z forward; view_z = forward depth > 0."""

    view_to_world: torch.Tensor       # (4, 4)
    view_to_world_prev: torch.Tensor  # (4, 4)
    tan_half_fov_y: torch.Tensor      # ()
    aspect: torch.Tensor              # ()
    near_z: torch.Tensor              # ()
    jitter: torch.Tensor              # (2,) pixels
    jitter_prev: torch.Tensor         # (2,)
    aperture: torch.Tensor            # ()
    focal_distance: torch.Tensor      # ()
    ortho: torch.Tensor               # ()

    @property
    def position(self) -> torch.Tensor:
        return self.view_to_world[:3, 3]

    @property
    def world_to_view(self) -> torch.Tensor:
        return _invert_rigid(self.view_to_world)

    @property
    def world_to_view_prev(self) -> torch.Tensor:
        return _invert_rigid(self.view_to_world_prev)

    def to(self, device) -> "Camera":
        return _to(self, device)


def _invert_rigid(m: torch.Tensor) -> torch.Tensor:
    rt = m[:3, :3].T
    t = m[:3, 3]
    out = torch.eye(4, dtype=m.dtype, device=m.device)
    out[:3, :3] = rt
    out[:3, 3] = -torch.stack([rt[i, 0] * t[0] + rt[i, 1] * t[1] + rt[i, 2] * t[2] for i in range(3)])
    return out


def look_at(eye, target, up=(0.0, 0.0, 1.0), fov_y_deg: float = 60.0, aspect: float = 1.0,
            near_z: float = 0.01, device=None) -> Camera:
    """Camera from eye/target (world z-up), on ``device`` (the CUDA card when
    None)."""
    device = resolve(device)
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    cam_up = np.cross(right, fwd)
    v2w = np.eye(4, dtype=np.float32)
    v2w[:3, 0] = right
    v2w[:3, 1] = cam_up
    v2w[:3, 2] = fwd
    v2w[:3, 3] = eye
    f32 = dict(dtype=torch.float32, device=device)
    v2w = torch.tensor(v2w, **f32)
    return Camera(
        view_to_world=v2w,
        view_to_world_prev=v2w.clone(),
        tan_half_fov_y=torch.tensor(np.float32(np.tan(np.deg2rad(fov_y_deg) * 0.5)), **f32),
        aspect=torch.tensor(aspect, **f32),
        near_z=torch.tensor(near_z, **f32),
        jitter=torch.zeros(2, **f32),
        jitter_prev=torch.zeros(2, **f32),
        aperture=torch.tensor(0.0, **f32),
        focal_distance=torch.tensor(1.0, **f32),
        ortho=torch.tensor(0.0, **f32),
    )


def build_triangle_soa(vertices: np.ndarray, indices: np.ndarray, normals: np.ndarray | None,
                       uvs: np.ndarray | None, material: np.ndarray,
                       tangents: np.ndarray | None = None) -> TriangleSoA:
    """Assemble the SoA from indexed mesh arrays (host numpy, then tensors
    on the CPU). Tangents, when absent, are derived per triangle from the UV
    chart; a degenerate chart falls back to a tangent of the geometric
    normal."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    p0 = vertices[indices[:, 0]]
    p1 = vertices[indices[:, 1]]
    p2 = vertices[indices[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    gn = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(gn, axis=-1)
    if normals is None:
        gnn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        n0 = n1 = n2 = gnn
    else:
        normals = np.asarray(normals, np.float32)
        n0, n1, n2 = (normals[indices[:, k]] for k in range(3))
    if uvs is None:
        uv0 = uv1 = uv2 = np.zeros((len(indices), 2), np.float32)
    else:
        uvs = np.asarray(uvs, np.float32)
        uv0, uv1, uv2 = (uvs[indices[:, k]] for k in range(3))
    if tangents is not None:
        tangents = np.asarray(tangents, np.float32)
        t0, t1, t2 = (tangents[indices[:, k], :3] for k in range(3))
        bitan_sign = tangents[indices[:, 0], 3]
    else:
        tang, bitan_sign = uv_tangents(e1, e2, uv0, uv1, uv2)
        t0 = t1 = t2 = tang
    f = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))
    return TriangleSoA(
        p0=f(p0), e1=f(e1), e2=f(e2), n0=f(n0), n1=f(n1), n2=f(n2),
        uv0=f(uv0), uv1=f(uv1), uv2=f(uv2),
        material=torch.from_numpy(np.asarray(material, np.int32).copy()),
        world_area=f(area), t0=f(t0), t1=f(t1), t2=f(t2), bitan_sign=f(bitan_sign),
    )


def uv_tangents(e1: np.ndarray, e2: np.ndarray, uv0, uv1, uv2):
    """Per-triangle (T, 3) unit tangents along +u of the uv chart and the
    bitangent signs (T,), from the (T, 3) edges and (T, 2) corner uvs; a
    degenerate chart falls back to a tangent of the geometric normal."""
    gn = np.cross(e1, e2)
    duv1 = np.asarray(uv1, np.float32) - np.asarray(uv0, np.float32)
    duv2 = np.asarray(uv2, np.float32) - np.asarray(uv0, np.float32)
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tang = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
    gnn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    alt = np.cross(gnn, np.where(np.abs(gnn[:, 2:3]) < 0.9,
                                 np.array([0.0, 0.0, 1.0], np.float32),
                                 np.array([1.0, 0.0, 0.0], np.float32)))
    tlen = np.linalg.norm(tang, axis=-1, keepdims=True)
    good = (ok[:, None]) & (tlen > 1e-12)
    tang = np.where(good, tang / np.maximum(tlen, 1e-20), alt)
    return tang.astype(np.float32), np.where(det < 0.0, -1.0, 1.0).astype(np.float32)


MAX_EMISSIVE_HARD_CAP = 8192


def make_scene(tris: TriangleSoA, materials: Materials,
               max_emissive: int | None = None) -> Scene:
    """Finalize a scene: derive the padded emissive triangle list on the
    host (largest-area emitters kept when the set is capped)."""
    emission = materials.emission.cpu().numpy()
    tri_mat = tris.material.cpu().numpy()
    is_emissive = emission.max(axis=-1)[tri_mat] > 0.0
    ids = np.nonzero(is_emissive)[0].astype(np.int32)
    count = len(ids)
    if max_emissive is None:
        max_emissive = 256 if count <= 256 else min(
            -(-count // 128) * 128, MAX_EMISSIVE_HARD_CAP
        )
    if count > max_emissive:
        areas = tris.world_area.cpu().numpy()[ids]
        ids = ids[np.argsort(-areas)[:max_emissive]]
        count = max_emissive
    padded = np.full(max_emissive, -1, np.int32)
    padded[:count] = ids
    return Scene(
        tris=tris,
        materials=materials,
        emissive_tris=torch.from_numpy(padded),
        emissive_count=torch.tensor(count, dtype=torch.int32),
        has_emissive=bool(count > 0),
    )
