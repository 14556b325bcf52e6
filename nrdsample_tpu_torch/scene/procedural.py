"""Procedural test scenes (counterpart of ``nrdsample_tpu/scene/procedural.py``):
the Cornell box, the shader balls and the kitchen, built with the same host
numpy code so the arrays equal the JAX builders' exactly."""

from __future__ import annotations

import numpy as np
import torch

from nrdsample_tpu_torch import config
from nrdsample_tpu_torch.scene.types import Materials, Scene, build_triangle_soa, make_scene


def _quad(p00, p10, p11, p01):
    """Two triangles for a quad given CCW corners; returns (verts, idx)."""
    v = np.array([p00, p10, p11, p01], np.float32)
    i = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, i


def make_box(center, size, flip=False):
    """Axis-aligned box; outward normals (flip=True for inward)."""
    c = np.asarray(center, np.float32)
    h = np.asarray(size, np.float32) * 0.5
    x0, y0, z0 = c - h
    x1, y1, z1 = c + h
    faces = [
        _quad([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),  # -z
        _quad([x0, y0, z1], [x0, y1, z1], [x1, y1, z1], [x1, y0, z1]),  # +z
        _quad([x0, y0, z0], [x0, y0, z1], [x1, y0, z1], [x1, y0, z0]),  # -y
        _quad([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),  # +y
        _quad([x0, y0, z0], [x0, y1, z0], [x0, y1, z1], [x0, y0, z1]),  # -x
        _quad([x1, y0, z0], [x1, y0, z1], [x1, y1, z1], [x1, y1, z0]),  # +x
    ]
    verts, idx = merge_meshes(faces)
    n = np.cross(
        verts[idx[:, 1]] - verts[idx[:, 0]], verts[idx[:, 2]] - verts[idx[:, 0]]
    )
    centers = verts[idx].mean(axis=1)
    outward = centers - c
    wrong = (n * outward).sum(-1) < 0
    if not flip:
        idx[wrong] = idx[wrong][:, ::-1]
    else:
        idx[~wrong] = idx[~wrong][:, ::-1]
    return verts, idx


def make_sphere(center, radius, n_theta=16, n_phi=24):
    """UV sphere with smooth vertex normals."""
    c = np.asarray(center, np.float32)
    theta = np.linspace(0, np.pi, n_theta + 1)
    phi = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    pts = np.stack(
        [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], axis=-1
    ).reshape(-1, 3)
    verts = (c + radius * pts).astype(np.float32)
    normals = pts.astype(np.float32)
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c2 = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            if i > 0:
                idx.append([a, c2, b])
            if i < n_theta - 1:
                idx.append([b, c2, d])
    return verts, np.array(idx, np.int32), normals


def make_plane(center, size, normal_axis=2):
    c = np.asarray(center, np.float32)
    h = np.asarray(size, np.float32) * 0.5
    if normal_axis == 2:
        v, i = _quad(
            c + [-h[0], -h[1], 0], c + [h[0], -h[1], 0],
            c + [h[0], h[1], 0], c + [-h[0], h[1], 0],
        )
    else:
        raise NotImplementedError
    return v, i


def merge_meshes(meshes):
    """Merge [(verts, idx), ...] -> (verts, idx) with offset indices."""
    vs, is_ = [], []
    off = 0
    for v, i in meshes:
        vs.append(v)
        is_.append(i + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(is_)


def _assemble(parts, materials_dict, max_emissive=None):
    """parts: [(verts, idx, normals|None, mat_id)]; materials_dict: name->params."""
    all_v, all_i, all_n, all_m = [], [], [], []
    off = 0
    for verts, idx, normals, mat in parts:
        all_v.append(verts)
        all_i.append(idx + off)
        if normals is None:
            normals = _face_normals_as_vertex(verts, idx)
        all_n.append(normals)
        all_m.append(np.full(len(idx), mat, np.int32))
        off += len(verts)
    tris = build_triangle_soa(np.concatenate(all_v), np.concatenate(all_i),
                              np.concatenate(all_n), None, np.concatenate(all_m))
    m = materials_dict
    n_mat = len(m["metalness"])
    f32 = lambda a: torch.tensor(np.array(a, np.float32))
    mats = Materials(
        base_color=f32(m["base_color"]),
        metalness=f32(m["metalness"]),
        roughness=f32(m["roughness"]),
        emission=f32(m["emission"]),
        ior=f32(m.get("ior", [1.5] * n_mat)),
        flags=torch.tensor(np.array(
            m.get("flags", [config.FLAG_NON_TRANSPARENT | config.FLAG_STATIC] * n_mat),
            np.int32)),
    )
    return make_scene(tris, mats, max_emissive=max_emissive)


def _face_normals_as_vertex(verts, idx):
    """Per-vertex normals by area-weighted face accumulation."""
    n = np.zeros_like(verts)
    fn = np.cross(verts[idx[:, 1]] - verts[idx[:, 0]], verts[idx[:, 2]] - verts[idx[:, 0]])
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def _rot_z(verts, deg, pivot):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    p = np.asarray(pivot, np.float32)
    v = verts - p
    out = v.copy()
    out[:, 0] = c * v[:, 0] - s * v[:, 1]
    out[:, 1] = s * v[:, 0] + c * v[:, 1]
    return (out + p).astype(np.float32)


def cornell_box(furnace: bool = False, light_intensity: float = 17.0) -> Scene:
    """The classic Cornell box (z-up, 2 m cube at origin, +y into the scene);
    furnace=True gives the white-furnace variant (albedo 1, no light)."""
    white = [0.730, 0.735, 0.729]
    red = [0.611, 0.056, 0.062]
    green = [0.117, 0.435, 0.115]
    if furnace:
        white = red = green = [1.0, 1.0, 1.0]
    materials = {
        "base_color": [white, red, green, white, [0.8, 0.8, 0.8]],
        "metalness": [0.0, 0.0, 0.0, 0.0, 0.0],
        "roughness": [1.0, 1.0, 1.0, 1.0, 1.0],
        "emission": [[0, 0, 0], [0, 0, 0], [0, 0, 0],
                     [0, 0, 0] if furnace else [light_intensity] * 3, [0, 0, 0]],
    }
    floor = _quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0])
    ceil = _quad([-1, -1, 2], [-1, 1, 2], [1, 1, 2], [1, -1, 2])
    back = _quad([-1, 1, 0], [1, 1, 0], [1, 1, 2], [-1, 1, 2])
    left = _quad([-1, -1, 0], [-1, 1, 0], [-1, 1, 2], [-1, -1, 2])
    right = _quad([1, -1, 0], [1, -1, 2], [1, 1, 2], [1, 1, 0])
    light = _quad([-0.24, -0.22, 1.98], [-0.24, 0.16, 1.98],
                  [0.23, 0.16, 1.98], [0.23, -0.22, 1.98])
    sb_v, sb_i = make_box([0.33, -0.35, 0.3], [0.6, 0.6, 0.6])
    tb_v, tb_i = make_box([-0.33, 0.28, 0.6], [0.6, 0.6, 1.2])
    sb_v = _rot_z(sb_v, -17.0, [0.33, -0.35, 0])
    tb_v = _rot_z(tb_v, 16.0, [-0.33, 0.28, 0])
    parts = [
        (floor[0], floor[1], None, 0),
        (ceil[0], ceil[1], None, 0),
        (back[0], back[1], None, 0),
        (left[0], left[1], None, 1),   # red
        (right[0], right[1], None, 2),  # green
        (light[0], light[1], None, 3),
        (sb_v, sb_i, None, 4),
        (tb_v, tb_i, None, 4),
    ]
    return _assemble(parts, materials, max_emissive=8)


def shader_balls(grid: int = 3, sphere_res: int = 24) -> Scene:
    """Grid of spheres with varying roughness/metalness over a floor plane.

    Stands in for the ShaderBalls glTF scene (BASELINE config 2): exercises the
    probabilistic diffuse/specular lobe split + ray cones + REBLUR.
    """
    parts = []
    n_mats = grid * grid + 1
    base_color, metal, rough, emission = [], [], [], []
    # floor
    fv, fi = make_plane([0, 0, 0], [20, 20])
    parts.append((fv, fi, None, 0))
    base_color.append([0.5, 0.5, 0.5])
    metal.append(0.0)
    rough.append(0.6)
    emission.append([0, 0, 0])
    mat_id = 1
    for i in range(grid):
        for j in range(grid):
            x = (i - (grid - 1) / 2) * 2.2
            y = (j - (grid - 1) / 2) * 2.2
            sv, si, sn = make_sphere([x, y, 0.9], 0.9, sphere_res, sphere_res + 8)
            parts.append((sv, si, sn, mat_id))
            base_color.append([0.7, 0.3 + 0.5 * i / max(grid - 1, 1), 0.2])
            metal.append(j / max(grid - 1, 1))
            rough.append(np.clip(0.05 + 0.9 * i / max(grid - 1, 1), 0.05, 1.0))
            emission.append([0, 0, 0])
            mat_id += 1
    materials = {
        "base_color": base_color,
        "metalness": metal,
        "roughness": rough,
        "emission": emission,
    }
    return _assemble(parts, materials)


def kitchen(light_intensity: float = 8.0) -> Scene:
    """Interior room with furniture-like boxes, an area light and an open
    wall for the sun (156 triangles)."""
    parts = []
    mats = {
        "base_color": [
            [0.75, 0.73, 0.68],  # walls
            [0.45, 0.30, 0.18],  # wood
            [0.85, 0.85, 0.88],  # appliance (metal)
            [0.9, 0.9, 0.9],     # light
            [0.3, 0.32, 0.35],   # counter
        ],
        "metalness": [0.0, 0.0, 0.9, 0.0, 0.1],
        "roughness": [0.9, 0.5, 0.25, 1.0, 0.35],
        "emission": [[0, 0, 0], [0, 0, 0], [0, 0, 0], [light_intensity] * 3, [0, 0, 0]],
    }
    floor = _quad([-3, -2, 0], [3, -2, 0], [3, 2, 0], [-3, 2, 0])
    ceil = _quad([-3, -2, 3], [-3, 2, 3], [3, 2, 3], [3, -2, 3])
    back = _quad([-3, 2, 0], [3, 2, 0], [3, 2, 3], [-3, 2, 3])
    left = _quad([-3, -2, 0], [-3, 2, 0], [-3, 2, 3], [-3, -2, 3])
    right = _quad([3, -2, 0], [3, -2, 3], [3, 2, 3], [3, 2, 0])
    for q in (floor, ceil, back, left, right):
        parts.append((q[0], q[1], None, 0))
    for k in range(3):
        v, i = make_box([-2 + 2.0 * k, 1.55, 0.45], [1.8, 0.8, 0.9])
        parts.append((v, i, None, 1))
        v, i = make_box([-2 + 2.0 * k, 1.55, 0.95], [1.85, 0.85, 0.08])
        parts.append((v, i, None, 4))
    v, i = make_box([2.5, 1.4, 1.0], [0.9, 0.9, 2.0])
    parts.append((v, i, None, 2))
    v, i = make_box([0, -0.5, 0.75], [1.6, 1.0, 0.07])
    parts.append((v, i, None, 1))
    for dx, dy in ((-0.7, -0.4), (0.7, -0.4), (-0.7, 0.4), (0.7, 0.4)):
        v, i = make_box([dx, -0.5 + dy, 0.36], [0.08, 0.08, 0.72])
        parts.append((v, i, None, 1))
    lv, li = _quad([-0.5, -0.3, 2.97], [-0.5, 0.3, 2.97], [0.5, 0.3, 2.97], [0.5, -0.3, 2.97])
    parts.append((lv, li, None, 3))
    return _assemble(parts, mats, max_emissive=8)
