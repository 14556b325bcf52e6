"""Procedural test scenes (counterpart of ``nrdsample_tpu/scene/procedural.py``):
the Cornell box and its glass variant, the shader balls, the kitchen, the
interior at night, the mirror room and the exterior street block, built with
the same host numpy code (and the same ``RandomState`` draws) so the arrays
equal the JAX builders' exactly."""

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


def cornell_box_glass(light_intensity: float = 17.0) -> Scene:
    """The Cornell box with a glass sphere (FLAG_TRANSPARENT) in place of the
    short box: the record corpus's glass scene, traced through
    ``build_scene_contexts``."""
    sv, si, sn = make_sphere([0.45, -0.4, 1.25], 0.38, 18, 26)
    white = [0.73, 0.735, 0.729]
    materials = {
        "base_color": [white, [0.611, 0.056, 0.062], [0.117, 0.435, 0.115],
                       white, [0.8, 0.8, 0.8], [1.0, 1.0, 1.0]],
        "metalness": [0.0] * 6,
        "roughness": [1.0, 1.0, 1.0, 1.0, 1.0, 0.0],
        "emission": [[0, 0, 0]] * 3 + [[light_intensity] * 3] + [[0, 0, 0]] * 2,
        "ior": [1.5] * 6,
        "flags": [config.FLAG_NON_TRANSPARENT] * 5 + [config.FLAG_TRANSPARENT],
    }
    floor = _quad([-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0])
    ceil = _quad([-1, -1, 2], [-1, 1, 2], [1, 1, 2], [1, -1, 2])
    back = _quad([-1, 1, 0], [1, 1, 0], [1, 1, 2], [-1, 1, 2])
    left = _quad([-1, -1, 0], [-1, 1, 0], [-1, 1, 2], [-1, -1, 2])
    right = _quad([1, -1, 0], [1, -1, 2], [1, 1, 2], [1, 1, 0])
    light = _quad([-0.24, -0.22, 1.98], [-0.24, 0.16, 1.98],
                  [0.23, 0.16, 1.98], [0.23, -0.22, 1.98])
    tb_v, tb_i = make_box([-0.33, 0.28, 0.6], [0.6, 0.6, 1.2])
    tb_v = _rot_z(tb_v, 16.0, [-0.33, 0.28, 0])
    parts = [
        (floor[0], floor[1], None, 0),
        (ceil[0], ceil[1], None, 0),
        (back[0], back[1], None, 0),
        (left[0], left[1], None, 1),
        (right[0], right[1], None, 2),
        (light[0], light[1], None, 3),
        (tb_v, tb_i, None, 4),
        (sv, si, sn, 5),
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


def interior_night(n_lights: int = 12, grid: int = 4, sphere_res: int = 16,
                   light_intensity: float = 25.0) -> Scene:
    """A dark interior lit only by small emissive ceiling panels (the bench
    ladder's interior1440 scene; 15,494 triangles and 24 emitters at the
    defaults): tables with glass (FLAG_TRANSPARENT) and metal spheres. The
    bench and the record corpus trace it in one context (``build_context``),
    the glass spheres among the opaque triangles."""
    parts = []
    base_color = [
        [0.55, 0.5, 0.45],    # walls
        [0.35, 0.25, 0.2],    # floor wood
        [0.9, 0.9, 0.92],     # metal
        [0.95, 0.95, 0.98],   # glass
        [0.6, 0.2, 0.15],     # cloth red
    ]
    metalness = [0.0, 0.0, 0.95, 0.0, 0.0]
    roughness = [0.85, 0.45, 0.15, 0.05, 0.8]
    emission = [[0, 0, 0]] * 5
    flags = [config.FLAG_NON_TRANSPARENT] * 3 + [
        config.FLAG_TRANSPARENT, config.FLAG_NON_TRANSPARENT
    ]
    ior = [1.5] * 5
    rs = np.random.RandomState(7)
    for _ in range(n_lights):
        # warm light colours of varied hue
        c = np.array([1.0, 0.55 + 0.4 * rs.rand(), 0.25 + 0.3 * rs.rand()])
        base_color.append([0.9, 0.9, 0.9])
        metalness.append(0.0)
        roughness.append(1.0)
        emission.append(list(c * light_intensity))
        flags.append(config.FLAG_NON_TRANSPARENT | config.FLAG_FORCED_EMISSION)
        ior.append(1.5)
    mats = {
        "base_color": base_color, "metalness": metalness,
        "roughness": roughness, "emission": emission,
        "flags": flags, "ior": ior,
    }
    # room shell 10x8x4, inward normals, and a wood floor overlay
    v, i = make_box([0, 0, 2.0], [10, 8, 4], flip=True)
    parts.append((v, i, None, 0))
    fv, fi = _quad([-5, -4, 0.01], [5, -4, 0.01], [5, 4, 0.01], [-5, 4, 0.01])
    parts.append((fv, fi, None, 1))
    # tables with a glass and a metal sphere each
    for gx in range(grid):
        for gy in range(2):
            cx = -3.5 + gx * 7.0 / max(grid - 1, 1)
            cy = -2.0 + gy * 4.0
            v, i = make_box([cx, cy, 0.5], [1.2, 1.2, 1.0])
            parts.append((v, i, None, 4))
            sv, si, sn = make_sphere([cx - 0.25, cy, 1.25], 0.22, sphere_res, sphere_res * 2)
            parts.append((sv, si, sn, 3))
            sv, si, sn = make_sphere([cx + 0.3, cy + 0.2, 1.18], 0.16, sphere_res, sphere_res * 2)
            parts.append((sv, si, sn, 2))
    # the emissive ceiling panels
    for k in range(n_lights):
        lx = -4.0 + (k % 4) * 2.6 + rs.rand() * 0.4
        ly = -3.0 + (k // 4) * 2.8 + rs.rand() * 0.4
        s = 0.25 + 0.2 * rs.rand()
        lv, li = _quad([lx - s, ly - s, 3.95], [lx - s, ly + s, 3.95],
                       [lx + s, ly + s, 3.95], [lx + s, ly - s, 3.95])
        parts.append((lv, li, None, 5 + k))
    return _assemble(parts, mats, max_emissive=max(64, 4 * n_lights))


def mirror_room(box_emission: float = 0.0) -> Scene:
    """A planar mirror floor (metalness 1, roughness 0.01: a delta surface
    for the PSR walk) under a floating diffuse box, before a diffuse wall:
    pixels on the mirror export the virtual surface behind it."""
    materials = {
        "base_color": [[0.95, 0.95, 0.95], [0.6, 0.2, 0.2], [0.7, 0.7, 0.7]],
        "metalness": [1.0, 0.0, 0.0],
        "roughness": [0.01, 0.9, 0.9],
        "emission": [[0, 0, 0], [box_emission] * 3, [0, 0, 0]],
    }
    floor_v, floor_i = make_plane([0.0, 0.0, 0.0], [8.0, 8.0])
    box_v, box_i = make_box([0.0, 0.0, 1.0], [1.0, 1.0, 0.6])
    wall = _quad([-4, 4, 0], [4, 4, 0], [4, 4, 4], [-4, 4, 4])
    parts = [
        (floor_v, floor_i, None, 0),   # mirror
        (box_v, box_i, None, 1),       # floating box
        (wall[0], wall[1], None, 2),   # diffuse back wall
    ]
    return _assemble(parts, materials, max_emissive=8)


def exterior(blocks: int = 4, window_grid: int = 6, cobbles: int = 60,
             tree_count: int = 120, tree_res: int = 20, lamp_count: int = 24,
             glass: bool = True, seed: int = 0) -> Scene:
    """A street block (the bench ladder's exterior720 scene): a blocks x
    blocks ring of buildings with glass window panes (FLAG_TRANSPARENT) on
    their street-facing facades, a cobblestone street of jittered boxes, trees
    (a trunk box and a canopy sphere with FLAG_LEAF, the triangle-count
    carrier) and emissive street lamps plus one emissive sign. About 200k
    triangles at the defaults; exterior(cobbles=120, tree_count=450,
    tree_res=28) has 1,058,884."""
    rs = np.random.RandomState(seed)
    parts = []
    m_ground, m_cobble, m_facade, m_roof, m_glass, m_leaf, m_trunk, m_lamp, m_sign = range(9)
    extent = 60.0

    gv, gi = make_plane([0, 0, 0], [extent * 2, extent * 2])
    parts.append((gv, gi, None, m_ground))
    for i in range(cobbles):
        for j in range(cobbles):
            x = (i / max(cobbles - 1, 1) - 0.5) * extent * 1.6
            y = (j / max(cobbles - 1, 1) - 0.5) * extent * 1.6
            s = 0.35 + 0.15 * rs.rand()
            cv, ci = make_box([x + 0.3 * (rs.rand() - 0.5), y + 0.3 * (rs.rand() - 0.5),
                               0.05 + 0.03 * rs.rand()], [s, s, 0.1])
            parts.append((cv, ci, None, m_cobble))

    for bi in range(blocks):
        for bj in range(blocks):
            if 0 < bi < blocks - 1 and 0 < bj < blocks - 1:
                continue   # hollow block: the street in the middle
            bx = (bi / max(blocks - 1, 1) - 0.5) * extent * 1.7
            by = (bj / max(blocks - 1, 1) - 0.5) * extent * 1.7
            w, d = 10.0 + 4.0 * rs.rand(), 8.0 + 4.0 * rs.rand()
            h = 8.0 + 10.0 * rs.rand()
            bv, bidx = make_box([bx, by, h / 2], [w, d, h])
            parts.append((bv, bidx, None, m_facade))
            rv, ri = make_box([bx, by, h + 0.3], [w * 1.08, d * 1.08, 0.6])
            parts.append((rv, ri, None, m_roof))
            if glass:
                for ny in (-1.0, 1.0):
                    fy = by + ny * (d / 2 + 0.02)
                    rows = max(int(h / 2.5), 2)
                    for wr in range(rows):
                        for wc in range(window_grid):
                            wx = bx + (wc / max(window_grid - 1, 1) - 0.5) * (w * 0.8)
                            wz = 1.5 + wr * (h - 2.5) / max(rows - 1, 1)
                            q = _quad([wx - 0.55, fy, wz - 0.7], [wx + 0.55, fy, wz - 0.7],
                                      [wx + 0.55, fy, wz + 0.7], [wx - 0.55, fy, wz + 0.7])
                            parts.append((q[0], q[1], None, m_glass))

    for _ in range(tree_count):
        tx = (rs.rand() - 0.5) * extent * 1.3
        ty = (rs.rand() - 0.5) * extent * 1.3
        th = 2.0 + 1.5 * rs.rand()
        tv, ti = make_box([tx, ty, th / 2], [0.35, 0.35, th])
        parts.append((tv, ti, None, m_trunk))
        cv, ci, cn = make_sphere([tx, ty, th + 1.2], 1.1 + 0.6 * rs.rand(), tree_res, tree_res + 8)
        parts.append((cv, ci, cn, m_leaf))

    for k in range(lamp_count):
        a = 2 * np.pi * k / lamp_count
        lx, ly = np.cos(a) * extent * 0.6, np.sin(a) * extent * 0.6
        pv, pi = make_box([lx, ly, 2.0], [0.15, 0.15, 4.0])
        parts.append((pv, pi, None, m_trunk))
        sv, si, sn = make_sphere([lx, ly, 4.2], 0.3, 8, 12)
        parts.append((sv, si, sn, m_lamp))
    sgn = _quad([-3, -extent * 0.84, 3], [3, -extent * 0.84, 3],
                [3, -extent * 0.84, 4.2], [-3, -extent * 0.84, 4.2])
    parts.append((sgn[0], sgn[1], None, m_sign))

    materials = {
        "base_color": [[0.35, 0.35, 0.36], [0.45, 0.42, 0.4], [0.6, 0.5, 0.42],
                       [0.3, 0.25, 0.23], [0.8, 0.85, 0.9], [0.15, 0.4, 0.12],
                       [0.3, 0.2, 0.12], [1.0, 0.9, 0.7], [0.9, 0.3, 0.6]],
        "metalness": [0.0, 0.0, 0.0, 0.1, 0.0, 0.0, 0.0, 0.0, 0.0],
        "roughness": [0.8, 0.7, 0.75, 0.5, 0.05, 0.8, 0.9, 0.4, 0.3],
        "emission": [[0, 0, 0]] * 7 + [[40.0, 36.0, 28.0], [25.0, 8.0, 17.0]],
        "ior": [1.5] * 9,
        "flags": [config.FLAG_NON_TRANSPARENT] * 4 + [
            config.FLAG_TRANSPARENT if glass else config.FLAG_NON_TRANSPARENT,
            config.FLAG_NON_TRANSPARENT | config.FLAG_LEAF,   # canopies transmit light
        ] + [config.FLAG_NON_TRANSPARENT] * 3,
    }
    return _assemble(parts, materials)   # emissive list sized to keep every lamp
