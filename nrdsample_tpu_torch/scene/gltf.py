"""glTF 2.0 loader and .glb writer (counterpart of
``nrdsample_tpu/scene/gltf.py``).

``load_gltf`` reads a .gltf (JSON with .bin or data-URI buffers) or .glb file
into a world-space ``Scene`` on the device it is given: indexed triangle
meshes under the node hierarchy (TRS or matrix transforms), POSITION /
NORMAL / TEXCOORD_0 / TANGENT, pbrMetallicRoughness materials with emissive
factors and strength, KHR_materials_ior, KHR_materials_transmission or
alphaMode BLEND as FLAG_TRANSPARENT, alphaMode MASK as FLAG_ALPHA_TEST, a
"leaf" or "foliage" material name as FLAG_LEAF; base-colour,
metallic-roughness and emissive textures become a ``TextureSet``. Interleaved
accessors and missing normals go through ``native/gltf_decode.cpp``. 8-bit
non-interlaced PNG textures are decoded here (zlib and the C++ scanline
unfilter); any other image needs Pillow, imported only then.

``save_glb`` writes a Scene as one .glb, a primitive per material, so that a
procedural scene goes through the same load path as a production asset.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct
import zlib

import numpy as np
import torch

from nrdsample_tpu_torch import config, native
from nrdsample_tpu_torch.device import resolve
from nrdsample_tpu_torch.scene import textures as tex_mod
from nrdsample_tpu_torch.scene.types import Materials, Scene, build_triangle_soa, make_scene

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples a pixel


def _load_buffers(doc: dict, base_dir: str, glb_bin: bytes | None) -> list:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin)
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _accessor_layout(doc: dict, buffers, idx: int):
    acc = doc["accessors"][idx]
    view = doc["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride") or (np.dtype(dtype).itemsize * ncomp)
    return acc, buffers[view["buffer"]], dtype, ncomp, offset, stride


def _read_accessor(doc: dict, buffers, idx: int) -> np.ndarray:
    """An accessor as a (count, ncomp) array: packed data as its own dtype,
    interleaved data (byteStride above the element) widened to float32, or
    int64 for uint32 scalars, by ``native.decode_accessor``."""
    acc, buf, dtype, ncomp, offset, stride = _accessor_layout(doc, buffers, idx)
    count = acc["count"]
    if stride == np.dtype(dtype).itemsize * ncomp:
        arr = np.frombuffer(buf, dtype=dtype, count=count * ncomp, offset=offset)
        return np.ascontiguousarray(arr.reshape(count, ncomp))
    as_index = acc["componentType"] == 5125 and ncomp == 1
    return native.decode_accessor(buf, offset, stride, count, ncomp, acc["componentType"],
                                  as_index=as_index)


def _read_accessor_plain(doc: dict, buffers, idx: int) -> np.ndarray:
    """The plain version of ``_read_accessor``'s interleaved case: a numpy
    strided view of the rows, in the accessor's own dtype."""
    acc, buf, dtype, ncomp, offset, stride = _accessor_layout(doc, buffers, idx)
    count, itemsize = acc["count"], np.dtype(dtype).itemsize * ncomp
    raw = np.frombuffer(buf, dtype=np.uint8)
    rows = np.lib.stride_tricks.as_strided(raw[offset:], shape=(count, itemsize),
                                           strides=(stride, 1), writeable=False)
    return np.ascontiguousarray(rows).view(dtype).reshape(count, ncomp)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    t = node.get("translation", [0, 0, 0])
    x, y, z, w = node.get("rotation", [0, 0, 0, 1])   # xyzw quaternion
    s = node.get("scale", [1, 1, 1])
    rot = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    m[:3, :3] = rot * np.array(s, np.float32)[None, :]
    m[:3, 3] = t
    return m


def _parse_glb(data: bytes):
    magic, _version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file (bad magic)")
    offset, doc, binary = 12, None, None
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8: offset + 8 + clen]
        if ctype == 0x4E4F534A:    # JSON
            doc = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:  # BIN
            binary = chunk
        offset += 8 + clen
    return doc, binary


def decode_png(data: bytes) -> np.ndarray | None:
    """An 8-bit, non-interlaced PNG (grey, grey + alpha, RGB, RGBA or
    palette; any of the five filters; tRNS transparency) as an (H, W, 4)
    uint8 RGBA array, as Pillow's ``convert("RGBA")`` gives it. None for any
    other PNG (16-bit, fewer bits, interlaced)."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG file")
    pos, idat, palette, trns, header = 8, [], None, None, None
    while pos + 8 <= len(data):
        length, tag = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8: pos + 8 + length]
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack_from(">I", data, pos + 8 + length)[0]:
            raise ValueError(f"PNG chunk {tag!r}: CRC mismatch")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        return None
    ch = _PNG_CHANNELS[ctype]
    px = native.png_unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if ctype == 3:                                     # palette
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:len(palette)]
        return np.concatenate([palette, alpha[:, None]], axis=1)[px[..., 0]]
    if ch in (2, 4):                                   # grey or RGB with alpha
        rgb, a = px[..., :ch - 1], px[..., ch - 1:]
    else:
        rgb = px
        a = np.full((h, w, 1), 255, np.uint8)
        if trns is not None:                           # one transparent colour
            key = np.frombuffer(trns, ">u2").astype(np.uint8)[:ch]
            a[(rgb == key).all(-1)] = 0
    if rgb.shape[-1] == 1:
        rgb = np.repeat(rgb, 3, axis=-1)
    return np.ascontiguousarray(np.concatenate([rgb, a], axis=-1))


def _decode_image(doc, buffers, base_dir, image_idx) -> np.ndarray:
    """A glTF image (bufferView or URI) as float32 RGBA in [0, 1], (H, W, 4)."""
    img = doc["images"][image_idx]
    if "bufferView" in img:
        bv = doc["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        data = buffers[bv["buffer"]][off:off + bv["byteLength"]]
    else:
        uri = img["uri"]
        if uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                data = f.read()
    rgba = decode_png(data) if data.startswith(_PNG_MAGIC) else None
    if rgba is None:
        try:
            import io

            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f"glTF image {image_idx} is not an 8-bit non-interlaced PNG; "
                               "decoding it needs Pillow, which is not installed") from e
        rgba = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    return np.asarray(rgba, np.float32) / 255.0


def _material_textures(doc, buffers, base_dir, mats, tex_res):
    """The TextureSet of the materials' base-colour (with alpha),
    metallic-roughness (G roughness, B metalness) and emissive textures, or
    None when no material has one."""
    def tex_image(tex_info):
        if not tex_info:
            return None
        tex = doc["textures"][tex_info["index"]]
        if "source" not in tex:
            return None
        return _decode_image(doc, buffers, base_dir, tex["source"])

    per_material, any_tex = [], False
    for m in mats or [{}]:
        pbr = m.get("pbrMetallicRoughness", {})
        entry = {}
        bc = tex_image(pbr.get("baseColorTexture"))
        if bc is not None:
            entry["base_color"] = bc   # RGBA: the builder takes the alpha
        mr = tex_image(pbr.get("metallicRoughnessTexture"))
        if mr is not None:
            entry["roughness"] = mr[..., 1]
            entry["metalness"] = mr[..., 2]
        em = tex_image(m.get("emissiveTexture"))
        if em is not None:
            entry["emissive"] = em[..., :3].mean(axis=-1)
        any_tex = any_tex or bool(entry)
        per_material.append(entry)
    return tex_mod.build_texture_set(per_material, res=tex_res) if any_tex else None


def _flat_normals(verts: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals of an index mesh (``native.accumulate_normals``), unit length."""
    n = native.accumulate_normals(verts, idx)
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)).astype(np.float32)


def load_gltf(path: str, max_emissive: int | None = None, load_textures: bool = True,
              tex_res: int = 256, device=None) -> Scene:
    """A .gltf / .glb file as a Scene in world space on ``device`` (the CUDA
    card when None), its textures resampled to ``tex_res``."""
    device = resolve(device)
    base_dir = os.path.dirname(os.path.abspath(path))
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            doc, glb_bin = _parse_glb(f.read())
    else:
        with open(path) as f:
            doc = json.load(f)
        glb_bin = None
    buffers = _load_buffers(doc, base_dir, glb_bin)

    mats = doc.get("materials", [{}])
    base_color, metalness, roughness, emission, ior, flags = [], [], [], [], [], []
    for m in mats or [{}]:
        pbr = m.get("pbrMetallicRoughness", {})
        ext = m.get("extensions", {})
        base_color.append(pbr.get("baseColorFactor", [1, 1, 1, 1])[:3])
        metalness.append(pbr.get("metallicFactor", 1.0))
        roughness.append(pbr.get("roughnessFactor", 1.0))
        strength = ext.get("KHR_materials_emissive_strength", {}).get("emissiveStrength", 1.0)
        emission.append([c * strength for c in m.get("emissiveFactor", [0, 0, 0])])
        ior.append(ext.get("KHR_materials_ior", {}).get("ior", 1.5))
        transmissive = "KHR_materials_transmission" in ext or m.get("alphaMode") == "BLEND"
        # glTF geometry is static scenery
        fl = (config.FLAG_TRANSPARENT if transmissive else config.FLAG_NON_TRANSPARENT)
        fl |= config.FLAG_STATIC
        if m.get("alphaMode") == "MASK":
            fl |= config.FLAG_ALPHA_TEST
        name = m.get("name", "").lower()
        if "leaf" in name or "foliage" in name:
            fl |= config.FLAG_LEAF
        flags.append(fl)
    if not mats:
        base_color, metalness, roughness = [[0.8, 0.8, 0.8]], [0.0], [0.9]
        emission, ior = [[0, 0, 0]], [1.5]
        flags = [config.FLAG_NON_TRANSPARENT | config.FLAG_STATIC]

    all_v, all_n, all_uv, all_i, all_m, all_t = [], [], [], [], [], []
    voffset = 0

    def visit(node_idx: int, parent: np.ndarray):
        nonlocal voffset
        node = doc["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        for prim in doc["meshes"][node["mesh"]]["primitives"] if "mesh" in node else ():
            if prim.get("mode", 4) != 4:   # TRIANGLES only
                continue
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            pos_w = pos @ world[:3, :3].T + world[:3, 3]
            nrm_w = None
            if "NORMAL" in attrs:
                nrm = _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                # by the normal matrix, the inverse transpose of world's 3x3
                nrm_w = nrm @ np.linalg.inv(world[:3, :3]).T.T
                nrm_w /= np.maximum(np.linalg.norm(nrm_w, axis=-1, keepdims=True), 1e-20)
            uv = (_read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else np.zeros((len(pos), 2), np.float32))
            tan_w = None
            if "TANGENT" in attrs:
                tan = _read_accessor(doc, buffers, attrs["TANGENT"]).astype(np.float32)
                tan_w = np.concatenate([tan[:, :3] @ world[:3, :3].T, tan[:, 3:4]], axis=-1)
                tan_w[:, :3] /= np.maximum(np.linalg.norm(tan_w[:, :3], axis=-1, keepdims=True),
                                           1e-20)
            if "indices" in prim:
                idx = _read_accessor(doc, buffers, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(len(pos), dtype=np.uint32)
            idx = idx.astype(np.int64).reshape(-1, 3)
            all_v.append(pos_w)
            all_n.append(nrm_w if nrm_w is not None else _flat_normals(pos_w, idx))
            all_uv.append(uv)
            all_t.append(tan_w)
            all_i.append(idx + voffset)
            all_m.append(np.full(len(idx), prim.get("material", 0), np.int32))
            voffset += len(pos)
        for child in node.get("children", []):
            visit(child, world)

    for root in doc["scenes"][doc.get("scene", 0)]["nodes"]:
        visit(root, np.eye(4, dtype=np.float32))

    # tangents only if every primitive carries them (else UV-derived ones)
    tangents = np.concatenate(all_t) if all_t and all(t is not None for t in all_t) else None
    tris = build_triangle_soa(np.concatenate(all_v), np.concatenate(all_i).astype(np.int32),
                              np.concatenate(all_n), np.concatenate(all_uv),
                              np.concatenate(all_m), tangents=tangents)
    f32 = lambda v: torch.tensor(np.array(v, np.float32))
    materials = Materials(base_color=f32(base_color), metalness=f32(metalness),
                          roughness=f32(roughness), emission=f32(emission), ior=f32(ior),
                          flags=torch.tensor(np.array(flags, np.int32)))
    scene = make_scene(tris, materials, max_emissive=max_emissive)
    if load_textures:
        ts = _material_textures(doc, buffers, base_dir, mats, tex_res)
        if ts is not None:
            has_at = bool((np.array(flags) & config.FLAG_ALPHA_TEST).any())
            scene = dataclasses.replace(scene, textures=ts, has_alpha_test=has_at)
    return scene.to(device)


def save_glb(scene: Scene, path: str) -> None:
    """Write ``scene`` as a binary glTF: one primitive per material in use
    (an unindexed triangle soup, so triangles come back grouped by
    material), the material constants as pbrMetallicRoughness and KHR
    extensions, FLAG_TRANSPARENT as KHR_materials_transmission,
    FLAG_ALPHA_TEST as alphaMode MASK and FLAG_LEAF as a "leaf" name.
    Textures are not written."""
    def host(t):
        return t.detach().cpu().numpy()

    tris = scene.tris
    p0 = host(tris.p0).astype(np.float32)
    p1 = p0 + host(tris.e1)
    p2 = p0 + host(tris.e2)
    n = [host(getattr(tris, f"n{k}")) for k in range(3)]
    uv = [host(getattr(tris, f"uv{k}")) for k in range(3)]
    tri_mat = host(tris.material).astype(np.int32)
    mats = scene.materials
    m_bc, m_metal, m_rough = host(mats.base_color), host(mats.metalness), host(mats.roughness)
    m_em, m_ior, m_fl = host(mats.emission), host(mats.ior), host(mats.flags).astype(np.int32)

    bin_parts: list[bytes] = []
    nbytes = 0
    views, accessors, materials_json, primitives = [], [], [], []

    def add_accessor(arr: np.ndarray, gltf_type: str, with_minmax=False):
        nonlocal nbytes
        data = np.ascontiguousarray(arr, np.float32)
        raw = data.tobytes()
        bin_parts.append(raw + b"\0" * ((4 - len(raw) % 4) % 4))
        views.append({"buffer": 0, "byteOffset": nbytes, "byteLength": len(raw)})
        nbytes += len(bin_parts[-1])
        acc = {"bufferView": len(views) - 1, "componentType": 5126, "count": len(data),
               "type": gltf_type}
        if with_minmax:
            acc["min"] = data.min(axis=0).tolist()
            acc["max"] = data.max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    for mi in range(len(m_bc)):
        sel = tri_mat == mi
        if not sel.any():
            continue
        # per-vertex order v0 v1 v2 of each triangle
        order = np.arange(3 * int(sel.sum())).reshape(3, -1).T.reshape(-1)
        pos = np.concatenate([p0[sel], p1[sel], p2[sel]])[order]
        nrm = np.concatenate([n[0][sel], n[1][sel], n[2][sel]])[order]
        tc = np.concatenate([uv[0][sel], uv[1][sel], uv[2][sel]])[order]
        primitives.append({
            "attributes": {"POSITION": add_accessor(pos, "VEC3", with_minmax=True),
                           "NORMAL": add_accessor(nrm, "VEC3"),
                           "TEXCOORD_0": add_accessor(tc, "VEC2")},
            "material": len(materials_json), "mode": 4,
        })
        fl, em = int(m_fl[mi]), m_em[mi]
        strength = float(em.max())
        mat = {
            "name": ("leaf_" if fl & config.FLAG_LEAF else "") + f"mat{mi}",
            "pbrMetallicRoughness": {"baseColorFactor": m_bc[mi].tolist() + [1.0],
                                     "metallicFactor": float(m_metal[mi]),
                                     "roughnessFactor": float(m_rough[mi])},
            "extensions": {"KHR_materials_ior": {"ior": float(m_ior[mi])}},
        }
        if strength > 0:
            mat["emissiveFactor"] = (em / max(strength, 1e-9)).tolist()
            mat["extensions"]["KHR_materials_emissive_strength"] = {"emissiveStrength": strength}
        if fl & config.FLAG_TRANSPARENT:
            mat["extensions"]["KHR_materials_transmission"] = {"transmissionFactor": 1.0}
        if fl & config.FLAG_ALPHA_TEST:
            mat["alphaMode"] = "MASK"
        materials_json.append(mat)

    blob = b"".join(bin_parts)
    doc = {
        "asset": {"version": "2.0", "generator": "nrdsample_tpu"},
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": primitives}], "materials": materials_json,
        "buffers": [{"byteLength": len(blob)}], "bufferViews": views, "accessors": accessors,
        "extensionsUsed": ["KHR_materials_ior", "KHR_materials_emissive_strength",
                           "KHR_materials_transmission"],
    }
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)
