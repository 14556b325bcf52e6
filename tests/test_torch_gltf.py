"""The port's glTF path (``scene/gltf.py``, ``native/gltf_decode.cpp``)
against the JAX package's.

The cases of tests/test_gltf.py run through both packages' ``load_gltf`` on
the same files, written by the test: every array of the two scenes
(triangles, materials, emitters, texture levels) is equal, bit for bit.
``save_glb`` writes the same bytes as the JAX package's, and the exterior
written by it loads back to the JAX loader's arrays of that file (the
triangles come back grouped by material, so the round trip is held to the
file, not to the procedural scene). The C++ strided decode equals the numpy
strided view and the normal sums equal ``np.add.at``'s within 1e-4 (their
order of adds differs). The PNG decoder equals Pillow's ``convert("RGBA")``
on every 8-bit colour type and filter; other images need Pillow, which is
imported only then."""

import base64
import dataclasses
import io
import json
import struct
import sys

import numpy as np
import pytest
import torch

from nrdsample_tpu import config as jconfig, native as jnative
from nrdsample_tpu.ops import traversal as jtraversal
from nrdsample_tpu.scene import gltf as jgltf, procedural as jproc
from nrdsample_tpu_torch import config, native
from nrdsample_tpu_torch.ops import traversal
from nrdsample_tpu_torch.scene import gltf, procedural
from nrdsample_tpu_torch.utils import image
from torch_session_cache import _session_lock, share_cores_between_workers

share_cores_between_workers()


@pytest.fixture(scope="module")
def jax_gltf_native(tmp_path_factory):
    """The JAX package's glTF decoder loaded in this process (its loader caches
    None in a process that loses the compile race of a fresh cache, and then
    decodes with numpy)."""
    with _session_lock(tmp_path_factory, "jax_native_gltf"):
        for _ in range(20):
            if jnative._LIBS.get("gltf_decode", True) is None:
                del jnative._LIBS["gltf_decode"]
            if jnative._gltf_lib() is not None:
                return
    pytest.fail("the JAX package's nrdsample_tpu/native/gltf_decode.cpp did not load")


def _assert_same_scene(got, want, textures=True):
    """Every leaf of the port's CPU scene equals the JAX scene's."""
    for part in ("tris", "materials"):
        for f in dataclasses.fields(getattr(got, part)):
            a = getattr(getattr(got, part), f.name).numpy()
            b = np.asarray(getattr(getattr(want, part), f.name))
            assert a.dtype == b.dtype, (part, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{part}.{f.name}")
    np.testing.assert_array_equal(got.emissive_tris.numpy(), np.asarray(want.emissive_tris))
    assert int(got.emissive_count) == int(want.emissive_count)
    assert got.has_emissive == want.has_emissive and got.has_alpha_test == want.has_alpha_test
    assert (got.textures is None) == (want.textures is None)
    if textures and got.textures is not None:
        assert got.textures.n_mips == want.textures.n_mips
        for a, b in zip(got.textures.levels, want.textures.levels):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _load_both(path, **kw):
    got = gltf.load_gltf(path, device="cpu", **kw)
    want = jgltf.load_gltf(path, **kw)
    _assert_same_scene(got, want)
    return got, want


def _make_gltf(tmp_path, transform=None):
    """tests/test_gltf.py's quad: two triangles, one emissive material."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    normals = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    buf = verts.tobytes() + normals.tobytes() + idx.tobytes()
    node = {"mesh": 0}
    node.update(transform or {})
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [node],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2,
                                    "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {"baseColorFactor": [0.8, 0.2, 0.1, 1.0],
                                     "metallicFactor": 0.3, "roughnessFactor": 0.6},
            "emissiveFactor": [1.0, 0.5, 0.25],
            "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 4.0}},
        }],
        "buffers": [{"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 48, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 96, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    p = tmp_path / "test.gltf"
    p.write_text(json.dumps(doc))
    return str(p)


def test_load_quad(tmp_path):
    scene, _ = _load_both(_make_gltf(tmp_path))
    assert scene.num_tris == 2
    np.testing.assert_allclose(scene.materials.base_color[0].numpy(), [0.8, 0.2, 0.1], atol=1e-6)
    assert float(scene.materials.metalness[0]) == pytest.approx(0.3)
    np.testing.assert_allclose(scene.materials.emission[0].numpy(), [4.0, 2.0, 1.0], atol=1e-6)
    assert scene.has_emissive and int(scene.emissive_count) == 2
    np.testing.assert_allclose(scene.tris.world_area.numpy(), 0.5, atol=1e-6)


@pytest.mark.parametrize("transform", [
    {"translation": [5, 0, 0], "scale": [2, 2, 2]},
    {"rotation": [0.0, 0.3826834, 0.0, 0.9238795], "translation": [0, 1, 2]},
    {"matrix": [2, 0, 0, 0, 0, 1, 0, 0, 0, 0, 3, 0, 1, 2, 3, 1]},
])
def test_node_transform_applied(tmp_path, transform):
    """TRS and matrix nodes; the normals go through the inverse transpose."""
    scene, _ = _load_both(_make_gltf(tmp_path, transform=transform))
    if "scale" in transform:
        assert scene.tris.p0[:, 0].min() >= 5.0
        np.testing.assert_allclose(scene.tris.world_area.numpy(), 2.0, atol=1e-5)


def _glb_of(src, tmp_path):
    doc = json.loads(open(src).read())
    blob = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])
    doc["buffers"][0] = {"byteLength": len(blob)}
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    blob += b"\x00" * ((4 - len(blob) % 4) % 4)
    glb = (struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob))
           + struct.pack("<II", len(js), 0x4E4F534A) + js
           + struct.pack("<II", len(blob), 0x004E4942) + blob)
    p = tmp_path / "test.glb"
    p.write_bytes(glb)
    return str(p)


def test_glb_roundtrip(tmp_path):
    scene, _ = _load_both(_glb_of(_make_gltf(tmp_path), tmp_path))
    assert scene.num_tris == 2


def _png_bytes(img: np.ndarray, tmp_path) -> bytes:
    """An RGB PNG of img written by the port's utils/image.write_png."""
    path = tmp_path / "tex.png"
    image.write_png(str(path), img)
    return path.read_bytes()


def _make_textured_gltf(tmp_path, png: bytes, name="textured.gltf", uri=True):
    """tests/test_gltf.py's textured quad (uvs, alphaMode MASK, no normals)
    with the given base-colour PNG, as a data URI or a file beside it."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    buf = verts.tobytes() + uvs.tobytes() + idx.tobytes()
    if uri:
        image_ref = {"uri": "data:image/png;base64," + base64.b64encode(png).decode()}
    else:
        (tmp_path / "base.png").write_bytes(png)
        image_ref = {"uri": "base.png"}
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "materials": [{"alphaMode": "MASK", "name": "Foliage_leaf",
                       "pbrMetallicRoughness": {"baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                                                "baseColorTexture": {"index": 0},
                                                "metallicRoughnessTexture": {"index": 0}},
                       "emissiveTexture": {"index": 0}}],
        "textures": [{"source": 0}],
        "images": [image_ref],
        "buffers": [{"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode()}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                        {"buffer": 0, "byteOffset": 48, "byteLength": 32},
                        {"buffer": 0, "byteOffset": 80, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    p = tmp_path / name
    p.write_text(json.dumps(doc))
    return str(p)


def _rgba_png(tmp_path):
    """tests/test_gltf.py's texture: a red 4x4 RGBA PNG, left half alpha 0."""
    from PIL import Image

    img = np.zeros((4, 4, 4), np.uint8)
    img[..., 0], img[..., 3] = 255, 255
    img[:, :2, 3] = 0
    bio = io.BytesIO()
    Image.fromarray(img).save(bio, format="PNG")
    return bio.getvalue()


def test_textures_loaded_and_alpha_flagged(tmp_path, jax_gltf_native):
    scene, _ = _load_both(_make_textured_gltf(tmp_path, _rgba_png(tmp_path)), tex_res=16)
    assert scene.textures is not None and scene.has_alpha_test
    assert bool((scene.materials.flags & config.FLAG_ALPHA_TEST).any())
    assert bool((scene.materials.flags & config.FLAG_LEAF).any())
    lvl0 = scene.textures.levels[0].numpy()
    assert lvl0.shape[0] == 1 and lvl0[0, :, 8:, 0].mean() > 0.9
    alpha = lvl0[0, :, :, 3]
    assert alpha[:, :4].mean() < 0.2 and alpha[:, 12:].mean() > 0.9


def test_textured_scene_traces_through_alpha(tmp_path, jax_gltf_native):
    path = _make_textured_gltf(tmp_path, _rgba_png(tmp_path))
    scene, jscene = _load_both(path, tex_res=16)
    ctx, sc = traversal.build_context(scene, device="cpu")
    jctx, jsc = jtraversal.build_context(jscene)
    o = np.array([[0.25, 0.5, 1.0], [0.75, 0.5, 1.0]], np.float32)
    d = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]], np.float32)
    got = traversal.closest_hit_alpha(ctx, sc, torch.from_numpy(o), torch.from_numpy(d))
    want = jtraversal.closest_hit_alpha(jctx, jsc, o, d)
    np.testing.assert_array_equal(got["tri"].numpy(), np.asarray(want["tri"]))
    assert int(got["tri"][0]) < 0 and int(got["tri"][1]) >= 0


def test_write_png_texture_through_both_loaders(tmp_path, jax_gltf_native):
    """A PNG written by utils/image.write_png (RGB, filter 0) as a file beside
    the .gltf: both loaders give the same texture set."""
    rs = np.random.RandomState(0)
    png = _png_bytes(rs.rand(32, 16, 3).astype(np.float32), tmp_path)
    scene, _ = _load_both(_make_textured_gltf(tmp_path, png, uri=False), tex_res=32)
    assert scene.textures.n_mips == 6


def test_glb_roundtrip_exterior(tmp_path, jax_gltf_native):
    """save_glb of the small exterior writes the JAX package's bytes, and
    load_gltf of that file gives the JAX loader's arrays; geometry, material
    constants and the TRANSPARENT / LEAF flags survive the round trip."""
    kw = dict(blocks=2, window_grid=2, cobbles=6, tree_count=4, tree_res=6, lamp_count=2)
    scene = procedural.exterior(**kw)
    path, jpath = str(tmp_path / "exterior.glb"), str(tmp_path / "exterior_jax.glb")
    gltf.save_glb(scene, path)
    jgltf.save_glb(jproc.exterior(**kw), jpath)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    loaded, _ = _load_both(path)
    assert loaded.tris.count == scene.tris.count
    np.testing.assert_allclose(scene.tris.p0.numpy().min(0), loaded.tris.p0.numpy().min(0), atol=1e-4)
    np.testing.assert_allclose(scene.tris.p0.numpy().max(0), loaded.tris.p0.numpy().max(0), atol=1e-4)
    src_fl, dst_fl = scene.materials.flags.numpy(), loaded.materials.flags.numpy()
    assert (dst_fl & config.FLAG_TRANSPARENT).any() == (src_fl & config.FLAG_TRANSPARENT).any()
    assert (dst_fl & config.FLAG_LEAF).any()
    src_bc = scene.materials.base_color.numpy()[scene.tris.material.numpy()]
    dst_bc = loaded.materials.base_color.numpy()[loaded.tris.material.numpy()]
    np.testing.assert_allclose(np.sort(src_bc.sum(1)), np.sort(dst_bc.sum(1)), atol=1e-5)
    assert np.isclose(scene.materials.emission.max(), loaded.materials.emission.max(), atol=1e-3)


def test_strided_accessor_native_and_plain(jax_gltf_native):
    """Interleaved vertex buffers (byteStride above the element) decode
    through gltf_decode.cpp as the numpy strided view does, as the JAX
    loader decodes them; uint32 indices widen to int64."""
    rs = np.random.RandomState(5)
    count = 37
    pos = rs.standard_normal((count, 3)).astype(np.float32)
    nrm = rs.standard_normal((count, 3)).astype(np.float32)
    ids = rs.randint(0, 1 << 31, count).astype(np.uint32)
    inter = np.concatenate([pos, nrm, ids.view(np.float32)[:, None],
                            np.zeros((count, 1), np.float32)], axis=1)
    buf = inter.tobytes()
    doc = {"bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(buf),
                            "byteStride": 32}],
           "accessors": [
               {"bufferView": 0, "componentType": 5126, "count": count, "type": "VEC3"},
               {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": count,
                "type": "VEC3"},
               {"bufferView": 0, "byteOffset": 24, "componentType": 5125, "count": count,
                "type": "SCALAR"}]}
    for i, want in enumerate((pos, nrm, ids[:, None])):
        got = gltf._read_accessor(doc, [buf], i)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gltf._read_accessor_plain(doc, [buf], i), want)
        np.testing.assert_array_equal(got, jgltf._read_accessor(doc, [buf], i))
    assert gltf._read_accessor(doc, [buf], 2).dtype == np.int64
    with pytest.raises(ValueError, match="rejected"):
        native.decode_accessor(buf, 0, 32, count + 1, 3, 5126)


def test_native_normal_accumulation_matches_numpy(jax_gltf_native):
    rs = np.random.RandomState(9)
    verts = rs.standard_normal((50, 3)).astype(np.float32)
    idx = rs.randint(0, 50, (40, 3)).astype(np.int64)
    got = native.accumulate_normals(verts, idx)
    ref = np.zeros_like(verts)
    fn = np.cross(verts[idx[:, 1]] - verts[idx[:, 0]], verts[idx[:, 2]] - verts[idx[:, 0]])
    for k in range(3):
        np.add.at(ref, idx[:, k], fn)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_array_equal(got, jnative.accumulate_normals(verts, idx))
    with pytest.raises(ValueError, match="out of range"):
        native.accumulate_normals(verts, idx + 50)


def _pillow_png(arr_or_img, **save):
    from PIL import Image

    img = arr_or_img if isinstance(arr_or_img, Image.Image) else Image.fromarray(arr_or_img)
    bio = io.BytesIO()
    img.save(bio, format="PNG", **save)
    return bio.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_decoder_matches_pillow(mode):
    """Each 8-bit colour type, stored unfiltered and with Pillow's adaptive
    filters (all five filter types), and with tRNS transparency."""
    from PIL import Image

    rs = np.random.RandomState(len(mode))
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 3}[mode]
    arr = rs.randint(0, 256, (37, 29, ch)).astype(np.uint8)
    arr[:12] = (np.arange(29)[None, :, None] * 7 % 256).astype(np.uint8)   # smooth rows
    img = Image.fromarray(arr[..., 0] if ch == 1 else arr, "RGB" if mode == "P" else mode)
    if mode == "P":
        img = img.convert("P", palette=Image.ADAPTIVE, colors=200)
    cases = [dict(compress_level=0), dict(optimize=True)]
    if mode in ("L", "RGB", "P"):
        cases.append(dict(transparency={"L": 7, "RGB": (1, 2, 3), "P": 5}[mode]))
    for save in cases:
        data = _pillow_png(img, **save)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
        np.testing.assert_array_equal(gltf.decode_png(data), want, err_msg=str(save))


def test_png_other_formats_need_pillow(tmp_path, monkeypatch):
    """A 4-bit palette PNG is not decoded here; _decode_image hands it to
    Pillow and, with Pillow missing, raises naming it."""
    from PIL import Image

    rs = np.random.RandomState(1)
    img = Image.fromarray(rs.randint(0, 256, (9, 9, 3)).astype(np.uint8)).convert(
        "P", palette=Image.ADAPTIVE, colors=13)
    data = _pillow_png(img)
    assert gltf.decode_png(data) is None
    doc = {"images": [{"uri": "data:image/png;base64," + base64.b64encode(data).decode()}]}
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / 255.0
    np.testing.assert_array_equal(gltf._decode_image(doc, [], str(tmp_path), 0), want)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        gltf._decode_image(doc, [], str(tmp_path), 0)
    png = _png_bytes(np.zeros((4, 4, 3), np.float32), tmp_path)   # PNG needs no Pillow
    doc["images"][0]["uri"] = "data:image/png;base64," + base64.b64encode(png).decode()
    assert gltf._decode_image(doc, [], str(tmp_path), 0).shape == (4, 4, 4)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A g++ failure raises with the compiler's message: no numpy fallback."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ["-DGLTF_BROKEN", "-include",
                                                                   "no_such_header.h"])
    monkeypatch.setattr(native, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.decode_accessor(b"\0" * 64, 0, 16, 2, 3, 5126)


def test_load_gltf_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gltf.load_gltf(_make_gltf(tmp_path))
