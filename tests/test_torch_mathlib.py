"""The port's mathlib against the JAX package's, on the same numpy inputs.

The RNG streams must be bit-exact (the whole frame rests on them); the float
helpers agree within 1e-6 abs/rel — a few float32 ULPs, which is what
torch's and XLA's pow/exp2/sin/cos/rsqrt implementations may differ by.
The low-discrepancy sequences are exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.mathlib import brdf as jbrdf, color as jcolor, geometry as jgeo
from nrdsample_tpu.mathlib import rng as jrng, sampling as jsampling
from nrdsample_tpu_torch.mathlib import brdf, color, geometry as geo, rng, sampling
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

TOL = 1e-6
N = 4096
RS = np.random.RandomState(7)


def _unit(n):
    v = RS.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


VEC_A = RS.randn(N, 3).astype(np.float32)
VEC_B = RS.randn(N, 3).astype(np.float32)
UNIT_N = _unit(N)
UNIT_V = _unit(N)
V_LOCAL = np.abs(_unit(N))  # upper hemisphere
RND2 = RS.uniform(0, 1, (N, 2)).astype(np.float32)
S01 = RS.uniform(-0.2, 1.2, N).astype(np.float32)
ROUGH = RS.uniform(0.02, 1.0, N).astype(np.float32)
COL = RS.uniform(0, 1.5, (N, 3)).astype(np.float32)

# (name, jax fn, torch fn, args): each fn takes the same numpy-built arguments
CASES = [
    ("dot3", jgeo.dot3, geo.dot3, (VEC_A, VEC_B)),
    ("length", jgeo.length, geo.length, (VEC_A,)),
    ("normalize", jgeo.normalize, geo.normalize, (VEC_A,)),
    ("cross", jgeo.cross, geo.cross, (VEC_A, VEC_B)),
    ("basis_t", lambda n: jgeo.orthonormal_basis(n)[0], lambda n: geo.orthonormal_basis(n)[0], (UNIT_N,)),
    ("basis_b", lambda n: jgeo.orthonormal_basis(n)[1], lambda n: geo.orthonormal_basis(n)[1], (UNIT_N,)),
    ("reflect", jgeo.reflect, geo.reflect, (UNIT_V, UNIT_N)),
    ("offset_ray", lambda p, n, z: jgeo.offset_ray(p, n, z, 0.01, 0.25),
     lambda p, n, z: geo.offset_ray(p, n, z, 0.01, 0.25), (VEC_A, UNIT_N, S01)),
    ("smoothstep_up", lambda x: jgeo.smoothstep(0.03, 0.1, x), lambda x: geo.smoothstep(0.03, 0.1, x), (S01,)),
    ("smoothstep_down", lambda x: jgeo.smoothstep(0.2, 0.0, x), lambda x: geo.smoothstep(0.2, 0.0, x), (S01,)),
    ("pow01", lambda x: jgeo.pow01(x, 4.85), lambda x: geo.pow01(x, 4.85), (S01,)),
    ("pow01_half", lambda x: jgeo.pow01(x, 0.5), lambda x: geo.pow01(x, 0.5), (S01,)),
    ("sqrt01", jgeo.sqrt01, geo.sqrt01, (S01,)),
    ("positive_rcp", jgeo.positive_rcp, geo.positive_rcp, (S01,)),
    ("luminance", jcolor.luminance, color.luminance, (COL,)),
    ("from_gamma", jcolor.from_gamma, color.from_gamma, (COL,)),
    ("cosine_ray", jsampling.cosine_ray, sampling.cosine_ray, (RND2,)),
    ("vndf_ggx", lambda r, v, a: jsampling.vndf_ggx(r, v, a, 0.95),
     lambda r, v, a: sampling.vndf_ggx(r, v, a, 0.95), (RND2, V_LOCAL, ROUGH)),
    ("ggx_d", jsampling.ggx_d, sampling.ggx_d, (S01, ROUGH)),
    ("smith_g1", jsampling.smith_g1, sampling.smith_g1, (S01, ROUGH)),
    ("to_world", jsampling.to_world, sampling.to_world, (UNIT_V, UNIT_N)),
    ("to_local", jsampling.to_local, sampling.to_local, (UNIT_V, UNIT_N)),
    ("fresnel_schlick", jbrdf.fresnel_schlick, brdf.fresnel_schlick, (COL, S01)),
    ("smith_g2", jbrdf.smith_g2_correlated, brdf.smith_g2_correlated, (S01, S01[::-1].copy(), ROUGH)),
    ("f0_albedo_albedo", lambda c, m: jbrdf.base_color_to_f0_albedo(c, m)[0],
     lambda c, m: brdf.base_color_to_f0_albedo(c, m)[0], (COL, S01)),
    ("f0_albedo_f0", lambda c, m: jbrdf.base_color_to_f0_albedo(c, m)[1],
     lambda c, m: brdf.base_color_to_f0_albedo(c, m)[1], (COL, S01)),
    ("environment_term", jbrdf.environment_term_rtg, brdf.environment_term_rtg, (COL, S01, ROUGH)),
]


@pytest.mark.parametrize("name,jfn,tfn,args", CASES, ids=[c[0] for c in CASES])
def test_float_helpers_match_jax(name, jfn, tfn, args):
    want = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = tfn(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _hash_inputs(n=200_000):
    rs = np.random.RandomState(0)
    pixel = rs.randint(0, 1920 * 1080, n).astype(np.int32)
    frame = rs.randint(0, 301, n).astype(np.int32)
    dim = rs.randint(0, 30_001, n).astype(np.int32)
    # the extremes of each range
    pixel[:4] = [0, 1920 * 1080 - 1, 0, 1920 * 1080 - 1]
    frame[:4] = [0, 300, 300, 0]
    dim[:4] = [30_000, 0, 30_000, 0]
    return pixel, frame, dim


def test_pcg4d_bit_exact():
    v = np.random.RandomState(1).randint(0, 2**32, (100_000, 4), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jrng.pcg4d(jnp.asarray(v))).astype(np.int64)
    got = rng.pcg4d(torch.from_numpy(v.astype(np.int64)))
    assert got.dtype == torch.int64 and int(got.max()) < 2**32 and int(got.min()) >= 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_u32_bit_exact():
    pixel, frame, dim = _hash_inputs()
    want = np.asarray(jrng.hash_u32(jnp.asarray(pixel), jnp.asarray(frame), jnp.asarray(dim)))
    got = rng.hash_u32(torch.from_numpy(pixel), torch.from_numpy(frame), torch.from_numpy(dim))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("fn", ["uniform1", "uniform2", "uniform4"])
def test_uniform_bit_exact(fn):
    pixel, frame, dim = _hash_inputs()
    want = np.asarray(getattr(jrng, fn)(jnp.asarray(pixel), jnp.asarray(frame), jnp.asarray(dim)))
    got = getattr(rng, fn)(torch.from_numpy(pixel), torch.from_numpy(frame), torch.from_numpy(dim))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniform_scalar_frame_and_dim_bit_exact():
    """The path tracer passes a 0-d frame tensor and a Python dim."""
    pixel = np.arange(1920 * 1080, dtype=np.int32)
    want = np.asarray(jrng.uniform2(jnp.asarray(pixel), jnp.int32(299), 10_152))
    got = rng.uniform2(torch.from_numpy(pixel), torch.tensor(299, dtype=torch.int32), 10_152)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("frame", [0, 1, 17, 300])
def test_sequences_exact(frame):
    px = np.tile(np.arange(64, dtype=np.int32), 64)
    py = np.repeat(np.arange(64, dtype=np.int32), 64)
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    np.testing.assert_array_equal(
        rng.bayer4x4(tpx, tpy, frame).numpy(), np.asarray(jrng.bayer4x4(jnp.asarray(px), jnp.asarray(py), frame)))
    np.testing.assert_array_equal(
        rng.weyl1d(torch.tensor(frame, dtype=torch.int32)).numpy(), np.asarray(jrng.weyl1d(jnp.int32(frame))))
    cb = rng.checkerboard(tpx, tpy, frame)
    assert cb.dtype == torch.int32
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jrng.checkerboard(jnp.asarray(px), jnp.asarray(py), frame)))


def _normalize_rounded(v: np.ndarray) -> np.ndarray:
    """normalize's float32 result with every op correctly rounded: the
    float32 squares and sums in order, then the sqrt, the reciprocal and the
    product, each exact in float64 and rounded once to float32."""
    sq = [v[:, k] * v[:, k] for k in range(3)]
    n2 = np.maximum(sq[0] + sq[1] + sq[2], np.float32(1e-30))
    s = np.sqrt(n2.astype(np.float64)).astype(np.float32)
    inv = (1.0 / s.astype(np.float64)).astype(np.float32)
    return (v.astype(np.float64) * inv.astype(np.float64)[:, None]).astype(np.float32)


def _normalize_inputs():
    rs = np.random.RandomState(11)
    v = np.concatenate([rs.randn(20_000, 3), rs.randn(2000, 3) * 1e-12, rs.randn(2000, 3) * 1e15,
                        np.zeros((4, 3))]).astype(np.float32)
    return v


def test_normalize_is_correctly_rounded():
    """On the CPU, normalize's 1/sqrt is ``torch.rsqrt``, which is the
    correctly rounded sqrt and reciprocal: the result equals the rounded
    one bit for bit."""
    v = _normalize_inputs()
    np.testing.assert_array_equal(geo.normalize(torch.from_numpy(v)).numpy(),
                                  _normalize_rounded(v))


@pytest.mark.cuda
def test_normalize_is_correctly_rounded_on_the_card():
    """On the card, normalize's sqrt and reciprocal are IEEE float32 ops,
    each rounded once: the result equals the rounded one, and so the CPU's,
    bit for bit. (The card's ``torch.rsqrt`` is within 2 ULPs; one ULP of a
    shading normal moved shaderballs512's REBLUR roughness gradient at 64x64
    by 6.5e-4 of the field's largest entry.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    v = _normalize_inputs()
    got = geo.normalize(torch.from_numpy(v).cuda()).cpu().numpy()
    np.testing.assert_array_equal(got, _normalize_rounded(v))
