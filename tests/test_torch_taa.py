"""The port's TAA, SH resolve and colour helpers against the JAX package's,
on numpy-seeded 24x32 planes: ``rgb_to_lab`` (the port's pow(x, 1/3) cube
root against JAX's cbrt), ``linear_to_srgb``, ``inverse_tonemap_lum``, the
plain resolve ``resolve_tail`` against the Pallas TAA kernel in interpret
mode with and without the wide mask, the velocity dilation, a whole
``apply`` over two frames, and the SH resolve.

Tolerances: rgb_to_lab within 2e-4 absolute on L, a and b (values up to
100). The port's pow(x, 1/3) is within 1.2e-7 relative (1 ULP) of JAX's
cbrt; the 116, 500 and 200 scales make that at most 1.5e-5, 6.1e-5 and
2.7e-5 on L, a and b over this test's 5,100 colours. 3e-5 against the
Pallas kernel (the bound of the JAX package's own parity test), 1e-5
against XLA elsewhere. The ``cuda`` case holds the TAA kernel against its
plain version on the card within 1e-6 and skips where there is none."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu import config as jcfg
from nrdsample_tpu.denoise import sh as jsh, taa as jtaa, taa_pallas
from nrdsample_tpu.mathlib import color as jcolor
from nrdsample_tpu_torch import config as cfgmod
from nrdsample_tpu_torch.denoise import sh, taa, taa_cuda
from nrdsample_tpu_torch.mathlib import color
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

H, W = 24, 32
TOL = 1e-5
PALLAS_TOL = 3e-5
LAB_TOL = 2e-4
KERNEL_TOL = 1e-6


def _planes(seed, h=H, w=W):
    rs = np.random.RandomState(seed)
    f32 = np.float32
    return {"cur": rs.rand(h, w, 3).astype(f32) * 1.5, "prev": rs.rand(h, w, 3).astype(f32) * 1.5,
            "mv_d": ((rs.rand(h, w, 2) * 2 - 1) * 3.0).astype(f32),
            "wide": (rs.rand(h, w) > 0.7).astype(f32), "reset": (rs.rand(h, w) > 0.9).astype(f32)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_color_helpers_match_jax():
    rs = np.random.RandomState(0)
    rgb = np.concatenate([rs.rand(4000, 3), rs.rand(1000, 3) * 1e-3,
                          rs.rand(100, 3) * 4.0 - 1.0]).astype(np.float32)
    got = color.rgb_to_lab(torch.from_numpy(rgb))
    np.testing.assert_allclose(got.numpy(), np.asarray(jcolor.rgb_to_lab(jnp.asarray(rgb))),
                               rtol=0.0, atol=LAB_TOL)
    x = np.linspace(-0.5, 1.5, 2001, dtype=np.float32)
    _close(color.linear_to_srgb(torch.from_numpy(x)), jcolor.linear_to_srgb(jnp.asarray(x)))
    _close(color.inverse_tonemap_lum(torch.from_numpy(x)), jcolor.inverse_tonemap_lum(jnp.asarray(x)))


@pytest.mark.parametrize("use_wide", [True, False])
def test_resolve_tail_matches_pallas_interpret(use_wide):
    p = _planes(1)
    p["mv_d"][:3, :, 0] += 500.0   # history off screen on the top rows
    jw = jnp.asarray(p["wide"]) if use_wide else None
    want = taa_pallas.taa_resolve_pallas(jnp.asarray(p["cur"]), jnp.asarray(p["prev"]),
                                         jnp.asarray(p["mv_d"]), jw, jnp.asarray(p["reset"]),
                                         jcfg.TAA_SIGMA_SCALE, 0.1, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    got = taa.resolve_tail(t["cur"], t["prev"], t["mv_d"], t["wide"] if use_wide else None,
                           t["reset"], cfgmod.TAA_SIGMA_SCALE, 0.1)
    _close(got, want, PALLAS_TOL)
    _close(got[:3], p["cur"][:3], 1e-6)   # off screen: the current colour wholesale


def test_velocity_dilation_matches_jax():
    rs = np.random.RandomState(2)
    mv = rs.randn(H, W, 2).astype(np.float32)
    vz = (1.0 + rs.rand(H, W) * 5.0).astype(np.float32)
    want = jtaa.closest_velocity_dilation(jnp.asarray(mv), jnp.asarray(vz))
    got = taa.closest_velocity_dilation(torch.from_numpy(mv), torch.from_numpy(vz))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_apply_matches_jax_over_two_frames():
    rs = np.random.RandomState(3)
    vz = (1.0 + rs.rand(H, W) * 5.0).astype(np.float32)
    wide = rs.rand(H, W) > 0.8
    jh, th = jtaa.TaaHistory.create(H, W), taa.TaaHistory.create(H, W, device="cpu")
    japply = jax.jit(jtaa.apply)
    for i in range(2):
        cur = rs.rand(H, W, 3).astype(np.float32)
        mv = (rs.randn(H, W, 3) * np.array([1.5, 1.5, 0.01])).astype(np.float32)
        jout, jh = japply(jh, jnp.asarray(cur), jnp.asarray(mv), jnp.asarray(vz),
                          wide_mask=jnp.asarray(wide), reset=jnp.bool_(i == 1))
        tout, th = taa.apply(th, torch.from_numpy(cur), torch.from_numpy(mv), torch.from_numpy(vz),
                             wide_mask=torch.from_numpy(wide), reset=i == 1)
        _close(tout, jout)
        assert int(th.valid) == int(jh.valid) == 1
    _close(th.color, jh.color)


def test_sh_resolve_matches_jax():
    rs = np.random.RandomState(4)
    rad = rs.rand(500, 3).astype(np.float32) * 2.0
    d = rs.randn(500, 3).astype(np.float32)
    n = rs.randn(500, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    jpk = jsh.pack(jnp.asarray(rad), jnp.asarray(d))
    tpk = sh.pack(torch.from_numpy(rad), torch.from_numpy(d))
    _close(tpk["dir"], jpk["dir"])
    _close(sh.resolve(tpk, torch.from_numpy(n)), jsh.resolve(jpk, jnp.asarray(n)))


def test_taa_wrapper_refuses_cpu_and_grad():
    t = {k: torch.from_numpy(v) for k, v in _planes(5).items()}
    with pytest.raises(ValueError):
        taa_cuda.taa_resolve_cuda(t["cur"], t["prev"], t["mv_d"], None, t["reset"], 2.0, 0.1)
    t["cur"].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        taa_cuda.taa_resolve_cuda(t["cur"], t["prev"], t["mv_d"], None, t["reset"], 2.0, 0.1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("use_wide,shape",
                         [(True, (270, 480)), (False, (270, 480)), (True, (37, 53)),
                          (False, (37, 53))],
                         ids=["True", "False", "True-37x53", "False-37x53"])
def test_taa_kernel_matches_plain_on_card(cuda_device, use_wide, shape):
    """At 270x480 and at 37x53, which no tile divides."""
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in _planes(6, *shape).items()}
    wide = t["wide"] if use_wide else None
    before = taa_cuda.LAUNCHES
    got = taa.resolve(t["cur"], t["prev"], t["mv_d"], wide, t["reset"], 2.0, 0.1)
    assert taa_cuda.LAUNCHES == before + 1
    want = taa.resolve_tail(t["cur"], t["prev"], t["mv_d"], wide, t["reset"], 2.0, 0.1)
    assert bool(((got - want).abs() <= KERNEL_TOL + KERNEL_TOL * want.abs()).all())
