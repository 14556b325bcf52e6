"""NaN through the three denoiser kernels on the card (``cuda`` cases; they
skip without a card): with NaN written into a few pixels of the radiance
planes and of the history, as the stress tests without sanitization do,
each kernel's non-finite outputs must be where its plain version's are
(the plain versions' torch.minimum / maximum / clamp give NaN where
fminf / fmaxf would drop it), and its finite outputs must equal the plain
version's within 1e-6 abs and rel."""

import numpy as np
import pytest
import torch

from nrdsample_tpu_torch.denoise import atrous_cuda, relax, taa, taa_cuda, taccum_cuda
from torch_session_cache import share_cores_between_workers

share_cores_between_workers()

H, W = 67, 101
KERNEL_TOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _planes(seed, dev):
    rs = np.random.RandomState(seed)
    f32 = np.float32

    def nan_in(a, share=0.02):
        a = a.copy()
        a[rs.rand(*a.shape[:2]) < share] = np.nan
        return a

    vz = (1.0 + rs.rand(H, W) * 5.0).astype(f32)
    n = rs.randn(H, W, 3).astype(f32) * 0.3 + np.array([0, 0, 1.0], f32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    out = {
        "illum": nan_in(rs.rand(H, W, 3).astype(f32) * 3.0),
        "vz": vz, "n": n,
        "mv": ((rs.rand(H, W, 3).astype(f32) * 2 - 1) * np.array([1.5, 1.5, 0.01], f32)),
        "h_illum": nan_in(rs.rand(H, W, 3).astype(f32) * 2.0),
        "h_moments": nan_in(rs.rand(H, W, 2).astype(f32)),
        "h_vz": (vz * (1.0 + rs.randn(H, W) * 0.005)).astype(f32),
        "h_frames": (rs.rand(H, W) * 6).astype(f32),
        "var": nan_in(rs.rand(H, W).astype(f32) * 0.5),
        "prev": nan_in(rs.rand(H, W, 3).astype(f32)),
        "wide": (rs.rand(H, W) < 0.3).astype(f32),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in out.items()}


def _same_nan_and_close(got, want):
    n_bad = 0
    for g, w in zip(got, want):
        bad_g, bad_w = ~torch.isfinite(g), ~torch.isfinite(w)
        assert torch.equal(bad_g, bad_w), (int(bad_g.sum()), int(bad_w.sum()))
        n_bad += int(bad_w.sum())
        ok = ~bad_w
        assert bool(((g[ok] - w[ok]).abs() <= KERNEL_TOL + KERNEL_TOL * w[ok].abs()).all())
    assert 0 < n_bad < sum(w.numel() for w in want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["relax_taccum", "relax_atrous", "taa_resolve"])
def test_denoiser_kernel_nan_matches_plain_on_card(cuda_device, kernel):
    p = _planes(11, cuda_device)
    if kernel == "relax_taccum":
        s = relax.RelaxSettings(max_accumulated_frames=torch.tensor(31.0, device=cuda_device))
        hist = relax.RelaxHistory(p["h_illum"], p["h_moments"], p["h_vz"], p["n"], p["h_frames"])
        args = (hist, p["illum"], p["vz"], p["n"], p["mv"], s)
        before = taccum_cuda.LAUNCHES
        got = relax.taccum(*args)
        assert taccum_cuda.LAUNCHES == before + 1
        want = relax.taccum_plain(*args)
    elif kernel == "relax_atrous":
        args = (p["illum"], p["var"], p["vz"], p["n"], 2, relax.RelaxSettings())
        before = atrous_cuda.LAUNCHES
        got = relax.atrous(*args)
        assert atrous_cuda.LAUNCHES == before + 1
        want = relax.atrous_iteration(*args)
    else:
        reset_mix = torch.zeros((H, W), device=cuda_device)
        args = (p["illum"], p["prev"], p["mv"][..., :2].contiguous(), p["wide"], reset_mix, 2.0, 0.1)
        before = taa_cuda.LAUNCHES
        got = (taa.resolve(*args),)
        assert taa_cuda.LAUNCHES == before + 1
        want = (taa.resolve_tail(*args),)
    _same_nan_and_close(got, want)
