"""The port's plain dense closest hit and emissive probe against the JAX
package's Pallas kernels (interpret mode) and XLA oracles, on the same
numpy-seeded rays; these plain versions are what the CUDA kernels are held
to on the card, bit for bit.

Both sides evaluate the same unfused float32 Möller-Trumbore sequence, and
where XLA does too the results are identical: ``tri`` equal on every ray and
t/u/v within 1e-6 abs/rel. XLA:CPU, though, contracts multiply-adds into FMAs
inside its fused loops when the host has FMA instructions. That moves t by
an ULP, which changes the winner only where two triangles are hit at the
same distance (a ray through a shared edge or vertex: 4 of 4000 rays on the
Cornell box below). So the exact comparison runs the JAX oracle in a
subprocess with XLA limited to SSE4.2 (no FMA), and the in-process
comparison against the default XLA accepts a different ``tri`` only on such
exact ties, checked in float64.

Cases marked ``cuda`` hold the kernels against the plain versions on the
card and skip where there is none."""

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nrdsample_tpu.ops import dense_pallas, emissive_probe as jprobe, intersect as jintersect
from nrdsample_tpu.render import emissive_is as jem
from nrdsample_tpu.scene import procedural as jproc
from nrdsample_tpu_torch.ops import (_kernels, dense_cuda, emissive_probe, intersect, reproject,
                                     traversal)
from nrdsample_tpu_torch.render import emissive_is
from nrdsample_tpu_torch.scene import procedural
from torch_session_cache import declare, session_cached, share_cores_between_workers

share_cores_between_workers()

TOL = 1e-6


def _rays(n, seed, spread):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _tris(name):
    tris = getattr(jproc, name)().tris
    return {k: np.asarray(getattr(tris, k)) for k in ("p0", "e1", "e2")}


def _port_hit(tris, o, d, t_max=intersect.T_MAX):
    tm = torch.from_numpy(t_max) if isinstance(t_max, np.ndarray) else t_max
    res = intersect.intersect_dense(torch.from_numpy(o), torch.from_numpy(d),
                                    *(torch.from_numpy(tris[k]) for k in ("p0", "e1", "e2")), tm)
    assert res["tri"].dtype == torch.int32 and res["t"].dtype == torch.float32
    return {k: v.numpy() for k, v in res.items()}


def _assert_hits_equal(got, want, hit):
    np.testing.assert_array_equal(got["tri"], np.asarray(want["tri"]))
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k][hit], np.asarray(want[k])[hit], rtol=TOL, atol=TOL)


def _t64(o, d, tris, j):
    """Float64 Möller-Trumbore distance of ray (o, d) to triangle j."""
    p0, e1, e2 = (tris[k][j].astype(np.float64) for k in ("p0", "e1", "e2"))
    pv = np.cross(d.astype(np.float64), e2)
    return float(e2 @ np.cross(o.astype(np.float64) - p0, e1)) / float(e1 @ pv)


def _assert_only_ties_differ(got, want, o, d, tris):
    """tri equal except where both picks are hit at the same float64
    distance (an exact tie that float32 rounding breaks either way)."""
    want = {k: np.asarray(v) for k, v in want.items()}
    differ = np.nonzero(got["tri"] != want["tri"])[0]
    assert len(differ) <= 0.005 * len(o)
    for i in differ:
        a, b = int(got["tri"][i]), int(want["tri"][i])
        assert a >= 0 and b >= 0, f"ray {i}: hit/miss differs ({a} vs {b})"
        ta, tb = _t64(o[i], d[i], tris, a), _t64(o[i], d[i], tris, b)
        assert abs(ta - tb) <= 1e-6 * max(abs(ta), 1.0), f"ray {i}: not a tie ({ta} vs {tb})"
    same = (got["tri"] == want["tri"]) & (got["tri"] >= 0)
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k][same], want[k][same], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["cornell_box", "kitchen"])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "intersect_dense"])
def test_plain_dense_matches_jax(name, oracle):
    tris = _tris(name)
    o, d = _rays(4000, 0, 3.0)
    if oracle == "pallas_interpret":
        jt = getattr(jproc, name)().tris
        want = dense_pallas.closest_hit_dense_pallas(jt, jnp.asarray(o), jnp.asarray(d), interpret=True)
    else:
        want = jintersect.intersect_dense(jnp.asarray(o), jnp.asarray(d),
                                          *(jnp.asarray(tris[k]) for k in ("p0", "e1", "e2")))
    got = _port_hit(tris, o, d)
    hit = got["tri"] >= 0
    assert hit.sum() > 100
    _assert_only_ties_differ(got, want, o, d, tris)
    # miss sentinel: t = t_max, u = v = 0
    np.testing.assert_array_equal(got["t"][~hit], np.float32(intersect.T_MAX))
    assert not got["u"][~hit].any() and not got["v"][~hit].any()


_UNFUSED_ORACLE = r"""
import sys
import numpy as np
import jax.numpy as jnp
from nrdsample_tpu.ops import dense_pallas, emissive_probe
from nrdsample_tpu.render import emissive_is
from nrdsample_tpu.scene import procedural

def rays(n, seed, spread):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)

out = {}
for name in ("cornell_box", "kitchen"):
    scene = getattr(procedural, name)()
    o, d = rays(4000, 0, 3.0)
    res = dense_pallas.closest_hit_dense_pallas(scene.tris, o, d, interpret=True)
    for k, v in res.items():
        out[f"dense_{name}_{k}"] = np.asarray(v)
for name in ("cornell_box", "kitchen", "interior_night"):
    o, d = rays(5000, 0, 2.0)
    em = emissive_is.build_emissive_set(getattr(procedural, name)())
    out[f"probe_{name}"] = np.asarray(emissive_probe.light_probe_pallas(em, o, d, interpret=True))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def unfused_oracle(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_dense_hit_unfused_oracle",
                          lambda: _unfused_oracle(tmp_path_factory))


declare("torch_dense_hit_unfused_oracle", lambda tpf: _unfused_oracle(tpf))


def _unfused_oracle(tmp_path_factory):
    """The Pallas kernels' results (interpret mode) from a JAX process whose
    XLA:CPU may not emit FMA instructions."""
    path = tmp_path_factory.mktemp("oracle") / "unfused.npz"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=SSE4_2",
               PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _UNFUSED_ORACLE, str(path)], env=env, cwd=repo,
                   check=True, timeout=300)
    return dict(np.load(path))


@pytest.mark.parametrize("name", ["cornell_box", "kitchen"])
def test_plain_dense_bit_matches_unfused_pallas(unfused_oracle, name):
    got = _port_hit(_tris(name), *_rays(4000, 0, 3.0))
    np.testing.assert_array_equal(got["tri"], unfused_oracle[f"dense_{name}_tri"])
    for k in ("t", "u", "v"):
        np.testing.assert_allclose(got[k], unfused_oracle[f"dense_{name}_{k}"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", ["cornell_box", "kitchen", "interior_night"])
def test_plain_probe_matches_unfused_pallas(unfused_oracle, name):
    _, em = _em(name)
    o, d = _rays(5000, 0, 2.0)
    got = emissive_probe.light_probe_plain(em, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), unfused_oracle[f"probe_{name}"], rtol=TOL, atol=TOL)


def test_bounded_t_max_and_ragged_tail():
    tris = _tris("cornell_box")
    o, d = _rays(777, 2, 3.0)
    tm = np.full(777, 1.5, np.float32)
    want = dense_pallas.closest_hit_dense_pallas(jproc.cornell_box().tris, jnp.asarray(o),
                                                 jnp.asarray(d), t_max=jnp.asarray(tm),
                                                 interpret=True)
    got = _port_hit(tris, o, d, tm)
    _assert_hits_equal(got, want, np.ones(777, bool))
    assert (got["t"] <= 1.5).all()


def test_any_hit_matches_occluded_dense():
    tris = _tris("cornell_box")
    o, d = _rays(1000, 3, 3.0)
    tm = np.full(1000, 2.0, np.float32)
    want = np.asarray(jintersect.occluded_dense(jnp.asarray(o), jnp.asarray(d),
                                                *(jnp.asarray(tris[k]) for k in ("p0", "e1", "e2")),
                                                t_max=jnp.asarray(tm)))
    ctx, _ = traversal.build_context(procedural.cornell_box(), device="cpu")
    blocked, t = traversal.any_hit_t(ctx, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    np.testing.assert_array_equal(blocked.numpy(), want)
    np.testing.assert_array_equal(traversal.any_hit(ctx, torch.from_numpy(o), torch.from_numpy(d),
                                                    torch.from_numpy(tm)).numpy(), want)
    assert (t.numpy()[~want] == np.float32(traversal.T_MAX)).all()


def _em(name):
    em = jem.build_emissive_set(getattr(jproc, name)())
    return em, {k: torch.from_numpy(np.array(em[k])) for k in ("p0", "e1", "e2", "intensity")}


@pytest.mark.parametrize("name", ["cornell_box", "kitchen", "interior_night"])
def test_plain_probe_matches_pallas(name):
    jem_set, em = _em(name)
    o, d = _rays(5000, 0, 2.0)
    want = np.asarray(jprobe.light_probe_pallas(jem_set, jnp.asarray(o), jnp.asarray(d), interpret=True))
    got = emissive_probe.light_probe_plain(em, torch.from_numpy(o), torch.from_numpy(d))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert (want > 0).any()


def test_plain_probe_matches_xla_probe_tail():
    jem_set, em = _em("cornell_box")
    o, d = _rays(333, 0, 2.0)
    want = np.asarray(jem.light_probe(jem_set, jnp.asarray(o), jnp.asarray(d)))
    got = emissive_is.light_probe(em, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_versions():
    ctx, scene = traversal.build_context(procedural.kitchen(), device="cpu")
    tr = ctx.tris
    o, d = (torch.from_numpy(a) for a in _rays(500, 4, 3.0))
    before = (dense_cuda.LAUNCHES, emissive_probe.LAUNCHES)
    a = traversal.closest_hit(ctx, o, d)
    b = intersect.intersect_dense(o, d, tr.p0, tr.e1, tr.e2)
    for k in a:
        assert torch.equal(a[k], b[k])
    em = emissive_is.build_emissive_set(scene)
    assert torch.equal(emissive_is.light_probe(em, o, d), emissive_probe.light_probe_plain(em, o, d))
    assert (dense_cuda.LAUNCHES, emissive_probe.LAUNCHES) == before


def test_kernel_wrappers_refuse_cpu_tensors():
    tris = {k: torch.from_numpy(v) for k, v in _tris("cornell_box").items()}
    o, d = (torch.from_numpy(a) for a in _rays(10, 5, 3.0))
    with pytest.raises(ValueError):
        dense_cuda.closest_hit_dense_cuda(tris["p0"], tris["e1"], tris["e2"], o, d)
    em = dict(tris, intensity=torch.ones(tris["p0"].shape[0]))
    with pytest.raises(ValueError):
        emissive_probe.light_probe_cuda(em, o, d)


@pytest.mark.parametrize("wrapper", ["sample_bilinear_cuda", "light_probe_cuda"])
def test_gather_and_probe_wrappers_refuse_grad(wrapper):
    """The bilinear gather and the emissive probe kernels have no backward,
    so an input that requires grad raises (their results would carry no
    gradient); the check comes before the device check, so CPU tensors
    show it."""
    if wrapper == "sample_bilinear_cuda":
        img = torch.rand(8, 8, 3, requires_grad=True)
        pos = torch.rand(5, 2) * 8.0
        with pytest.raises(NotImplementedError, match="requires grad"):
            reproject.sample_bilinear_cuda(img, pos)
        return
    tris = {k: torch.from_numpy(v) for k, v in _tris("cornell_box").items()}
    o, d = (torch.from_numpy(a) for a in _rays(10, 5, 3.0))
    em = dict(tris, intensity=torch.ones(tris["p0"].shape[0], requires_grad=True))
    with pytest.raises(NotImplementedError, match="requires grad"):
        emissive_probe.light_probe_cuda(em, o, d)


@pytest.mark.parametrize("symbol", sorted(_kernels.SIGNATURES))
def test_bound_symbols_match_their_c_declarations(symbol):
    """ctypes passes each argument as declared in SIGNATURES; a count that
    differs from the C definition would corrupt the launch on the card, where
    nothing checks it."""
    decls = {}
    for path in _kernels.sources():
        with open(path) as f:
            for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', f.read()):
                decls[name] = args.split(",")
    assert symbol in decls, f"no extern \"C\" definition of {symbol} in csrc/*.cu"
    assert len(decls[symbol]) == len(_kernels.SIGNATURES[symbol])
    # every pointer crosses as c_void_p, every non-pointer as a scalar type
    for c_arg, ct in zip(decls[symbol], _kernels.SIGNATURES[symbol]):
        assert ("*" in c_arg) == (ct is ctypes.c_void_p), f"{symbol}: {c_arg.strip()} vs {ct}"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cornell_box", "kitchen"])
def test_dense_kernel_matches_plain_on_card(cuda_device, name):
    tris = getattr(procedural, name)().tris.to(cuda_device)
    o, d = (torch.from_numpy(a).to(cuda_device) for a in _rays(100_003, 6, 3.0))
    tm = torch.full((o.shape[0],), 2.0, device=cuda_device)
    for t_max in (intersect.T_MAX, tm):
        got = dense_cuda.closest_hit_dense_cuda(tris.p0, tris.e1, tris.e2, o, d, t_max)
        want = intersect.intersect_dense(o, d, tris.p0, tris.e1, tris.e2, t_max)
        assert torch.equal(got["tri"], want["tri"])
        for k in ("t", "u", "v"):
            torch.testing.assert_close(got[k], want[k], rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_probe_kernel_matches_plain_on_card(cuda_device):
    _, em = _em("kitchen")
    em = {k: v.to(cuda_device) for k, v in em.items()}
    o, d = (torch.from_numpy(a).to(cuda_device) for a in _rays(100_003, 7, 2.0))
    got = emissive_probe.light_probe_cuda(em, o, d)
    torch.testing.assert_close(got, emissive_probe.light_probe_plain(em, o, d), rtol=TOL, atol=TOL)
