"""The port's sharding (``nrdsample_tpu_torch/parallel/``, the SHARC probe
split, ``trace_frame`` over a pixel block, ``train.make_sharded_train_step``)
on the CPU, against the single-rank port and the JAX package's ``halo``.

In one process, with no process group: the flagship glass Cornell box
(``tests/test_sharded_parity.py``'s configuration) at 48x48 traced in 2, 3
and 5 contiguous pixel blocks, concatenated, against the whole-image trace
(FULL_PROBABILISTIC and HALF). 2 and 3 blocks of 48x48 keep every block a
multiple of 16 pixels, and then every plane is bit-equal: each pixel's RNG
is keyed by its index. 5 blocks of 461 do not, and PyTorch's CPU
transcendentals take another path for a vector's tail than for its body,
so there the planes are held to PERF.md §2's frame bound. The SHARC probe
grid (9x9) traced in blocks of ids against the whole grid: bit-equal where
the blocks are multiples of 16 probes, else within §2.

Over spawned gloo ranks on 127.0.0.1 (``parallel.distributed.run_ranks``,
each spawn with its own timeout): the halo exchange on 4 ranks against
JAX's ``halo`` under ``shard_map`` on 4 of conftest's 8 CPU devices, on
``tests/test_halo.py``'s inputs (atol 1e-6); ``tests/test_distributed.py``'s
bring-up on 2 ranks; two sharded frames on 2 ranks at 48x48 (color, final,
shadow and every History leaf within 1e-4 of the single-rank port frame,
``test_sharded_parity.py``'s bound); the sharded gradients and step on 2
ranks at 40x40 (within 1e-4 of the largest |entry| of the single-rank
``value_and_grad``); ``dryrun_multichip(2, device="cpu")`` at 16x16, its step
against ``make_train_step``'s.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from nrdsample_tpu.parallel import halo as jhalo
from nrdsample_tpu_torch.config import TracingMode
from nrdsample_tpu_torch.parallel import distributed, dryrun, mesh as mesh_mod
from nrdsample_tpu_torch.pipeline import frame, train
from nrdsample_tpu_torch.render import sharc_update
from torch_parallel_ranks import (_blur3_rows, blur3, compound, distributed_rank,
                                  fail_on_rank_0, frames_and_grads_rank, halo_rank)
from torch_session_cache import declare, session_cached, share_cores_between_workers

share_cores_between_workers()

OUTLIER_FRAC = 0.005      # PERF.md §2: pixels past 1e-3 * (1 + |ref|), per plane
PARITY_TOL = 1e-4         # test_sharded_parity.py's bound, and the gradient bound
SPAWN_TIMEOUT_S = 240.0
MODES = {"full_probabilistic": TracingMode.FULL_PROBABILISTIC, "half": TracingMode.HALF}
FRAME_SPECS = [{"name": "flagship", "width": 48, "height": 48, "bounce_num": 2,
                "cfg": {"tracing_mode": mode}} for mode in MODES.values()]
GRAD_SPEC = {"name": "flagship", "width": 40, "height": 40, "bounce_num": 2}


def _outlier_frac(ref, got):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    bad = np.abs(ref - got) > 1e-3 * (1.0 + np.abs(ref))
    return bad.reshape(bad.shape[0], -1).any(-1).mean()


def _assert_planes(got: dict, want: dict, exact: bool, what: str):
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, f"{what} {k}"
        if exact or not torch.is_floating_point(w):
            assert torch.equal(g, w), f"{what} {k}: {int((g != w).sum())} entries differ"
        else:
            assert _outlier_frac(w.numpy(), g.numpy()) <= OUTLIER_FRAC, f"{what} {k}"


# ---- trace_frame over pixel blocks, and the probe split, in one process ----


@pytest.fixture(scope="module", params=list(MODES))
def whole_trace(request):
    ctx, scene, cam, cfg, settings = dryrun.flagship(48, 48, "cpu", bounce_num=2,
                                                     tracing_mode=MODES[request.param])
    hist = frame.History.create(cfg, "cpu")
    with torch.no_grad():
        gb, aux = frame.trace_frame(ctx, scene, cam, cfg, settings, hist)
    return (ctx, scene, cam, cfg, settings, hist), gb, aux


@pytest.mark.parametrize("blocks", [2, 3, 5])
def test_block_trace_matches_the_whole_trace(whole_trace, blocks):
    (ctx, scene, cam, cfg, settings, hist), want, want_aux = whole_trace
    parts = []
    for r in range(blocks):
        lo, hi = mesh_mod.block_bounds(cfg.n_pixels, blocks, r)
        pidx = torch.arange(lo, hi, dtype=torch.int32)
        with torch.no_grad():
            gb, aux = frame.trace_frame(ctx, scene, cam, cfg, settings, hist, pixel_idx=pidx)
        assert all(v.shape[0] == hi - lo for v in gb.values())
        for a, b in zip(dataclasses_leaves(aux["sharc"]), dataclasses_leaves(want_aux["sharc"])):
            assert torch.equal(a, b)
        parts.append(gb)
    got = {k: torch.cat([p[k] for p in parts]) for k in want}
    aligned = all((hi - lo) % 16 == 0 for lo, hi in
                  (mesh_mod.block_bounds(cfg.n_pixels, blocks, r) for r in range(blocks)))
    assert aligned == (blocks in (2, 3))
    _assert_planes(got, want, aligned, f"{blocks} blocks")


def dataclasses_leaves(obj):
    import dataclasses

    return [getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)]


@pytest.mark.parametrize("blocks", [2, 3])
@pytest.mark.parametrize("mode", ["curr", "full"])
def test_probe_blocks_match_the_whole_grid(whole_trace, blocks, mode):
    """``_trace_probe_paths`` on each rank's block of probe ids,
    concatenated (``mesh.gather_probes``'s order), against the whole grid;
    the FULL pass walks through the glass first."""
    (ctx, scene, cam, cfg, settings, hist), _, _ = whole_trace
    ds = cfg.sharc_downscale
    n_px = (cfg.width // ds) * (cfg.height // ds)
    frame_index = hist.frame_index
    with torch.no_grad():
        want = sharc_update._trace_probe_paths(ctx, scene, cam, cfg, settings, frame_index,
                                               mode=mode)
        parts = []
        for r in range(blocks):
            lo, hi = mesh_mod.block_bounds(n_px, blocks, r)
            parts.append(sharc_update._trace_probe_paths(
                ctx, scene, cam, cfg, settings, frame_index,
                sidx=torch.arange(lo, hi, dtype=torch.int32), mode=mode))
    aligned = all((mesh_mod.block_bounds(n_px, blocks, r)[1]
                   - mesh_mod.block_bounds(n_px, blocks, r)[0]) % 16 == 0
                  for r in range(blocks))
    flat = {"first_l": 0, "probe_vz": 1, "probe_n": 2, "grad_lum": 4}
    got = {k: torch.cat([p[i] for p in parts]) for k, i in flat.items()}
    ref = {k: want[i] for k, i in flat.items()}
    for k in want[3]:       # (depth, m, ...) -> (m, depth, ...): a probe per row
        got[f"stacked.{k}"] = torch.cat([p[3][k] for p in parts], dim=1).transpose(0, 1)
        ref[f"stacked.{k}"] = want[3][k].transpose(0, 1)
    assert n_px == 81
    _assert_planes(got, ref, aligned, f"{mode} probes in {blocks} blocks")


def test_block_bounds_and_shard_pixels():
    assert [mesh_mod.block_bounds(10, 4, r) for r in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert [mesh_mod.block_bounds(81, 2, r) for r in range(2)] == [(0, 41), (41, 81)]
    m = mesh_mod.make_mesh(device="cpu")
    assert (m.size, m.rank) == (1, 0)
    assert torch.equal(mesh_mod.shard_pixels(m, 12), torch.arange(12, dtype=torch.int32))
    with pytest.raises(ValueError):
        mesh_mod.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="leave rank"):
        mesh_mod.shard_pixels(mesh_mod.PixelMesh(4, 3, torch.device("cpu")), 9)


def test_single_rank_sharded_frame_is_render_frame():
    """On a mesh of one rank the sharded frame and step are render_frame and
    make_train_step."""
    ctx, scene, cam, cfg, settings = dryrun.flagship(16, 16, "cpu")
    m = mesh_mod.make_mesh(device="cpu")
    h = frame.History.create(cfg, "cpu")
    with torch.no_grad():
        want, _ = frame.render_frame(ctx, scene, cam, cfg, settings, h)
        got, _ = mesh_mod.sharded_render_fn(ctx, cfg, m)(scene, cam, settings, h)
    assert torch.equal(got["color"], want["color"])


def test_init_is_a_no_op_in_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.init() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK"):
        monkeypatch.setenv(k, "1")
    assert distributed.init() is False
    assert distributed.global_mesh().shape == (1, 1)
    scene = {"a": torch.ones(2)}
    assert distributed.broadcast_scene(scene) is scene
    if not torch.cuda.is_available():   # one process, no card: None is the card, as everywhere
        with pytest.raises(RuntimeError, match="device='cpu'"):
            distributed.default_device()
    assert distributed.default_device("cpu") == torch.device("cpu")
    assert distributed.backend_for(2, "cpu") == "gloo"
    assert distributed.backend_for(2, "cuda:0") == "gloo"


def test_collective_refuses_an_unknown_op():
    with pytest.raises(ValueError, match="unknown collective"):
        distributed.collective("reduce_scatter", torch.ones(2))


# ---- the halo exchange over 4 gloo ranks against JAX's under shard_map ----


def _jblur3(x):
    up = jnp.concatenate([x[:1], x[:-1]], axis=0)
    dn = jnp.concatenate([x[1:], x[-1:]], axis=0)
    return (up + x + dn) / 3.0


def _halo_images():
    return {"blur": np.random.RandomState(0).rand(64, 16).astype(np.float32),
            "compound": np.arange(32 * 8, dtype=np.float32).reshape(32, 8),
            "channels": np.random.RandomState(1).rand(16, 4, 3).astype(np.float32)}


@pytest.fixture(scope="module")
def halo_results():
    images = _halo_images()
    ranks = distributed.run_ranks(halo_rank, 4, (images,), device="cpu",
                                  timeout_s=SPAWN_TIMEOUT_S)
    return images, {k: np.concatenate([r[k] for r in ranks]) for k in ranks[0]}


def _jax_halo(name, img):
    """JAX's halo under shard_map on 4 devices: (the exchanged blocks,
    concatenated; the case's result)."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))

    def local(x):
        xp = jhalo.exchange_rows(x, 2 if name == "compound" else 1, "rows")
        if name == "blur":
            return xp, (xp[:-2] + xp[1:-1] + xp[2:]) / 3.0
        if name == "compound":
            return xp, jhalo.stencil_with_halo(lambda a: _jblur3(_jblur3(a)), 2, "rows")(x)
        return xp, jhalo.crop_rows(xp, 1)

    fn = shard_map(local, mesh=mesh, in_specs=P("rows"), out_specs=(P("rows"), P("rows")))
    return tuple(np.asarray(a) for a in jax.jit(fn)(jnp.asarray(img)))


@pytest.mark.parametrize("name", ["blur", "compound", "channels"])
def test_halo_matches_jax(halo_results, name):
    """The exchanged rows are JAX's, bit for bit, and the stencil on them is
    the stencil on JAX's rows. The results are JAX's within atol 1e-6,
    except the compound stencil on 0..255, where one float32 ULP is 1.5e-5
    and XLA's jit of (up + x + dn) / 3 rounds unlike the same arithmetic
    eagerly (in torch and in JAX alike): within 1e-6 relative there."""
    images, got = halo_results
    img = images[name]
    padded, result = _jax_halo(name, img)
    np.testing.assert_array_equal(got[f"{name}.padded"], padded)
    blocks = [b.copy() for b in np.split(padded, 4)]
    if name == "blur":
        on_jax_rows = np.concatenate([_blur3_rows(torch.from_numpy(b)).numpy() for b in blocks])
    elif name == "compound":
        on_jax_rows = np.concatenate([compound(torch.from_numpy(b)).numpy()[2:-2]
                                      for b in blocks])
    else:
        on_jax_rows = np.concatenate([b[1:-1] for b in blocks])
    np.testing.assert_array_equal(got[name], on_jax_rows)
    if name == "compound":
        np.testing.assert_allclose(got[name], result, rtol=1e-6, atol=0)
        want = compound(torch.from_numpy(img)).numpy()   # interior rows: the unsharded stencil
        np.testing.assert_allclose(got[name][4:-4], want[4:-4], atol=1e-5)
    else:
        np.testing.assert_allclose(got[name], result, atol=1e-6, rtol=0)
    if name == "blur":
        np.testing.assert_allclose(got[name], blur3(torch.from_numpy(img)).numpy(), atol=1e-6)
    elif name == "channels":
        np.testing.assert_array_equal(got[name], img)


def test_halo_on_one_rank_clamps_at_both_edges():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    from nrdsample_tpu_torch.parallel import halo

    xp = halo.exchange_rows(x, 2, mesh_mod.make_mesh(device="cpu"))
    assert torch.equal(xp[:2], x[:1].expand(2, 3)) and torch.equal(xp[-2:], x[-1:].expand(2, 3))
    assert torch.equal(halo.crop_rows(xp, 2), x) and halo.crop_rows(x, 0) is x


# ---- tests/test_distributed.py's bring-up over 2 gloo ranks ----


def test_two_rank_bringup():
    from nrdsample_tpu_torch.scene import procedural

    ranks = distributed.run_ranks(distributed_rank, 2, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    scene0 = procedural.cornell_box()
    for r in ranks:
        assert r["init_again"] is True and r["world"] == 2 and r["backend"] == "gloo"
        assert tuple(r["mesh"]) == (1, 2) and tuple(r["device_mesh"]) == (1, 2)
        np.testing.assert_array_equal(r["albedo"], 0.0)
        assert r["ior"] == 1.5
        np.testing.assert_array_equal(r["base_color"], scene0.materials.base_color.numpy())
        np.testing.assert_array_equal(r["tris"], scene0.tris.p0.numpy())
        assert r["total"] == float(np.arange(16, dtype=np.float32).sum())
        assert r["devices"] == ["cpu"] * 4


def test_a_failing_rank_fails_the_run():
    """Rank 0 raises while rank 1 waits for it in a collective: the run
    raises with rank 0's traceback at once, not at the spawn's timeout, and
    ends rank 1."""
    t0 = time.monotonic()
    with pytest.raises(distributed.RankError, match="ZeroDivisionError: rank 0 fails"):
        distributed.run_ranks(fail_on_rank_0, 2, device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    assert time.monotonic() - t0 < SPAWN_TIMEOUT_S / 4


# ---- the sharded frame and training step over 2 gloo ranks ----


def _sharded():
    """Rank 0's planes of two sharded frames of each mode and its sharded
    gradients (one spawn of 2 ranks), beside the single-rank port's."""
    ranks = distributed.run_ranks(frames_and_grads_rank, 2, (FRAME_SPECS, GRAD_SPEC),
                                  device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    single = []
    for spec in FRAME_SPECS:
        ctx, scene, cam, cfg, settings = dryrun.setup(spec, "cpu")
        h = frame.History.create(cfg, "cpu")
        with torch.no_grad():
            for _ in range(2):
                out, h = frame.render_frame(ctx, scene, cam, cfg, settings, h)
        single.append({k: v.numpy() for k, v in dryrun.frame_planes(out, h).items()})
    ctx, scene, cam, cfg, settings = dryrun.setup(GRAD_SPEC, "cpu")
    diff, rest = train.split_materials(scene.materials)
    loss, grads = train.value_and_grad(train.make_loss_fn(ctx, cfg), diff, rest, scene, cam,
                                       settings, frame.History.create(cfg, "cpu"),
                                       torch.zeros((cfg.n_pixels, 3)))
    return {"ranks": ranks, "single": single, "loss": float(loss),
            "grads": {k: v.numpy() for k, v in grads.items()}}


declare("torch_parallel_sharded", lambda _: _sharded())


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return session_cached(tmp_path_factory, "torch_parallel_sharded", _sharded)


@pytest.mark.parametrize("index", [0, 1], ids=list(MODES))
def test_sharded_frame_matches_the_single_rank_frame(sharded, index):
    ranks, single = sharded["ranks"], sharded["single"]
    got, want = ranks[0]["frames"][index]["planes"], single[index]
    assert set(got) == set(want) and len(want) > 20
    diffs = dryrun.max_abs_diff(got, want)
    worst = max(diffs, key=diffs.get)
    assert diffs[worst] < PARITY_TOL, (worst, diffs[worst])
    assert [r["frames"][index]["pixels"] for r in ranks] == [[0, 1152], [1152, 2304]]
    assert [r["frames"][index]["broadcast"] for r in ranks] == [["cpu", "cpu", True]] * 2


def test_sharded_gradients_match_the_single_rank_gradients(sharded):
    loss, grads = sharded["loss"], sharded["grads"]
    got = sharded["ranks"][0]["grads"]
    assert abs(got["loss"] - loss) <= 1e-5 * loss
    for k, w in grads.items():
        g = got["grads"][k]
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.max(np.abs(g - w)) <= PARITY_TOL * np.max(np.abs(w)), k
    assert np.max(np.abs(grads["base_color"])) > 0


def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    """The dry run (a 16x16 flagship frame and step over 2 ranks); its step
    equals make_train_step's on one rank."""
    res = dryrun.dryrun_multichip(2, device="cpu", size=16, timeout_s=SPAWN_TIMEOUT_S)
    assert res["err"] < dryrun.PARITY_TOL and np.isfinite(res["loss"])
    assert "dryrun_multichip(2): 16x16" in capsys.readouterr().out
    ctx, scene, cam, cfg, settings = dryrun.flagship(16, 16, "cpu")
    loss, mats = train.make_train_step(ctx, cfg)(scene.materials, scene, cam, settings,
                                                 frame.History.create(cfg, "cpu"),
                                                 torch.zeros((cfg.n_pixels, 3)))
    assert abs(res["loss"] - float(loss)) <= 1e-5 * float(loss)
    for k, v in res["materials"].items():
        np.testing.assert_allclose(v, getattr(mats, k).numpy(), rtol=0, atol=1e-6)
