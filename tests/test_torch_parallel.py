"""PyTorch port vs JAX package: ``parallel/`` on gloo process groups.

One group of four ranks, started by spawn (JAX's threads already run in
the pytest process, and fork is unsafe there), runs every multi-rank check
of the port and hands NumPy results back; the tests then hold them against
JAX's programs on the 8 forced host devices of tests/conftest.py, at the
tolerances of tests/test_spatial.py.  The rank body is a module-level
function and this module imports JAX only inside its tests, so a spawned
rank never imports JAX.  The group has a process-group timeout and every
join a timeout, so a hung rank fails the tests instead of stalling them.
"""

import datetime
import multiprocessing as mp
import sys
import time
import traceback

import numpy as np
import pytest
import torch

from imageanalysis3_tpu_torch import synthetic as tsyn

WORLD = 4
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
RESULT_TIMEOUT_S = 120          # after JAX's references are done
JOIN_TIMEOUT_S = 30
HALO = 3
CS_KW = dict(th_seed=300.0, max_num_seeds=32, background_gfilt_size=3.0)
PR_KW = dict(drift_channel_index=1, fit_channel_indices=(0,),
             seed_thresholds=[400.0, 400.0], hot_pixel=False,
             drift_size=32, max_num_seeds=48, lm_iters=15, n_max_iter=3,
             background_gfilt_size=3.0)
ROUNDS_SHAPE = (8, 64, 64)
N_ROUNDS = 5                 # not a multiple of WORLD: padding runs


def _inputs():
    """Every scene of the group, from seeded NumPy (the port's copies of
    the JAX package's synthetic helpers)."""
    rng = np.random.default_rng(0)
    halo_x = rng.normal(size=(4, 64, 8)).astype(np.float32)

    # tests/test_spatial.py::test_sharded_correct_and_seed_matches_single_device
    rng = np.random.default_rng(1)
    shape = (10, 128, 64)
    im, _ = tsyn.random_spot_field(shape, 12, rng, min_separation=10.0,
                                   height_range=(800.0, 2500.0))
    prof = tsyn.illumination_profile(shape[1:])
    raw = tsyn.poisson_camera_noise(im * prof[None], rng).astype(np.uint16)

    # tests/test_spatial.py::test_sharded_process_round_full_chain
    rng = np.random.default_rng(5)
    _, t = tsyn.random_spot_field(shape, 40, rng, min_separation=7.0,
                                  height_range=(1500.0, 4000.0))
    ref = tsyn.render_gaussian_spots(shape, t["centers"], t["heights"],
                                     t["sigmas"], 120.0).astype(np.float32)
    d_true = np.array([0.4, 1.2, -0.9])
    mov = tsyn.render_gaussian_spots(shape, t["centers"] + d_true,
                                     t["heights"], t["sigmas"],
                                     120.0).astype(np.float32)

    fov = tsyn.make_synthetic_fov(shape=ROUNDS_SHAPE, n_rounds=N_ROUNDS,
                                  n_channels=2, n_spots=10, seed=3,
                                  drift_scale=2.0)
    return {"halo_x": halo_x, "raw": raw, "prof": prof.astype(np.float32),
            "ims": np.stack([mov, mov]), "ref": ref, "truth": t["centers"],
            "d_true": d_true,
            "rounds": np.clip(fov.ims, 0, 65535).astype(np.uint16),
            "rounds_illum": fov.illumination.astype(np.float32),
            "batch": np.arange(8 * 3 * 4, dtype=np.float32).reshape(8, 3, 4)}


def _seeds_np(corrected, seeds):
    return {"corrected": corrected.numpy(),
            "coords": seeds.coords.numpy(), "valid": seeds.valid.numpy(),
            "count": int(seeds.count), "threshold": float(seeds.threshold)}


def _round_pipeline(inp):
    from imageanalysis3_tpu_torch.config import ExperimentConfig, SeedConfig
    from imageanalysis3_tpu_torch.pipeline import FovPipeline
    cfg = ExperimentConfig(image_size=ROUNDS_SHAPE,
                           seed=SeedConfig(th_seed=300.0, max_num_seeds=32))
    return FovPipeline(cfg, n_channels=2, drift_channel_index=1,
                       fit_channel_indices=(0, 1),
                       illumination=inp["rounds_illum"],
                       image_shape=ROUNDS_SHAPE, device="cpu")


def _rank_main(rank, world, store_path, inp, results):
    """One rank of the group: every multi-rank check, results to the
    parent (rank 0's in full, the others' own rows where they differ)."""
    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        from torch.distributed.tensor import DTensor, Shard

        from imageanalysis3_tpu_torch.parallel import (assemble_global_batch,
                                                       make_mesh, shard_fovs)
        from imageanalysis3_tpu_torch.parallel import spatial as sp
        from imageanalysis3_tpu_torch.parallel.mesh import gather_cat

        mesh = make_mesh(device_type="cpu",
                         store=dist.FileStore(store_path, world),
                         rank=rank, world_size=world,
                         timeout=GROUP_TIMEOUT)
        one = make_mesh(1, device_type="cpu", timeout=GROUP_TIMEOUT)
        out = {"jax_loaded": any(m.split(".")[0] in ("jax",
                                                     "imageanalysis3_tpu")
                                 for m in sys.modules),
               "mesh": (mesh.size(), mesh.get_local_rank(),
                        mesh.mesh_dim_names),
               "one_is_none": one is None}

        x = inp["halo_x"]
        w = x.shape[1] // world
        tile = sp.halo_exchange(torch.from_numpy(x[:, rank * w:
                                                   (rank + 1) * w]),
                                HALO, mesh)
        out["halo_tiles"] = gather_cat(tile, mesh, dim=1).numpy()

        out["cs"] = _seeds_np(*sp.sharded_correct_and_seed(
            inp["raw"], mesh, illumination=inp["prof"], **CS_KW))
        w = inp["raw"].shape[1] // world
        block = torch.from_numpy(inp["raw"][:, rank * w:(rank + 1) * w])
        dt = DTensor.from_local(block, mesh, [Shard(1)], run_check=False)
        out["cs_dtensor"] = _seeds_np(*sp.sharded_correct_and_seed(
            dt, mesh, illumination=inp["prof"], **CS_KW))

        pr = sp.sharded_process_round(inp["ims"], inp["ref"], mesh, **PR_KW)
        out["pr"] = [t.numpy() for t in pr]

        pipe = _round_pipeline(inp)
        rounds = torch.from_numpy(inp["rounds"])
        ref = pipe.prepare_reference(pipe.correct_reference(rounds[0]))
        got = pipe.process_rounds(rounds, ref, mesh=mesh)
        out["rounds_mesh"] = [f.numpy() for f in got]

        fovs = [f"fov_{i:02d}" for i in range(8)]
        mine = shard_fovs(fovs)
        rows = [fovs.index(f) for f in mine]
        arr = assemble_global_batch(inp["batch"][rows], mesh)
        out["batch_rows"] = rows
        out["batch_local"] = arr.to_local().numpy()
        out["batch_full"] = arr.full_tensor().numpy()
        out["batch_sums"] = arr.sum(dim=(1, 2)).full_tensor().numpy()
        try:
            assemble_global_batch(np.zeros((3 if rank < 2 else 2, 1)), mesh)
            out["uneven_raised"] = False
        except ValueError:
            out["uneven_raised"] = True

        if one is not None:
            out["halo_one"] = sp.halo_exchange(torch.from_numpy(x), HALO,
                                               one).numpy()
            out["cs_one"] = _seeds_np(*sp.sharded_correct_and_seed(
                inp["raw"], one, illumination=inp["prof"], **CS_KW))
            out["pr_one"] = [t.numpy() for t in sp.sharded_process_round(
                inp["ims"], inp["ref"], one, **PR_KW)]
            out["rounds_meshless"] = [f.numpy() for f in
                                      pipe.process_rounds(rounds, ref)]
        dist.barrier()
        results.put((rank, "ok", out))
    except BaseException:       # noqa: BLE001 -- reported to the parent
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Start the 4-rank gloo group by spawn, collect every rank's results,
    join every rank within its timeout."""
    inp = _inputs()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, WORLD, store, inp, results), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        # JAX's programs compile and run here while the ranks work
        refs = {"cs": _jax_correct_and_seed(inp),
                "pr": _jax_process_round(inp)}
        t0 = time.monotonic()
        while len(got) < WORLD:
            left = RESULT_TIMEOUT_S - (time.monotonic() - t0)
            rank, status, payload = results.get(timeout=max(1.0, left))
            if status != "ok":
                pytest.fail(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=JOIN_TIMEOUT_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
            p.join(timeout=5)
    assert not hung, "a rank did not exit within its join timeout"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return inp, got, refs


def test_group_ranks_and_spawned_without_jax(group):
    _, got, _ = group
    for r in range(WORLD):
        assert got[r]["mesh"] == (WORLD, r, ("data",))
        assert not got[r]["jax_loaded"]
        assert got[r]["one_is_none"] == (r != 0)


def test_halo_exchange_matches_symmetric_pad(group):
    """Every rank's halo-extended tile equals the globally padded slice:
    the first and last by reflection, the interior ones exactly."""
    inp, got, _ = group
    x = inp["halo_x"]
    w = x.shape[1] // WORLD
    want = np.pad(x, ((0, 0), (HALO, HALO), (0, 0)), mode="symmetric")
    tiles = got[0]["halo_tiles"]
    for r in range(WORLD):
        tile = tiles[:, r * (w + 2 * HALO):(r + 1) * (w + 2 * HALO)]
        np.testing.assert_array_equal(tile, want[:, r * w:(r + 1) * w
                                                 + 2 * HALO])
    np.testing.assert_array_equal(got[0]["halo_one"], want)


def _jax_correct_and_seed(inp):
    import jax.numpy as jnp
    from imageanalysis3_tpu.ops.corrections import correct_channel_stack
    from imageanalysis3_tpu.ops.seeding import get_seeds
    from imageanalysis3_tpu.parallel import make_mesh
    from imageanalysis3_tpu.parallel.spatial import sharded_correct_and_seed
    raw, prof = jnp.asarray(inp["raw"]), jnp.asarray(inp["prof"])
    c_sh, s_sh = sharded_correct_and_seed(raw, make_mesh(4),
                                          illumination=prof, **CS_KW)
    c_1 = correct_channel_stack(raw[None], illumination_profile=prof[None],
                                do_bleedthrough=False, do_highpass=False)[0]
    s_1 = get_seeds(c_1, max_num_seeds=32, th_seed=300.0,
                    background_gfilt_size=3.0)
    return ((np.asarray(c_sh), s_sh), (np.asarray(c_1), s_1))


def _jax_process_round(inp):
    import jax
    import jax.numpy as jnp
    from imageanalysis3_tpu.parallel import make_mesh
    from imageanalysis3_tpu.parallel.spatial import sharded_process_round
    return jax.tree.map(np.asarray, sharded_process_round(
        jnp.asarray(inp["ims"]), jnp.asarray(inp["ref"]), make_mesh(4),
        **PR_KW))


def _coord_set(coords, valid):
    return {tuple(int(v) for v in c) for c in np.asarray(coords)[
        np.asarray(valid)]}


def test_sharded_correct_and_seed_matches_jax_and_unsharded(group):
    """4 ranks against JAX's make_mesh(4) program and JAX's unsharded
    correct_channel_stack + get_seeds (tests/test_spatial.py's case and
    tolerances); the port's own unsharded correction bit for bit; a
    DTensor input and a one-rank mesh give the same result."""
    from imageanalysis3_tpu_torch.ops.corrections import correct_channel_stack
    inp, got, refs = group
    cs = got[0]["cs"]
    (c_sh, s_sh), (c_1, s_1) = refs["cs"]
    for want in (c_sh, c_1):
        np.testing.assert_allclose(cs["corrected"], want, rtol=2e-5,
                                   atol=0.25)
    mine = _coord_set(cs["coords"], cs["valid"])
    assert mine == _coord_set(s_sh.coords, s_sh.valid)
    assert mine == _coord_set(s_1.coords, s_1.valid)
    assert len(mine) > 5
    assert cs["count"] == int(s_sh.count) == int(s_1.count)
    assert cs["threshold"] == pytest.approx(float(s_sh.threshold))
    port_1 = correct_channel_stack(
        torch.from_numpy(inp["raw"])[None],
        illumination_profile=torch.from_numpy(inp["prof"])[None],
        do_bleedthrough=False)[0].numpy()
    np.testing.assert_array_equal(cs["corrected"], port_1)
    for other in (got[1]["cs"], got[0]["cs_dtensor"], got[0]["cs_one"]):
        np.testing.assert_array_equal(other["corrected"], cs["corrected"])
        assert _coord_set(other["coords"], other["valid"]) == mine
        assert other["count"] == cs["count"]


def _matched(spots, valid, truth, tol):
    got = spots[valid][:, 1:4]
    return sum(np.linalg.norm(got - c, axis=1).min() < tol for c in truth)


def _rounds_agree(a, b):
    """tests/test_spatial.py's 1-device parity tolerances."""
    (ca, sa, va, da, _), (cb, sb, vb, db, _) = a, b
    np.testing.assert_allclose(ca, cb, rtol=2e-5, atol=2e-2)
    np.testing.assert_allclose(da, db, atol=5e-3)
    ga, gb = sa[0][va[0]][:, 1:4], sb[0][vb[0]][:, 1:4]
    assert len(ga) == len(gb)
    for c in gb:
        assert np.linalg.norm(ga - c, axis=1).min() < 0.05


def test_sharded_process_round_recovers_truth_and_matches_one_rank(group):
    inp, got, _ = group
    corrected, spots, valid, drift, flag = got[0]["pr"]
    assert corrected.shape == (2,) + inp["ref"].shape
    np.testing.assert_allclose(drift, -inp["d_true"], atol=0.2)
    assert int(flag) == 0
    assert _matched(spots[0], valid[0], inp["truth"], 0.3) \
        >= 0.8 * len(inp["truth"])
    _rounds_agree(got[0]["pr"], got[0]["pr_one"])
    for r in range(1, WORLD):
        for a, b in zip(got[r]["pr"], got[0]["pr"]):
            np.testing.assert_array_equal(a, b)


def test_sharded_process_round_matches_jax(group):
    _, got, refs = group
    want = refs["pr"]
    _rounds_agree(got[0]["pr"], want)
    assert int(got[0]["pr"][4]) == int(want[4])


def test_process_rounds_over_the_mesh_equals_meshless(group):
    """5 rounds over 4 ranks (padded to 8): every field bit for bit the
    meshless form's, on every rank."""
    _, got, _ = group
    want = got[0]["rounds_meshless"]
    assert want[0].shape[0] == N_ROUNDS
    for r in range(WORLD):
        for a, b in zip(got[r]["rounds_mesh"], want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert want[2].sum() > 0           # some spots are valid


def test_assemble_global_batch_rows_in_fov_order(group):
    inp, got, _ = group
    batch = inp["batch"]
    assert sum((got[r]["batch_rows"] for r in range(WORLD)), []) \
        == list(range(8))
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["batch_local"],
                                      batch[got[r]["batch_rows"]])
        np.testing.assert_array_equal(got[r]["batch_full"], batch)
        np.testing.assert_allclose(got[r]["batch_sums"],
                                   batch.sum(axis=(1, 2)))
        assert got[r]["uneven_raised"]


def test_lm_fit_single_matches_jax():
    """One spot at a time, the port's batch of one against JAX's
    lm_fit_single (cold and warm started), at tests/test_torch_fit.py's
    tolerances on the natural rows."""
    import jax
    import jax.numpy as jnp
    from imageanalysis3_tpu import synthetic as jsyn
    from imageanalysis3_tpu.ops import gaussian_fit as jg
    from imageanalysis3_tpu_torch.ops import gaussian_fit as tg

    rng = np.random.default_rng(0)
    shape = (20, 64, 64)
    truth = jsyn.sample_spot_params(shape, 8, rng, min_separation=10.0)
    im = jsyn.render_gaussian_spots(shape, truth["centers"],
                                    truth["heights"], truth["sigmas"],
                                    truth["background"])
    im = jsyn.poisson_camera_noise(im, rng).astype(np.float32)
    seeds = jnp.asarray(truth["centers"].round().astype(np.float32))
    px, co, mk = jg.gather_blocks(jnp.asarray(im), seeds, 5)
    fit = jax.jit(jax.vmap(lambda a, b, c, d, p0: jg.lm_fit_single(
        a, b, c, d, 1.0, 0.5, 4.0, 1.5, 30, params0=p0),
        in_axes=(0, 0, 0, 0, None)))
    pj, ej = fit(px, co, mk, seeds, None)
    pj_w, ej_w = jax.jit(jax.vmap(lambda a, b, c, d, p0: jg.lm_fit_single(
        a, b, c, d, 1.0, 0.5, 4.0, 1.5, 10, params0=p0)))(
        px, co, mk, seeds, pj)
    for p0, want_p, want_e, iters in ((None, pj, ej, 30),
                                      (pj, pj_w, ej_w, 10)):
        rows = [tg.lm_fit_single(
            np.array(px[i]), np.array(co[i]), np.array(mk[i]),
            np.array(seeds[i]), 1.0, 0.5, 4.0, 1.5, iters,
            params0=None if p0 is None else np.array(p0[i]),
            device="cpu") for i in range(px.shape[0])]
        p_t = torch.stack([r[0] for r in rows])
        e_t = torch.stack([r[1] for r in rows])
        ce = torch.from_numpy(np.array(seeds))
        delta = torch.ones(len(rows))
        nat_t = tg.to_natural(p_t, ce, delta, 0.5, 4.0, e_t).numpy()
        nat_j = tg.to_natural(torch.from_numpy(np.array(want_p)), ce,
                              delta, 0.5, 4.0,
                              torch.from_numpy(np.array(want_e))).numpy()
        np.testing.assert_allclose(nat_t[:, 1:4], nat_j[:, 1:4], atol=1e-3)
        np.testing.assert_allclose(nat_t[:, 0], nat_j[:, 0], rtol=1e-2)
        np.testing.assert_allclose(nat_t[:, 5:8], nat_j[:, 5:8], atol=1e-3)
        np.testing.assert_allclose(nat_t[:, 10], nat_j[:, 10], rtol=1e-3)
        assert np.abs(nat_t[:, 1:4] - truth["centers"]).max() < 0.5


def test_make_mesh_needs_a_card_for_cuda(monkeypatch):
    """A CUDA mesh without a card raises; it never falls back to gloo."""
    import torch.distributed as dist
    from imageanalysis3_tpu_torch.parallel import make_mesh
    if dist.is_initialized():
        pytest.fail("a process group leaked into this test process")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(store=dist.HashStore(), rank=0, world_size=1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="store"):
        make_mesh(device_type="cpu", rank=0)
