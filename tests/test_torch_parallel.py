"""The port's sharded stages (``slam_loop_closing_tpu_torch.parallel``) on 1,
2 and 4 gloo ranks, against the JAX package's ``parallel.sharded`` on the
8-device CPU mesh of ``tests/conftest.py`` at ``tests/test_parallel.py``'s
shapes, and against the port's own single-device functions.

Ring and banded counts are integers and must be bitwise equal, zeros
included (the skipped tiles); the front-end's validity bitwise, its
keypoints within 1e-4; the video loops equal. PGO and BA sum partial sums
over the ranks, which reorders float adds, so they are held to the port's
single-device ``optimize_pose_graph`` / ``alternating_ba`` at
``tests/test_parallel.py``'s tolerances (PGO 1e-5, its last cost rtol 1e-5;
BA 5e-3 / 5e-2 / 1e-3); the port's single-device PGO and BA are held to the
JAX package by ``test_torch_sfm.py``. RANSAC's pair split must not change a
pair's result: equal to the single-device call at every world size.

The ranks run in spawned processes (:func:`..parallel.launch.spawn`, each
with its own timeout) on the rank bodies of ``tests/torch_parallel_ranks.py``,
which import no jax; each world size runs all light stages in one spawn,
started in a thread so the JAX references compile meanwhile.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from slam_loop_closing_tpu.config import OrbConfig as JOrbConfig
from slam_loop_closing_tpu.parallel import mesh as jmesh
from slam_loop_closing_tpu.parallel import sharded as jsharded
from slam_loop_closing_tpu_torch.config import (BaConfig, OrbConfig,
                                                PgoConfig, RansacConfig)
from slam_loop_closing_tpu_torch.ops import ba, lie, orb, pgo, ransac
from slam_loop_closing_tpu_torch.parallel import dryrun, launch, sharded
from slam_loop_closing_tpu_torch.parallel import mesh as mesh_lib
from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

torch.set_num_threads(1)

WORLD_SIZES = (1, 2, 4)
SPAWN_TIMEOUT = 240.0
RING_CASES = {"full16": (16, 64, None), "band64_gap5": (64, 32, 5),
              "band64_gap3": (64, 32, 3)}
BANDED_CASES = {"f16_gap5": (16, 48, 5), "f11_gap3": (11, 32, 3),
                "f11_gap5": (11, 32, 5)}


def random_db(rng, f, n):
    """tests/test_parallel.py's store: random +-1 descriptors, a random
    valid prefix a frame, invalid rows zero."""
    signed = np.where(rng.random((f, n, 256)) > 0.5, 1, -1).astype(np.int8)
    valid = np.zeros((f, n), bool)
    for i in range(f):
        k = rng.integers(n // 2, n + 1)
        valid[i, :k] = True
        signed[i, k:] = 0
    return signed, valid


def two_view_pairs(rng, p=6, n=64):
    """``p`` pairs of ``n`` normalized correspondences of random scenes, a
    quarter of them outliers, a tenth masked out."""
    x1s, x2s = [], []
    for _ in range(p):
        X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(4, 10, n)], -1)
        R = np.asarray(lie.so3_exp(torch.tensor(rng.normal(0, 0.05, 3),
                                                dtype=torch.float32)))
        t = np.array([-1.0, rng.normal(0, 0.1), rng.normal(0, 0.1)])
        Xc = X @ R.T + t
        x1s.append(X[:, :2] / X[:, 2:])
        x2 = Xc[:, :2] / Xc[:, 2:]
        x2[: n // 4] += rng.normal(0, 0.2, (n // 4, 2))
        x2s.append(x2)
    mask = rng.random((p, n)) > 0.1
    return (np.asarray(x1s, np.float32), np.asarray(x2s, np.float32), mask)


def pose_chain(rng, k=13):
    """tests/test_parallel.py's PGO graph: odd edge count (12 sequential +
    1 loop), so the edges pad."""
    params = torch.tensor(rng.normal(0, 0.1, (k, 6)), dtype=torch.float32)
    g = pgo.build_trajectory_graph(
        params, 1, k - 1, lie.so3_exp(torch.tensor([0.05, -0.02, 0.01])),
        torch.tensor([0.1, 0.0, -0.05]), 10.0)
    return params.numpy(), {f: getattr(g, f).numpy()
                            for f in pgo.PoseGraph._fields}


def ba_scene(rng, drop: int):
    """tests/test_parallel.py's BA scene: 6 cameras x 40 points, pixel
    noise, noisy points; ``drop`` observations removed (a count that does
    not split evenly pads)."""
    n_cam, n_pt = 6, 40
    pts = (rng.uniform(-1, 1, (n_pt, 3)) + [0, 0, 5]).astype(np.float32)
    cams = rng.normal(0, 0.05, (n_cam, 6)).astype(np.float32)
    K = np.asarray([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]], np.float32)
    oc, op = np.meshgrid(np.arange(n_cam), np.arange(n_pt), indexing="ij")
    oc, op = oc.ravel()[drop:], op.ravel()[drop:]
    uv = ba._project_params(torch.from_numpy(K), torch.from_numpy(cams[oc]),
                            torch.from_numpy(pts[op])).numpy()
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    obs = {"cam": oc.astype(np.int32), "point": op.astype(np.int32),
           "uv": uv, "valid": np.ones(len(oc), bool)}
    noisy = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    return K, cams, noisy, obs


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ring = {name: (*random_db(rng, f, n), gap)
            for name, (f, n, gap) in RING_CASES.items()}
    banded = {name: (*random_db(rng, f, n), gap)
              for name, (f, n, gap) in BANDED_CASES.items()}
    frames = np.asarray(orbit_sequence(num_frames=8, h=96, w=128,
                                       num_points=120), np.float32)
    videos = np.stack([np.asarray(orbit_sequence(
        num_frames=16, h=96, w=128, num_points=150, seed=s), np.float32)
        for s in (0, 1, 2)])                     # V = 3: pads on 2 and 4
    return {"ring": ring, "banded": banded, "frontend": (frames, 100),
            "videos": videos, "pgo": pose_chain(rng),
            "ba": {"240obs": ba_scene(rng, 0), "237obs": ba_scene(rng, 3)},
            "verify": (*two_view_pairs(rng), 32)}


SFM_CAPS = dict(max_keyframes=32, max_points=8192, max_obs=32768)


def sfm_frames():
    return np.asarray(orbit_sequence(num_frames=24, h=144, w=192,
                                     num_points=250, seed=5), np.float32)


@pytest.fixture(scope="module")
def spawned(inputs):
    """Every spawn of this file, started together in threads (the ranks
    run while the JAX references and the single-device twins compute):
    ("stages", ws) for each world size, ("sfm", 2) and ("dryrun", 2)."""
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLD_SIZES) + 2)
    futures = {("stages", ws): pool.submit(
        launch.spawn, ranks.stages, ws, device="cpu", args=(inputs,),
        timeout=SPAWN_TIMEOUT) for ws in WORLD_SIZES}
    futures["sfm", 2] = pool.submit(
        launch.spawn, ranks.sfm, 2, device="cpu",
        args=(sfm_frames(), dryrun.sfm_config().to_json(), SFM_CAPS),
        timeout=SPAWN_TIMEOUT)
    futures["dryrun", 2] = pool.submit(dryrun.dryrun_multichip, 2,
                                       device="cpu", timeout=SPAWN_TIMEOUT)
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def port(spawned):
    """{world size: the future of every rank's ``ranks.stages`` results}."""
    return {ws: spawned["stages", ws] for ws in WORLD_SIZES}


def results(port, ws, key):
    """Rank 0's result of ``key``, after checking every rank got the same
    (the sharded functions give every rank the global result)."""
    outs = port[ws].result()
    for other in outs[1:]:
        _assert_same(other[key], outs[0][key])
    return outs[0][key]


def _assert_same(a, b):
    if isinstance(a, dict):
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)) and a and isinstance(a[0], np.ndarray):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must fake 8 CPU devices"
    return jmesh.make_mesh(8)


@pytest.fixture(scope="module")
def jax_ring(mesh8, inputs, port):
    return {name: np.asarray(jsharded.ring_similarity_counts(
                mesh8, jnp.asarray(s), jnp.asarray(v), min_gap=gap))
            for name, (s, v, gap) in inputs["ring"].items()}


@pytest.fixture(scope="module")
def jax_banded(mesh8, inputs, port):
    out = {}
    for name, (s, v, gap) in inputs["banded"].items():
        nfeat = jnp.sum(jnp.asarray(v), axis=1).astype(jnp.int32)
        c, sims = jsharded.banded_loop_counts(mesh8, jnp.asarray(s),
                                              jnp.asarray(v), nfeat, gap)
        out[name] = (np.asarray(c), np.asarray(sims))
    return out


# ---------------------------------------------------------------------------
# ring and banded counts against the JAX mesh, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_equals_jax(port, jax_ring, inputs, ws, case):
    got = results(port, ws, f"ring/{case}")
    np.testing.assert_array_equal(got, jax_ring[case])
    gap = inputs["ring"][case][2]
    if gap is not None:
        # zeros exactly on the tiles the JAX rule skips
        f, block = got.shape[0], 8
        q = np.arange(f)[:, None] // block * block
        t = np.arange(f)[None, :] // block * block
        skipped = ~(t <= q + block - 1 - gap)
        assert not got[skipped].any() and got[~skipped].any()


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("case", list(BANDED_CASES))
def test_banded_loop_counts_equal_jax(port, jax_banded, inputs, ws, case):
    counts, sims = results(port, ws, f"banded/{case}")
    ref_c, ref_s = jax_banded[case]
    f, gap = counts.shape[0], inputs["banded"][case][2]
    assert counts.shape == (f, f) == (BANDED_CASES[case][0],) * 2
    np.testing.assert_array_equal(counts, ref_c)
    np.testing.assert_array_equal(sims, ref_s)
    band = np.arange(f)[None, :] <= np.arange(f)[:, None] - gap
    assert not counts[~band].any() and counts[band].all()


# ---------------------------------------------------------------------------
# the front-end and the videos against the JAX mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_frontend(mesh8, inputs, port):
    frames, nf = inputs["frontend"]
    return jsharded.frontend_sharded(
        mesh8, jnp.asarray(frames), JOrbConfig(num_features=nf,
                                               num_levels=1))


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_frontend_sharded_equals_jax(port, jax_frontend, inputs, ws):
    got = results(port, ws, "frontend")
    np.testing.assert_array_equal(got["valid"],
                                  np.asarray(jax_frontend.keypoints.valid))
    np.testing.assert_allclose(got["xy"],
                               np.asarray(jax_frontend.keypoints.xy),
                               atol=1e-4)
    # and bitwise the port's single-device call (its front-end does not
    # depend on the batch)
    frames, nf = inputs["frontend"]
    local = orb.detect_and_describe_batch(
        torch.from_numpy(frames),
        OrbConfig(num_features=nf, num_levels=1))
    for name, ref in (("valid", local.keypoints.valid),
                      ("xy", local.keypoints.xy),
                      ("descriptors", local.descriptors),
                      ("signed", local.signed)):
        np.testing.assert_array_equal(got[name], ref.numpy(), err_msg=name)


@pytest.fixture(scope="module")
def jax_videos(mesh8, inputs, port):
    from slam_loop_closing_tpu.config import (LoopConfig,
                                              PipelineConfig as JPipeline)

    cfg = dataclasses.replace(
        JPipeline(), orb=JOrbConfig(num_features=100, num_levels=1),
        loop=LoopConfig(loop_threshold=0.15, min_loop_gap=8, frame_skip=1))
    return ranks.loop_tuples(
        jsharded.process_videos_sharded(mesh8, inputs["videos"], cfg))


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_process_videos_sharded_equals_jax(port, jax_videos, ws):
    got = results(port, ws, "videos")
    assert len(got) == 3 and any(got)
    assert got == jax_videos


# ---------------------------------------------------------------------------
# PGO, BA and RANSAC against the port's single-device functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("solver", ["dense", "pcg"])
def test_pgo_sharded_matches_single(port, inputs, ws, solver):
    params, graph = inputs["pgo"]
    cfg = (PgoConfig() if solver == "dense"
           else PgoConfig(dense_solver_max_poses=0, cg_iterations=30))
    ref, costs_ref = pgo.optimize_pose_graph(
        torch.from_numpy(params), ranks.pose_graph(graph), cfg)
    got, costs = results(port, ws, f"pgo/{solver}")
    assert graph["mask"].shape[0] % 2 == 1       # the edges pad
    assert costs[-1] < 0.5 * costs[0]
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(costs[-1], costs_ref[-1].numpy(), rtol=1e-5)


@pytest.mark.parametrize("ws", WORLD_SIZES)
@pytest.mark.parametrize("case", ["240obs", "237obs"])
def test_ba_sharded_matches_single(port, inputs, ws, case):
    K, cams, pts, obs = inputs["ba"][case]
    ref_c, ref_p, ref_e = ba.alternating_ba(
        torch.from_numpy(K), torch.from_numpy(cams), torch.from_numpy(pts),
        ranks.observations(obs), None, BaConfig())
    got_c, got_p, got_e = results(port, ws, f"ba/{case}")
    np.testing.assert_allclose(got_c, ref_c.numpy(), atol=5e-3)
    np.testing.assert_allclose(got_p, ref_p.numpy(), rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(got_e, ref_e.numpy(), rtol=1e-3)
    assert got_e[-1] < 0.5 * float(ba.mean_reprojection_error(
        torch.from_numpy(K), torch.from_numpy(cams), torch.from_numpy(pts),
        ranks.observations(obs)))


@pytest.mark.parametrize("ws", WORLD_SIZES)
def test_verify_pairs_sharded_equals_single(port, inputs, ws):
    x1, x2, mask, hyps = inputs["verify"]
    generator = torch.Generator()
    generator.manual_seed(0)
    ref = ransac.estimate_essential_ransac_pairs(
        torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(mask),
        generator, 100.0, RansacConfig(num_hypotheses=hyps))
    got = results(port, ws, "verify")
    assert ref.ok.any()
    for field in ransac.EssentialResult._fields:
        np.testing.assert_array_equal(got[field],
                                      getattr(ref, field).numpy(),
                                      err_msg=field)


# ---------------------------------------------------------------------------
# Version-B end to end, the dry run, the launcher and the mesh
# ---------------------------------------------------------------------------

def test_sfm_reconstruct_sharded_matches_staged_twin(spawned):
    """tests/test_parallel.py's end-to-end check on 2 ranks, at 512
    hypotheses (at the JAX test's 128 the port's own draws break the
    keyframe chain on this orbit and no loop is found, so the sharded PGO
    would not run)."""
    from slam_loop_closing_tpu_torch.models.sfm import SfMPipeline

    frames = sfm_frames()
    pipe = SfMPipeline(dryrun.sfm_config(), log=lambda *a: None,
                       use_scan=True, device="cpu", **SFM_CAPS)
    s1, _ = pipe.run_frontend_and_keyframes_scan(frames)
    loop1 = pipe.find_loop(s1)
    s1 = pipe.optimize(s1, loop1)
    s1, _ = pipe.bundle_adjust(s1)
    s1 = pipe.remove_outliers(s1)
    s1, errs2 = pipe.bundle_adjust(s1, outer_iterations=3)
    got = spawned["sfm", 2].result()
    _assert_same(got[1], got[0])
    got = got[0]
    assert loop1.found and got["metrics"]["loop_found"]
    assert got["kf_count"] == int(s1.kf_count)
    assert got["point_count"] == int(s1.point_count)
    np.testing.assert_allclose(got["poses"], s1.poses.numpy(), atol=1e-3)
    assert abs(got["metrics"]["e2"] - float(errs2[-1])) < 1e-2
    assert got["points_valid"] == int(s1.point_valid.sum())


def test_dryrun_two_ranks(spawned):
    s = spawned["dryrun", 2].result()
    assert s["ranks"] == 2 and s["loop_found"] and s["keyframes"] >= 5
    assert s["counts_shape"] == (4, 4) and len(s["pair_inliers"]) == 2
    assert dryrun.summary_line(s).startswith(
        "dryrun_multichip(2): frontend+ring+verify OK (counts (4, 4), 2 "
        "pairs); multi-video sharded OK (0 loops); Version-B sharded OK")


def _sleeper(mesh):
    import time

    time.sleep(600)


def _raiser(mesh):
    raise ValueError(f"rank {mesh.rank} fails")


def test_spawn_times_out():
    """A rank that never finishes fails the caller at the timeout (and is
    killed) instead of hanging the suite."""
    with pytest.raises(TimeoutError):
        launch.spawn(_sleeper, 1, device="cpu", timeout=3.0)


def test_spawn_raises_rank_failure():
    with pytest.raises(Exception, match="rank 0 fails"):
        launch.spawn(_raiser, 1, device="cpu", timeout=60.0)


def test_spawn_defaults_to_cuda():
    """``spawn`` runs NCCL ranks on the cards unless asked for the CPU."""
    import inspect

    sig = inspect.signature(launch.spawn)
    assert sig.parameters["device"].default == "cuda"


def test_spawn_without_gpu_raises_before_any_rank(monkeypatch):
    """With no device given on a machine without GPUs, ``spawn`` raises
    before it starts a process; nothing falls back to gloo."""
    started = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(launch.mp, "start_processes",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="CUDA device"):
        launch.spawn(_raiser, 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        launch.spawn(_raiser, 2, device="cuda:0")
    assert not started


def test_make_mesh_on_cuda_never_falls_back():
    """Without NCCL or a visible GPU a CUDA mesh raises; nothing moves the
    work to gloo or to the CPU."""
    if torch.cuda.is_available() and torch.distributed.is_nccl_available():
        pytest.skip("this machine has a card: the cuda-marked tests cover it")
    with pytest.raises(RuntimeError):
        mesh_lib.make_mesh(device="cuda")
    assert not torch.distributed.is_initialized()


def test_make_mesh_without_launcher_has_one_rank():
    with pytest.raises(ValueError, match="launcher"):
        mesh_lib.make_mesh(2, device="cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n,m", [(11, 8), (16, 8), (3, 4), (1, 1)])
def test_pad_to_multiple(n, m):
    x = torch.arange(n * 2, dtype=torch.int32).reshape(n, 2) + 1
    padded, size = mesh_lib.pad_to_multiple(x, m)
    assert size == n and padded.shape == (-(-n // m) * m, 2)
    assert torch.equal(padded[:n], x) and not padded[n:].any()
    jp, jn = jmesh.pad_to_multiple(jnp.asarray(x.numpy()), m)
    assert jn == n and np.array_equal(np.asarray(jp), padded.numpy())


@pytest.mark.parametrize("d,me,i,gap", [(1, 0, 0, 3), (2, 1, 0, 5),
                                        (2, 1, 1, 5), (4, 3, 2, 30),
                                        (4, 0, 3, 1)])
def test_band_step_pairs_follow_the_tile_rule(d, me, i, gap):
    """One ring step's pair list holds exactly the frame pairs of the tiles
    the JAX ring computes (its rule, tile by tile)."""
    fl, block = 32, 8
    src = (me - i) % d
    qidx, tidx = sharded._band_step_pairs(fl, block, me * fl, src * fl, gap,
                                          "cpu")
    got = set(zip(qidx.tolist(), (tidx - fl).tolist()))
    want = {(q * block + a, t * block + b)
            for q in range(fl // block) for t in range(fl // block)
            if src * fl + t * block <= me * fl + q * block + block - 1 - gap
            for a in range(block) for b in range(block)}
    assert got == want and len(got) == qidx.numel()
