"""The port's live Version-A API against the JAX package on the CPU, on the
32-frame 144x192 orbit fixture of test_loop_closing.py: ``process_frame``,
``process_stream``, ``detect_loops`` and the single-stage entry points.

Loops depend on features and counts only: the loop set, its order, every
count and similarity are equal (tolerance 0), and so are the log lines.
RANSAC's random numbers do not carry across frameworks, so geometry is held
to the JAX package with its sampled minimal sets injected (R within 1e-3),
and the port's own sampling to the fixture's pose and point gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu.models import loop_closing as jlc
from slam_loop_closing_tpu.ops import matching as jmatch
from slam_loop_closing_tpu.ops import ransac as jransac
from slam_loop_closing_tpu.utils import synth_video as jsynth
from slam_loop_closing_tpu_torch import config as tconfig
from slam_loop_closing_tpu_torch.models import loop_closing as tlc
from slam_loop_closing_tpu_torch.utils import convert
from test_torch_loop_closing import as_tuples, small_config

torch.set_num_threads(1)

NUM_FRAMES = 32


def port_config(cfg):
    return tconfig.PipelineConfig.from_json(cfg.to_json())


def port_system(log=None, max_frames=NUM_FRAMES):
    return tlc.LoopClosingSystem(
        port_config(small_config(0)), max_frames=max_frames,
        log=log if log is not None else (lambda _: None), device="cpu")


@pytest.fixture(scope="module")
def orbit_frames():
    return jsynth.orbit_sequence(num_frames=NUM_FRAMES, h=144, w=192,
                                 num_points=250, seed=3)


@pytest.fixture(scope="module")
def jax_run(orbit_frames):
    """The JAX package's process_frame over the fixture: (system, log
    lines, loops per frame)."""
    lines = []
    sys_ = jlc.LoopClosingSystem(small_config(0), max_frames=NUM_FRAMES,
                                 log=lines.append)
    loops = [sys_.process_frame(f) for f in orbit_frames]
    return sys_, lines, loops


@pytest.fixture(scope="module")
def port_run(orbit_frames):
    lines = []
    sys_ = port_system(log=lines.append)
    loops = [sys_.process_frame(f) for f in orbit_frames]
    return sys_, lines, loops


def test_process_frame_same_loops_as_jax(jax_run, port_run):
    """Loop set, order, counts and similarities frame by frame, and the
    whole record: equal (tolerance 0)."""
    jsys, _, jloops = jax_run
    tsys, _, tloops = port_run
    assert [as_tuples(x) for x in tloops] == [as_tuples(x) for x in jloops]
    assert as_tuples(tsys.get_loop_closures()) == \
        as_tuples(jsys.get_loop_closures())
    assert len(tsys.get_loop_closures()) > 20


def test_log_lines_equal_jax(jax_run, port_run):
    """``log`` receives one line per loop, in the JAX package's words."""
    _, jlines, _ = jax_run
    _, tlines, _ = port_run
    assert tlines == jlines
    assert tlines[0].startswith("Loop closure detected: frame 20 <-> frame")


def test_process_frame_same_loops_as_process_video(port_run, orbit_frames):
    tsys, _, _ = port_run
    video = port_system().process_video(orbit_frames)
    key = lambda loops: {(c.current_frame_id, c.matched_frame_id)  # noqa: E731
                         for c in loops}
    assert key(video) == key(tsys.get_loop_closures())


def test_process_stream_equals_process_frame(port_run, orbit_frames):
    """process_stream yields the ids in order, each frame's loops are those
    of plain process_frame calls, and they concatenate to the record."""
    tsys, _, loops = port_run
    stream_sys = port_system()
    ids = [100 + i for i in range(NUM_FRAMES)]
    per_frame = list(stream_sys.process_stream(orbit_frames, frame_ids=ids))
    assert [fid for fid, _ in per_frame] == ids
    shift = [[(c.current_frame_id - 100, c.matched_frame_id - 100,
               c.num_matches, c.similarity_score) for c in x]
             for _, x in per_frame]
    assert shift == [as_tuples(x) for x in loops]
    flat = [c for _, x in per_frame for c in x]
    assert as_tuples(flat) == as_tuples(stream_sys.get_loop_closures())


def test_consecutive_pose_and_points(port_run):
    """The port's own RANSAC on frames 0 -> 1: a pose that is not the
    identity, with an orthonormal rotation, and > 10 triangulated points;
    every frame's points pass the depth and distance gates."""
    tsys, _, _ = port_run
    f1 = tsys.get_frames()[1]
    assert not np.allclose(f1.pose, np.eye(4))
    R = f1.pose[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
    assert len(f1.points3d) > 10
    for f in tsys.get_frames():
        if len(f.points3d):
            assert (f.points3d[:, 2] > 0).all()
            assert (np.linalg.norm(f.points3d, axis=1) < 100).all()


def _jax_ransac(rows_i, rows_j, K, key, cfg, radius, tau):
    """The JAX package's _pair_geometry up to its RANSAC, op by op: the
    minimal sets it draws for this key, and its RANSAC result on them."""
    m = jmatch.nn_matches_2xmin(rows_i[0], rows_i[1], rows_j[0], rows_j[1],
                                2.0)
    c = jnp.stack([K[0, 2], K[1, 2]])
    f = jnp.stack([K[0, 0], K[1, 1]])
    x1 = (rows_i[2] - c) / f
    x2 = (rows_j[2][m.idx] - c) / f
    quality = jmatch.prosac_quality(x2, x1, m, radius, tau)
    idx = jransac._sample_minimal_sets(key, m.mask, cfg.num_hypotheses,
                                       cfg.min_points, quality)
    res = jransac.estimate_essential_ransac(
        x1, x2, m.mask, key, (K[0, 0] + K[1, 1]) * 0.5, cfg, quality=quality)
    return idx, res


def test_geometry_with_jax_samples(jax_run):
    """Every consecutive pair the JAX package accepted: its keys replayed
    (one split per pair, one more per scanned frame; the JAX geometry
    recomputed must give the recorded pose), its minimal sets injected into
    the port's geometry on the converted database — which accepts the pose
    too, R within 1e-3 of JAX's RANSAC on the same sets (measured 5e-5).
    The reference is JAX's RANSAC run op by op: its fused per-frame program
    rounds differently and lands up to 1.2e-3 away from it on this
    fixture."""
    jsys, _, _ = jax_run
    cfg = small_config(0)
    db = convert.database(jsys, "cpu")
    K = torch.tensor(cfg.camera.K, dtype=torch.float32)
    rng = jax.random.PRNGKey(0)
    accepted = 0
    for i in range(1, NUM_FRAMES):
        rng, key = jax.random.split(rng)
        rows_i = (jsys._db_signed[i], jsys._db_valid[i], jsys._db_xy[i])
        rows_j = (jsys._db_signed[i - 1], jsys._db_valid[i - 1],
                  jsys._db_xy[i - 1])
        if i >= cfg.loop.min_loop_gap:
            rng, _ = jax.random.split(rng)
        pose = jsys.frames[i].pose
        if np.allclose(pose, np.eye(4)):
            continue
        accepted += 1
        _, R_rec, _, _, _, _ = jlc._pair_geometry(
            *rows_i, *rows_j, jsys.K, key, scale=2.0, cfg=cfg.ransac,
            radius=jsys._radius, tau=jsys._tau)
        np.testing.assert_allclose(np.asarray(R_rec), pose[:3, :3], atol=1e-6)
        idx, ref = _jax_ransac(rows_i, rows_j, jsys.K, key, cfg.ransac,
                               jsys._radius, jsys._tau)
        assert bool(ref.ok)
        count, R, _, ok, _, _ = tlc._pair_geometry(
            *db.row(i), *db.row(i - 1), K, port_config(cfg).ransac, 2.0,
            jsys._radius, jsys._tau, idx=torch.tensor(np.asarray(idx)))
        assert bool(ok) and int(count) >= 8
        assert np.abs(R.numpy() - np.asarray(ref.R)).max() < 1e-3
    assert accepted >= NUM_FRAMES - 2


def test_detect_loops_on_converted_database(jax_run):
    """The JAX system's frame database, converted, scanned by the port:
    JAX's loops of the last frame."""
    jsys, _, jloops = jax_run
    tsys = port_system()
    tsys.db = convert.database(jsys, "cpu")
    tsys._frame_ids = list(jsys._frame_ids)
    got = tsys.detect_loops(NUM_FRAMES - 1)
    assert got and as_tuples(got) == as_tuples(jloops[-1])


def test_process_video_fills_database(orbit_frames, tmp_path):
    """process_video mirrors its features into the database and the frame
    list: a later detect_loops gives the loops process_video found for that
    frame, and save_results counts the frames."""
    tsys = port_system()
    video = tsys.process_video(orbit_frames)
    last = [c for c in video if c.current_frame_id == NUM_FRAMES - 1]
    assert last and as_tuples(tsys.detect_loops(NUM_FRAMES - 1)) == \
        as_tuples(last)
    assert len(tsys.get_frames()) == NUM_FRAMES
    assert len(tsys.get_frames()[-1].points3d) > 10  # re-triangulated
    text = tsys.save_results(tmp_path).read_text()
    assert f"Total frames processed: {NUM_FRAMES}" in text


def test_redo_on_first_hit_disagreement(orbit_frames, monkeypatch):
    """A device first hit that disagrees with the host's (forced here) makes
    process_frame redo the re-triangulation against the host's first hit,
    with one more readback; the loops do not change."""
    ref = port_system()
    ref_loops = [ref.process_frame(f) for f in orbit_frames[:22]]
    reads = []
    real = tlc._readback
    monkeypatch.setattr(tlc, "_first_hit", lambda counts, sims, t, m: (
        torch.tensor(3), torch.tensor(True)))
    monkeypatch.setattr(tlc, "_readback",
                        lambda pending: reads.append(set(pending)) or
                        real(pending))
    sys_ = port_system()
    loops = [sys_.process_frame(f) for f in orbit_frames[:22]]
    assert [as_tuples(x) for x in loops] == [as_tuples(x) for x in ref_loops]
    assert len(reads) == 22 + 2                # frames 20 and 21 redo
    assert reads.count({"g"}) == 2
    assert len(sys_.get_frames()[20].points3d) > 10


def test_max_frames_exceeded_raises(orbit_frames):
    sys_ = port_system(max_frames=2)
    sys_.process_frame(orbit_frames[0])
    sys_.process_frame(orbit_frames[1])
    with pytest.raises(ValueError):
        sys_.process_frame(orbit_frames[2])


def test_single_stage_api(orbit_frames):
    """detect_features, match_features, estimate_pose and
    triangulate_points on two consecutive frames."""
    sys_ = port_system()
    f0 = sys_.detect_features(orbit_frames[0])
    f1 = sys_.detect_features(orbit_frames[1])
    assert f0.descriptors.shape == (300, 8) and f0.keypoints.xy.shape == (300, 2)
    m = sys_.match_features(f1, f0)
    assert int(m.count) > 50
    R, t, ok = sys_.estimate_pose(f1, f0, m)
    assert ok
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-4)
    assert abs(float(torch.linalg.norm(t)) - 1.0) < 1e-4
    assert len(sys_.triangulate_points(f1, f0, m, R, t)) > 10
