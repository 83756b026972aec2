"""The port's batched Version-A slice against the JAX package on the CPU:
``process_video`` on the 32-frame orbit fixture of test_loop_closing.py
(loop set, counts, similarities) and on its multi-loop fixture (two true
revisits, a distractor pass), ``process_videos_batched`` on three
small videos, the loop report and its PNGs, the config and synthetic video
copies, the conversion of the JAX package's arrays, and the rule that
the port loads no JAX."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_loop_closing_tpu import config as jconfig
from slam_loop_closing_tpu.models.loop_closing import \
    LoopClosingSystem as JaxLoopClosingSystem
from slam_loop_closing_tpu.ops import matching as jmatch
from slam_loop_closing_tpu.ops import orb as jorb
from slam_loop_closing_tpu.utils import io as jio
from slam_loop_closing_tpu.utils import synth_video as jsynth
from slam_loop_closing_tpu_torch import config as tconfig
from slam_loop_closing_tpu_torch.models.loop_closing import LoopClosingSystem
from slam_loop_closing_tpu_torch.ops import matching as tmatch
from slam_loop_closing_tpu_torch.ops import orb as torb
from slam_loop_closing_tpu_torch.utils import convert
from slam_loop_closing_tpu_torch.utils import synth_video as tsynth
from slam_loop_closing_tpu_torch.utils.profiling import StageTimer, annotate

torch.set_num_threads(1)


def small_config(grid_cell: int) -> jconfig.PipelineConfig:
    """test_loop_closing.py's small_cfg, with plain (0) or grid top-K."""
    return dataclasses.replace(
        jconfig.PipelineConfig(),
        orb=jconfig.OrbConfig(num_features=300, num_levels=2,
                              grid_cell=grid_cell),
        loop=jconfig.LoopConfig(loop_threshold=0.15, min_loop_gap=20,
                                frame_skip=1),
        ransac=jconfig.RansacConfig(num_hypotheses=128))


def as_tuples(loops):
    return [(c.current_frame_id, c.matched_frame_id, c.num_matches,
             c.similarity_score) for c in loops]


@pytest.fixture(scope="module")
def orbit_frames():
    return jsynth.orbit_sequence(num_frames=32, h=144, w=192, num_points=250,
                                 seed=3)


@pytest.fixture(scope="module")
def slice_runs(orbit_frames):
    """Both packages' process_video per top-K mode: (JAX system, port
    system, JAX loops, port loops)."""
    out = {}
    for grid in (0, 8):
        cfg = small_config(grid)
        jsys = JaxLoopClosingSystem(cfg, max_frames=32)
        tsys = LoopClosingSystem(
            tconfig.PipelineConfig.from_json(cfg.to_json()), max_frames=32,
            device="cpu")
        out[grid] = (jsys, tsys, jsys.process_video(orbit_frames),
                     tsys.process_video(orbit_frames))
    return out


@pytest.mark.parametrize("grid", [0, 8])
def test_process_video_same_loops(slice_runs, grid):
    """The loop set, the candidate order, every loop's match count and its
    similarity are equal (tolerance 0: measured equal)."""
    _, _, ref, got = slice_runs[grid]
    assert ref, "no loops in the reference run"
    assert as_tuples(got) == as_tuples(ref)


ML_FRAMES, ML_GAP, ML_DY = 96, 16, 16.0   # test_loop_closing.py's fixture


@pytest.fixture(scope="module")
def multi_loop_runs():
    """The multi-loop fixture of test_loop_closing.py (96 x 240x320, 800
    points, seed 3, ORB-500, 2 levels, gap 16) through both packages'
    process_video, with the truth mask and the pair geometry."""
    frames, thetas, ys = tsynth.multi_loop_sequence(
        num_frames=ML_FRAMES, h=240, w=320, num_points=800, seed=3,
        distractor_dy=ML_DY)
    cfg = dataclasses.replace(
        jconfig.PipelineConfig(),
        orb=jconfig.OrbConfig(num_features=500, num_levels=2),
        loop=jconfig.LoopConfig(loop_threshold=0.15, min_loop_gap=ML_GAP,
                                frame_skip=1),
        ransac=jconfig.RansacConfig(num_hypotheses=256))
    jsys = JaxLoopClosingSystem(cfg, max_frames=ML_FRAMES)
    tsys = LoopClosingSystem(tconfig.PipelineConfig.from_json(cfg.to_json()),
                             max_frames=ML_FRAMES, device="cpu")
    ref, got = jsys.process_video(frames), tsys.process_video(frames)
    dth = np.abs(thetas[:, None] - thetas[None, :])
    dth = np.minimum(dth, 2 * np.pi - dth)
    return dict(jsys=jsys, tsys=tsys, ref=ref, got=got, dth=dth,
                dy=np.abs(ys[:, None] - ys[None, :]),
                gt=tsynth.ground_truth_loop_pairs(thetas, ys, ML_GAP))


def test_multi_loop_fixture_same_loops(multi_loop_runs):
    """On the fixture that does not saturate (loops AND non-loops inside the
    band): the loop set and the candidate order equal the JAX package's;
    match counts within 1 on at most 1% of the loops and equal elsewhere (a
    keypoint whose angle lies on a bin edge takes the other BRIEF bin, R2),
    the similarity with them (1 / 500 features)."""
    ref, got = multi_loop_runs["ref"], multi_loop_runs["got"]
    pairs = [(c.current_frame_id, c.matched_frame_id) for c in got]
    assert pairs == [(c.current_frame_id, c.matched_frame_id) for c in ref]
    band = sum(max(0, q - ML_GAP + 1) for q in range(ML_FRAMES))
    assert 100 < len(pairs) < band - 100
    dn = np.array([g.num_matches - r.num_matches for g, r in zip(got, ref)])
    assert np.abs(dn).max() <= 1 and np.mean(dn != 0) <= 0.01
    ds = np.array([g.similarity_score - r.similarity_score
                   for g, r in zip(got, ref)])
    assert np.abs(ds).max() <= 1 / 500 + 1e-6
    assert np.all(ds[dn == 0] == 0)


def test_multi_loop_counts_on_the_jax_store_bitwise(multi_loop_runs):
    """The JAX package's own descriptor store of the fixture through the
    port's band counts: its count matrix, bitwise, with zero and non-zero
    entries below and above the loop rule inside the band."""
    jsys = multi_loop_runs["jsys"]
    signed = np.array(jsys._db_signed)[:ML_FRAMES]
    valid = np.array(jsys._db_valid)[:ML_FRAMES]
    ref = np.asarray(jmatch.banded_pair_counts(
        jnp.asarray(signed), jnp.asarray(valid), ML_GAP))
    got = tmatch.banded_pair_counts(torch.from_numpy(signed),
                                    torch.from_numpy(valid), ML_GAP).numpy()
    np.testing.assert_array_equal(got, ref)
    band = np.tril(np.ones_like(ref, bool), -ML_GAP)
    assert (ref[band] < 50).sum() > 100 and (ref[band] > 150).sum() > 100


def test_multi_loop_truth(multi_loop_runs):
    """Against the ground truth: every true revisit pair is a loop; the
    raw similarity rule also fires on the distractor pass (the same angles
    at a fully separated height: hard negatives, as in the JAX package),
    and the geometric verification of the Version-B loop search
    (``sfm._verify_loop_scores``, the port's own draws) accepts every true
    pair and none of the hard negatives."""
    from slam_loop_closing_tpu_torch.models import sfm

    tsys, got = multi_loop_runs["tsys"], multi_loop_runs["got"]
    dth, dy, gt = (multi_loop_runs[k] for k in ("dth", "dy", "gt"))
    pred = {(c.current_frame_id, c.matched_frame_id) for c in got}
    true_pairs = set(zip(*(v.tolist() for v in np.nonzero(gt))))
    hard = {p for p in pred if dy[p] >= ML_DY - 2.0 and dth[p] < 0.2}
    assert len(true_pairs) >= 10 and true_pairs <= pred
    assert len(hard) >= 10

    sel = sorted(true_pairs | hard)
    padded = sel + [sel[0]] * ((-len(sel)) % sfm.VERIFY_CHUNK)
    cq, ct = torch.tensor(padded, dtype=torch.int32).T
    cam = tsys.config.camera
    norm = ((tsys.db.xy[:ML_FRAMES] - torch.tensor([cam.cx, cam.cy]))
            / torch.tensor([cam.fx, cam.fy])).to(torch.float32)
    scores, _ = sfm._verify_loop_scores(
        tsys.db.packed[:ML_FRAMES], tsys.db.valid[:ML_FRAMES], norm, cq, ct,
        torch.Generator().manual_seed(11),
        torch.tensor((cam.fx + cam.fy) * 0.5, dtype=torch.float32),
        tsys._radius, tsys._tau, 0.7, tsys.config.ransac)
    verified = {p for p, s in zip(sel, scores.tolist())
                if s[1] >= 25 and s[2] >= 15}
    assert true_pairs <= verified
    assert not verified & hard


def test_annotate_names_a_profiler_range():
    """``annotate`` (the JAX package's TraceAnnotation): a context manager
    whose block shows under its name in a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("loop-scan"):
            torch.ones(8).sum()
    assert "loop-scan" in {e.key for e in prof.key_averages()}


def test_process_video_uint8_frames_and_ids(orbit_frames):
    """uint8 frames ship as the JAX package ships them; frame ids map
    through."""
    u8 = (np.clip(orbit_frames, 0, 1) * 255).astype(np.uint8)
    ids = [100 + i for i in range(32)]
    cfg = small_config(8)
    ref = JaxLoopClosingSystem(cfg, max_frames=32).process_video(u8, ids)
    got = LoopClosingSystem(tconfig.PipelineConfig.from_json(cfg.to_json()),
                            max_frames=32, device="cpu").process_video(u8, ids)
    assert as_tuples(got) == as_tuples(ref)
    with pytest.raises(ValueError):
        LoopClosingSystem(tconfig.PipelineConfig.from_json(cfg.to_json()),
                          max_frames=8, device="cpu").process_video(u8)


def test_save_results_same_report(slice_runs, tmp_path):
    jsys, tsys, _, _ = slice_runs[0]
    ref = jio.format_loop_closures(
        [{"current": c.current_frame_id, "matched": c.matched_frame_id,
          "num_matches": c.num_matches, "similarity": c.similarity_score}
         for c in jsys.get_loop_closures()], total_frames=len(jsys.frames))
    path = tsys.save_results(tmp_path / "out")
    assert path.name == "loop_closures.txt"
    assert path.read_text().splitlines() == ref.splitlines()
    assert len(tsys.get_loop_closures()) == len(jsys.get_loop_closures())


def test_process_videos_batched_equals_jax_and_per_video():
    """Three 20-frame videos (frames not a multiple of the tile block):
    loop ids and counts exact, similarity to 1e-6, against the JAX package
    and against the port's process_video on each video alone."""
    cfg = dataclasses.replace(
        small_config(8),
        loop=jconfig.LoopConfig(loop_threshold=0.15, min_loop_gap=12,
                                frame_skip=1))
    tcfg = tconfig.PipelineConfig.from_json(cfg.to_json())
    videos = np.stack([jsynth.orbit_sequence(num_frames=20, h=144, w=192,
                                             num_points=250, seed=s)
                       for s in (3, 4, 5)])
    ref = JaxLoopClosingSystem.process_videos_batched(videos, cfg)
    got = LoopClosingSystem.process_videos_batched(videos, tcfg, device="cpu")
    assert len(got) == 3 and all(ref)
    for v in range(3):
        assert [t[:3] for t in as_tuples(got[v])] == \
            [t[:3] for t in as_tuples(ref[v])]
        np.testing.assert_allclose([c.similarity_score for c in got[v]],
                                   [c.similarity_score for c in ref[v]],
                                   rtol=0, atol=1e-6)
        alone = LoopClosingSystem(tcfg, max_frames=20, device="cpu"
                                  ).process_video(videos[v])
        assert as_tuples(got[v]) == as_tuples(alone)
    # at or below the gap there is nothing to scan
    assert LoopClosingSystem.process_videos_batched(
        videos[:, :12], tcfg, device="cpu") == [[], [], []]


def test_save_results_same_png_names(slice_runs, tmp_path):
    """loop_X_Y.png per loop and matches_X_Y.png every viz_every-th frame:
    the file names of the JAX package, each a decodable RGB image two
    frames wide; match_viz=False leaves the matches_ files out."""
    from PIL import Image

    jsys, tsys, _, _ = slice_runs[8]
    jsys.save_results(tmp_path / "jax")
    tsys.save_results(tmp_path / "torch")
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert any(n.startswith("loop_") for n in names)
    assert any(n.startswith("matches_") for n in names)
    for n in names:
        if n.endswith(".png"):
            img = Image.open(tmp_path / "torch" / n)
            assert img.mode == "RGB" and img.size == (2 * 192, 144)
    ref = np.asarray(Image.open(tmp_path / "jax" / names[1]), np.int16)
    got = np.asarray(Image.open(tmp_path / "torch" / names[1]), np.int16)
    assert np.mean(np.abs(got - ref) > 0) < 0.01
    tsys.save_results(tmp_path / "noviz", match_viz=False)
    assert sorted(p.name for p in (tmp_path / "noviz").iterdir()) == \
        [n for n in names if not n.startswith("matches_")]


def test_config_json_and_orbit_copies():
    assert tconfig.PipelineConfig().to_json() == \
        jconfig.PipelineConfig().to_json()
    cfg = small_config(8)
    assert tconfig.PipelineConfig.from_json(cfg.to_json()).to_json() == \
        cfg.to_json()
    for kw in [dict(num_frames=3, h=40, w=56, num_points=250, seed=3),
               dict(num_frames=2, h=30, w=44, seed=1, revisit=False)]:
        np.testing.assert_array_equal(tsynth.orbit_sequence(**kw),
                                      jsynth.orbit_sequence(**kw))


def test_convert_feeds_jax_features_to_port_matcher(orbit_frames):
    """JAX's front-end output, converted, through the port's band counts:
    bitwise the JAX band counts of the same features (so matching is
    tested apart from front-end agreement)."""
    cfg = jconfig.OrbConfig(num_features=200, num_levels=2)
    frames = orbit_frames[::2]
    jf = jax.tree.map(np.asarray, jorb.detect_and_describe_batch(
        jnp.asarray(frames), cfg))
    tf = convert.orb_features(jf, "cpu")
    np.testing.assert_array_equal(tf.signed.numpy(), jf.signed)
    np.testing.assert_array_equal(tf.keypoints.valid.numpy(),
                                  jf.keypoints.valid)
    np.testing.assert_array_equal(tf.descriptors.numpy().view(np.uint32),
                                  jf.descriptors)
    ref = np.asarray(jmatch.banded_pair_counts(
        jnp.asarray(jf.signed), jnp.asarray(jf.keypoints.valid), 5))
    got = tmatch.banded_pair_counts(tf.signed, tf.keypoints.valid, 5).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.max() > 0
    D = convert.brief_matrices(jorb.brief_matrices(cfg), "cpu")
    np.testing.assert_array_equal(
        D.numpy(), torb.brief_matrices(tconfig.OrbConfig(), "cpu").numpy())
    mw = convert.moment_weights(jorb._orientation_moment_weights(), "cpu")
    np.testing.assert_array_equal(mw.numpy(),
                                  torb._orientation_moment_weights())


def test_stage_timer_sums_stages():
    timer = StageTimer("cpu")
    for _ in range(2):
        with timer.stage("a"):
            pass
    with timer.stage("b"):
        pass
    assert set(timer.stages) == {"a", "b"}
    assert timer.frames_per_sec(10) == 10 / sum(timer.stages.values())


def test_stage_timer_stage_rate_and_summary_equal_jax(tmp_path):
    """One stage's rate, the summary block in the JAX package's words, and
    a trace file around a block."""
    from slam_loop_closing_tpu.utils import profiling as jprof
    from slam_loop_closing_tpu_torch.utils import profiling as tprof

    timer, ref = StageTimer("cpu"), jprof.StageTimer()
    timer.stages = {"loop_detection": 2.0, "save_results": 0.5}
    ref.stages = dict(timer.stages)
    assert timer.frames_per_sec(10, "loop_detection") == 5.0
    assert timer.frames_per_sec(10, "missing") == float("inf")
    assert timer.frames_per_sec(10) == ref.frames_per_sec(10) == 4.0
    assert timer.summary() == ref.summary()
    with tprof.trace(None):
        pass
    with tprof.trace(tmp_path / "t"):
        torch.ones(4).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0


def test_port_imports_no_jax():
    """Importing the slice loads no jax module (the test process itself
    has jax loaded, hence the subprocess)."""
    code = ("import sys, slam_loop_closing_tpu_torch.models.loop_closing, "
            "slam_loop_closing_tpu_torch.ops.cuda_kernels, "
            "slam_loop_closing_tpu_torch.ops.epipolar, "
            "slam_loop_closing_tpu_torch.ops.ransac, "
            "slam_loop_closing_tpu_torch.utils.convert, "
            "slam_loop_closing_tpu_torch.utils.profiling, "
            "slam_loop_closing_tpu_torch.models.sfm, "
            "slam_loop_closing_tpu_torch.ops.ba, "
            "slam_loop_closing_tpu_torch.ops.camera, "
            "slam_loop_closing_tpu_torch.ops.lie, "
            "slam_loop_closing_tpu_torch.ops.outliers, "
            "slam_loop_closing_tpu_torch.ops.pgo, "
            "slam_loop_closing_tpu_torch.ops.triangulation, "
            "slam_loop_closing_tpu_torch.utils.checkpoint, "
            "slam_loop_closing_tpu_torch.utils.io, "
            "slam_loop_closing_tpu_torch.utils.logging, "
            "slam_loop_closing_tpu_torch.utils.kitti, "
            "slam_loop_closing_tpu_torch.utils.synth_video, "
            "slam_loop_closing_tpu_torch.models.calibration, "
            "slam_loop_closing_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('slam_loop_closing_tpu.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
