"""The port's batched Version-A slice against the JAX package on the CPU:
``process_video`` on the 32-frame orbit fixture of test_loop_closing.py
(loop set, counts, similarities), the loop report, the config and synthetic
video copies, the conversion of the JAX package's arrays, and the rule that
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
from slam_loop_closing_tpu_torch.utils.profiling import StageTimer

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


def test_port_imports_no_jax():
    """Importing the slice loads no jax module (the test process itself
    has jax loaded, hence the subprocess)."""
    code = ("import sys, slam_loop_closing_tpu_torch.models.loop_closing, "
            "slam_loop_closing_tpu_torch.ops.cuda_kernels, "
            "slam_loop_closing_tpu_torch.ops.epipolar, "
            "slam_loop_closing_tpu_torch.ops.ransac, "
            "slam_loop_closing_tpu_torch.utils.convert, "
            "slam_loop_closing_tpu_torch.utils.profiling; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('slam_loop_closing_tpu.')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
