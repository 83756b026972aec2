"""The benchmark's plain reference against the port's plain path on the
CPU, at a small size: the same keypoints and descriptors bit for bit, the
same good-match counts and the same loop set. (On the card the benchmark
compares the port's kernels with this reference in every run.)"""

import dataclasses

import numpy as np
import pytest
import torch

from loopbench.reference import loops as ref_loops
from loopbench.reference import orb as ref_orb
from loopbench.traffic import render

from slam_loop_closing_tpu_torch.config import (CameraConfig, LoopConfig,
                                                OrbConfig, PipelineConfig)
from slam_loop_closing_tpu_torch.models.loop_closing import LoopClosingSystem
from slam_loop_closing_tpu_torch.ops import image, matching, orb

ORB = {"num_features": 300, "fast_threshold": 20, "num_levels": 4,
       "scale_factor": 1.2, "patch_size": 31, "descriptor_bits": 256,
       "nms_radius": 1, "pattern_seed": 17, "brief_bins": 30, "border": 19,
       "grid_cell": 8}
LOOP = {"loop_threshold": 0.15, "min_loop_gap": 12, "frame_skip": 3,
        "min_matches": 50}


def traffic(frames=36, h=144, w=192, glyphs=1):
    return {"frames": frames, "height": h, "width": w, "pool": 1,
            "orbit_radius": 8.0, "wall_radius": 16.0, "wall_height": 32.0,
            "focal_frac": 0.8, "deg_per_frame": 12.0,
            "height_knots": [[0.0, 0.0], [1.0, 0.0]],
            "texture": {"wavelengths": {"s": 0.6, "d": 0.25, "c": 1.0},
                        "mix": {"base": 0.3, "smooth_gain": 0.3,
                                "smooth": {"s": 1},
                                "steps": [{"fine": "d", "coarse": "c",
                                           "offset": 0.3, "coarse_gain": 0.1,
                                           "gain": 0.4}]}},
            "overlay": {"glyphs": glyphs, "glyph": 12, "gap": 16, "x": 24,
                        "y": 90, "ground": 0.08,
                        "tones": [[0.85, 0.85, 0.85, 0.85]]}}


@pytest.fixture(scope="module")
def frames():
    return render.render(traffic(), seed=2 ** 31 + 7, stream=0, device="cpu")


def test_renderer_is_seeded(frames):
    again = render.render(traffic(), seed=2 ** 31 + 7, stream=0,
                          device="cpu")
    other = render.render(traffic(), seed=2 ** 31 + 7, stream=1,
                          device="cpu")
    assert frames.dtype == torch.uint8 and frames.shape == (36, 144, 192)
    assert torch.equal(frames, again)
    assert not torch.equal(frames, other)
    # the burnt-in box is the same in every frame
    box = frames[:, 90:90 + 44, 24:24 + 44]
    assert torch.equal(box, box[:1].expand_as(box))


def test_front_end_equals_port(frames):
    xy, valid, packed = ref_orb.front_end(frames[:6], ORB)
    feats = orb.detect_and_describe_batch(image.ship_frames(frames[:6], "cpu"),
                                          OrbConfig(**ORB))
    assert torch.equal(xy, feats.keypoints.xy)
    assert torch.equal(valid, feats.keypoints.valid)
    assert torch.equal(packed, feats.descriptors)
    assert int(valid.sum()) > 1000


def test_bfloat16_front_end_differs(frames):
    """The control's front-end: one precision below the configuration's,
    it moves keypoints or bits."""
    ref = ref_orb.front_end(frames[:4], ORB)
    low = ref_orb.front_end(frames[:4], ORB, torch.bfloat16)
    assert any(not torch.equal(a, b) for a, b in zip(ref, low))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counts_equal_port(frames, dtype):
    xy, valid, packed = ref_orb.front_end(frames[:8], ORB)
    valid[3, ::3] = False          # invalid rows are masked, not read
    valid[5] = False               # a frame with no valid row counts 0
    got = ref_loops.band_counts(packed, valid, 1, dtype=dtype,
                                targets_per_pass=3)
    signed = torch.where(valid[..., None],
                         ref_orb.unpack_signed(packed), 0).to(torch.int8)
    want = matching.block_pair_counts_plain(signed, valid, signed, valid)
    band = np.tril(np.ones((8, 8), bool), -1)
    assert np.array_equal(got, np.where(band, want.numpy(), 0))
    assert got[band].max() > 20


def test_loop_set_equals_process_video(frames):
    cfg = dataclasses.replace(PipelineConfig(), camera=CameraConfig.assumed(),
                              orb=OrbConfig(**ORB), loop=LoopConfig(**LOOP))
    system = LoopClosingSystem(cfg, device="cpu", log=lambda *a: None)
    got = {(c.current_frame_id, c.matched_frame_id): (c.num_matches,
                                                      c.similarity_score)
           for c in system.process_video(frames)}
    xy, valid, packed = ref_orb.front_end(frames, ORB)
    counts = ref_loops.band_counts(packed, valid, LOOP["min_loop_gap"])
    sims = ref_loops.similarity(counts, valid.sum(1).numpy())
    want = {(int(i), int(j)): (int(counts[i, j]), sims[i, j]) for i, j in
            np.argwhere(ref_loops.loop_mask(counts, sims, LOOP))}
    assert got.keys() == want.keys() and got
    for key, (c, s) in got.items():
        assert c == want[key][0] and np.float32(s) == want[key][1]


def test_reference_imports_nothing_of_the_port():
    """The reference, its comparison and its control load neither the port
    nor JAX."""
    import subprocess
    import sys

    from loopbench.tests.tiny import REPO

    code = ("import sys; sys.path.insert(0, %r); "
            "from loopbench import spec; "
            "spec.load_module('checks', 'loop_detection'); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"jax", "jaxlib", "flax", "slam_loop_closing_tpu",
                         "slam_loop_closing_tpu_torch"}
