"""The ORB front-end's bits do not depend on how many frames (or
keypoints) one call holds: the pyramid (kernel J's plain version) and the
orientation moments (kernel M's plain version) sum in a fixed order. On the
CPU, at small sizes; the card's form of the same gate is
``tests/test_torch_cuda_kernels.py::test_front_end_batch_invariant_on_card``.
"""

import numpy as np
import pytest
import torch

from slam_loop_closing_tpu_torch.config import OrbConfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck
from slam_loop_closing_tpu_torch.ops import image as image_ops
from slam_loop_closing_tpu_torch.ops import orb
from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence

torch.set_num_threads(1)


def _frames(h, w):
    """Three orbit frames of ``h`` x ``w`` (rendered landscape, transposed
    for a portrait shape)."""
    if h > w:
        return np.ascontiguousarray(
            orbit_sequence(num_frames=3, h=w, w=h, num_points=250,
                           seed=3).transpose(0, 2, 1))
    return orbit_sequence(num_frames=3, h=h, w=w, num_points=250, seed=3)


def _outputs(feats, levels):
    kp = feats.keypoints
    return [*levels, kp.xy, kp.valid, kp.response, kp.octave, kp.angle,
            feats.descriptors]


@pytest.mark.parametrize("grid", [0, 8])
@pytest.mark.parametrize("h,w", [(144, 192), (192, 144)])
def test_front_end_batch_1_equals_batch_3(h, w, grid):
    """Tolerance 0: pyramid levels, keypoints, angles and packed descriptors
    of three frames in one call against one call a frame."""
    frames = torch.from_numpy(_frames(h, w))
    cfg = OrbConfig(num_features=300, num_levels=3, grid_cell=grid)
    whole = _outputs(orb.detect_and_describe_batch(frames, cfg),
                     image_ops.pyramid(frames, cfg.num_levels,
                                       cfg.scale_factor))
    parts = [_outputs(orb.detect_and_describe_batch(frames[i:i + 1], cfg),
                      image_ops.pyramid(frames[i:i + 1], cfg.num_levels,
                                        cfg.scale_factor))
             for i in range(3)]
    for k, got in enumerate(whole):
        assert torch.equal(got, torch.cat([p[k] for p in parts])), k
    assert bool(whole[-5].any())


@pytest.mark.parametrize("rows", [1, 7, 300])
def test_moment_sums_do_not_depend_on_the_pass(rng, rows, monkeypatch):
    """Kernel M's plain version over 1,000 patches, ``rows`` patches a pass,
    against one pass: bitwise."""
    patches = torch.from_numpy(rng.random((1000, 32, 32)).astype(np.float32))
    mw = torch.from_numpy(orb._orientation_moment_weights())
    ref = ck.moment_sums_plain(patches, mw)
    monkeypatch.setattr(ck, "_MOMENT_ROWS_PER_PASS", rows)
    assert torch.equal(ck.moment_sums_plain(patches, mw), ref)
    assert torch.equal(ck.moment_sums_plain(patches[:rows], mw), ref[:rows])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pyramid_level_frame_by_frame(rng, dtype):
    """Kernel J's plain version on four frames at once and one at a time,
    from float32 frames and from a bfloat16 level: bitwise."""
    x = torch.from_numpy((rng.integers(0, 256, (4, 90, 120)) / 255.0)
                         .astype(np.float32)).to(dtype)
    whole = ck.pyramid_level(x, 75, 100)
    for i in range(4):
        one = ck.pyramid_level(x[i:i + 1], 75, 100)
        assert all(torch.equal(a[i:i + 1], b) for a, b in zip(whole, one))
