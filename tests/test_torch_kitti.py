"""The port's KITTI adapter (a numpy copy) against the JAX package's on
synthetic poses: file round trip, ground-truth loop pairs, and the
tolerance-windowed recall and precision. Exact equality."""

import numpy as np
import pytest

from slam_loop_closing_tpu.utils import kitti as jkitti
from slam_loop_closing_tpu_torch.utils import kitti as tkitti


def _square_loop_poses(n_side=30, step=1.0):
    """Cam-to-world poses tracing a closed square: the last frames return to
    within a meter of the first ones."""
    poses = []
    pos = np.zeros(3)
    dirs = [np.array([1.0, 0, 0]), np.array([0, 0, 1.0]),
            np.array([-1.0, 0, 0]), np.array([0, 0, -1.0])]
    for leg in range(4):
        for _ in range(n_side):
            P = np.eye(3, 4)
            P[:, 3] = pos
            poses.append(P)
            pos = pos + dirs[leg] * step
    return np.stack(poses)


def test_gt_loop_pairs_from_synthetic_poses(tmp_path):
    poses = _square_loop_poses()
    (tmp_path / "poses").mkdir()
    np.savetxt(tmp_path / "poses" / "00.txt", poses.reshape(len(poses), 12))
    loaded = tkitti.load_gt_poses(tmp_path, "00")
    np.testing.assert_array_equal(loaded, jkitti.load_gt_poses(tmp_path, "00"))
    np.testing.assert_allclose(loaded, poses)
    assert tkitti.load_gt_poses(tmp_path, "01") is None
    pairs = tkitti.gt_loop_pairs(loaded, dist_thresh=2.0, min_gap=100)
    assert pairs == jkitti.gt_loop_pairs(loaded, dist_thresh=2.0, min_gap=100)
    assert pairs, "square loop must close"
    for i, j in pairs:
        assert i - j >= 100
        assert i >= 110 and j <= 10


def test_layout_and_intrinsics(tmp_path):
    assert not tkitti.available(tmp_path)
    with pytest.raises(FileNotFoundError):
        tkitti.frame_paths(tmp_path)
    seq = tmp_path / "sequences" / "00"
    (seq / "image_0").mkdir(parents=True)
    for i in (2, 0, 1):
        (seq / "image_0" / f"{i:06d}.png").write_bytes(b"")
    (seq / "calib.txt").write_text(
        "P0: 718.856 0 607.1928 0 0 718.856 185.2157 0 0 0 1 0\n"
        "P1: 718.856 0 607.1928 -386.1448 0 718.856 185.2157 0 0 0 1 0\n")
    assert tkitti.available(tmp_path) and jkitti.available(tmp_path)
    assert tkitti.frame_paths(tmp_path) == jkitti.frame_paths(tmp_path)
    assert [p.name for p in tkitti.frame_paths(tmp_path)] == [
        "000000.png", "000001.png", "000002.png"]
    K = tkitti.load_intrinsics(tmp_path)
    np.testing.assert_array_equal(K, jkitti.load_intrinsics(tmp_path))
    assert K[0, 0] == 718.856 and K[1, 2] == 185.2157


@pytest.mark.parametrize("pred,gt,tol", [
    ([(118, 0), (116, 4)], [(118, 0), (119, 1)], 5),
    ([(118, 0), (110, 9)], [(118, 0), (119, 1)], 0),
    ([(118, 0), (60, 9)], [(118, 0), (119, 1)], 5),
    ([], [(118, 0), (119, 1)], 5),
    ([(1, 2)], [], 5)])
def test_recall_and_precision_equal_jax(pred, gt, tol):
    assert tkitti.loop_recall(pred, gt, tol) == jkitti.loop_recall(pred, gt, tol)
    assert tkitti.loop_precision(pred, gt, tol) == \
        jkitti.loop_precision(pred, gt, tol)


def test_loop_recall_tolerance_window():
    gt = [(118, 0), (119, 1)]
    assert tkitti.loop_recall([(118, 0), (116, 4)], gt, tol=5) == 1.0
    assert tkitti.loop_recall([(118, 0), (110, 9)], gt, tol=0) == 0.5
    assert tkitti.loop_precision([(118, 0), (60, 9)], gt, tol=5) == 0.5
