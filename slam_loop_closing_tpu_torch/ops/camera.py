"""Pinhole camera model: projection, 5-coefficient distortion and its
fixed-iteration inverse.

Port of :mod:`slam_loop_closing_tpu.ops.camera` (reference ``projectPoint``
main.cpp:149-165, ``computeSingleReprojError`` main.cpp:227-246 and the
``cv::undistort`` call sites main.cpp:1114,1145): keypoint coordinates are
undistorted, not whole images.

Every function takes leading batch axes (``[..., 3]`` points, ``[..., 2]``
pixels): the JAX package's vmapped ``*_batch`` names are these functions.
Poses are world->camera (R, t). Constant divisors are device tensors (a CUDA
division by a host scalar is a multiply by its reciprocal, ROADMAP R8).
"""

from __future__ import annotations

import torch

BEHIND_CAMERA_ERROR = 1e9  # reference main.cpp:238 returns 1e9 if z <= 0


def _apply(R: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return (R @ X[..., None])[..., 0]


def project(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
            X: torch.Tensor) -> torch.Tensor:
    """Pinhole projection K @ (R @ X + t) -> [..., 3] (u, v, z_cam)
    (reference main.cpp:149-165); callers gate on z_cam."""
    Xc = _apply(R, X) + t
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-12, 1e-12, z)
    u = K[0, 0] * Xc[..., 0] / z_safe + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / z_safe + K[1, 2]
    return torch.stack([u, v, z], dim=-1)


def reproj_error(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
                 X: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Pixel reprojection error, 1e9 behind the camera (main.cpp:227-246)."""
    uvz = project(K, R, t, X)
    d = uvz[..., :2] - obs
    err = torch.sqrt(torch.sum(d * d, dim=-1))
    return torch.where(uvz[..., 2] <= 0.0, BEHIND_CAMERA_ERROR, err)


def _distortion_terms(x, y, dist):
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return radial, dx, dy


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """The OpenCV 5-coefficient model (k1, k2, p1, p2, k3) applied to
    normalized camera coordinates ``[..., 2]``."""
    x, y = xy[..., 0], xy[..., 1]
    radial, dx, dy = _distortion_terms(x, y, dist)
    return torch.stack([x * radial + dx, y * radial + dy], dim=-1)


def undistort_normalized(xy_dist: torch.Tensor, dist: torch.Tensor,
                         iterations: int = 8) -> torch.Tensor:
    """Invert :func:`distort_normalized` with ``iterations`` fixed-point
    steps (OpenCV undistortPoints' compensation loop; the JAX package's
    ``fori_loop`` of the same count)."""
    one = torch.ones((), dtype=xy_dist.dtype, device=xy_dist.device)
    xy = xy_dist
    for _ in range(iterations):
        x, y = xy[..., 0], xy[..., 1]
        radial, dx, dy = _distortion_terms(x, y, dist)
        inv_radial = one / torch.where(torch.abs(radial) < 1e-8, 1e-8, radial)
        xy = torch.stack([(xy_dist[..., 0] - dx) * inv_radial,
                          (xy_dist[..., 1] - dy) * inv_radial], dim=-1)
    return xy


def pixel_to_normalized(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    return torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0],
                        (uv[..., 1] - K[1, 2]) / K[1, 1]], dim=-1)


def normalized_to_pixel(K: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    return torch.stack([K[0, 0] * xy[..., 0] + K[0, 2],
                        K[1, 1] * xy[..., 1] + K[1, 2]], dim=-1)


def undistort_points(K: torch.Tensor, dist: torch.Tensor,
                     uv: torch.Tensor) -> torch.Tensor:
    """Undistort pixel keypoints: pixel -> normalized -> fixed-point inverse
    -> pixel with the same K (reference main.cpp:1114,1145)."""
    return normalized_to_pixel(
        K, undistort_normalized(pixel_to_normalized(K, uv), dist))


def distort_points(K: torch.Tensor, dist: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """Forward distortion of ideal pixel coordinates."""
    return normalized_to_pixel(
        K, distort_normalized(pixel_to_normalized(K, uv), dist))
