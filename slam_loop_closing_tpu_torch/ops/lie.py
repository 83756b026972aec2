"""SO(3)/SE(3) operations: Rodrigues exp/log maps and pose parameterization.

Port of :mod:`slam_loop_closing_tpu.ops.lie` (reference main.cpp:120-146
``poseToParams``/``paramsToPose``, main.cpp:262-268 ``rotationError``).

Conventions (matching the reference):

* Poses are world->camera: ``x_cam = R @ X_world + t``.
* Pose params are 6-vectors ``[rvec; t]`` with ``R = exp(rvec)``.
* Relative edge: ``R_to = R_rel @ R_from``, ``t_to = R_rel @ t_from + t_rel``
  (reference main.cpp:78-86).

Every function takes any leading batch axes (``[..., 3]`` vectors,
``[..., 3, 3]`` matrices): the JAX package's vmapped ``*_batch`` names are
these functions. There is no data-dependent control flow: singularities
are handled by Taylor branches selected with ``torch.where`` on both the
value and its inputs, so ``torch.func.jacfwd`` (the PGO and BA Jacobians)
stays finite. Constant divisors are device tensors (a CUDA division by a
host scalar is a multiply by its reciprocal, ROADMAP R8).
"""

from __future__ import annotations

import math

import torch


def _c(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]_x of [..., 3] vectors."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def so3_exp(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle [..., 3] -> rotation [..., 3, 3].
    Smooth at theta = 0 through the second-order Taylor series of
    sin(t)/t and (1 - cos t)/t^2."""
    theta_sq = torch.sum(rvec * rvec, dim=-1)
    small = theta_sq < 1e-8
    # the untaken branch must stay finite under autodiff: a safe theta
    theta_sq_safe = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    a = torch.where(small, 1.0 - theta_sq / _c(6.0, rvec),
                    torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / _c(24.0, rvec),
                    (1.0 - torch.cos(theta)) / theta_sq_safe)
    W = hat(rvec)
    return (_eye(rvec) + a[..., None, None] * W
            + b[..., None, None] * (W @ W))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3] (inverse Rodrigues),
    with the JAX package's branches: Taylor near theta = 0, the largest
    diagonal of (R + I)/2 near theta = pi. Theta comes from
    ``atan2(sin, cos)``, never ``arccos``, whose derivative diverges at 0:
    with it the PGO Jacobians turn NaN at convergence."""
    trace = torch.clamp(R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], -1.0, 3.0)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5          # = sin(theta) * axis
    sin_sq = torch.sum(w * w, dim=-1)
    sin_theta = torch.sqrt(sin_sq + 1e-30)
    theta = torch.atan2(sin_theta, cos_theta)

    near_zero = (sin_sq < 1e-10) & (cos_theta > 0.0)
    near_pi = theta > math.pi - 1e-3
    # generic: rvec = theta / sin(theta) * w; near zero the Taylor series
    # theta / sin(theta) = 1 + sin^2 / 6 + O(sin^4)
    sin_safe = torch.where(near_zero, 1.0, sin_theta)
    factor = torch.where(near_zero, 1.0 + sin_sq / _c(6.0, R),
                         theta / sin_safe)
    rvec_generic = factor[..., None] * w

    # near pi: the axis from the largest diagonal of (R + I)/2 = a a^T
    A = (R + _eye(R)) * 0.5
    diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), 0.0, 1.0)
    k = torch.argmax(diag, dim=-1)
    col = torch.take_along_dim(A, k[..., None, None].expand(*k.shape, 3, 1),
                               dim=-1)[..., 0]          # A[:, k]
    dk = torch.take_along_dim(diag, k[..., None], dim=-1)[..., 0]
    axis_unnorm = col / torch.sqrt(torch.clamp_min(dk, 1e-12))[..., None]
    norm = torch.sqrt(torch.sum(axis_unnorm * axis_unnorm, dim=-1))
    axis = axis_unnorm / torch.clamp_min(norm, 1e-12)[..., None]
    # the sign that makes exp(theta * axis) match R (benign at exactly pi)
    sign = torch.where(torch.sum(axis * w, dim=-1) < 0.0, -1.0, 1.0)
    rvec_pi = theta[..., None] * axis * sign[..., None]
    return torch.where(near_pi[..., None], rvec_pi, rvec_generic)


def rotation_error(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle ||log(R1 @ R2^T)|| in radians (main.cpp:262-268)."""
    r = so3_log(R1 @ R2.transpose(-1, -2))
    return torch.sqrt(torch.sum(r * r, dim=-1))


def pose_to_params(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [..., 6] params [rvec; t] (main.cpp:120-132)."""
    return torch.cat([so3_log(R), t], dim=-1)


def params_to_pose(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., 6] params [rvec; t] -> (R, t) (main.cpp:136-146)."""
    return so3_exp(p[..., :3]), p[..., 3:]


def _apply(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (R @ v[..., None])[..., 0]


def compose(R_rel: torch.Tensor, t_rel: torch.Tensor, R_from: torch.Tensor,
            t_from: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Chain a relative pose onto an absolute one (main.cpp:1216-1219):
    ``R_to = R_rel @ R_from``, ``t_to = R_rel @ t_from + t_rel``."""
    return R_rel @ R_from, _apply(R_rel, t_from) + t_rel


def relative(R_from: torch.Tensor, t_from: torch.Tensor, R_to: torch.Tensor,
             t_to: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Relative pose such that ``compose(rel, from) == to``."""
    R_rel = R_to @ R_from.transpose(-1, -2)
    return R_rel, t_to - _apply(R_rel, t_from)


def invert(R: torch.Tensor, t: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of a world->camera pose."""
    Rt = R.transpose(-1, -2)
    return Rt, -_apply(Rt, t)


def camera_center(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera center in world coordinates: C = -R^T t (main.cpp:983)."""
    return -_apply(R.transpose(-1, -2), t)


def slerp_rvec(rvec: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Fractional rotation exp(alpha * log R) in axis-angle form, as
    ``simplePoseCorrection`` interpolates (main.cpp:451-492)."""
    return alpha * rvec
