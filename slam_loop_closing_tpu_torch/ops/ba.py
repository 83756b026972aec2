"""Alternating bundle adjustment: motion-only and structure-only Gauss-Newton
over all cameras / all points at once.

Port of :mod:`slam_loop_closing_tpu.ops.ba` (reference ``refineCameraPoseGN``
main.cpp:632-743, ``refinePointGN`` main.cpp:757-858,
``computeReprojectionError`` main.cpp:871-896,
``alternatingBundleAdjustment`` main.cpp:905-943). Each pass is one vmapped
forward-mode Jacobian over all observations (``torch.func``), a segment
sum assembling per-camera 6x6 (or per-point 3x3) normal equations, and one
batched solve: the 3x3 closed form of :func:`..epipolar._solve3x3`, the 6x6
through ``torch.linalg.solve_ex`` (no info readback). Iteration counts are
fixed and the LM acceptance is a per-camera / per-point select, so nothing
is read back.

Every float sum over observations is :func:`..cuda_kernels.segment_sums`
(kernel N on the card; a Gauss-Newton step's H and g in one launch) over a
plan of the camera or point index built once per :func:`_refine` call: a
camera's (point's) valid observations are added in ascending observation
order from zero, the order of a sequential ``index_add_`` on the CPU, so
the result has the same bits at every run on either device. Invalid
observations, whose terms are zeros, join no sum. The integer observation
counts stay ``index_add_`` (exact in any order).

``reduce`` (default the identity) is applied to every sum over observations — the
per-camera and per-point counts, errors and normal equations, and the mean
error's sum and count — before anything decides on it: the
observation-sharded BA of :mod:`..parallel.sharded` passes an all-reduce, so
every rank accepts and rejects the same steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_loop_closing_tpu_torch.config import BaConfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels, epipolar, lie


class Observations(NamedTuple):
    cam: torch.Tensor    # [O] int32 camera index
    point: torch.Tensor  # [O] int32 point index
    uv: torch.Tensor     # [O, 2] float32 pixel measurement
    valid: torch.Tensor  # [O] bool


def _project_params(K: torch.Tensor, cam_params: torch.Tensor,
                    X: torch.Tensor) -> torch.Tensor:
    """Projection as a smooth function of [..., 6] camera params (the
    function whose autodiff Jacobian replaces the reference's central
    differences, main.cpp:676-696)."""
    R, t = lie.params_to_pose(cam_params)
    Xc = (R @ X[..., None])[..., 0] + t
    z = Xc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    return torch.stack([K[0, 0] * Xc[..., 0] / z_safe + K[0, 2],
                        K[1, 1] * Xc[..., 1] / z_safe + K[1, 2]], dim=-1)


def _obs_residual(K, cam_params, X, uv):
    return _project_params(K, cam_params, X) - uv


def reprojection_errors(K: torch.Tensor, cam_params: torch.Tensor,
                        points: torch.Tensor, obs: Observations) -> torch.Tensor:
    """[O] pixel reprojection error per observation (0 where invalid)."""
    r = _obs_residual(K, cam_params[obs.cam.long()],
                      points[obs.point.long()], obs.uv)
    e = torch.sqrt(torch.sum(r * r, dim=-1))
    return torch.where(obs.valid, e, 0.0)


def _no_reduce(x: torch.Tensor) -> torch.Tensor:
    return x


def mean_reprojection_error(K, cam_params, points, obs: Observations,
                            reduce=_no_reduce) -> torch.Tensor:
    """Mean pixel error over valid observations (reference
    ``computeReprojectionError`` main.cpp:871-896, the figure printed
    before/after BA, main.cpp:1543-1555)."""
    e = reprojection_errors(K, cam_params, points, obs)
    n = torch.sum(obs.valid, dtype=torch.float32)
    total, n = reduce(torch.stack([torch.sum(e), n]))
    return total / torch.clamp_min(n, 1.0)


def _per_obs_jacobians(K, cam_params, points, obs: Observations, argnum: int):
    """[O, 2] residuals and [O, 2, d] Jacobians with respect to the observing
    camera (``argnum`` 1, d = 6) or the observed point (2, d = 3)."""
    cp = cam_params[obs.cam.long()]
    X = points[obs.point.long()]
    r = _obs_residual(K, cp, X, obs.uv)
    J = torch.func.vmap(torch.func.jacfwd(_obs_residual, argnums=argnum),
                        in_dims=(None, 0, 0, 0))(K, cp, X, obs.uv)
    r = torch.where(obs.valid[:, None], r, 0.0)
    # (a float64 tangent can arise under jacfwd, as in ..pgo)
    J = torch.where(obs.valid[:, None, None], J, 0.0).to(r.dtype)
    return r, J


def _solve_damped(H: torch.Tensor, g: torch.Tensor,
                  damping: float) -> torch.Tensor:
    """Batched solve of (H + damping I) delta = -g for [B, d, d] blocks with
    the reference's fixed LM damping (main.cpp:676, 800): 3x3 by the closed
    form, larger blocks by ``solve_ex``."""
    d = H.shape[-1]
    Hd = H + damping * torch.eye(d, dtype=H.dtype, device=H.device)
    if d == 3:
        return -epipolar._solve3x3(Hd, g)
    return -torch.linalg.solve_ex(Hd, g[..., None])[0][..., 0]


def _count(n: int, index: torch.Tensor, valid: torch.Tensor, reduce):
    """[n] valid observations of each camera (point)."""
    out = torch.zeros(n, dtype=torch.int32, device=valid.device)
    out.index_add_(0, index.long(), valid.to(torch.int32))
    return reduce(out)


def _refine(K, cam_params, points, obs: Observations, argnum: int,
            movable, iterations: int, damping: float, reduce):
    """Shared Gauss-Newton loop of :func:`refine_cameras` (``argnum`` 1)
    and :func:`refine_points` (2), with per-entity LM acceptance: a step is
    kept only where that camera's (point's) total squared error does not
    grow and stays finite (points behind a camera give exploding 1/z
    Jacobians that otherwise diverge to NaN)."""
    x0 = cam_params if argnum == 1 else points
    # an invalid observation adds exact zeros: it joins no segment (the
    # padding of a bucketed map would otherwise make one camera's and one
    # point's segment as long as the padding)
    group = obs.cam if argnum == 1 else obs.point
    plan = cuda_kernels.segment_plan(torch.where(obs.valid, group.long(), -1),
                                     x0.shape[0])

    def scatter(*values):
        return [reduce(s) for s in cuda_kernels.segment_sums(plan, *values)]

    def args(x):
        return (x, points) if argnum == 1 else (cam_params, x)

    def errs(x):
        return scatter(reprojection_errors(K, *args(x), obs) ** 2)[0]

    x, err_x = x0, errs(x0)
    for _ in range(iterations):
        r, J = _per_obs_jacobians(K, *args(x), obs, argnum)
        # H and g in one launch
        H, g = scatter(torch.einsum("oik,oil->okl", J, J),
                       torch.einsum("oik,oi->ok", J, r))
        delta = torch.where(movable[:, None], _solve_damped(H, g, damping),
                            0.0)
        cand = x + delta
        err_cand = errs(cand)
        better = (err_cand <= err_x) & torch.all(torch.isfinite(cand), dim=1)
        x = torch.where(better[:, None], cand, x)
        err_x = torch.where(better, err_cand, err_x)
    return x


def refine_cameras(K: torch.Tensor, cam_params: torch.Tensor,
                   points: torch.Tensor, obs: Observations,
                   fixed_mask: torch.Tensor | None = None,
                   iterations: int = 5, damping: float = 1e-3,
                   min_observations: int = 10,
                   reduce=_no_reduce) -> torch.Tensor:
    """Motion-only GN for all cameras at once (reference
    ``refineCameraPoseGN`` main.cpp:632-743). Cameras with fewer than
    ``min_observations`` valid observations stay (main.cpp:648);
    ``fixed_mask`` freezes more (camera 0 during BA)."""
    counts = _count(cam_params.shape[0], obs.cam, obs.valid, reduce)
    movable = counts >= min_observations
    if fixed_mask is not None:
        movable = movable & ~fixed_mask
    return _refine(K, cam_params, points, obs, 1, movable, iterations,
                   damping, reduce)


def refine_points(K: torch.Tensor, cam_params: torch.Tensor,
                  points: torch.Tensor, obs: Observations,
                  point_valid: torch.Tensor | None = None,
                  iterations: int = 5, damping: float = 1e-3,
                  min_observations: int = 2,
                  reduce=_no_reduce) -> torch.Tensor:
    """Structure-only GN for all points at once (reference
    ``refinePointGN`` main.cpp:757-858)."""
    counts = _count(points.shape[0], obs.point, obs.valid, reduce)
    movable = counts >= min_observations
    if point_valid is not None:
        movable = movable & point_valid
    return _refine(K, cam_params, points, obs, 2, movable, iterations,
                   damping, reduce)


def alternating_ba(K: torch.Tensor, cam_params: torch.Tensor,
                   points: torch.Tensor, obs: Observations,
                   point_valid: torch.Tensor | None = None,
                   cfg: BaConfig = BaConfig(),
                   outer_iterations: int | None = None,
                   reduce=_no_reduce):
    """Alternating BA (reference main.cpp:905-943): each outer iteration
    refines every camera (points fixed), then every point (cameras fixed).
    Camera 0 stays fixed as the gauge. Returns (cam_params, points,
    [outer] mean reprojection errors). ``obs`` may be a shard of the
    observations when ``reduce`` sums each partial sum over the shards (see
    the module's docstring)."""
    outer = cfg.outer_iterations if outer_iterations is None \
        else outer_iterations
    fixed = torch.arange(cam_params.shape[0], device=cam_params.device) == 0
    cp, pts, errs = cam_params, points, []
    for _ in range(outer):
        cp = refine_cameras(K, cp, pts, obs, fixed, cfg.camera_gn_iterations,
                            cfg.camera_damping, cfg.min_camera_observations,
                            reduce)
        pts = refine_points(K, cp, pts, obs, point_valid,
                            cfg.point_gn_iterations, cfg.point_damping,
                            cfg.min_point_observations, reduce)
        errs.append(mean_reprojection_error(K, cp, pts, obs, reduce))
    return cp, pts, torch.stack(errs)
