"""Pose-graph optimization: Gauss-Newton / Levenberg-Marquardt with autodiff
Jacobians, and the linear drift-spread correction.

Port of :mod:`slam_loop_closing_tpu.ops.pgo` (reference ``optimizePoseGraph``
main.cpp:282-445, ``simplePoseCorrection`` main.cpp:451-492):

* per-edge Jacobian blocks from one ``torch.func.vmap`` of
  ``torch.func.jacfwd`` of :func:`edge_residual` (the JAX package's vmapped
  ``jax.jacfwd``);
* normal equations assembled by segment sums of [6, 6] blocks;
* up to ``cfg.dense_solver_max_poses`` poses a dense Cholesky solve
  (``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``: the plain
  ``cholesky`` reads cuSOLVER's info back to the host on every call), above
  it matrix-free block-Jacobi preconditioned CG (``torch.linalg.inv_ex``).

Residual per edge (main.cpp:334-359): ``r = sqrt(w) * [log(R_pred^T R_to);
t_to - (R_rel t_from + t_rel)]`` with ``R_pred = R_rel R_from``. Pose 0 is
the gauge: its update is projected to zero. The iteration count is fixed;
convergence (max |delta| < tol) freezes the parameters on the device, so the
loop reads nothing back.

Every float sum over edges into poses (or pose pairs) is
:func:`..cuda_kernels.segment_sums` (kernel N on the card) over a plan built
once per :func:`optimize_pose_graph` call. Where the JAX package adds the
from-edges' terms and then the to-edges', the port sums the two lists as
one (the kernel reads both in place), so a pose's terms come in that
order: from-edges, then to-edges, each in ascending edge order (a
sequential ``index_add_`` on the CPU). The result has the same bits at every run on either device. A
masked edge, whose terms are zeros, joins no sum.

``reduce`` (default the identity) is applied to every sum over edges — the cost, the
gradient, the Hessian's blocks and each CG iteration's Hessian-vector
product — before anything decides on it: the edge-sharded PGO of
:mod:`..parallel.sharded` passes an all-reduce, so every rank assembles the
whole graph's normal equations from its shard and takes the same steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from slam_loop_closing_tpu_torch.config import PgoConfig
from slam_loop_closing_tpu_torch.ops import cuda_kernels, lie


class PoseGraph(NamedTuple):
    """Edge list as SoA tensors (fixed capacity; pad with mask=False)."""

    e_from: torch.Tensor   # [E] int64
    e_to: torch.Tensor     # [E] int64
    R_rel: torch.Tensor    # [E, 3, 3]
    t_rel: torch.Tensor    # [E, 3]
    weight: torch.Tensor   # [E] float32 (reference: 1 sequential, 10 loop)
    mask: torch.Tensor     # [E] bool


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` by a device scalar (true division on the card too, R8)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def edge_residual(p_from: torch.Tensor, p_to: torch.Tensor,
                  R_rel: torch.Tensor, t_rel: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """[..., 6] residuals of edges given [..., 6] pose params (reference
    main.cpp:334-359)."""
    R_from, t_from = lie.params_to_pose(p_from)
    R_to, t_to = lie.params_to_pose(p_to)
    R_pred = R_rel @ R_from
    r_rot = lie.so3_log(R_pred.transpose(-1, -2) @ R_to)
    r_t = t_to - ((R_rel @ t_from[..., None])[..., 0] + t_rel)
    return torch.sqrt(weight)[..., None] * torch.cat([r_rot, r_t], dim=-1)


def residuals(params: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """[E, 6] stacked residuals (masked edges 0)."""
    r = edge_residual(params[g.e_from], params[g.e_to], g.R_rel, g.t_rel,
                      g.weight)
    return torch.where(g.mask[:, None], r, 0.0)


def _no_reduce(x: torch.Tensor) -> torch.Tensor:
    return x


def total_cost(params: torch.Tensor, g: PoseGraph,
               reduce=_no_reduce) -> torch.Tensor:
    """Sum of squared residuals (printed every 5 iterations by the
    reference, main.cpp:432-435)."""
    return reduce(torch.sum(residuals(params, g) ** 2))


def _edge_jacobians(params: torch.Tensor, g: PoseGraph):
    """Per-edge Jacobian blocks J_from, J_to, each [E, 6, 6], by one vmapped
    forward-mode autodiff of :func:`edge_residual`. (Under ``jacfwd`` a
    0-d float32 value combined with a Python float carries a float64
    tangent, so the blocks are cast back to the parameters' dtype.)"""
    Jf, Jt = torch.func.vmap(torch.func.jacfwd(edge_residual, argnums=(0, 1)))(
        params[g.e_from], params[g.e_to], g.R_rel, g.t_rel, g.weight)
    m = g.mask[:, None, None]
    return (torch.where(m, Jf, 0.0).to(params.dtype),
            torch.where(m, Jt, 0.0).to(params.dtype))


class _Plans(NamedTuple):
    """The segment plans of one graph: ``edges`` sends the from-edges' and
    then the to-edges' rows to their poses (a sum over it is a pair, the
    from-edges' terms and the to-edges', read as one list of rows);
    ``blocks`` (dense solver only)
    sends the ff, tt, ft and tf blocks' rows to block (a, b) at row
    ``a * n + b`` of the [N * N, 6, 6] Hessian."""

    edges: cuda_kernels.SegmentPlan
    blocks: cuda_kernels.SegmentPlan | None


def _plans(g: PoseGraph, n: int, dense: bool) -> _Plans:
    # a masked edge adds exact zeros: both its ends become -1, so it joins
    # no segment (each of its block rows a * n + b is negative too)
    ef = torch.where(g.mask, g.e_from.long(), -1)
    et = torch.where(g.mask, g.e_to.long(), -1)
    blocks = None
    if dense:
        blocks = cuda_kernels.segment_plan(
            torch.cat([ef * n + ef, et * n + et, ef * n + et, et * n + ef]),
            n * n)
    return _Plans(cuda_kernels.segment_plan(torch.cat([ef, et]), n), blocks)


def _gradient_terms(Jf, Jt, r):
    """The edges' terms of g_i = sum_e J_e,i^T r_e, [N, 6]."""
    return (torch.einsum("eij,ei->ej", Jf, r),
            torch.einsum("eij,ei->ej", Jt, r))


def _diag_terms(Jf, Jt):
    """The edges' terms of the [N, 6, 6] diagonal blocks of H."""
    return (torch.einsum("eij,eik->ejk", Jf, Jf),
            torch.einsum("eij,eik->ejk", Jt, Jt))


def _dense_step(params: torch.Tensor, g: PoseGraph, plans: _Plans,
                damping: float, reduce):
    """One LM step through the dense normal equations and a Cholesky solve
    (small N)."""
    n = params.shape[0]
    r = residuals(params, g)
    Jf, Jt = _edge_jacobians(params, g)
    grad = reduce(cuda_kernels.segment_sums(
        plans.edges, _gradient_terms(Jf, Jt, r))[0])
    Hft = torch.einsum("eij,eik->ejk", Jf, Jt)
    # H as [N * N, 6, 6] blocks, block (a, b) at row a * n + b
    blocks = reduce(cuda_kernels.segment_sum(
        torch.cat([torch.einsum("eij,eik->ejk", Jf, Jf),
                   torch.einsum("eij,eik->ejk", Jt, Jt), Hft,
                   Hft.transpose(1, 2)]), plans.blocks))
    Hm = blocks.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(n * 6, n * 6)
    bm = grad.reshape(n * 6)
    # LM damping lambda = damping * tr(H) / dim (reference main.cpp:411)
    lam = _div(damping * torch.trace(Hm), n * 6)
    eye = torch.eye(n * 6, dtype=params.dtype, device=params.device)
    Hm = Hm + lam * eye
    # gauge fix of pose 0: identity rows and columns, zero right-hand side
    fix = torch.arange(n * 6, device=params.device) < 6
    Hm = torch.where(fix[:, None] | fix[None, :], eye, Hm)
    bm = torch.where(fix, 0.0, bm)
    L, _ = torch.linalg.cholesky_ex(Hm)
    return torch.cholesky_solve(-bm[:, None], L)[:, 0].reshape(n, 6)


def _hvp(v: torch.Tensor, g: PoseGraph, plans: _Plans, Jf, Jt, lam,
         reduce) -> torch.Tensor:
    """Matrix-free (H + lam I) v from the per-edge blocks: [N, 6] -> [N, 6];
    pose 0's row is the identity (gauge)."""
    y = (torch.einsum("eij,ej->ei", Jf, v[g.e_from])
         + torch.einsum("eij,ej->ei", Jt, v[g.e_to]))
    out = reduce(cuda_kernels.segment_sums(
        plans.edges, (torch.einsum("eij,ei->ej", Jf, y),
                      torch.einsum("eij,ei->ej", Jt, y)))[0]) + lam * v
    first = (torch.arange(v.shape[0], device=v.device) == 0)[:, None]
    return torch.where(first, v, out)


def _pcg_step(params: torch.Tensor, g: PoseGraph, plans: _Plans,
              damping: float, cg_iterations: int, reduce):
    """One LM step by block-Jacobi preconditioned CG (large N; O(E)
    memory)."""
    n = params.shape[0]
    r = residuals(params, g)
    Jf, Jt = _edge_jacobians(params, g)
    # the gradient and the diagonal blocks in one launch
    grad, diag = map(reduce, cuda_kernels.segment_sums(
        plans.edges, _gradient_terms(Jf, Jt, r), _diag_terms(Jf, Jt)))
    tr = torch.sum(torch.diagonal(diag, dim1=-2, dim2=-1))
    lam = _div(damping * tr, n * 6)
    eye6 = torch.eye(6, dtype=params.dtype, device=params.device)
    first = (torch.arange(n, device=params.device) == 0)
    Minv = torch.linalg.inv_ex(diag + lam * eye6)[0]
    Minv = torch.where(first[:, None, None], eye6, Minv)
    b = torch.where(first[:, None], 0.0, -grad)

    def precond(x):
        return torch.einsum("nij,nj->ni", Minv, x)

    tiny = torch.full((), 1e-20, dtype=params.dtype, device=params.device)
    x = torch.zeros_like(b)
    res = b - _hvp(x, g, plans, Jf, Jt, lam, reduce)
    z = precond(res)
    p = z
    for _ in range(cg_iterations):
        Ap = _hvp(p, g, plans, Jf, Jt, lam, reduce)
        rz = torch.sum(res * z)
        alpha = rz / torch.maximum(torch.sum(p * Ap), tiny)
        x = x + alpha * p
        res = res - alpha * Ap
        z_new = precond(res)
        beta = torch.sum(res * z_new) / torch.maximum(rz, tiny)
        p = z_new + beta * p
        z = z_new
    return x


def optimize_pose_graph(params: torch.Tensor, g: PoseGraph,
                        cfg: PgoConfig = PgoConfig(),
                        num_iterations: int | None = None,
                        reduce=_no_reduce):
    """Gauss-Newton/LM PGO (reference ``optimizePoseGraph``
    main.cpp:282-445) of [N, 6] pose params (pose 0 fixed). Returns
    (optimized params, [iters + 1] costs). Convergence (max |delta| <
    cfg.convergence_tol, main.cpp:424) freezes the updates. ``g`` may be a
    shard of the edges when ``reduce`` sums each partial sum over the
    shards (see the module's docstring)."""
    iters = cfg.max_iterations if num_iterations is None else num_iterations
    n = params.shape[0]
    use_dense = n <= cfg.dense_solver_max_poses
    plans = _plans(g, n, use_dense)
    first = (torch.arange(n, device=params.device) == 0)[:, None]
    done = torch.zeros((), dtype=torch.bool, device=params.device)
    costs = [total_cost(params, g, reduce)]
    p = params
    for _ in range(iters):
        if use_dense:
            delta = _dense_step(p, g, plans, cfg.damping, reduce)
        else:
            delta = _pcg_step(p, g, plans, cfg.damping, cfg.cg_iterations,
                              reduce)
        delta = torch.where(first, 0.0, delta)
        max_update = torch.amax(torch.abs(delta))
        p = torch.where(done, p, p + delta)
        done = done | (max_update < cfg.convergence_tol)
        costs.append(total_cost(p, g, reduce))
    return p, torch.stack(costs)


def build_trajectory_graph(poses_params: torch.Tensor, loop_from, loop_to,
                           R_loop: torch.Tensor, t_loop: torch.Tensor,
                           loop_weight: float = 10.0) -> PoseGraph:
    """The reference's graph (main.cpp:1440-1470): K-1 sequential edges of
    weight 1 measured from the current pose chain, plus one loop edge of
    weight ``loop_weight``. ``loop_from`` / ``loop_to`` are ints or 0-d
    tensors."""
    n = poses_params.shape[0]
    dev = poses_params.device
    Rs, ts = lie.params_to_pose(poses_params)
    e_from = torch.arange(n - 1, device=dev)
    R_rel, t_rel = lie.relative(Rs[:-1], ts[:-1], Rs[1:], ts[1:])
    loop_from = torch.as_tensor(loop_from, device=dev).reshape(1).long()
    loop_to = torch.as_tensor(loop_to, device=dev).reshape(1).long()
    return PoseGraph(
        e_from=torch.cat([e_from, loop_from]),
        e_to=torch.cat([e_from + 1, loop_to]),
        R_rel=torch.cat([R_rel, R_loop[None]]),
        t_rel=torch.cat([t_rel, t_loop[None]]),
        weight=torch.cat([torch.ones(n - 1, device=dev),
                          torch.full((1,), loop_weight, device=dev)]),
        mask=torch.ones(n, dtype=torch.bool, device=dev))


def simple_pose_correction(params: torch.Tensor, loop_past, loop_curr,
                           R_loop: torch.Tensor) -> torch.Tensor:
    """Linear drift spread (reference ``simplePoseCorrection``
    main.cpp:451-492): the rotation drift between the loop-predicted and the
    current pose of ``loop_curr`` is spread linearly (in axis-angle) over
    poses past+1 .. curr; translations stay (scale ambiguity, main.cpp:487).
    ``R_loop`` maps pose[past] to the measured pose of curr."""
    n = params.shape[0]
    dev = params.device
    Rs, ts = lie.params_to_pose(params)
    past = torch.as_tensor(loop_past, device=dev).reshape(1).long()
    curr = torch.as_tensor(loop_curr, device=dev).reshape(1).long()
    R_measured = R_loop @ Rs.index_select(0, past)[0]
    drift_vec = lie.so3_log(R_measured @ Rs.index_select(0, curr)[0].T)
    idx = torch.arange(n, device=dev)
    span = torch.clamp_min((curr - past).to(torch.float32), 1.0)
    alpha = torch.clamp((idx - past).to(torch.float32) / span, 0.0, 1.0)
    dR = lie.so3_exp(lie.slerp_rvec(drift_vec, alpha[:, None]))
    new_params = lie.pose_to_params(dR @ Rs, ts)
    # only poses strictly after loop_past move (main.cpp:480)
    return torch.where((idx > past)[:, None], new_params, params)
