"""Two-view epipolar geometry: essential-matrix estimation, pose recovery,
DLT triangulation, and the keyframe-gating metrics.

Port of :mod:`slam_loop_closing_tpu.ops.epipolar`. Everything works on
fixed-size padded point arrays with boolean validity masks, in normalized
camera coordinates (pixels divided through K), float32 throughout. Functions
that the JAX package vmaps take leading batch axes here instead: the minimal
solver over hypotheses, the cheirality vote over the four pose candidates,
and the 8-point solve, Sampson errors and pose recovery over the candidate
pairs of the SfM loop search (``[..., N, 2]`` points).

On a CUDA device every function is a short chain of PyTorch kernels; the
small SVDs and the QR go through ``torch.linalg`` (cuSOLVER), and each
``torch.linalg.svd`` call reads cuSOLVER's convergence info back to the host
(two host syncs per call, measured on an H100; nothing else here reads the
device). SVD sign and ordering conventions differ between LAPACK, cuSOLVER
and XLA: E is defined up to sign, and :func:`recover_pose` picks its (R, t)
by the cheirality vote, which does not depend on them.
"""

from __future__ import annotations

import torch


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] matrices by cofactor expansion (no LU)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


# ---------------------------------------------------------------------------
# masked statistics
# ---------------------------------------------------------------------------

def masked_upper_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``sorted(values[mask])[count // 2]`` — the reference's median
    (main.cpp:251-256). Returns 0.0 for an empty mask (main.cpp:176)."""
    count = torch.sum(mask, dtype=torch.int32)
    big = torch.finfo(values.dtype).max
    s = torch.sort(torch.where(mask, values, big)).values
    idx = torch.clamp(count // 2, 0, values.shape[0] - 1)
    return torch.where(count > 0, s.gather(0, idx.reshape(1).long())[0], 0.0)


def median_displacement(pts1: torch.Tensor, pts2: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Upper-median pixel displacement of matched pairs (main.cpp:171-189)."""
    d = pts2 - pts1
    return masked_upper_median(torch.sqrt(torch.sum(d * d, dim=-1)), mask)


# ---------------------------------------------------------------------------
# essential matrix
# ---------------------------------------------------------------------------

def epipolar_design(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The 8-point design matrix: rows ``[u2u1, u2v1, u2, v2u1, v2v1, v2,
    u1, v1, 1]`` so that ``A @ vec(E) = 0`` for ``x2h^T E x1h = 0``.
    Batched over any leading axes; x1/x2 are [..., N, 2] -> [..., N, 9]."""
    one = torch.ones_like(x1[..., 0])
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        one], dim=-1)


def nullspace_8x9(A: torch.Tensor) -> torch.Tensor:
    """Unit nullspace vector of a batch of [..., 8, 9] design matrices via
    Householder QR of ``A^T`` — the RANSAC minimal-sample solver. For a
    full-rank minimal sample the nullspace is exact (dimension one): the
    last column of the complete-QR ``Q`` of ``A^T`` spans it. Elementwise
    and matrix-vector work only, so a batch of hypotheses is a few dozen
    kernels on the card."""
    M = A.transpose(-1, -2)                              # [..., 9, 8]
    idx = torch.arange(9, device=A.device)
    vs, betas = [], []
    for k in range(8):
        x = torch.where(idx >= k, M[..., :, k], 0.0)
        alpha = torch.sqrt(torch.sum(x * x, dim=-1))
        sign = torch.where(x[..., k] >= 0, 1.0, -1.0)
        ek = (idx == k).to(A.dtype)
        v = x + (sign * alpha)[..., None] * ek
        vn2 = torch.sum(v * v, dim=-1)
        # 2 / vn2 (PyTorch takes 1 / vn2 times 2: the same bits)
        beta = torch.where(vn2 > 1e-30, 2.0 / vn2, 0.0)
        w = torch.einsum("...i,...ij->...j", v, M) * beta[..., None]
        M = M - v[..., :, None] * w[..., None, :]
        vs.append(v)
        betas.append(beta)
    # q = Q e_9 = H_1 (H_2 (... (H_8 e_9))) — only the last column of Q
    q = torch.broadcast_to((idx == 8).to(A.dtype), A.shape[:-2] + (9,))
    for k in reversed(range(8)):
        v, beta = vs[k], betas[k]
        q = q - v * (beta * torch.sum(v * q, dim=-1))[..., None]
    return q


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (s, s, 0) with
    s = (s1 + s2) / 2. Batched over leading axes."""
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    z = torch.zeros_like(s)
    return (U * torch.stack([s, s, z], dim=-1)[..., None, :]) @ Vt


def essential_eight_point(x1: torch.Tensor, x2: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point essential-matrix solve on normalized coordinates:
    QR-reduce the weighted [N, 9] design, take the smallest right singular
    vector of the 9x9 R (the same vector as the SVD of the design, without
    squaring its condition number), project onto the essential manifold.
    Batched over leading axes of [..., N, 2] points and [..., N] weights."""
    Aw = epipolar_design(x1, x2) * weights[..., None]
    R = torch.linalg.qr(Aw, mode="r").R                  # [..., 9, 9]
    Vt9 = torch.linalg.svd(R, full_matrices=True).Vh
    return project_to_essential(Vt9[..., -1, :].reshape(*Vt9.shape[:-2], 3,
                                                         3))


def essential_eight_point_fast(x1: torch.Tensor, x2: torch.Tensor,
                               weights: torch.Tensor) -> torch.Tensor:
    """8-point solve via the smallest eigenvector of the 9x9 normal matrix
    ``A^T A`` — faster, but squares the condition number (in float32 about
    half the inliers are lost at a 1 px threshold). Kept for callers with
    looser thresholds, as in the JAX package."""
    Aw = epipolar_design(x1, x2) * weights[:, None]
    vecs = torch.linalg.eigh(Aw.T @ Aw).eigenvectors    # ascending
    return project_to_essential(vecs[:, 0].reshape(3, 3))


def sampson_error(E: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> torch.Tensor:
    """First-order (Sampson) squared epipolar error of [..., N]
    correspondences under ``E`` [..., 3, 3] -> [..., N], normalized
    coordinates; the leading axes of the points and of E broadcast."""
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)  # [..., N, 3]
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], dim=-1)
    Ex1 = x1h @ E.transpose(-1, -2)      # [..., N, 3] = (E @ x1h^T)^T
    Etx2 = x2h @ E                       # [..., N, 3] = (E^T @ x2h^T)^T
    num = torch.sum(x2h * Ex1, dim=-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    return num / torch.clamp_min(den, 1e-12)


def decompose_essential(E: torch.Tensor):
    """E [..., 3, 3] -> the four (R, t) candidates (R1,t), (R1,-t), (R2,t),
    (R2,-t) as ([..., 4, 3, 3], [..., 4, 3]) (cv::decomposeEssentialMat:
    R1 = U W V^T, R2 = U W^T V^T, t = u3, with determinant sign fixes so R
    are proper rotations)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(_det3(U))[..., None, None]
    Vt = Vt * torch.sign(_det3(Vt))[..., None, None]
    # W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]] from the identity's rows, on
    # the device (a host tensor, or a write of a Python scalar into a CUDA
    # tensor, is a host sync)
    e = torch.eye(3, dtype=E.dtype, device=E.device)
    W = torch.stack([-e[1], e[0], e[2]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _projections(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R, t[..., None]], dim=-1)        # [..., 3, 4]


def _dlt_rows(R1, t1, R2, t2, x1, x2) -> torch.Tensor:
    """The 4x4 DLT systems of every correspondence, [..., N, 4, 4], with
    the leading axes of the poses and of the [..., N, 2] points broadcast."""
    P1, P2 = _projections(R1, t1), _projections(R2, t2)
    parts = torch.broadcast_tensors(
        x1[..., 0:1] * P1[..., None, 2, :] - P1[..., None, 0, :],
        x1[..., 1:2] * P1[..., None, 2, :] - P1[..., None, 1, :],
        x2[..., 0:1] * P2[..., None, 2, :] - P2[..., None, 0, :],
        x2[..., 1:2] * P2[..., None, 2, :] - P2[..., None, 1, :])
    return torch.stack(parts, dim=-2)


def triangulate_dlt(R1: torch.Tensor, t1: torch.Tensor, R2: torch.Tensor,
                    t2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Batched two-view DLT triangulation (cv::triangulatePoints, reference
    main.cpp:1249-1250), normalized coordinates: the smallest right singular
    vector of each correspondence's 4x4 system (one batched SVD). Returns
    [N, 3] world points, the homogeneous division guarded; callers gate on
    depth as the reference does."""
    Xh = torch.linalg.svd(_dlt_rows(R1, t1, R2, t2, x1, x2)).Vh[..., -1, :]
    w = Xh[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / w_safe[..., None]


def triangulate_linear(R1: torch.Tensor, t1: torch.Tensor, R2: torch.Tensor,
                       t2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
                       ) -> torch.Tensor:
    """Inhomogeneous two-view triangulation: the DLT rows of
    :func:`triangulate_dlt` solved as ``B X = -c`` through closed-form 3x3
    normal equations. Equivalent except for points at infinity; used for
    the cheirality votes. Leading pose axes of R2/t2 broadcast:
    [..., N, 3]."""
    rows = _dlt_rows(R1, t1, R2, t2, x1, x2)
    B = rows[..., :3]
    c = rows[..., 3]
    H = torch.einsum("...nij,...nik->...njk", B, B)
    g = torch.einsum("...nij,...ni->...nj", B, c)
    H = H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device)
    return -_solve3x3(H, g)


def _solve3x3(H: torch.Tensor, g: torch.Tensor,
              tiny: float = 1e-30) -> torch.Tensor:
    """Closed-form batched 3x3 solve (adjugate), elementwise only, so the
    same bits on every device. A determinant below ``tiny`` in magnitude is
    taken as ``tiny`` (the caller's Tikhonov epsilon keeps H invertible);
    with ``tiny=0`` a singular H gives inf or nan, as an LU solve does."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    p, q, r = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A00 = e * r - f * q
    A01 = c * q - b * r
    A02 = b * f - c * e
    A10 = f * p - d * r
    A11 = a * r - c * p
    A12 = c * d - a * f
    A20 = d * q - e * p
    A21 = b * p - a * q
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / torch.where(torch.abs(det) < tiny, tiny, det)
    x0 = (A00 * g[..., 0] + A01 * g[..., 1] + A02 * g[..., 2]) * inv_det
    x1 = (A10 * g[..., 0] + A11 * g[..., 1] + A12 * g[..., 2]) * inv_det
    x2 = (A20 * g[..., 0] + A21 * g[..., 1] + A22 * g[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def depths(R: torch.Tensor, t: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame depth z of [..., N, 3] points under a pose with leading
    axes matching X's: [..., N]."""
    return (X @ R[..., 2, :, None])[..., 0] + t[..., 2, None]


def cheirality_counts(Rs: torch.Tensor, ts: torch.Tensor, x1: torch.Tensor,
                      x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """For each of the [..., C] (R, t) candidates, the number of masked
    points of [..., N] that triangulate in front of BOTH cameras
    (cv::recoverPose's vote)."""
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    zero = torch.zeros(3, dtype=Rs.dtype, device=Rs.device)
    X = triangulate_linear(eye, zero, Rs, ts, x1[..., None, :, :],
                           x2[..., None, :, :])           # [..., C, N, 3]
    ok = ((depths(eye, zero, X) > 0) & (depths(Rs, ts, X) > 0)
          & mask[..., None, :])
    return torch.sum(ok, dim=-1, dtype=torch.int32)


def recover_pose(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                 mask: torch.Tensor):
    """cv::recoverPose equivalent (reference main.cpp:596-601): the (R, t)
    candidate with the best cheirality vote among masked inliers (the first
    on a tie). Returns (R, t, pose_inlier_mask, num_pose_inliers); batched
    over leading axes of E [..., 3, 3] and the points [..., N, 2]."""
    Rs, ts = decompose_essential(E)
    best = torch.argmax(cheirality_counts(Rs, ts, x1, x2, mask), dim=-1)
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3)[..., 0,
                                                                     :, :]
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2)[..., 0, :]
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    zero = torch.zeros(3, dtype=E.dtype, device=E.device)
    X = triangulate_linear(eye, zero, R, t, x1, x2)
    pose_mask = (depths(eye, zero, X) > 0) & (depths(R, t, X) > 0) & mask
    return R, t, pose_mask, torch.sum(pose_mask, dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# gating metrics
# ---------------------------------------------------------------------------

def parallax_angle_deg(C1: torch.Tensor, C2: torch.Tensor,
                       X: torch.Tensor) -> torch.Tensor:
    """Angle (degrees) between rays C1->X and C2->X, clamped acos
    (reference main.cpp:200-222). Batched over points [N, 3]."""
    ray1 = X - C1[None, :]
    ray2 = X - C2[None, :]
    n1 = torch.sqrt(torch.sum(ray1 * ray1, dim=-1))
    n2 = torch.sqrt(torch.sum(ray2 * ray2, dim=-1))
    cosang = torch.sum(ray1 * ray2, dim=-1) / torch.clamp_min(n1 * n2, 1e-18)
    ang = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    return torch.where((n1 < 1e-9) | (n2 < 1e-9), 0.0, ang)
