"""Camera calibration: chessboard saddle-point detection + Zhang-method
intrinsics with joint Gauss-Newton refinement.

Port of :mod:`slam_loop_closing_tpu.models.calibration`, the replacement for
the reference's ``calibrate`` executable (calibrate.cpp:5-150):
``findChessboardCornersSB`` + ``cornerSubPix`` + ``cv::calibrateCamera``.

* corner detection is a dense saddle-point response over the whole image
  (chessboard X-corners are saddle points of intensity: det(Hessian) < 0
  with strong curvature both ways); subpixel refinement by quadratic fit,
  then the gradient-orthogonality iteration of ``cornerSubPix`` batched
  over all corners;
* grid ordering tries both orientations (9x6 / 6x9 like calibrate.cpp:65-108)
  via a PCA-aligned row clustering (host numpy);
* calibration is Zhang's method: per-image DLT homographies, closed-form
  intrinsics from the absolute-conic constraints, extrinsics from H (host
  numpy), then one joint damped Gauss-Newton refinement of (fx, fy, cx, cy,
  k1, k2, p1, p2, k3) + per-image poses in float32 with forward-mode
  Jacobians (``torch.func.jacfwd``);
* headless: corner-overlay PNGs instead of imshow (calibrate.cpp:114-125).

The tensor parts run on an explicit ``device``. The RMS reprojection error
printed at the end follows cv::calibrateCamera's definition
(calibrate.cpp:139-147).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from slam_loop_closing_tpu_torch.config import CalibrationConfig
from slam_loop_closing_tpu_torch.ops import image as image_ops
from slam_loop_closing_tpu_torch.ops import lie
from slam_loop_closing_tpu_torch.ops.fast import _topk_lowest_index


# ---------------------------------------------------------------------------
# saddle-point corner detection
# ---------------------------------------------------------------------------

def saddle_response(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Dense chessboard-corner response of an [H, W] image: ``-det(Hessian)``
    of the smoothed image, zeroed where non-positive. X-corners are
    intensity saddles, so ``Ixx * Iyy - Ixy^2`` is strongly negative there
    and near zero on edges and flats (edges have one zero curvature
    direction)."""
    g = image_ops.gaussian_blur(img, sigma)
    # central differences, one-sided at the edges
    gy, gx = torch.gradient(g)
    gyy, gyx = torch.gradient(gy)
    gxy, gxx = torch.gradient(gx)
    det = gxx * gyy - 0.25 * (gxy + gyx) ** 2
    return torch.clamp_min(-det, 0.0)


def detect_saddle_points(img: torch.Tensor, num_corners: int):
    """Top-K saddle points with 5x5 NMS and quadratic subpixel refinement.
    Returns (xy [K, 2] float32, response [K], valid [K])."""
    resp = saddle_response(img)
    h, w = resp.shape
    local_max = F.max_pool2d(resp[None, None], 5, stride=1, padding=2)[0, 0]
    peaks = torch.where(resp >= local_max, resp, 0.0)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= 4) & (ys < h - 4) & (xs >= 4) & (xs < w - 4)
    peaks = torch.where(interior, peaks, 0.0)
    vals, idx = _topk_lowest_index(peaks.reshape(-1), num_corners)
    py = idx // w
    px = idx % w

    # quadratic subpixel: a paraboloid through the 3x3 response
    # neighbourhood, whose window is moved inside the image
    y0 = torch.clamp(torch.clamp_min(py, 1) - 1, 0, h - 3)
    x0 = torch.clamp(torch.clamp_min(px, 1) - 1, 0, w - 3)

    def n(a, b):
        return resp[y0 + a, x0 + b]

    dx = (n(1, 2) - n(1, 0)) * 0.5
    dy = (n(2, 1) - n(0, 1)) * 0.5
    dxx = n(1, 2) - 2.0 * n(1, 1) + n(1, 0)
    dyy = n(2, 1) - 2.0 * n(1, 1) + n(0, 1)
    ox = torch.where(dxx.abs() > 1e-12, -dx / dxx, 0.0)
    oy = torch.where(dyy.abs() > 1e-12, -dy / dyy, 0.0)
    xy = torch.stack([px.to(torch.float32) + torch.clamp(ox, -1.0, 1.0),
                      py.to(torch.float32) + torch.clamp(oy, -1.0, 1.0)], -1)
    return xy, vals, vals > 0.0


def xcorner_scores(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Chessboard X-corner polarity check (ChESS-style): at a true inner
    corner the two diagonal quadrant pairs have opposite intensity and each
    pair agrees with itself. Board-boundary corners (one quadrant =
    background) score low — this is what separates the 54 inner corners from
    edge artifacts. Returns a [K] score (higher = more X-corner-like),
    max-pooled over two probe radii."""
    def at(dx, dy):
        off = torch.tensor([dx, dy], dtype=xy.dtype, device=xy.device)
        return image_ops.bilinear_sample(img, xy + off)

    def score(d):
        a = at(d, d)
        b = at(-d, -d)
        c = at(d, -d)
        e = at(-d, d)
        return (a + b - c - e).abs() - (a - b).abs() - (c - e).abs()

    return torch.maximum(score(3.0), score(5.0))


def refine_corners_subpix(img: torch.Tensor, xy: torch.Tensor,
                          window: int = 11, iterations: int = 30,
                          eps: float = 1e-3) -> torch.Tensor:
    """``cv::cornerSubPix`` equivalent (calibrate.cpp:85-86: 11x11 window,
    30 iterations, eps 1e-3), batched over all [K, 2] corners.

    Classic gradient-orthogonality iteration: at a saddle point every window
    pixel's gradient is orthogonal to its offset from the corner, so p
    solves ``sum(w g g^T) p = sum(w g g^T q)`` over window pixels q with
    Gaussian weights w. ``window`` is the half-size like OpenCV's
    cv::Size(11, 11) (search side = 2*11+1). Iteration stops (freezes) per
    corner once the update drops below ``eps``."""
    gy, gx = torch.gradient(img)
    half = window
    d = torch.arange(-half, half + 1, dtype=torch.float32, device=img.device)
    dys, dxs = torch.meshgrid(d, d, indexing="ij")
    offs = torch.stack([dxs.reshape(-1), dys.reshape(-1)], -1)   # [W, 2]
    wgt = torch.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2)
                    / (2.0 * (half / 2.0) ** 2))
    eye = torch.eye(2, dtype=torch.float32, device=img.device)

    p = xy.to(torch.float32)
    frozen = torch.zeros(p.shape[0], dtype=torch.bool, device=img.device)
    for _ in range(iterations):
        q = p[:, None, :] + offs                                  # [K, W, 2]
        gxs = image_ops.bilinear_sample(gx, q)
        gys = image_ops.bilinear_sample(gy, q)
        gxx = torch.sum(wgt * gxs * gxs, dim=1)
        gxy = torch.sum(wgt * gxs * gys, dim=1)
        gyy = torch.sum(wgt * gys * gys, dim=1)
        A = torch.stack([torch.stack([gxx, gxy], -1),
                         torch.stack([gxy, gyy], -1)], -2)        # [K, 2, 2]
        b = torch.stack([
            torch.sum(wgt * (gxs * gxs * q[..., 0] + gxs * gys * q[..., 1]),
                      dim=1),
            torch.sum(wgt * (gxs * gys * q[..., 0] + gys * gys * q[..., 1]),
                      dim=1)], -1)
        ok = (gxx * gyy - gxy * gxy).abs() > 1e-12
        # a flat window's system is singular: solve the identity there
        A_safe = torch.where(ok[:, None, None], A + 1e-12 * eye, eye)
        sol = torch.linalg.solve(A_safe, b)
        new_p = torch.where(ok[:, None], sol, p)
        move = torch.sqrt(torch.sum((new_p - p) ** 2, dim=-1))
        # clamp runaway updates (flat windows) and freeze on convergence
        new_p = torch.where((move < 2.0)[:, None], new_p, p)
        p = torch.where(frozen[:, None], p, new_p)
        frozen = frozen | (move < eps)
    return p


def order_grid(xy: np.ndarray, rows: int, cols: int) -> np.ndarray | None:
    """Order detected corners into a row-major [rows*cols, 2] grid (host
    helper; mirrors the both-orientations retry of calibrate.cpp:65-108).

    Two stages: (1) PCA-frame row clustering with gap-based splits for the
    initial guess, (2) homography-guided refinement — fit H from the current
    assignment, re-assign every lattice slot to its nearest detected corner,
    iterate. Stage 2 fixes the row mis-partitions PCA clustering makes under
    perspective tilt. Returns None if the points don't form the grid."""
    n = rows * cols
    if len(xy) < n:
        return None
    pts = xy[:n].astype(np.float64)
    c = pts.mean(0)
    _, _, vt = np.linalg.svd(pts - c, full_matrices=False)
    ax = (pts - c) @ vt.T  # PCA frame: ax[:,0] = long axis
    # rows: split the short-axis ordering at the (rows-1) largest gaps
    order = np.argsort(ax[:, 1])
    short = ax[order, 1]
    gaps = np.diff(short)
    cut_positions = np.sort(np.argsort(gaps)[-(rows - 1):]) + 1
    rows_idx = np.split(order, cut_positions)
    if any(len(r) != cols for r in rows_idx):
        # fall back to equal-count split
        rows_idx = np.array_split(order, rows)
        if any(len(r) != cols for r in rows_idx):
            return None
    grid = np.concatenate(
        [r[np.argsort(ax[r, 0])] for r in rows_idx])
    assign = pts[grid]

    # homography-guided refinement
    gy, gx = np.mgrid[0:rows, 0:cols]
    obj = np.stack([gx.ravel().astype(np.float64),
                    gy.ravel().astype(np.float64)], 1)
    for _ in range(5):
        H = homography_dlt(obj, assign)
        ph = np.concatenate([obj, np.ones((n, 1))], 1) @ H.T
        pred = ph[:, :2] / ph[:, 2:]
        # nearest detected corner per lattice slot (greedy one-to-one)
        d = np.linalg.norm(pred[:, None, :] - pts[None, :, :], axis=2)
        new_assign_idx = np.full(n, -1)
        used = np.zeros(len(pts), bool)
        for slot in np.argsort(d.min(1)):
            cand = np.argsort(d[slot])
            for j in cand:
                if not used[j]:
                    new_assign_idx[slot] = j
                    used[j] = True
                    break
        new_assign = pts[new_assign_idx]
        if np.allclose(new_assign, assign):
            assign = new_assign
            break
        assign = new_assign
    # final sanity: residual of the fitted homography
    H = homography_dlt(obj, assign)
    ph = np.concatenate([obj, np.ones((n, 1))], 1) @ H.T
    pred = ph[:, :2] / ph[:, 2:]
    if np.max(np.linalg.norm(pred - assign, axis=1)) > 3.0:
        return None
    return assign.astype(np.float32)


def find_chessboard(img: np.ndarray, rows: int, cols: int,
                    cfg: CalibrationConfig = CalibrationConfig(), *, device):
    """Detect + order the inner-corner grid; tries both orientations AND two
    detection scales like the reference (9x6 / 6x9 at full and half
    resolution, corners scaled back, calibrate.cpp:65-108), then refines
    every corner on the ORIGINAL image with the cornerSubPix-equivalent
    (calibrate.cpp:85-86, using cfg.refine_window / refine_iterations /
    refine_eps). Returns ([rows*cols, 2] corners row-major, (rows, cols)) or
    (None, None)."""
    n = rows * cols
    full = torch.as_tensor(np.asarray(img, np.float32), device=device)
    for scale in (1, 2):
        imgs = full if scale == 1 else full[::2, ::2]
        xy, _resp, valid = detect_saddle_points(imgs, 3 * n)
        # polarity filter: drop saddle responses that are not X-corners
        # (board boundary / background artifacts), then keep the strongest n
        keep = valid & (xcorner_scores(imgs, xy) > 0.25)
        xy = xy[keep].cpu().numpy()
        for r, c in ((rows, cols), (cols, rows)):
            g = order_grid(xy, r, c)
            if g is not None and _grid_plausible(g, r, c):
                if scale > 1:
                    g = g * scale  # scale corners back (calibrate.cpp:79-84)
                g = refine_corners_subpix(
                    full, torch.as_tensor(g, dtype=torch.float32,
                                          device=device),
                    cfg.refine_window, cfg.refine_iterations, cfg.refine_eps)
                return g.cpu().numpy().astype(np.float32), (r, c)
    return None, None


def _grid_plausible(grid: np.ndarray, rows: int, cols: int) -> bool:
    g = grid.reshape(rows, cols, 2)
    dr = np.linalg.norm(np.diff(g, axis=0), axis=-1)
    dc = np.linalg.norm(np.diff(g, axis=1), axis=-1)
    if dr.size == 0 or dc.size == 0:
        return False
    return (dr.std() < 0.35 * dr.mean()) and (dc.std() < 0.35 * dc.mean())


# ---------------------------------------------------------------------------
# Zhang initialization
# ---------------------------------------------------------------------------

def homography_dlt(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """Normalized DLT homography world-plane -> image (host numpy; runs once
    per calibration image)."""
    def norm_pts(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / np.mean(np.linalg.norm(p - c, axis=1))
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        ph = np.concatenate([p, np.ones((len(p), 1))], 1)
        return (ph @ T.T)[:, :2], T

    a, Ta = norm_pts(obj_xy)
    b, Tb = norm_pts(img_xy)
    rows = []
    for (X, Y), (u, v) in zip(a, b):
        rows.append([-X, -Y, -1, 0, 0, 0, u * X, u * Y, u])
        rows.append([0, 0, 0, -X, -Y, -1, v * X, v * Y, v])
    _, _, vt = np.linalg.svd(np.asarray(rows))
    H = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Tb) @ H @ Ta
    return H / H[2, 2]


def intrinsics_from_homographies(Hs: list[np.ndarray],
                                 image_size: tuple[int, int]) -> np.ndarray:
    """Zhang's closed-form K from >= 2 homographies (absolute-conic
    constraints v12 b = 0, (v11 - v22) b = 0). Falls back to a principal-
    point-centered guess if the system is degenerate."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])

    rows = []
    for H in Hs:
        rows.append(v(H, 0, 1))
        rows.append(v(H, 0, 0) - v(H, 1, 1))
    A = np.asarray(rows)
    _, s, vt = np.linalg.svd(A)
    b = vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    try:
        cy = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 ** 2)
        lam = B33 - (B13 ** 2 + cy * (B12 * B13 - B11 * B23)) / B11
        fx = np.sqrt(lam / B11)
        fy = np.sqrt(lam * B11 / (B11 * B22 - B12 ** 2))
        cx = -B13 * fx ** 2 / lam
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        if not np.all(np.isfinite(K)) or fx <= 0 or fy <= 0:
            raise FloatingPointError
        return K
    except FloatingPointError:
        h, w = image_size
        f = 1.2 * max(h, w)
        return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])


def extrinsics_from_homography(K: np.ndarray, H: np.ndarray):
    """Per-image (R, t) from H = K [r1 r2 t] (Zhang), with SVD
    orthogonalization of the rotation."""
    A = np.linalg.inv(K) @ H
    lam = 1.0 / np.linalg.norm(A[:, 0])
    r1 = lam * A[:, 0]
    r2 = lam * A[:, 1]
    r3 = np.cross(r1, r2)
    t = lam * A[:, 2]
    R = np.stack([r1, r2, r3], axis=1)
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = -R
    if (R[:, :2] * np.stack([r1, r2], 1)).sum() < 0:
        R, t = -R, -t
    return R, t


# ---------------------------------------------------------------------------
# joint GN refinement (the cv::calibrateCamera LM stage)
# ---------------------------------------------------------------------------

class CalibrationResult(NamedTuple):
    K: np.ndarray
    dist: np.ndarray        # (k1, k2, p1, p2, k3)
    rms: float
    per_image_poses: list[tuple[np.ndarray, np.ndarray]]
    num_images: int


def _project_calib(intr: torch.Tensor, poses: torch.Tensor,
                   X: torch.Tensor) -> torch.Tensor:
    """Project the board points ``X`` [n, 3] into every image: intrinsics
    vector [fx, fy, cx, cy, k1, k2, p1, p2, k3], poses [m, 6] of
    [rvec; t] -> [m, n, 2] pixels."""
    R = lie.so3_exp(poses[:, :3])                                # [m, 3, 3]
    Xc = torch.einsum("mij,nj->mni", R, X) + poses[:, None, 3:]
    x = Xc[..., 0] / Xc[..., 2]
    y = Xc[..., 1] / Xc[..., 2]
    k1, k2, p1, p2, k3 = intr[4], intr[5], intr[6], intr[7], intr[8]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([intr[0] * xd + intr[2], intr[1] * yd + intr[3]], -1)


def refine_calibration(intr0: torch.Tensor, poses0: torch.Tensor,
                       obj: torch.Tensor, img_pts: torch.Tensor,
                       iterations: int = 20):
    """Joint damped Gauss-Newton over intrinsics (9) + per-image poses
    (M x 6): full dense normal equations from forward-mode Jacobians (the
    problem is tiny — 9 + 6M parameters; one dense solve per iteration). A
    step is accepted only when the cost falls."""
    m = poses0.shape[0]

    def residuals(flat):
        proj = _project_calib(flat[:9], flat[9:].reshape(m, 6), obj)
        return (proj - img_pts).reshape(-1)

    flat = torch.cat([intr0, poses0.reshape(-1)])
    eye = torch.eye(flat.shape[0], dtype=flat.dtype, device=flat.device)
    for _ in range(iterations):
        r = residuals(flat)
        J = torch.func.jacfwd(residuals)(flat)
        H = J.T @ J
        g = J.T @ r
        lam = 1e-3 * torch.trace(H) / H.shape[0]
        new = flat + torch.linalg.solve(H + lam * eye, -g)
        better = torch.sum(residuals(new) ** 2) < torch.sum(r ** 2)
        flat = torch.where(better, new, flat)
    r = residuals(flat)
    rms = torch.sqrt(torch.mean(r ** 2) * 2.0)  # per-point (u, v) pairs
    return flat[:9], flat[9:].reshape(m, 6), rms


def calibrate_camera(images: list[np.ndarray],
                     cfg: CalibrationConfig = CalibrationConfig(),
                     log=print, *, device) -> CalibrationResult:
    """Full calibration from chessboard images (the ``calibrate`` tool,
    calibrate.cpp:5-150), the tensor parts on ``device``."""
    rows, cols = cfg.board_rows, cfg.board_cols
    sq = cfg.square_size_m
    grids = []
    layouts = []
    for i, img in enumerate(images):
        g, layout = find_chessboard(img, rows, cols, cfg, device=device)
        if g is None:
            log(f"Image {i}: chessboard not found, skipping")
            continue
        grids.append(g)
        layouts.append(layout)
        log(f"Image {i}: found {layout[0]}x{layout[1]} corners")
    if len(grids) < 2:
        raise ValueError("need at least 2 usable chessboard images")

    Hs = []
    objs = []
    for g, (r, c) in zip(grids, layouts):
        gy, gx = np.mgrid[0:r, 0:c]
        obj = np.stack([gx.ravel() * sq, gy.ravel() * sq], 1)
        objs.append(obj)
        Hs.append(homography_dlt(obj, g))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    h, w = images[0].shape
    K0 = intrinsics_from_homographies(Hs, (h, w))
    poses0 = []
    for H in Hs:
        R, t = extrinsics_from_homography(K0, H)
        poses0.append(np.concatenate([lie.so3_log(f32(R)).cpu().numpy(), t]))

    intr0 = f32([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2],
                 0.0, 0.0, 0.0, 0.0, 0.0])
    obj3 = f32(np.concatenate([objs[0], np.zeros((len(objs[0]), 1))], 1))
    intr, poses, rms = refine_calibration(
        intr0, f32(np.stack(poses0)), obj3, f32(np.stack(grids)),
        cfg.lm_iterations)
    intr = intr.cpu().numpy().astype(np.float64)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1.0]])
    dist = intr[4:9]
    rots = lie.so3_exp(poses[:, :3]).cpu().numpy()
    pose_list = [(R, p[3:]) for R, p in zip(rots, poses.cpu().numpy())]
    log(f"Calibration RMS reprojection error: {float(rms):.4f} px")
    log(f"K =\n{K}")
    log(f"distCoeffs = {dist}")
    return CalibrationResult(K=K, dist=dist, rms=float(rms),
                             per_image_poses=pose_list,
                             num_images=len(grids))


def run_cli(args) -> int:
    """CLI entry (the ``calibrate`` mode)."""
    from slam_loop_closing_tpu_torch.utils import io as io_utils

    img_dir = Path(args.images)
    paths = sorted(img_dir.glob("*.png"))
    if not paths:
        raise SystemExit(f"no .png images in {img_dir} (calibrate.cpp:25)")
    images = [io_utils.load_frame_gray(p) for p in paths]
    cfg = CalibrationConfig(board_cols=args.cols, board_rows=args.rows,
                            square_size_m=args.square_size)
    calibrate_camera(images, cfg, device=args.device)
    if args.output_overlays:
        _write_overlays(images, cfg, Path(args.output_overlays), args.device)
    return 0


def _write_overlays(images, cfg, out_dir: Path, device):
    """Corner-overlay PNGs (replaces the reference's 500 ms imshow,
    calibrate.cpp:114-125)."""
    from PIL import Image, ImageDraw

    out_dir.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(images):
        g, _ = find_chessboard(img, cfg.board_rows, cfg.board_cols, cfg,
                               device=device)
        im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)
                             ).convert("RGB")
        if g is not None:
            d = ImageDraw.Draw(im)
            for x, y in g:
                d.ellipse([x - 3, y - 3, x + 3, y + 3], outline=(255, 0, 0))
        im.save(str(out_dir / f"corners_{i:02d}.png"))
