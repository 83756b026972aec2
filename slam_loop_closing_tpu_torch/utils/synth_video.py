"""Synthetic closed-loop video: a camera orbiting inside a textured
cylinder, ray-cast to grayscale frames with numpy.

A copy of :func:`slam_loop_closing_tpu.utils.synth_video.orbit_sequence`,
the render helpers it uses, ``write_frames``, the point splatter
``render_frame``, the multi-loop fixture (``multi_loop_sequence`` with its
truth mask ``ground_truth_loop_pairs``) and the command line ``main`` (the
tests hold frames and masks equal). The orbit spans a full turn, so the
final frames see the first frames' wall again: a correct loop detector MUST
join them. The multi-loop trajectory has two true revisits and a distractor
pass at another height that a correct detector must NOT join, so it tells a
right matcher from one that joins everything.
:func:`render_chessboard` and :func:`chessboard_views` rasterize the
calibration tool's input: views of a chessboard plane under a known camera.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def render_frame(K: np.ndarray, R: np.ndarray, t: np.ndarray,
                 X: np.ndarray, intensity: np.ndarray, size: np.ndarray,
                 h: int, w: int) -> np.ndarray:
    """Rasterize points into a [h, w] float32 frame (painter's order by
    depth: far points first so near ones overwrite). Every point is a square
    of four tones fixed by its intensity, so each view renders the same
    texture with local gradient structure."""
    Xc = X @ R.T + t
    z = Xc[:, 2]
    vis = z > 0.2
    uv = np.zeros((len(X), 2))
    uv[vis] = (Xc[vis, :2] / z[vis, None]) @ np.diag([K[0, 0], K[1, 1]]) \
        + np.array([K[0, 2], K[1, 2]])
    img = np.zeros((h, w), np.float32)
    order = np.argsort(-z)
    for i in order:
        if not vis[i]:
            continue
        u, v = uv[i]
        # screen-space size shrinks with depth
        s = max(2, int(round(size[i] / z[i] * 10.0)))
        x0, y0 = int(round(u)) - s, int(round(v)) - s
        x1, y1 = x0 + 2 * s + 1, y0 + 2 * s + 1
        if x1 <= 0 or y1 <= 0 or x0 >= w or y0 >= h:
            continue
        base = intensity[i]
        tones = np.array([[base, base * 0.45],
                          [base * 0.7, min(base * 1.3, 1.0)]], np.float32)
        xm, ym = int(round(u)), int(round(v))
        for qy in (0, 1):
            for qx in (0, 1):
                ya = max(0, y0) if qy == 0 else max(0, ym)
                yb = ym if qy == 0 else y1
                xa = max(0, x0) if qx == 0 else max(0, xm)
                xb = xm if qx == 0 else x1
                if yb > ya and xb > xa:
                    img[ya:yb, xa:xb] = tones[qy, qx]
    return img


def _multiscale_texture(rng, th: int, tw: int) -> np.ndarray:
    """Smooth multi-octave noise plus thresholded mid-scale noise, in
    [0, 1]: gradients at every scale, real intensity steps for FAST, and
    regionally distinct edge patterns so descriptors differ by place."""
    def octave_noise(octave):
        n = rng.standard_normal((th // octave + 2, tw // octave + 2))
        ys = np.linspace(0, n.shape[0] - 1.001, th)
        xs = np.linspace(0, n.shape[1] - 1.001, tw)
        y0 = ys.astype(int)
        x0 = xs.astype(int)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        return ((1 - fy) * ((1 - fx) * n[y0][:, x0] + fx * n[y0][:, x0 + 1])
                + fy * ((1 - fx) * n[y0 + 1][:, x0]
                        + fx * n[y0 + 1][:, x0 + 1]))

    smooth = sum(octave_noise(o) * o for o in (8, 16, 32, 96))
    smooth -= smooth.min()
    smooth /= smooth.max()
    edges = (octave_noise(12) > 0.7 * octave_noise(96)).astype(np.float64)
    edges2 = (octave_noise(24) > 0.3 + 0.4 * octave_noise(128)).astype(
        np.float64)
    tex = 0.2 + 0.25 * smooth + 0.35 * edges + 0.2 * edges2
    return np.clip(tex, 0.0, 1.0).astype(np.float32)


def render_cylinder_trajectory(thetas: np.ndarray, ys: np.ndarray,
                               h: int = 240, w: int = 320,
                               num_points: int = 400, radius: float = 8.0,
                               seed: int = 0) -> np.ndarray:
    """[B, h, w] float32 frames of a camera inside a textured cylinder
    (axis y, radius twice the orbit radius) at orbit angle ``thetas[i]`` and
    height ``ys[i]``, looking along the +theta tangent. ``num_points``
    scales the texture resolution."""
    rng = np.random.default_rng(seed)
    tw = max(1024, 4 * num_points)
    th = 512
    tex = _multiscale_texture(rng, th, tw)

    cyl_r = 2.0 * radius
    f = 0.8 * w
    Kinv_scale = 1.0 / f

    us, vs = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    dir_cam = np.stack([(us - w / 2) * Kinv_scale,
                        (vs - h / 2) * Kinv_scale,
                        np.ones_like(us)], -1)     # [h, w, 3]

    num_frames = len(thetas)
    frames = np.zeros((num_frames, h, w), np.float32)
    for i in range(num_frames):
        ang = float(thetas[i])
        C = np.array([radius * np.cos(ang), float(ys[i]),
                      radius * np.sin(ang)])
        z = np.array([-np.sin(ang), 0.0, np.cos(ang)])
        up = np.array([0.0, 1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])                    # world->cam rows
        d = dir_cam @ R                            # R^T @ dir, [h, w, 3]
        # ray-cylinder: |C_xz + t d_xz|^2 = cyl_r^2, the positive root
        a = d[..., 0] ** 2 + d[..., 2] ** 2
        b = 2.0 * (C[0] * d[..., 0] + C[2] * d[..., 2])
        c = C[0] ** 2 + C[2] ** 2 - cyl_r ** 2
        disc = np.maximum(b * b - 4 * a * c, 0.0)
        t_hit = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-12)
        px = C[0] + t_hit * d[..., 0]
        py = C[1] + t_hit * d[..., 1]
        pz = C[2] + t_hit * d[..., 2]
        theta = np.arctan2(pz, px)                 # [-pi, pi]
        u_tex = (theta + np.pi) / (2 * np.pi) * (tw - 1)
        v_tex = np.clip((py / cyl_r * 0.5 + 0.5) * (th - 1), 0, th - 1)
        u0 = u_tex.astype(int) % tw
        v0 = v_tex.astype(int)
        frames[i] = tex[v0, u0]
    return frames


def orbit_sequence(num_frames: int = 100, h: int = 240, w: int = 320,
                   num_points: int = 400, radius: float = 8.0,
                   seed: int = 0, revisit: bool = True) -> np.ndarray:
    """[B, h, w] float32 frames of a camera orbiting inside the textured
    cylinder at constant speed. With ``revisit`` the orbit spans a full
    2*pi, so the final frames see the start's wall again (ground-truth loop
    closure)."""
    span = 2 * np.pi if revisit else np.pi
    thetas = span * np.arange(num_frames) / num_frames
    return render_cylinder_trajectory(thetas, np.zeros(num_frames), h, w,
                                      num_points, radius, seed)


def multi_loop_sequence(num_frames: int = 120, h: int = 240, w: int = 320,
                        num_points: int = 400, radius: float = 8.0,
                        seed: int = 0, distractor_dy: float = 16.0):
    """The hard loop-closure fixture: two true revisit regions and a
    distractor near-revisit pass. Segments, as fractions of the frames:

    1. forward, theta 0 -> 0.34 * 2 pi at y = 0 (new territory);
    2. backward, theta 0.34 -> 0.20 * 2 pi at y = 0: TRUE revisit #1 (the
       look direction depends on theta only, so the poses of segment 1 are
       rendered again);
    3. forward, theta 0.20 -> 0.34 * 2 pi at y = ``distractor_dy``: the
       DISTRACTOR, the same angles at a height whose texture bands are
       disjoint; a correct detector must not fire here. The climb and the
       descent take a few frames, whose pairs are scored as ignore;
    4. forward, theta 0.34 * 2 pi -> 2 pi * 1.03 back at y = 0: new
       territory, then the wrap past theta = 0 is TRUE revisit #2.

    Returns (frames [B, h, w] float32, thetas [B], ys [B]);
    :func:`ground_truth_loop_pairs` of (thetas, ys) is the truth mask."""
    n1 = int(0.30 * num_frames)
    n2 = int(0.13 * num_frames)
    n3 = int(0.13 * num_frames)
    n4 = num_frames - n1 - n2 - n3
    a, b = 0.34 * 2 * np.pi, 0.20 * 2 * np.pi
    th1 = np.linspace(0.0, a, n1, endpoint=False)
    th2 = np.linspace(a, b, n2, endpoint=False)
    th3 = np.linspace(b, a, n3, endpoint=False)
    th4 = np.linspace(a, 2 * np.pi * 1.03, n4)
    thetas = np.concatenate([th1, th2, th3, th4])
    r3 = max(2, min(4, n3 // 3))
    r4 = max(2, min(4, n4 // 4))
    ys = np.concatenate([
        np.zeros(n1),
        np.zeros(n2),
        np.concatenate([np.linspace(0.0, distractor_dy, r3, endpoint=False),
                        np.full(n3 - r3, distractor_dy)]),
        np.concatenate([np.linspace(distractor_dy, 0.0, r4, endpoint=False),
                        np.zeros(n4 - r4)]),
    ])
    frames = render_cylinder_trajectory(thetas, ys, h, w, num_points,
                                        radius, seed)
    return frames, thetas, ys


def ground_truth_loop_pairs(thetas: np.ndarray, ys: np.ndarray,
                            min_gap: int, tol_theta: float = 0.08,
                            tol_y: float = 1.0) -> np.ndarray:
    """[B, B] bool mask of TRUE revisit (query, target) pairs: angular
    distance (mod 2 pi) within ``tol_theta`` radians AND height within
    ``tol_y``, with ``target <= query - min_gap``. Same-angle pairs at
    well-separated heights (the distractor pass) are negatives; pairs at
    intermediate heights or just outside ``tol_theta`` are partially
    co-visible and are scored as ignore, not as false positives."""
    dth = np.abs(thetas[:, None] - thetas[None, :])
    dth = np.minimum(dth, 2 * np.pi - dth)
    dy = np.abs(ys[:, None] - ys[None, :])
    near = (dth < tol_theta) & (dy < tol_y)
    q = np.arange(len(thetas))[:, None]
    t = np.arange(len(thetas))[None, :]
    return near & (t <= q - min_gap)


def write_frames(frames: np.ndarray, out_dir: str | Path) -> Path:
    """Write frames as ``frame_%04d.png`` (the reference's naming,
    extract_images_from_mov.cpp:47)."""
    from slam_loop_closing_tpu_torch.utils.io import _write_png

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        _write_png(out / f"frame_{i:04d}.png",
                   (np.clip(f, 0, 1) * 255).astype(np.uint8))
    return out


def render_chessboard(K, R, t, rows, cols, square, h, w,
                      ss: int = 2) -> np.ndarray:
    """Rasterize a chessboard plane (z=0 world, ``rows`` x ``cols`` squares
    of side ``square``, gray outside) under a pinhole camera by mapping
    every pixel back through the plane homography. ``ss``: supersampling
    factor for soft edges. [h, w] float32 in [0, 1]."""
    Hinv = np.linalg.inv(K @ np.stack([R[:, 0], R[:, 1], t], axis=1))
    ys, xs = np.mgrid[0:h * ss, 0:w * ss] / ss
    world = Hinv @ np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    X = world[0] / world[2]
    Y = world[1] / world[2]
    ix = np.floor(X / square).astype(int)
    iy = np.floor(Y / square).astype(int)
    img = np.where((ix + iy) % 2 == 0, 1.0, 0.0)
    inside = ((X > 0) & (X < cols * square)
              & (Y > 0) & (Y < rows * square))
    img = np.where(inside, img, 0.5)
    img = img.reshape(h * ss, w * ss).astype(np.float32)
    return img.reshape(h, ss, w, ss).mean((1, 3))


def chessboard_views(num_views: int = 6, h: int = 240, w: int = 320,
                     focal: float = 300.0, rows: int = 6, cols: int = 9,
                     square: float = 0.03, seed: int = 2):
    """``num_views`` mildly tilted views of a board with ``rows`` x ``cols``
    inner corners, centered 0.55-0.75 units in front of a camera with
    ``K = [[focal, 0, w/2], [0, focal, h/2], [0, 0, 1]]``: (K, images)."""
    K = np.array([[focal, 0, w / 2.0], [0, focal, h / 2.0], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    images = []
    for _ in range(num_views):
        rv = rng.uniform(-0.25, 0.25, 3) * np.array([1, 1, 0.5])
        ang = np.linalg.norm(rv)
        axis = rv / max(ang, 1e-9)
        Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                       [-axis[1], axis[0], 0]])
        R = np.eye(3) + np.sin(ang) * Kx + (1 - np.cos(ang)) * Kx @ Kx
        center = np.array([cols * square / 2, rows * square / 2, 0.0])
        C = center + R.T @ np.array([rng.uniform(-0.02, 0.02),
                                     rng.uniform(-0.02, 0.02),
                                     -rng.uniform(0.55, 0.75)])
        images.append(render_chessboard(K, R, -R @ C, rows + 1, cols + 1,
                                        square, h, w))
    return K, images


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--points", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    frames = orbit_sequence(args.frames, args.height, args.width,
                            args.points, seed=args.seed)
    out = write_frames(frames, args.out)
    print(f"Wrote {args.frames} frames to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
