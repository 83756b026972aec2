"""Synthetic closed-loop video: a camera orbiting inside a textured
cylinder, ray-cast to grayscale frames with numpy.

A copy of :func:`slam_loop_closing_tpu.utils.synth_video.orbit_sequence` and
the render helpers it uses (the tests hold the frames equal). The orbit
spans a full turn, so the final frames see the first frames' wall again: a
correct loop detector MUST join them.
"""

from __future__ import annotations

import numpy as np


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
