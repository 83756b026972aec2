"""Orbit video rendered on the device from a seed.

A PyTorch copy of ``slam_loop_closing_tpu_torch.utils.synth_video.
render_cylinder_trajectory``: a camera inside a textured cylinder (axis y)
at orbit angle ``theta`` and height ``y``, looking along the +theta tangent,
every pixel ray-cast to the wall. Two things differ, both so that the loop
rule behaves on these frames as on real video:

* The wall's texture is procedural and continuous (value noise on seeded
  lattices, sampled where each ray lands) in place of a small texel array
  magnified with nearest-neighbour lookups. Magnified texels render as
  blocks of 10 px or more whose step corners give near-identical
  descriptors anywhere, so every pair of frames passed the loop rule.
* A burnt-in box (a camera's time stamp, as dash-cam and phone video carry)
  sits at the same place in every frame. Its corners match across any two
  frames at distance 0, which holds ``min d1`` near 0 and the count rule's
  threshold at its floor of 30, as the generic near-duplicate corners of
  real frames do; unrelated places then fail the rule and revisits pass.

Everything is drawn from ``torch.Generator`` objects on the device seeded
from the run's seed, so a seed gives the same frames on a device.
"""

from __future__ import annotations

import math

import torch

_MIX = 0x9E3779B97F4A7C15   # odd 64-bit constant mixing a seed and a stream


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of run ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * _MIX + stream * 0xBF58476D1CE4E5B9 + 1)
                  % (1 << 63))
    return g


class Wall:
    """The cylinder wall's texture: lattices of uniform values in [-1, 1],
    one per noise layer, wrapped around the circumference."""

    def __init__(self, traffic: dict, g: torch.Generator, device):
        self.radius = float(traffic["wall_radius"])
        self.height = float(traffic["wall_height"])
        circ = 2.0 * math.pi * self.radius
        self.layers = {}
        for name, wavelength in traffic["texture"]["wavelengths"].items():
            cols = max(4, round(circ / wavelength))
            rows = max(4, math.ceil(self.height / wavelength) + 3)
            values = torch.rand((rows, cols), generator=g, device=device)
            self.layers[name] = (circ / cols, values * 2.0 - 1.0)
        self.mix = traffic["texture"]["mix"]

    def noise(self, name: str, s: torch.Tensor, v: torch.Tensor):
        """Value noise of layer ``name`` at arc length ``s`` and height
        ``v`` (smoothstep-weighted bilinear interpolation)."""
        step, lat = self.layers[name]
        rows, cols = lat.shape
        x = s / step
        yv = torch.clamp((v + 0.5 * self.height) / step + 1.0, 0.0,
                         rows - 1.001)
        x0 = torch.floor(x)
        y0 = torch.floor(yv)
        fx = x - x0
        fy = yv - y0
        fx = fx * fx * (3.0 - 2.0 * fx)
        fy = fy * fy * (3.0 - 2.0 * fy)
        xi = torch.remainder(x0.long(), cols)
        xj = torch.remainder(xi + 1, cols)
        yi = y0.long()
        a = lat[yi, xi]
        b = lat[yi, xj]
        c = lat[yi + 1, xi]
        d = lat[yi + 1, xj]
        return ((1 - fy) * ((1 - fx) * a + fx * b)
                + fy * ((1 - fx) * c + fx * d))

    def shade(self, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Intensity in [0, 1]: weighted smooth octaves, plus two layers of
        thresholded noise that give real intensity steps (FAST corners)
        with irregular, place-specific outlines."""
        m = self.mix
        smooth = sum(w * self.noise(n, s, v) for n, w in m["smooth"].items())
        smooth = 0.5 + 0.5 * smooth / sum(m["smooth"].values())
        out = m["base"] + m["smooth_gain"] * smooth
        for step in m["steps"]:
            edge = (self.noise(step["fine"], s, v)
                    > step["offset"] + step["coarse_gain"]
                    * self.noise(step["coarse"], s, v))
            out = out + step["gain"] * edge.to(out.dtype)
        return torch.clamp(out, 0.0, 1.0)


def overlay(traffic: dict, h: int, w: int, device) -> tuple:
    """(mask, values) of the burnt-in box: [h, w] bool and float32. The
    box holds a row of glyphs, each a block of ``glyph`` px split into
    quadrants of fixed tones; it is the same in every frame of every run."""
    box = traffic["overlay"]
    mask = torch.zeros((h, w), dtype=torch.bool, device=device)
    values = torch.zeros((h, w), dtype=torch.float32, device=device)
    if not box["glyphs"]:
        return mask, values
    gs, gap = box["glyph"], box["gap"]
    x0, y0 = box["x"], box["y"]
    bw = box["glyphs"] * (gs + gap) + gap
    bh = gs + 2 * gap
    mask[y0:y0 + bh, x0:x0 + bw] = True
    values[y0:y0 + bh, x0:x0 + bw] = box["ground"]
    half = gs // 2
    for k, tones in enumerate(box["tones"][:box["glyphs"]]):
        gx = x0 + gap + k * (gs + gap)
        gy = y0 + gap
        for q, tone in enumerate(tones):
            qy, qx = divmod(q, 2)
            values[gy + qy * half:gy + (qy + 1) * half,
                   gx + qx * half:gx + (qx + 1) * half] = tone
    return mask, values


def trajectory(traffic: dict, start: float) -> tuple:
    """(thetas, ys) of the traffic's path: a constant angular step from
    ``start`` and a piecewise-linear height over the frames."""
    n = traffic["frames"]
    step = math.radians(traffic["deg_per_frame"])
    thetas = [start + step * i for i in range(n)]
    knots = traffic["height_knots"]
    ys = []
    for i in range(n):
        t = i / max(1, n - 1)
        for (t0, y0), (t1, y1) in zip(knots, knots[1:]):
            if t0 <= t <= t1:
                ys.append(y0 + (y1 - y0) * (t - t0) / max(t1 - t0, 1e-12))
                break
    return thetas, ys


def render(traffic: dict, seed: int, stream: int, device,
           chunk: int = 32) -> torch.Tensor:
    """Sequence ``stream`` of run ``seed``: [frames, height, width] uint8 on
    ``device``. The wall's texture and the start angle come from the
    stream's generator, so two streams show different places."""
    g = generator(seed, stream, device)
    wall = Wall(traffic, g, device)
    start = float(torch.rand((), generator=g, device=device)) * 2 * math.pi
    thetas, ys = trajectory(traffic, start)
    return draw(traffic, wall, thetas, ys, device, chunk)


def draw(traffic: dict, wall: Wall, thetas: list, ys: list, device,
         chunk: int = 32) -> torch.Tensor:
    """[len(thetas), height, width] uint8 frames of ``wall`` seen from the
    orbit angles ``thetas`` at heights ``ys``."""
    h, w = traffic["height"], traffic["width"]
    r = float(traffic["orbit_radius"])
    f = traffic["focal_frac"] * w
    vs, us = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    dx = (us - w / 2) / f
    dy = (vs - h / 2) / f
    mask, values = overlay(traffic, h, w, device)
    out = torch.empty((len(thetas), h, w), dtype=torch.uint8, device=device)
    for s0 in range(0, len(thetas), chunk):
        th = torch.tensor(thetas[s0:s0 + chunk], dtype=torch.float32,
                          device=device)[:, None, None]
        cy = torch.tensor(ys[s0:s0 + chunk], dtype=torch.float32,
                          device=device)[:, None, None]
        cx, cz = r * torch.cos(th), r * torch.sin(th)
        sn, cs = torch.sin(th), torch.cos(th)
        # camera axes: z = (-sin, 0, cos), x = up x z = (cos, 0, sin),
        # y = z x x = (0, 1, 0); a ray's world direction is R^T dir_cam
        rx = dx * cs - sn
        ry = dy
        rz = dx * sn + cs
        a = rx * rx + rz * rz
        b = 2.0 * (cx * rx + cz * rz)
        c = cx * cx + cz * cz - wall.radius ** 2
        t_hit = (-b + torch.sqrt(torch.clamp_min(b * b - 4 * a * c, 0.0))) \
            / torch.clamp_min(2 * a, 1e-12)
        px = cx + t_hit * rx
        py = cy + t_hit * ry
        pz = cz + t_hit * rz
        arc = (torch.atan2(pz, px) + math.pi) * wall.radius
        img = wall.shade(arc, py)
        img = torch.where(mask, values, img)
        out[s0:s0 + chunk] = (img * 255.0).to(torch.uint8)
    return out
