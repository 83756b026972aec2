"""Probe of kernel A's grid mode (the grid top-K's cell maxima in A's
epilogue) at the main path's shape: the four pyramid levels (1080x1920,
900x1600, 750x1333, 625x1111) of 96 1080p orbit frames, ORB-2000 at
``grid_cell`` 8 and border 19, each level's budget as
``orb.detect_and_describe_batch`` gives it. Two forms of a level's
detection, checked to select the same keypoints bitwise, then timed:

* ``before``: kernel A writing the suppressed score map
  (``fast_score_nms_blur``), then ``fast.select_topk_grid`` (the border
  mask, the keyed full-map passes, the cell maxima, the ranking);
* ``after``: A's grid mode writing a key and a response a cell
  (``fast_grid_keys_blur``), then ``fast.rank_grid_keys`` (the stable sort
  of the cell keys and the gathers).

Each form and each of its parts (``a_ms``, ``topk_ms``; ``grid_ms``,
``rank_ms``) by CUDA events around ``REPS`` calls (the mean of a call), and
each form's summed kernel time under the profiler (``device_ms``). Bounds
at 3.35 TB/s: A reads the frame and writes the score and the blur, 12 B a
pixel; the grid mode writes the blur and 8 B a cell, 8.125 B a pixel at
cell 8.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_fast_grid.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line (a
level, then the four levels summed); exits 1 if the forms differ.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

import chip_smoke  # noqa: E402
from slam_loop_closing_tpu_torch.config import OrbConfig  # noqa: E402
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_loop_closing_tpu_torch.ops import fast  # noqa: E402
from slam_loop_closing_tpu_torch.ops import image as image_ops  # noqa: E402
from slam_loop_closing_tpu_torch.ops import orb  # noqa: E402
from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence  # noqa: E402

REPS = 20
FRAMES = 96
CELL, BORDER = 8, 19


def orbit_levels(dev) -> list:
    """The four levels of ``FRAMES`` orbit frames: 4 rendered 1080p frames,
    each copy shifted along x, as ``probe_brief_bits.py`` builds them."""
    base = orbit_sequence(num_frames=4, h=1080, w=1920, num_points=2000,
                          seed=7)
    imgs = np.stack([np.roll(base[i % 4], 3 * (i // 4), axis=1)
                     for i in range(FRAMES)])
    return [lv.contiguous() for lv in image_ops.pyramid(
        torch.from_numpy(imgs).to(dev), 4, 1.2)]


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    cfg = OrbConfig(num_features=2000, grid_cell=CELL)
    thr = cfg.fast_threshold / 255.0
    budgets = orb._level_budgets(cfg.num_features, cfg.num_levels,
                                 cfg.scale_factor)
    ok = True
    total = {}
    for level, (lv, k) in enumerate(zip(orbit_levels(dev), budgets)):
        def a():
            return ck.fast_score_nms_blur(lv, thr)

        score = a()[0]

        def topk():
            return fast.select_topk_grid(score, k, BORDER, CELL)

        def before():
            s, blur = a()
            return fast.select_topk_grid(s, k, BORDER, CELL) + (blur,)

        def grid():
            return ck.fast_grid_keys_blur(lv, thr, BORDER, CELL)

        keys, cell_resp, _ = grid()

        def rank():
            return fast.rank_grid_keys(keys, cell_resp, k, CELL)

        def after():
            kk, rr, blur = grid()
            return fast.rank_grid_keys(kk, rr, k, CELL) + (blur,)

        same = all(torch.equal(x, y) for x, y in zip(before(), after()))
        ok &= same
        b, h, w = lv.shape
        px, cells = b * h * w, b * -(-h // CELL) * -(-w // CELL)
        rec = dict(level=level, shape=[b, h, w], budget=k, bitwise=same,
                   valid=int(after()[2].sum()),
                   before_ms=chip_smoke.cuda_ms(before, REPS),
                   after_ms=chip_smoke.cuda_ms(after, REPS),
                   a_ms=chip_smoke.cuda_ms(a, REPS),
                   topk_ms=chip_smoke.cuda_ms(topk, REPS),
                   grid_ms=chip_smoke.cuda_ms(grid, REPS),
                   rank_ms=chip_smoke.cuda_ms(rank, REPS),
                   before_device_ms=chip_smoke.device_ms(before, REPS),
                   after_device_ms=chip_smoke.device_ms(after, REPS),
                   a_bound_ms=chip_smoke.bound(12 * px, 0.0,
                                               "ffma")["bound_ms"],
                   grid_bound_ms=chip_smoke.bound(8 * px + 8 * cells, 0.0,
                                                  "ffma")["bound_ms"],
                   grid_bytes_per_px=(8 * px + 8 * cells) / px)
        print(json.dumps(rec), flush=True)
        for key, v in rec.items():
            if key.endswith("_ms"):
                total[key] = total.get(key, 0.0) + v
        del score, keys, cell_resp
        torch.cuda.empty_cache()
    print(json.dumps({"levels": "all", "frames": FRAMES, **total}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
