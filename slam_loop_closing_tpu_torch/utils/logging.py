"""Structured logging: a copy of
:class:`slam_loop_closing_tpu.utils.logging.PipelineLogger`. The reference's
observable behaviour is its stdout prose (per-keyframe acceptance lines
main.cpp:1202-1206, triangulation counters main.cpp:1343-1346, summary
blocks); the logger prints those lines and records every event as JSON."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any


class PipelineLogger:
    """print-compatible logger (the pipelines take any ``log`` callable)
    that also accumulates structured events and can dump them as JSON."""

    def __init__(self, stream=sys.stdout,
                 metrics_path: str | Path | None = None):
        self.stream = stream
        self.metrics_path = Path(metrics_path) if metrics_path else None
        self.events: list[dict[str, Any]] = []
        self._t0 = time.time()
        self._stage_starts: dict[str, float] = {}

    def __call__(self, *args):
        msg = " ".join(str(a) for a in args)
        print(msg, file=self.stream)
        self.event("log", message=msg)

    def event(self, kind: str, **fields):
        self.events.append({"t": round(time.time() - self._t0, 4),
                            "kind": kind, **fields})

    def stage_start(self, name: str):
        self._stage_starts[name] = time.perf_counter()

    def stage_end(self, name: str, **fields):
        dt = time.perf_counter() - self._stage_starts.pop(
            name, time.perf_counter())
        self.event("stage", stage=name, seconds=round(dt, 4), **fields)
        return dt

    def keyframe_accepted(self, frame: int, kf_index: int, matches: int,
                          median_disp: float, inliers: int):
        """Reference acceptance line (main.cpp:1202-1206):
        ``\\nKeyframe K (frame F): disp=Xpx, matches=M, inliers=I (P%)``."""
        pct = 100.0 * inliers / max(matches, 1)
        self(f"\nKeyframe {kf_index} (frame {frame}): "
             f"disp={median_disp:.1f}px, matches={matches}, "
             f"inliers={inliers} ({pct:.0f}%)")

    def triangulation_counters(self, created: int, merged: int,
                               parallax: int, reproj: int, depth: int):
        """Reference counter line (main.cpp:1343-1346); behind-camera
        rejections count as depth (main.cpp:1283-1295)."""
        self(f"  New: {created}, Merged: {merged} "
             f"(rejected: parallax={parallax}, reproj={reproj}, "
             f"depth={depth})")

    def pgo_cost(self, iteration: int, cost: float):
        if iteration % 5 == 0:
            self(f"PGO iteration {iteration}: cost {cost:.6f}")

    def ba_error(self, outer_iter: int, error_px: float):
        self(f"BA outer iteration {outer_iter}: "
             f"mean reprojection error {error_px:.4f} px")

    def save(self):
        if self.metrics_path:
            self.metrics_path.parent.mkdir(parents=True, exist_ok=True)
            self.metrics_path.write_text(json.dumps(self.events, indent=1))
            return self.metrics_path
        return None
