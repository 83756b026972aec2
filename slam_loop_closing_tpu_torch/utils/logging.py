"""The pipelines' log lines: the prose of
:class:`slam_loop_closing_tpu.utils.logging.PipelineLogger`. The reference's
observable behaviour is its stdout prose (per-keyframe acceptance lines
main.cpp:1202-1206, triangulation counters main.cpp:1343-1346, summary
blocks); the logger prints those lines. Stage timing and traces are
:mod:`.profiling`'s."""

from __future__ import annotations

import sys


class PipelineLogger:
    """print-compatible logger (the pipelines take any ``log`` callable)
    with the reference's line formats."""

    def __init__(self, stream=sys.stdout):
        self.stream = stream

    def __call__(self, *args):
        print(" ".join(str(a) for a in args), file=self.stream)

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
