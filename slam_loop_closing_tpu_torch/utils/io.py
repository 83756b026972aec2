"""Loop-closure report writers — copies of
:func:`slam_loop_closing_tpu.utils.io.format_loop_closures` and
:func:`~slam_loop_closing_tpu.utils.io.write_loop_closures_txt` (the tests
hold the outputs equal)."""

from __future__ import annotations

from pathlib import Path
from typing import Iterable


def format_loop_closures(loops: Iterable[dict],
                         total_frames: int | None = None) -> str:
    """Render the loop-closure report byte-identical to the reference's
    example output (README.md:150-166): the ``=== Processing Complete ===``
    header with totals, then a ``Loop Closures Detected:`` section with one
    ``Frame X <-> Frame Y`` block per loop. Similarity uses C++ default
    ostream formatting (6 significant digits, trailing zeros trimmed), i.e.
    Python ``%g``.

    Each loop dict: {current, matched, num_matches, similarity}."""
    loops = list(loops)
    out = ["=== Processing Complete ==="]
    if total_frames is not None:
        out.append(f"Total frames processed: {total_frames}")
    out.append(f"Loop closures detected: {len(loops)}")
    out.append("")
    out.append("Loop Closures Detected:")
    out.append("======================")
    out.append("")
    for lp in loops:
        out.append(f"Frame {lp['current']} <-> Frame {lp['matched']}")
        out.append(f"  Matches: {lp['num_matches']}")
        out.append(f"  Similarity: {lp['similarity']:g}")
        out.append("")
    return "\n".join(out)


def write_loop_closures_txt(path: str | Path, loops: Iterable[dict],
                            total_frames: int | None = None) -> Path:
    """``loop_closures.txt`` in the README's exact format — see
    :func:`format_loop_closures`."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(format_loop_closures(loops, total_frames))
    return p
