"""A copy of the benchmark shrunk to a size the CPU runs in seconds:
160 x 120 frames, 40- and 48-frame sequences, ORB-200, one traced call,
the same files otherwise."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_copy(tmp: Path) -> tuple[Path, Path]:
    """(root, base) of a shrunk copy of ``BENCHMARK.json`` and
    ``loopbench/`` under ``tmp``."""
    base = tmp / "loopbench"
    shutil.copytree(REPO / "loopbench", base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for f in (base / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(height=120, width=160, pool=2,
                 frames=40 if t["frames"] < 200 else 48)
        t["overlay"]["glyphs"] = 0
        f.write_text(json.dumps(t))
    for f in (base / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["orb"]["num_features"] = 200
        f.write_text(json.dumps(c))
    for f in (base / "workloads").glob("*.json"):
        w = json.loads(f.read_text())
        w.update(trace_calls=1)
        w["check"].update(among=2)
        if "batch" in w["args"]:
            w["args"]["batch"] = 16
        if "pairs_per_call" in w["args"]:
            w["args"]["pairs_per_call"] = 300
        f.write_text(json.dumps(w))
    return tmp, base


def run_tiny(root: Path, base: Path, name: str, trace: bool = False,
             control: bool = False, seed: int = 2 ** 31 + 11):
    """One run of cell ``name`` of a shrunk copy on the CPU: (result,
    notes). Two CPU threads: these tensors are small."""
    import time

    import torch

    from loopbench import harness, spec

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run_cell(spec.cell(name, root, base), seed, 0.2,
                                trace, "cpu", time.perf_counter(),
                                control=control)
    finally:
        torch.set_num_threads(threads)
