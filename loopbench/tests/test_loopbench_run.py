"""Whole runs of the benchmark's cells at a tiny size on the CPU: the
result line's shape, the import guard, a cell and a metric added as files
alone, and the comparison failing on the control and on planted faults."""

import json
import os
import subprocess
import sys

import pytest
import torch

from loopbench.harness import FORBIDDEN
from loopbench.tests.tiny import REPO, run_tiny, tiny_copy

CELLS = ["orb2000-video96", "orb4000-seq500-dense", "orb2000-seq1000"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def test_run_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    proc = subprocess.run(
        [sys.executable, "loopbench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


GUARD = """
import json, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from loopbench.tests.tiny import run_tiny
from loopbench.harness import forbidden_modules
root, base = Path({root!r}), Path({base!r})
out = {{}}
for trace in (False, True):
    result, notes = run_tiny(root, base, {cell!r}, trace)
    out[str(trace)] = result
found = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"results": out, "forbidden": forbidden_modules(),
                  "top_level": found}}))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_loads_no_jax(tiny, cell):
    """A fresh interpreter runs the cell (measured and traced) at a tiny
    size; no module whose top-level name is jax, jaxlib, flax or the JAX
    package is loaded (names compared whole: the port's name starts with
    the JAX package's)."""
    root, base = tiny
    proc = subprocess.run(
        [sys.executable, "-c", GUARD.format(repo=str(REPO), root=str(root),
                                            base=str(base), cell=cell)],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["forbidden"] == []
    assert not set(got["top_level"]) & set(FORBIDDEN)
    assert "slam_loop_closing_tpu_torch" in got["top_level"]
    measured, traced = got["results"]["False"], got["results"]["True"]
    for result in (measured, traced):
        assert result["correct"] is True
        assert list(result)[-1] == "check"
        assert set(result["check"]) == {"frontend_differ", "counts_differ",
                                        "loops_differ"}
        assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"frames_per_s", "setup_s"} <= set(measured["metrics"])
    assert ("video_p95_ms" in measured["metrics"]) == (cell == CELLS[0])
    assert "breakdown" in traced and "busy_s" in traced["device"]


def test_cell_and_metric_added_as_files(tiny, tmp_path):
    """A later change adds a traffic mix, a cell and a per-layer metric by
    adding files (and their entries in BENCHMARK.json); the harness runs
    them with no edit to its code."""
    import shutil

    root = tmp_path
    shutil.copytree(tiny[1], root / "loopbench")
    base = root / "loopbench"
    bench = json.loads((tiny[0] / "BENCHMARK.json").read_text())
    mix = json.loads((base / "traffic" / "orbit-video96.json").read_text())
    mix.update(frames=36, deg_per_frame=9.0)
    (base / "traffic" / "orbit-extra.json").write_text(json.dumps(mix))
    cell = json.loads((base / "workloads" / "orb2000-video96.json")
                      .read_text())
    cell.update(traffic="orbit-extra", why="a cell added as files")
    (base / "workloads" / "orb2000-extra.json").write_text(json.dumps(cell))
    (base / "metrics" / "calls_per_window.py").write_text(
        "def read(run):\n    return float(len(run.call_s))\n")
    bench["workloads"].append({"name": "orb2000-extra",
                               "config": "orb2000-1080p",
                               "traffic": "orbit-extra", "chips": 1,
                               "why": "a cell added as files"})
    bench["per_layer"].append({"name": "calls_per_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "frames_per_s",
                               "workloads": ["orb2000-extra"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, notes = run_tiny(root, base, "orb2000-extra", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["calls_per_window"]["value"] == \
        result["attempted"]
    assert notes["band_pairs"] == result["attempted"] * 21  # 36 frames, gap 30
    result, _ = run_tiny(root, base, "orb2000-video96", trace=True)
    assert "calls_per_window" not in result["metrics"]


KIND = {
    "traffic/flat.py": '''
import torch

def render(traffic, seed, stream, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed + 7919 * stream)
    level = torch.randint(0, 256, (traffic["frames"], 1, 1), generator=g,
                          device=device, dtype=torch.uint8)
    return level.expand(-1, traffic["height"], traffic["width"]).contiguous()
''',
    "entries/brightest.py": '''
from loopbench.answer import Answer

class Entry:
    def __init__(self, config, args, device):
        from slam_loop_closing_tpu_torch.ops import image
        self.image, self.device = image, device

    def __call__(self, frames):
        x = self.image.ship_frames(frames, self.device)
        return Answer(frames=frames.shape[0], loops=[],
                      counts=x.amax((1, 2)).cpu().numpy())

def work(answer, cell):
    return {"frames": answer.frames}
''',
    "checks/brightest.py": '''
import torch
from loopbench.answer import Answer

LIMITS = {"frames_differ": 0}

def brightest(frames, dt):
    return (frames.to(dt) / torch.full((), 255.0, dtype=dt,
                                       device=frames.device)).amax((1, 2))

def judge(answer, frames, cell):
    want = brightest(frames, torch.float32).cpu().numpy()
    return {"frames_differ": int((answer.counts != want).sum()),
            "judged_frames": answer.frames}

def summary(answers, cell):
    return {"frames": sum(a.frames for a in answers)}

class Control:
    def __init__(self, cell, device, like):
        self.device = device

    def __call__(self, frames):
        got = brightest(frames.to(self.device), torch.bfloat16)
        return Answer(frames=frames.shape[0], loops=[],
                      counts=got.float().cpu().numpy())
''',
    "trace/spans/upload.json": '["slam_loop_closing_tpu_torch.ops.image:ship_frames"]',
    "metrics/upload_calls.py": '''
def read(run):
    calls = run.trace.span_calls.get("upload", 0)
    return float(calls) if calls else None
''',
    "configs/flat.json": '{"name": "flat"}',
    "traffic/flat-8.json": json.dumps({"generator": "flat", "frames": 8,
                                       "height": 24, "width": 32,
                                       "pool": 2}),
    "workloads/flat-brightest.json": json.dumps({
        "config": "flat", "traffic": "flat-8", "chips": 1,
        "why": "a new kind of cell", "entry": "brightest", "args": {},
        "check": {"module": "brightest", "calls": 1, "among": 2},
        "trace_calls": 1}),
}


def test_kind_of_cell_added_as_files(tiny, tmp_path):
    """A later change adds a new kind of cell: its traffic generator, its
    entry, its check with its control, a span and a metric, each a file
    found by name (and their entries in BENCHMARK.json); the harness runs
    it with no edit to its code, and its control comes out not correct."""
    import shutil

    root = tmp_path
    shutil.copytree(tiny[1], root / "loopbench")
    base = root / "loopbench"
    for name, text in KIND.items():
        (base / name).write_text(text)
    bench = json.loads((tiny[0] / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "flat", "source": "a test",
                             "file": "loopbench/configs/flat.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "flat-brightest", "config": "flat",
                               "traffic": "flat-8", "chips": 1,
                               "why": "a new kind of cell"})
    bench["per_layer"].append({"name": "upload_calls", "unit": "calls",
                               "better": "lower", "source": "program_span",
                               "layer": "entry", "moves": "frames_per_s",
                               "workloads": ["flat-brightest"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, notes = run_tiny(root, base, "flat-brightest", trace=True)
    assert result["correct"] is True
    assert result["check"] == {"frames_differ": {"value": 0, "limit": 0}}
    assert result["metrics"]["upload_calls"]["value"] == 1.0
    assert notes["frames"] == 8 * result["attempted"]
    result, _ = run_tiny(root, base, "flat-brightest", control=True)
    assert result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    """The reference one precision below the configuration's, in the
    program's place, fails the comparison."""
    result, _ = run_tiny(*tiny, cell, control=True)
    assert result["correct"] is False
    assert result["check"]["frontend_differ"]["value"] > 0


def _stale(module, attr):
    """The function hands back its first answer ever: state unchanged."""
    fn = getattr(module, attr)
    first = []

    def stale(*args, **kwargs):
        if not first:
            first.append(fn(*args, **kwargs))
        return first[0]
    return stale


def _half(module, attr):
    """The front-end describes the first half of its batch; the rest comes
    back with no valid keypoint."""
    fn = getattr(module, attr)

    def half(imgs, *args, **kwargs):
        out = fn(imgs, *args, **kwargs)
        b = imgs.shape[0] // 2
        kp = out.keypoints._replace(valid=out.keypoints.valid.clone())
        kp.valid[b:] = False
        signed = out.signed.clone()
        signed[b:] = 0
        return out._replace(keypoints=kp, signed=signed)
    return half


def _altered(module, attr):
    """One count, the largest, is off by one where it is produced."""
    fn = getattr(module, attr)

    def altered(*args, **kwargs):
        out = fn(*args, **kwargs)
        out = out.clone() if isinstance(out, torch.Tensor) else out.copy()
        flat = out.reshape(-1)
        flat[int(flat.argmax())] += 1
        return out
    return altered


FAULTS = {"stale": ("orb", "detect_and_describe_batch", _stale),
          "half": ("orb", "detect_and_describe_batch", _half),
          "altered_band": ("matching", "banded_pair_counts", _altered),
          "altered_dense": ("matching", "dense_pair_counts_chunked",
                            _altered)}


@pytest.mark.parametrize("fault,cell", [
    ("stale", CELLS[0]), ("stale", CELLS[1]), ("half", CELLS[0]),
    ("half", CELLS[2]), ("altered_band", CELLS[0]),
    ("altered_band", CELLS[2]), ("altered_dense", CELLS[1])])
def test_planted_fault_is_not_correct(tiny, monkeypatch, fault, cell):
    """The timed path broken underneath, the rest of a run as it is: the
    comparison comes out false. (A cell on one chip has no exchange between
    chips to leave out.)"""
    from slam_loop_closing_tpu_torch.ops import matching, orb

    modules = {"orb": orb, "matching": matching}
    mod, attr, make = FAULTS[fault]
    monkeypatch.setattr(modules[mod], attr, make(modules[mod], attr))
    result, _ = run_tiny(*tiny, cell)
    assert result["correct"] is False


@pytest.mark.cuda
def test_tiny_cells_on_card(tiny):
    """On the card: the program's run is correct, the control's is not."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import time

    from loopbench import harness, spec

    for name in CELLS:
        cell = spec.cell(name, *tiny)
        for control in (False, True):
            result, _ = harness.run_cell(cell, 2 ** 31 + 5, 0.2, True,
                                         "cuda", time.perf_counter(),
                                         control=control)
            assert result["correct"] is (not control)
            assert result["device"]["platform"] == "gpu"
