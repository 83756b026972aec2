"""The benchmark's data, found by name.

``BENCHMARK.json`` at the checkout's root names the cells and metrics; each
name leads to a file of its own under this folder:

* a configuration: ``configs/<name>.json``;
* a cell: ``workloads/<name>.json`` (its configuration, traffic, entry and
  its arguments, its check and the calls it judges, the calls it traces,
  chips and why);
* a traffic mix: ``traffic/<name>.json``, made by the generator it names,
  ``traffic/<generator>.py`` (``render(traffic, seed, stream, device)``);
* an entry (the program's path a cell drives): ``entries/<name>.py``, with
  ``Entry(config, args, device)``, whose calls take a frame stack and
  return an ``answer.Answer``, and ``work(answer, cell)``, the shapes of a
  traced call for the yardstick;
* a check: ``checks/<name>.py``, with ``LIMITS``, ``judge(answer, frames,
  cell)``, ``summary(answers, cell)`` and the control, ``Control(cell,
  device, like)``;
* a span: ``trace/spans/<name>.json``, the program's functions it wraps;
* a metric: ``metrics/<name>.py``, a reader with ``read(run) -> float |
  None``.

Adding a cell, a traffic mix, a kind of cell, a span or a metric is adding
files.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(kind: str, name: str, base: Path = HERE):
    """``<base>/<kind>/<name>.py`` as a module of its own."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"loopbench_{kind}_{name}".replace("-", "_").replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One cell, with everything its name leads to."""

    name: str
    base: Path              # the folder its files were found in
    workload: dict          # workloads/<name>.json
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    end_to_end: list        # BENCHMARK.json metrics this cell reports
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A per-layer metric is read in the cells its ``workloads`` lists, or
    without that key in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def cell(name: str, root: Path = ROOT, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises where the cell's
    files disagree with it."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    workload = load_json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise SystemExit(f"workloads/{name}.json: {key} "
                             f"{workload[key]!r} differs from BENCHMARK.json's "
                             f"{entry[key]!r}")
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = load_json(root / files[entry["config"]])
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, base, workload, config, traffic, e2e, per_layer)
