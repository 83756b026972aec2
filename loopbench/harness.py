"""One run of one cell: set-up, the measured window, the traced reading,
the comparison with the reference, the result line.

What differs between kinds of cell is found by name from the cell's files
(``spec.py``): the traffic's generator, the entry (with the yardstick's
shapes of a traced call, its ``work``), the comparison and its control
(``checks/<name>.py``), the spans and the metrics. :func:`run_cell` runs on
whatever device it is given, so the CPU tests can drive a whole run at a
tiny size; ``run.py`` is the command that refuses to run without the card.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from loopbench import spec
from loopbench.trace import profile

FORBIDDEN = ("jax", "jaxlib", "flax", "slam_loop_closing_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (the port's own name starts with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers take it."""

    cell: spec.Cell
    cuda: bool
    setup_s: float
    window_s: float
    call_s: list             # seconds of each call of the window
    call_frames: list        # frames of each call of the window
    trace: profile.Trace | None = None
    work: list = dataclasses.field(default_factory=list)   # traced calls
    counters: dict = dataclasses.field(default_factory=dict)


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def render_pool(cell: spec.Cell, seed: int, device, cuda: bool) -> list:
    """The traffic's ``pool`` sequences of this seed, made on the device by
    the generator the traffic file names (``traffic/<generator>.py``) and
    kept as uint8 in pinned host memory, where a decoder would hand them
    over."""
    traffic = cell.traffic
    generator = spec.load_module("traffic", traffic["generator"], cell.base)
    pool = []
    for k in range(traffic["pool"]):
        frames = generator.render(traffic, seed, k, device)
        host = torch.empty(frames.shape, dtype=torch.uint8, pin_memory=cuda)
        host.copy_(frames)
        pool.append(host)
        del frames
    return pool


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False) -> tuple:
    """One run from ``t_start`` (the process's start, on the
    ``perf_counter`` clock): (the result line's object, ``check`` last;
    notes: the check's summary of the window and what was judged).
    ``control`` puts the comparison's control in the program's place after
    the warm call, in the form of the program's answer."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    w = cell.workload
    entries = spec.load_module("entries", w["entry"], cell.base)
    check = spec.load_module("checks", w["check"]["module"], cell.base)
    marks = [("imports", time.perf_counter())]
    if cuda:
        from slam_loop_closing_tpu_torch.utils import cuda_build
        cuda_build.load()
        marks.append(("kernels", time.perf_counter()))
    pool = render_pool(cell, seed, device, cuda)
    marks.append(("frames", time.perf_counter()))
    if cuda:
        # the renderer's temporaries are the benchmark's, not the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    entry = entries.Entry(cell.config, w["args"], device)
    # one warm call of the cell's own shapes: the window's calls find every
    # kernel loaded and the allocator's blocks in place
    warm = entry(pool[0])
    calls = 1
    if cuda:
        torch.cuda.synchronize()
    marks.append(("warm call", time.perf_counter()))
    if control:
        entry = check.Control(cell, device, like=warm)
    del warm
    setup_s = marks[-1][1] - t_start
    steps = [f"{n} {b - a:.3f}" for (_, a), (n, b)
             in zip([("", t_start)] + marks, marks)]
    _log(f"set-up {setup_s:.3f} s: " + ", ".join(steps))

    rng = np.random.default_rng([seed, 1])
    judged = sorted(int(k) for k in rng.choice(
        w["check"]["among"], size=w["check"]["calls"], replace=False))
    n_traced = w["trace_calls"] if trace else 0
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    spans = profile.Spans(cuda, cell.base / "trace" / "spans")
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        # call 0 is the profiler's warm-up step, calls 1 .. n are recorded
        prof = torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(
                wait=0, warmup=1, active=n_traced, repeat=1))
        prof.start()
    answers, call_s, frames_of = [], [], []
    w0 = time.perf_counter()
    k = 0
    while True:
        frames = pool[calls % len(pool)]
        traced = trace and k <= n_traced
        t0 = time.perf_counter()
        if traced:
            if k == 1:
                spans.start()
            with torch.profiler.record_function(profile.CALL):
                answer = entry(frames)
            if k == n_traced:
                spans.stop()
            prof.step()
            if k == n_traced:
                prof.stop()
        else:
            answer = entry(frames)
        call_s.append(time.perf_counter() - t0)
        # the features of a call are kept while it may still be judged (the
        # last call stands in for a draw past the window's end) or read
        if k >= 1 and k - 1 not in judged and not (trace and k - 1 >= 1
                                                    and k - 1 <= n_traced):
            answers[-1].features = None
        answers.append(answer)
        frames_of.append(calls % len(pool))
        calls += 1
        k += 1
        if time.perf_counter() - w0 >= seconds and k > n_traced:
            break
    window_s = time.perf_counter() - w0
    q = np.percentile(np.asarray(call_s) * 1e3, [0, 5, 50, 95, 100])
    _log(f"window {window_s:.3f} s, {len(call_s)} calls; call ms min "
         f"{q[0]:.2f} p5 {q[1]:.2f} p50 {q[2]:.2f} p95 {q[3]:.2f} max "
         f"{q[4]:.2f} (call {int(np.argmax(call_s))}), first "
         f"{call_s[0] * 1e3:.2f}")
    run = Run(cell=cell, cuda=cuda, setup_s=setup_s, window_s=window_s,
              call_s=call_s, call_frames=[a.frames for a in answers])
    if cuda:
        run.counters["window_peak_bytes"] = torch.cuda.max_memory_allocated()
    if trace:
        run.work = [entries.work(a, cell) for a in answers[1:n_traced + 1]]
        run.trace = profile.analyse(prof.events(), spans)
        _log(f"trace: span device s {run.trace.span_device_s}, span event s "
             f"{run.trace.span_event_s}, span calls {run.trace.span_calls}, "
             f"busy {run.trace.busy_s} s of {run.trace.window_s} s")
        with profile.counting_syncs(cuda) as box:
            entry(pool[calls % len(pool)])
        run.counters["syncs_per_call"] = box["syncs"]
    memory_peak = max(peak_setup, run.counters.get("window_peak_bytes", 0))
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules the port must not load: {found}")

    summary = check.summary(answers, cell)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m["name"], cell.base).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the judged calls: drawn before the window; a draw past its end is
    # the last call
    judged = sorted({min(j, len(answers) - 1) for j in judged})
    kept = {j: (answers[j], pool[frames_of[j]]) for j in judged}
    del entry, answers, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    totals = {}
    for j, (answer, frames) in kept.items():
        for key, value in check.judge(answer, frames.to(device),
                                      cell).items():
            totals[key] = totals.get(key, 0) + value
    correct = all(totals[key] <= lim for key, lim in check.LIMITS.items())
    seen = {key: v for key, v in totals.items() if key not in check.LIMITS}
    _log(f"reference check {time.perf_counter() - t_check:.3f} s: "
         f"{len(kept)} calls, "
         + ", ".join(f"{key} {v}" for key, v in seen.items()))

    result = {"correct": bool(correct), "attempted": len(call_s), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(device)
                                  if cuda else "cpu"),
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["check"] = {key: {"value": totals[key], "limit": lim}
                       for key, lim in check.LIMITS.items()}
    notes = {**summary, "judged_calls": sorted(kept), **seen,
             "window_calls": len(call_s), "window_s": window_s}
    return result, notes
