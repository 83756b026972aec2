"""The port's span primitive (``utils/profiling.py``): nothing recorded and
no range opened off the profiler, records while a session records, their
clock against the profiler's, counters, ``spans.json`` beside
``trace.json``, and what an off span costs."""

import json
import statistics
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from slam_loop_closing_tpu_torch.utils import profiling


def _new(before: int) -> list:
    return profiling.spans()[before:]


def test_off_span_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"range {name} opened off the profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    before = len(profiling.spans())
    assert profiling.annotate("slam.a") is profiling.annotate("slam.b", n=1)
    with profiling.annotate("slam.a"):
        profiling.count("n", 2)
        torch.ones(4).sum()
    assert profiling.spans()[before:] == []


def test_profiler_warmup_step_records_nothing():
    """Under the benchmark's schedule (a warm-up step, then recorded
    steps), the warm-up step's spans are neither kept nor in the trace."""
    before = len(profiling.spans())
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=2, repeat=1))
    prof.start()
    for step in range(3):
        with profiling.annotate(f"slam.test.step{step}"):
            torch.ones(4).sum()
        prof.step()
    prof.stop()
    names = [r["name"] for r in _new(before)]
    assert names == ["slam.test.step1", "slam.test.step2"]
    events = {e.name for e in prof.events()}
    assert {"slam.test.step1", "slam.test.step2"} <= events
    assert "slam.test.step0" not in events


def test_nested_spans_carry_parent_and_request():
    before = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("slam.test.call", frames=3):
            with profiling.annotate("slam.test.stage"):
                with profiling.annotate("slam.test.inner"):
                    torch.ones(4).sum()
            with profiling.annotate("slam.test.other"):
                pass
        with profiling.annotate("slam.test.next"):
            pass
    recs = {r["name"]: r for r in _new(before)}
    call, stage = recs["slam.test.call"], recs["slam.test.stage"]
    assert call["parent"] is None and call["request"] == call["id"]
    assert stage["parent"] == call["id"]
    assert recs["slam.test.inner"]["parent"] == stage["id"]
    assert recs["slam.test.other"]["parent"] == call["id"]
    assert {r["request"] for n, r in recs.items() if n != "slam.test.next"} \
        == {call["id"]}
    nxt = recs["slam.test.next"]
    assert nxt["parent"] is None and nxt["request"] == nxt["id"] != call["id"]
    assert call["counters"] == {"frames": 3}
    for r in recs.values():
        assert r["end_ns"] >= r["start_ns"]
        assert r["host_ms"] == (r["end_ns"] - r["start_ns"]) / 1e6
        assert r["device_ms"] is None   # no CUDA in this process
    inner = recs["slam.test.inner"]
    assert call["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= call["end_ns"]


def test_span_clock_is_the_profilers():
    """Each record's start and end lie within a median of 50 us of its
    ``record_function`` range on the profiler's clock (``trace_start_ns``
    plus the range's time in us), over 150 spans."""
    before = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(150):
            with profiling.annotate(f"slam.test.s{i}"):
                torch.ones(16).sum()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e.time_range for e in prof.events()}
    recs = _new(before)
    assert len(recs) == 150
    start = [abs(r["start_ns"] - (t0 + ranges[r["name"]].start * 1e3))
             for r in recs]
    end = [abs(r["end_ns"] - (t0 + ranges[r["name"]].end * 1e3))
           for r in recs]
    assert statistics.median(start) < 50e3
    assert statistics.median(end) < 50e3


def test_count_lands_on_the_innermost_span():
    before = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("slam.test.outer", bytes=3):
            with profiling.annotate("slam.test.inner"):
                profiling.count("n", 2)
                profiling.count("n")
            profiling.count("bytes", 1)
    recs = {r["name"]: r["counters"] for r in _new(before)}
    assert recs == {"slam.test.inner": {"n": 3},
                    "slam.test.outer": {"bytes": 4}}


def test_span_inside_its_own_name_is_folded():
    """A stage whose functions call each other (the pair counts) is one
    span: the inner span of the same name adds no record, and its counts
    land on the outer one."""
    before = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("slam.test.counts", pairs=10):
            with profiling.annotate("slam.test.counts", pairs=10):
                profiling.count("launches")
    (rec,) = _new(before)
    assert rec["counters"] == {"pairs": 10, "launches": 1}
    assert [e.name for e in prof.events()].count("slam.test.counts") == 1


def test_trace_writes_spans_beside_the_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("slam.test.before"):
            pass
    with profiling.trace(tmp_path / "t"):
        with profiling.annotate("slam.test.call", frames=1):
            torch.ones(4).sum()
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    recs = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert [r["name"] for r in recs] == ["slam.test.call"]
    assert set(recs[0]) == {"name", "id", "parent", "request", "start_ns",
                            "end_ns", "host_ms", "device_ms", "counters"}
    assert recs[0]["counters"] == {"frames": 1}
    assert profiling.spans() == recs


def test_off_span_costs_under_2_us():
    """Off the profiler a span is a flag read and a shared no-op: the mean
    of 100,000 (loose, for the tier's parallel workers)."""
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with profiling.annotate("slam.test.off"):
            pass
    mean_us = (time.perf_counter() - t0) / n * 1e6
    assert mean_us < 2.0, mean_us


@pytest.mark.cuda
def test_span_device_time_on_card():
    """On the card each span gets the current stream's time between its
    entry and exit, resolved when the records are read."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    x = torch.randn(4096, 4096, device="cuda")
    before = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profiling.annotate("slam.test.matmul"):
            for _ in range(8):
                x = x @ x / 64.0
    (rec,) = _new(before)
    assert rec["device_ms"] > 0
