"""The readers of the program's own spans (``loopbench/trace/program.py``
and the ``program_span`` metrics) in tiny traced runs on the CPU, and on
the card."""

import pytest
import torch

from loopbench.tests.tiny import run_tiny, tiny_copy
from loopbench.trace import program

VIDEO, DENSE, BANDED = ("orb2000-video96", "orb4000-seq500-dense",
                        "orb2000-seq1000")
VIDEO_ONLY = {"init_ms", "host_tail_ms"}
DEVICE = {"upload_gb_per_s", "detect_ms_per_frame", "describe_ms_per_frame"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def read_spans(monkeypatch):
    """The spans each run's readers were given, a list a run."""
    got = {}
    collect = program._collect

    def spy(run):
        got[id(run)] = collect(run)
        return got[id(run)]

    monkeypatch.setattr(program, "_collect", spy)
    return got


def test_video_run_reads_host_spans(tiny, read_spans):
    result, _ = run_tiny(*tiny, VIDEO, trace=True)
    metrics = result["metrics"]
    assert VIDEO_ONLY <= set(metrics)
    assert metrics["init_ms"]["unit"] == "ms"
    assert metrics["init_ms"]["value"] > 0
    assert metrics["host_tail_ms"]["value"] > 0
    # a CPU run's spans have no device time: those readers give None
    assert not DEVICE & set(metrics)
    (spans,) = read_spans.values()
    names = {r["name"] for r in spans}
    assert {"slam.loop.init", "slam.orb.brief_matrices",
            "slam.loop.process_video", "slam.orb.detect",
            "slam.matching.counts", "slam.loop.frames"} <= names
    assert all(r["device_ms"] is None for r in spans)


@pytest.mark.parametrize("cell", [DENSE, BANDED])
def test_sequence_run_reads_no_video_metrics(tiny, read_spans, cell):
    result, _ = run_tiny(*tiny, cell, trace=True)
    assert not (VIDEO_ONLY | DEVICE) & set(result["metrics"])
    (spans,) = read_spans.values()
    counts = [r for r in spans if r["name"] == "slam.matching.counts"]
    # one traced call: one counts span, its pairs (t <= q - gap of the 48
    # tiny frames; dense gap 1, banded the loop rule's 30) counted once
    assert len(counts) == 1
    n = 48 - (1 if cell == DENSE else 30)
    assert counts[0]["counters"]["pairs"] == n * (n + 1) // 2


def test_second_run_reads_only_its_own_spans(tiny, read_spans):
    """Two traced runs in one process: the second run's readers see its
    own traced call's spans, none of the first run's."""
    first, _ = run_tiny(*tiny, VIDEO, trace=True, seed=2 ** 31 + 11)
    second, _ = run_tiny(*tiny, VIDEO, trace=True, seed=2 ** 31 + 12)
    runs = list(read_spans.values())
    assert len(runs) == 2
    for spans in runs:
        roots = [r for r in spans if r["parent"] is None]
        # a traced call: a new system (init), then its process_video
        assert [r["name"] for r in roots] == ["slam.loop.init",
                                              "slam.loop.process_video"]
    assert min(r["id"] for r in runs[1]) > max(r["id"] for r in runs[0])
    assert second["metrics"]["init_ms"]["value"] > 0


@pytest.mark.cuda
def test_span_metrics_on_card(tiny):
    """On the card: a traced run reports all five span metrics in the video
    cell and the three device ones in the sequence cells; the program's
    ranges leave the benchmark's own spans their device time (the
    front-end and counts metrics still read) and are not counted as
    device work."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    import time

    from loopbench import harness, spec

    for name in (VIDEO, DENSE, BANDED):
        result, _ = harness.run_cell(spec.cell(name, *tiny), 2 ** 31 + 5,
                                     0.2, True, "cuda", time.perf_counter())
        assert result["correct"] is True
        want = DEVICE | {"frontend_ms_per_frame", "counts_gpairs_per_s"} | (
            VIDEO_ONLY if name == VIDEO else set())
        assert want <= set(result["metrics"])
        assert result["metrics"]["upload_gb_per_s"]["value"] > 0
        ops = [op for op, _ in result["breakdown"]["device_ops"]]
        assert not [op for op in ops if op.startswith("slam.")]
        assert result["device"]["busy_s"] <= result["device"]["window_s"]
