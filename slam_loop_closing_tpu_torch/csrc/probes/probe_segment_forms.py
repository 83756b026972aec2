"""Probe of kernel N's forms on the card (fixed-order segment sums), each
checked bitwise against the plain version and timed with CUDA events
(``ms``, the mean of a call, host-paced at these sizes) and under the
profiler (``device_ms``), in every call the smoke makes at the Version-B ORB
run's backend indices (BA's cameras and points after the first BA; the
dense PGO's blocks) and at BASELINE config 5's edge index
(``chip_smoke.N_SHAPE_CALLS``):

* the library's kernel (a thread a chain up to ``SHORT_ROWS`` rows, a
  block a longer segment through a cp.async ring; the sums of a call in one
  launch);
* other thresholds between the two forms (``SHORT_ROWS`` when the plan
  is built: 4, 16, 32; 0 puts every non-empty segment in the long form,
  2^30 every segment in the short form), and other caps on the long
  form's blocks (``LONG_BLOCKS_PER_SM``: 1 and 8);
* variants of its source built beside it (rows a short chain loads at
  once, the ring's stage size, blocks an SM);
* the form it replaced (``segment_sum_warp.cu``: a warp a segment, one
  sum a launch, the two-source sums concatenated first), and
  ``index_add_`` of the same rows (float atomics).

Each variant is the library's source with constants edited, built into
``build/torch_kernels/probe_segment_*.so`` and called through the
library's wrapper (``cuda_build.load`` swapped). Also prints each index's
segment lengths, the byte bound of each call, and at BA's camera sums and
config 5's CG product the host microseconds of the wrapper and of its
parts, beside ``index_add_``'s.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_segment_forms.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line; exits
1 if a form is not bitwise.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import math
import multiprocessing
import subprocess
import sys
import types
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

import chip_smoke  # noqa: E402
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_loop_closing_tpu_torch.utils import cuda_build  # noqa: E402

REPS = 20
THRESHOLDS = (4, 16, 32, 0, 2 ** 30)
LONG_BLOCKS_PER_SM = (1, 8)
# source edits of csrc/segment_sum.cu by form
VARIANTS = {
    "batch 2": (("kBatch = 4;", "kBatch = 2;"),),
    "batch 8": (("kBatch = 4;", "kBatch = 8;"),),
    "stage 5120 floats": (("kStageFloats = 2560;", "kStageFloats = 5120;"),),
    "6 blocks an SM": (("kBlocksPerSm = 8;", "kBlocksPerSm = 6;"),),
    "4 blocks an SM": (("kBlocksPerSm = 8;", "kBlocksPerSm = 4;"),),
}
# the C entry as it was before its arguments were packed: one ctypes
# argument each (appended to the source; timed by host_breakdown only)
SEPARATE_ARGS = """
extern "C" int slam_segment_sum_args(
    const void* order, const void* offsets, const void* long_ids,
    const void* long_count, int n, int short_rows, int long_blocks, int count,
    const void* first0, const void* second0, int split0, int d0, void* out0,
    const void* first1, const void* second1, int split1, int d1, void* out1,
    const void* first2, const void* second2, int split2, int d2, void* out2,
    void* stream) {
  const long long a[] = {
      (long long)order, (long long)offsets, (long long)long_ids,
      (long long)long_count, n, short_rows, long_blocks, count,
      (long long)first0, (long long)second0, split0, d0, (long long)out0,
      (long long)first1, (long long)second1, split1, d1, (long long)out1,
      (long long)first2, (long long)second2, split2, d2, (long long)out2};
  return slam_segment_sum(a, stream);
}
"""


def _nvcc(src: Path, so: Path) -> subprocess.Popen:
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared", "-o",
           str(so), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_variants() -> tuple[dict, ctypes.CDLL]:
    """Each variant's entry point (its source edited and built with the
    library's flags into the build directory, the ptxas lines printed) and
    the warp form's, all compiled at once."""
    src = (cuda_build.CSRC / "segment_sum.cu").read_text()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = cuda_build.BUILD_DIR / f"probe_segment_{name.replace(' ', '_')}.cu"
        cu.write_text(text)
        jobs[name] = (cu.with_suffix(".so"), _nvcc(cu, cu.with_suffix(".so")))
    cu = cuda_build.BUILD_DIR / "probe_segment_separate_args.cu"
    cu.write_text(src + SEPARATE_ARGS)
    jobs["separate arguments"] = (cu.with_suffix(".so"),
                                  _nvcc(cu, cu.with_suffix(".so")))
    warp = cuda_build.BUILD_DIR / "probe_segment_warp.so"
    jobs["warp"] = (warp, _nvcc(HERE / "segment_sum_warp.cu", warp))
    lib = cuda_build.load()
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        print(json.dumps({"build": name, "ptxas": [
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]}), flush=True)
        cdll = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "warp":
            fn = cdll.slam_segment_sum_warp
            fn.argtypes, fn.restype = (p, p, p, p, i, i, p), ctypes.c_int
            out[name] = fn
            continue
        if name == "separate arguments":
            fn = cdll.slam_segment_sum_args
            fn.argtypes = (p, p, p, p, i, i, i, i) + (p, p, i, i, p) * 3 + (p,)
            fn.restype = ctypes.c_int
            out[name] = fn
            continue
        fn, ref = cdll.slam_segment_sum, lib.slam_segment_sum
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        out[name] = types.SimpleNamespace(slam_segment_sum=fn)
    return out, lib


@contextlib.contextmanager
def using(ns):
    """The wrapper runs ``ns``'s entry points."""
    load = cuda_build.load
    cuda_build.load = lambda: ns
    try:
        yield
    finally:
        cuda_build.load = load


@contextlib.contextmanager
def constant(name: str, value):
    """``cuda_kernels.<name>`` set to ``value`` (the plan's thresholds are
    read when a plan is built)."""
    old = getattr(ck, name)
    setattr(ck, name, value)
    try:
        yield
    finally:
        setattr(ck, name, old)


def warp_sums(fn, plan, sums) -> list:
    """The warp form: one launch a sum, a two-source sum concatenated."""
    outs = []
    for s in sums:
        rows = (torch.cat(s) if isinstance(s, tuple) else s).contiguous()
        d = math.prod(rows.shape[1:])
        out = torch.empty((plan.n, *rows.shape[1:]), device=rows.device)
        cuda_build.check(fn(rows.data_ptr(), plan.order.data_ptr(),
                            plan.offsets.data_ptr(), out.data_ptr(), plan.n,
                            d, torch.cuda.current_stream().cuda_stream),
                         "segment_sum_warp")
        outs.append(out)
    return outs


def backend_shapes(dev) -> dict:
    """``chip_smoke``'s kernel N indices: the Version-B ORB run's backend
    after its first BA, and BASELINE config 5's edge index."""
    with concurrent.futures.ProcessPoolExecutor(
            chip_smoke.RENDER_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        frames, = chip_smoke.render_orbits(pool, [(
            chip_smoke.SFM_FRAMES, chip_smoke.SFM_H, chip_smoke.SFM_W, 400,
            0)])
    pipe = chip_smoke.sfm_pipeline(chip_smoke.sfm_config(), frames.shape[0],
                                   dev)
    state, _ = pipe.run_frontend_and_keyframes_scan(
        torch.from_numpy(frames).to(dev))
    loop = pipe.find_loop(state)
    state = pipe.optimize(state, loop)
    state, _ = pipe.bundle_adjust(state)
    shapes = chip_smoke.backend_indices(pipe, state, loop)
    params, g = chip_smoke.pgo_config5_graph(dev)
    shapes["PGO config 5"] = (torch.cat([g.e_from, g.e_to]), params.shape[0],
                              g.e_from.shape[0])
    return shapes


def _launch_stream_object(name, device, *args) -> None:
    """``cuda_kernels._launch`` with the stream's handle read from a
    ``torch.cuda.current_stream`` object, as it was before."""
    fn = getattr(cuda_build.load(), f"slam_{name}")
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        raise RuntimeError("the probe runs on the current device")
    cuda_build.check(fn(*args, torch.cuda.current_stream(index).cuda_stream),
                     name)
    ck.LAUNCHES[name] += 1


def host_breakdown(plan, rows: torch.Tensor, index: torch.Tensor,
                   lib, separate) -> dict:
    """Host microseconds a call (``chip_smoke.host_us``: 200 calls
    enqueued, one synchronize) of the wrapper with one sum and its parts on
    ``rows``: the wrapper; the wrapper with the stream read from a
    ``torch.cuda.Stream``; its output's allocation; the packing of the
    arguments; the C entry called with n = 0 (the arguments passed, nothing
    launched), packed and as separate ctypes arguments (``separate``);
    ``_launch`` the same way; the stream's handle both ways; ``torch.zeros``
    and ``index_add_``, the call it replaced."""
    dev = rows.device
    d = math.prod(rows.shape[1:])
    out = rows.new_empty(plan.n, *rows.shape[1:])
    ptr, e = rows.data_ptr(), rows.shape[0]
    head = [plan.order.data_ptr(), plan.offsets.data_ptr(),
            plan.long_ids.data_ptr(), plan.long_count.data_ptr(), 0,
            plan.short_rows, plan.long_blocks, 1, ptr, ptr, e, d,
            out.data_ptr()]
    block = ck.SEGMENT_ARGS[1].pack(*head)
    flat = (*head, *(0, 0, 0, 0, 0) * (ck.MAX_SUMS - 1))
    stream = torch.cuda.current_stream().cuda_stream
    i = torch.cuda.current_device()
    keep = (index >= 0) & (index < plan.n)
    idx, kept = index[keep].long(), rows[keep]

    def stream_object():
        launch = ck._launch
        ck._launch = _launch_stream_object
        try:
            return ck.segment_sums(plan, rows)
        finally:
            ck._launch = launch

    parts = {
        "segment_sum": lambda: ck.segment_sums(plan, rows),
        "segment_sum, stream from a torch.cuda.Stream": stream_object,
        "output allocation": lambda: rows.new_empty(plan.n,
                                                    *rows.shape[1:]),
        "packing the arguments": lambda: ck.SEGMENT_ARGS[1].pack(*head),
        "C entry, packed, nothing launched": lambda: lib.slam_segment_sum(
            block, stream),
        "C entry, 24 separate arguments, nothing launched": lambda: separate(
            *flat, stream),
        "_launch, nothing launched": lambda: ck._launch(
            "segment_sum", dev, block),
        "stream: torch.cuda.current_stream(i).cuda_stream": lambda:
            torch.cuda.current_stream(i).cuda_stream,
        "stream: torch._C._cuda_getCurrentRawStream(i)": lambda:
            torch._C._cuda_getCurrentRawStream(i),
        "torch.zeros + index_add_": lambda: torch.zeros(
            (plan.n, *rows.shape[1:]), device=dev).index_add_(0, idx, kept),
        "torch.zeros": lambda: torch.zeros((plan.n, *rows.shape[1:]),
                                           device=dev),
    }
    return {k: chip_smoke.host_us(fn, 200) for k, fn in parts.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    variants, lib = build_variants()
    shapes = backend_shapes(dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    ok = True
    for name, (index, n, split) in shapes.items():
        plan = ck.segment_plan(index, n)
        lengths = (plan.offsets[1:] - plan.offsets[:-1]).cpu()
        e = index.shape[0]
        print(json.dumps(dict(
            index=name, rows=e, segments=n, in_segments=int(lengths.sum()),
            longest=int(lengths.max()), mean=float(lengths.float().mean()),
            longer_than={t: int((lengths > t).sum())
                         for t in (2, 4, 8, 16, 32, 64, 128)})), flush=True)
        plans = {}
        for const, values in (("SHORT_ROWS", THRESHOLDS),
                              ("LONG_BLOCKS_PER_SM", LONG_BLOCKS_PER_SM)):
            for v in values:
                with constant(const, v):
                    plans[f"{const} {v}"] = ck.segment_plan(index, n)
        keep = (index >= 0) & (index < n)
        idx = index[keep].long()
        for widths in chip_smoke.N_SHAPE_CALLS[name]:
            vals = [torch.randn((e, *w), generator=gen, device=dev)
                    for w in widths]
            sums = [v if split is None else (v[:split], v[split:])
                    for v in vals]
            refs = [ck.segment_sum_plain(v, plan) for v in vals]
            d = [math.prod(w) for w in widths]
            kept = [v[keep] for v in vals]
            forms = {"library": (None, plan),
                     **{f: (None, p) for f, p in plans.items()},
                     **{v: (variants[v], plan) for v in VARIANTS}}
            calls = {f: (lambda ns=ns, pl=pl: _in(ns, pl, sums))
                     for f, (ns, pl) in forms.items()}
            calls["warp (the form replaced)"] = (
                lambda: warp_sums(variants["warp"], plan, sums))
            calls["index_add_"] = lambda: [
                torch.zeros((n, *v.shape[1:]), device=dev).index_add_(
                    0, idx, v) for v in kept]
            bound = chip_smoke.bound_pipes(
                4 * (e * sum(d) + e + n + 1 + n * sum(d)),
                {"ffma": e * sum(d)})["bound_ms"]
            if name in ("BA cameras", "PGO config 5") and len(d) == 1:
                rows = vals[0]
                for rnd in range(3):
                    print(json.dumps(dict(
                        index=name, widths=d, round=rnd,
                        host_us=host_breakdown(
                            plan, rows, index, lib,
                            variants["separate arguments"]))), flush=True)
            for form, call in calls.items():
                same = None
                if form != "index_add_":
                    same = all(torch.equal(g.view(torch.int32),
                                           r.view(torch.int32))
                               for g, r in zip(call(), refs))
                    ok &= same
                print(json.dumps(dict(
                    index=name, widths=d, form=form, bitwise=same,
                    ms=chip_smoke.cuda_ms(call, REPS),
                    device_ms=chip_smoke.device_ms(call, REPS),
                    bound_ms=bound)), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


def _in(ns, plan, sums):
    if ns is None:
        return ck.segment_sums(plan, *sums)
    with using(ns):
        return ck.segment_sums(plan, *sums)


if __name__ == "__main__":
    sys.exit(main())
