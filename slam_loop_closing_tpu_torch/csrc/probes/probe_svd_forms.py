"""Probe of kernel S's forms on the card (the small float64 Jacobi SVDs of
the two-view geometry), each checked bitwise against the library's kernel
and timed in turns, with CUDA events (``ms``, the mean of a call,
host-paced at small batches) and under the profiler (``device_ms``):

* the library's kernel (a group of n // 2 lanes a matrix, a lane a pair
  of each round, 2 warps a block) through its wrapper;
* variants of the library's source, built beside it (``VARIANTS``): 1 and
  4 warps a block, ptxas's default register budget
  (``__launch_bounds__`` without its second argument: fewer registers, a
  small spill), that budget at 3 x 3 without U only, and the lane's index
  in 64 bits at 3 x 3, each launched through the same wrapper (a variant
  that does not build is reported and left out);
* the form it replaced (``svd_small_thread.cu``: a thread a matrix), as
  it is and with the library's ``__launch_bounds__`` second argument;

at the shapes one RANSAC of the live pair and of 32 and 256 pairs gives
the kernel (``chip_smoke.record_svd_inputs``: 3x3 at 1, 32 and 256 with
and without U, 9x9 at 1, 32 and 256, the live pair's 2,000 4x4 DLT
systems) and at 100,000 random 9x9 matrices; the 3 x 3 shapes in
``ROUNDS_3X3`` turns, the others in two. Also prints:

* each form's registers, stack and spills from ptxas;
* ``svd_chain.cu``: in one thread, by ``clock64()`` and the global timer,
  the latency of a rotation's parameter chain, of one pair's dependent
  arithmetic alone (its columns in registers: the sums, the test, the
  chain, the rotation) and of one whole pair as the kernel runs it (its
  columns loaded from shared memory and stored back) at n = 3, 4 and 9;
* each shape's sweeps (``svd_jacobi_plain``), its bound by the float64
  rate (``chip_smoke.svd_ops``) and its critical path: the most sweeps of
  a matrix x the rounds of a sweep x one pair's dependent arithmetic (the
  work the bits fix; beside it the same with the kernel's whole pair);
* the wrapper's host microseconds by part on a [1, 9, 9], a [3, 3] (with
  U) and a [32, 9, 9] input, beside the wrapper as it was (its input and
  outputs always reshaped) and that wrapper with its three outputs carved
  from one allocation.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_svd_forms.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line; exits
1 if a form is not bitwise.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

import chip_smoke  # noqa: E402
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_loop_closing_tpu_torch.utils import cuda_build  # noqa: E402

REPS, HOST_REPS = 50, 500
DEVICE_REPS = (100, 20)        # profiled calls a turn: up to 2,000, beyond
ROUNDS_3X3, ROUNDS = 4, 2      # turns of every form at 3 x 3, elsewhere
ITERS = 4096                   # repetitions a latency is timed over
RANDOM_BATCH = 100_000
LIBRARY = "lane (library)"
THREAD = "thread (the form replaced)"
# name: (source, (text, its replacement)), each built beside the library
VARIANTS = {
    "lane, 1 warp a block": ("svd_small.cu", (
        "constexpr int kThreads = 64;", "constexpr int kThreads = 32;")),
    "lane, 4 warps a block": ("svd_small.cu", (
        "constexpr int kThreads = 64;", "constexpr int kThreads = 128;")),
    "lane, ptxas's default registers": ("svd_small.cu", (
        "__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads)")),
    "lane, 64-bit index at 3 x 3": ("svd_small.cu", (
        "std::conditional<P == 1, int, long long>",
        "std::conditional<P == 1, long long, long long>")),
    "lane, ptxas's default registers at 3 x 3 without U": ("svd_small.cu", (
        "__launch_bounds__(kThreads, 1)",
        "__launch_bounds__(kThreads, kU || lanes(N) > 1 ? 1 : 0)")),
    "thread, __launch_bounds__(128, 1)": ("probes/svd_small_thread.cu", (
        "__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 1)")),
}


def _nvcc(src: Path, so: Path) -> subprocess.Popen:
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
           str(cuda_build.CSRC), "-shared", "-o", str(so), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build() -> dict:
    """Every form's library, compiled at once, its ptxas lines printed:
    the library's source as it is, its :data:`VARIANTS`, the thread form,
    the latency kernels."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    edited = {}
    for name, (rel, edit) in VARIANTS.items():
        src = (cuda_build.CSRC / rel).read_text()
        if edit[0] not in src:
            raise RuntimeError(f"{edit[0]!r} not in {rel}")
        edited[name] = cuda_build.BUILD_DIR / f"probe_svd_{len(edited)}.cu"
        edited[name].write_text(src.replace(*edit))
    sources = {LIBRARY: cuda_build.CSRC / "svd_small.cu", **edited,
               THREAD: HERE / "svd_small_thread.cu",
               "latencies": HERE / "svd_chain.cu"}
    jobs = {}
    for name, cu in sources.items():
        so = cuda_build.BUILD_DIR / f"probe_svd_form_{len(jobs)}.so"
        jobs[name] = (so, _nvcc(cu, so))
    p, i = ctypes.c_void_p, ctypes.c_int
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0 and name in VARIANTS:
            print(json.dumps({"build": name, "failed": log[-2000:]}),
                  flush=True)
            continue
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-4000:]}")
        print(json.dumps({"build": name, "ptxas": [
            line.strip() for line in log.splitlines()
            if "entry function" in line or "registers" in line
            or "spill" in line]}), flush=True)
        lib = ctypes.CDLL(str(so))
        if name.startswith("thread"):
            fn = lib.slam_svd_small_thread
            fn.argtypes = (p, p, p, p, i, i, p)
        elif name == "latencies":
            fn = lib.slam_svd_chain
            fn.argtypes = (p, p, p, i, i, i, p)
        else:
            fn = lib.slam_svd_small
            fn.argtypes = (p, p, p, p, i, i, p)
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


@contextlib.contextmanager
def using(fn):
    """The wrapper launches ``fn`` as ``slam_svd_small``."""
    load = cuda_build.load
    cuda_build.load = lambda: types.SimpleNamespace(slam_svd_small=fn)
    try:
        yield
    finally:
        cuda_build.load = load


def outputs(flat: torch.Tensor, compute_u: bool):
    """U (or None), S and Vh for ``flat`` [B, n, n]: three ``new_empty``,
    as the wrapper allocates them."""
    b, n = flat.shape[0], flat.shape[-1]
    return (flat.new_empty(b, 3, 3) if compute_u else None,
            flat.new_empty(b, n), flat.new_empty(b, n, n))


def sliced_outputs(flat: torch.Tensor, compute_u: bool):
    """The same from one ``new_empty``, sliced into views."""
    b, n = flat.shape[0], flat.shape[-1]
    nu = 9 * b * compute_u
    buf = flat.new_empty(nu + b * n + b * n * n)
    return (buf[:nu].view(b, 3, 3) if compute_u else None,
            buf[nu:nu + b * n].view(b, n), buf[nu + b * n:].view(b, n, n))


def strided_outputs(flat: torch.Tensor, compute_u: bool):
    """The same from one ``new_empty``, by ``as_strided``."""
    b, n = flat.shape[0], flat.shape[-1]
    nu = 9 * b * compute_u
    buf = flat.new_empty(nu + b * n + b * n * n)
    return (buf.as_strided((b, 3, 3), (9, 3, 1)) if compute_u else None,
            buf.as_strided((b, n), (n, 1), nu),
            buf.as_strided((b, n, n), (n * n, n, 1), nu + b * n))


def thread_form(fn, a: torch.Tensor, compute_u: bool):
    """The thread form's launch on ``a`` [B, n, n]."""
    n, b = a.shape[-1], a.shape[0]
    u, s, vh = outputs(a, compute_u)
    cuda_build.check(fn(a.data_ptr(), None if u is None else u.data_ptr(),
                        s.data_ptr(), vh.data_ptr(), n, b,
                        torch._C._cuda_getCurrentRawStream(a.get_device())),
                     "svd_small_thread")
    return u, s, vh


def checks(a: torch.Tensor, compute_u: bool) -> bool:
    """The wrapper's argument checks alone."""
    ck._require(a.dim() >= 2 and a.shape[-1] == a.shape[-2]
                and a.shape[-1] in ck.SVD_SIZES, "n")
    ck._require(a.dtype == torch.float32, "float32")
    ck._require(not compute_u or a.shape[-1] == 3, "U")
    return ck._on_cuda(a)


def svd_small_before(a: torch.Tensor, compute_u: bool = False, carve=outputs):
    """``cuda_kernels.svd_small`` on a CUDA tensor as it was: its input
    always reshaped and made contiguous, its outputs from ``carve`` and
    reshaped to the input's leading axes."""
    checks(a, compute_u)
    n = a.shape[-1]
    lead = a.shape[:-2]
    flat = a.reshape(-1, n, n).contiguous()
    batch = flat.shape[0]
    u, s, vh = carve(flat, compute_u)
    ck._launch("svd_small", flat.device, flat.data_ptr(),
               None if u is None else u.data_ptr(), s.data_ptr(),
               vh.data_ptr(), n, batch)
    return (None if u is None else u.reshape(*lead, 3, 3),
            s.reshape(*lead, n), vh.reshape(*lead, n, n))


def host_breakdown(a: torch.Tensor, compute_u: bool, lib_fn) -> dict:
    """Host microseconds a call (``chip_smoke.host_us``) of the wrapper, of
    the wrapper as it was (and with one output allocation), and of the
    wrapper's parts; the launches with a batch of 0 reach the C entry and
    launch nothing."""
    n = a.shape[-1]
    flat = a.reshape(-1, n, n).contiguous()
    b = flat.shape[0]
    u, s, vh = outputs(flat, compute_u)
    up = None if u is None else u.data_ptr()
    sp, vp, ap = s.data_ptr(), vh.data_ptr(), flat.data_ptr()
    stream = torch._C._cuda_getCurrentRawStream(a.get_device())
    lead = a.shape[:-2]
    parts = {
        "svd_small": lambda: ck.svd_small(a, compute_u),
        "svd_small as it was (reshapes always)": lambda: svd_small_before(
            a, compute_u),
        "svd_small as it was, one allocation sliced": lambda:
            svd_small_before(a, compute_u, sliced_outputs),
        "svd_small as it was, one allocation by as_strided": lambda:
            svd_small_before(a, compute_u, strided_outputs),
        "checks": lambda: checks(a, compute_u),
        "reshape and contiguous": lambda: a.reshape(-1, n, n).contiguous(),
        "three new_empty": lambda: outputs(flat, compute_u),
        "one new_empty, sliced": lambda: sliced_outputs(flat, compute_u),
        "one new_empty, as_strided": lambda: strided_outputs(flat,
                                                             compute_u),
        "_launch, nothing launched": lambda: ck._launch(
            "svd_small", flat.device, ap, up, sp, vp, n, 0),
        "C entry, nothing launched": lambda: lib_fn(
            ap, up, sp, vp, n, 0, stream),
        "output reshapes": lambda: (s.reshape(*lead, n),
                                    vh.reshape(*lead, n, n)),
    }
    return {k: chip_smoke.host_us(fn, HOST_REPS) for k, fn in parts.items()}


def latencies(fn, dev) -> dict:
    """Nanoseconds and cycles of one repetition of each piece of
    ``svd_chain.cu`` (the second of two runs), and the chain's, a pair's
    arithmetic's and a whole pair's latency less their loop's overhead."""
    rng = np.random.default_rng(9)
    sets = rng.normal(size=(16, 36))
    x, y = sets[0, :9], sets[0, 9:18]
    inp = torch.tensor(np.concatenate([sets.ravel(), [
        float(x @ x), float(y @ y), float(x @ y)]]), dtype=torch.float64,
        device=dev)
    out = torch.empty(1, dtype=torch.float64, device=dev)
    times = torch.empty(3, dtype=torch.int64, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(out.get_device())
    got = {}
    for name, which, n in (("carry", 0, 9), ("chain", 1, 9),
                           ("copy", 3, 9), ("pair 9", 2, 9),
                           ("pair 4", 2, 4), ("pair 3", 2, 3),
                           ("arithmetic 9", 4, 9), ("arithmetic 4", 4, 4),
                           ("arithmetic 3", 4, 3)):
        for _ in range(2):
            cuda_build.check(fn(inp.data_ptr(), out.data_ptr(),
                                times.data_ptr(), ITERS, which, n, stream),
                             "svd_chain")
            torch.cuda.synchronize()
        cycles, ns, rot = times.tolist()
        got[name] = dict(cycles=cycles / ITERS, ns=ns / ITERS,
                         rotated=rot / ITERS if which in (2, 4) else None)
    res = {"raw": got, "clock_ghz": got["pair 9"]["cycles"]
           / got["pair 9"]["ns"]}
    res["chain_ns"] = got["chain"]["ns"] - got["carry"]["ns"]
    res["chain_cycles"] = got["chain"]["cycles"] - got["carry"]["cycles"]
    for n in (3, 4, 9):
        res[f"pair_ns {n}"] = got[f"pair {n}"]["ns"] - got["copy"]["ns"]
        res[f"pair_cycles {n}"] = (got[f"pair {n}"]["cycles"]
                                   - got["copy"]["cycles"])
        res[f"arithmetic_ns {n}"] = (got[f"arithmetic {n}"]["ns"]
                                     - got["carry"]["ns"])
        res[f"arithmetic_cycles {n}"] = (got[f"arithmetic {n}"]["cycles"]
                                         - got["carry"]["cycles"])
    return res


def shapes(dev) -> dict:
    """label: (matrices on the card, compute_u): the RANSAC shapes (a 3 x 3
    batch recorded without U is also run with U, and the other way round)
    and 100,000 random 9 x 9 matrices over four decades of scale."""
    inputs, calls, syncs = chip_smoke.record_svd_inputs(
        dev, np.random.default_rng(16))
    print(json.dumps({"ransac_calls": {str(k): v for k, v in calls.items()},
                      "ransac_host_syncs": syncs}), flush=True)
    out = {}
    for (n, b, cu), a in sorted(inputs.items()):
        for u in ((False, True) if n == 3 else (False,)):
            out.setdefault(f"{n}x{n} x {b}{' with U' if u else ''}",
                           (a.reshape(b, n, n).contiguous(), u))
    rng = np.random.default_rng(17)
    a = rng.normal(size=(RANDOM_BATCH, 9, 9)) * 10.0 ** rng.uniform(
        -2, 2, (RANDOM_BATCH, 1, 1))
    out[f"9x9 x {RANDOM_BATCH} random"] = (
        torch.from_numpy(a.astype(np.float32)).to(dev), False)
    return out


def same(got, ref) -> bool:
    return all((g is None and r is None) or torch.equal(
        g.view(torch.int32), r.view(torch.int32)) for g, r in zip(got, ref))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    fns = build()
    lat = latencies(fns["latencies"], dev)
    print(json.dumps({"latencies": lat}), flush=True)
    ok = True
    for label, (a, cu) in shapes(dev).items():
        n, b = a.shape[-1], a.shape[0]
        ref = ck.svd_small(a, cu)
        host = a.cpu() if b <= 2000 else a    # the plain form on the CPU
        plain = same(ref, [None if x is None else x.to(dev)
                           for x in ck.svd_small_plain(host, cu)])
        ok &= plain
        _, sweeps, rotations = ck.svd_jacobi_plain(host)
        sweeps, rotations = sweeps.cpu(), rotations.cpu()
        rounds = n - 1 + (n & 1)
        steps = int(sweeps.max()) * rounds
        critical = steps * lat[f"arithmetic_ns {n}"] * 1e-6
        dfma = chip_smoke.bound_pipes(
            b * (2 * n * n + n + 9 * cu) * 4,
            {"dfma": chip_smoke.svd_ops(n, sweeps, rotations)})
        print(json.dumps(dict(
            shape=label, sweeps_mean=float(sweeps.double().mean()),
            sweeps_max=int(sweeps.max()), rounds=rounds,
            bitwise_plain=plain, critical_path_ms=critical,
            whole_pairs_ms=steps * lat[f"pair_ns {n}"] * 1e-6,
            rate_bound_ms=dfma["bound_ms"], rate_bound_by=dfma["bound_by"])),
            flush=True)
        forms = {LIBRARY: lambda: ck.svd_small(a, cu)}
        for name, fn in fns.items():
            if name.startswith("thread"):
                forms[name] = lambda fn=fn: thread_form(fn, a, cu)
            elif name in VARIANTS:
                forms[name] = lambda fn=fn: _in(fn, a, cu)
        reps = DEVICE_REPS[b > 2000]
        for rnd in range(ROUNDS_3X3 if n == 3 else ROUNDS):
            for form, call in (forms.items() if rnd % 2 == 0
                               else reversed(list(forms.items()))):
                bitwise = same(call(), ref)
                ok &= bitwise
                print(json.dumps(dict(
                    shape=label, form=form, round=rnd, bitwise=bitwise,
                    ms=chip_smoke.cuda_ms(call, REPS),
                    device_ms=chip_smoke.device_ms(call, reps))),
                    flush=True)
    lib = cuda_build.load().slam_svd_small
    rng = np.random.default_rng(3)
    for shape, cu in (((1, 9, 9), False), ((3, 3), True),
                      ((32, 9, 9), False)):
        a = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            dev)
        for rnd in range(3):
            print(json.dumps(dict(
                shape=f"{list(shape)}{' with U' if cu else ''}", round=rnd,
                host_us=host_breakdown(a, cu, lib))), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


def _in(fn, a, cu):
    with using(fn):
        return ck.svd_small(a, cu)


if __name__ == "__main__":
    sys.exit(main())
