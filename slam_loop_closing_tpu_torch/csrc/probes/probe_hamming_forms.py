"""Probe of the tensor-core forms of the Hamming nearest-neighbour inner
loop on the card: builds ``hamming_forms.cu`` (the form of
``csrc/hamming_mma.cuh`` and the forms that lost to it), checks each mma's
raw [64, 64] tile product and each form's d1 against the plain version,
bitwise, times the forms with CUDA events on one 8192 x 8192 pair and on
pair lists over stores of 4,000-, 300- and 1,001-row frames, beside the
library's kernel I (its wrapper, allocation and split pass included), and
times each mma instruction alone and with its epilogue.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_hamming_forms.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops  # noqa: E402
from slam_loop_closing_tpu_torch.ops import matching  # noqa: E402
from slam_loop_closing_tpu_torch.utils import cuda_build  # noqa: E402

FORMS = {0: "s8 m16n8k32",
         1: "b1 m16n8k256 and.popc, one mma, rows in place",
         2: "b1 m16n8k256 and.popc, two mma",
         3: "b1 m16n8k256 and.popc, one mma, rows by parity (the library's)"}
SLAB = {0: 512, 1: 1024, 2: 1024, 3: 1024}
RATE_FORMS = {0: "s8 m16n8k32, accumulating",
              1: "b1 m16n8k256, accumulating",
              2: "b1 m16n8k256, fresh accumulator + two 3-input maxima"}


def build() -> ctypes.CDLL:
    out = cuda_build.BUILD_DIR / "probe_hamming_forms.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I",
           str(cuda_build.CSRC), "-shared", "-o", str(out),
           str(HERE / "hamming_forms.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stdout + proc.stderr, file=sys.stderr)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed")
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_hamming_d1.argtypes = (i, p, p, p, p, p, p, i, i, i, i, p)
    lib.probe_tile_product.argtypes = (i, p, p, p, p)
    lib.probe_mma_rate.argtypes = (i, i, i, p, p)
    lib.probe_knn2.argtypes = (i, p, p, p, p, p, p, p, p, p, i, i, i, p)
    return lib


def words(rng, *shape) -> torch.Tensor:
    w = rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).cuda()


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": card}))
    ok = True

    # the raw tile products against the +-1 matmul of hamming_matrix
    q, t = words(rng, 64, 8), words(rng, 64, 8)
    d = matching.hamming_matrix(
        desc_ops.bits_to_signed(desc_ops.packed_to_bits(q)),
        desc_ops.bits_to_signed(desc_ops.packed_to_bits(t))).to(torch.int32)
    bq = desc_ops.packed_to_bits(q).to(torch.int32)
    bt = desc_ops.packed_to_bits(t).to(torch.int32)
    want = {0: 256 - 2 * d, 1: (bq.float() @ bt.float().T).to(torch.int32)}
    for form in (0, 1):
        out = torch.empty((64, 64), dtype=torch.int32, device="cuda")
        cuda_build.check(lib.probe_tile_product(
            form, q.data_ptr(), t.data_ptr(), out.data_ptr(), stream), "tile")
        torch.cuda.synchronize()
        same = bool(torch.equal(out, want[form]))
        ok &= same
        print(json.dumps({"tile_product": FORMS[form], "equal": same}))

    # each mma alone: the rate the card gives this instruction
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for form, macs in ((0, 16 * 8 * 32), (1, 16 * 8 * 256),
                       (2, 16 * 8 * 256)):
        for per_sm in (1, 2):
            blocks, iters = sms * per_sm, 4096
            sink = torch.empty(blocks * 256, dtype=torch.int32, device="cuda")
            ms = time_ms(lambda: cuda_build.check(lib.probe_mma_rate(
                form, blocks, iters, sink.data_ptr(), stream), "rate"), 5)
            count = blocks * 8 * iters * 8
            print(json.dumps({
                "mma_rate": RATE_FORMS[form], "warps_per_sm": 8 * per_sm,
                "ms": ms, "T_ops_per_s": 2 * macs * count / ms / 1e9,
                "G_row_pairs_per_s": macs * count / 256 / ms / 1e6}))

    def run(form, pq, pt, vt, qidx, tidx, splits):
        p_cnt, n_q = qidx.shape[0], pq.shape[1]
        out = torch.empty((splits, p_cnt, n_q), dtype=torch.int32,
                          device="cuda")
        cuda_build.check(lib.probe_hamming_d1(
            form, pq.data_ptr(), pt.data_ptr(), vt.data_ptr(),
            qidx.data_ptr(), tidx.data_ptr(), out.data_ptr(), p_cnt, n_q,
            pt.shape[1], splits, stream), "probe")
        return out

    def finish(out):
        d1 = out.amin(0)
        return torch.where(d1 < 257, d1, matching.BIG).to(torch.int32)

    cases = []
    # one 8192 x 8192 pair, 3% of the target rows invalid
    pq, pt = words(rng, 1, 8192, 8), words(rng, 1, 8192, 8)
    vt = torch.from_numpy(rng.random((1, 8192)) > 0.03).cuda()
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    cases.append(("8192x8192", pq, pt, vt, zero, zero, 50))
    # 2,048 pairs of a 64-frame store of 4,000 rows, 5% invalid, one frame
    # with no valid row
    store = words(rng, 64, 4000, 8)
    sv = torch.from_numpy(rng.random((64, 4000)) > 0.05).cuda()
    sv[7] = False
    pairs = torch.from_numpy(rng.integers(0, 64, size=(2, 2048),
                                          dtype=np.int32)).cuda()
    cases.append(("2048 pairs x 4000 rows", store, store, sv, pairs[0],
                  pairs[1], 3))
    # ragged sizes
    for n in (300, 1001):
        st = words(rng, 6, n, 8)
        v = torch.from_numpy(rng.random((6, n)) > 0.1).cuda()
        v[2] = False
        pr = torch.from_numpy(rng.integers(0, 6, size=(2, 40),
                                           dtype=np.int32)).cuda()
        cases.append((f"40 pairs x {n} rows", st, st, v, pr[0], pr[1], 20))

    for name, pq, pt, vt, qidx, tidx, reps in cases:
        vt8 = vt.contiguous().view(torch.uint8)
        ref = ck.hamming_d1_pairs_plain(pq, pt, vt, qidx, tidx)
        lib_ms = time_ms(lambda: ck.hamming_d1_pairs(pq, pt, vt, qidx, tidx),
                         reps)
        same = bool(torch.equal(ck.hamming_d1_pairs(pq, pt, vt, qidx, tidx),
                                ref))
        print(json.dumps({"case": name, "form": "library kernel I",
                          "ms": lib_ms, "equal": same}))
        for form in FORMS:
            blocks = qidx.shape[0] * -(-pq.shape[1] // SLAB[form])
            for splits in sorted({1, max(1, min(-(-2 * sms // blocks),
                                                  pt.shape[1] // 128))}):
                got = finish(run(form, pq, pt, vt8, qidx, tidx, splits))
                same = bool(torch.equal(got, ref))
                ok &= same
                ms = time_ms(lambda: run(form, pq, pt, vt8, qidx, tidx,
                                         splits), reps)
                rows = qidx.shape[0] * pq.shape[1] * pt.shape[1]
                print(json.dumps({
                    "case": name, "form": FORMS[form], "splits": splits,
                    "ms": ms, "equal": same,
                    "G_row_pairs_per_s": rows / ms / 1e6,
                    "int8_bound_ms": rows * 512 / 1979e12 * 1e3}))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
