"""Probe of the designs of kernels E (motion support) and F (Hamming top-2
with index) on the card, each form checked bitwise against the plain
version and timed with CUDA events (``ms``: a call's share of back-to-back
calls, host included) and under the profiler (``device_ms``):

* kernel E at its main paths' shapes (the live set of 2,000, batch-1 sets,
  the ORB and SIFT verification chunks) with the target split forced to
  each of several counts, beside the count the library picks;
* kernel F's epilogue forms of ``hamming_forms.cu`` (keyed at 1, 2, 4 and
  8 query tiles a warp, branchy at 2; no target split) at the keyframe
  step's one pair and the loop search's 300 pairs of ``chip_smoke``'s
  check store, beside the library's kernel F;
* the library's kernel F at the keyframe step's pair with the target split
  forced to each of several counts.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_support_knn2.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line; exits
1 if a form is not bitwise.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))
sys.path.insert(0, str(HERE))

import chip_smoke  # noqa: E402
import probe_hamming_forms  # noqa: E402
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck  # noqa: E402

E_SHAPES = ((1, 2000), (1, 4000), (1, 1000), (1, 1536), (32, 1000),
            (32, 1536))
E_SPLITS = (1, 2, 4, 5, 6, 7, 8, 9, 10, 12, 16, 24, 31, 62)
F_FORMS = {0: "keyed, 1 tile a warp", 1: "keyed, 2 tiles (the library's)",
           2: "keyed, 4 tiles", 3: "keyed, 8 tiles", 4: "branchy, 2 tiles"}
F_SPLITS = (1, 2, 4, 8, 15)


def forced(splits: int):
    """Replace ``ck._target_splits`` (the split count of kernels E, F, G
    and I) by a constant."""
    ck._target_splits = lambda *args: splits


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ok = True

    target_splits = ck._target_splits
    rng = np.random.default_rng(1)
    radii = chip_smoke.sfm_support_radii()
    for batch, n in E_SHAPES:
        args = chip_smoke.support_set(rng, batch, n, dev, *radii)[0]
        ref = ck.motion_support_plain(*args)
        chosen = target_splits(batch * -(-n // ck._MS_SLAB),
                               ck._MS_BLOCKS_PER_SM, n, ck._MS_MIN_SPLIT, sms)
        for s in sorted(set(E_SPLITS + (chosen,))):
            if s > max(1, n // 32):
                continue
            forced(s)
            same = bool(torch.equal(ck.motion_support(*args), ref))
            ok &= same
            print(json.dumps({
                "kernel": "E", "shape": [batch, n], "splits": s,
                "library_choice": s == chosen, "equal": same,
                "ms": chip_smoke.cuda_ms(lambda: ck.motion_support(*args),
                                         50),
                "device_ms": chip_smoke.device_ms(
                    lambda: ck.motion_support(*args), 50)}), flush=True)
    ck._target_splits = target_splits

    lib = probe_hamming_forms.build()
    stream = torch.cuda.current_stream().cuda_stream
    packed, vt, _, pairs = chip_smoke.knn2_store(np.random.default_rng(2),
                                                 dev)
    k = chip_smoke.SFM_STORE
    loop_q, loop_t = (t.contiguous() for t in torch.tensor(
        pairs, dtype=torch.int32, device=dev).T)
    one_q, one_t = (torch.tensor([f], dtype=torch.int32, device=dev)
                    for f in (k - 1, k - 2))
    vt8 = vt.view(torch.uint8)
    n = packed.shape[1]

    def form_run(form, qi, ti):
        out = [torch.empty((qi.shape[0], n), dtype=torch.int32, device=dev)
               for _ in range(3)]
        ck.cuda_build.check(lib.probe_knn2(
            form, packed.data_ptr(), packed.data_ptr(), vt8.data_ptr(),
            vt8.data_ptr(), qi.data_ptr(), ti.data_ptr(),
            *(o.data_ptr() for o in out), qi.shape[0], n, n, stream), "knn2")
        return out

    for case, (qi, ti) in (("keyframe step, 1 pair", (one_q, one_t)),
                           ("loop search, 300 pairs", (loop_q, loop_t))):
        ref = ck.hamming_knn2_plain(packed, vt, packed, vt, qi, ti)
        got = ck.hamming_knn2(packed, vt, packed, vt, qi, ti)
        same = all(torch.equal(g, r) for g, r in zip(got, ref))
        ok &= same
        print(json.dumps({
            "kernel": "F", "case": case, "form": "library", "equal": same,
            "splits": target_splits(
                qi.shape[0] * -(-n // ck._KNN2_SLAB), ck._KNN2_BLOCKS_PER_SM,
                n, ck._KNN2_MIN_SPLIT_ROWS, sms),
            "ms": chip_smoke.cuda_ms(lambda: ck.hamming_knn2(
                packed, vt, packed, vt, qi, ti), 50),
            "device_ms": chip_smoke.device_ms(lambda: ck.hamming_knn2(
                packed, vt, packed, vt, qi, ti), 50)}), flush=True)
        for form, name in F_FORMS.items():
            same = all(torch.equal(g, r)
                       for g, r in zip(form_run(form, qi, ti), ref))
            ok &= same
            print(json.dumps({
                "kernel": "F", "case": case, "form": name, "splits": 1,
                "equal": same,
                "ms": chip_smoke.cuda_ms(lambda: form_run(form, qi, ti), 50),
                "device_ms": chip_smoke.device_ms(
                    lambda: form_run(form, qi, ti), 50)}), flush=True)
        if qi.shape[0] == 1:
            for s in F_SPLITS:
                forced(s)
                same = all(torch.equal(g, r) for g, r in zip(
                    ck.hamming_knn2(packed, vt, packed, vt, qi, ti), ref))
                ok &= same
                print(json.dumps({
                    "kernel": "F", "case": case, "form": "library",
                    "splits": s, "equal": same, "ms": chip_smoke.cuda_ms(
                        lambda: ck.hamming_knn2(packed, vt, packed, vt, qi,
                                                ti), 50),
                    "device_ms": chip_smoke.device_ms(
                        lambda: ck.hamming_knn2(packed, vt, packed, vt, qi,
                                                ti), 50)}), flush=True)
            ck._target_splits = target_splits
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
