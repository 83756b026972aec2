"""Probe of kernel Q (rotated BRIEF at each keypoint's bin) at the main
path's shapes: the patches, angles and validity that
``orb.detect_and_describe_batch`` hands Q for one batch of 1080p orbit
frames (96 frames at ORB-2000, 192,000 keypoints: the video and the
1000-frame sequence; 50 at ORB-4000, 200,000: BASELINE config 2), each
checked bitwise against the plain version and the 30 bf16 products it
replaced, then timed:

* ``ms``: CUDA events around ``REPS`` calls, the mean of a call;
* ``device_ms``: the summed device time of a call's kernels under the
  profiler;
* ``plain_ms``: the plain version (a gather, a bf16 comparison, the
  int64 packing) on the card;
* ``library_ms``: the form Q replaced, ``brief_from_patches_binned``'s 30
  bf16 cuBLAS products and 30 selects, ``bits_to_packed`` and
  ``bits_to_signed``;
* ``bound_ms``: the patches, angles and validity read once and both
  descriptor layouts written once, at 3.35 TB/s.

    python3 slam_loop_closing_tpu_torch/csrc/probes/probe_brief_bits.py

Needs one CUDA device and ``nvcc``. Prints one JSON object per line; exits
1 if Q is not bitwise.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

import chip_smoke  # noqa: E402
from slam_loop_closing_tpu_torch.config import OrbConfig  # noqa: E402
from slam_loop_closing_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from slam_loop_closing_tpu_torch.ops import descriptors as desc_ops  # noqa: E402
from slam_loop_closing_tpu_torch.ops import orb  # noqa: E402
from slam_loop_closing_tpu_torch.utils.synth_video import orbit_sequence  # noqa: E402

REPS = 50
SHAPES = ((96, 2000), (50, 4000))   # frames, features


def describe_inputs(base: np.ndarray, frames: int, features: int, dev):
    """(patches, angle, valid, pairs) that the front-end hands Q on
    ``frames`` copies of the orbit frames ``base``, each shifted along x."""
    imgs = np.stack([np.roll(base[i % len(base)], 3 * (i // len(base)),
                             axis=1) for i in range(frames)])
    cfg = OrbConfig(num_features=features)
    seen = []
    real = ck.brief_bits

    def spy(*args):
        seen.append(args)
        return real(*args)

    ck.brief_bits = spy
    try:
        orb.detect_and_describe_batch(torch.from_numpy(imgs).to(dev), cfg,
                                      orb.brief_pairs(cfg, dev))
    finally:
        ck.brief_bits = real
    return seen[0]


def main() -> int:
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    base = orbit_sequence(num_frames=4, h=1080, w=1920, num_points=2000,
                          seed=7)
    ok = True
    for frames, features in SHAPES:
        patches, angle, valid, pairs = describe_inputs(base, frames,
                                                       features, dev)
        k = patches.shape[0]
        D = orb.brief_matrices(OrbConfig(), dev)

        def q():
            return ck.brief_bits(patches, angle, valid, pairs)

        def plain():
            return ck.brief_bits_plain(patches, angle, valid, pairs)

        def products():
            bits = orb.brief_from_patches_binned(patches, angle, valid, D)
            return (desc_ops.bits_to_packed(bits),
                    torch.where(valid[:, None],
                                desc_ops.bits_to_signed(bits),
                                0).to(torch.int8))

        got = q()
        same = all(torch.equal(a, b) for ref in (plain(), products())
                   for a, b in zip(got, ref))
        ok &= same
        nbytes = k * (orb.PATCH * orb.PATCH * 4 + 4 + 1
                      + desc_ops.WORDS * 4 + desc_ops.BITS)
        rec = dict(frames=frames, features=features, keypoints=k,
                   valid=int(valid.sum()), bitwise=same,
                   ms=chip_smoke.cuda_ms(q, REPS),
                   device_ms=chip_smoke.device_ms(q, REPS),
                   plain_ms=chip_smoke.cuda_ms(plain, 3),
                   **chip_smoke.bound(nbytes, 0.0, "int8"))
        rec.update(library_ms=chip_smoke.cuda_ms(products, 5),
                   library_device_ms=chip_smoke.device_ms(products, 5))
        rec["gb_per_s"] = nbytes / rec["device_ms"] / 1e6
        print(json.dumps(rec), flush=True)
        del patches, angle, valid, got
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
