"""Run one cell of the port's benchmark once and print its result line.

    python3 loopbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json`` and the port
(``slam_loop_closing_tpu_torch``). Needs a CUDA card: without one, or
without the cards the cell asks for, it exits 1 and prints no result. The
last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``check`` last: each number compared with its limit); the line before it
the check's summary of the window (for the loop-detection cells the share
of loop-band frame pairs that passed the loop rule) and what was judged.
The numbers compared close standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or torch keeps lives in the checkout, at fixed
# paths (the kernels' library goes to build/torch_kernels by the program)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from loopbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.workload["chips"]:
        print(f"{cell.name} needs {cell.workload['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    result, notes = harness.run_cell(cell, args.seed, args.seconds,
                                     bool(args.trace), "cuda:0", T_START)
    print(json.dumps({"summary": notes}), flush=True)
    print(json.dumps(result), flush=True)
    for key, item in result["check"].items():
        print(f"check {key} {item['value']} limit {item['limit']}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
