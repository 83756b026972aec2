"""Run the comparison's control on the card: the plain reference put in the
program's place one precision below the configuration's (the ``Control``
of the cell's ``checks/<name>.py``), through a whole run of a cell at its
own size, for several seeds. Each seed prints one JSON line with the numbers compared
and whether the run came out correct (it must not).

    python3 loopbench/control.py --workload <name> --seeds 11,12,13 \\
        --seconds 2

The window only has to finish the judged calls; the benchmark's own runs
never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)

    import torch

    from loopbench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cell = spec.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result, notes = harness.run_cell(cell, seed, args.seconds, False,
                                         "cuda:0", t, control=True)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": result["correct"],
                          "check": result["check"], "notes": notes,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
