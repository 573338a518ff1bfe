"""The readings that the limits of ``limits/<workload>.json`` are set
from: one cell run on many seeds in one process, each a short window, with
the program as configured (the lower readings) or with its own bfloat16
path switched on (``--control``, the upper readings).  Prints one JSON
line a seed with every number compared.  Not part of a benchmark run.

    python3 perfbench/readings.py --workload tv4k.frames --seconds 3 \
        --seeds 11 12 13 [--control]
"""

import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)
    import torch
    import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    ctl = torch.bfloat16 if a.control else None
    for seed in a.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(a.workload, seed, a.seconds, False,
                             control=ctl, log=lambda s: None)
        print(json.dumps(dict(
            workload=a.workload, seed=seed, control=bool(a.control),
            correct=r["correct"], solves=r["attempted"],
            readings=r.get("readings"),
            seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
