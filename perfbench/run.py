"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer ones), ``device`` and, traced, ``breakdown``; the numbers
compared with the plain reference come last, under ``checks``, and as the
last lines of standard error.  Without a CUDA card, with fewer cards than
the cell asks for, or with JAX or the JAX package loaded, the run exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))      # the checkout: the program
sys.path.insert(0, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import harness
    bench = harness.spec()
    c = harness.cell(bench, a.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    chips = int(c["workload"]["chips"])
    if torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           t_start=T_START, bench=bench)
    res.pop("readings", None)
    # the window's look, then a last one: whatever the check, the trace's
    # reduction or the metrics loaded since would not stop the result
    found = sorted(set(res.pop("blocked_modules"))
                   | set(harness.blocked_modules()))
    if found:
        print(f"[blocked] modules loaded in this process: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
