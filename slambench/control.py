"""Readings that set the correctness limits: the port's numbers and the
control's, over many seeds of one cell, in one process.

    python -m slambench.control --workload <name> --seeds 1 2 3 ... \
        [--seconds S] [--out chiprun_out/control_<name>.jsonl]

Each seed runs the cell as the benchmark does (set-up, a window of
``--seconds``) and prints one JSON line: the seed, the window's frames and
``failed``, the compared numbers of the port and of the control (the
references put in the port's place one precision lower, ``check.py``).
The limits in ``limits/<cell>.json`` lie between the largest of the port's
readings and the smallest of the control's (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from slambench import cell as cell_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = cell_mod.find_cell(args.workload)
    out = args.out or os.path.join("chiprun_out",
                                   f"control_{args.workload}.jsonl")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "a") as f:
        for seed in args.seeds:
            r = cell_mod.run_cell(cell, seed, args.seconds, False,
                                  device="cuda", control=True)
            line = {"workload": args.workload, "seed": seed,
                    "frames": r["frames"], "failed": r["failed"],
                    "fps": r["frames"] / r["window_s"],
                    "program": r["numbers"], "control": r["control"]}
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
