"""Run one cell of the port's benchmark and print its result line.

    python -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a machine with the cards
the cell asks for. Prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit; the same comparisons are
the last lines of standard error. Exits non-zero, with no result, without
enough CUDA cards, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import time


def _process_age_s() -> float:
    """Seconds since this process started, from the kernel's records."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE_AT_IMPORT = _process_age_s()
_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the program and of its libraries at a fixed path inside
# the checkout, so that only a checkout's first run builds
CACHE = os.path.join(REPO, ".slambench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam_2_ros_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def result_line(cell, run, setup_s, trace, device_kind, readers):
    """The result's JSON object, keys in the contract's order."""
    ctx = dict(run["ctx"], setup_s=setup_s)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = readers(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": run["memory_peak_bytes"]}
    line = {"correct": run["correct"], "attempted": run["attempted"],
            "failed": run["failed"], "metrics": metrics, "device": device}
    t = run["ctx"]["trace"]
    if trace:
        from slambench import profile
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": profile.top(t["device_ops"]),
                             "idle_gaps": profile.top(t["idle_gaps"])}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in run["checks"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)

    import torch
    from slambench import cell as cell_mod, check

    cell = cell_mod.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"slambench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"cuda available: {torch.cuda.is_available()}, cards: "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    opened = {}

    def on_open():
        opened["setup_s"] = (_AGE_AT_IMPORT + time.perf_counter()
                             - _T_IMPORT)
    run = cell_mod.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device="cuda", on_open=on_open,
                            log=lambda *a: print(*a, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"slambench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    run["correct"], run["checks"] = check.verdict(run["numbers"], cell.limits)
    print(f"card: {card_line()}; torch {torch.__version__}; "
          f"window {run['window_s']:.3f} s, {run['frames']} frames",
          file=sys.stderr)
    line = result_line(cell, run, opened["setup_s"], bool(args.trace), kind,
                       lambda name: cell_mod.metric_reader(cell.root, name))
    compared = {name for name, _, _ in run["checks"]}
    for name, v in run["numbers"].items():
        if name not in compared:
            print(f"shown {name} {v!r} (not compared)", file=sys.stderr)
    for name, v, lim in run["checks"]:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
