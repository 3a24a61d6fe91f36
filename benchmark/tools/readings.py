"""Readings that set a cell's limits: the program's checks on many seeds
and the control's (the reference at float8 in the program's place), at the
cell's own size, in one process.

    python3 benchmark/tools/readings.py --workload <name> --seconds <s> \
        --seeds <n> ... [--control_seeds <n> ...]

Prints one JSON line a reading: {"seed", "side": "program" | "control", "checks"}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import harness  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--control_floors", type=int, default=3)
    p.add_argument("--device", default=None)
    args = p.parse_args()
    spec = harness.load_cell(args.workload)
    harness.set_environment(spec)
    driver = harness.driver(spec["mix"]["driver"])
    for seed in args.seeds:
        out = harness.run_cell(spec, seed, args.seconds, False, args.device, time.perf_counter())
        print(json.dumps({"seed": seed, "side": "program", "checks": out["res"]["checks"],
                          "metrics": out["res"]["metrics"]}), flush=True)
    for seed in args.control_seeds:
        kw = {"n_floors": args.control_floors} if spec["mix"]["driver"] == "fused_scoring" else {}
        checks = driver.control(spec["config"], spec["mix"], seed, args.device, **kw)
        print(json.dumps({"seed": seed, "side": "control", "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
