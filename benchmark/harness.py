"""The benchmark's entry: one cell, one run, one result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in BENCHMARK.json:

* `configs/<config>.json`: the configuration's sizes and the limits of
  its checks;
* `traffic/<mix>.json`: the mix's parameters, among them its `driver`, the
  module `drivers/<driver>.py` that drives the program with this kind of
  traffic (`run(config, mix, seed, seconds, trace, device, t_start)`), so
  that a new kind of traffic is a new mix and, where no driver fits, a
  new driver: no file that is there changes;
* `metrics/<metric>.py`: a per-layer metric's reader, `read(ctx)`.

With `--trace 0` the result holds the cell's end-to-end metrics, taken on
the host's clock over the whole window; with `--trace 1` its per-layer
metrics, read from a profiled stretch. Either way the run checks its
answers against the plain reference (reference/) and prints each number
compared beside its limit, as the last lines on standard error and as the
result line's last key. The result is the last line on standard output.

Exit codes: 0 a result was printed (correct or not); 2 bad arguments or
manifest; 3 no CUDA card, or fewer than the cell asks for; 4 JAX, Flax or
the JAX package was loaded in this process.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "salve_tpu")


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The workload `name` with its configuration, mix and metric lists."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((root / config_entry["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" / f"{cell['traffic']}.json").read_text())

    def applies(metric: Dict) -> bool:
        return name in metric.get("workloads", [name])

    end_to_end = [m for m in manifest["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if applies(m) and ("workloads" in m or m["moves"] in reported)]
    return {"cell": cell, "config": config, "mix": mix, "end_to_end": end_to_end, "per_layer": per_layer}


def _module(folder: str, name: str, root: Path):
    path = root / "benchmark" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    return _module("metrics", metric, root).read


def driver(name: str, root: Path = ROOT):
    return _module("drivers", name, root)


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that are JAX, Flax or the JAX package
    (names compared whole: salve_tpu_torch is not salve_tpu)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def card_line() -> Dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
        name, limit = out[0].rsplit(",", 1)
        return {"name": name.strip(), "power_limit": limit.strip()}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": "unknown", "power_limit": "unknown"}


def set_environment(spec: Dict) -> None:
    """Before torch starts: every build and kernel cache in the checkout at
    a fixed path, and cuBLAS's fixed workspace where the configuration
    trains deterministically (read at the process's first cuBLAS call)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    # One host thread for CPU tensor ops: the program's host work is
    # dispatch, and idle pool threads spinning beside it only add noise.
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if spec["config"].get("deterministic_training"):
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device, t0: float, root: Path = ROOT) -> Dict:
    """Drive the cell with its mix's driver and collect its metrics and checks."""
    from benchmark.weights import arch_of

    config, mix = spec["config"], spec["mix"]
    res = driver(mix["driver"], root).run(config, mix, seed, seconds, trace, device, t0)
    metrics: Dict[str, Dict] = {}
    if trace:
        import torch

        ctx = dict(res["ctx"], driver=mix["driver"], px=config["crop_px"],
                   arch=arch_of(config),
                   kind=torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu")
        for m in spec["per_layer"]:
            value = reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            if m["name"] in res["metrics"]:
                metrics[m["name"]] = {"value": res["metrics"][m["name"]], "unit": m["unit"]}
    limits = config["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in res["checks"].items()}
    correct = res["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
           "res": res, "checks": checks}
    return out


def result_line(out: Dict, trace: bool, chips: int, kind: str, card: Dict) -> Dict:
    """The result line: correct, attempted, failed, metrics, device (and the
    breakdown when traced), the card, and the checks last."""
    res = out["res"]
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics")}
    line["device"] = {"platform": "gpu", "kind": kind, "count": chips,
                      "memory_peak_bytes": int(res["memory_peak_bytes"])}
    if trace:
        t = res["ctx"]["trace"]
        line["device"]["busy_s"], line["device"]["window_s"] = t.busy_s, t.window_s
        line["breakdown"] = t.breakdown()
    line["card"] = card
    line["checks"] = out["checks"]
    return line


def main(argv: Optional[List[str]], t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        spec = load_cell(args.workload)
    except (KeyError, OSError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2

    set_environment(spec)
    import torch

    torch.set_num_threads(1)

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), None, t0)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: this process loaded {', '.join(bad)}", file=sys.stderr)
        return 4

    kernels = sys.modules.get("salve_tpu_torch.ops.kernels")
    if kernels is not None and kernels._LOADED is not None:
        print(f"kernel library: {kernels._LOADED.path} (built in {kernels._LOADED.build_seconds:.1f} s this run)",
              file=sys.stderr)
    card = card_line()
    line = result_line(out, bool(args.trace), spec["cell"]["chips"], torch.cuda.get_device_name(0), card)
    res = out["res"]
    if "floor_p50_ms" in res["metrics"]:
        print(f"floors {res['floors']}: median {res['metrics']['floor_p50_ms']} ms, "
              f"p95 {res['metrics']['floor_p95_ms']} ms", file=sys.stderr)
    if args.trace:
        t, plain = res["ctx"]["trace"], res["ctx"]["plain_window_s"]
        print(f"traced window {t.window_s} s; the same work untraced {plain} s (ratio {t.window_s / plain})",
              file=sys.stderr)
    print(f"card: {card['name']}, power limit {card['power_limit']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
