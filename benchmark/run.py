"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name from ``BENCHMARK.json`` at the checkout's root: the configuration in
``benchmark/configs/<config>.json``, the mix in
``benchmark/traffic/<traffic>.json`` (whose ``driver`` names the loop in
``benchmark/drivers/``), the limits of the comparison in
``benchmark/limits/<cell>.json``, and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``. The last line of standard output is the
result as one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pykaldi2_tpu")


def cache_dirs(root: str) -> dict:
    """Fixed cache directories inside the checkout (the program builds its
    kernels into ``build/kernels`` there by itself)."""
    return {"TRITON_CACHE_DIR": os.path.join(root, "build", "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(root, "build", "torch_extensions")}


def load_bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, key: str) -> list:
    """The metrics of ``bench[key]`` that the cell reports."""
    return [m for m in bench[key] if "workloads" not in m or cell in m["workloads"]]


def reader(metric: str):
    """``read(run) → float | None`` of ``metrics/<metric>.py``."""
    if os.path.join(HERE, "metrics") not in sys.path:
        sys.path.insert(0, os.path.join(HERE, "metrics"))
    spec = importlib.util.spec_from_file_location(f"metric_{metric}",
                                                  os.path.join(HERE, "metrics", metric + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


class Context:
    def __init__(self, bench: dict, cell: str, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        work = next((w for w in bench["workloads"] if w["name"] == cell), None)
        if work is None:
            raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
        self.bench, self.cell, self.work = bench, cell, work
        self.config = load_json("configs", work["config"])
        self.mix = load_json("traffic", work["traffic"])
        self.limits = load_json("limits", cell)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start = device, t_start


def card_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def execute(ctx: Context) -> dict:
    """Drive the cell and assemble the result (without the device check)."""
    import compare

    driver = importlib.import_module("drivers." + ctx.mix["driver"])
    run, checks, attempted, failed, peak = driver.run(ctx)
    correct = compare.passed(checks)
    metrics = {}
    if not ctx.trace:
        values = {"setup_s": run.setup_s}
        values.update(driver.end_to_end(run))
        for m in cell_metrics(ctx.bench, ctx.cell, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell_metrics(ctx.bench, ctx.cell, "per_layer"):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": _kind(dev), "count": ctx.work["chips"],
              "memory_peak_bytes": int(peak)}
    if dev.type == "cuda":
        device["power_limit"] = card_limit()
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device}
    if ctx.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": _number(v), "limit": lim} for k, (v, lim) in checks.items()}
    return out


def _number(v: float):
    """A JSON number, or its name where it is not finite."""
    return v if math.isfinite(v) else str(v)


def _kind(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.update(cache_dirs(ROOT))
    bench = load_bench(ROOT)
    work = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if work is None:
        print(f"run.py: no workload {args.workload!r}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"run.py: the cell needs {work['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    from pykaldi2_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    ctx = Context(bench, args.workload, args.seed, args.seconds, bool(args.trace), dev,
                  T_START)
    result = execute(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: the process holds {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    sys.exit(main())
