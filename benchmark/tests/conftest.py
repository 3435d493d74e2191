"""CPU tests of the benchmark's harness. Nothing here needs a card."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = {"type": "lstm", "hidden_size": 32, "num_layers": 2, "proj_size": 0,
              "bidirectional": False, "output_size": 50, "dropout": 0.0,
              "compute_dtype": "bfloat16"}
TINY_MIX = {"driver": "ce_train", "batch_chunks": 4, "chunk_frames": 20,
            "optimizer": {"type": "adam", "lr": 0.0002, "grad_clip": 5.0}, "files": 6,
            "frames_min": 30, "frames_max": 70, "length_seed": 5, "amplitude": 3000.0,
            "epoch_utts": 24, "checked_steps": 3,
            "trace_steps": 2}
# the comparison's limits at the tiny size, set as the cell's are: above what
# sound runs read (loss 6e-6, gradient 5e-4, change 6e-4) and below what the
# fp8 control reads (loss 4e-5, gradient 7e-3, change 3e-3)
TINY_LIMITS = {"rows_wrong": 0, "loss_gap": 2e-5, "grad_gap": 0.003, "change_gap": 0.0018}
with open(os.path.join(BENCH, "traffic", "se_mmi_otf.json")) as _f:
    TINY_SE_MIX = dict(json.load(_f), batch_utts=4, bucket_frames=60, phones=3, files=6,
                       frames_min=30, frames_max=60, epoch_utts=12, trace_steps=2)
TINY_SEARCH = {"max_active": 8, "max_arcs": 40}
# sound runs read loss 2e-5, gradient 1e-3, change 1.4e-2, scores 5e-5 and
# lattices 0; the fp8 control 4e-4, 1.2e-2, 3.6e-2 and 6e-4; an altered link
# moves 1.5 of a frame's occupancy
TINY_SE_LIMITS = {"rows_wrong": 0, "loss_gap": 1e-4, "grad_gap": 0.005, "change_gap": 0.025,
                  "obs_gap": 2e-4, "lattice_gap": 0.01}


def tiny_config(**model) -> dict:
    with open(os.path.join(BENCH, "configs", "lstm_4x1024.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY_MODEL)
    cfg.update(model)
    return cfg


def add_cell(root: str, cell: str, config: dict, mix: dict, limits: dict,
             metric_files: dict = None) -> None:
    """Add a cell to the tree at ``root`` by new files and entries only."""
    bench = os.path.join(root, "benchmark")
    cname, tname = cell.replace(".", "_") + "_cfg", cell.replace(".", "_") + "_mix"
    for kind, name, data in (("configs", cname, config), ("traffic", tname, mix),
                             ("limits", cell, limits)):
        with open(os.path.join(bench, kind, name + ".json"), "w") as f:
            json.dump(data, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": cname, "source": "https://example.org/tiny",
                         "file": f"benchmark/configs/{cname}.json", "reduced": [],
                         "why": "tiny"})
    b["workloads"].append({"name": cell, "config": cname, "traffic": tname, "chips": 1,
                           "why": "tiny"})
    for name, source in (metric_files or {}).items():
        with open(os.path.join(bench, "metrics", name + ".py"), "w") as f:
            f.write(source)
        b["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "data loader",
                               "moves": "ce_frames_per_s", "workloads": [cell]})
    kind = "se" if mix["driver"] == "se_otf" else "ce"
    for m in b["per_layer"] + b["end_to_end"]:
        if "workloads" in m and m["name"] in (f"loader_wait_ms.{kind}", f"mfu.{kind}",
                                              f"{kind}_frames_per_s"):
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)


@pytest.fixture
def tree(tmp_path):
    """A copy of BENCHMARK.json and the benchmark's folder."""
    root = str(tmp_path / "tree")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


RUNNER = """
import json, sys, time
sys.path[:0] = [{bench!r}, {root!r}]
import run, torch
{patch}
bench = run.load_bench({tree!r})
ctx = run.Context(bench, {cell!r}, {seed!r}, {seconds!r}, {trace!r}, torch.device("cpu"),
                  time.perf_counter())
out = run.execute(ctx)
out["forbidden"] = run.forbidden_modules()
print(json.dumps(out))
"""


def run_cpu(tree: str, cell: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
            patch: str = "", timeout: float = 240) -> dict:
    """One run of ``cell`` from the tree's own harness, on the CPU, in a
    fresh process; skips only the look for a card. ``patch`` is code run
    first, to break the program underneath."""
    code = RUNNER.format(bench=os.path.join(tree, "benchmark"), root=ROOT, tree=tree,
                         cell=cell, seed=seed, seconds=seconds, trace=trace, patch=patch)
    env = dict(os.environ, PK2_PLATFORM="cpu", TMPDIR=os.path.dirname(tree))
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=timeout, env=env, cwd=tree)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])
