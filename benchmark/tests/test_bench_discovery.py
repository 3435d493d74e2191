"""A cell, a configuration, a mix and a per-layer metric are added by new
files and entries only, and BENCHMARK.json keeps to the contract's form."""

from __future__ import annotations

import hashlib
import json
import os
import re

from conftest import ROOT, TINY_LIMITS, TINY_MIX, add_cell, run_cpu, tiny_config

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
NEW_METRIC = '''
def read(run):
    return 1e3 * max(run.window.loader_waits_s)
'''


def _digests(root: str) -> dict:
    out = {}
    for base, _dirs, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_cell_from_new_files_only(tree):
    before = _digests(tree)
    add_cell(tree, "tiny.ce", tiny_config(), TINY_MIX, TINY_LIMITS,
             metric_files={"loader_wait_max_ms.tiny": NEW_METRIC})
    after = _digests(tree)
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "benchmark/configs/tiny_ce_cfg.json", "benchmark/traffic/tiny_ce_mix.json",
        "benchmark/limits/tiny.ce.json", "benchmark/metrics/loader_wait_max_ms.tiny.py"}
    out = run_cpu(tree, "tiny.ce", trace=True)
    assert out["correct"] is True
    assert out["metrics"]["loader_wait_max_ms.tiny"]["value"] >= 0.0
    assert "loader_wait_ms.ce" in out["metrics"] and "mfu.ce" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert [k for k in out if k != "forbidden"][-1] == "checks"


def test_benchmark_json_form():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"] for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        for kind, name in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(ROOT, "benchmark", kind, name + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py")) \
            or m in b["end_to_end"]
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
