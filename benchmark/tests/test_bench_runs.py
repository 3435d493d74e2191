"""Whole runs: no card means no result; no JAX in the process; a broken
timed path comes out not correct; the control fails the limits."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import (BENCH, ROOT, TINY_LIMITS, TINY_MIX, TINY_SE_LIMITS, TINY_SE_MIX,
                      TINY_SEARCH, add_cell, run_cpu, tiny_config)


STATE_UNCHANGED = """
from pykaldi2_tpu_torch.utils import lr
lr.Optimizer.step = lambda self: None
"""
HALF_BATCH = """
from pykaldi2_tpu_torch import trainer
_forward = trainer.ce_forward
def _half(model, feat_fn, batch, generator, train):
    b = dict(batch)
    half = batch["mask"].shape[0] // 2
    b["mask"] = batch["mask"].clone()
    b["mask"][half:] = 0.0
    return _forward(model, feat_fn, b, generator, train)
trainer.ce_forward = _half
"""
SE_HALF_BATCH = """
from pykaldi2_tpu_torch import trainer
_update = trainer._se_update
def _half(optimizer, logits, obj_rows, labels, sup, nf, *args):
    half = sup.shape[0] // 2
    keep = (torch.arange(sup.shape[0], device=sup.device) < half).float()
    return _update(optimizer, logits, obj_rows * keep, labels, sup * keep[:, None], nf, *args)
trainer._se_update = _half
"""
ALTERED_FRAME = """
from pykaldi2_tpu_torch.decode import device_lattice as dl
_call = dl.DeviceSearch.__call__
def _altered(self, obs, nf, **kw):
    lat, scores, dropped = _call(self, obs, nf, **kw)
    pdf = lat.pdf.clone()
    t = int(nf.min()) // 2
    pdf[:, t] = (pdf[:, t] + 1) % int(self.graph.num_pdfs)
    return lat._replace(pdf=pdf), scores, dropped
dl.DeviceSearch.__call__ = _altered
"""


@pytest.fixture
def tiny(tree):
    add_cell(tree, "tiny.ce", tiny_config(), TINY_MIX, TINY_LIMITS)
    add_cell(tree, "tinyp.ce", tiny_config(proj_size=16, bidirectional=True), TINY_MIX,
             TINY_LIMITS)
    add_cell(tree, "tiny.se", tiny_config(**TINY_SEARCH), TINY_SE_MIX, TINY_SE_LIMITS)
    return tree


def test_no_card_no_result(tmp_path):
    bare = str(tmp_path / "bare")
    shutil.copytree(BENCH, os.path.join(bare, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = json.load(f)["workloads"][0]["name"]
    for cwd in (ROOT, bare):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                            "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=120,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert p.returncode != 0
        assert not p.stdout.strip()


@pytest.mark.parametrize("cell,trace,metrics", [
    ("tiny.ce", False, {"ce_frames_per_s", "setup_s"}),
    ("tinyp.ce", False, {"ce_frames_per_s", "setup_s"}),
    ("tiny.se", False, {"se_frames_per_s", "setup_s"}),
    ("tiny.se", True, {"loader_wait_ms.se", "mfu.se"})])
def test_sound_run_is_correct_without_jax(tiny, cell, trace, metrics):
    out = run_cpu(tiny, cell, seed=2**31 + 11, trace=trace)
    assert out["correct"] is True, out["checks"]
    assert out["forbidden"] == []
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == metrics


def test_window_runs_on_past_an_epoch(tree):
    """The driver starts the next epoch where one ends: a program faster than
    an epoch's worth of window still finds batches."""
    import corpus

    mix = dict(TINY_MIX, epoch_utts=TINY_MIX["files"])
    add_cell(tree, "short.ce", tiny_config(), mix, TINY_LIMITS)
    chunks = sum(-(-int(n) // mix["chunk_frames"]) for n in corpus.file_lengths(mix))
    per_epoch = -(-chunks // mix["batch_chunks"])
    out = run_cpu(tree, "short.ce", seconds=1.0)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 2 * per_epoch


@pytest.mark.parametrize("cell,fault", [("tiny.ce", STATE_UNCHANGED), ("tiny.ce", HALF_BATCH),
                                        ("tiny.se", STATE_UNCHANGED),
                                        ("tiny.se", SE_HALF_BATCH), ("tiny.se", ALTERED_FRAME)],
                         ids=["ce_state_unchanged", "ce_half_batch", "se_state_unchanged",
                              "se_half_batch", "se_altered_frame"])
def test_broken_step_is_not_correct(tiny, cell, fault):
    out = run_cpu(tiny, cell, seed=5, patch=fault)
    assert out["correct"] is False


@pytest.mark.parametrize("cell,limits,faults", [
    ("tiny.ce", TINY_LIMITS, ("control", "half", "unchanged")),
    ("tiny.se", TINY_SE_LIMITS, ("control", "half", "unchanged", "altered"))])
def test_control_fails_the_limits(tiny, cell, limits, faults):
    p = subprocess.run([sys.executable, os.path.join(tiny, "benchmark", "control.py"),
                        "--workload", cell, "--seeds", "3,4", "--device", "cpu"],
                       cwd=tiny, capture_output=True, text=True, timeout=400,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    for line in p.stdout.strip().splitlines():
        r = json.loads(line)
        assert r["rows_wrong"] == 0
        for fault in faults:
            assert any(r[fault][k] > limits[k] for k in r[fault]), (fault, r)


def test_forbidden_names_are_whole():
    import run

    assert "pykaldi2_tpu" not in run.forbidden_modules()
    sys.modules["pykaldi2_tpu.fake"] = type(sys)("pykaldi2_tpu.fake")
    try:
        assert "pykaldi2_tpu" in run.forbidden_modules()
    finally:
        del sys.modules["pykaldi2_tpu.fake"]
