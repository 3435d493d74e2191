"""The readers of the program's own spans: what they read from a trace that
holds them, that a trace without them (a program that has none) gives them
nothing, and that the program's spans move no other reader."""

from __future__ import annotations

import json
import os

import pytest

import run as run_mod
import trace as trace_mod
from conftest import ROOT
from drivers.ce_train import Run, Window

NEW = {"fwd_ms.ce": "ce_train", "bwd_ms.ce": "ce_train", "train_ms.se": "se_otf"}


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events(program: bool) -> list:
    """Two steps: the harness's spans, the program's where ``program`` (the
    backward's on the autograd thread 2), and a launch under each."""
    ev = []
    for k, t in enumerate((0, 1000)):
        c = 10 * k
        ev += [_x("user_annotation", "loader.next", t, 50),
               _x("user_annotation", "step.enqueue", t + 50, 900),
               _x("user_annotation", "lstm.fwd", t + 100, 200),
               _x("user_annotation", "lstm.bwd", t + 400, 300, tid=2),
               _x("user_annotation", "optimizer", t + 800, 100),
               _x("cuda_runtime", "cudaLaunchKernel", t + 60, 1, corr=c + 1),
               _x("cuda_runtime", "cudaLaunchKernelExC", t + 150, 1, corr=c + 2),
               _x("cuda_driver", "cuLaunchKernelEx", t + 450, 1, tid=2, corr=c + 3),
               _x("cuda_runtime", "cudaLaunchKernel", t + 850, 1, corr=c + 4),
               _x("kernel", "fbank", t + 70, 40, tid=7, corr=c + 1),
               _x("kernel", "lstm_proj_fwd", t + 160, 300, tid=7, corr=c + 2),
               _x("kernel", "lstm_proj_bwd", t + 460, 350, tid=7, corr=c + 3),
               _x("kernel", "adam", t + 860, 20, tid=7, corr=c + 4)]
        if program:
            ev += [_x("user_annotation", "pk2/train.forward", t + 55, 300),
                   _x("user_annotation", "pk2/lstm.fwd", t + 120, 100),
                   _x("user_annotation", "pk2/train.backward", t + 380, 400, tid=2),
                   _x("user_annotation", "pk2/lstm.bwd", t + 420, 200, tid=2),
                   _x("user_annotation", "pk2/optimizer.step", t + 810, 80)]
    ev.append(_x("user_annotation", "sync", 2000, 100))
    return ev


def _run(driver: str, program: bool) -> Run:
    with open(os.path.join(ROOT, "benchmark", "configs", "blstmp_4x1024p512.json")) as f:
        config = json.load(f)
    r = Run(config, {"driver": driver})
    r.trace = trace_mod.parse(_events(program), steps=2)
    r.traced_frames, r.traced_links = 1e5, 1e6
    r.window = Window(seconds=1.0, steps=2, frames=1e5, loader_waits_s=[1e-3, 2e-3],
                      step_ms=[80.0, 82.0], search_ms=[600.0, 610.0])
    return r


def _metrics() -> list:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [m["name"] for m in json.load(f)["per_layer"]]


def test_new_readers_read_the_programs_spans():
    ce, se = _run("ce_train", True), _run("se_otf", True)
    # per step: the fbank and K5 under train.forward (40 + 300 µs), K6 under
    # train.backward (350), Adam under optimizer.step (20)
    assert run_mod.reader("fwd_ms.ce")(ce) == pytest.approx(0.34)
    assert run_mod.reader("bwd_ms.ce")(ce) == pytest.approx(0.35)
    assert run_mod.reader("train_ms.se")(se) == pytest.approx(0.71)
    assert run_mod.reader("fwd_ms.ce")(se) is None
    assert run_mod.reader("train_ms.se")(ce) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_readers_give_nothing_without_the_programs_spans(name):
    assert run_mod.reader(name)(_run(NEW[name], False)) is None
    r = _run(NEW[name], True)
    r.trace = None
    assert run_mod.reader(name)(r) is None


def test_the_programs_spans_move_no_other_reader():
    """Every accepted reader reads the same from the trace with the
    program's spans as from the same trace without them."""
    others = [m for m in _metrics() if m not in NEW]
    assert len(others) == 11
    for driver in ("ce_train", "se_otf"):
        a, b = _run(driver, False), _run(driver, True)
        assert (a.trace.window_s, a.trace.busy_s, a.trace.idle_gaps) == \
            (b.trace.window_s, b.trace.busy_s, b.trace.idle_gaps)
        for name in others:
            assert run_mod.reader(name)(a) == run_mod.reader(name)(b), (driver, name)
