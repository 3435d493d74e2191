"""The port's tracing (pykaldi2_tpu_torch/utils/tracing.py) on the CPU.

Off, the train step enters no ``record_function`` and keeps nothing; under
a torch profiler the spans mark the trace without being kept; on, they are
kept in order, nested, on the threads that ran them, on the clock of the
profiler's chrome trace. Both CLIs' ``-profile`` write traces that hold the
program's spans, those of the prefetch thread the profiler cannot see
included, and ``train_se`` makes its CUDA-event marks only on logged steps.
"""

import functools
import json
import os
import threading

import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.bin import train_ce, train_se
from pykaldi2_tpu_torch.data.dataloader import BucketSpec, ChunkDataloader, SeqDataloader
from pykaldi2_tpu_torch.data.prefetch import device_prefetch
from pykaldi2_tpu_torch.decode.device_lattice import (DeviceSearch, _compact_band,
                                                      pack_decode_graph)
from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.pipeline import build_frontend
from pykaldi2_tpu_torch.trainer import make_ce_train_step, make_se_lattice_steps
from pykaldi2_tpu_torch.utils import make_optimizer, tracing

from toydata import make_toy_corpus

NUM_PDFS = 5
STEP_SPANS = ("pk2/train.forward", "pk2/train.backward", "pk2/optimizer.step")
MAIN = threading.main_thread().native_id


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


@pytest.fixture
def toy(tmp_path):
    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=6, num_pdfs=NUM_PDFS,
                            min_sec=0.3, max_sec=0.6, seed=3)
    feat = C.FeatConfig(fbank=C.FbankOpts(frame_opts=C.FrameOpts(dither=0.0),
                                          mel_opts=C.MelOpts(num_bins=24)))
    dataset, feat_fn, extras_fn = build_frontend(
        C.DataConfig(wav_scp=paths["wav_scp"], label_ark=paths["ali"], feat=feat))
    model = build_model(C.ModelConfig(type="lstm", input_size=feat_fn.dim, hidden_size=16,
                                      num_layers=1, output_size=NUM_PDFS,
                                      compute_dtype="float32"))
    return dataset, feat_fn, extras_fn, model


def _ce_batches(toy, n):
    dataset, _feat_fn, extras_fn, _model = toy
    loader = ChunkDataloader(dataset, 3, 20, shuffle=False, extras_fn=extras_fn)
    return list(device_prefetch(iter(loader), torch.device("cpu")))[:n]


def _ce_step(toy):
    _dataset, feat_fn, _extras, model = toy
    opt = make_optimizer(C.OptimizerConfig(type="adam", lr=1e-3, grad_clip=5.0),
                         model.parameters())
    return make_ce_train_step(model, feat_fn, opt)


def _names(spans, want=STEP_SPANS):
    return [s.name for s in spans if s.name in want]


def test_off_enters_no_record_function_and_keeps_nothing(toy, monkeypatch):
    batches = _ce_batches(toy, 2)
    step = _ce_step(toy)
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    for b in batches:
        step(b)
    assert calls == []
    assert tracing.take()["spans"] == []
    tracing.enable()
    step(batches[0])
    assert set(STEP_SPANS) <= set(calls)


def test_on_keeps_the_step_spans_in_order_and_nested(toy):
    batches = _ce_batches(toy, 2)
    step = _ce_step(toy)
    tracing.enable()
    for b in batches:
        step(b)
    tracing.disable()
    spans = tracing.take()["spans"]
    assert _names(spans) == list(STEP_SPANS) * 2
    by_id = {s.id: s for s in spans}
    lstm = [s for s in spans if s.name in ("pk2/lstm.fwd", "pk2/lstm.bwd")]
    assert len(lstm) == 4
    for s in lstm:
        parent = by_id[s.parent].name
        assert parent == ("pk2/train.forward" if s.name == "pk2/lstm.fwd"
                          else "pk2/train.backward")
        assert by_id[s.parent].start_ns <= s.start_ns <= s.end_ns <= by_id[s.parent].end_ns
    assert all(s.tid == MAIN and s.start_ns <= s.end_ns for s in spans)


def test_profiler_alone_marks_the_trace_without_keeping(toy):
    batches = _ce_batches(toy, 1)
    step = _ce_step(toy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batches[0])
    names = {e.name for e in prof.events()}
    assert set(STEP_SPANS) | {"pk2/lstm.fwd", "pk2/lstm.bwd"} <= names
    assert tracing.take()["spans"] == []


def test_kept_spans_map_onto_the_chrome_trace(toy, tmp_path):
    """A kept span's start is its trace event's baseTimeNanoseconds + ts·1000,
    within 1 ms."""
    batches = _ce_batches(toy, 2)
    step = _ce_step(toy)
    step(batches[0])
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batches[1])
    tracing.disable()
    kept = tracing.take()["spans"]
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc["baseTimeNanoseconds"])
    events = {(e["name"], e["tid"]): e for e in doc["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("pk2/")}
    assert len(kept) >= 5
    for s in kept:
        e = events[(s.name, s.tid)]
        assert abs(base + e["ts"] * 1e3 - s.start_ns) < 1e6, s.name
        assert abs(base + (e["ts"] + e["dur"]) * 1e3 - s.end_ns) < 1e6, s.name
    assert tracing.add_unseen(doc, kept) == 0


def test_prefetch_spans_name_their_threads(toy):
    dataset, _feat_fn, extras_fn, _model = toy
    loader = ChunkDataloader(dataset, 3, 20, shuffle=False, extras_fn=extras_fn)
    tracing.enable()
    n = sum(1 for _ in device_prefetch(iter(loader), torch.device("cpu")))
    tracing.disable()
    spans = tracing.take()["spans"]
    batch = [s for s in spans if s.name == "pk2/loader.batch"]
    wait = [s for s in spans if s.name == "pk2/loader.wait"]
    # one span a batch, and one that found the loader's end
    assert len(batch) == n + 1 and len(wait) == n + 1
    assert all(s.tid != MAIN for s in batch) and all(s.tid == MAIN for s in wait)


def _loop_graph(num_pdfs):
    """Start state 0 and one state a pdf, every state reaching every pdf."""
    fst = Fst()
    for _ in range(num_pdfs + 1):
        fst.add_state()
    fst.set_start(0)
    for s in range(num_pdfs + 1):
        for p in range(num_pdfs):
            fst.add_arc(s, p + 1, 0, 0.5, p + 1)
        if s:
            fst.set_final(s, 0.0)
    return fst


def test_se_lattice_steps_keep_the_search_and_train_spans(toy):
    dataset, feat_fn, extras_fn, model = toy
    opt = make_optimizer(C.OptimizerConfig(type="momentum", lr=1e-3, momentum=0.9),
                         model.parameters())
    forward_fn, train_fn = make_se_lattice_steps(model, feat_fn, opt,
                                                 obs_transfer_dtype="float32")
    loader = SeqDataloader(dataset, BucketSpec(boundaries=(400,), batch_sizes=3),
                           shuffle=False, extras_fn=extras_fn)
    batch = next(iter(device_prefetch(iter(loader), torch.device("cpu"))))
    batch.pop("utt_ids")
    search = DeviceSearch(pack_decode_graph(_loop_graph(NUM_PDFS)))
    tracing.enable()
    obs = forward_fn(batch)
    lat, _scores, _dropped = search(obs, batch["num_frames"], max_active=4, max_arcs=256,
                                    capture=False)
    lat, _ = _compact_band(lat, None)
    m = train_fn(batch, lat)
    tracing.disable()
    assert np.isfinite(float(m["objective"]))
    names = [s.name for s in tracing.take()["spans"]]
    order = ["pk2/eval.forward", "pk2/search.replay", "pk2/search.compact", *STEP_SPANS]
    assert [n for n in names if n in order] == order
    assert names.count("pk2/latfb.fwd") == names.count("pk2/latfb.bwd") == 1


def test_counters_add_and_take_clears():
    tracing.count("search.captures", 1.5)
    tracing.count("search.captures", 0.25)
    assert tracing.take()["counters"] == {"search.captures": (2, 1.75)}
    assert tracing.take()["counters"] == {}


def _trace_events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _short_profile(monkeypatch, cli, steps):
    """The CLI's profiler over ``steps`` steps from step 2, not 20."""
    monkeypatch.setattr(cli, "StepProfiler", functools.partial(tracing.StepProfiler,
                                                               steps=steps))


def test_train_ce_profile_holds_the_prefetch_threads_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    _short_profile(monkeypatch, train_ce, 4)
    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=4, num_pdfs=4, seed=17)
    data = {"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
            "feat": {"fbank": {"frame_opts": {"dither": 0.0}, "mel_opts": {"num_bins": 24}}}}
    cfg = {"model": {"type": "lstm", "hidden_size": 16, "num_layers": 1, "output_size": 4,
                     "compute_dtype": "float32"},
           "optimizer": {"type": "adam", "lr": 0.01},
           "trainer": {"batch_size": 2, "chunk_len": 20, "num_epochs": 1,
                       "log_interval": 100}}
    dp, cp = str(tmp_path / "data.yaml"), str(tmp_path / "exp.yaml")
    for path, doc in ((dp, data), (cp, cfg)):
        with open(path, "w") as f:
            yaml.safe_dump(doc, f)
    prof = str(tmp_path / "prof")
    assert train_ce.main(["-config", cp, "-data", dp, "-exp_dir", str(tmp_path / "exp"),
                          "-profile", prof]) == 0
    events = _trace_events(os.path.join(prof, "trace.json"))
    batch_tids = {e["tid"] for e in events if e["name"] == "pk2/loader.batch"}
    assert batch_tids and MAIN not in batch_tids
    main = [e["name"] for e in events if e["tid"] == MAIN and e["name"] in STEP_SPANS]
    assert main.count("pk2/train.forward") == main.count("pk2/optimizer.step") == 4


@pytest.mark.parametrize("mode,argv,times", [
    ("fixed", [], ("train_ms",)),
    ("host", ["-on_the_fly", "-num_threads", "2"], ("forward_ms", "train_ms")),
    ("device", ["-on_the_fly", "-decoder", "device", "-max_arcs", "64"],
     ("forward_ms", "search_ms", "compact_ms", "train_ms")),
])
def test_train_se_profile_and_marks_on_logged_steps(tmp_path, monkeypatch, mode, argv, times):
    """Each SE loop: ``-profile`` writes a trace with the step's spans; the
    step-time marks are made only on the step that logs them (the second of
    three), and the logged times are there."""
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    _short_profile(monkeypatch, train_se, 1)
    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=6, num_pdfs=4, min_sec=0.3,
                            max_sec=0.6, seed=8)
    cfg = {"model": {"type": "lstm", "hidden_size": 16, "num_layers": 1, "output_size": 4,
                     "compute_dtype": "float32"},
           "optimizer": {"type": "momentum", "momentum": 0.9, "lr": 1e-3},
           "trainer": {"batch_size": 2, "num_epochs": 1, "log_interval": 2,
                       "beam": 24.0, "lattice_beam": 12.0, "acoustic_scale": 1.0},
           "data": {"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
                    "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                       "mel_opts": {"num_bins": 24}}}}}
    cp = str(tmp_path / "se.yaml")
    with open(cp, "w") as f:
        yaml.safe_dump(cfg, f)
    flags = []
    real = train_se._mark

    def mark(dev, logged):
        flags.append(logged)
        return real(dev, logged)

    monkeypatch.setattr(train_se, "_mark", mark)
    exp, prof = str(tmp_path / "exp"), str(tmp_path / "prof")
    assert train_se.main(["-config", cp, "-exp_dir", exp, "-criterion", "mmi",
                          "-profile", prof, *argv]) == 0
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "step" in r]
    assert [r["step"] for r in steps] == [2]
    assert set(times) <= set(steps[0])
    marks = 2 * len(times) if mode == "host" else len(times) + 1
    assert sum(flags) == marks and len(flags) == marks * 3
    names = {e["name"] for e in _trace_events(os.path.join(prof, "trace.json"))}
    assert {"pk2/train.backward", "pk2/optimizer.step"} <= names
    if mode != "fixed":
        assert "pk2/train.forward" in names
    if mode == "device":
        assert {"pk2/eval.forward", "pk2/search.replay", "pk2/search.compact"} <= names
