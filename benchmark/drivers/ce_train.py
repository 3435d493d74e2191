"""Frame cross-entropy training of a recurrent acoustic model, as
``bin/train_ce.py``'s epoch loop runs it: ``build_model`` and
``make_optimizer``, the step of ``trainer.make_ce_train_step``, fed by
``ChunkDataloader`` through ``device_prefetch``, one epoch after another.

Set-up builds the one step object and drives it through its first
``checked_steps`` steps on the loader's first batches; those steps warm up
every shape of the cell and are the ones the reference follows. The window
then runs the same object on the batches that follow, and counts the
labelled frames of each batch the loader hands it.
"""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

import compare
import corpus as corpus_mod
import trace as trace_mod
import weights as weights_mod
from reference import am

ADAM_BETA1 = 0.9


@dataclass
class Window:
    seconds: float = 0.0
    steps: int = 0
    frames: float = 0.0
    failed: int = 0
    loader_waits_s: list = field(default_factory=list)
    step_ms: list = field(default_factory=list)
    search_ms: list = field(default_factory=list)


@dataclass
class Run:
    """What the metric readers read."""

    config: dict
    mix: dict
    setup_s: float = 0.0
    window: Window = field(default_factory=Window)
    trace: object = None
    traced_frames: float = 0.0
    traced_links: float = 0.0


def model_cfg(config: dict) -> dict:
    return {k: config[k] for k in ("type", "hidden_size", "num_layers", "proj_size",
                                   "bidirectional", "output_size", "dropout",
                                   "compute_dtype")}


def frontend_cfg(config: dict) -> dict:
    return {k: config[k] for k in ("samp_freq", "frame_length_ms", "frame_shift_ms",
                                   "dither", "preemph_coeff", "num_mel_bins", "low_freq",
                                   "high_freq", "cmvn_norm_means")}


def _port_configs(config: dict, corpus):
    from pykaldi2_tpu_torch.config import (CmvnOpts, DataConfig, FbankOpts, FeatConfig,
                                           FrameOpts, MelOpts)

    fe = frontend_cfg(config)
    frame = FrameOpts(samp_freq=fe["samp_freq"], frame_length_ms=fe["frame_length_ms"],
                      frame_shift_ms=fe["frame_shift_ms"], dither=fe["dither"],
                      preemph_coeff=fe["preemph_coeff"], window_type=config["window_type"])
    mel = MelOpts(num_bins=fe["num_mel_bins"], low_freq=fe["low_freq"],
                  high_freq=fe["high_freq"])
    feat = FeatConfig(type="fbank", fbank=FbankOpts(frame_opts=frame, mel_opts=mel),
                      cmvn=CmvnOpts(norm_means=fe["cmvn_norm_means"],
                                    norm_vars=config["cmvn_norm_vars"]))
    return DataConfig(wav_scp=corpus.wav_scp, label_ark=corpus.label_ark, feat=feat,
                      shuffle=True, num_workers=0)


def first_gradient_norm(optimizer, p) -> torch.Tensor:
    """‖g‖ of the gradient Adam received in its first step, from its first
    moment (1 − β₁)·g; NaN where the step left no state."""
    m = optimizer.base.state.get(p, {}).get("exp_avg")
    if m is None:
        return torch.tensor(float("nan"))
    return (m / (1.0 - ADAM_BETA1)).norm()


def epochs(loader, to_device, dev):
    """The loader's batches on ``dev``, epoch after epoch, as the recipe's
    epoch loop sets each epoch and wraps the loader in ``to_device``."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from to_device(loader, dev)
        epoch += 1


def labelled_frames(batch: dict) -> torch.Tensor:
    """Frames of a CE batch that carry a label, counted on the device from
    the loader's own rows."""
    return (batch["mask"] * (batch["labels"] >= 0)).sum()


def _host(batch: dict) -> dict:
    return {k: batch[k].cpu() for k in ("wave", "labels", "mask")}


def run(ctx) -> tuple:
    """→ (Run, checks, attempted, failed, memory_peak_bytes)."""
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.data.prefetch import device_prefetch
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.config import ModelConfig, OptimizerConfig
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import make_ce_train_step
    from pykaldi2_tpu_torch.utils import make_optimizer

    config, mix, dev = ctx.config, ctx.mix, ctx.device
    cuda = dev.type == "cuda"
    out = Run(config, mix)
    tmp = tempfile.mkdtemp(prefix="pk2bench-")
    try:
        corpus = corpus_mod.make(tmp, mix, ctx.seed, config["output_size"])
        dataset, feat_fn, extras_fn = build_frontend(_port_configs(config, corpus))
        mc = model_cfg(config)
        with torch.device("meta"):
            model = build_model(ModelConfig(input_size=feat_fn.dim, **mc))
        model = model.to_empty(device=dev)
        spec = weights_mod.spec(mc, feat_fn.dim)
        weights_mod.load_into(model, weights_mod.make(spec, ctx.seed, dev))
        opt_cfg = mix["optimizer"]
        optimizer = make_optimizer(OptimizerConfig(type=opt_cfg["type"], lr=opt_cfg["lr"],
                                                   grad_clip=opt_cfg["grad_clip"]),
                                   model.parameters())
        spans = trace_mod.Spans()
        base_step = optimizer.step

        def optimizer_step():
            with spans("optimizer"):
                base_step()

        optimizer.step = optimizer_step
        step = make_ce_train_step(model, feat_fn, optimizer)
        loader = ChunkDataloader(dataset, mix["batch_chunks"], mix["chunk_frames"],
                                 shuffle=True, seed=ctx.seed % 2**31, extras_fn=extras_fn)
        batches = epochs(loader, device_prefetch, dev)
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)

        checked, losses = [], []
        named = list(model.named_parameters())
        for k in range(mix["checked_steps"]):
            batch = next(batches)
            checked.append(_host(batch))
            losses.append(step(batch, gen)["loss"])
            if k == 0:
                grad = {n: first_gradient_norm(optimizer, p) for n, p in named}
        w0 = weights_mod.make(spec, ctx.seed, dev)
        change = {n: (p.detach() - w0[n]).norm() for n, p in named}
        del w0
        prog = {"loss": [float(x) for x in losses],
                "grad": {n: float(v) for n, v in grad.items()},
                "change": {n: float(v) for n, v in change.items()}}
        if cuda:
            torch.cuda.synchronize(dev)
        out.setup_s = time.perf_counter() - ctx.t_start

        out.window = _window(step, batches, gen, dev, ctx.seconds, spans)
        w = out.window
        ms = sorted(w.step_ms) or [0.0]
        print(f"window: {w.steps} steps, {w.seconds:.3f} s, {w.frames:.0f} frames; loader "
              f"wait {1e3 * sum(w.loader_waits_s) / w.steps:.3f} ms a step; step ms p50 "
              f"{ms[len(ms) // 2]:.3f}, max {ms[-1]:.3f}", file=sys.stderr, flush=True)
        if ctx.trace:
            handles = trace_mod.layer_spans(model.nnet, "lstm", spans)
            out.trace, out.traced_frames = _traced(step, batches, gen, dev, mix, spans, tmp)
            for h in handles:
                h.remove()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        batches.close()
        del step, optimizer, model, batches, base_step, named, grad, change
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        checks = check(ctx, corpus, checked, prog, spec)
        return out, checks, out.window.steps, out.window.failed, peak
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def _window(step, batches, gen, dev, seconds: float, spans) -> Window:
    """Steps back to back until ``seconds`` have passed on the host clock,
    then a wait for the device: every step enqueued counts."""
    cuda = dev.type == "cuda"
    w = Window()
    frames = torch.zeros((), device=dev)
    bad = torch.zeros((), device=dev)
    marks = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        a = time.perf_counter()
        batch = next(batches)
        w.loader_waits_s.append(time.perf_counter() - a)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        frames += labelled_frames(batch)
        m = step(batch, gen)
        bad += (~torch.isfinite(m["loss"])).float()
        w.steps += 1
        if time.perf_counter() >= deadline:
            break
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize(dev)
        marks.append(end)
        w.step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    w.seconds = time.perf_counter() - t0
    w.frames, w.failed = float(frames), int(bad)
    return w


def _traced(step, batches, gen, dev, mix: dict, spans, tmp: str):
    """``trace_steps`` steps under the profiler, with the harness's spans."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    frames = torch.zeros((), device=dev)
    spans.on = True
    try:
        with profile(activities=acts) as prof:
            for _ in range(mix["trace_steps"]):
                with spans("loader.next"):
                    batch = next(batches)
                with spans("step.enqueue"):
                    frames += labelled_frames(batch)
                    step(batch, gen)
            with spans("sync"):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
    finally:
        spans.on = False
    return (trace_mod.read(prof, os.path.join(tmp, "trace.json"), mix["trace_steps"]),
            float(frames))


# --------------------------------------------------------------------------
# correctness
# --------------------------------------------------------------------------


def chunk_table(corpus, chunk: int) -> dict:
    """{labels of a chunk as bytes: (file, first frame, frames)} over the
    corpus's files, chunked as the recipe chunks: 80-frame pieces from each
    utterance's start, the last one shorter."""
    table = {}
    for k, lab in enumerate(corpus.labels):
        for c0 in range(0, lab.shape[0], chunk):
            piece = lab[c0:c0 + chunk]
            table[piece.tobytes()] = (k, c0, piece.shape[0])
    return table


def rebuild_rows(corpus, batch: dict, chunk: int, table: dict, fe: dict):
    """The batch rebuilt from the corpus, row by row, from the chunk each of
    the program's rows names; → (batch of fp32/int tensors, rows that
    differ from the program's)."""
    shift = int(fe["samp_freq"] * fe["frame_shift_ms"] / 1000)
    length = int(fe["samp_freq"] * fe["frame_length_ms"] / 1000)
    labels_p = batch["labels"].numpy()
    mask_p = batch["mask"].numpy()
    b, s = batch["wave"].shape
    wave = np.zeros((b, s), np.float32)
    labels = np.full((b, chunk), -1, np.int32)
    mask = np.zeros((b, chunk), np.float32)
    for i in range(b):
        clen = int(mask_p[i].sum())
        hit = table.get(labels_p[i, :clen].tobytes())
        if hit is None or hit[2] != clen:
            continue
        k, c0, n = hit
        src = corpus.waves[k][c0 * shift: c0 * shift + (n - 1) * shift + length]
        wave[i, :src.shape[0]] = src
        labels[i, :n] = corpus.labels[k][c0:c0 + n]
        mask[i, :n] = 1.0
    wrong = int(np.sum(np.any(wave != batch["wave"].numpy(), axis=1)
                       | np.any(labels != labels_p, axis=1) | np.any(mask != mask_p, axis=1)))
    return ({"wave": torch.from_numpy(wave), "labels": torch.from_numpy(labels),
             "mask": torch.from_numpy(mask)}, wrong)


def reference_batches(ctx, corpus, checked: list) -> tuple:
    fe = frontend_cfg(ctx.config)
    table = chunk_table(corpus, ctx.mix["chunk_frames"])
    out, wrong = [], 0
    for batch in checked:
        rb, w = rebuild_rows(corpus, batch, ctx.mix["chunk_frames"], table, fe)
        out.append({k: v.to(ctx.device) for k, v in rb.items()})
        wrong += w
    return out, wrong


def reference_run(ctx, batches: list, spec: list, precision: str,
                  keep_rows: float = 1.0) -> dict:
    params = weights_mod.make(spec, ctx.seed, ctx.device)
    cfg = {"model": model_cfg(ctx.config), "frontend": frontend_cfg(ctx.config)}
    return am.train_steps(params, batches, cfg, ctx.mix["optimizer"], precision, keep_rows)


def first_batches(ctx, corpus) -> tuple:
    """(the loader's first ``checked_steps`` batches on the host, the
    weights' spec) without the train step: what the control reads."""
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.pipeline import build_frontend

    dataset, feat_fn, extras_fn = build_frontend(_port_configs(ctx.config, corpus))
    loader = ChunkDataloader(dataset, ctx.mix["batch_chunks"], ctx.mix["chunk_frames"],
                             shuffle=True, seed=ctx.seed % 2**31, extras_fn=extras_fn)
    it = iter(loader)
    batches = [{k: torch.from_numpy(v) for k, v in next(it).items()
                if k in ("wave", "labels", "mask")} for _ in range(ctx.mix["checked_steps"])]
    return batches, weights_mod.spec(model_cfg(ctx.config), feat_fn.dim)


def check(ctx, corpus, checked: list, prog: dict, spec: list) -> dict:
    t0 = time.perf_counter()
    batches, wrong = reference_batches(ctx, corpus, checked)
    ref = reference_run(ctx, batches, spec, "fp32")
    print(f"reference: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for kind in ("grad", "change"):
        worst = compare.leaf_gaps(prog[kind], ref[kind])[:3]
        print(f"worst {kind} leaves: " + ", ".join(f"{k} {g:.3g}" for g, k in worst),
              file=sys.stderr)
    print("losses: program " + ", ".join(f"{x:.9g}" for x in prog["loss"]) + "; reference "
          + ", ".join(f"{x:.9g}" for x in ref["loss"]), file=sys.stderr)
    return compare.training(prog, ref, ctx.limits, rows_wrong=wrong)


def end_to_end(run: Run) -> dict:
    return {"ce_frames_per_s": run.window.frames / run.window.seconds}


def control_readings(ctx, tmp: str) -> dict:
    """control.py's readings of one seed: the fp8 control, half of each
    batch, and an unchanged state, each in the program's place."""
    import run

    corpus = corpus_mod.make(tmp, ctx.mix, ctx.seed, ctx.config["output_size"])
    host, spec = first_batches(ctx, corpus)
    batches, wrong = reference_batches(ctx, corpus, host)
    ref = reference_run(ctx, batches, spec, "fp32")
    out = {"rows_wrong": wrong}
    for name, precision, keep, lr in (("control", "fp8", 1.0, None),
                                      ("half", "fp32", 0.5, None),
                                      ("unchanged", "fp32", 1.0, 0.0)):
        c = ctx
        if lr is not None:
            c = run.Context(ctx.bench, ctx.cell, ctx.seed, ctx.seconds, False, ctx.device, 0.0)
            c.mix = dict(ctx.mix, optimizer=dict(ctx.mix["optimizer"], lr=lr))
        got = reference_run(c, batches, spec, precision, keep)
        out[name] = {k: v for k, (v, _l) in compare.training(got, ref, ctx.limits).items()
                     if k != "rows_wrong"}
    return out

