"""On-the-fly MMI sequence training through the device search, as
``bin/train_se.py:_run_device_search`` runs a batch: the eval forward
(``forward_fn``), the batched beam search (``DeviceSearch``) over the
packed denominator graph, the band's compaction (``_compact_band``, one
host sync) and the lattice train step (``train_fn``), the two functions
from ``trainer.make_se_lattice_steps``; batches from ``SeqDataloader``
through ``device_batches``.

Set-up builds the one step object and drives it through its first
``checked_steps`` steps (the first captures the search's CUDA graph); the
reference follows those steps. It follows the program's search too: its own
search reads the program's eval scores, so the check compares the search
(its lattices' log Z under the same scores), the eval forward (the scores)
and the training, each by itself.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import compare
import corpus as corpus_mod
import dengraph
import trace as trace_mod
import weights as weights_mod
from drivers.ce_train import Run, Window, _port_configs, epochs, frontend_cfg, model_cfg
from reference import lattice as ref_lattice
from reference import se as ref_se

MOMENTUM_KEY = "momentum_buffer"
SEARCH_KEYS = ("max_active", "max_arcs", "beam", "lattice_beam")


def search_cfg(config: dict) -> dict:
    """The search's settings, which the configuration states (se.yaml's)."""
    return {k: config[k] for k in SEARCH_KEYS}


def _graph(mix: dict) -> dict:
    return dengraph.make(mix["phones"], mix["graph_seed"])


def _program_fst(graph: dict):
    from pykaldi2_tpu_torch.graph.fst import Fst

    fst = Fst()
    for _ in range(graph["num_states"]):
        fst.add_state()
    fst.set_start(graph["start"])
    for s, d, p, w in zip(graph["src"].tolist(), graph["dst"].tolist(),
                          graph["pdf"].tolist(), graph["w"].tolist()):
        fst.add_arc(s, p + 1, 0, w, d)
    for s in np.flatnonzero(np.isfinite(graph["final"])).tolist():
        fst.set_final(s, float(graph["final"][s]))
    return fst


def _loader(ctx, dataset, extras_fn):
    from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader

    mix = ctx.mix
    spec = BucketSpec(boundaries=(mix["bucket_frames"],), batch_sizes=mix["batch_utts"])
    # with a fixed order every seed's batches hold the same lengths
    seed = mix["length_seed"] if mix.get("fixed_order", False) else ctx.seed % 2**31
    return SeqDataloader(dataset, spec, shuffle=True, seed=seed, extras_fn=extras_fn)


def _latfb_spans(spans):
    """Wrap the lattice MMI function with ``latfb.fwd`` and ``latfb.bwd``
    spans (its forward runs K7, its backward K8); returns the original."""
    from pykaldi2_tpu_torch.ops import fb_lattice

    orig = fb_lattice.mmi_objective_lattice_ts

    def wrapped(*args, **kw):
        with spans("latfb.fwd"):
            out = orig(*args, **kw)
        if spans.on and out.grad_fn is not None:
            state = {}

            def pre(_grads):
                state["rf"] = torch.profiler.record_function("latfb.bwd")
                state["rf"].__enter__()

            def post(_gin, _gout):
                if "rf" in state:
                    state.pop("rf").__exit__(None, None, None)

            out.grad_fn.register_prehook(pre)
            out.grad_fn.register_hook(post)
        return out

    fb_lattice.mmi_objective_lattice_ts = wrapped
    return orig


def run(ctx) -> tuple:
    from pykaldi2_tpu_torch.config import ModelConfig, OptimizerConfig
    from pykaldi2_tpu_torch.data.prefetch import device_batches
    from pykaldi2_tpu_torch.decode.device_lattice import (DeviceSearch, _compact_band,
                                                          pack_decode_graph)
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.ops import fb_lattice
    from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import make_se_lattice_steps
    from pykaldi2_tpu_torch.utils import make_optimizer

    config, mix, dev = ctx.config, ctx.mix, ctx.device
    cuda = dev.type == "cuda"
    se = mix["se"]
    out = Run(config, mix)
    tmp = tempfile.mkdtemp(prefix="pk2bench-")
    try:
        graph = _graph(mix)
        corpus = corpus_mod.make(tmp, mix, ctx.seed, graph["num_pdfs"])
        dataset, feat_fn, extras_fn = build_frontend(_port_configs(config, corpus))
        mc = model_cfg(config)
        with torch.device("meta"):
            model = build_model(ModelConfig(input_size=feat_fn.dim, **mc))
        model = model.to_empty(device=dev)
        spec = weights_mod.spec(mc, feat_fn.dim)
        weights_mod.load_into(model, weights_mod.make(spec, ctx.seed, dev))
        opt = mix["optimizer"]
        optimizer = make_optimizer(OptimizerConfig(type="momentum", lr=opt["lr"],
                                                   momentum=opt["momentum"],
                                                   grad_clip=opt["grad_clip"]),
                                   model.parameters())
        log_prior = priors_from_counts(count_labels(dataset.labels.values(),
                                                    config["output_size"]))
        search = DeviceSearch(pack_decode_graph(_program_fst(graph)).to(dev))
        spans = trace_mod.Spans()
        orig = _latfb_spans(spans)
        try:
            forward_fn, train_fn = make_se_lattice_steps(
                model, feat_fn, optimizer, log_prior=log_prior,
                acoustic_scale=se["acoustic_scale"], den_scale=se["den_scale"],
                drop_frames=se["drop_frames"], ce_ratio=se["ce_ratio"], criterion="mmi",
                obs_transfer_dtype="float32")
        finally:
            fb_lattice.mmi_objective_lattice_ts = orig
        gen = torch.Generator(device=dev).manual_seed(ctx.seed)
        batches = epochs(_loader(ctx, dataset, extras_fn), device_batches, dev)
        beams = search_cfg(config)

        def step(batch, marks=None):
            batch.pop("utt_ids", None)
            obs = forward_fn(batch)
            if marks is not None:
                marks[0].record()
            with spans("search"):
                lat, _scores, _dropped = search(obs, batch["num_frames"], **beams)
                lat, _ = _compact_band(lat, None)
            if marks is not None:
                marks[1].record()
            m = train_fn(batch, lat, gen)
            return obs, lat, m

        checked, named = [], list(model.named_parameters())
        losses = []
        pdfs = graph["num_pdfs"]
        for k in range(mix["checked_steps"]):
            batch = next(batches)
            host = {n: batch[n].cpu() for n in ("wave", "labels", "mask", "num_frames")}
            obs, lat, m = step(batch)
            host["obs"] = obs[:, :, :pdfs].cpu()
            host["lat"] = {n: getattr(lat, n).cpu() for n in ("src", "dst", "pdf", "weight",
                                                              "final")}
            checked.append(host)
            losses.append(-m["objective"] + se["ce_ratio"] * m["ce"])
            if k == 0:
                grad = {n: first_gradient_norm(optimizer, p) for n, p in named}
        w0 = weights_mod.make(spec, ctx.seed, dev)
        change = {n: (p.detach() - w0[n]).norm() for n, p in named}
        del w0, obs, lat, m
        prog = {"loss": [float(x) for x in losses],
                "grad": {n: float(v) for n, v in grad.items()},
                "change": {n: float(v) for n, v in change.items()}}
        if cuda:
            torch.cuda.synchronize(dev)
        out.setup_s = time.perf_counter() - ctx.t_start

        out.window = _window(step, batches, dev, ctx.seconds)
        w = out.window
        print(f"window: {w.steps} steps, {w.seconds:.3f} s, {w.frames:.0f} frames; loader "
              f"wait {1e3 * sum(w.loader_waits_s) / w.steps:.3f} ms a step; search "
              f"{sum(w.search_ms) / max(len(w.search_ms), 1):.3f} ms a step",
              file=sys.stderr, flush=True)
        if ctx.trace:
            _latfb_spans(spans)
            try:
                out.trace, out.traced_frames, out.traced_links = _traced(
                    step, batches, dev, mix, spans, tmp)
            finally:
                fb_lattice.mmi_objective_lattice_ts = orig
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        del step, optimizer, model, batches, named, grad, change, search, forward_fn, train_fn
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = check(ctx, corpus, graph, checked, prog, spec)
        return out, checks, w.steps, w.failed, peak
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def first_gradient_norm(optimizer, p) -> torch.Tensor:
    """‖g‖ of the gradient SGD received in its first step: its first
    momentum buffer; NaN where the step left no state."""
    buf = optimizer.base.state.get(p, {}).get(MOMENTUM_KEY)
    if buf is None:
        return torch.tensor(float("nan"))
    return buf.norm()


def _window(step, batches, dev, seconds: float) -> Window:
    cuda = dev.type == "cuda"
    w = Window()
    frames = torch.zeros((), device=dev)
    bad = torch.zeros((), device=dev)
    marks, pairs = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        a = time.perf_counter()
        batch = next(batches)
        w.loader_waits_s.append(time.perf_counter() - a)
        pair = None
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            pairs.append(pair)
        frames += batch["num_frames"].sum()
        _obs, _lat, m = step(batch, pair)
        bad += (~torch.isfinite(m["objective"])).float()
        w.steps += 1
        if time.perf_counter() >= deadline:
            break
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize(dev)
        marks.append(end)
        w.step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        w.search_ms = [a.elapsed_time(b) for a, b in pairs]
    w.seconds = time.perf_counter() - t0
    w.frames, w.failed = float(frames), int(bad)
    return w


def _traced(step, batches, dev, mix: dict, spans, tmp: str):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    frames = torch.zeros((), device=dev)
    links = torch.zeros((), device=dev)
    spans.on = True
    try:
        with profile(activities=acts) as prof:
            for _ in range(mix["trace_steps"]):
                with spans("loader.next"):
                    batch = next(batches)
                with spans("step.enqueue"):
                    frames += batch["num_frames"].sum()
                    _obs, lat, _m = step(batch)
                    links += (lat.weight > ref_lattice.HALF).sum()
            with spans("sync"):
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
    finally:
        spans.on = False
    return (trace_mod.read(prof, os.path.join(tmp, "trace.json"), mix["trace_steps"]),
            float(frames), float(links))


# --------------------------------------------------------------------------
# correctness
# --------------------------------------------------------------------------


def rebuild_rows(corpus, host: dict):
    """The batch rebuilt from the corpus by the utterance each row's labels
    name; → (batch, rows that differ from the program's)."""
    table = {lab.tobytes(): k for k, lab in enumerate(corpus.labels)}
    labels_p, nf_p = host["labels"].numpy(), host["num_frames"].numpy()
    b, s = host["wave"].shape
    t_len = labels_p.shape[1]
    wave = np.zeros((b, s), np.float32)
    labels = np.full((b, t_len), -1, np.int32)
    mask = np.zeros((b, t_len), np.float32)
    nf = np.zeros(b, np.int32)
    for i in range(b):
        k = table.get(labels_p[i, :nf_p[i]].tobytes())
        if k is None:
            continue
        n = corpus.labels[k].shape[0]
        src = corpus.waves[k][:s]
        wave[i, :src.shape[0]] = src
        labels[i, :n] = corpus.labels[k]
        mask[i, :n] = 1.0
        nf[i] = n
    wrong = int(np.sum(np.any(wave != host["wave"].numpy(), axis=1)
                       | np.any(labels != labels_p, axis=1)
                       | np.any(mask != host["mask"].numpy(), axis=1) | (nf != nf_p)))
    return ({"wave": torch.from_numpy(wave), "labels": torch.from_numpy(labels),
             "mask": torch.from_numpy(mask), "num_frames": torch.from_numpy(nf)}, wrong)


def reference_cfg(ctx) -> dict:
    return {"model": model_cfg(ctx.config), "frontend": frontend_cfg(ctx.config),
            "se": ctx.mix["se"], "optimizer": ctx.mix["optimizer"]}


def follow(ctx, corpus, graph, checked: list, spec: list, precision: str = "fp32",
           keep_rows: float = 1.0):
    """The reference's readings: (batches rebuilt, rows wrong, per step the
    reference's eval scores and its lattice from the given scores, the
    training's {"loss", "grad", "change"})."""
    dev = ctx.device
    cfg = reference_cfg(ctx)
    search = search_cfg(ctx.config)
    tab = ref_lattice.in_tables(graph, dev)
    prior = ref_se.log_prior([corpus.labels[k] for k in corpus.index],
                             ctx.config["output_size"]).to(dev)
    params = weights_mod.make(spec, ctx.seed, dev)
    ref_se.am.set_fp32_exact()
    sgd = ref_se.Momentum(params, cfg["optimizer"]["lr"], cfg["optimizer"]["momentum"],
                          cfg["optimizer"]["grad_clip"])
    p0 = {k: v.clone() for k, v in params.items()}
    wrong, steps, out = 0, [], {"loss": [], "grad": {}, "change": {}}
    for i, host in enumerate(checked):
        rb, w = rebuild_rows(corpus, host)
        wrong += w
        batch = {k: v.to(dev) for k, v in rb.items()}
        if "obs" in host:
            obs_search = host["obs"].to(dev)
        else:
            with torch.no_grad():
                obs_search = ref_se.scores(params, batch, cfg, prior, precision)[1]
            obs_search = obs_search[:, :, :graph["num_pdfs"]]
        lat = ref_lattice.search(obs_search, batch["num_frames"], tab, **search)
        loss, grads, obs = ref_se.mmi_step(params, batch, lat, cfg, prior, precision,
                                           keep_rows)
        steps.append({"obs": obs[:, :, :graph["num_pdfs"]], "lat": lat, "batch": batch})
        clipped = sgd.step(params, grads)
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = {k: float(g.norm()) for k, g in clipped.items()}
        del grads, clipped, obs
    out["change"] = {k: float((params[k] - p0[k]).norm()) for k in params}
    return steps, wrong, out


def occupancies(obs: torch.Tensor, lat: dict, nf: torch.Tensor) -> torch.Tensor:
    """The lattice's pdf occupancies [B, T, P] under ``obs``."""
    o = obs.detach().requires_grad_(True)
    with torch.enable_grad():
        z = ref_lattice.logz(o, lat, nf)
        gamma, = torch.autograd.grad(z.sum(), o)
    return gamma


def stage_gaps(checked: list, steps: list, dev) -> dict:
    """obs_gap: the largest |program's eval score − reference's| over valid
    frames and the graph's pdfs; lattice_gap: the largest Σ_p |γ_p − γ_r|
    over frames, γ the pdf occupancies of the program's lattice and of the
    reference's, both under the program's scores (0 to 2)."""
    obs_gap, lat_gap = 0.0, 0.0
    for host, ref in zip(checked, steps):
        nf = ref["batch"]["num_frames"]
        valid = ref["batch"]["mask"][..., None] > 0
        obs_p = host["obs"].to(dev)
        d = torch.where(valid, (obs_p - ref["obs"]).abs(), torch.zeros_like(obs_p))
        obs_gap = max(obs_gap, float(d.max()))
        g_p = occupancies(obs_p, {k: v.to(dev) for k, v in host["lat"].items()}, nf)
        g_r = occupancies(obs_p, ref["lat"], nf)
        g = (g_p - g_r).abs().sum(dim=2).max()
        lat_gap = max(lat_gap, float(g) if torch.isfinite(g) else float("inf"))
    return {"obs_gap": obs_gap, "lattice_gap": lat_gap}


def first_batches(ctx, corpus) -> tuple:
    """(the loader's first ``checked_steps`` batches on the host, the
    weights' spec, the graph) without the program's step: what the control
    reads."""
    from pykaldi2_tpu_torch.pipeline import build_frontend

    dataset, feat_fn, extras_fn = build_frontend(_port_configs(ctx.config, corpus))
    it = iter(_loader(ctx, dataset, extras_fn))
    keys = ("wave", "labels", "mask", "num_frames")
    batches = [{k: torch.from_numpy(v) for k, v in next(it).items() if k in keys}
               for _ in range(ctx.mix["checked_steps"])]
    return batches, weights_mod.spec(model_cfg(ctx.config), feat_fn.dim)


def check(ctx, corpus, graph, checked: list, prog: dict, spec: list) -> dict:
    t0 = time.perf_counter()
    steps, wrong, ref = follow(ctx, corpus, graph, checked, spec)
    t1 = time.perf_counter()
    print(f"dropped links: reference's lattices hold "
          f"{sum(int((st['lat']['weight'] > ref_lattice.HALF).sum()) for st in steps)} links",
          file=sys.stderr)
    gaps = stage_gaps(checked, steps, ctx.device)
    print(f"reference: {t1 - t0:.1f} s to follow the steps, {time.perf_counter() - t1:.1f} s "
          f"to compare the scores and lattices", file=sys.stderr)
    for kind in ("grad", "change"):
        worst = compare.leaf_gaps(prog[kind], ref[kind])[:3]
        print(f"worst {kind} leaves: " + ", ".join(f"{k} {g:.3g}" for g, k in worst),
              file=sys.stderr)
    print("losses: program " + ", ".join(f"{x:.9g}" for x in prog["loss"]) + "; reference "
          + ", ".join(f"{x:.9g}" for x in ref["loss"]), file=sys.stderr)
    checks = compare.training(prog, ref, ctx.limits, rows_wrong=wrong)
    checks.update({k: (v, ctx.limits.get(k)) for k, v in gaps.items()})
    return checks


def end_to_end(run: Run) -> dict:
    return {"se_frames_per_s": run.window.frames / run.window.seconds}


def _as_program(steps: list, hosts: list) -> list:
    """A reference run's steps in the form of the program's checked steps."""
    return [{**{k: v.cpu() for k, v in h.items()}, "obs": st["obs"].cpu(),
             "lat": {k: v.cpu() for k, v in st["lat"].items()}}
            for h, st in zip(hosts, steps)]


def _altered(hosts: list, graph: dict) -> list:
    """Each utterance's lattice with the pdfs of every link of its middle
    frame moved to the next pdf: an answer altered where the search makes
    it (one link alone carries almost no occupancy on a random model)."""
    out = []
    for h in hosts:
        lat = {k: v.clone() for k, v in h["lat"].items()}
        t = int(h["num_frames"].min()) // 2
        lat["pdf"][:, t] = (lat["pdf"][:, t] + 1) % graph["num_pdfs"]
        out.append({**h, "lat": lat})
    return out


def control_readings(ctx, tmp: str) -> dict:
    """control.py's readings of one seed: the fp8 control, half of each
    batch, an unchanged state and an altered lattice link, each in the
    program's place, against the fp32 reference following it."""
    import run

    graph = _graph(ctx.mix)
    corpus = corpus_mod.make(tmp, ctx.mix, ctx.seed, graph["num_pdfs"])
    hosts, spec = first_batches(ctx, corpus)
    base_steps, wrong, base = follow(ctx, corpus, graph, hosts, spec)
    out = {"rows_wrong": wrong}

    def readings(prog_hosts, prog, steps=base_steps, ref=base):
        r = {k: v for k, (v, _l) in compare.training(prog, ref, ctx.limits).items()
             if k != "rows_wrong"}
        r.update(stage_gaps(prog_hosts, steps, ctx.device))
        return r

    # the reference following the fp8 control searches the control's scores
    c_steps, _w, c_out = follow(ctx, corpus, graph, hosts, spec, precision="fp8")
    c_hosts = _as_program(c_steps, hosts)
    r_steps, _w, r_out = follow(ctx, corpus, graph, c_hosts, spec)
    out["control"] = readings(c_hosts, c_out, r_steps, r_out)
    # the other faults stand where the fp32 reference stood: it follows them
    # with the same steps it took on its own
    base_hosts = _as_program(base_steps, hosts)
    _s, _w, half = follow(ctx, corpus, graph, base_hosts, spec, keep_rows=0.5)
    out["half"] = readings(base_hosts, half)
    c = run.Context(ctx.bench, ctx.cell, ctx.seed, ctx.seconds, False, ctx.device, 0.0)
    c.mix = dict(ctx.mix, optimizer=dict(ctx.mix["optimizer"], lr=0.0))
    _s, _w, still = follow(c, corpus, graph, base_hosts, spec)
    out["unchanged"] = readings(base_hosts, still)
    out["altered"] = readings(_altered(base_hosts, graph), base)
    return out

