"""Drive the PyTorch port's CE main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. build every kernel (csrc/*.cu, one nvcc each, in parallel) for sm_90a;
  2. hold each kernel against its plain PyTorch version at the flagship
     shapes (B=64 rows of 80-frame chunks, 80 fbank bins, H=1024), with the
     tolerances below, and time kernel, plain version and library call;
     then a small BLSTM's outputs and gradients on the card against the CPU;
  3. write a synthetic wave corpus (128 utterances of 1-3 s, random pdf-ids
     below 8952) and run the port's ``bin/train_ce.main`` on it at full width
     (4x1024 LSTM, 80-bin fbank, 8952 senones, batch 64, 80-frame chunks, Adam
     2e-4, clip 5); the kernel launch counts are zeroed just before and read
     just after, and every kernel must have launched;
  4. one eval pass of the trained checkpoint on the card, held against the
     same model on the CPU (plain versions) on a small input;
  5. train-step timing and a short profile of the device time by kernel;
  6. K2/K3 time against sequence length and batch (per-step vs fixed cost).

Output: per-kernel and per-step lines, the card's name and power limit, a
``{"kernels": [...]}`` JSON line and, last, ``{"ok": true, "device": {...}}``.
Bounds use the H100 SXM peaks: 3.35 TB/s, 989 TFLOP/s bf16 (tensor cores),
67 TFLOP/s fp32 (no tensor cores).
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_BPS, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
B, T, H, LAYERS, SENONES, BINS = 64, 80, 1024, 4, 8952, 80
FRAMES_PER_UTT = 1230.0  # LibriSpeech-960 mean utterance length (bench.py:36)
# kernel vs plain: fp32 summation order (+ one bf16 ulp for the saved gates);
# card vs CPU: cuBLAS bf16 GEMMs against exact-product emulation, through
# layers whose bf16 rounding of h can flip on a tie
TOL = {"fbank": 2e-3, "lstm_fwd": 2e-3, "lstm_fwd_gates": 8e-3, "lstm_bwd": 1e-3,
       "eval_logits": 5e-2, "blstm_out": 1e-2, "blstm_grad_rel": 1e-2}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, n: int = 20, warmup: int = 2) -> float:
    """Mean ms per call from CUDA events around n calls, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def bound_ms(nbytes: float, flops_by_peak) -> tuple:
    t_bytes = nbytes / MEM_BPS
    t_ops = sum(f / peak for f, peak in flops_by_peak)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(name: str, got, want, tol: float) -> float:
    err = float((got.float() - want.float()).abs().max())
    print(f"{name}: max_abs_err {err:.3e} (tolerance {tol:g})", flush=True)
    if not math.isfinite(err) or err > tol:
        fail(f"{name} disagrees with its plain version: {err} > {tol}")
    return err


def kernel_checks(dev):
    """Phase 2: each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.config import FbankOpts, FrameOpts, MelOpts
    from pykaldi2_tpu_torch.data.dataloader import chunk_samples
    from pykaldi2_tpu_torch.frontend import fused as F
    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    rng = np.random.RandomState(0)
    rows = {}

    # K1: fused fbank on a batch of 64 raw 80-frame chunks
    opts = FbankOpts(frame_opts=FrameOpts(dither=0.0), mel_opts=MelOpts(num_bins=BINS))
    fo = opts.frame_opts
    s = chunk_samples(T, fo)
    wave = torch.tensor((rng.randn(B, s) * 4000).astype(np.float32), device=dev)
    got = F.fused_fbank(wave, opts)
    torch.cuda.synchronize()
    err = check("K1 fbank", got, F.fused_fbank_plain(wave, opts), TOL["fbank"])
    w, k = fo.window_size, fo.padded_window_size // 2
    nrows = B * T
    flops = 2 * nrows * w * k * 2 + 2 * nrows * k * BINS
    nbytes = 4 * (B * s + T * w + w + 2 * w * k + k * BINS + nrows * BINS)
    bms, by = bound_ms(nbytes, [(flops, FP32_FLOPS)])
    rows["fbank"] = dict(
        name="fbank", route="cuda", source="pykaldi2_tpu_torch/csrc/fbank.cu",
        replaces="pykaldi2_tpu/frontend/fused.py:38", max_abs_err=err,
        ms=timed(lambda: F.fused_fbank(wave, opts)),
        plain_ms=timed(lambda: F.fused_fbank_plain(wave, opts)),
        bound_ms=bms, bound_by=by, library_ms=None)

    # K2: LSTM forward over one (layer, direction) at B=64, T=80, H=1024
    xp = torch.tensor((rng.randn(T, B, 4 * H) * 0.5).astype(np.float32), device=dev)
    wh = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (H, 4 * H)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    mask = torch.ones(T, B, device=dev)
    mask[50:, 3] = 0.0   # padded tails carry state through
    mask[20:, 11] = 0.0
    ys, cs, gates = L.lstm_fwd(xp, wh, mask)
    torch.cuda.synchronize()
    yp, cp, gp = L.lstm_fwd_plain(xp, wh, mask)
    err = max(check("K2 lstm_fwd ys", ys, yp, TOL["lstm_fwd"]),
              check("K2 lstm_fwd cs", cs, cp, TOL["lstm_fwd"]))
    check("K2 lstm_fwd gates (bf16)", gates, gp, TOL["lstm_fwd_gates"])
    flops = 2 * (T - 1) * B * H * 4 * H     # t = 0 has h = 0: no product
    nbytes = 4 * T * B * 4 * H + 2 * H * 4 * H + 4 * T * B + 2 * 4 * T * B * H + 2 * T * B * 4 * H
    bms, by = bound_ms(nbytes, [(flops, BF16_FLOPS)])
    cudnn = torch.nn.LSTM(H, H).to(device=dev, dtype=torch.bfloat16)
    cudnn.flatten_parameters()
    x_lib = torch.randn(T, B, H, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        lib_fwd = timed(lambda: cudnn(x_lib))
    rows["lstm_fwd"] = dict(
        name="lstm_fwd", route="cuda", source="pykaldi2_tpu_torch/csrc/lstm.cu",
        replaces="pykaldi2_tpu/ops/lstm_pallas.py:135", max_abs_err=err,
        ms=timed(lambda: L.lstm_fwd(xp, wh, mask)),
        plain_ms=timed(lambda: L.lstm_fwd_plain(xp, wh, mask), n=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=lib_fwd)

    # K3: LSTM backward on the plain forward's saved tensors
    dys = torch.tensor((rng.randn(T, B, H) * 0.1).astype(np.float32), device=dev)
    dg = L.lstm_bwd(dys, gp, cp, mask, wh)
    torch.cuda.synchronize()
    err = check("K3 lstm_bwd dgates", dg, L.lstm_bwd_plain(dys, gp, cp, mask, wh),
                TOL["lstm_bwd"])
    flops = 2 * (T - 1) * B * 4 * H * H     # the last step has no recurrent dh
    nbytes = (4 * T * B * H + 2 * T * B * 4 * H + 4 * T * B * H + 4 * T * B
              + 2 * H * 4 * H + 4 * T * B * 4 * H)
    bms, by = bound_ms(nbytes, [(flops, BF16_FLOPS)])
    x_req = x_lib.clone().requires_grad_(True)
    for p in cudnn.parameters():
        p.requires_grad_(False)
    out, _ = cudnn(x_req)
    d_out = torch.randn_like(out)
    lib_bwd = timed(lambda: torch.autograd.grad(out, x_req, d_out, retain_graph=True))
    rows["lstm_bwd"] = dict(
        name="lstm_bwd", route="cuda", source="pykaldi2_tpu_torch/csrc/lstm.cu",
        replaces="pykaldi2_tpu/ops/lstm_pallas.py:205", max_abs_err=err,
        ms=timed(lambda: L.lstm_bwd(dys, gp, cp, mask, wh)),
        plain_ms=timed(lambda: L.lstm_bwd_plain(dys, gp, cp, mask, wh), n=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=lib_bwd)
    # odd shapes: B=70 takes two launches of the 64-row kernel, H=64 a small grid
    xs = torch.tensor((rng.randn(7, 70, 256) * 0.5).astype(np.float32), device=dev)
    ws = torch.tensor(rng.uniform(-0.1, 0.1, (64, 256)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    mk = torch.ones(7, 70, device=dev)
    mk[4:, 0] = 0.0
    got = L.lstm_fwd(xs, ws, mk)
    want = L.lstm_fwd_plain(xs, ws, mk)
    torch.cuda.synchronize()
    check("K2 lstm_fwd ys at T=7 B=70 H=64", got[0], want[0], TOL["lstm_fwd"])
    ds = torch.tensor(rng.randn(7, 70, 64).astype(np.float32), device=dev)
    check("K3 lstm_bwd at T=7 B=70 H=64", L.lstm_bwd(ds, want[2], want[1], mk, ws),
          L.lstm_bwd_plain(ds, want[2], want[1], mk, ws), TOL["lstm_bwd"])
    for r in rows.values():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']}: {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
              f"library {lib} ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    return rows


def blstm_grad_check(dev):
    """A 2-layer BLSTM (reversed direction, masks, dWh and the bf16 GEMM
    gradients) on the card against the same module on the CPU."""
    import torch

    from pykaldi2_tpu_torch.models.lstm import LSTMStack

    gen = torch.Generator().manual_seed(3)
    cpu = LSTMStack(80, 256, 2, bidirectional=True, generator=gen)
    card = LSTMStack(80, 256, 2, bidirectional=True).to(dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(16, 30, 80, generator=gen)
    mask = torch.ones(16, 30)
    mask[3, 17:] = 0.0
    w = torch.randn(16, 30, 512, generator=gen)
    outs = []
    for mod, d in ((cpu, "cpu"), (card, dev)):
        y = mod(x.to(d), mask.to(d))
        (y * w.to(d)).sum().backward()
        outs.append((y.detach().cpu(), {k: p.grad.cpu() for k, p in mod.named_parameters()}))
    torch.cuda.synchronize()
    (y_cpu, g_cpu), (y_card, g_card) = outs
    check("BLSTM forward, card vs CPU plain path", y_card, y_cpu, TOL["blstm_out"])
    worst = max(float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max())
                for k in g_cpu)
    print(f"BLSTM gradients, card vs CPU: max error relative to each tensor's "
          f"max {worst:.3e} (tolerance {TOL['blstm_grad_rel']:g})", flush=True)
    if not math.isfinite(worst) or worst > TOL["blstm_grad_rel"]:
        fail(f"BLSTM gradients disagree: {worst}")


def recurrence_sweep(dev):
    """Phase 6: K2/K3 time against T and B at H=1024, which separates the
    per-step cost (slope in T) from the fixed cost of a launch, and shows
    whether a step's cost grows with the batch rows it stages."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    rng = np.random.RandomState(1)
    wh = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (H, 4 * H)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    print("recurrence sweep (H=1024): T, B, K2 ms, K3 ms, K2 us/step, K3 us/step", flush=True)
    for b in (16, 64):
        for t in (10, 40, 80):
            xp = torch.tensor((rng.randn(t, b, 4 * H) * 0.5).astype(np.float32), device=dev)
            mask = torch.ones(t, b, device=dev)
            ys, cs, gates = L.lstm_fwd(xp, wh, mask)
            dys = torch.randn_like(ys) * 0.1
            f_ms = timed(lambda: L.lstm_fwd(xp, wh, mask))
            b_ms = timed(lambda: L.lstm_bwd(dys, gates, cs, mask, wh))
            print(f"  sweep T={t:3d} B={b:3d}  K2 {f_ms:.4f} ms  K3 {b_ms:.4f} ms  "
                  f"K2 {1e3 * f_ms / t:.2f} us/step  K3 {1e3 * b_ms / t:.2f} us/step",
                  flush=True)


def write_corpus(root: str, n_utts: int = 128, seed: int = 0) -> dict:
    """Synthetic 16 kHz corpus: wav.scp + a binary pdf-id alignment ark."""
    import numpy as np

    from pykaldi2_tpu_torch.config import FrameOpts
    from pykaldi2_tpu_torch.data import kaldi_io
    from pykaldi2_tpu_torch.data.wav import write_wav
    from pykaldi2_tpu_torch.frontend.window import num_frames

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    fo = FrameOpts()
    lines = []
    ali = os.path.join(root, "ali.ark")
    with kaldi_io.ArkWriter(ali, kind="ivec") as w:
        for i in range(n_utts):
            n = int(16000 * rng.uniform(1.0, 3.0))
            path = os.path.join(root, "wav", f"utt{i:04d}.wav")
            write_wav(path, (rng.randn(n) * 3000).astype(np.float32))
            lines.append(f"utt{i:04d} {path}\n")
            w.write(f"utt{i:04d}", rng.randint(0, SENONES, num_frames(n, fo)).astype(np.int32))
    scp = os.path.join(root, "wav.scp")
    with open(scp, "w") as f:
        f.writelines(lines)
    return {"wav_scp": scp, "label_ark": ali}


def main_path(dev, root: str):
    """Phase 3: the port's CLI at full width; returns (exp_dir, launches)."""
    import yaml

    from pykaldi2_tpu_torch.bin import train_ce
    from pykaldi2_tpu_torch.frontend.fused import fused_fbank
    from pykaldi2_tpu_torch.ops.lstm_cuda import lstm_bwd, lstm_fwd

    corpus = write_corpus(os.path.join(root, "corpus"))
    data_yaml, cfg_yaml = os.path.join(root, "data.yaml"), os.path.join(root, "ce.yaml")
    with open(data_yaml, "w") as f:
        yaml.safe_dump({**corpus, "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                                     "mel_opts": {"num_bins": BINS}}}}, f)
    with open(cfg_yaml, "w") as f:  # examples/librispeech/ce.yaml at full width
        yaml.safe_dump({
            "model": {"type": "lstm", "hidden_size": H, "num_layers": LAYERS,
                      "output_size": SENONES, "dropout": 0.1, "compute_dtype": "bfloat16"},
            "optimizer": {"type": "adam", "lr": 0.0002, "grad_clip": 5.0},
            "trainer": {"batch_size": B, "chunk_len": T, "num_epochs": 1,
                        "log_interval": 1, "seed": 777}}, f)
    exp = os.path.join(root, "exp")
    fused_fbank.launches = lstm_fwd.launches = lstm_bwd.launches = 0
    rc = train_ce.main(["-config", cfg_yaml, "-data", data_yaml, "-exp_dir", exp],
                       device=str(dev))
    import torch

    torch.cuda.synchronize()
    launches = {"fbank": fused_fbank.launches, "lstm_fwd": lstm_fwd.launches,
                "lstm_bwd": lstm_bwd.launches}
    if rc != 0:
        fail(f"train_ce.main returned {rc}")
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    steps = [r for r in recs if "step" in r]
    if not steps or not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"main path wrote no finite step losses: {steps}")
    print(f"main path: {len(steps)} steps, losses "
          f"{[round(r['loss'], 4) for r in steps]}", flush=True)
    if not os.path.exists(os.path.join(exp, "model.0.npz")):
        fail("main path wrote no checkpoint")
    return exp, cfg_yaml, data_yaml, launches


def eval_check(dev, exp: str, cfg_yaml: str, data_yaml: str):
    """Phase 4: eval forward of the checkpoint on the card vs the CPU plain path."""
    import torch

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import make_eval_step
    from pykaldi2_tpu_torch.utils import load_checkpoint

    cfg = load_config(cfg_yaml)
    cfg.data = load_data_config(data_yaml)
    dataset, feat_fn, _ = build_frontend(cfg.data)
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model).to(dev)
    load_checkpoint(os.path.join(exp, "model.0.npz"), model)
    batch_np = next(iter(ChunkDataloader(dataset, B, T, shuffle=False)))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    nll, cnt, cor = make_eval_step(model, feat_fn)(batch)
    loss = float(nll) / max(float(cnt), 1.0)
    if not math.isfinite(loss) or float(cnt) <= 0:
        fail(f"eval pass gave loss {loss} over {float(cnt)} frames")
    print(f"eval: loss {loss:.4f} over {int(cnt)} frames, frame_acc "
          f"{float(cor) / float(cnt):.4f}", flush=True)
    # small input: the same model on the card (kernels) and on the CPU (plain)
    small = {k: v[:2] for k, v in batch.items()}
    model_cpu = build_model(cfg.model)
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.no_grad():
        feats = feat_fn.for_eval()(small)
        got = model(feats, small["mask"])
        small_cpu = {k: v.cpu() for k, v in small.items()}
        want = model_cpu(feat_fn.for_eval()(small_cpu), small_cpu["mask"])
    if tuple(got.shape) != (2, T, SENONES) or not bool(torch.isfinite(got).all()):
        fail(f"eval logits have shape {tuple(got.shape)} or non-finite values")
    check("eval logits, card vs CPU plain path", got.cpu(), want, TOL["eval_logits"])


def step_timing(dev, cfg_yaml: str, data_yaml: str) -> dict:
    """Phase 5: fenced train-step time on one fixed batch, then a short profile."""
    import torch

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import make_ce_train_step
    from pykaldi2_tpu_torch.utils import make_optimizer

    cfg = load_config(cfg_yaml)
    cfg.data = load_data_config(data_yaml)
    dataset, feat_fn, _ = build_frontend(cfg.data)
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model, generator=torch.Generator().manual_seed(0)).to(dev)
    step = make_ce_train_step(model, feat_fn, make_optimizer(cfg.optimizer, model.parameters()))
    batch_np = next(iter(ChunkDataloader(dataset, B, T, shuffle=False)))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        step(batch, gen)
    torch.cuda.synchronize()
    n = 50                      # throughput: steps queued back to back
    t0 = time.perf_counter()
    for _ in range(n):
        m = step(batch, gen)
    loss = float(m["loss"])     # waits for the last step
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    if not math.isfinite(loss):
        fail(f"timed train steps reached loss {loss}")
    lat = []                    # latency: each step fenced on its own
    for _ in range(100):
        t1 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    lat.sort()
    out = {"step_ms": dt * 1e3, "frames_per_sec": B * T / dt,
           "utt_per_sec": B * T / dt / FRAMES_PER_UTT,
           "fenced_step_ms_p50": lat[49], "fenced_step_ms_p90": lat[89],
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"train step: {out['step_ms']:.3f} ms mean over {n} queued steps | "
          f"{out['frames_per_sec']:.0f} frames/s | {out['utt_per_sec']:.2f} utt/s "
          f"(frames/s / {FRAMES_PER_UTT:g}) | fenced step p50 {lat[49]:.3f} ms, p90 "
          f"{lat[89]:.3f} ms (100 steps) | peak {out['peak_mem_gib']:.2f} GiB", flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(batch, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel and memcpy rows only: CPU-op rows, and user annotations such as
    # the optimizer's step range, also report the device time of what they
    # launched and would count it twice
    evs = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA") and _self_device_us(e) > 0
           and not getattr(e, "is_user_annotation", False)
           and not e.key.startswith("Optimizer.")]
    busy_us = sum(_self_device_us(e) for e in evs)
    print(f"profile, 3 steps: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall ({100 * busy_us / wall_us:.1f}%); top kernels by device time:", flush=True)
    for e in sorted(evs, key=lambda e: -_self_device_us(e))[:15]:
        print(f"  {_self_device_us(e) / 3e3:9.3f} ms/step  x{e.count // 3:<5d} "
              f"{e.key[:90]}", flush=True)
    out["device_busy_share"] = busy_us / wall_us
    return out


def _self_device_us(event) -> float:
    """Self device time of a profiler row (named self_cuda_time_total before
    torch 2.4)."""
    v = getattr(event, "self_device_time_total", None)
    return float(event.self_cuda_time_total if v is None else v)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "pykaldi2_tpu_torch")):
        fail("run from a checkout: pykaldi2_tpu_torch/ is not beside this script")
    sys.path.insert(0, HERE)
    import pykaldi2_tpu_torch
    from pykaldi2_tpu_torch import device as D

    if os.path.dirname(os.path.abspath(pykaldi2_tpu_torch.__file__)) != os.path.join(
            HERE, "pykaldi2_tpu_torch"):
        fail(f"imported pykaldi2_tpu_torch from {pykaldi2_tpu_torch.__file__}, not the checkout")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    dev = D.resolve_device("cuda")

    t0 = time.perf_counter()
    reports = D.build_all(force=True)
    print(f"built {', '.join(reports)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rows = kernel_checks(dev)
    blstm_grad_check(dev)
    root = os.path.join(HERE, "build", "chip_smoke")
    exp, cfg_yaml, data_yaml, launches = main_path(dev, root)
    eval_check(dev, exp, cfg_yaml, data_yaml)
    step_timing(dev, cfg_yaml, data_yaml)
    recurrence_sweep(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    for name, n in launches.items():
        rows[name]["launches"] = n
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows.values()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
