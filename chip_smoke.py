"""Drive the PyTorch port's main paths on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. build every kernel (csrc/*.cu, one nvcc each, in parallel) for sm_90a,
     and the native lattice decoder (native/latdec.cc, g++) beside them;
  2. hold each kernel against its plain PyTorch version at the flagship
     shapes (B=64 rows of 80-frame chunks, 80 fbank bins, H=1024), with the
     tolerances below, and time kernel, plain version and library call;
     K4 for Kaldi's mfcc_hires options and its 13-cepstra default, K5/K6 at
     the BLSTMP shapes (P=512) in both directions, K6 also at H=256, P=128
     (B=70: two launches) and H=P=1024, each K6 call made twice and the two
     required equal bit for bit; K7-K10 likewise on the
     probe lattice of bench.py:626-647 (B=32, T=448, K=A=256, 8952 pdfs);
     K2/K3 also at B in {16, 32, 64, 70} x H in {1024, 64, 48} with padded
     rows, each called twice on the same inputs, which must agree bit for
     bit; then a small BLSTM's and a small BLSTMP's outputs and gradients on
     the card against the CPU;
  3. write a synthetic wave corpus (128 utterances of 1-3 s, random pdf-ids
     below 8952) and run the port's ``bin/train_ce.main`` on it at full width
     (4x1024 LSTM, 80-bin fbank, 8952 senones, batch 64, 80-frame chunks, Adam
     2e-4, clip 5); the kernel launch counts are zeroed just before and read
     just after, and every kernel must have launched;
  4. one eval pass of the trained checkpoint on the card, held against the
     same model on the CPU (plain versions) on a small input;
  5. train-step timing and a short profile of the device time by kernel;
  6. K2/K3 time against sequence length and batch (per-step vs fixed cost),
     beside cuDNN's LSTM forward and backward-data at each batch;
  7. BLSTMP: ``bin/train_ce.main`` on phase 3's corpus with the BLSTMP
     4x1024/512 configuration of bench.py:185-205 (80-bin fbank, 8952
     senones, batch 64, 80-frame chunks, momentum 0.9, lr 0.01, clip 5):
     K1, K5 and K6 must launch (K5/K6 8 times a step) and K2/K3 not; then
     phase 4's eval check and phase 5's timing for that model;
  8. the MFCC recipe: ``bin/compute_cmvn_stats.main`` over phase 3's corpus
     with Kaldi's mfcc_hires options, ``bin/compute_feats.main`` (one
     utterance held against K4's plain version on the CPU), then
     ``bin/train_ce.main`` with those features and stats on the flagship
     4x1024 LSTM; K4 must launch in each, K2/K3 in training; phase 5's
     timing for that step;
  9. on-the-fly lattice sequence training: a corpus of 96 whole utterances
     of 4-4.5 s (up to 448 frames) with random pdf-ids of the 41-phone
     3-state model of bench.py:366-371 (123 pdfs), and ``bin/train_se.main
     -on_the_fly -decoder host`` seeded from phase 3's checkpoint at full
     width (batch 32, momentum 0.9, lr 1e-5, clip 5, ce_ratio 0.1, beam 10,
     lattice beam 4, max_active 200), 3 steps under MMI and 3 under sMBR,
     launch counts zeroed before and read after each; then K7-K10 against
     their plain versions on a decoded lattice batch, and a profile of one
     SE train step per criterion;
 10. fixed-denominator sequence training: K11 against its plain version on
     the all-COO tiles of bench.py:463-499's 96,001-state chain graph (both
     orientations, R=16 and 32, each called twice and required equal bit for
     bit, timed beside its bound and a BSR ``torch.sparse.mm``);
     ``bin/compute_priors.main`` on a corpus of 48
     utterances of 3.5-4 s (random pdf-ids below 8952); ``bin/train_se.main
     -den_graph`` on the chain graph (the block route, K11) with the
     flagship LSTM seeded from phase 3's checkpoint, se.yaml's settings at
     batch 16 × 400 frames, 3 MMI and 3 sMBR steps, K11 launched the count
     the code derives (2T a step with the full alpha history saved, 3T with
     the segmented recompute); the dense (``-generic_den``) and bigram
     (default) routes on phase 9's corpus, 3 steps per criterion, K11 not
     launched; a small block-route train step on the card against the CPU;
     and per route and criterion the fenced train step, peak memory and a
     profile with K11's share.

Output: per-kernel and per-step lines, the card's name and power limit, a
``{"kernels": [...]}`` JSON line and, last, ``{"ok": true, "device": {...}}``.
Bounds use the H100 SXM peaks: 3.35 TB/s, 989 TFLOP/s bf16 (tensor cores),
67 TFLOP/s fp32 (no tensor cores).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MEM_BPS, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
B, T, H, LAYERS, SENONES, BINS = 64, 80, 1024, 4, 8952, 80
PROJ = 512  # BLSTMP 4x1024/512 (bench.py:185-205)
# Kaldi's mfcc_hires.conf (egs/librispeech/s5/conf): 40 bins, 40 cepstra,
# low 20 Hz, high -400 Hz, no energy; and Kaldi's default 13/23 with energy
MFCC_HIRES = {"num_ceps": 40, "use_energy": False,
              "mel_opts": {"num_bins": 40, "low_freq": 20.0, "high_freq": -400.0}}
MFCC_DEFAULT = {"num_ceps": 13, "use_energy": True, "mel_opts": {"num_bins": 23}}
FRAMES_PER_UTT = 1230.0  # LibriSpeech-960 mean utterance length (bench.py:36)
# kernel vs plain: fp32 summation order (+ one bf16 ulp for the saved gates);
# card vs CPU: cuBLAS bf16 GEMMs against exact-product emulation, through
# layers whose bf16 rounding of h can flip on a tie
# K4: the fbank's log-mel error carried through the DCT (a sum of 40
# log-mels with weights up to ~0.2, times the lifter, up to ~11.5 at c12);
# K5/K6 vs plain: K2/K3's tolerances (the same bf16 operands and fp32
# sums; hfull is bf16 like the gates)
TOL = {"fbank": 2e-3, "lstm_fwd": 2e-3, "lstm_fwd_gates": 8e-3, "lstm_bwd": 1e-3,
       "eval_logits": 5e-2, "blstm_out": 1e-2, "blstm_grad_rel": 1e-2, "mfcc": 1e-2,
       "lstmp_fwd": 2e-3, "lstmp_fwd_bf16": 8e-3, "lstmp_bwd": 1e-3}
# K7-K10 vs plain: the same fp32 arithmetic, but the kernels add each slot's
# arcs with shared-memory atomics, in another order. Logs (alphas, norms,
# logZ) agree to 1e-4·max(1, |x|). gamma = exp(lg) agrees to 1e-5 + 1e-4·|γ|:
# lg adds the cumulative norms (hundreds; one fp32 ulp ~1e-5), so a rounding
# there is a relative error of γ. contrib = γ·(c − f) agrees to
# 1e-5·max(1, |f|) + 1e-4·|contrib|: c and f are expected frame counts of up
# to T, and their difference keeps their ulps.
LAT_TOL = {"log": 1e-4, "rel": 1e-4, "abs": 1e-5}
# K11 vs plain: nonnegative x times nonnegative tiles, each output a sum of
# up to 2·128 terms in another order: each side is within 255·2^-24 ≈ 1.5e-5
# of the exact sum relative to the element, so the two within 3e-5 of the
# row's max
BLOCK_TOL = 3e-5
# fixed-denominator SE (phase 10): batch, bucket (frames), utterances, and
# bench.py:463-499's chain graph (3200 chains of 30 states)
FD_B, FD_T, FD_UTTS, CHAIN = 16, 400, 48, (3200, 30)
SE_B, SE_T, SE_UTTS, SE_PHONES, SE_PROBE_KA = 32, 448, 96, 41, 256
# banded lattice kernels: the TPU kernel each replaces, and the fp32
# operations one frame needs per arc and per slot (bounds below)
LATFB = {
    "latfb_logz_fwd": ("K7", "pykaldi2_tpu/ops/fb_lattice_pallas.py:159", 6, 8),
    "latfb_occupancies_bwd": ("K8", "pykaldi2_tpu/ops/fb_lattice_pallas.py:238", 14, 8),
    "latfb_smbr_fwd": ("K9", "pykaldi2_tpu/ops/fb_lattice_pallas.py:325", 9, 13),
    "latfb_smbr_bwd": ("K10", "pykaldi2_tpu/ops/fb_lattice_pallas.py:413", 22, 13),
}


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


def timed_graph(fn, n: int = 50) -> float:
    """Mean device ms per call from a CUDA graph of n calls (timed over 5
    replays): a kernel whose wrapper takes longer on the host than the kernel
    takes on the card is timed by the kernel, not by the host's launch rate."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * n)


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
    lstm_shape_checks(dev)
    return rows


# K2/K3 against their plain versions beyond the flagship's shape: 16, 32, 64
# and 70 rows (70 takes two launches of 64) at H=1024 and at the small grids
# of H=64 and H=48 (K2: 8 and 6 CTAs in clusters of 2; K3: 4 and 3 CTAs)
LSTM_SHAPES = [(b, h) for h in (1024, 64, 48) for b in (16, 32, 64, 70)]


def lstm_shape_checks(dev, t_len: int = 24) -> None:
    """Phase 2, K2/K3 at LSTM_SHAPES with rows padded from different frames
    on; two calls of each kernel on the same inputs must agree bit for bit
    (the cluster sums run in a fixed order, with no atomics)."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    rng = np.random.RandomState(4)
    for b, h in LSTM_SHAPES:
        what = f"T={t_len} B={b} H={h}"
        xp = torch.tensor((rng.randn(t_len, b, 4 * h) * 0.5).astype(np.float32), device=dev)
        wh = torch.tensor((rng.uniform(-1, 1, (h, 4 * h)) / math.sqrt(h)).astype(np.float32),
                          device=dev).to(torch.bfloat16)
        mask = torch.ones(t_len, b, device=dev)
        for r in range(0, b, 5):
            mask[1 + (7 * r) % (t_len - 1):, r] = 0.0
        got = L.lstm_fwd(xp, wh, mask)
        again = L.lstm_fwd(xp, wh, mask)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            fail(f"K2 at {what}: two calls on the same inputs differ")
        yp, cp, gp = L.lstm_fwd_plain(xp, wh, mask)
        check(f"K2 lstm_fwd ys at {what}", got[0], yp, TOL["lstm_fwd"])
        check(f"K2 lstm_fwd cs at {what}", got[1], cp, TOL["lstm_fwd"])
        check(f"K2 lstm_fwd gates (bf16) at {what}", got[2], gp, TOL["lstm_fwd_gates"])
        dys = torch.tensor((rng.randn(t_len, b, h) * 0.1).astype(np.float32), device=dev)
        dg = L.lstm_bwd(dys, gp, cp, mask, wh)
        dg2 = L.lstm_bwd(dys, gp, cp, mask, wh)
        torch.cuda.synchronize()
        if not torch.equal(dg, dg2):
            fail(f"K3 at {what}: two calls on the same inputs differ")
        check(f"K3 lstm_bwd dgates at {what}", dg, L.lstm_bwd_plain(dys, gp, cp, mask, wh),
              TOL["lstm_bwd"])
    for h in sorted({h for _, h in LSTM_SHAPES}):
        k2, k3 = L.lstm_clusters(h, dev)
        print(f"LSTM kernels at H={h}: K2 {h // 8} CTAs in clusters of {k2}, "
              f"K3 {h // 16} CTAs in clusters of {k3}", flush=True)


def mfcc_opts(spec: dict):
    """MfccOpts with dither 0 from one of the option sets above."""
    from pykaldi2_tpu_torch.config import FrameOpts, MelOpts, MfccOpts

    spec = dict(spec)
    return MfccOpts(frame_opts=FrameOpts(dither=0.0), mel_opts=MelOpts(**spec.pop("mel_opts")),
                    **spec)


def mfcc_checks(dev) -> dict:
    """Phase 2, K4: fused MFCC against its plain version on 64 raw 80-frame
    chunks, for the hires and the 13-cepstra-with-energy options; the row
    (times, bound) is the hires one, the error the larger of the two."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.data.dataloader import chunk_samples
    from pykaldi2_tpu_torch.frontend import fused as F

    rng = np.random.RandomState(5)
    errs, row = [], None
    for label, spec in (("hires 40/40", MFCC_HIRES), ("13/23 + energy", MFCC_DEFAULT)):
        opts = mfcc_opts(spec)
        fo = opts.frame_opts
        s = chunk_samples(T, fo)
        wave = torch.tensor((rng.randn(B, s) * 4000).astype(np.float32), device=dev)
        got = F.fused_mfcc(wave, opts)
        torch.cuda.synchronize()
        errs.append(check(f"K4 mfcc {label}", got, F.fused_mfcc_plain(wave, opts), TOL["mfcc"]))
        if row is None:
            w, k = fo.window_size, fo.padded_window_size // 2
            m, c, nrows = opts.mel_opts.num_bins, opts.num_ceps, B * T
            flops = 2 * nrows * w * k * 2 + 2 * nrows * k * m + 2 * nrows * m * c
            nbytes = 4 * (B * s + T * w + w + 2 * w * k + k * m + m * c + nrows * c)
            bms, by = bound_ms(nbytes, [(flops, FP32_FLOPS)])
            row = dict(name="mfcc", route="cuda", source="pykaldi2_tpu_torch/csrc/fbank.cu",
                       replaces="pykaldi2_tpu/frontend/fused.py:125",
                       ms=timed(lambda: F.fused_mfcc(wave, opts)),
                       plain_ms=timed(lambda: F.fused_mfcc_plain(wave, opts)),
                       bound_ms=bms, bound_by=by, library_ms=None)
    row["max_abs_err"] = max(errs)
    return {"mfcc": row}


def lstmp_checks(dev) -> dict:
    """Phase 2, K5/K6: the LSTMP recurrence of one (layer, direction) at
    T=80, B=64, H=1024, P=512, with padded rows, in both directions (the
    reversed one runs time-flipped inputs, as models/lstm.py does), against
    the plain versions; then a B=70 (two launches), H=256, P=128 case and,
    for K6, an H=P=1024 one. Every K6 call is made twice (``k6_check``)."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    rng = np.random.RandomState(2)
    xp = torch.tensor((rng.randn(T, B, 4 * H) * 0.5).astype(np.float32), device=dev)
    wh = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (PROJ, 4 * H)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    wp = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (H, PROJ)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    mask = torch.ones(T, B, device=dev)
    mask[50:, 3] = 0.0
    mask[20:, 11] = 0.0
    dys = torch.tensor((rng.randn(T, B, PROJ) * 0.1).astype(np.float32), device=dev)
    fwd_errs, bwd_errs = [], []
    for label, x_in, m_in in (("forward", xp, mask),
                              ("reversed", xp.flip(0).contiguous(), mask.flip(0).contiguous())):
        ys, cs, gates, hfull = L.lstm_proj_fwd(x_in, wh, wp, m_in)
        torch.cuda.synchronize()
        yp, cp, gp, hp = L.lstm_proj_fwd_plain(x_in, wh, wp, m_in)
        fwd_errs += [check(f"K5 lstmp_fwd {label} ys", ys, yp, TOL["lstmp_fwd"]),
                     check(f"K5 lstmp_fwd {label} cs", cs, cp, TOL["lstmp_fwd"])]
        check(f"K5 lstmp_fwd {label} gates (bf16)", gates, gp, TOL["lstmp_fwd_bf16"])
        check(f"K5 lstmp_fwd {label} hfull (bf16)", hfull, hp, TOL["lstmp_fwd_bf16"])
        bwd_errs += k6_check(f"T={T} B={B} H={H} P={PROJ} {label}", dys, gp, cp, m_in, wh, wp)
    # odd shapes: B=70 takes two launches of the 64-row kernel
    xs = torch.tensor((rng.randn(7, 70, 1024) * 0.5).astype(np.float32), device=dev)
    whs = torch.tensor(rng.uniform(-0.1, 0.1, (128, 1024)).astype(np.float32),
                       device=dev).to(torch.bfloat16)
    wps = torch.tensor(rng.uniform(-0.1, 0.1, (256, 128)).astype(np.float32),
                       device=dev).to(torch.bfloat16)
    mk = torch.ones(7, 70, device=dev)
    mk[4:, 0] = 0.0
    got = L.lstm_proj_fwd(xs, whs, wps, mk)
    want = L.lstm_proj_fwd_plain(xs, whs, wps, mk)
    torch.cuda.synchronize()
    check("K5 lstmp_fwd ys at T=7 B=70 H=256 P=128", got[0], want[0], TOL["lstmp_fwd"])
    ds = torch.tensor(rng.randn(7, 70, 128).astype(np.float32), device=dev)
    k6_check("T=7 B=70 H=256 P=128 forward", ds, want[2], want[1], mk, whs, wps)
    # the reversed direction runs on the states of a time-flipped forward
    rev = L.lstm_proj_fwd_plain(xs.flip(0).contiguous(), whs, wps, mk.flip(0).contiguous())
    k6_check("T=7 B=70 H=256 P=128 reversed", ds.flip(0).contiguous(), rev[2], rev[1],
             mk.flip(0).contiguous(), whs, wps)
    # H = P = 1024: the largest shared-memory layout K6 takes
    t_big = min(24, T)
    wh_big = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (H, 4 * H)).astype(np.float32),
                          device=dev).to(torch.bfloat16)
    wp_big = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (H, H)).astype(np.float32),
                          device=dev).to(torch.bfloat16)
    d_big = torch.tensor((rng.randn(t_big, B, H) * 0.1).astype(np.float32), device=dev)
    for label, flip in (("forward", False), ("reversed", True)):
        f = (lambda a: a.flip(0).contiguous()) if flip else (lambda a: a.contiguous())
        m_big = f(mask[:t_big])
        _y, c_big, g_big, _h = L.lstm_proj_fwd_plain(f(xp[:t_big]), wh_big, wp_big, m_big)
        k6_check(f"T={t_big} B={B} H={H} P={H} {label}", f(d_big), g_big, c_big, m_big, wh_big,
                 wp_big)
    for h, p in ((H, PROJ), (256, 128), (H, H)):
        print(f"K6 at H={h} P={p}: {h // 16} CTAs in clusters of "
              f"{L.lstmp_bwd_cluster(h, p, dev)}", flush=True)

    # times at the BLSTMP shapes; the yardstick is one cuDNN LSTMP direction
    cudnn = torch.nn.LSTM(H, H, proj_size=PROJ).to(device=dev, dtype=torch.bfloat16)
    cudnn.flatten_parameters()
    x_lib = torch.randn(T, B, H, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        lib_fwd = timed(lambda: cudnn(x_lib))
    x_req = x_lib.clone().requires_grad_(True)
    for prm in cudnn.parameters():
        prm.requires_grad_(False)
    out, _ = cudnn(x_req)
    d_out = torch.randn_like(out)
    lib_bwd = timed(lambda: torch.autograd.grad(out, x_req, d_out, retain_graph=True))
    yp, cp, gp, hp = L.lstm_proj_fwd_plain(xp, wh, wp, mask)
    h4 = 4 * H
    f_flops = 2 * (T - 1) * B * PROJ * h4 + 2 * T * B * H * PROJ   # t = 0 has hp = 0
    f_bytes = (4 * T * B * h4 + 2 * PROJ * h4 + 2 * H * PROJ + 4 * T * B
               + 4 * T * B * PROJ + 4 * T * B * H + 2 * T * B * h4 + 2 * T * B * H)
    b_flops = 2 * T * B * PROJ * H + 2 * (T - 1) * B * h4 * PROJ   # no dhp after t = 0
    b_bytes = (4 * T * B * PROJ + 2 * T * B * h4 + 4 * T * B * H + 4 * T * B
               + 2 * PROJ * h4 + 2 * H * PROJ + 4 * T * B * h4 + 4 * T * B * PROJ)
    rows = {}
    for name, err, fn, plain, flops, nbytes, lib, line in (
            ("lstm_proj_fwd", max(fwd_errs), lambda: L.lstm_proj_fwd(xp, wh, wp, mask),
             lambda: L.lstm_proj_fwd_plain(xp, wh, wp, mask), f_flops, f_bytes, lib_fwd, 384),
            ("lstm_proj_bwd", max(bwd_errs), lambda: L.lstm_proj_bwd(dys, gp, cp, mask, wh, wp),
             lambda: L.lstm_proj_bwd_plain(dys, gp, cp, mask, wh, wp), b_flops, b_bytes,
             lib_bwd, 458)):
        bms, by = bound_ms(nbytes, [(flops, BF16_FLOPS)])
        rows[name] = dict(
            name=name, route="cuda", source="pykaldi2_tpu_torch/csrc/lstm.cu",
            replaces=f"pykaldi2_tpu/ops/lstm_pallas.py:{line}", max_abs_err=err,
            ms=timed(fn), plain_ms=timed(plain, n=3, warmup=1), bound_ms=bms, bound_by=by,
            library_ms=lib)
    k6 = rows["lstm_proj_bwd"]
    print(f"K6 at T={T} B={B} H={H} P={PROJ}: {k6['ms']:.4f} ms a call, "
          f"{1e3 * k6['ms'] / T:.2f} us a step; cuDNN LSTMP backward-data {lib_bwd:.4f} ms, "
          f"{1e3 * lib_bwd / T:.2f} us a step", flush=True)
    return rows


def k6_check(what: str, dys, gates, cs, mask, wh, wp) -> list:
    """K6 called twice on the same inputs (the two results must be equal bit
    for bit: the cluster sums run in a fixed order, with no atomics), then
    held against its plain version; returns the two max errors."""
    import torch

    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    dg, dm = L.lstm_proj_bwd(dys, gates, cs, mask, wh, wp)
    dg2, dm2 = L.lstm_proj_bwd(dys, gates, cs, mask, wh, wp)
    torch.cuda.synchronize()
    if not (torch.equal(dg, dg2) and torch.equal(dm, dm2)):
        fail(f"K6 at {what}: two calls on the same inputs differ")
    wg, wm = L.lstm_proj_bwd_plain(dys, gates, cs, mask, wh, wp)
    return [check(f"K6 lstmp_bwd dgates at {what}", dg, wg, TOL["lstmp_bwd"]),
            check(f"K6 lstmp_bwd dhpm at {what}", dm, wm, TOL["lstmp_bwd"])]


def print_rows(rows: dict) -> None:
    for r in rows.values():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"kernel {r['name']}: {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | "
              f"library {lib} ms | bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)


def close(name: str, got, want, atol, rtol: float) -> float:
    """Fail unless |got − want| <= atol + rtol·|want| everywhere (``atol`` may
    be a tensor that broadcasts); returns the max abs error."""
    d = (got.float() - want.float()).abs()
    worst = float((d / (atol + rtol * want.float().abs())).max())
    err = float(d.max())
    print(f"{name}: max_abs_err {err:.3e}, worst error / (atol + {rtol:g}*|want|) "
          f"{worst:.3f}", flush=True)
    if not math.isfinite(worst) or worst > 1.0:
        fail(f"{name} disagrees with its plain version (worst ratio {worst})")
    return err


def close_log(name: str, got, want) -> float:
    """Log-domain carries: the same slots dead (≈ NEG_INF) on both sides, the
    live ones within LAT_TOL["log"]·max(1, |want|)."""
    import torch

    alive = want > -1e29
    if not torch.equal(got > -1e29, alive):
        fail(f"{name}: the kernel and the plain version disagree on which slots are dead")
    return close(name, got[alive], want[alive], LAT_TOL["log"], LAT_TOL["log"])


def latfb_bytes(name: str, t: int, b: int, a: int, k: int) -> int:
    """Bytes a banded kernel must move: each fp32/int32 input read once, each
    output written once, at the tensors' shapes."""
    tba, tbk, tb = t * b * a, t * b * k, t * b
    n = {"latfb_logz_fwd": 4 * tba + tb + tbk + tb,                          # in: obs w src dst act
         "latfb_occupancies_bwd": 4 * tba + 2 * tb + tbk + b * k + b + tba,  # + residuals, γ out
         "latfb_smbr_fwd": 5 * tba + tb + 2 * tbk + tb,                      # + arc_acc, aaccs out
         "latfb_smbr_bwd": 5 * tba + 2 * tb + 2 * tbk + b * k + 2 * b + tba}[name]
    return 4 * n


def latfb_compare(dev, label: str, obs, lat, nf, ref, rows=None) -> dict:
    """K7-K10 against their plain versions on one packed lattice batch: obs
    [B,T,P], a TimeSyncLattice, num_frames [B] and reference pdfs [B,T] on the
    card. The backward kernels take the plain forwards' residuals. Returns
    {name: max_abs_err}; with ``rows``, also times each kernel and its plain
    version and fills one row per kernel."""
    import torch

    from pykaldi2_tpu_torch.ops import fb_lattice as FL
    from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC
    from pykaldi2_tpu_torch.ops.fb import NEG_INF

    b, t, _p = obs.shape
    k, a = lat.num_slots, lat.src.shape[2]
    band = FL._band(obs, lat)
    active = FL._active_ts(t, nf)
    arc_acc = FL._arc_acc_ts(lat, ref, "pdf", None, None)
    live = float(((band[3] > 0.5 * NEG_INF) * active).sum()) / (t * b * a)
    print(f"latfb {label}: B={b} T={t} K={k} A={a}, {live:.1%} of the band is live "
          f"arcs in active frames", flush=True)

    def run(kernel, plain):
        got = kernel()
        torch.cuda.synchronize()
        return got, plain()

    calls, errs = {}, {}
    calls["latfb_logz_fwd"] = (lambda: KC.logz_fwd(*band, active, k),
                               lambda: KC.logz_fwd_plain(*band, active, k))
    (ga, gn), (wa, wn) = run(*calls["latfb_logz_fwd"])

    def logz_of(alphas, norms):
        return torch.logsumexp(torch.clamp(alphas[-1] + lat.final, min=NEG_INF), 1) + norms[-1]

    logz = logz_of(wa, wn)
    errs["latfb_logz_fwd"] = max(
        close_log(f"K7 {label} alphas", ga, wa),
        close(f"K7 {label} norms", gn, wn, LAT_TOL["log"], LAT_TOL["log"]),
        close(f"K7 {label} logZ", logz_of(ga, gn), logz, LAT_TOL["log"], LAT_TOL["log"]))

    alpha0 = KC.initial_alpha(b, k, wa)
    args = (*band, active, FL._prev(wa, alpha0), FL._prev(wn, wn.new_zeros(b))[:, :, None],
            lat.final, logz[:, None].contiguous())
    calls["latfb_occupancies_bwd"] = (lambda: KC.occupancies_bwd(*args),
                                      lambda: KC.occupancies_bwd_plain(*args))
    gamma, want = run(*calls["latfb_occupancies_bwd"])
    errs["latfb_occupancies_bwd"] = close(f"K8 {label} gamma", gamma, want, LAT_TOL["abs"],
                                          LAT_TOL["rel"])

    calls["latfb_smbr_fwd"] = (lambda: KC.smbr_fwd(*band, active, arc_acc, k),
                               lambda: KC.smbr_fwd_plain(*band, active, arc_acc, k))
    (ga, gc, gn), (wa, wc, wn) = run(*calls["latfb_smbr_fwd"])
    errs["latfb_smbr_fwd"] = max(
        close_log(f"K9 {label} alphas", ga, wa),
        close(f"K9 {label} aaccs", gc, wc, LAT_TOL["abs"], LAT_TOL["rel"]),
        close(f"K9 {label} norms", gn, wn, LAT_TOL["log"], LAT_TOL["log"]))

    total = torch.clamp(wa[-1] + lat.final, min=NEG_INF)
    f = torch.sum(torch.softmax(total, 1) * wc[-1], 1)
    args10 = (*band, active, arc_acc, FL._prev(wa, alpha0), FL._prev(wc, torch.zeros_like(wc[0])),
              FL._prev(wn, wn.new_zeros(b))[:, :, None], lat.final, logz_of(wa, wn)[:, None].contiguous(),
              f[:, None].contiguous())
    calls["latfb_smbr_bwd"] = (lambda: KC.smbr_contribs_bwd(*args10),
                               lambda: KC.smbr_contribs_bwd_plain(*args10))
    contrib, want = run(*calls["latfb_smbr_bwd"])
    errs["latfb_smbr_bwd"] = close(f"K10 {label} contrib", contrib, want,
                                   LAT_TOL["abs"] * torch.clamp(f.abs(), min=1.0)[None, :, None],
                                   LAT_TOL["rel"])
    if rows is None:
        return errs
    for name, (kernel, plain) in calls.items():
        kno, replaces, per_arc, per_slot = LATFB[name]
        bms, by = bound_ms(latfb_bytes(name, t, b, a, k),
                           [(t * b * (per_arc * a + per_slot * k), FP32_FLOPS)])
        rows[name] = dict(
            name=name, route="cuda", source="pykaldi2_tpu_torch/csrc/latfb.cu",
            replaces=replaces, max_abs_err=errs[name], ms=timed(kernel, n=10),
            plain_ms=timed(plain, n=2, warmup=1), bound_ms=bms, bound_by=by, library_ms=None)
        r = rows[name]
        print(f"kernel {kno} {name} ({label}, B={b} T={t} K={k} A={a}): {r['ms']:.4f} ms | "
              f"plain {r['plain_ms']:.4f} ms | library n/a | bound {bms:.4f} ms ({by}, "
              f"{latfb_bytes(name, t, b, a, k)} bytes)", flush=True)
    return errs


def latfb_probe(dev) -> dict:
    """Phase 2, K7-K10: the bench's probe lattice (bench.py:626-647), fully
    dense random bands at B=32, T=448, K=A=256 over 8952 pdfs; returns its
    rows (errors, times, bounds)."""
    import torch

    from pykaldi2_tpu_torch.ops.fb_lattice import TimeSyncLattice

    b, t, k = SE_B, SE_T, SE_PROBE_KA
    gen = torch.Generator(device=dev).manual_seed(0)

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=dev, dtype=torch.int32)

    lat = TimeSyncLattice(
        src=ints(k, (b, t, k)), dst=ints(k, (b, t, k)), pdf=ints(SENONES, (b, t, k)),
        weight=torch.randn(b, t, k, generator=gen, device=dev) * 0.1,
        final=torch.zeros(b, k, device=dev))
    obs = torch.randn(b, t, SENONES, generator=gen, device=dev) * 0.1
    nf = torch.full((b,), t, dtype=torch.int32, device=dev)
    rows = {}
    latfb_compare(dev, "probe", obs, lat, nf, ints(SENONES, (b, t)), rows)
    return rows


def make_chain_graph(num_chains: int = CHAIN[0], chain_len: int = CHAIN[1],
                     num_pdfs: int = SENONES, seed: int = 0):
    """Copy of bench.py:463-499's ``_make_chain_graph``: a word-denominator
    shaped graph of linear pdf chains and a shared loop state (each chain end
    returns to the loop, the loop fans out to every chain start; self-loops
    on chain states) — 96,001 states and 192,000 arcs at the defaults."""
    import numpy as np

    from pykaldi2_tpu_torch.ops.fsa import DenseFsa

    rng = np.random.RandomState(seed)
    S = 1 + num_chains * chain_len
    src, dst, wt = [], [], []
    loop = 0
    state_pdf = np.zeros(S, np.int64)
    state_pdf[1:] = rng.randint(1, num_pdfs, S - 1)
    for c in range(num_chains):
        s0 = 1 + c * chain_len
        src.append(loop)
        dst.append(s0)
        wt.append(-np.log(num_chains))
        for i in range(chain_len - 1):
            src.append(s0 + i)
            dst.append(s0 + i + 1)
            wt.append(-0.1)
            src.append(s0 + i)  # self-loop (HMM-style durations)
            dst.append(s0 + i)
            wt.append(-2.3)
        src.append(s0 + chain_len - 1)
        dst.append(loop)
        wt.append(-0.1)
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    final = np.full(S, -np.inf, np.float32)
    final[loop] = 0.0
    return DenseFsa(S, src, dst, state_pdf[dst].astype(np.int32), np.asarray(wt, np.float32),
                    final, 0)


def blockfb_bytes(g, rows: int, transpose: bool) -> int:
    """Bytes K11 must move: the tiles, x, the index arrays read once, the
    output written once."""
    from pykaldi2_tpu_torch.ops.fb_block_cuda import _orientation

    src_blk, _dst, tiles, rowptr = _orientation(g, transpose)
    return (tiles.numel() * 4 + 2 * rows * g.num_padded * 4 + src_blk.numel() * 4
            + rowptr.numel() * 4)


def bsr_call(g, transpose: bool, x):
    """The library yardstick: one ``torch.sparse.mm`` of a BSR matrix with
    128-blocks built from the same tiles (out^T = W^T x^T; W^T's block row j
    holds tile n^T at block column i_n, and the tile list is already in that
    row order). Returns (a callable, None) or (None, the error it raised)."""
    import torch

    from pykaldi2_tpu_torch.ops.fb_block_cuda import _orientation

    src_blk, _dst, tiles, rowptr = _orientation(g, transpose)
    try:
        bsr = torch.sparse_bsr_tensor(rowptr.long(), src_blk.long(),
                                      tiles.transpose(1, 2).contiguous(),
                                      size=(g.num_padded, g.num_padded))
        xt = x.t().contiguous()
        fn = lambda: torch.sparse.mm(bsr, xt)  # noqa: E731
        out = fn()
        torch.cuda.synchronize()
        return fn, out.t()
    except Exception as e:  # the yardstick only: the port never calls it
        return None, e


def blockfb_checks(dev, g=None) -> tuple:
    """Phase 10, K11: the block-sparse matvec against its plain version at
    the main path's shapes — the all-COO tiles of the 96k-state chain graph,
    both orientations, R = 16 (MMI, sMBR's beta) and R = 32 (sMBR's stacked
    rows) — and timed beside its bound and the BSR library call. Returns
    (row of the R = 16 forward orientation, the packed graph on the card)."""
    import torch

    from pykaldi2_tpu_torch.ops.fb_block import pack_graph_blocks
    from pykaldi2_tpu_torch.ops.fb_block_cuda import block_matvec, block_matvec_plain

    if g is None:
        t0 = time.perf_counter()
        fsa = make_chain_graph()
        g = pack_graph_blocks(fsa)
        print(f"chain graph: {fsa.num_states} states, {fsa.num_arcs} arcs → Sp={g.num_padded}, "
              f"{g.wb.shape[0]} tiles (forward), {g.wbt.shape[0]} (transposed); packed on the "
              f"host in {time.perf_counter() - t0:.2f} s", flush=True)
        g = g.to(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    row, errs = None, []
    for rows in (FD_B, 2 * FD_B):
        for transpose in (False, True):
            x = torch.rand(rows, g.num_padded, generator=gen, device=dev)
            x[:, g.num_states:] = 0.0      # padded states: 0 in linear form
            got = block_matvec(x, g, transpose)
            again = block_matvec(x, g, transpose)
            torch.cuda.synchronize()
            label = f"K11 block_matvec R={rows} {'transposed' if transpose else 'forward'}"
            if not torch.equal(got, again):
                fail(f"{label}: two calls on the same inputs differ")
            want = block_matvec_plain(x, g, transpose)
            scale = want.abs().max(dim=1, keepdim=True).values
            worst = float(((got - want).abs() / (BLOCK_TOL * scale)).max())
            err = float((got - want).abs().max())
            print(f"{label}: max_abs_err {err:.3e}, worst error / ({BLOCK_TOL:g}*row max) "
                  f"{worst:.3f}", flush=True)
            if not math.isfinite(worst) or worst > 1.0:
                fail(f"{label} disagrees with its plain version (worst ratio {worst})")
            if not bool((got[:, g.num_states:] == 0).all()):
                fail(f"{label}: padded states are not exactly 0")
            errs.append(err)
            nbytes = blockfb_bytes(g, rows, transpose)
            ntiles = (g.wbt if transpose else g.wb).shape[0]
            bms, by = bound_ms(nbytes, [(2 * rows * g.block * g.block * ntiles, FP32_FLOPS)])
            lib_fn, lib_out = bsr_call(g, transpose, x)
            lib_ms = None
            if lib_fn is None:
                print(f"{label}: the BSR library call raised: {lib_out!r}", flush=True)
            elif not bool(torch.allclose(lib_out, want, rtol=1e-4, atol=1e-6)):
                print(f"{label}: the BSR library call disagrees with the plain version "
                      f"(max {float((lib_out - want).abs().max()):.3e}); not timed", flush=True)
            else:
                lib_ms = timed(lib_fn, n=20)
            r = dict(name="block_matvec", route="cuda",
                     source="pykaldi2_tpu_torch/csrc/blockfb.cu",
                     replaces="pykaldi2_tpu/ops/fb_block.py:297",
                     ms=timed_graph(lambda: block_matvec(x, g, transpose)),
                     plain_ms=timed(lambda: block_matvec_plain(x, g, transpose), n=10),
                     bound_ms=bms, bound_by=by, library_ms=lib_ms)
            eager = timed(lambda: block_matvec(x, g, transpose), n=50)
            lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
            print(f"kernel {label}: {r['ms']:.4f} ms (CUDA graph of 50 calls; eager calls "
                  f"{eager:.4f} ms) | plain {r['plain_ms']:.4f} ms | library (BSR sparse.mm) "
                  f"{lib} ms | bound {bms:.4f} ms ({by}, {nbytes} bytes)", flush=True)
            if row is None:
                row = r
    row["max_abs_err"] = max(errs)
    return row, g


def blstm_grad_check(dev, proj: int = 0):
    """A 2-layer BLSTM, or BLSTMP with ``proj`` (reversed direction, masks,
    dWh, dWp and the bf16 GEMM gradients) on the card against the same module
    on the CPU."""
    import torch

    from pykaldi2_tpu_torch.models.lstm import LSTMStack

    gen = torch.Generator().manual_seed(3)
    cpu = LSTMStack(80, 256, 2, bidirectional=True, proj_size=proj, generator=gen)
    card = LSTMStack(80, 256, 2, bidirectional=True, proj_size=proj).to(dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(16, 30, 80, generator=gen)
    mask = torch.ones(16, 30)
    mask[3, 17:] = 0.0
    w = torch.randn(16, 30, cpu.output_size, generator=gen)
    outs = []
    for mod, d in ((cpu, "cpu"), (card, dev)):
        y = mod(x.to(d), mask.to(d))
        (y * w.to(d)).sum().backward()
        outs.append((y.detach().cpu(), {k: p.grad.cpu() for k, p in mod.named_parameters()}))
    torch.cuda.synchronize()
    (y_cpu, g_cpu), (y_card, g_card) = outs
    what = f"BLSTMP (P={proj})" if proj else "BLSTM"
    check(f"{what} forward, card vs CPU plain path", y_card, y_cpu, TOL["blstm_out"])
    worst = max(float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max())
                for k in g_cpu)
    print(f"{what} gradients, card vs CPU: max error relative to each tensor's "
          f"max {worst:.3e} (tolerance {TOL['blstm_grad_rel']:g})", flush=True)
    if not math.isfinite(worst) or worst > TOL["blstm_grad_rel"]:
        fail(f"{what} gradients disagree: {worst}")


def recurrence_sweep(dev):
    """Phase 6: K2/K3 time against T and B at H=1024, which separates the
    per-step cost (slope in T) from the fixed cost of a launch and shows how
    a step's cost grows with the batch rows; beside it at each B, cuDNN's
    bf16 ``nn.LSTM`` forward and backward-data (the yardsticks of phase 2)."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    rng = np.random.RandomState(1)
    wh = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (H, 4 * H)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    cudnn = torch.nn.LSTM(H, H).to(device=dev, dtype=torch.bfloat16)
    cudnn.flatten_parameters()
    for prm in cudnn.parameters():
        prm.requires_grad_(False)
    print("recurrence sweep (H=1024): T, B, K2 ms, K3 ms, K2 us/step, K3 us/step", flush=True)
    for b in (16, 32, 64):
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
        x_lib = torch.randn(T, b, H, device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            lib_f = timed(lambda: cudnn(x_lib))
        x_req = x_lib.clone().requires_grad_(True)
        out, _ = cudnn(x_req)
        d_out = torch.randn_like(out)
        lib_b = timed(lambda: torch.autograd.grad(out, x_req, d_out, retain_graph=True))
        print(f"  cuDNN T={T} B={b:3d}  fwd {lib_f:.4f} ms ({1e3 * lib_f / T:.2f} us/step)  "
              f"backward-data {lib_b:.4f} ms ({1e3 * lib_b / T:.2f} us/step)", flush=True)


def write_corpus(root: str, n_utts: int = 128, seconds=(1.0, 3.0), num_labels: int = SENONES,
                 seed: int = 0) -> dict:
    """Synthetic 16 kHz corpus of random audio: wav.scp + a binary ark of
    random pdf-ids below ``num_labels``."""
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
            n = int(16000 * rng.uniform(*seconds))
            path = os.path.join(root, "wav", f"utt{i:04d}.wav")
            write_wav(path, (rng.randn(n) * 3000).astype(np.float32))
            lines.append(f"utt{i:04d} {path}\n")
            w.write(f"utt{i:04d}", rng.randint(0, num_labels, num_frames(n, fo)).astype(np.int32))
    scp = os.path.join(root, "wav.scp")
    with open(scp, "w") as f:
        f.writelines(lines)
    return {"wav_scp": scp, "label_ark": ali}


def counted() -> dict:
    """Every kernel wrapper by its row name, K1-K11; each counts its launches."""
    from pykaldi2_tpu_torch.frontend.fused import fused_fbank, fused_mfcc
    from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC
    from pykaldi2_tpu_torch.ops import lstm_cuda as L
    from pykaldi2_tpu_torch.ops.fb_block_cuda import block_matvec

    return {"fbank": fused_fbank, "lstm_fwd": L.lstm_fwd, "lstm_bwd": L.lstm_bwd,
            "mfcc": fused_mfcc, "lstm_proj_fwd": L.lstm_proj_fwd,
            "lstm_proj_bwd": L.lstm_proj_bwd, "latfb_logz_fwd": KC.logz_fwd,
            "latfb_occupancies_bwd": KC.occupancies_bwd, "latfb_smbr_fwd": KC.smbr_fwd,
            "latfb_smbr_bwd": KC.smbr_contribs_bwd, "block_matvec": block_matvec}


def zero_counts() -> None:
    for fn in counted().values():
        fn.launches = 0


def read_counts() -> dict:
    import torch

    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counted().items()}


def train_ce_run(dev, what: str, cfg_yaml: str, data_yaml: str, exp: str) -> tuple:
    """``bin/train_ce.main`` with the counts zeroed just before and read just
    after; fails unless it wrote finite step losses and a checkpoint.
    Returns (launches, number of steps)."""
    from pykaldi2_tpu_torch.bin import train_ce

    zero_counts()
    rc = train_ce.main(["-config", cfg_yaml, "-data", data_yaml, "-exp_dir", exp],
                       device=str(dev))
    launches = read_counts()
    if rc != 0:
        fail(f"{what}: train_ce.main returned {rc}")
    print(f"{what} launches: {json.dumps(launches)}", flush=True)
    steps = step_records(exp)
    if not steps or not all(math.isfinite(r["loss"]) for r in steps):
        fail(f"{what} wrote no finite step losses: {steps}")
    print(f"{what}: {len(steps)} steps, losses {[round(r['loss'], 4) for r in steps]}",
          flush=True)
    if not os.path.exists(os.path.join(exp, "model.0.npz")):
        fail(f"{what} wrote no checkpoint")
    return launches, len(steps)


def need_launches(what: str, launches: dict, positive=(), zero=()) -> None:
    for name in positive:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the {what}")
    for name in zero:
        if launches[name] != 0:
            fail(f"kernel {name} was launched {launches[name]} times on the {what}")


def blstmp_path(dev, root: str, data_yaml: str) -> tuple:
    """Phase 7: the BLSTMP 4x1024/512 CE run (bench.py:185-205) on phase 3's
    corpus; returns (launches, cfg_yaml)."""
    import yaml

    cfg_yaml = os.path.join(root, "blstmp.yaml")
    with open(cfg_yaml, "w") as f:
        yaml.safe_dump({
            "model": {"type": "blstm", "hidden_size": H, "num_layers": LAYERS,
                      "proj_size": PROJ, "output_size": SENONES, "compute_dtype": "bfloat16"},
            "optimizer": {"type": "momentum", "momentum": 0.9, "lr": 0.01, "grad_clip": 5.0},
            "trainer": {"batch_size": B, "chunk_len": T, "num_epochs": 1,
                        "log_interval": 1, "seed": 777}}, f)
    exp = os.path.join(root, "exp_blstmp")
    launches, steps = train_ce_run(dev, "BLSTMP CE path", cfg_yaml, data_yaml, exp)
    need_launches("BLSTMP CE path", launches, positive=("fbank",),
                  zero=("lstm_fwd", "lstm_bwd"))
    per_step = 2 * LAYERS  # one K5 and one K6 launch per (layer, direction)
    for name in ("lstm_proj_fwd", "lstm_proj_bwd"):
        if launches[name] != per_step * steps:
            fail(f"kernel {name} launched {launches[name]} times in {steps} BLSTMP steps, "
                 f"expected {per_step} a step")
    eval_check(dev, exp, cfg_yaml, data_yaml, "BLSTMP")
    step_timing(dev, cfg_yaml, data_yaml, "BLSTMP")
    return launches, cfg_yaml


def mfcc_path(dev, root: str, data_yaml: str, ce_yaml: str) -> dict:
    """Phase 8: the MFCC recipe (compute_cmvn_stats, compute_feats, train_ce)
    on phase 3's corpus; returns the launches summed over the phase."""
    import numpy as np
    import torch
    import yaml

    from pykaldi2_tpu_torch.bin import compute_cmvn_stats, compute_feats
    from pykaldi2_tpu_torch.data import kaldi_io
    from pykaldi2_tpu_torch.data.wav import read_wav
    from pykaldi2_tpu_torch.frontend.fused import fused_mfcc_plain

    with open(data_yaml) as f:
        corpus = {k: v for k, v in yaml.safe_load(f).items() if k != "feat"}
    hires = {"frame_opts": {"dither": 0.0}, **MFCC_HIRES}
    mfcc_yaml = os.path.join(root, "mfcc_data.yaml")
    with open(mfcc_yaml, "w") as f:
        yaml.safe_dump({**corpus, "feat": {"type": "mfcc", "mfcc": hires}}, f)
    total = dict.fromkeys(counted(), 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    stats = os.path.join(root, "cmvn_mfcc_hires.mat")
    zero_counts()
    t0 = time.perf_counter()
    if compute_cmvn_stats.main(["-data", mfcc_yaml, "-output", stats], device=str(dev)) != 0:
        fail("compute_cmvn_stats.main failed")
    got = read_counts()
    print(f"compute_cmvn_stats (mfcc_hires): {time.perf_counter() - t0:.2f} s, launches "
          f"{json.dumps(got)}", flush=True)
    need_launches("compute_cmvn_stats path", got, positive=("mfcc",))
    add(got)
    from pykaldi2_tpu_torch.pipeline import load_cmvn_stats

    st = load_cmvn_stats(stats)
    if st.shape != (2, 41) or not np.isfinite(st).all() or st[0, -1] <= 0:
        fail(f"compute_cmvn_stats wrote stats of shape {st.shape}, count {st[0, -1]}")

    ark = os.path.join(root, "mfcc_hires.ark")
    zero_counts()
    t0 = time.perf_counter()
    if compute_feats.main(["-data", mfcc_yaml, "-out", ark], device=str(dev)) != 0:
        fail("compute_feats.main failed")
    got = read_counts()
    print(f"compute_feats (mfcc_hires): {time.perf_counter() - t0:.2f} s, launches "
          f"{json.dumps(got)}", flush=True)
    need_launches("compute_feats path", got, positive=("mfcc",))
    add(got)
    feats = dict(kaldi_io.read_ark(ark))
    uid, path = next(iter(kaldi_io.read_scp(corpus["wav_scp"])))
    wave, _ = read_wav(path)
    want = fused_mfcc_plain(torch.from_numpy(wave.astype(np.float32)[None]),
                            mfcc_opts(MFCC_HIRES))[0]
    if feats[uid].shape != tuple(want.shape):
        fail(f"compute_feats wrote {feats[uid].shape} for {uid}, expected {tuple(want.shape)}")
    check(f"compute_feats {uid} (card, padded) vs K4's plain version on the CPU",
          torch.from_numpy(feats[uid]), want, TOL["mfcc"])

    train_yaml = os.path.join(root, "mfcc_train.yaml")
    with open(train_yaml, "w") as f:
        yaml.safe_dump({**corpus, "feat": {"type": "mfcc", "mfcc": hires,
                                           "cmvn": {"stats_path": stats}}}, f)
    got, _ = train_ce_run(dev, "MFCC CE path", ce_yaml, train_yaml,
                          os.path.join(root, "exp_mfcc"))
    need_launches("MFCC CE path", got, positive=("mfcc", "lstm_fwd", "lstm_bwd"),
                  zero=("fbank",))
    add(got)
    step_timing(dev, ce_yaml, train_yaml, "MFCC")
    return total


def main_path(dev, root: str):
    """Phase 3: the port's CLI at full width; returns (exp_dir, launches)."""
    import yaml

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
    launches, _ = train_ce_run(dev, "main path", cfg_yaml, data_yaml, exp)
    need_launches("main path", launches, positive=("fbank", "lstm_fwd", "lstm_bwd"))
    return exp, cfg_yaml, data_yaml, launches


def eval_check(dev, exp: str, cfg_yaml: str, data_yaml: str, what: str = "eval"):
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
    print(f"{what}: loss {loss:.4f} over {int(cnt)} frames, frame_acc "
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
    check(f"{what} logits, card vs CPU plain path", got.cpu(), want, TOL["eval_logits"])


def step_timing(dev, cfg_yaml: str, data_yaml: str, what: str = "train step") -> dict:
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
    print(f"{what}: {out['step_ms']:.3f} ms mean over {n} queued steps | "
          f"{out['frames_per_sec']:.0f} frames/s | {out['utt_per_sec']:.2f} utt/s "
          f"(frames/s / {FRAMES_PER_UTT:g}) | fenced step p50 {lat[49]:.3f} ms, p90 "
          f"{lat[89]:.3f} ms (100 steps) | peak {out['peak_mem_gib']:.2f} GiB", flush=True)

    out["device_busy_share"] = profile_steps(lambda: step(batch, gen), 3, f"{what} profile")
    return out


def profile_steps(fn, n: int, what: str, top: int = 15, share_of: str = None) -> float:
    """Profile n calls of fn; print the device busy share and the top kernels
    by device time per call (and, with ``share_of``, the share of device time
    of the kernels whose name holds it); returns the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
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
    print(f"{what}, {n} steps: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall ({100 * busy_us / wall_us:.1f}%); top kernels by device time:", flush=True)
    for e in sorted(evs, key=lambda e: -_self_device_us(e))[:top]:
        print(f"  {_self_device_us(e) / (n * 1e3):9.3f} ms/step  x{e.count // n:<5d} "
              f"{e.key[:90]}", flush=True)
    if share_of:
        mine = sum(_self_device_us(e) for e in evs if share_of in e.key)
        print(f"{what}: {share_of} {mine / (n * 1e3):.3f} ms/step, {100 * mine / busy_us:.1f}% "
              f"of device time", flush=True)
    return busy_us / wall_us


def _self_device_us(event) -> float:
    """Self device time of a profiler row (named self_cuda_time_total before
    torch 2.4)."""
    v = getattr(event, "self_device_time_total", None)
    return float(event.self_cuda_time_total if v is None else v)


def se_path(dev, root: str, ce_ckpt: str):
    """Phase 7: ``bin/train_se.main -on_the_fly -decoder host`` at full width,
    3 steps under MMI and 3 under sMBR. Returns ({banded kernel: launches in
    the run that drives it}, {criterion: the run's first decoded batch as
    (TimeSyncLattice, obs, num_frames)}, se.yaml, data.yaml)."""
    import yaml

    from pykaldi2_tpu_torch.bin import train_se
    from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel

    tm = TransitionModel(HmmTopology.three_state(range(1, SE_PHONES + 1)))
    corpus = write_corpus(os.path.join(root, "se_corpus"), SE_UTTS, (4.0, 4.5), tm.num_pdfs,
                          seed=1)
    mdl = os.path.join(root, "se_corpus", "final.mdl")
    tm.write_kaldi(mdl)
    data_yaml, cfg_yaml = os.path.join(root, "se_data.yaml"), os.path.join(root, "se.yaml")
    with open(data_yaml, "w") as f:
        yaml.safe_dump({**corpus, "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                                     "mel_opts": {"num_bins": BINS}}}}, f)
    with open(cfg_yaml, "w") as f:  # examples/librispeech/se.yaml, one 448-frame bucket of 32
        yaml.safe_dump({
            "model": {"type": "lstm", "hidden_size": H, "num_layers": LAYERS,
                      "output_size": SENONES, "compute_dtype": "bfloat16"},
            "optimizer": {"type": "momentum", "momentum": 0.9, "lr": 1e-5, "grad_clip": 5.0},
            "trainer": {"batch_size": SE_B, "num_epochs": 1, "log_interval": 1, "seed": 777,
                        "acoustic_scale": 0.1, "ce_ratio": 0.1,
                        "bucket_boundaries": [SE_T]}}, f)
    need = {"mmi": ("latfb_logz_fwd", "latfb_occupancies_bwd"),
            "smbr": ("latfb_smbr_fwd", "latfb_smbr_bwd")}
    threads = min(os.cpu_count() or 1, 16)
    first, current = {}, {}
    decode = train_se.decode_batch

    def capture(decoders, pool, obs, nf):  # keeps each run's first decoded batch
        out = decode(decoders, pool, obs, nf)
        first.setdefault(current["crit"], (out[0], obs, nf))
        return out

    launches = {}
    train_se.decode_batch = capture
    try:
        for crit in ("mmi", "smbr"):
            current["crit"] = crit
            exp = os.path.join(root, f"se_{crit}")
            zero_counts()
            rc = train_se.main(
                ["-config", cfg_yaml, "-data", data_yaml, "-exp_dir", exp, "-on_the_fly",
                 "-decoder", "host", "-criterion", crit, "-seed_model", ce_ckpt,
                 "-trans_model", mdl, "-beam", "10", "-lattice_beam", "4", "-max_active", "200",
                 "-num_threads", str(threads)], device=str(dev))
            got = read_counts()
            if rc != 0:
                fail(f"train_se.main -criterion {crit} returned {rc}")
            print(f"SE {crit} path launches: {json.dumps(got)}", flush=True)
            for name in ("fbank", "lstm_fwd", "lstm_bwd") + need[crit]:
                if got[name] <= 0:
                    fail(f"kernel {name} was not launched on the SE {crit} path")
            launches.update({name: got[name] for name in need[crit]})
            steps = step_records(exp)
            if len(steps) != SE_UTTS // SE_B or not all(math.isfinite(r["objective"])
                                                         for r in steps):
                fail(f"SE {crit} path: expected {SE_UTTS // SE_B} steps with finite "
                     f"objectives, got {steps}")
            for r in steps:
                print(f"SE {crit} step {int(r['step'])}: objective {r['objective']:.5f} frame_acc "
                      f"{r['frame_acc']:.4f} | lattice K {int(r['lat_k'])} A {int(r['lat_a'])} | forward "
                      f"{r['forward_ms']:.1f} ms, host decode {r['decode_ms']:.1f} ms, pack "
                      f"{r['pack_ms']:.1f} ms, wait {r['wait_ms']:.1f} ms, train step "
                      f"{r['train_ms']:.1f} ms ({threads} decode threads)", flush=True)
    finally:
        train_se.decode_batch = decode
    return launches, first, cfg_yaml, data_yaml


def se_step_checks(dev, first: dict, cfg_yaml: str, data_yaml: str, ckpt: str) -> dict:
    """Phase 7, after the runs: K7-K10 against their plain versions on the
    sMBR run's first decoded batch (the main path's shapes, timed), then one
    SE train step per criterion on that batch and lattice, fenced and
    profiled. Returns the kernel rows."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import make_se_lattice_steps
    from pykaldi2_tpu_torch.utils import load_checkpoint, make_optimizer

    lat, obs_np, nf_np = first["smbr"]
    lat = lat.to(dev)
    nf = torch.from_numpy(nf_np).to(dev)
    ref = torch.randint(0, SE_PHONES * 3, tuple(obs_np.shape[:2]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    rows = {}
    latfb_compare(dev, "decoded", torch.from_numpy(obs_np).to(dev), lat, nf, ref, rows)

    cfg = load_config(cfg_yaml)
    cfg.data = load_data_config(data_yaml)
    dataset, feat_fn, _ = build_frontend(cfg.data)
    cfg.model.input_size = feat_fn.dim
    loader = SeqDataloader(dataset, BucketSpec(boundaries=(SE_T,), batch_sizes=SE_B),
                           shuffle=cfg.data.shuffle, seed=cfg.trainer.seed)
    loader.set_epoch(0)
    batch_np = next(iter(loader))
    if not np.array_equal(batch_np["num_frames"], nf_np):
        fail("the loader's first SE batch is not the one the captured lattice was decoded for")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items() if k != "utt_ids"}
    log_prior = priors_from_counts(count_labels(dataset.labels.values(), cfg.model.output_size))
    gen = torch.Generator(device=dev).manual_seed(2)
    for crit in ("mmi", "smbr"):
        model = build_model(cfg.model).to(dev)
        load_checkpoint(ckpt, model)
        _fwd, train = make_se_lattice_steps(
            model, feat_fn, make_optimizer(cfg.optimizer, model.parameters()),
            log_prior=log_prior, acoustic_scale=cfg.trainer.acoustic_scale,
            ce_ratio=cfg.trainer.ce_ratio, criterion=crit)
        torch.cuda.reset_peak_memory_stats(dev)
        train(batch, lat, gen)
        torch.cuda.synchronize()
        lat_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            m = train(batch, lat, gen)
            obj = float(m["objective"])
            torch.cuda.synchronize()
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(obj):
            fail(f"SE {crit} train step reached objective {obj}")
        print(f"SE {crit} train step (B={SE_B}, T={SE_T}, K={lat.num_slots}, "
              f"A={lat.src.shape[2]}): fenced {', '.join(f'{x:.2f}' for x in lat_ms)} ms, "
              f"objective {obj:.5f}, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
        profile_steps(lambda: train(batch, lat, gen), 2, f"SE {crit} train step profile", top=12)
    return rows


def expected_block_launches(crit: str, t_lens, sp: int) -> int:
    """K11 launches of the block route's train steps, derived from the code:
    MMI computes logZ and the occupancies in its forward (T matvecs each);
    when the [T, B, Sp] alpha history (two for sMBR: alpha and accumulator)
    passes the 3 GiB save budget, the backward recomputes each segment first
    (another T). So 2T a step with the full save, 3T with remat."""
    hist = 1 if crit == "mmi" else 2
    return sum((2 if hist * t * FD_B * sp * 4 <= (3 << 30) else 3) * t for t in t_lens)


def step_records(exp: str) -> list:
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "step" in r]


def train_se_fixed_run(dev, what: str, argv: list, steps: int) -> tuple:
    """``bin/train_se.main`` without ``-on_the_fly``, the counts zeroed just
    before and read just after; fails unless it ran ``steps`` steps with
    finite objectives. Returns (launches, step records)."""
    from pykaldi2_tpu_torch.bin import train_se

    zero_counts()
    t0 = time.perf_counter()
    rc = train_se.main(argv, device=str(dev))
    launches = read_counts()
    if rc != 0:
        fail(f"{what}: train_se.main returned {rc}")
    print(f"{what}: {time.perf_counter() - t0:.1f} s, launches {json.dumps(launches)}",
          flush=True)
    exp = argv[argv.index("-exp_dir") + 1]
    recs = step_records(exp)
    if len(recs) != steps or not all(math.isfinite(r["objective"]) for r in recs):
        fail(f"{what}: expected {steps} steps with finite objectives, got {recs}")
    for r in recs:
        print(f"{what} step {int(r['step'])}: objective {r['objective']:.5f} frame_acc "
              f"{r['frame_acc']:.4f} | T {int(r['t_len'])} | train step {r['train_ms']:.1f} ms",
              flush=True)
    return launches, recs


def fixed_step_timing(dev, what: str, cfg_yaml: str, data_yaml: str, den, crit: str, ckpt: str,
                      log_prior, pdf_to_phone, smi: str) -> None:
    """Phase 10, timing: one fixed-denominator train step on the loader's
    first batch, fenced 3 times after a warm-up, its peak memory, then a
    profile of one step (device busy share, K11's share, top kernels)."""
    import torch

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import make_se_train_step
    from pykaldi2_tpu_torch.utils import load_checkpoint, make_optimizer

    cfg = load_config(cfg_yaml)
    cfg.data = load_data_config(data_yaml)
    dataset, feat_fn, _ = build_frontend(cfg.data)
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model).to(dev)
    load_checkpoint(ckpt, model)
    step = make_se_train_step(
        model, feat_fn, make_optimizer(cfg.optimizer, model.parameters()), den, crit,
        log_prior=log_prior, acoustic_scale=cfg.trainer.acoustic_scale,
        ce_ratio=cfg.trainer.ce_ratio, pdf_to_phone=pdf_to_phone)
    loader = SeqDataloader(dataset, BucketSpec(boundaries=tuple(cfg.trainer.bucket_boundaries),
                                               batch_sizes=cfg.trainer.batch_size),
                           shuffle=False, seed=cfg.trainer.seed)
    loader.set_epoch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(iter(loader)).items()
             if k != "utt_ids"}
    gen = torch.Generator(device=dev).manual_seed(2)
    torch.cuda.reset_peak_memory_stats(dev)
    step(batch, gen)
    torch.cuda.synchronize()
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = step(batch, gen)
        obj = float(m["objective"])
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    if not math.isfinite(obj):
        fail(f"{what} train step reached objective {obj}")
    b, t = batch["labels"].shape
    print(f"{what} train step (B={b}, T={t}; {smi}): fenced "
          f"{', '.join(f'{x:.2f}' for x in lat)} ms, objective {obj:.5f}, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    profile_steps(lambda: step(batch, gen), 1, f"{what} train step profile ({smi})", top=12,
                  share_of="block_matvec")


def fixed_den_card_vs_cpu(dev) -> None:
    """Phase 10: one block-route train step of a small LSTM on a small chain
    graph (401 states, 4 blocks of 128) on the card (K11) and on the CPU
    (plain K11), from the same weights and batch, under MMI and sMBR in both
    backward modes. The LSTM's recurrent products round h to bf16 on both
    sides, and a rounding tie that fp32 noise flips moves later steps by a
    bf16 ulp: objectives agree to 1e-3·max(1, |obj|) and gradients to 1e-2 of
    each tensor's max (as ``blstm_grad_check``)."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.config import (FbankOpts, FeatConfig, FrameOpts, MelOpts,
                                           ModelConfig, OptimizerConfig)
    from pykaldi2_tpu_torch.data.dataloader import chunk_samples
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.ops.fb_block import pack_graph_blocks
    from pykaldi2_tpu_torch.pipeline import FeaturePipeline
    from pykaldi2_tpu_torch.trainer import make_se_train_step
    from pykaldi2_tpu_torch.utils import make_optimizer

    pdfs = 50
    g = pack_graph_blocks(make_chain_graph(40, 10, pdfs))
    feat_cfg = FeatConfig(fbank=FbankOpts(frame_opts=FrameOpts(dither=0.0),
                                          mel_opts=MelOpts(num_bins=24)))
    mcfg = ModelConfig(type="lstm", input_size=24, hidden_size=64, num_layers=2,
                       output_size=pdfs, compute_dtype="float32")
    rng = np.random.RandomState(9)
    b, t = 4, 60
    batch = {"wave": torch.tensor((rng.randn(b, chunk_samples(t, feat_cfg.fbank.frame_opts))
                                   * 3000).astype(np.float32)),
             "labels": torch.tensor(rng.randint(0, pdfs, (b, t)).astype(np.int32)),
             "num_frames": torch.tensor([60, 50, 40, 30], dtype=torch.int32)}
    batch["mask"] = (torch.arange(t)[None, :] < batch["num_frames"][:, None]).float()
    batch["labels"][batch["mask"] == 0] = -1
    opt = OptimizerConfig(type="sgd", lr=0.0, grad_clip=0.0)
    base = build_model(mcfg, generator=torch.Generator().manual_seed(4))
    for crit in ("mmi", "smbr"):
        for budget in (str(3 << 30), "0"):
            os.environ["PK2_BLOCKFB_SAVE_BYTES"] = budget
            out = []
            for d in ("cpu", dev):
                model = build_model(mcfg).to(d)
                model.load_state_dict(base.state_dict())
                step = make_se_train_step(model, FeaturePipeline(feat_cfg),
                                          make_optimizer(opt, model.parameters()), g, crit,
                                          acoustic_scale=0.1, ce_ratio=0.1)
                m = step({k: v.to(d) for k, v in batch.items()})
                out.append((float(m["objective"]),
                            {k: p.grad.detach().cpu() for k, p in model.named_parameters()}))
            del os.environ["PK2_BLOCKFB_SAVE_BYTES"]
            (o_cpu, g_cpu), (o_card, g_card) = out
            mode = "full save" if budget != "0" else "remat"
            d_obj = abs(o_card - o_cpu)
            worst = max(float((g_card[k] - g_cpu[k]).abs().max() / g_cpu[k].abs().max())
                        for k in g_cpu)
            print(f"block route {crit} ({mode}), card vs CPU: objective {o_card:.6f} vs "
                  f"{o_cpu:.6f} (|diff| {d_obj:.2e}), gradients max error relative to each "
                  f"tensor's max {worst:.3e}", flush=True)
            if not math.isfinite(d_obj) or d_obj > 1e-3 * max(1.0, abs(o_cpu)):
                fail(f"block route {crit} ({mode}): card and CPU objectives disagree")
            if not math.isfinite(worst) or worst > 1e-2:
                fail(f"block route {crit} ({mode}): card and CPU gradients disagree ({worst})")


def fixed_den_phase(dev, root: str, ce_ckpt: str, se_cfg: str, se_data: str) -> tuple:
    """Phase 10: fixed-denominator sequence training. Returns (K11's row, its
    launches on the block route)."""
    import numpy as np
    import yaml

    from pykaldi2_tpu_torch.bin import compute_priors, train_se
    from pykaldi2_tpu_torch.data import kaldi_io
    from pykaldi2_tpu_torch.ops.fsa import save_fsa
    from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    row, g = blockfb_checks(dev)

    # compute_priors on the phase's alignments
    corpus = write_corpus(os.path.join(root, "fd_corpus"), FD_UTTS, (3.5, 4.0), SENONES, seed=2)
    prior = os.path.join(root, "fd_corpus", "prior.npy")
    if compute_priors.main(["-ali", corpus["label_ark"], "-out", prior,
                            "-num_pdfs", str(SENONES)]) != 0:
        fail("compute_priors.main failed")
    want = priors_from_counts(count_labels(
        (v for _, v in kaldi_io.read_ark(corpus["label_ark"], "ivec")), SENONES))
    got = np.load(prior)
    if got.shape != (SENONES,) or not np.isfinite(got).all() or not np.array_equal(got, want):
        fail(f"compute_priors wrote {got.shape}, not the alignments' log-priors")
    print(f"compute_priors: {SENONES} log-priors from {FD_UTTS} utterances", flush=True)

    # the block route at full width: the 96k-state chain graph, the flagship LSTM
    chain = os.path.join(root, "fd_corpus", "chain_den.npz")
    save_fsa(chain, make_chain_graph())
    data_yaml, cfg_yaml = os.path.join(root, "fd_data.yaml"), os.path.join(root, "fd.yaml")
    with open(data_yaml, "w") as f:
        yaml.safe_dump({**corpus, "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                                     "mel_opts": {"num_bins": BINS}}}}, f)
    with open(cfg_yaml, "w") as f:  # examples/librispeech/se.yaml, one 400-frame bucket of 16
        yaml.safe_dump({
            "model": {"type": "lstm", "hidden_size": H, "num_layers": LAYERS,
                      "output_size": SENONES, "compute_dtype": "bfloat16"},
            "optimizer": {"type": "momentum", "momentum": 0.9, "lr": 1e-5, "grad_clip": 5.0},
            "trainer": {"batch_size": FD_B, "num_epochs": 1, "log_interval": 1, "seed": 777,
                        "acoustic_scale": 0.1, "ce_ratio": 0.1, "drop_frames": True,
                        "bucket_boundaries": [FD_T]}}, f)
    block_launches = 0
    for crit in ("mmi", "smbr"):
        what = f"fixed-den SE, block route, {crit}"
        launches, recs = train_se_fixed_run(dev, what, [
            "-config", cfg_yaml, "-data", data_yaml, "-exp_dir",
            os.path.join(root, f"fd_block_{crit}"), "-criterion", crit, "-den_graph", chain,
            "-prior_path", prior, "-seed_model", ce_ckpt], FD_UTTS // FD_B)
        need_launches(what, launches, positive=("fbank", "lstm_fwd", "lstm_bwd"))
        want_n = expected_block_launches(crit, [int(r["t_len"]) for r in recs], g.num_padded)
        if launches["block_matvec"] != want_n:
            fail(f"{what}: K11 launched {launches['block_matvec']} times, the code derives "
                 f"{want_n}")
        t_sum = sum(int(r["t_len"]) for r in recs)
        print(f"{what}: K11 launched {want_n} times as derived ({want_n // t_sum}T a step)",
              flush=True)
        block_launches += launches["block_matvec"]

    # dense and bigram routes on phase 9's 41-phone 3-state corpus
    mdl = os.path.join(root, "se_corpus", "final.mdl")
    for route, extra, crit in (("dense", ["-generic_den"], "mmi"), ("bigram", [], "mmi"),
                               ("bigram", [], "smbr"), ("bigram", [], "mpfe")):
        what = f"fixed-den SE, {route} route, {crit}"
        launches, _ = train_se_fixed_run(dev, what, [
            "-config", se_cfg, "-data", se_data, "-exp_dir",
            os.path.join(root, f"fd_{route}_{crit}"), "-criterion", crit, "-trans_model", mdl,
            "-seed_model", ce_ckpt, *extra], SE_UTTS // SE_B)
        need_launches(what, launches, positive=("fbank", "lstm_fwd", "lstm_bwd"),
                      zero=("block_matvec",))

    fixed_den_card_vs_cpu(dev)

    # timing: the block route on the chain graph, the dense and bigram routes
    log_prior = np.load(prior)
    for crit in ("mmi", "smbr"):
        fixed_step_timing(dev, f"fixed-den block {crit}", cfg_yaml, data_yaml, g, crit, ce_ckpt,
                          log_prior, None, smi)
    import logging

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.pipeline import build_frontend

    cfg = load_config(se_cfg)
    cfg.data = load_data_config(se_data)
    dataset, _, _ = build_frontend(cfg.data)
    log = logging.getLogger("chip_smoke")
    for route, extra, crits in (("dense", ["-generic_den"], ("mmi",)),
                                ("bigram", [], ("mmi", "smbr", "mpfe"))):
        args = train_se.build_argparser().parse_args(
            ["-exp_dir", root, "-trans_model", mdl, *extra])
        tm, den, p2p = train_se._build_tm_and_den(cfg, args, dataset, log)
        for crit in crits:
            packed = train_se.pack_denominator(args, cfg, log, dataset, tm, den, p2p, crit)
            fixed_step_timing(dev, f"fixed-den {route} {crit}", se_cfg, se_data, packed, crit,
                              ce_ckpt, priors_from_counts(count_labels(
                                  dataset.labels.values(), SENONES)), p2p, smi)
    return row, block_launches


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

    from concurrent.futures import ThreadPoolExecutor

    from pykaldi2_tpu_torch.decode.decoder import build_native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ for the decoder beside the nvcc builds
        native = pool.submit(build_native, True)
        reports = D.build_all(force=True)
        native.result()
    print(f"built {', '.join(reports)} and the native decoder in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    rows = kernel_checks(dev)
    rows.update(mfcc_checks(dev))
    rows.update(lstmp_checks(dev))
    print_rows(rows)
    probe = latfb_probe(dev)
    blstm_grad_check(dev)
    blstm_grad_check(dev, proj=128)
    root = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)  # the trainers resume from checkpoints they find
    exp, cfg_yaml, data_yaml, launches = main_path(dev, root)
    eval_check(dev, exp, cfg_yaml, data_yaml)
    step_timing(dev, cfg_yaml, data_yaml)
    recurrence_sweep(dev)
    proj_launches, _ = blstmp_path(dev, root, data_yaml)
    launches.update({k: proj_launches[k] for k in ("lstm_proj_fwd", "lstm_proj_bwd")})
    launches["mfcc"] = mfcc_path(dev, root, data_yaml, cfg_yaml)["mfcc"]
    se_launches, first, se_cfg, se_data = se_path(dev, root, os.path.join(exp, "model.0.npz"))
    decoded = se_step_checks(dev, first, se_cfg, se_data,
                             os.path.join(root, "se_smbr", "model.0.npz"))
    rows["block_matvec"], launches["block_matvec"] = fixed_den_phase(
        dev, root, os.path.join(exp, "model.0.npz"), se_cfg, se_data)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    # K7-K10: times and bounds at the decoded batch (the main path's shapes),
    # the error the larger of the probe's and the decoded batch's
    for name, r in decoded.items():
        rows[name] = dict(r, max_abs_err=max(r["max_abs_err"], probe[name]["max_abs_err"]))
    launches.update(se_launches)
    for name, n in launches.items():
        rows[name]["launches"] = n
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: rows[name][k] for k in keys} for name in counted()]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
