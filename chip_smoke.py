"""Drive the PyTorch port's main paths on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. build every kernel (csrc/*.cu, one nvcc each, in parallel) for sm_90a,
     and the native lattice decoder (native/latdec.cc, g++) beside them;
  2. hold each kernel against its plain PyTorch version at the flagship
     shapes (B=64 rows of 80-frame chunks, 80 fbank bins, H=1024), with the
     tolerances below, and time kernel, plain version and library call;
     K1 and K4 also on one 1,230-frame utterance (the feature CLIs' launch;
     both shapes timed), on 8 kHz audio without snip edges and on 32 kHz
     audio (a row tile's columns split over two CTAs), each called twice
     and required equal bit for bit;
     K4 for Kaldi's mfcc_hires options and its 13-cepstra default, K5/K6 at
     the BLSTMP shapes (P=512) in both directions, also at H=256, P=128
     (B=70: two launches) and H=P=1024, each K5 and K6 call made twice and
     the two required equal bit for bit; K7-K10 likewise on the
     probe lattice of bench.py:626-647 (B=32, T=448, K=A=256, 8952 pdfs);
     then K7-K10 on a band packed as pack_time_sync packs it (padding arcs
     at slot 0, inactive frames, an active frame of padding only), on bands
     that take no ring (A=250; K=14,520, where K7 still takes one) or read
     arcs past it (A=2,560), and K7 at its cap of 29,048 slots;
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
     profile with K11's share;
 11. data simulation with the recipe's block (examples/librispeech/
     data.yaml:32-50) on phase 3's corpus: (a) host-side,
     ``bin/compute_cmvn_stats.main`` then ``bin/train_ce.main`` on the
     flagship with those stats, K1-K3 launched, the loader's wait per step
     printed beside phase 5's step; (b) ``on_device: true``: the same CE
     run, the sim_rir [64, 8000] and sim_noise shapes, the host's
     ``batch_extras`` time per batch, ``apply_simulation`` on the card
     against the CPU on one batch, phase 5's timing for that step and the
     FFTs' device time in its profile;
 12. ``bin/decode.main -decoder host`` over phase 9's 96 utterances with
     phase 9's SE MMI checkpoint, a free word-loop graph of 200 random words
     (``make_decode_graph``, 2-5 phones each) and random reference
     transcripts, at the CLI's beam 16 and max_active 7000 with
     ``-num_threads``, ``-prior``, ``-dump_ark`` and ``-ref``: K1 and K2
     launched and K3 not, forward ms per batch, host search ms per
     utterance, real-time factor and WER (meaningless with these weights),
     and two utterances' dumped log-likelihoods against the CPU run;
 13. K2 at B=1 (align's launch: H=1024, one 512-frame bucket) against its
     plain version, two calls bit-equal; fault F3's routing: one forward and
     backward of an LSTM at H=1040 and an LSTMP at H=48, P=64 on the card
     against the CPU, with no kernel launched and the slow route's warning
     logged, and H=1024 taking K2/K3; run.sh stage 0, ``bin/align.main
     -trans_model`` with phase 12's checkpoint over phase 9's utterances,
     transcripts of random words of phase 12's lexicon (K1 and K2 launched,
     K3 not; int32 pdf-ids below 123, one per frame; forward and
     ``fsa_viterbi`` ms an utterance by CUDA events; one utterance against
     the same CLI on the CPU); stage 4, order-2 and order-3 ``train_arpa``
     LMs over those transcripts, ``bin/build_graph.main decode -arpa`` and
     ``den -ali`` (sizes, host seconds), and ``bin/decode.main -graph
     hclg.npz`` on 8 utterances; ``bin/lattice_tool.main`` on the word
     lattices of the 2 longest transcripts from that HCLG at the CLI's
     beams, from log-likelihoods peaked on stage 0's alignments (N-best,
     rescoring from the order-3 to the order-2 LM, posterior pruning; host
     ms an utterance) and
     ``bin/compare_posteriors.main`` on phase 12's card and CPU arks;
 14. K12 (the search's frontier) against its plain version bit for bit, frame
     by frame from the start state, on the SE den graph (K 200, K = S), the
     200-word loop (K 2,000), an in-frame eps loop, drawn frames with ties,
     ±0.0 and NEG_INF rows, and a 60,000-state graph whose rows and sort do
     not fit in shared memory; timed beside its bound, the plain version and
     ``torch.topk`` alone; then (a) ``bin/train_ce.main`` with ce.yaml's
     ``type: tdnn`` (5 layers of
     1024, dilations 1,1,3,3,3, kernel 3) and ``type: transformer`` (4
     layers of 1024, 8 heads, ffn 2048) at phase 3's batch and optimizer:
     K1 launched, K2/K3 and K5/K6 not; the card against the CPU on two
     chunks (logits, loss, gradients); phase 5's timing and profile beside
     the flagship's; (b) ``bin/train_se.main -on_the_fly -decoder device``
     under MMI and sMBR at phase 9's settings and max_arcs 800: K1-K3 and
     K7/K8 or K9/K10 launched, the step split (forward, search, compaction,
     train) beside phase 9's host-decoder steps, links dropped; on one batch
     K12 along its search, the captured search against the eager loops on
     the card and (8 rows) on the CPU and K7-K10 on its compacted band
     against their plain versions; (c)
     ``bin/decode.main -decoder device`` over phase 12's 96 utterances,
     checkpoint and word loop at beam 16, max_active 2000, max_arcs 1024,
     lattice beam 8 (K1/K2 launched; wall, real-time factor, search ms a
     batch, links dropped, retries, hypotheses equal to phase 12's), then
     ``-on_device``, and ``-nbest 5`` through the device route on 8
     utterances at max_active 8 (the lattice tools are Python); (d) on one
     batch of (b) and of (c) K12 along the search and the captured search
     against the eager one: ``search.frontier`` B x T a call, times a frame,
     the capture's host time and the device operations a frame of the eager
     search (the graph's nodes);
 15. the data-parallel paths, each in child processes: (a) in a one-rank
     ``nccl`` group from torchrun's environment, ``bin/train_ce.main
     -multihost`` on phase 3's corpus and config (K1-K3 launched in the
     child), whose parameters must equal phase 3's run without a group
     (1e-6 of each leaf's max |p|); (b) two ``gloo`` ranks on this one card
     (nccl refuses two ranks on one device), each a half of phase 3's first
     batch (2 x 32), one momentum step of the flagship from the same
     weights against one process at B=64: rtol 3e-5, atol 3e-6, the ranks
     bit-identical; (c) the same with bf16 gradient sums, against (b) at rtol
     2e-2, atol 2e-3; (d) ``bin/train_se.main -multihost -on_the_fly
     -decoder device -criterion mmi`` at phase 14(b)'s argv in a one-rank
     nccl group, every collective and DDP forward recorded with whether the
     stream was capturing: none inside the search's capture, K7/K8
     launched, the parameters equal to phase 14(b)'s MMI run's; (e) the
     flagship step queued with DDP against the same step without a process
     group (in turns, one process), and the fenced wall of (b)'s step;
 16. the generic per-utterance lattice route (ops/fb_batched.py): phase 9's
     first sMBR batch decoded again by phase 9's decoders into (DenseFsa,
     frames) pairs, packed by ``pack_graph_batch`` and ``pack_time_sync``;
     (a) the buckets and the saved history's bytes against the card's free
     memory; (b) logZ, occupancies and the expected accuracy with its
     gradient (pdf and phone level) against K7-K10 on the same lattices,
     within LAT_TOL, and one frame's scatter passes timed; (c) the generic
     route on the card against the CPU for the two shortest rows; (d)
     ``make_se_lattice_steps``' train_fn on the BatchedGraphs, 3 MMI and 3
     sMBR steps from phase 3's checkpoint: the first step's objective and
     gradients against the same step on the TimeSyncLattice, K1-K3
     launched and K7-K10 not, fenced step, peak memory, busy share and
     device operations a frame.

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
# K1/K4 launch shapes (utterances x frames): the CE batch of 64 80-frame
# chunks, and one mean-length utterance as the feature CLIs launch it
FRONT_SHAPES = ((B, T), (1, int(FRAMES_PER_UTT)))
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
# apply_simulation card vs CPU (phase 11): cuFFT against pocketfft over
# [64, 32768] rows, then the same mixing: within 1e-5 of max|out|
SIM_TOL = 1e-5
# phase 12's free word loop: words of 2-5 phones of the 41-phone model
DECODE_WORDS = 200
# phase 13: utterances aligned on the card, and align's frame bucket for
# phase 9's 4-4.5 s utterances (the reference pads to a power of two >= 128)
ALIGN_UTTS, ALIGN_BUCKET = 96, 512
# the lattice tools' input: log-likelihoods N(0, LAT_SIGMA) plus LAT_PEAK on
# the aligned pdf give word lattices of hundreds of states, thousands of arcs
LAT_SIGMA, LAT_PEAK = 1.0, 2.0
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
# phase 14: ce.yaml's other backbones at the flagship's width, and the device
# search at phase 9's SE settings and phase 12's decode beams
TDNN = {"type": "tdnn", "hidden_size": H, "tdnn_dilations": [1, 1, 3, 3, 3], "tdnn_kernel": 3}
TRANSFORMER = {"type": "transformer", "hidden_size": H, "num_layers": LAYERS, "num_heads": 8,
               "ffn_size": 2048}
DEV_SE = {"beam": 10.0, "lattice_beam": 4.0, "max_active": 200, "max_arcs": 800}
DEV_DECODE = {"beam": 16.0, "max_active": 2000, "max_arcs": 1024, "lattice_beam": 8.0}
# the device route's -nbest run: the word acceptor's epsilon removal is Python
# per state and arc, seconds a lattice on this random-weight model even at a
# frontier of 20 (P6), so that run keeps a frontier of 8
NBEST_ACTIVE = 8
# backbones card vs CPU on the same features. fp32: cuBLAS against the CPU's
# fp32 products, sums in other orders (1e-6 relative). bf16: the same operands
# and fp32 sums, but a sum that lands on the other side of a bf16 rounding
# boundary (ulp 2^-8 of a layer-normed activation) flips that activation for
# the next product, and flips carry on through the layers: on a random
# full-width TDNN the conv outputs drift 4.8e-6, 2.9e-4, 1.6e-3, 3.1e-3,
# 6.5e-3 layer by layer, the logits 8.6e-3 and the gradients 3.3e-2 of their
# norm (Transformer 8.2e-3, 1.9e-2; NVIDIA H100 80GB HBM3, 700.00 W)
BACKBONE_TOL = {"float32": {"logits": 1e-3, "loss": 1e-5, "grad_rel": 1e-3},
                "bfloat16": {"logits": TOL["eval_logits"], "loss": 1e-3, "grad_rel": 8e-2}}
# the captured search against the eager loops: the same fp32 adds and maxes in
# the same order, so equal; bound: 1e-6 of max(1, |x|); the CPU loop runs the
# SE batch's first 8 rows (about a second a row)
SEARCH_TOL, SEARCH_CPU_ROWS = 1e-6, 8
# frames of the eager search whose device operations phase 14(d) counts
OPS_FRAMES = 16
# K12 (phase 14): the frames each comparison walks from the search's start
# state, and the states of the synthetic graph whose rows do not fit in
# shared memory
FRONTIER_FRAMES, FRONTIER_BIG_S = 48, 60000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_name_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


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


def fbank_opts(bins: int = BINS, **frame):
    """Fbank options with dither 0 (and ``frame``'s frame options), by
    default the flagship's 80 bins."""
    from pykaldi2_tpu_torch.config import FbankOpts, FrameOpts, MelOpts

    return FbankOpts(frame_opts=FrameOpts(dither=0.0, **frame), mel_opts=MelOpts(num_bins=bins))


def front_wave(rng, b: int, t: int, fo, dev):
    """[b, S] random fp32 audio on ``dev`` whose snip-edges framing gives t frames."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.data.dataloader import chunk_samples

    return torch.tensor((rng.randn(b, chunk_samples(t, fo)) * 4000).astype(np.float32),
                        device=dev)


# a K1/K4 option set beside the recipe's: 8 kHz audio framed without snip
# edges under the povey window (W=200, K=128), 3 utterances of 123 frames,
# a row count (369) that no tile size divides
FRONT_8K = {"samp_freq": 8000.0, "snip_edges": False, "window_type": "povey"}
# and 32 kHz audio (W=800, K=512: two CTAs split a row tile's columns and
# exchange its spectrum), 2 utterances of 100 frames
FRONT_32K = {"samp_freq": 32000.0}


def raw_wave(dev, seed: int, b: int, s: int):
    """[b, s] random fp32 audio on ``dev``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    return torch.tensor((rng.randn(b, s) * 4000).astype(np.float32), device=dev)


def front_compare(what: str, fn, plain, opts, wave, tol: float) -> float:
    """K1 or K4 (``fn``) against its plain version on one input; a second
    call on the same input must give the same bits (fixed-order sums, no
    atomics). Returns the max abs error."""
    import torch

    got = fn(wave, opts)
    again = fn(wave, opts)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"{what}: two calls on the same input differ")
    return check(what, got, plain(wave, opts), tol)


def front_shapes(what: str, fn, plain, opts, rng, dev, tol: float, time_it: bool = True):
    """K1 or K4 at each of FRONT_SHAPES (the first from ``rng``, the rest
    from a fixed seed): compared, and with ``time_it`` timed beside the
    plain version and the bound, one line a shape with the tile the host
    picked. Returns the CE batch's row fields."""
    import numpy as np

    from pykaldi2_tpu_torch.config import MfccOpts
    from pykaldi2_tpu_torch.frontend import fused as F

    fo, mfcc = opts.frame_opts, isinstance(opts, MfccOpts)
    m, ceps = opts.mel_opts.num_bins, (opts.num_ceps if mfcc else 0)
    w, k = fo.window_size, fo.padded_window_size // 2
    row, extra = {}, np.random.RandomState(7)
    for b, t in FRONT_SHAPES:
        wave = front_wave(rng if not row else extra, b, t, fo, dev)
        label = f"{what} B={b} x {t} frames"
        err = front_compare(label, fn, plain, opts, wave, tol)
        if not time_it:
            row = row or {"max_abs_err": err}
            row["max_abs_err"] = max(row["max_abs_err"], err)
            continue
        # the bound charges the work the function needs: the DFT over the W
        # real samples and K bins, the mel product over each filter's
        # nonzero bins, K4's DCT; the waveform, the tables the kernel reads
        # and the output, each once
        win, cs, melw, band, dct_t, _, _ = F._kernel_tables(opts, dev)
        tables = [x for x in (win, cs, melw, band, dct_t) if x is not None]
        nrows = b * t
        flops = 2 * nrows * w * k * 2 + 2 * nrows * melw.numel() + 2 * nrows * m * ceps
        nbytes = 4 * (wave.numel() + sum(x.numel() for x in tables) + nrows * (ceps or m))
        bms, by = bound_ms(nbytes, [(flops, FP32_FLOPS)])
        # ms as a caller pays it (eager calls, the wrapper's host work
        # included: the feature CLIs launch one utterance at a time), and the
        # device's time alone from a CUDA graph
        ms, device_ms = timed(lambda: fn(wave, opts)), timed_graph(lambda: fn(wave, opts))
        plain_ms = timed(lambda: plain(wave, opts))
        r, cl, cm, rt = F.kernel_tile(nrows, opts, mfcc)
        print(f"kernel {label}: {ms:.4f} ms (CUDA events over 20 calls; device {device_ms:.4f} "
              f"ms from a CUDA graph of 50) | plain {plain_ms:.4f} ms | bound {bms:.4f} ms "
              f"({by}) | tiles of {rt} rows ({r} a thread), {cl} CTA(s) a tile, {cm} tile(s) "
              f"a table stream, {-(-(-(-nrows // rt)) // cm) * cm * cl} CTAs", flush=True)
        if not row:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        row["max_abs_err"] = max(row["max_abs_err"], err)
    return row


def kernel_checks(dev):
    """Phase 2: each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.frontend import fused as F
    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    rng = np.random.RandomState(0)
    rows = {}

    # K1: fused fbank on a batch of 64 raw 80-frame chunks and on one
    # mean-length utterance; then 8 kHz audio without snip edges, and 32 kHz
    row = front_shapes("K1 fbank", F.fused_fbank, F.fused_fbank_plain, fbank_opts(), rng, dev,
                       TOL["fbank"])
    err = max(front_compare("K1 fbank, 8 kHz, no snip edges, 23 bins", F.fused_fbank,
                            F.fused_fbank_plain, fbank_opts(23, **FRONT_8K),
                            raw_wave(dev, 8, 3, 9841), TOL["fbank"]),
              front_compare("K1 fbank, 32 kHz, 80 bins", F.fused_fbank, F.fused_fbank_plain,
                            fbank_opts(**FRONT_32K), raw_wave(dev, 9, 2, 99 * 320 + 800),
                            TOL["fbank"]))
    rows["fbank"] = dict(
        name="fbank", route="cuda", source="pykaldi2_tpu_torch/csrc/fbank.cu",
        replaces="pykaldi2_tpu/frontend/fused.py:38",
        **dict(row, max_abs_err=max(row["max_abs_err"], err)), library_ms=None)

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


def mfcc_opts(spec: dict, **frame):
    """MfccOpts with dither 0 (and ``frame``'s frame options) from one of the
    option sets above."""
    from pykaldi2_tpu_torch.config import FrameOpts, MelOpts, MfccOpts

    spec = dict(spec)
    return MfccOpts(frame_opts=FrameOpts(dither=0.0, **frame),
                    mel_opts=MelOpts(**spec.pop("mel_opts")), **spec)


def mfcc_checks(dev) -> dict:
    """Phase 2, K4: fused MFCC against its plain version for the hires and
    the 13-cepstra-with-energy options at FRONT_SHAPES, the former on
    FRONT_32K's audio and the latter on FRONT_8K's; the row (times, bound)
    is the hires one on the CE batch, the error the largest of all."""
    import numpy as np

    from pykaldi2_tpu_torch.frontend import fused as F

    rng = np.random.RandomState(5)
    row = front_shapes("K4 mfcc hires 40/40", F.fused_mfcc, F.fused_mfcc_plain,
                       mfcc_opts(MFCC_HIRES), rng, dev, TOL["mfcc"])
    err = front_shapes("K4 mfcc 13/23 + energy", F.fused_mfcc, F.fused_mfcc_plain,
                       mfcc_opts(MFCC_DEFAULT), rng, dev, TOL["mfcc"],
                       time_it=False)["max_abs_err"]
    err8 = max(front_compare("K4 mfcc hires, 32 kHz", F.fused_mfcc, F.fused_mfcc_plain,
                             mfcc_opts(MFCC_HIRES, **FRONT_32K),
                             raw_wave(dev, 9, 2, 99 * 320 + 800), TOL["mfcc"]),
               front_compare("K4 mfcc 13/23 + energy, 8 kHz, no snip edges", F.fused_mfcc,
                             F.fused_mfcc_plain, mfcc_opts(MFCC_DEFAULT, **FRONT_8K),
                             raw_wave(dev, 8, 3, 9841), TOL["mfcc"]))
    return {"mfcc": dict(name="mfcc", route="cuda", source="pykaldi2_tpu_torch/csrc/fbank.cu",
                         replaces="pykaldi2_tpu/frontend/fused.py:125",
                         **dict(row, max_abs_err=max(row["max_abs_err"], err, err8)),
                         library_ms=None)}


def lstmp_checks(dev) -> dict:
    """Phase 2, K5/K6: the LSTMP recurrence of one (layer, direction) at
    T=80, B=64, H=1024, P=512, with padded rows, in both directions (the
    reversed one runs time-flipped inputs, as models/lstm.py does), against
    the plain versions; then a B=70 (two launches), H=256, P=128 case and an
    H=P=1024 one. Every call is made twice (``k5_check``, ``k6_check``)."""
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
        errs, (_yp, cp, gp, _hp) = k5_check(f"T={T} B={B} H={H} P={PROJ} {label}", x_in, wh, wp,
                                            m_in)
        fwd_errs += errs
        bwd_errs += k6_check(f"T={T} B={B} H={H} P={PROJ} {label}", dys, gp, cp, m_in, wh, wp)
    # odd shapes: B=70 takes two launches of the 64-row kernel
    xs = torch.tensor((rng.randn(7, 70, 1024) * 0.5).astype(np.float32), device=dev)
    whs = torch.tensor(rng.uniform(-0.1, 0.1, (128, 1024)).astype(np.float32),
                       device=dev).to(torch.bfloat16)
    wps = torch.tensor(rng.uniform(-0.1, 0.1, (256, 128)).astype(np.float32),
                       device=dev).to(torch.bfloat16)
    mk = torch.ones(7, 70, device=dev)
    mk[4:, 0] = 0.0
    _errs, want = k5_check("T=7 B=70 H=256 P=128", xs, whs, wps, mk)
    ds = torch.tensor(rng.randn(7, 70, 128).astype(np.float32), device=dev)
    k6_check("T=7 B=70 H=256 P=128 forward", ds, want[2], want[1], mk, whs, wps)
    # the reversed direction runs on the states of a time-flipped forward
    rev = L.lstm_proj_fwd_plain(xs.flip(0).contiguous(), whs, wps, mk.flip(0).contiguous())
    k6_check("T=7 B=70 H=256 P=128 reversed", ds.flip(0).contiguous(), rev[2], rev[1],
             mk.flip(0).contiguous(), whs, wps)
    # H = P = 1024: the largest shared-memory layouts K5 and K6 take
    t_big = min(24, T)
    wh_big = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (H, 4 * H)).astype(np.float32),
                          device=dev).to(torch.bfloat16)
    wp_big = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (H, H)).astype(np.float32),
                          device=dev).to(torch.bfloat16)
    d_big = torch.tensor((rng.randn(t_big, B, H) * 0.1).astype(np.float32), device=dev)
    for label, flip in (("forward", False), ("reversed", True)):
        f = (lambda a: a.flip(0).contiguous()) if flip else (lambda a: a.contiguous())
        m_big = f(mask[:t_big])
        _errs, (_y, c_big, g_big, _h) = k5_check(f"T={t_big} B={B} H={H} P={H} {label}",
                                                 f(xp[:t_big]), wh_big, wp_big, m_big)
        k6_check(f"T={t_big} B={B} H={H} P={H} {label}", f(d_big), g_big, c_big, m_big, wh_big,
                 wp_big)
    for h, p in ((H, PROJ), (256, 128), (H, H)):
        print(f"K5 and K6 at H={h} P={p}: {h // 16} CTAs in clusters of "
              f"{L.lstmp_fwd_cluster(h, p, dev)} and {L.lstmp_bwd_cluster(h, p, dev)}",
              flush=True)

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
    k5, k6 = rows["lstm_proj_fwd"], rows["lstm_proj_bwd"]
    print(f"K5 at T={T} B={B} H={H} P={PROJ}: {k5['ms']:.4f} ms a call, "
          f"{1e3 * k5['ms'] / T:.2f} us a step; cuDNN LSTMP forward {lib_fwd:.4f} ms, "
          f"{1e3 * lib_fwd / T:.2f} us a step", flush=True)
    print(f"K6 at T={T} B={B} H={H} P={PROJ}: {k6['ms']:.4f} ms a call, "
          f"{1e3 * k6['ms'] / T:.2f} us a step; cuDNN LSTMP backward-data {lib_bwd:.4f} ms, "
          f"{1e3 * lib_bwd / T:.2f} us a step", flush=True)
    return rows


def k5_check(what: str, xp, wh, wp, mask) -> tuple:
    """K5 called twice on the same inputs (the two results must be equal bit
    for bit: the cluster sums run in a fixed order, with no atomics), then
    held against its plain version; returns (the ys and cs errors, the plain
    outputs)."""
    import torch

    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    got = L.lstm_proj_fwd(xp, wh, wp, mask)
    again = L.lstm_proj_fwd(xp, wh, wp, mask)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        fail(f"K5 at {what}: two calls on the same inputs differ")
    want = L.lstm_proj_fwd_plain(xp, wh, wp, mask)
    errs = [check(f"K5 lstmp_fwd ys at {what}", got[0], want[0], TOL["lstmp_fwd"]),
            check(f"K5 lstmp_fwd cs at {what}", got[1], want[1], TOL["lstmp_fwd"])]
    check(f"K5 lstmp_fwd gates (bf16) at {what}", got[2], want[2], TOL["lstmp_fwd_bf16"])
    check(f"K5 lstmp_fwd hfull (bf16) at {what}", got[3], want[3], TOL["lstmp_fwd_bf16"])
    return errs, want


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


def lat_logz(alphas, norms, final):
    """log Z [B] from a forward's alphas [T,B,K] and norms [T,B]."""
    import torch

    from pykaldi2_tpu_torch.ops.fb import NEG_INF

    return torch.logsumexp(torch.clamp(alphas[-1] + final, min=NEG_INF), 1) + norms[-1]


def latfb_bwd_args(band, active, arc_acc, lat, fwd, sfwd) -> tuple:
    """K8's and K10's arguments, as the trainers build them, from the plain
    forwards' outputs: fwd = K7's (alphas, norms), sfwd = K9's (alphas,
    aaccs, norms)."""
    import torch

    from pykaldi2_tpu_torch.ops import fb_lattice as FL
    from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC
    from pykaldi2_tpu_torch.ops.fb import NEG_INF

    (wa, wn), (sa, sc, sn) = fwd, sfwd
    b, k = lat.final.shape
    alpha0 = KC.initial_alpha(b, k, wa)
    args8 = (*band, active, FL._prev(wa, alpha0), FL._prev(wn, wn.new_zeros(b))[:, :, None],
             lat.final, lat_logz(wa, wn, lat.final)[:, None].contiguous())
    f = torch.sum(torch.softmax(torch.clamp(sa[-1] + lat.final, min=NEG_INF), 1) * sc[-1], 1)
    args10 = (*band, active, arc_acc, FL._prev(sa, alpha0), FL._prev(sc, torch.zeros_like(sc[0])),
              FL._prev(sn, sn.new_zeros(b))[:, :, None], lat.final,
              lat_logz(sa, sn, lat.final)[:, None].contiguous(), f[:, None].contiguous())
    return args8, args10


def latfb_bwd_checks(label: str, calls: dict, f) -> dict:
    """K8 and K10 against their plain versions: ``calls`` maps each row name
    to (kernel, plain) thunks, ``f`` is K10's [B,1] expected accuracy.
    Returns {name: max_abs_err}."""
    import torch

    errs = {}
    for name, what in (("latfb_occupancies_bwd", "K8 {} gamma"),
                       ("latfb_smbr_bwd", "K10 {} contrib")):
        kernel, plain = calls[name]
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        atol = LAT_TOL["abs"]
        if name == "latfb_smbr_bwd":  # c and f are frame counts: f's ulps scale the error
            atol = atol * torch.clamp(f.abs(), min=1.0)[None]
        errs[name] = close(what.format(label), got, want, atol, LAT_TOL["rel"])
    return errs


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
    rings = {"K7": KC.logz_fwd_ring(a, k), "K8": KC.bwd_ring(a, k, False),
             "K9": KC.smbr_fwd_ring(a, k), "K10": KC.bwd_ring(a, k, True)}
    print(f"latfb {label}: B={b} T={t} K={k} A={a}, {live:.1%} of the band is live arcs in "
          f"active frames; rings: " + ", ".join(f"{kno} {s} stages of {c} arcs"
                                                for kno, (s, c) in rings.items()), flush=True)
    for kno in ("K7", "K8", "K9", "K10"):  # a training band takes the ring
        if rings[kno][0] < 2:
            fail(f"{kno} {label}: no ring at K={k}, A={a}")

    def run(kernel, plain):
        got = kernel()
        torch.cuda.synchronize()
        return got, plain()

    calls, errs = {}, {}
    calls["latfb_logz_fwd"] = (lambda: KC.logz_fwd(*band, active, k),
                               lambda: KC.logz_fwd_plain(*band, active, k))
    errs["latfb_logz_fwd"], (wa, wn) = logz_fwd_compare(f"K7 {label}", band, active, lat)

    calls["latfb_smbr_fwd"] = (lambda: KC.smbr_fwd(*band, active, arc_acc, k),
                               lambda: KC.smbr_fwd_plain(*band, active, arc_acc, k))
    (gs, gc, gm), sfwd = run(*calls["latfb_smbr_fwd"])
    errs["latfb_smbr_fwd"] = max(
        close_log(f"K9 {label} alphas", gs, sfwd[0]),
        close(f"K9 {label} aaccs", gc, sfwd[1], LAT_TOL["abs"], LAT_TOL["rel"]),
        close(f"K9 {label} norms", gm, sfwd[2], LAT_TOL["log"], LAT_TOL["log"]))

    args8, args10 = latfb_bwd_args(band, active, arc_acc, lat, (wa, wn), sfwd)
    calls["latfb_occupancies_bwd"] = (lambda: KC.occupancies_bwd(*args8),
                                      lambda: KC.occupancies_bwd_plain(*args8))
    calls["latfb_smbr_bwd"] = (lambda: KC.smbr_contribs_bwd(*args10),
                               lambda: KC.smbr_contribs_bwd_plain(*args10))
    errs.update(latfb_bwd_checks(label, calls, args10[-1]))
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


def latfb_padded(dev) -> dict:
    """Phase 2, K7-K10 on ``padded_lattice``: padding arcs at slot 0,
    inactive frames and an active frame of padding only, the paths K7-K10
    skip around; then K7-K10 with no ring, reading the band from global
    memory: a band of 250 arcs a frame (not a multiple of 4, so no bulk
    copies) and one of K=14,520 slots (no room for two stages), whose
    sources at each frame are the slots the frame before reached; a band
    of 2,560 arcs a frame (the padded band's arcs five times over), whose
    arcs past the ring's 2,048 are read from global memory; and K7 alone at
    its cap of 29,048 slots (4 frames, no ring). K8 and
    K10 take the A=250 band's first 160 frames (its utterances ending 288
    frames earlier): over all 448 frames its log Z reaches -360, and there
    fp32 cannot resolve gamma to LAT_TOL (the plain version is 2.3x LAT_TOL
    from its fp64 evaluation; PERF.md §6). Returns {name: max_abs_err}."""
    import torch

    from pykaldi2_tpu_torch.ops import fb_lattice as FL
    from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC

    obs, lat, nf, ref = padded_lattice(dev)
    errs = latfb_compare(dev, "packed padding", obs, lat, nf, ref)
    cut = FL.TimeSyncLattice(*(x[:, :, :250].contiguous() for x in lat[:4]), lat.final)
    t, b, k, a = 8, 2, 14520, 64
    wide = chained_lattice(dev, t, b, k, a, obs.shape[2], seed=5)
    dup = FL.TimeSyncLattice(*(x[:b, :16].repeat(1, 1, 5) for x in lat[:4]), lat.final[:b])
    # the kernels that take a ring on each band: K7, with two [K] buffers,
    # still has room for one at K=14,520
    for label, o, lt, n, rf, ringed, bwd_frames in (
            ("A=250", obs, cut, nf, ref, (), 160),
            ("K=14520", obs[:b, :t], wide, nf[:b].clamp(max=t), ref[:b, :t], ("K7",), t),
            ("A=2560", obs[:b, :16], dup, torch.tensor([16, 12], dtype=torch.int32, device=dev),
             ref[:b, :16], ("K7", "K8", "K9", "K10"), 16)):
        band = FL._band(o, lt)
        active = FL._active_ts(o.shape[1], n)
        arc_acc = FL._arc_acc_ts(lt, rf, "pdf", None, None)
        kk, aa = lt.num_slots, lt.src.shape[2]
        rings = {"K7": KC.logz_fwd_ring(aa, kk), "K8": KC.bwd_ring(aa, kk, False),
                 "K9": KC.smbr_fwd_ring(aa, kk), "K10": KC.bwd_ring(aa, kk, True)}
        for kno, (stages, chunk) in rings.items():
            if (stages >= 2) != (kno in ringed):
                fail(f"{kno} {label}: {stages} stages of {chunk} arcs, expected "
                     f"{'a ring' if kno in ringed else 'none'}")
        k7_label = f"K7 {label} ({'ring' if 'K7' in ringed else 'no ring'})"
        label = f"{label} ({'ring' if 'K9' in ringed else 'no ring'})"
        errs["latfb_logz_fwd"] = max(errs["latfb_logz_fwd"],
                                     logz_fwd_compare(k7_label, band, active, lt)[0])
        got = KC.smbr_fwd(*band, active, arc_acc, kk)
        torch.cuda.synchronize()
        sfwd = KC.smbr_fwd_plain(*band, active, arc_acc, kk)
        what = f"K9 {label}"
        errs["latfb_smbr_fwd"] = max(
            errs["latfb_smbr_fwd"], close_log(f"{what} alphas", got[0], sfwd[0]),
            close(f"{what} aaccs", got[1], sfwd[1], LAT_TOL["abs"], LAT_TOL["rel"]),
            close(f"{what} norms", got[2], sfwd[2], LAT_TOL["log"], LAT_TOL["log"]))
        if bwd_frames < o.shape[1]:  # the band's first frames, its utterances ending earlier
            n = n - (o.shape[1] - bwd_frames)
            o, rf = o[:, :bwd_frames], rf[:, :bwd_frames]
            lt = FL.TimeSyncLattice(*(x[:, :bwd_frames].contiguous() for x in lt[:4]), lt.final)
            band = FL._band(o, lt)
            active = FL._active_ts(bwd_frames, n)
            arc_acc = FL._arc_acc_ts(lt, rf, "pdf", None, None)
            sfwd = KC.smbr_fwd_plain(*band, active, arc_acc, kk)
            label = f"{label}, {bwd_frames} frames"
        args8, args10 = latfb_bwd_args(band, active, arc_acc, lt,
                                       KC.logz_fwd_plain(*band, active, kk), sfwd)
        calls = {"latfb_occupancies_bwd": (lambda: KC.occupancies_bwd(*args8),
                                           lambda: KC.occupancies_bwd_plain(*args8)),
                 "latfb_smbr_bwd": (lambda: KC.smbr_contribs_bwd(*args10),
                                    lambda: KC.smbr_contribs_bwd_plain(*args10))}
        for name, err in latfb_bwd_checks(label, calls, args10[-1]).items():
            errs[name] = max(errs[name], err)
    # K7 at its own slot cap (two [K] buffers fill the CTA's shared memory;
    # no ring), a few frames whose sources chain from the frame before
    kmax = KC.max_slots(2)
    top = chained_lattice(dev, t=4, b=2, k=kmax, a=64, pdfs=obs.shape[2], seed=6)
    if KC.logz_fwd_ring(64, kmax) != (0, 0):
        fail(f"K7 at K={kmax}: a ring was taken where two [K] buffers fill shared memory")
    band = FL._band(obs[:2, :4], top)
    errs["latfb_logz_fwd"] = max(errs["latfb_logz_fwd"], logz_fwd_compare(
        f"K7 K={kmax} (no ring)", band, FL._active_ts(4, nf[:2].clamp(max=4)), top)[0])
    return errs


def chained_lattice(dev, t: int, b: int, k: int, a: int, pdfs: int, seed: int):
    """A random band of K slots whose sources at each frame are slots the
    frame before reached (so few slots die), frame 0 leaving slot 0, and a
    final weight of 0 on the last frame's destinations."""
    import torch

    from pykaldi2_tpu_torch.ops import fb_lattice as FL
    from pykaldi2_tpu_torch.ops.fb import NEG_INF

    gen = torch.Generator(device=dev).manual_seed(seed)
    lat = FL.TimeSyncLattice(
        src=torch.randint(0, k, (b, t, a), generator=gen, device=dev, dtype=torch.int32),
        dst=torch.randint(0, k, (b, t, a), generator=gen, device=dev, dtype=torch.int32),
        pdf=torch.randint(0, pdfs, (b, t, a), generator=gen, device=dev, dtype=torch.int32),
        weight=torch.randn(b, t, a, generator=gen, device=dev),
        final=torch.full((b, k), NEG_INF, device=dev))
    lat.src[:, 0] = 0
    for f in range(1, t):
        lat.src[:, f] = lat.dst[:, f - 1, torch.randperm(a, generator=gen, device=dev)]
    lat.final.scatter_(1, lat.dst[:, -1].long(), 0.0)
    return lat


def logz_fwd_compare(what: str, band, active, lat) -> tuple:
    """K7 against its plain version on one band: alphas, norms and log Z.
    Returns (max abs error, the plain version's (alphas, norms))."""
    import torch

    from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC

    k = lat.num_slots
    got = KC.logz_fwd(*band, active, k)
    torch.cuda.synchronize()
    want = KC.logz_fwd_plain(*band, active, k)
    return max(close_log(f"{what} alphas", got[0], want[0]),
               close(f"{what} norms", got[1], want[1], LAT_TOL["log"], LAT_TOL["log"]),
               close(f"{what} logZ", lat_logz(*got, lat.final), lat_logz(*want, lat.final),
                     LAT_TOL["log"], LAT_TOL["log"])), want


def padded_lattice(dev, seed: int = 1):
    """A banded lattice batch shaped as phase 9's decoded one and packed as
    ``pack_time_sync`` packs it: B=SE_B utterances of 398-448 frames in
    T=SE_T, K=256 slots and A=512 arcs a frame, 300-512 live arcs in an
    active frame (~74% of the band live, as the decoded batch), padding arcs
    at src = dst = 0 with weight NEG_INF, frames past an utterance's end all
    padding; utterance 0 also has an active frame whose arcs are all padding
    (frame 5), where every arc adds exp(0) = 1 to slot 0. Returns (obs
    [B,T,123], TimeSyncLattice, num_frames [B], reference pdfs [B,T]) on
    ``dev``."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.ops.fb import NEG_INF
    from pykaldi2_tpu_torch.ops.fb_lattice import TimeSyncLattice

    b, t, k, a, pdfs = SE_B, SE_T, 256, 512, 3 * SE_PHONES
    rng = np.random.RandomState(seed)
    nf = rng.randint(t * 8 // 9, t + 1, b).astype(np.int32)
    src = np.zeros((b, t, a), np.int32)
    dst = np.zeros((b, t, a), np.int32)
    w = np.full((b, t, a), NEG_INF, np.float32)
    slots = rng.randint(100, k + 1, (b, t + 1))
    slots[:, 0] = 1
    for i in range(b):
        for f in range(nf[i]):
            n = rng.randint(300, a + 1)
            src[i, f, :n] = rng.randint(0, slots[i, f], n)
            dst[i, f, :n] = rng.randint(0, slots[i, f + 1], n)
            w[i, f, :n] = -np.abs(rng.randn(n)) * 2.0
    src[0, 5], dst[0, 5], w[0, 5] = 0, 0, NEG_INF
    final = np.full((b, k), NEG_INF, np.float32)
    for i in range(b):
        final[i, : slots[i, nf[i]]] = 0.0
    pdf = rng.randint(0, pdfs, (b, t, a)).astype(np.int32)
    obs = (0.1 * rng.randn(b, t, pdfs)).astype(np.float32)
    ref = rng.randint(0, pdfs, (b, t))
    lat = TimeSyncLattice(*(torch.from_numpy(x).to(dev) for x in (src, dst, pdf, w, final)))
    return (torch.from_numpy(obs).to(dev), lat, torch.from_numpy(nf).to(dev),
            torch.from_numpy(ref).to(dev))


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
    """Every kernel wrapper by its row name, K1-K12; each counts its launches."""
    from pykaldi2_tpu_torch.decode.frontier import frontier
    from pykaldi2_tpu_torch.frontend.fused import fused_fbank, fused_mfcc
    from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC
    from pykaldi2_tpu_torch.ops import lstm_cuda as L
    from pykaldi2_tpu_torch.ops.fb_block_cuda import block_matvec

    return {"fbank": fused_fbank, "lstm_fwd": L.lstm_fwd, "lstm_bwd": L.lstm_bwd,
            "mfcc": fused_mfcc, "lstm_proj_fwd": L.lstm_proj_fwd,
            "lstm_proj_bwd": L.lstm_proj_bwd, "latfb_logz_fwd": KC.logz_fwd,
            "latfb_occupancies_bwd": KC.occupancies_bwd, "latfb_smbr_fwd": KC.smbr_fwd,
            "latfb_smbr_bwd": KC.smbr_contribs_bwd, "block_matvec": block_matvec,
            "search_frontier": frontier}


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


def step_timing(dev, cfg_yaml: str, data_yaml: str, what: str = "train step",
                share_of: str = None) -> dict:
    """Phase 5: fenced train-step time on one fixed batch (with the loaders'
    extras, such as the on-device simulation's RIR and noise rows), then a
    short profile."""
    import torch

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import make_ce_train_step
    from pykaldi2_tpu_torch.utils import make_optimizer

    cfg = load_config(cfg_yaml)
    cfg.data = load_data_config(data_yaml)
    dataset, feat_fn, extras_fn = build_frontend(cfg.data)
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model, generator=torch.Generator().manual_seed(0)).to(dev)
    step = make_ce_train_step(model, feat_fn, make_optimizer(cfg.optimizer, model.parameters()))
    batch_np = next(iter(ChunkDataloader(dataset, B, T, shuffle=False, extras_fn=extras_fn)))
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
    lat, enq = [], []           # latency: each step fenced on its own
    for _ in range(100):
        t1 = time.perf_counter()
        step(batch, gen)
        enq.append((time.perf_counter() - t1) * 1e3)  # host time until step() returns
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    lat.sort()
    enq.sort()
    out = {"step_ms": dt * 1e3, "frames_per_sec": B * T / dt,
           "utt_per_sec": B * T / dt / FRAMES_PER_UTT,
           "fenced_step_ms_p50": lat[49], "fenced_step_ms_p90": lat[89],
           "enqueue_ms_p50": enq[49],
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
    print(f"{what}: {out['step_ms']:.3f} ms mean over {n} queued steps | "
          f"{out['frames_per_sec']:.0f} frames/s | {out['utt_per_sec']:.2f} utt/s "
          f"(frames/s / {FRAMES_PER_UTT:g}) | fenced step p50 {lat[49]:.3f} ms, p90 "
          f"{lat[89]:.3f} ms, host enqueue p50 {enq[49]:.3f} ms (100 steps) | peak "
          f"{out['peak_mem_gib']:.2f} GiB", flush=True)

    out["device_busy_share"], out["device_ops_per_step"] = profile_steps(
        lambda: step(batch, gen), 3, f"{what} profile", share_of=share_of)
    return out


def profile_steps(fn, n: int, what: str, top: int = 15, share_of: str = None) -> tuple:
    """Profile n calls of fn; print the device busy share, the device
    operations (kernels and copies) a call and the top kernels by device time
    per call (and, with ``share_of``, the share of device time of the kernels
    whose name holds it); returns (busy share, device operations a call)."""
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
    ops = sum(e.count for e in evs) / n
    print(f"{what}, {n} steps: device busy {busy_us / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms "
          f"wall ({100 * busy_us / wall_us:.1f}%), {ops:.0f} device operations a step; top "
          f"kernels by device time:", flush=True)
    for e in sorted(evs, key=lambda e: -_self_device_us(e))[:top]:
        print(f"  {_self_device_us(e) / (n * 1e3):9.3f} ms/step  x{e.count // n:<5d} "
              f"{e.key[:90]}", flush=True)
    if share_of:
        mine = sum(_self_device_us(e) for e in evs if share_of in e.key.lower())
        print(f"{what}: {share_of} {mine / (n * 1e3):.3f} ms/step, {100 * mine / busy_us:.1f}% "
              f"of device time", flush=True)
    return busy_us / wall_us, ops


def _self_device_us(event) -> float:
    """Self device time of a profiler row (named self_cuda_time_total before
    torch 2.4)."""
    v = getattr(event, "self_device_time_total", None)
    return float(event.self_cuda_time_total if v is None else v)


def se_path(dev, root: str, ce_ckpt: str):
    """Phase 9: ``bin/train_se.main -on_the_fly -decoder host`` at full width,
    3 steps under MMI and 3 under sMBR. Returns ({banded kernel: launches in
    the run that drives it}, {criterion: the run's first decoded batch as
    (TimeSyncLattice, obs, num_frames), "decoders": the MMI run's host
    decoders}, se.yaml, data.yaml)."""
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
        first.setdefault("decoders", decoders)
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


def se_reference(dev, shape):
    """Random reference pdfs [B, T] below the SE model's 123 for the lattice
    accuracy checks (phases 9 and 16)."""
    import torch

    return torch.randint(0, SE_PHONES * 3, tuple(shape), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))


def se_first_batch(dev, cfg_yaml: str, data_yaml: str, nf_np):
    """Phase 9's first SE batch on the card, as its runs' loader gives it:
    (config, feature pipeline, batch, log prior); fails unless its lengths
    are ``nf_np``, those of the batch whose lattices were captured."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
    from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts
    from pykaldi2_tpu_torch.pipeline import build_frontend

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
    return cfg, feat_fn, batch, log_prior


def se_step_checks(dev, first: dict, cfg_yaml: str, data_yaml: str, ckpt: str) -> dict:
    """Phase 9, after the runs: K7-K10 against their plain versions on the
    sMBR run's first decoded batch (the main path's shapes, timed), then one
    SE train step per criterion on that batch and lattice, fenced and
    profiled. Returns the kernel rows."""
    import torch

    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.trainer import make_se_lattice_steps
    from pykaldi2_tpu_torch.utils import load_checkpoint, make_optimizer

    lat, obs_np, nf_np = first["smbr"]
    lat = lat.to(dev)
    nf = torch.from_numpy(nf_np).to(dev)
    ref = se_reference(dev, obs_np.shape[:2])
    rows = {}
    latfb_compare(dev, "decoded", torch.from_numpy(obs_np).to(dev), lat, nf, ref, rows)

    cfg, feat_fn, batch, log_prior = se_first_batch(dev, cfg_yaml, data_yaml, nf_np)
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

    smi = card_name_and_limit()
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


def timed_prefetch(module, waits: list):
    """Wrap ``module.device_prefetch`` so each batch's wait on the loader is
    appended to ``waits`` (s); returns the original to put back."""
    real = module.device_prefetch

    def wrapper(*a, **kw):
        it = real(*a, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            waits.append(time.perf_counter() - t0)
            yield batch

    module.device_prefetch = wrapper
    return real


def sim_data_yaml(root: str, data_yaml: str, name: str, on_device: bool, stats: str) -> str:
    """Phase 3's corpus with the recipe's simulation block verbatim
    (examples/librispeech/data.yaml:32-50) and its CMVN settings."""
    import yaml

    with open(data_yaml) as f:
        d = yaml.safe_load(f)
    with open(os.path.join(HERE, "examples", "librispeech", "data.yaml")) as f:
        recipe = yaml.safe_load(f)
    d["simulation"] = dict(recipe["simulation"], on_device=on_device)
    if stats:
        d["feat"]["cmvn"] = dict(recipe["feat"]["cmvn"], stats_path=stats)
    path = os.path.join(root, name)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def sim_ce_run(dev, what: str, cfg_yaml: str, data_yaml: str, exp: str, base_ms: float):
    """train_ce under simulation with the loader's wait per batch recorded;
    K1-K3 must launch."""
    from pykaldi2_tpu_torch.bin import train_ce

    waits = []
    real = timed_prefetch(train_ce, waits)
    t0 = time.perf_counter()
    try:
        launches, steps = train_ce_run(dev, what, cfg_yaml, data_yaml, exp)
    finally:
        train_ce.device_prefetch = real
    wall = time.perf_counter() - t0
    need_launches(what, launches, positive=("fbank", "lstm_fwd", "lstm_bwd"))
    rest = waits[1:] or waits
    print(f"{what}: {steps} steps in {wall:.2f} s; loader wait {1e3 * waits[0]:.1f} ms before "
          f"the first batch, then {1e3 * sum(rest) / len(rest):.1f} ms a step (max "
          f"{1e3 * max(rest):.1f}) against a {base_ms:.2f} ms queued train step (phase 5)",
          flush=True)
    return launches


def simulation_phase(dev, root: str, cfg_yaml: str, data_yaml: str, base: dict) -> None:
    """Phase 11: the recipe's simulation block on the flagship CE path, on
    the host (a) and on the device (b)."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.bin import compute_cmvn_stats
    from pykaldi2_tpu_torch.config import load_data_config
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.simulation.device import apply_simulation, draw_simulation

    t_phase = time.perf_counter()
    host_yaml = sim_data_yaml(root, data_yaml, "sim_host_stats.yaml", False, None)
    stats = os.path.join(root, "cmvn_sim.stats")
    zero_counts()
    t0 = time.perf_counter()
    if compute_cmvn_stats.main(["-data", host_yaml, "-output", stats], device=str(dev)) != 0:
        fail("compute_cmvn_stats.main failed under host simulation")
    got = read_counts()
    need_launches("compute_cmvn_stats path (host simulation)", got, positive=("fbank",))
    print(f"compute_cmvn_stats (host simulation): {time.perf_counter() - t0:.2f} s, "
          f"{got['fbank']} K1 launches", flush=True)
    host_yaml = sim_data_yaml(root, data_yaml, "sim_host.yaml", False, stats)
    sim_ce_run(dev, "CE + host simulation", cfg_yaml, host_yaml,
               os.path.join(root, "exp_sim_host"), base["step_ms"])

    dev_yaml = sim_data_yaml(root, data_yaml, "sim_device.yaml", True, stats)
    sim_ce_run(dev, "CE + on-device simulation", cfg_yaml, dev_yaml,
               os.path.join(root, "exp_sim_device"), base["step_ms"])
    dcfg = load_data_config(dev_yaml)
    dataset, _feat_fn, extras_fn = build_frontend(dcfg)
    batch = next(iter(ChunkDataloader(dataset, B, T, shuffle=False, extras_fn=extras_fn)))
    s = batch["wave"].shape[1]
    if batch["sim_rir"].shape != (B, 8000) or batch["sim_noise"].shape != (B, s):
        fail(f"sim_rir {batch['sim_rir'].shape} / sim_noise {batch['sim_noise'].shape}, "
             f"expected ({B}, 8000) / ({B}, {s})")
    uids = [f"utt{i:04d}" for i in range(B)]
    extras_fn(uids, s)
    t0 = time.perf_counter()
    for _ in range(3):
        extras_fn(uids, s)
    extras_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"on-device simulation: sim_rir {batch['sim_rir'].shape}, sim_noise "
          f"{batch['sim_noise'].shape}; host batch_extras {extras_ms:.1f} ms a batch of {B}",
          flush=True)
    # apply_simulation on the card against the CPU, the same draws and tensors
    draws = draw_simulation(torch.Generator().manual_seed(0), B, dcfg.simulation)
    shift = dcfg.feat.fbank.frame_opts.window_shift
    sm = torch.repeat_interleave(torch.from_numpy(batch["mask"]).float(), shift, dim=-1)
    sm = torch.nn.functional.pad(sm, (0, max(s - sm.shape[-1], 0)))[:, :s]
    args = [torch.from_numpy(batch[k]) for k in ("wave", "sim_rir", "sim_noise")]
    want = apply_simulation(*args, *draws, sm)
    got = apply_simulation(*[a.to(dev) for a in args], *[d.to(dev) for d in draws], sm.to(dev))
    scale = float(want.abs().max())
    check(f"apply_simulation [{B}, {s}] card vs CPU (max|out| {scale:.0f})", got.cpu(), want,
          SIM_TOL * scale)
    sim = step_timing(dev, cfg_yaml, dev_yaml, "CE + on-device simulation step", share_of="fft")
    print(f"on-device simulation adds {sim['step_ms'] - base['step_ms']:.3f} ms to the queued "
          f"step ({base['step_ms']:.3f} -> {sim['step_ms']:.3f}) and "
          f"{sim['fenced_step_ms_p50'] - base['fenced_step_ms_p50']:.3f} ms to the fenced p50; "
          f"host enqueue p50 {base['enqueue_ms_p50']:.3f} -> {sim['enqueue_ms_p50']:.3f} ms, "
          f"device operations a step {base['device_ops_per_step']:.0f} -> "
          f"{sim['device_ops_per_step']:.0f}", flush=True)
    print(f"phase 11 (simulation): {time.perf_counter() - t_phase:.1f} s", flush=True)


def decode_phase(dev, root: str, se_cfg: str, se_data: str, ckpt: str) -> dict:
    """Phase 12: ``bin/decode.main -decoder host`` over phase 9's corpus with
    phase 9's SE MMI checkpoint and a free word-loop graph at the CLI's beams;
    then the forward's split, one lattice's size at those beams, and the
    lattice flags on 8 utterances (``decode_lattice_run``). Returns what
    phase 13 reuses: the lexicon (dict and file), the word table, the prior
    and two utterances' log-likelihood arks, the card's and
    the CPU's."""
    import numpy as np
    import torch
    import yaml

    from pykaldi2_tpu_torch.bin import decode
    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data import kaldi_io
    from pykaldi2_tpu_torch.data.dataset import SpeechDataset
    from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder
    from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel, make_decode_graph
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts
    from pykaldi2_tpu_torch.pipeline import FeaturePipeline
    from pykaldi2_tpu_torch.utils import load_checkpoint

    t_phase = time.perf_counter()
    rng = np.random.RandomState(12)
    tm = TransitionModel(HmmTopology.three_state(range(1, SE_PHONES + 1)))
    lexicon = {f"w{i:03d}": [[int(p) for p in rng.randint(1, SE_PHONES + 1, rng.randint(2, 6))]]
               for i in range(DECODE_WORDS)}
    word_ids = {w: i + 1 for i, w in enumerate(lexicon)}
    lex_path = os.path.join(root, "lexicon.txt")
    with open(lex_path, "w") as f:
        f.writelines(f"{w} {' '.join(map(str, prons[0]))}\n" for w, prons in lexicon.items())
    t0 = time.perf_counter()
    g = make_decode_graph(tm, lexicon, word_ids)
    graph, words = os.path.join(root, "decode_graph.fst.txt"), os.path.join(root, "words.txt")
    g.write_text(graph)
    with open(words, "w") as f:
        f.write("<eps> 0\n" + "".join(f"{w} {i}\n" for w, i in word_ids.items()))
    print(f"decode graph: {DECODE_WORDS} words of 2-5 phones, {g.num_states} states, "
          f"{g.num_arcs} arcs, built in {time.perf_counter() - t0:.2f} s", flush=True)
    with open(se_data) as f:
        corpus = yaml.safe_load(f)
    ref = os.path.join(root, "decode_ref.txt")
    with open(ref, "w") as f:
        for uid, _ in kaldi_io.read_scp(corpus["wav_scp"]):
            f.write(uid + " " + " ".join(rng.choice(list(word_ids), rng.randint(5, 13))) + "\n")
    cfg = load_config(se_cfg)
    cfg.data = load_data_config(se_data)
    dataset = SpeechDataset.from_config(cfg.data)
    prior = os.path.join(root, "decode_prior.npy")
    np.save(prior, priors_from_counts(count_labels(dataset.labels.values(), SENONES)))
    threads = min(os.cpu_count() or 1, 16)
    dump = os.path.join(root, "decode_post.ark")
    argv = ["-config", se_cfg, "-data", se_data, "-model", ckpt, "-graph", graph,
            "-words", words, "-ref", ref, "-prior", prior, "-num_threads", str(threads),
            "-dump_ark", dump, "-hyp_out", os.path.join(root, "decode.hyp")]

    fwd_ms, utt_ms = [], []
    make_forward, search = decode.make_forward, LatticeDecoder.decode

    def timed_forward(*a, **kw):
        fn = make_forward(*a, **kw)

        def forward(batch):
            t1 = time.perf_counter()
            out = fn(batch)  # on the card; the CLI copies it to the host next
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t1) * 1e3)
            return out
        return forward

    def timed_search(self, loglikes):
        t1 = time.perf_counter()
        out = search(self, loglikes)
        utt_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    decode.make_forward, LatticeDecoder.decode = timed_forward, timed_search
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc = decode.main(argv, device=str(dev))
    finally:
        decode.make_forward, LatticeDecoder.decode = make_forward, search
    wall = time.perf_counter() - t0
    launches = read_counts()
    if rc != 0:
        fail(f"decode.main returned {rc}")
    print(f"decode path launches: {json.dumps(launches)}", flush=True)
    need_launches("decode path", launches, positive=("fbank", "lstm_fwd"), zero=("lstm_bwd",))
    hyps = [line.split() for line in open(os.path.join(root, "decode.hyp"))]
    frames = sum(dataset.utt_num_frames(u) for u in dataset.utt_ids)
    audio_s = frames * 0.01
    if len(hyps) != len(dataset.utt_ids) or len(utt_ms) != len(hyps):
        fail(f"decode wrote {len(hyps)} hypotheses after {len(utt_ms)} searches for "
             f"{len(dataset.utt_ids)} utterances")
    print(f"decode: {len(hyps)} utterances, {audio_s:.1f} s of audio in {wall:.2f} s wall "
          f"(real-time factor {audio_s / wall:.1f} x); forward {np.mean(fwd_ms):.2f} ms a batch "
          f"on the card, without the copy to the host (split below) ({len(fwd_ms)} batches of "
          f"<= 8, min {min(fwd_ms):.2f}, max "
          f"{max(fwd_ms):.2f}); host search {np.mean(utt_ms):.1f} ms an utterance (median "
          f"{np.median(utt_ms):.1f}, max {max(utt_ms):.1f}; {threads} threads; beam 16, "
          f"max_active 7000)", flush=True)
    # two utterances' scaled log-likelihoods: the card's dump against the
    # plain versions on the CPU
    feat_fn = FeaturePipeline(cfg.data.feat).for_eval()
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model)
    load_checkpoint(ckpt, model)
    forward = make_forward(model, feat_fn, np.load(prior), 0.1, torch.device("cpu"))
    posts = dict(kaldi_io.read_scp(dump + ".scp"))
    post_card, post_cpu = (os.path.join(root, f"decode_post_{n}.ark") for n in ("card", "cpu"))
    with kaldi_io.ArkWriter(post_card) as w_card, kaldi_io.ArkWriter(post_cpu) as w_cpu:
        for uid in dataset.utt_ids[:2]:
            utt = dataset.get(uid)
            want = forward({"wave": torch.from_numpy(utt.wave[None]),
                            "mask": torch.ones(1, utt.num_frames)})[0].numpy()
            got = kaldi_io.read_scp_entry(posts[uid], "mat")
            if got.shape != want.shape:
                fail(f"dumped log-likelihoods of {uid}: {got.shape}, expected {want.shape}")
            check(f"decode log-likelihoods {uid} ({utt.num_frames} frames), card vs CPU "
                  f"plain path", torch.from_numpy(got), torch.from_numpy(want),
                  TOL["eval_logits"])
            w_card.write(uid, got)
            w_cpu.write(uid, want)
    forward_split(dev, cfg, ckpt, np.load(prior), dataset)
    # one utterance's lattice at the CLI's beams, emitted but not post-processed
    ll = kaldi_io.read_scp_entry(posts[dataset.utt_ids[0]], "mat")
    t0 = time.perf_counter()
    lat, _frames, _sc = LatticeDecoder(g).decode_lattice(ll, with_frames=True)
    print(f"decode lattice of {dataset.utt_ids[0]} ({len(ll)} frames) at beam 16, max_active "
          f"7000, lattice beam 8: {lat.num_states} states, {lat.num_arcs} arcs, searched and "
          f"emitted in {time.perf_counter() - t0:.2f} s", flush=True)
    os.remove(dump)
    decode_lattice_run(dev, root, argv, dataset, ref)
    print(f"phase 12 (decode): {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(lexicon=lexicon, lexicon_path=lex_path, words=words, prior=prior,
                post_card=post_card, post_cpu=post_cpu)


def forward_split(dev, cfg, ckpt: str, log_prior, dataset) -> None:
    """The decode forward of one batch of 8, as ``decode.make_forward`` runs
    it, split by CUDA events into features (K1), the model (K2, the output
    layer), the fp32 log-softmax/prior/scale and the copy to pageable host
    memory; a copy into pinned memory is timed beside it."""
    import torch

    from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
    from pykaldi2_tpu_torch.data.prefetch import device_prefetch
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.pipeline import FeaturePipeline
    from pykaldi2_tpu_torch.utils import load_checkpoint

    feat_fn = FeaturePipeline(cfg.data.feat).for_eval()
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model).to(dev)
    load_checkpoint(ckpt, model)
    model.eval()
    lp = torch.as_tensor(log_prior, dtype=torch.float32, device=dev)
    loader = SeqDataloader(dataset, BucketSpec(boundaries=(200, 400, 800, 1600, 3200),
                                               batch_sizes=8), shuffle=False)
    batch = next(iter(device_prefetch(loader, dev)))
    batch.pop("utt_ids")
    parts = ("features", "model", "log_softmax/prior/scale", "copy to pageable host")
    ms = {k: [] for k in parts + ("copy to pinned host", "host wall")}
    pinned = None
    with torch.no_grad():
        for rep in range(8):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            feats = feat_fn(batch)
            ev[1].record()
            logits = model(feats, batch["mask"])
            ev[2].record()
            out = 0.1 * (torch.log_softmax(logits.to(torch.float32), dim=-1) - lp)
            ev[3].record()
            host = out.cpu().numpy()
            ev[4].record()
            wall = (time.perf_counter() - t0) * 1e3
            if pinned is None:
                pinned = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                ev[4].record()
            pinned.copy_(out)
            ev[5].record()
            torch.cuda.synchronize()
            if rep >= 3:  # the first calls warm up the allocator and the kernels
                for i, k in enumerate(parts):
                    ms[k].append(ev[i].elapsed_time(ev[i + 1]))
                ms["copy to pinned host"].append(ev[4].elapsed_time(ev[5]))
                ms["host wall"].append(wall)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"decode forward split, one batch {tuple(host.shape)} ({host.nbytes / 2**20:.1f} MiB "
          f"fp32), mean of 5 (CUDA events): " + ", ".join(f"{k} {v:.3f} ms"
                                                           for k, v in mean.items()), flush=True)


def subset_data(root: str, name: str, data_yaml: str, uids) -> str:
    """A copy of ``data_yaml`` whose wav.scp holds only ``uids``."""
    import yaml

    with open(data_yaml) as f:
        data = yaml.safe_load(f)
    scp = os.path.join(root, f"{name}_wav.scp")
    with open(data["wav_scp"]) as f, open(scp, "w") as out:
        out.writelines(line for line in f if line.split()[0] in uids)
    data["wav_scp"] = scp
    path = os.path.join(root, f"{name}_data.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    return path


def subset_lines(src: str, dst: str, uids) -> str:
    """The lines of ``src`` whose first field is in ``uids``, written to ``dst``."""
    with open(src) as f, open(dst, "w") as out:
        out.writelines(line for line in f if line.split()[0] in uids)
    return dst


def decode_lattice_run(dev, root: str, argv: list, dataset, ref: str) -> None:
    """run.sh stage 5's lattice flags (``-lattice_out x.ark -oracle``) and
    its consensus extra (``-mbr -ctm_out``) through ``decode.main`` on the
    first 8 utterances, the lattice ark read back. The lattice tools fold
    epsilons state by state in Python (as the reference's do); on this
    random-weight model a lattice at max_active 7000 holds hundreds of
    thousands of states (printed above), so this run keeps the CLI's beam
    and lattice beam and narrows max_active to 20. It runs on one thread,
    since the tools hold the GIL, and prints each tool's host ms an
    utterance."""
    import contextlib
    import io

    from pykaldi2_tpu_torch.bin import decode
    from pykaldi2_tpu_torch.decode import lattice, mbr
    from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder
    from pykaldi2_tpu_torch.decode.lattice_ark import read_lattice_ark, write_lattice_ark

    t_run = time.perf_counter()
    uids = dataset.utt_ids[:8]
    opts = dict(zip(argv[::2], argv[1::2]))
    data_yaml = subset_data(root, "decode_lat", opts["-data"], uids)
    sub_ref = subset_lines(ref, os.path.join(root, "decode_lat_ref.txt"), uids)
    lat_ark, ctm, hyp = (os.path.join(root, n) for n in ("decode.lat.ark", "decode.ctm",
                                                         "decode_lat.hyp"))
    run = ["-config", opts["-config"], "-data", data_yaml, "-model", opts["-model"],
           "-graph", opts["-graph"], "-words", opts["-words"], "-ref", sub_ref,
           "-prior", opts["-prior"], "-num_threads", "1", "-max_active", "20",
           "-hyp_out", hyp, "-lattice_out", lat_ark, "-oracle", "-mbr", "-ctm_out", ctm]

    ms = {"search + lattice": [], "lattice_word_fst": [], "lattice_word_fst_timed": [],
          "mbr_decode": []}
    sizes = []
    real = {"search + lattice": (LatticeDecoder, "decode_lattice"),
            "lattice_word_fst": (lattice, "lattice_word_fst"),
            "lattice_word_fst_timed": (mbr, "lattice_word_fst_timed"),
            "mbr_decode": (mbr, "mbr_decode")}
    saved = {k: getattr(owner, name) for k, (owner, name) in real.items()}

    def timed(key):
        fn = saved[key]

        def wrapper(*a, **kw):
            t1 = time.perf_counter()
            out = fn(*a, **kw)
            ms[key].append((time.perf_counter() - t1) * 1e3)
            if key == "search + lattice":
                sizes.append((out[0].num_states, out[0].num_arcs))
            return out
        return wrapper

    for k, (owner, name) in real.items():
        setattr(owner, name, timed(k))
    printed = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            rc = decode.main(run, device=str(dev))
    finally:
        for k, (owner, name) in real.items():
            setattr(owner, name, saved[k])
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(printed.getvalue(), end="", flush=True)
    if rc != 0:
        fail(f"decode.main with the lattice flags returned {rc}")
    need_launches("decode lattice path", launches, positive=("fbank", "lstm_fwd"),
                  zero=("lstm_bwd",))
    hyps = {line.split()[0]: line.split()[1:] for line in open(hyp)}
    lats = read_lattice_ark(lat_ark)
    if sorted(hyps) != sorted(uids) or sorted(lats) != sorted(uids):
        fail(f"decode with the lattice flags: hypotheses for {sorted(hyps)}, lattices for "
             f"{sorted(lats)}, expected {sorted(uids)}")
    for uid, f in lats.items():
        if f.num_states == 0 or not f.finals or f.start < 0:
            fail(f"lattice of {uid} read back with {f.num_states} states, {len(f.finals)} finals")
    again = lat_ark + ".again"
    write_lattice_ark(again, lats)
    with open(lat_ark, "rb") as a, open(again, "rb") as b:
        if a.read() != b.read():
            fail("the lattice ark read back does not write the same bytes")
    if "%Oracle WER" not in printed.getvalue():
        fail("decode -oracle printed no oracle WER")
    ctm_lines = [line.split() for line in open(ctm)]
    if (len(ctm_lines) != sum(len(w) for w in hyps.values())
            or any(len(c) != 6 or c[0] not in hyps for c in ctm_lines)):
        fail(f"CTM has {len(ctm_lines)} lines for {sum(len(w) for w in hyps.values())} "
             f"MBR words")
    mean = {k: sum(v) / max(len(v), 1) for k, v in ms.items()}
    print(f"decode lattice flags (-lattice_out, -oracle, -mbr -ctm_out; beam 16, lattice "
          f"beam 8, max_active 20): {len(uids)} utterances in {wall:.2f} s wall on one "
          f"thread; launches {json.dumps(launches)}; lattices "
          f"{sum(s[0] for s in sizes) / len(sizes):.0f} states, "
          f"{sum(s[1] for s in sizes) / len(sizes):.0f} arcs on average; host ms an "
          f"utterance: "
          + ", ".join(f"{k} {v:.1f} (max {max(ms[k]):.1f})" for k, v in mean.items())
          + f"; {len(lats)} lattices read back, {len(ctm_lines)} CTM words", flush=True)
    print(f"phase 12 lattice run: {time.perf_counter() - t_run:.1f} s", flush=True)


def k2_single_check(dev) -> None:
    """Phase 13: K2 at B=1, H=1024 over one 512-frame bucket (align's launch),
    against its plain version with phase 2's tolerance; two calls on the same
    inputs must agree bit for bit."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    rng = np.random.RandomState(13)
    t_len = ALIGN_BUCKET
    xp = torch.tensor((rng.randn(t_len, 1, 4 * H) * 0.5).astype(np.float32), device=dev)
    wh = torch.tensor((rng.uniform(-1, 1, (H, 4 * H)) / math.sqrt(H)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    mask = torch.ones(t_len, 1, device=dev)
    mask[449:] = 0.0
    got = L.lstm_fwd(xp, wh, mask)
    again = L.lstm_fwd(xp, wh, mask)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(got, again)):
        fail("K2 at B=1: two calls on the same inputs differ")
    yp, cp, gp = L.lstm_fwd_plain(xp, wh, mask)
    what = f"T={t_len} B=1 H={H}"
    check(f"K2 lstm_fwd ys at {what}", got[0], yp, TOL["lstm_fwd"])
    check(f"K2 lstm_fwd cs at {what}", got[1], cp, TOL["lstm_fwd"])
    check(f"K2 lstm_fwd gates (bf16) at {what}", got[2], gp, TOL["lstm_fwd_gates"])
    print(f"kernel K2 at {what}: {timed(lambda: L.lstm_fwd(xp, wh, mask), n=10):.4f} ms "
          f"(CUDA events over 10 calls), clusters {L.lstm_clusters(H, dev)}", flush=True)


def f3_checks(dev) -> None:
    """Phase 13, fault F3: an LSTM at H=1040 and an LSTMP at H=48, P=64 (shapes
    outside the kernels) run one forward and backward on the card against the
    CPU, with no kernel launched and the slow route's warning logged; the
    flagship H=1024 still takes K2/K3."""
    import logging

    import torch

    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    warned = []

    class Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    logger = logging.getLogger(L.__name__)
    handler = Catch(logging.WARNING)
    logger.addHandler(handler)
    try:
        for h, p in ((1040, 0), (48, 64)):
            what = f"LSTM H={h}" + (f" P={p}" if p else "")
            gen = torch.Generator().manual_seed(h)
            t_len, b = 20, 4
            args = [torch.randn(t_len, b, 4 * h, generator=gen) * 0.5,
                    (torch.rand(p or h, 4 * h, generator=gen) * 2 - 1) / math.sqrt(h)]
            if p:
                args.append((torch.rand(h, p, generator=gen) * 2 - 1) / math.sqrt(h))
            mask = torch.ones(t_len, b)
            mask[12:, 1] = 0.0
            dys = torch.randn(t_len, b, p or h, generator=gen)
            fn = L.LstmProjSeq if p else L.LstmSeq
            outs = []
            warned.clear()
            zero_counts()
            for d in ("cpu", dev):
                leaves = [a.detach().to(d).requires_grad_() for a in args]
                y = fn.apply(*leaves, mask.to(d))
                (y * dys.to(d)).sum().backward()
                outs.append((y.detach().cpu(), [a.grad.cpu() for a in leaves]))
            launches = read_counts()
            need_launches(f"{what} (outside the kernels)", launches,
                          zero=("lstm_fwd", "lstm_bwd", "lstm_proj_fwd", "lstm_proj_bwd"))
            if not any(f"hidden size {h}" in m for m in warned):
                fail(f"{what}: the plain route logged no warning ({warned})")
            (y_cpu, g_cpu), (y_card, g_card) = outs
            check(f"F3 {what} forward, card (plain route) vs CPU", y_card, y_cpu,
                  TOL["blstm_out"])
            worst = max(float((u - v).abs().max() / v.abs().max())
                        for u, v in zip(g_card, g_cpu))
            print(f"F3 {what} gradients, card vs CPU: max error relative to each tensor's "
                  f"max {worst:.3e} (tolerance {TOL['blstm_grad_rel']:g}); kernel launches "
                  f"0; warned: {warned[0]!r}", flush=True)
            if not math.isfinite(worst) or worst > TOL["blstm_grad_rel"]:
                fail(f"F3 {what} gradients disagree: {worst}")
    finally:
        logger.removeHandler(handler)
    gen = torch.Generator().manual_seed(3)
    xp = (torch.randn(16, 2, 4 * H, generator=gen) * 0.5).to(dev).requires_grad_()
    wh = ((torch.rand(H, 4 * H, generator=gen) * 2 - 1) / math.sqrt(H)).to(dev)
    zero_counts()
    L.LstmSeq.apply(xp, wh.requires_grad_(), torch.ones(16, 2, device=dev)).sum().backward()
    launches = read_counts()
    if (launches["lstm_fwd"], launches["lstm_bwd"]) != (1, 1):
        fail(f"the flagship H={H} did not take K2/K3 once each: {launches}")
    print(f"F3: H={H} takes K2/K3 ({launches['lstm_fwd']}, {launches['lstm_bwd']} launches)",
          flush=True)


def align_phase(dev, root: str, se_cfg: str, se_data: str, ckpt: str, dec: dict) -> dict:
    """Phase 13, run.sh stage 0: ``bin/align.main -trans_model`` with phase
    12's checkpoint over the first ALIGN_UTTS utterances of phase 9's corpus,
    with transcripts of random words of phase 12's lexicon; the forward and
    ``fsa_viterbi`` timed per utterance by CUDA events; one utterance against
    the same CLI on the CPU. Returns the paths stage 4 reads."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.bin import align
    from pykaldi2_tpu_torch.config import load_data_config
    from pykaldi2_tpu_torch.data import kaldi_io
    from pykaldi2_tpu_torch.data.dataset import SpeechDataset
    from pykaldi2_tpu_torch.ops.fb import fsa_viterbi

    t_phase = time.perf_counter()
    dataset = SpeechDataset.from_config(load_data_config(se_data))
    rng = np.random.RandomState(13)
    words = list(dec["lexicon"])
    # transcripts of 3-8 words for every utterance (4-4.5 s: at 3 frames a
    # phone and at most 5 phones a word, 8 words take at most 120 frames),
    # every word of the lexicon used at least once so the LMs cover it
    stream = list(rng.permutation(words)) + list(rng.choice(words, 6 * len(dataset.utt_ids)))
    texts = {}
    for uid in dataset.utt_ids:
        n = int(rng.randint(3, 9))
        texts[uid], stream = stream[:n], stream[n:]
    text = os.path.join(root, "align_text.txt")
    with open(text, "w") as f:
        f.writelines(f"{uid} {' '.join(ws)}\n" for uid, ws in texts.items())
    uids = dataset.utt_ids[:ALIGN_UTTS]
    sub_text = subset_lines(text, os.path.join(root, "align_text_sub.txt"), uids)
    mdl = os.path.join(root, "se_corpus", "final.mdl")

    events, captured, state = [], {}, {}
    make_forward, viterbi = align.make_forward, align.fsa_viterbi

    def with_events(kind, fn, *a):
        if state["key"] != "card":
            return fn(*a)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*a)
        ev[1].record()
        events.append([kind, ev])
        return out

    def timed_forward(*a, **kw):
        fn = make_forward(*a, **kw)
        return lambda wave, mask: with_events("forward", fn, wave, mask)

    def timed_viterbi(obs, graph, num_frames):
        score, arcs = with_events("viterbi", viterbi, obs, graph, num_frames)
        if state["key"] not in captured:  # the first utterance's inputs and result
            captured[state["key"]] = (obs.cpu(), graph.to("cpu"), num_frames.cpu(),
                                      score.cpu(), arcs.cpu())
        return score, arcs

    def run(what, argv, device, key):
        state["key"] = key
        align.make_forward, align.fsa_viterbi = timed_forward, timed_viterbi
        try:
            t0 = time.perf_counter()
            rc = align.main(argv, device=device)
            wall = time.perf_counter() - t0
        finally:
            align.make_forward, align.fsa_viterbi = make_forward, viterbi
        if rc != 0:
            fail(f"{what}: align.main returned {rc}")
        return wall

    ali = os.path.join(root, "align.ark")
    base = ["-config", se_cfg, "-data", se_data, "-model", ckpt, "-lexicon",
            dec["lexicon_path"], "-trans_model", mdl]
    zero_counts()
    wall = run("stage 0", base + ["-text", sub_text, "-out", ali], str(dev), "card")
    launches = read_counts()
    print(f"align path launches: {json.dumps(launches)}", flush=True)
    need_launches("align path", launches, positive=("fbank", "lstm_fwd"), zero=("lstm_bwd",))
    got = dict(kaldi_io.read_ark(ali, kind="ivec"))
    if sorted(got) != sorted(uids):
        fail(f"align wrote {len(got)} alignments for {len(uids)} utterances")
    for uid, pdfs in got.items():
        nf = dataset.utt_num_frames(uid)
        if pdfs.dtype != np.int32 or pdfs.shape != (nf,) or pdfs.min() < 0 or pdfs.max() >= 123:
            fail(f"alignment of {uid}: {pdfs.dtype} {pdfs.shape}, range [{pdfs.min()}, "
                 f"{pdfs.max()}], expected {nf} int32 pdf-ids below 123")
    score = float(captured["card"][3][0])
    if not (math.isfinite(score) and score > -1e29):
        fail(f"align: the first utterance's Viterbi score is {score}")
    torch.cuda.synchronize()
    ms = {"forward": [], "viterbi": []}
    for kind, ev in events:
        ms[kind].append(ev[0].elapsed_time(ev[1]))
    frames = sum(dataset.utt_num_frames(u) for u in uids)
    print(f"align (stage 0): {len(uids)} utterances, {frames} frames, in {wall:.2f} s wall "
          f"({wall * 1e3 / len(uids):.1f} ms an utterance); per utterance (CUDA events, "
          f"frames padded to a power of two >= 128): forward {np.mean(ms['forward']):.2f} ms "
          f"(min {min(ms['forward']):.2f}, max {max(ms['forward']):.2f}), fsa_viterbi "
          f"{np.mean(ms['viterbi']):.2f} ms (min {min(ms['viterbi']):.2f}, max "
          f"{max(ms['viterbi']):.2f}); K1 {launches['fbank']}, K2 {launches['lstm_fwd']} "
          f"launches; first score {score:.2f}", flush=True)

    # the first utterance through the same CLI on the CPU
    first = uids[0]
    ali_cpu = os.path.join(root, "align_cpu.ark")
    one = subset_lines(text, os.path.join(root, "align_text_one.txt"), [first])
    run("stage 0 on the CPU", base + ["-text", one, "-out", ali_cpu], "cpu", "cpu")
    want = dict(kaldi_io.read_ark(ali_cpu, kind="ivec"))[first]
    obs_card, graph, nf, _, arcs_card = captured["card"]
    obs_cpu, _, _, score_cpu, _ = captured["cpu"]
    d = check(f"align log-likelihoods of {first} ({int(nf[0])} frames), card vs CPU",
              obs_card[0, : int(nf[0])], obs_cpu[0, : int(nf[0])], TOL["eval_logits"])
    # the Viterbi on identical inputs: the CPU's arcs must be the card's
    s2, a2 = fsa_viterbi(obs_card, graph, nf)
    if not torch.equal(a2, arcs_card) or abs(float(s2[0]) - score) > 1e-5 * abs(score):
        fail(f"fsa_viterbi on the card's log-likelihoods: CPU arcs equal "
             f"{torch.equal(a2, arcs_card)}, scores {float(s2[0])} vs {score}")
    same = float((got[first] == want).mean())
    if same < 1.0:
        # two Viterbi-best paths of inputs within d a frame: on the CPU's
        # inputs the card's path scores within 2·T·d of the CPU's best. The
        # path's score is summed in fp64; the CPU's best is fp32, two
        # additions a frame, each within 2^-24 of |best|: T·2^-23·|best|
        t = int(nf[0])
        arcs = arcs_card[0, :t]
        path = float((graph.weight[arcs].double()
                      + obs_cpu[0, torch.arange(t), graph.pdf[arcs]].double()).sum()
                     + float(graph.final[graph.dst[arcs[-1]]]))
        best = float(score_cpu[0])
        if path < best - 2 * t * d - t * 2.0 ** -23 * abs(best):
            fail(f"align of {first}: the card's path scores {path} on the CPU's inputs, "
                 f"{best} best ({same:.3f} of frames agree)")
    print(f"align of {first}: card vs CPU CLI, {same:.4f} of frames equal; fsa_viterbi on "
          f"identical inputs equal (arcs, score {score:.3f})", flush=True)
    print(f"phase 13 stage 0: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(ali=ali, mdl=mdl, texts=texts)


def graph_phase(dev, root: str, se_cfg: str, se_data: str, ckpt: str, dec: dict,
                stage0: dict) -> dict:
    """Phase 13, run.sh stage 4: order-2 and order-3 ``train_arpa`` LMs over
    stage 0's transcripts, ``bin/build_graph.main decode -arpa`` (HCLG) and
    ``den -ali``, each graph's size and host seconds; then ``bin/decode.main
    -graph hclg.npz`` on 8 utterances (stage 5 on stage 4's graph)."""
    import contextlib
    import io

    from pykaldi2_tpu_torch.bin import build_graph, decode
    from pykaldi2_tpu_torch.graph.arpa import train_arpa, write_arpa
    from pykaldi2_tpu_torch.graph.vfst import VectorFst
    from pykaldi2_tpu_torch.ops.fsa import load_fsa

    t_phase = time.perf_counter()
    sents = list(stage0["texts"].values())
    lms = {}
    for order in (2, 3):
        lms[order] = os.path.join(root, f"lm{order}.arpa")
        t0 = time.perf_counter()
        write_arpa(train_arpa(sents, order=order), lms[order])
        print(f"train_arpa order {order} over {len(sents)} transcripts: "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    hclg, den = os.path.join(root, "hclg.npz"), os.path.join(root, "den.npz")
    words = os.path.join(root, "hclg_words.txt")
    t0 = time.perf_counter()
    rc = build_graph.main(["decode", "-lexicon", dec["lexicon_path"], "-arpa", lms[3], "-out",
                           hclg, "-words_out", words, "-trans_model", stage0["mdl"]])
    hclg_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"build_graph decode -arpa returned {rc}")
    g = VectorFst.load(hclg)
    t0 = time.perf_counter()
    rc = build_graph.main(["den", "-ali", stage0["ali"], "-trans_model", stage0["mdl"],
                           "-out", den])
    den_s = time.perf_counter() - t0
    if rc != 0:
        fail(f"build_graph den returned {rc}")
    dg = load_fsa(den)
    if g.num_arcs == 0 or dg.num_arcs == 0:
        fail("build_graph wrote an empty graph")
    print(f"build_graph (stage 4): HCLG of {len(dec['lexicon'])} words, order-3 LM: "
          f"{g.num_states} states, {g.num_arcs} arcs in {hclg_s:.2f} s on the host; den graph "
          f"from {ALIGN_UTTS} alignments: {dg.num_states} states, {dg.num_arcs} arcs in "
          f"{den_s:.2f} s", flush=True)

    uids = sorted(stage0["texts"])[:8]
    data = subset_data(root, "hclg_decode", se_data, uids)
    ref = os.path.join(root, "hclg_ref.txt")
    with open(ref, "w") as f:
        f.writelines(f"{u} {' '.join(stage0['texts'][u])}\n" for u in uids)
    hyp = os.path.join(root, "hclg.hyp")
    argv = ["-config", se_cfg, "-data", data, "-model", ckpt, "-graph", hclg, "-words",
            words, "-ref", ref, "-prior", dec["prior"], "-hyp_out", hyp, "-num_threads",
            str(min(os.cpu_count() or 1, 8))]
    printed = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = decode.main(argv, device=str(dev))
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(printed.getvalue(), end="", flush=True)
    if rc != 0:
        fail(f"decode.main -graph hclg.npz returned {rc}")
    need_launches("HCLG decode path", launches, positive=("fbank", "lstm_fwd"),
                  zero=("lstm_bwd",))
    hyps = [line.split()[0] for line in open(hyp)]
    if sorted(hyps) != uids or "%WER" not in printed.getvalue():
        fail(f"decode on the HCLG: hypotheses for {hyps}, expected {uids}")
    print(f"decode on stage 4's HCLG: {len(uids)} utterances in {wall:.2f} s wall; launches "
          f"{json.dumps(launches)}", flush=True)
    print(f"phase 13 stage 4: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(lms=lms, hclg=hclg, words=words)


def lattice_tools_phase(root: str, dec: dict, stage0: dict, stage4: dict) -> None:
    """Phase 13, the lattice tools on the host, on word lattices of the two
    utterances with the longest transcripts (LibriSpeech's hold ~33 words,
    these 3-8) from stage 4's HCLG at the decode CLI's beams (16, max_active
    7000, lattice beam 8), as ``decode -lattice_out`` emits them. Phase 12's
    random-weight model gives flat log-likelihoods, whose word lattices are
    either a single path (max_active 20: 5-6 states) or millions of arcs; so
    the log-likelihoods here are N(0, LAT_SIGMA) with LAT_PEAK added along
    the utterance's stage 0 alignment, which gives word lattices of hundreds
    of states and thousands of arcs with the transcript on the best path.
    Then ``bin/lattice_tool.main``: N-best, LM rescoring from the order-3 LM
    in the HCLG to the order-2 LM, posterior pruning, each tool's host ms an
    utterance; and ``bin/compare_posteriors.main`` on phase 12's card and CPU
    arks."""
    import contextlib
    import io

    import numpy as np

    from pykaldi2_tpu_torch.bin import compare_posteriors, lattice_tool
    from pykaldi2_tpu_torch.bin.decode import load_graph
    from pykaldi2_tpu_torch.data import kaldi_io
    from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder
    from pykaldi2_tpu_torch.decode.lattice import lattice_word_fst
    from pykaldi2_tpu_torch.decode.lattice_ark import read_lattice_ark, write_lattice_ark

    t_phase = time.perf_counter()
    alis = dict(kaldi_io.read_ark(stage0["ali"], kind="ivec"))
    uids = sorted(sorted(alis, key=lambda u: (-len(stage0["texts"][u]), u))[:2])
    hclg = load_graph(stage4["hclg"])
    rng = np.random.RandomState(14)
    lats, sizes, ms_lat = {}, [], []
    for uid in uids:
        pdfs = alis[uid]
        ll = rng.randn(len(pdfs), 3 * SE_PHONES).astype(np.float32) * LAT_SIGMA
        ll[np.arange(len(pdfs)), pdfs] += LAT_PEAK
        t0 = time.perf_counter()
        lat, frames, _ = LatticeDecoder(hclg).decode_lattice(ll, with_frames=True)
        lats[uid] = lattice_word_fst(lat, loglikes=ll, frames=frames)
        ms_lat.append((time.perf_counter() - t0) * 1e3)
        sizes.append((len(pdfs), lat.num_states, lats[uid].num_states, lats[uid].num_arcs))
    lat2 = os.path.join(root, "lat2.ark")
    write_lattice_ark(lat2, lats)
    out = {n: os.path.join(root, n) for n in ("nbest.txt", "rescored.ark", "pruned.ark",
                                                 "rescored.hyp")}
    lms = stage4["lms"]
    runs = {"nbest 10": ["-nbest", "10", "-nbest_out", out["nbest.txt"]],
            "rescore lm3 -> lm2": ["-arpa_old", lms[3], "-arpa_new", lms[2], "-rescored_out",
                                   out["rescored.ark"], "-best_path", out["rescored.hyp"]],
            "prune_beam 4": ["-prune_beam", "4.0", "-pruned_out", out["pruned.ark"]]}
    ms = {}
    for what, extra in runs.items():
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = lattice_tool.main(["-lattices", lat2, "-words", stage4["words"]] + extra)
        ms[what] = (time.perf_counter() - t0) * 1e3 / len(lats)
        if rc != 0:
            fail(f"lattice_tool {what} returned {rc}")
    nb = [line.split() for line in open(out["nbest.txt"])]
    if sorted({x[0].rsplit("-", 1)[0] for x in nb}) != uids or len(nb) > 10 * len(uids):
        fail(f"lattice_tool -nbest 10 wrote {len(nb)} lines")
    # the peaked log-likelihoods make each transcript the lattice's best path
    for uid in uids:
        best = next(x[2:] for x in nb if x[0] == f"{uid}-1")
        if best != [str(w) for w in stage0["texts"][uid]]:
            fail(f"lattice_tool -nbest: the best path of {uid} is {best}, the transcript "
                 f"{stage0['texts'][uid]}")
    for name in ("rescored.ark", "pruned.ark"):
        back = read_lattice_ark(out[name])
        if sorted(back) != uids or any(not f.finals for f in back.values()):
            fail(f"lattice_tool wrote {name} with {sorted(back)}")
    pruned = read_lattice_ark(out["pruned.ark"])
    print(f"word lattices of {uids} ({[len(stage0['texts'][u]) for u in uids]} words) "
          f"from stage 4's HCLG (beam 16, max_active 7000, lattice "
          f"beam 8; log-likelihoods N(0, {LAT_SIGMA:g}) + {LAT_PEAK:g} on the aligned pdf): "
          + "; ".join(f"{t} frames, search lattice {s} states, word lattice {ws} states "
                      f"{wa} arcs" for t, s, ws, wa in sizes)
          + f"; search + lattice_word_fst {np.mean(ms_lat):.1f} ms an utterance on the host; "
          f"pruned at beam 4 to {[(f.num_states, f.num_arcs) for f in pruned.values()]} "
          f"(states, arcs)", flush=True)
    print("lattice_tool on those word lattices: host ms an utterance: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
          + "; each best path is its transcript", flush=True)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = compare_posteriors.main([dec["post_card"], dec["post_cpu"], "-atol",
                                      str(TOL["eval_logits"])])
    print(printed.getvalue(), end="", flush=True)
    if rc != 0:
        fail(f"compare_posteriors on phase 12's card and CPU arks returned {rc}")
    print(f"phase 13 lattice tools: {time.perf_counter() - t_phase:.1f} s", flush=True)


def align_graph_phase(dev, root: str, se_cfg: str, se_data: str, ckpt: str, dec: dict) -> None:
    """Phase 13: K2 at B=1, F3's routing, run.sh stages 0 and 4, the lattice tools."""
    t_phase = time.perf_counter()
    k2_single_check(dev)
    f3_checks(dev)
    stage0 = align_phase(dev, root, se_cfg, se_data, ckpt, dec)
    stage4 = graph_phase(dev, root, se_cfg, se_data, ckpt, dec, stage0)
    lattice_tools_phase(root, dec, stage0, stage4)
    print(f"phase 13 (align, graphs, lattice tools): {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# phase 14: the TDNN and Transformer backbones, and the search on the card
# ---------------------------------------------------------------------------


def backbone_card_vs_cpu(dev, what: str, cfg_yaml: str, data_yaml: str, exp: str) -> None:
    """Phase 14(a): the trained full-width checkpoint on two chunks of 80
    frames (the CPU front end's features), on the card and on the CPU, in
    fp32 and in the run's bf16: logits, the CE loss (relative) and every
    parameter's gradient (the norm of the difference against the CPU
    gradient's norm), each within ``BACKBONE_TOL[compute dtype]``."""
    import torch

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import ce_forward
    from pykaldi2_tpu_torch.utils import load_checkpoint

    cfg = load_config(cfg_yaml)
    cfg.data = load_data_config(data_yaml)
    dataset, feat_fn, _ = build_frontend(cfg.data)
    cfg.model.input_size = feat_fn.dim
    batch_np = next(iter(ChunkDataloader(dataset, 2, T, shuffle=False)))
    # the CPU front end's features feed both: K1 against its plain version
    # would otherwise move the inputs of the first product
    feats = feat_fn.for_eval()({k: torch.from_numpy(v) for k, v in batch_np.items()})
    for dtype in ("float32", "bfloat16"):
        cfg.model.compute_dtype = dtype
        tol = BACKBONE_TOL[dtype]
        out = {}
        for key, d in (("card", dev), ("cpu", torch.device("cpu"))):
            model = build_model(cfg.model).to(d)
            load_checkpoint(os.path.join(exp, "model.0.npz"), model)
            batch = {k: torch.from_numpy(v).to(d) for k, v in batch_np.items()}

            def fe(_batch, generator=None, x=feats.to(d)):
                return x

            logits = model(fe(batch), batch["mask"])
            nll, cnt, _cor = ce_forward(model, fe, batch, None, False)
            loss = nll / cnt
            loss.backward()
            out[key] = (logits.detach().cpu(), float(loss.detach()),
                        {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
        (lg, lc), (ng, nc) = (out["card"][0], out["cpu"][0]), (out["card"][1], out["cpu"][1])
        if tuple(lg.shape) != (2, T, SENONES) or not bool(torch.isfinite(lg).all()):
            fail(f"{what} logits have shape {tuple(lg.shape)} or non-finite values")
        check(f"{what} {dtype} logits, card vs CPU", lg, lc, tol["logits"])
        if abs(ng - nc) > tol["loss"] * abs(nc):
            fail(f"{what} {dtype} CE loss card {ng} vs CPU {nc}")
        rel = {n: float((out["card"][2][n] - g).norm() / max(float(g.norm()), 1e-30))
               for n, g in out["cpu"][2].items()}
        worst = sorted(rel, key=rel.get)[-3:]
        print(f"{what} {dtype} card vs CPU (2 x {T} frames): loss {ng:.6f} vs {nc:.6f}; "
              f"gradients |card - CPU| / |CPU| per tensor, worst: "
              + ", ".join(f"{n} {rel[n]:.3g}" for n in reversed(worst))
              + f" (bound {tol['grad_rel']})", flush=True)
        if not max(rel.values()) <= tol["grad_rel"]:
            fail(f"{what} {dtype} gradients card vs CPU: {max(rel.values()):.3g} of the "
                 f"tensor's norm")


def backbone_phase(dev, root: str, data_yaml: str, base: dict) -> None:
    """Phase 14(a): ``bin/train_ce.main`` with ce.yaml's ``type: tdnn`` and
    ``type: transformer`` at full width on phase 3's corpus; K1 launches and
    K2/K3 (and K5/K6) do not; the card against the CPU; phase 5's timing and
    profile beside the flagship's step of this run."""
    import yaml

    for what, model in (("TDNN", TDNN), ("Transformer", TRANSFORMER)):
        cfg_yaml = os.path.join(root, f"{what.lower()}.yaml")
        with open(cfg_yaml, "w") as f:
            yaml.safe_dump({
                "model": {**model, "output_size": SENONES, "dropout": 0.1,
                          "compute_dtype": "bfloat16"},
                "optimizer": {"type": "adam", "lr": 0.0002, "grad_clip": 5.0},
                "trainer": {"batch_size": B, "chunk_len": T, "num_epochs": 1,
                            "log_interval": 1, "seed": 777}}, f)
        exp = os.path.join(root, f"exp_{what.lower()}")
        launches, steps = train_ce_run(dev, f"{what} CE path", cfg_yaml, data_yaml, exp)
        need_launches(f"{what} CE path", launches, positive=("fbank",),
                      zero=("lstm_fwd", "lstm_bwd", "lstm_proj_fwd", "lstm_proj_bwd"))
        print(f"{what} CE path: K1 {launches['fbank'] / steps:g} launches a step", flush=True)
        backbone_card_vs_cpu(dev, what, cfg_yaml, data_yaml, exp)
        got = step_timing(dev, cfg_yaml, data_yaml, f"{what} CE step")
        print(f"{what} CE step beside the flagship (B={B}, T={T}): queued {got['step_ms']:.3f} vs "
              f"{base['step_ms']:.3f} ms, fenced p50 {got['fenced_step_ms_p50']:.3f} vs "
              f"{base['fenced_step_ms_p50']:.3f} ms, {got['frames_per_sec']:.0f} vs "
              f"{base['frames_per_sec']:.0f} frames/s, busy {100 * got['device_busy_share']:.1f}% "
              f"vs {100 * base['device_busy_share']:.1f}%, peak {got['peak_mem_gib']:.2f} vs "
              f"{base['peak_mem_gib']:.2f} GiB", flush=True)


def search_compare(dev, what: str, obs, graph, nf, kw: dict, cpu_rows: int = 0) -> tuple:
    """Phase 14(b)-(d) on one batch: the captured search on the card against
    the same loop run eagerly on the card, and on the CPU for the first
    ``cpu_rows`` utterances (each row's search is independent of the others;
    the CPU loop takes seconds a row) (src, dst, pdf, dropped exactly;
    weights, finals and scores within ``SEARCH_TOL`` of max(1, |x|)); then
    the times of both on the card, the capture and the device operations a
    frame of the eager loop (the nodes its graph holds). Returns the
    captured search's output."""
    import torch

    from pykaldi2_tpu_torch.decode import device_lattice as DL
    from pykaldi2_tpu_torch.utils import tracing

    b, t = obs.shape[:2]
    search = DL.DeviceSearch(graph)
    tracing.take()
    cap = search(obs, nf, **kw)
    counters = tracing.take()["counters"]
    capture_s = counters.get("search.captures", (0, math.nan))[1]
    others = [(search(obs, nf, capture=False, **kw), "eager on the card", b)]
    through_k12 = [counters.get("search.frontier"),
                   tracing.take()["counters"].get("search.frontier")]
    if through_k12 != [(1, b * t)] * 2:
        fail(f"{what}: search.frontier read {through_k12} for the captured and the eager "
             f"search, not one call of B x T = {b * t} frames each")
    print(f"{what}: search.frontier {b * t} frames (B x T) for each of the captured and the "
          f"eager search: every frame through K12", flush=True)
    if cpu_rows:
        others.append((DL.device_lattice_generate(obs[:cpu_rows].cpu(), graph.to("cpu"),
                                                  nf[:cpu_rows].cpu(), capture=False, **kw),
                       f"eager on the CPU (rows 0-{cpu_rows - 1})", cpu_rows))
    for other, name, rows in others:
        err = 0.0
        for field, x, y in zip(cap[0]._fields, cap[0], other[0]):
            x, y = x[:rows].cpu(), y.cpu()
            if field in ("src", "dst", "pdf"):
                if not torch.equal(x, y):
                    fail(f"{what}: captured search vs {name}: {field} differs")
            else:
                err = max(err, close(f"{what} {field}, captured vs {name}", x, y,
                                     SEARCH_TOL, SEARCH_TOL))
        err = max(err, close(f"{what} scores, captured vs {name}", cap[1][:rows].cpu(),
                             other[1].cpu(), SEARCH_TOL, SEARCH_TOL))
        if not torch.equal(cap[2][:rows].cpu(), other[2].cpu()):
            fail(f"{what}: dropped counts differ, captured vs {name}")
        print(f"{what}: captured search equals the {name} (indices exact, weights within "
              f"{err:.3g})", flush=True)
    eager_ms = timed(lambda: search(obs, nf, capture=False, **kw), n=1, warmup=0)
    rep_ms = timed(lambda: search(obs, nf, **kw), n=5, warmup=1)
    # the profiler's cost grows with the operations it records: count them on
    # the first OPS_FRAMES frames, profile one replay
    _busy, ops = profile_steps(
        lambda: search(obs[:, :OPS_FRAMES], nf.clamp(max=OPS_FRAMES), capture=False, **kw), 1,
        f"{what} eager search profile (first {OPS_FRAMES} frames)", top=8)
    busy, _ops = profile_steps(lambda: search(obs, nf, **kw), 1,
                               f"{what} captured search profile", top=5)
    live = (cap[0].weight > -5e29).sum(2)
    print(f"{what} search (B={b}, T={t}, {json.dumps(kw)}): captured {rep_ms:.2f} ms "
          f"({1e3 * rep_ms / t:.1f} us a frame, busy {100 * busy:.1f}%) vs eager {eager_ms:.2f} ms "
          f"({1e3 * eager_ms / t:.1f} us a frame); capture {capture_s:.2f} s "
          f"of host time, {ops / OPS_FRAMES:.1f} device operations a frame (graph nodes); "
          f"links a frame max {int(live.max())}, mean {float(live.float().mean()):.1f}; dropped "
          f"{int(cap[2].sum())}", flush=True)
    return cap


def frontier_state(g, b: int) -> tuple:
    """The search's start state over ``g``: (alpha [B, S], slot_prev [B, S])."""
    import torch

    alpha = g.eps0_w[None].expand(b, g.num_states).clone()
    slot = torch.where(g.eps0_w > -5e29, 0, -1)[None].expand(b, g.num_states).clone()
    return alpha, slot


def frontier_equal(what: str, tabs, g, alpha, obs_t, slot, nf, t: int, k: int, beam: float,
                   lbeam: float):
    """One frame of K12 against ``frontier_plain`` on the same CUDA tensors:
    every output equal bit for bit (fp32 compared as int32 bits). Returns
    the plain version's outputs."""
    import torch

    from pykaldi2_tpu_torch.decode import frontier as FR

    got = FR.frontier(g, tabs, alpha, obs_t, slot, nf, t, k, beam, lbeam)
    want = FR.frontier_plain(g, alpha, obs_t, slot, nf, t, k, beam, lbeam)
    for field, x, y in zip(FR.Frontier._fields, got, want):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.shape != y.shape or not torch.equal(x, y):
            bad = int((x != y).sum()) if x.shape == y.shape else -1
            fail(f"K12 {what}, frame {t}: {field} differs from frontier_plain in {bad} of "
                 f"{y.numel()} entries")
    return want


def frontier_compare(what: str, g, obs, nf, k: int, beam: float, lbeam: float,
                     frames: int = FRONTIER_FRAMES) -> tuple:
    """K12 against ``frontier_plain`` along a search over ``g`` from its start
    state, ``frames`` frames of ``obs`` [B, T, P], each frame's inputs the
    plain version's previous outputs. Returns (alpha, slot_prev, tables)
    after the last frame."""
    import torch

    from pykaldi2_tpu_torch.decode import frontier as FR

    tabs = FR.frontier_tables(g)
    b, frames = obs.shape[0], min(frames, obs.shape[1])
    alpha, slot = frontier_state(g, b)
    n0 = FR.frontier.launches
    kept = []
    for t in range(frames):
        want = frontier_equal(what, tabs, g, alpha, obs[:, t], slot, nf, t, k, beam, lbeam)
        alpha, slot = want.alpha_next, want.slot_cur
        kept.append(want.keep_k.sum(dim=1))
    torch.cuda.synchronize()
    if FR.frontier.launches != n0 + frames:
        fail(f"K12 {what}: {FR.frontier.launches - n0} launches for {frames} frames")
    kept = torch.stack(kept).float()
    print(f"K12 {what} (B={b}, S={g.num_states}, K={k}, L={g.eps_depth}, beams "
          f"{beam:g}/{lbeam:g}): equal to frontier_plain bit for bit on {frames} frames from "
          f"the start state; frontier states kept a row: first frame "
          f"{float(kept[0].mean()):.1f}, last {float(kept[-1].mean()):.1f}", flush=True)
    return alpha, slot, tabs


def frontier_graph(s: int, s_lo: int, d_lo: int, d_hi: int, pdfs: int, seed: int, dev,
                   tied: bool = False):
    """A ``DeviceDecodeGraph`` of random in-arc tables (no eps arcs): S states,
    the first s_lo with d_lo in-arcs, the rest d_hi with about a third of
    them padding. ``tied``: the low bucket's weights are multiples of 0.5
    with −0.0 among them, the high bucket's −0.3 − multiples of 0.25, so
    that with scores in multiples of 0.5 many sums tie and no in-arc max
    meets +0.0 against −0.0 (an order the plain version leaves open)."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.decode.device_lattice import DeviceDecodeGraph
    from pykaldi2_tpu_torch.ops.fb import NEG_INF

    rng = np.random.RandomState(seed)
    s2 = s - s_lo
    src_lo = rng.randint(0, s, (s_lo, d_lo))
    src_hi = rng.randint(0, s, (s2, d_hi))
    if tied:
        w_lo = np.round(rng.randn(s_lo, d_lo) * 4) * 0.5
        w_lo[rng.rand(s_lo, d_lo) < 0.1] = -0.0
        w_hi = -0.3 - 0.25 * rng.randint(0, 12, (s2, d_hi))
    else:
        w_lo, w_hi = -3 * rng.rand(s_lo, d_lo), -3 * rng.rand(s2, d_hi)
    pad = rng.rand(s2, d_hi) < 0.3
    pad[:, 0] = False
    src_hi[pad], w_hi[pad] = 0, NEG_INF
    pdf = rng.randint(0, pdfs, s)
    eps0 = np.full(s, NEG_INF, np.float32)
    eps0[0] = 0.0

    def i64(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(dev)

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    empty_z, empty_t = i64(np.zeros(0)), i64(np.zeros((0, 1)))
    return DeviceDecodeGraph(
        in_src_lo=i64(src_lo), in_w_lo=f32(w_lo), in_src_hi=i64(src_hi), in_w_hi=f32(w_hi),
        in_ol_lo=i64(np.zeros((s_lo, d_lo))), in_ol_hi=i64(np.zeros((s2, d_hi))),
        state_pdf=i64(pdf), final=f32(np.full(s, NEG_INF)), eps_z1=empty_z,
        eps_src_z1=empty_t, eps_w_z1=f32(np.zeros((0, 1))), eps_z2=empty_z, eps_src_z2=empty_t,
        eps_w_z2=f32(np.zeros((0, 1))), eps_z3=empty_z, eps_src_z3=empty_t,
        eps_w_z3=f32(np.zeros((0, 1))), eps_out_dst=i64(np.zeros((s, 0))),
        eps_out_w=f32(np.zeros((s, 0))), eps0_w=f32(eps0), start=0, num_states=s, s_lo=s_lo,
        d_lo=d_lo, d_hi=d_hi, num_pdfs=int(pdf.max()) + 1, has_olabels=False, eps_depth=0)


def eps_loop_fst(phones: int = SE_PHONES, seed: int = 17):
    """A phone loop of 3-state HMMs (pdf 3q + j) whose junctions go through
    input-epsilon hubs: every phone's last state and the start reach hub 1
    by eps, hub 1 → hub 2 → hub 3 by eps, the first five phones also reach
    hub 4; each hub enters every phone. Eps depth 3, three eps in-degree
    buckets: the in-frame closure's layers."""
    import numpy as np

    from pykaldi2_tpu_torch.graph.fst import EPS, Fst

    rng = np.random.RandomState(seed)
    f = Fst()
    start = f.add_state()
    f.set_start(start)
    st = [[f.add_state() for _ in range(3)] for _ in range(phones)]
    hubs = [f.add_state() for _ in range(4)]
    f.add_arc(start, EPS, EPS, -0.1, hubs[0])
    f.add_arc(hubs[0], EPS, EPS, float(-rng.rand()), hubs[1])
    f.add_arc(hubs[1], EPS, EPS, float(-rng.rand()), hubs[2])
    for q in range(phones):
        for j in range(3):
            f.add_arc(st[q][j], 3 * q + j + 1, 0, float(np.log(rng.uniform(0.3, 0.8))),
                      st[q][j])
            if j < 2:
                f.add_arc(st[q][j], 3 * q + j + 2, 0, float(-rng.rand()), st[q][j + 1])
        f.add_arc(st[q][2], EPS, EPS, float(-rng.rand()), hubs[0])
        if q < 5:
            f.add_arc(st[q][2], EPS, EPS, float(-rng.rand()), hubs[3])
        f.set_final(st[q][2], float(-rng.rand()))
        f.add_arc(start, 3 * q + 1, 0, float(-2 - rng.rand()), st[q][0])
        for h in hubs:
            f.add_arc(h, 3 * q + 1, 0, float(-1 - 3 * rng.rand()), st[q][0])
    return f


def frontier_tied_checks(dev, what: str, g, ks, b: int = 16, draws: int = 4) -> None:
    """K12 against ``frontier_plain`` on single frames of drawn inputs: alpha
    in multiples of 0.5 with ±0.0 and NEG_INF entries, one row all NEG_INF,
    observations in multiples of 0.25 with ±0.0, one row past its last frame,
    slot_prev random; a beam that fp32 cannot hold exactly."""
    import torch

    from pykaldi2_tpu_torch.decode import frontier as FR
    from pykaldi2_tpu_torch.ops.fb import NEG_INF

    tabs = FR.frontier_tables(g)
    gen = torch.Generator(device=dev).manual_seed(23)
    s = g.num_states

    def signed_zeros(x):
        u = torch.rand(x.shape, generator=gen, device=dev)
        x = torch.where(u < 0.05, -0.0, x)
        return torch.where((u >= 0.05) & (u < 0.1), 0.0, x)

    for t in range(draws):
        alpha = signed_zeros(torch.round(torch.randn(b, s, generator=gen, device=dev) * 6) / 2)
        alpha = torch.where(torch.rand(b, s, generator=gen, device=dev) < 0.25, NEG_INF, alpha)
        alpha[-1] = NEG_INF
        obs_t = torch.round(torch.randn(b, SENONES, generator=gen, device=dev) * 8) / 4
        obs_t = signed_zeros(obs_t)
        nf = torch.full((b,), draws + 1, dtype=torch.int64, device=dev)
        nf[1] = t
        for k in ks:
            slot = torch.randint(-1, k, (b, s), generator=gen, device=dev)
            want = frontier_equal(what, tabs, g, alpha, obs_t, slot, nf, t, k, 10.3, 4.0)
            ties = int((want.vals[:, 1:] == want.vals[:, :-1]).sum())
            zeros = int((want.vals == 0).sum())
            if t == 0:
                print(f"K12 {what} (B={b}, S={s}, K={k}): equal to frontier_plain bit for bit "
                      f"on {draws} drawn frames; frame 0: {ties} tied neighbours among the top "
                      f"K, {zeros} of them ±0.0", flush=True)


def frontier_bytes(g, tabs, b: int, k: int) -> int:
    """Bytes one frame of K12 needs: the tables once, alpha and the pdfs'
    observations of each row read, the rows' outputs written."""
    s = g.num_states
    tables = sum(x.numel() * x.element_size() for x in
                 (tabs.lo_src, tabs.lo_w, tabs.hi_src, tabs.hi_w, tabs.pdf, tabs.elayers,
                  *tabs.ez, *tabs.esrc, *tabs.ew))
    pdfs = int(g.state_pdf.unique().numel())
    return tables + b * (4 * s + 4 * pdfs + 8 + (4 + 4 + 8) * s + (4 + 8 + 1 + 1) * k)


def frontier_time(what: str, g, tabs, obs_t, alpha, slot, nf, t: int, k: int, beam: float,
                  lbeam: float) -> dict:
    """K12's time on one frame (a CUDA graph of 50 calls, and eager calls)
    beside its bound, the plain version's (likewise) and ``torch.topk``
    alone on the plain version's [B, S] int64 keys. Returns the kernel row."""
    import torch

    from pykaldi2_tpu_torch.decode import frontier as FR
    from pykaldi2_tpu_torch.ops.fb import NEG_INF

    args = (g, tabs, alpha, obs_t, slot, nf, t, k, beam, lbeam)
    plain_args = (g, alpha, obs_t, slot, nf, t, k, beam, lbeam)
    ms = timed_graph(lambda: FR.frontier(*args))
    eager = timed(lambda: FR.frontier(*args), n=50)
    plain_ms = timed_graph(lambda: FR.frontier_plain(*plain_args))
    plain_eager = timed(lambda: FR.frontier_plain(*plain_args), n=20)
    r_lo, r_hi = FR.relax(g, alpha)
    m = r_lo.amax(dim=2) if r_hi is None else torch.cat([r_lo.amax(dim=2), r_hi.amax(dim=2)], 1)
    new_alpha = torch.where(m > -5e29, m + obs_t.index_select(1, g.state_pdf), NEG_INF)
    key = (~FR._order_key(new_alpha)) * (1 << 32) + torch.arange(g.num_states, device=m.device)
    lib_ms = timed_graph(lambda: torch.topk(key, k, dim=1, largest=False, sorted=True))
    b = alpha.shape[0]
    nbytes = frontier_bytes(g, tabs, b, k)
    slots = g.s_lo * g.d_lo + (g.num_states - g.s_lo) * g.d_hi
    bms, by = bound_ms(nbytes, [(3 * b * slots, FP32_FLOPS)])
    print(f"kernel K12 search_frontier {what} (B={b}, S={g.num_states}, K={k}): {ms:.4f} ms "
          f"(CUDA graph of 50 calls; eager calls {eager:.4f} ms) | plain {plain_ms:.4f} ms "
          f"(CUDA graph; eager {plain_eager:.4f} ms) | library (torch.topk alone) "
          f"{lib_ms:.4f} ms | bound {bms:.5f} ms ({by}, {nbytes} bytes)", flush=True)
    return dict(name="search_frontier", route="cuda",
                source="pykaldi2_tpu_torch/csrc/search.cu",
                replaces="none (XLA ops in pykaldi2_tpu/decode/device_lattice.py)", ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)


def frontier_checks(dev) -> dict:
    """Phase 14, K12: the frontier kernel against ``frontier_plain``, bit for
    bit, along searches from the start state on tools/device_search_probe.py's
    SE den graph (K 200 at the benchmark's beams 16/8, and K = S) and 200-word
    loop (K 2,000), an in-frame eps loop (K 64 and K = S), drawn frames with
    ties, ±0.0 and NEG_INF rows (K 200 and K = S), and a 60,000-state graph
    whose rows do not fit in shared memory (K 200, 7,000 and S: the sort
    buffer in global memory too); then timed at the den graph's K 200 (B=16)
    and the word loop's K 2,000 (B=8). Returns the den graph's kernel row."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.bin.train_se import phone_loop_den_fst
    from pykaldi2_tpu_torch.decode import device_lattice as DL
    from pykaldi2_tpu_torch.graph import (HmmTopology, TransitionModel, estimate_phone_bigram,
                                          make_decode_graph)

    t0 = time.perf_counter()
    tm = TransitionModel(HmmTopology.three_state(range(1, SE_PHONES + 1)))
    rng = np.random.RandomState(0)
    seqs = [list(rng.randint(1, SE_PHONES + 1, 30)) for _ in range(50)]
    den = DL.pack_decode_graph(
        phone_loop_den_fst(tm, estimate_phone_bigram(seqs, tm.topo.phones))).to(dev)
    lexicon = {f"w{i:03d}": [[int(p) for p in rng.randint(1, SE_PHONES + 1, rng.randint(2, 6))]]
               for i in range(DECODE_WORDS)}
    word = DL.pack_decode_graph(make_decode_graph(tm, lexicon, {w: i + 1 for i, w in
                                                                enumerate(lexicon)}),
                                eps_mode="auto").to(dev)
    eps = DL.pack_decode_graph(eps_loop_fst(), eps_mode="inframe").to(dev)
    if eps.eps_depth < 3:
        fail(f"the eps loop packed with eps depth {eps.eps_depth}, not 3")

    def obs_for(b, t):
        gen = torch.Generator(device=dev).manual_seed(5 + b)
        return 0.1 * torch.log_softmax(
            torch.randn(b, t, SENONES, generator=gen, device=dev) * 3, dim=-1)

    def nf_for(b, t):
        nf = torch.full((b,), t, dtype=torch.int64, device=dev)
        nf[-1] = t - 7
        return nf

    b_den, b_word = 16, 8
    obs_den, obs_word = obs_for(b_den, FRONTIER_FRAMES), obs_for(b_word, FRONTIER_FRAMES)
    nf_den, nf_word = nf_for(b_den, FRONTIER_FRAMES), nf_for(b_word, FRONTIER_FRAMES)
    den_state = frontier_compare("SE den graph", den, obs_den, nf_den, 200, 16.0, 8.0)
    frontier_compare("SE den graph, K = S", den, obs_den, nf_den, den.num_states, 16.0, 8.0)
    k_word = min(DEV_DECODE["max_active"], word.num_states)
    word_state = frontier_compare("decode word loop", word, obs_word, nf_word, k_word,
                                  DEV_DECODE["beam"], DEV_DECODE["lattice_beam"])
    for k in (64, eps.num_states):
        frontier_compare("in-frame eps loop" + (", K = S" if k == eps.num_states else ""), eps,
                         obs_word, nf_word, k, 16.0, 8.0)
    tied = frontier_graph(3000, 2000, 1, 6, SENONES, 29, dev, tied=True)
    frontier_tied_checks(dev, "tied scores", tied, (200, tied.num_states))
    big = frontier_graph(FRONTIER_BIG_S, FRONTIER_BIG_S * 5 // 6, 2, 8, SENONES, 31, dev)
    for k in (200, 7000, big.num_states):
        frontier_compare(f"{big.num_states}-state graph (rows in global memory)", big,
                         obs_den[:4], nf_den[:4], k, 16.0, 8.0, frames=8)
    print(f"K12 checks: {time.perf_counter() - t0:.1f} s", flush=True)
    alpha, slot, tabs = den_state
    t = FRONTIER_FRAMES - 1
    row = frontier_time("SE den graph", den, tabs, obs_den[:, t], alpha, slot, nf_den, t, 200,
                        16.0, 8.0)
    alpha, slot, tabs = word_state
    frontier_time("decode word loop", word, tabs, obs_word[:, t], alpha, slot, nf_word, t,
                  k_word, DEV_DECODE["beam"], DEV_DECODE["lattice_beam"])
    row["max_abs_err"] = 0.0
    return row


def device_se_phase(dev, root: str, ce_ckpt: str, se_cfg: str, se_data: str) -> int:
    """Phase 14(b): ``bin/train_se.main -on_the_fly -decoder device`` under
    MMI and sMBR at phase 9's settings and max_arcs 800, from phase 3's
    checkpoint: K1-K3, K12 and the criterion's K7/K8 or K9/K10 launch; the
    step split from ``metrics.jsonl`` beside phase 9's host-decoder steps;
    then one batch: K12 against its plain version along the search, the
    captured search against the eager loops on the card and the CPU (phase
    14(d)), and K7-K10 on its compacted band against their plain versions.
    Returns K12's launches in the MMI run."""
    import torch

    from pykaldi2_tpu_torch.bin import train_se
    from pykaldi2_tpu_torch.bin.train_se import phone_loop_den_fst
    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
    from pykaldi2_tpu_torch.decode.device_lattice import _compact_band, pack_decode_graph
    from pykaldi2_tpu_torch.graph import TransitionModel, estimate_phone_bigram
    from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts
    from pykaldi2_tpu_torch.pipeline import build_frontend
    from pykaldi2_tpu_torch.trainer import make_se_lattice_steps
    from pykaldi2_tpu_torch.utils import load_checkpoint, make_optimizer

    mdl = os.path.join(root, "se_corpus", "final.mdl")
    need = {"mmi": ("latfb_logz_fwd", "latfb_occupancies_bwd"),
            "smbr": ("latfb_smbr_fwd", "latfb_smbr_bwd")}
    for crit in ("mmi", "smbr"):
        exp = os.path.join(root, f"se_dev_{crit}")
        zero_counts()
        t0 = time.perf_counter()
        rc = train_se.main(
            ["-config", se_cfg, "-data", se_data, "-exp_dir", exp, "-on_the_fly", "-decoder",
             "device", "-criterion", crit, "-seed_model", ce_ckpt, "-trans_model", mdl,
             "-beam", str(DEV_SE["beam"]), "-lattice_beam", str(DEV_SE["lattice_beam"]),
             "-max_active", str(DEV_SE["max_active"]), "-max_arcs", str(DEV_SE["max_arcs"])],
            device=str(dev))
        wall = time.perf_counter() - t0
        got = read_counts()
        if rc != 0:
            fail(f"train_se.main -decoder device -criterion {crit} returned {rc}")
        need_launches(f"device-search SE {crit} path", got,
                      positive=("fbank", "lstm_fwd", "lstm_bwd", "search_frontier")
                      + need[crit])
        if crit == "mmi":
            frontier_launches = got["search_frontier"]
        steps = step_records(exp)
        if len(steps) != SE_UTTS // SE_B or not all(math.isfinite(r["objective"])
                                                     for r in steps):
            fail(f"device-search SE {crit}: expected {SE_UTTS // SE_B} steps with finite "
                 f"objectives, got {steps}")
        print(f"device-search SE {crit}: {len(steps)} steps in {wall:.2f} s of CLI (capture "
              f"included); launches a step: " + ", ".join(
                  f"{k} {got[k] / len(steps):g}" for k in ("fbank", "lstm_fwd", "lstm_bwd")
                  + need[crit]), flush=True)
        host = step_records(os.path.join(root, f"se_{crit}"))
        for r, h in zip(steps, host):
            parts = [r[k] for k in ("forward_ms", "search_ms", "compact_ms", "train_ms")]
            print(f"device-search SE {crit} step {int(r['step'])}: objective "
                  f"{r['objective']:.5f} | forward {parts[0]:.1f}, search {parts[1]:.1f}, "
                  f"compaction {parts[2]:.1f}, train step {parts[3]:.1f} ms: step {sum(parts):.1f} "
                  f"ms by events | band K {int(r['lat_k'])} A {int(r['lat_a'])} after "
                  f"compaction, lattice_links_dropped {int(r['lattice_links_dropped'])} | phase 9 "
                  f"host-decoder step {int(h['step'])}: forward {h['forward_ms']:.1f} + wait "
                  f"{h['wait_ms']:.1f} + train {h['train_ms']:.1f} ms (decode "
                  f"{h['decode_ms']:.1f}, pack {h['pack_ms']:.1f} ms on the host)", flush=True)

    # one batch: the first SE batch's eval obs from phase 3's checkpoint
    cfg = load_config(se_cfg)
    cfg.data = load_data_config(se_data)
    dataset, feat_fn, _ = build_frontend(cfg.data)
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model).to(dev)
    load_checkpoint(ce_ckpt, model)
    tm = TransitionModel.read_kaldi(mdl)
    p2p = {pdf: p for (p, _j, pdf) in tm.tuples}
    seqs = [collapse_to_phones([p2p[int(x)] for x in lab]) for lab in dataset.labels.values()]
    den = pack_decode_graph(phone_loop_den_fst(tm, estimate_phone_bigram(seqs, tm.topo.phones)))
    den = den.to(dev)
    loader = SeqDataloader(dataset, BucketSpec(boundaries=(SE_T,), batch_sizes=SE_B),
                           shuffle=False)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(iter(loader)).items()
             if k != "utt_ids"}
    log_prior = priors_from_counts(count_labels(dataset.labels.values(), cfg.model.output_size))
    fwd, _train = make_se_lattice_steps(model, feat_fn,
                                        make_optimizer(cfg.optimizer, model.parameters()),
                                        log_prior=log_prior,
                                        acoustic_scale=cfg.trainer.acoustic_scale,
                                        obs_transfer_dtype="float32")
    obs, nf = fwd(batch), batch["num_frames"]
    kw = {k: DEV_SE[k] for k in ("beam", "lattice_beam", "max_active", "max_arcs")}
    frontier_compare("SE den graph, phase 14(b)'s first batch", den, obs, nf.long(),
                     min(DEV_SE["max_active"], den.num_states), DEV_SE["beam"],
                     DEV_SE["lattice_beam"])
    lat, _ = _compact_band(search_compare(dev, "SE den graph", obs, den, nf, kw,
                                          cpu_rows=SEARCH_CPU_ROWS)[0], None)
    ref = torch.randint(0, SE_PHONES * 3, tuple(obs.shape[:2]), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    errs = latfb_compare(dev, "device-decoded", obs, lat, nf.long(), ref)
    print("K7-K10 on the device-decoded band (B=%d, T=%d, K=%d, A=%d) vs plain: %s"
          % (obs.shape[0], obs.shape[1], lat.num_slots, lat.src.shape[2],
             ", ".join(f"{k} {v:.3g}" for k, v in errs.items())), flush=True)
    return frontier_launches


def device_decode_phase(dev, root: str, se_cfg: str, se_data: str, ckpt: str, dec: dict) -> None:
    """Phase 14(c): ``bin/decode.main -decoder device`` over phase 12's 96
    utterances, checkpoint, prior and word loop at beam 16, max_active 2000
    (K is capped at the graph's states), max_arcs 1024 and lattice beam 8 (K1
    and K2 launch, K3 and K7-K10 not; search ms a batch by CUDA events, links
    dropped, retries, hypotheses equal to phase 12's host decode); then
    ``-on_device`` on the same graph, ``-nbest 5`` on 8 utterances through
    the device route, and one batch's captured search against the eager
    loops (phase 14(d))."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.bin import decode
    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
    from pykaldi2_tpu_torch.data.dataset import SpeechDataset
    from pykaldi2_tpu_torch.decode import device_lattice as DL
    from pykaldi2_tpu_torch.graph.fst import Fst
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.pipeline import FeaturePipeline
    from pykaldi2_tpu_torch.utils import load_checkpoint

    graph = os.path.join(root, "decode_graph.fst.txt")
    ref = os.path.join(root, "decode_ref.txt")
    threads = min(os.cpu_count() or 1, 16)
    cfg = load_config(se_cfg)
    cfg.data = load_data_config(se_data)
    dataset = SpeechDataset.from_config(cfg.data)
    audio_s = sum(dataset.utt_num_frames(u) for u in dataset.utt_ids) * 0.01
    base = ["-config", se_cfg, "-data", se_data, "-model", ckpt, "-graph", graph,
            "-words", dec["words"], "-ref", ref, "-prior", dec["prior"],
            "-num_threads", str(threads)]
    dev_args = ["-decoder", "device", "-beam", str(DEV_DECODE["beam"]), "-max_active",
                str(DEV_DECODE["max_active"]), "-max_arcs", str(DEV_DECODE["max_arcs"]),
                "-lattice_beam", str(DEV_DECODE["lattice_beam"])]
    calls, real = [], DL.DeviceSearch.__call__

    def timed_search(self, obs, nf, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(self, obs, nf, **kw)
        e1.record()
        calls.append((e0, e1, out[2].sum(), kw["lattice_beam"], obs.shape[1]))
        return out

    hyp = os.path.join(root, "decode_dev.hyp")
    DL.DeviceSearch.__call__ = timed_search
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc = decode.main(base + dev_args + ["-hyp_out", hyp], device=str(dev))
    finally:
        DL.DeviceSearch.__call__ = real
    wall = time.perf_counter() - t0
    launches = read_counts()
    if rc != 0:
        fail(f"decode.main -decoder device returned {rc}")
    need_launches("device decode path", launches,
                  positive=("fbank", "lstm_fwd", "search_frontier"),
                  zero=("lstm_bwd", "latfb_logz_fwd", "latfb_occupancies_bwd",
                        "latfb_smbr_fwd", "latfb_smbr_bwd"))
    first = [c for c in calls if c[3] == DEV_DECODE["lattice_beam"]]
    search_ms = [c[0].elapsed_time(c[1]) for c in first]
    dropped = sum(int(c[2]) for c in calls)
    retries = len(calls) - len(first)
    hyps = {ln.split()[0]: ln.split()[1:] for ln in open(hyp)}
    host = {ln.split()[0]: ln.split()[1:] for ln in open(os.path.join(root, "decode.hyp"))}
    same = sum(1 for u, w in hyps.items() if host.get(u) == w)
    if len(hyps) + retries < 1 or len(hyps) > len(dataset.utt_ids):
        fail(f"decode -decoder device wrote {len(hyps)} hypotheses")
    print(f"decode -decoder device: {len(hyps)} of {len(dataset.utt_ids)} utterances, "
          f"{audio_s:.1f} s of audio in {wall:.2f} s wall (real-time factor "
          f"{audio_s / wall:.1f} x); launches a batch: K1 {launches['fbank'] / len(first):g}, K2 "
          f"{launches['lstm_fwd'] / len(first):g}; search {np.mean(search_ms):.1f} ms a batch "
          f"by events (first batch, capture included, {search_ms[0]:.1f}; {len(first)} batches, "
          f"frames {sorted({c[4] for c in first})}); {dropped} links dropped, {retries} retries "
          f"at a wider lattice beam; {same} of {len(hyps)} hypotheses equal phase 12's host "
          f"decode (random weights: reported, not required)", flush=True)

    g = Fst.read_text(graph)
    if any(a.ilabel == 0 for arcs in g.arcs for a in arcs):
        fail("phase 12's word loop has eps arcs: -on_device needs a fully-emitting graph")
    hyp_od = os.path.join(root, "decode_ondev.hyp")
    zero_counts()
    t0 = time.perf_counter()
    if decode.main(base + ["-on_device", "-hyp_out", hyp_od], device=str(dev)) != 0:
        fail("decode.main -on_device failed")
    wall = time.perf_counter() - t0
    got = read_counts()
    need_launches("on-device decode path", got, positive=("fbank", "lstm_fwd"),
                  zero=("lstm_bwd",))
    od = {ln.split()[0]: ln.split()[1:] for ln in open(hyp_od)}
    if sorted(od) != sorted(dataset.utt_ids):
        fail(f"decode -on_device wrote {len(od)} hypotheses for {len(dataset.utt_ids)}")
    same = sum(od[u] == host.get(u) for u in od)
    print(f"decode -on_device: {len(od)} utterances, {audio_s:.1f} s of audio in {wall:.2f} s "
          f"wall (real-time factor {audio_s / wall:.1f} x); {same} hypotheses equal phase "
          f"12's host decode", flush=True)

    uids = dataset.utt_ids[:8]
    sub = subset_data(root, "decode_dev_nbest", se_data, uids)
    nb = os.path.join(root, "decode_dev.nbest")
    t0 = time.perf_counter()
    run = ["-config", se_cfg, "-data", sub, "-model", ckpt, "-graph", graph, "-words",
           dec["words"], "-prior", dec["prior"], "-num_threads", "1", "-decoder", "device",
           "-max_active", str(NBEST_ACTIVE), "-nbest", "5", "-nbest_out", nb, "-hyp_out",
           os.path.join(root, "decode_dev_nbest.hyp")]
    if decode.main(run, device=str(dev)) != 0:
        fail("decode.main -decoder device -nbest 5 failed")
    lines = [ln.split() for ln in open(nb)]
    got_uids = {ln[0].rsplit("-", 1)[0] for ln in lines}
    if not got_uids or not got_uids <= set(uids) or any(len(ln) < 2 for ln in lines):
        fail(f"decode -decoder device -nbest 5 wrote {len(lines)} lines for {sorted(got_uids)}")
    print(f"decode -decoder device -nbest 5 (max_active {NBEST_ACTIVE}, one thread): {len(uids)} "
          f"utterances "
          f"in {time.perf_counter() - t0:.2f} s, {len(lines)} N-best lines for "
          f"{len(got_uids)} utterances", flush=True)

    # phase 14(d) on one batch of the decode: its log-likelihoods from the CLI's forward
    feat_fn = FeaturePipeline(cfg.data.feat).for_eval()
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model).to(dev)
    load_checkpoint(ckpt, model)
    model.eval()
    forward = decode.make_forward(model, feat_fn, np.load(dec["prior"]), 0.1, dev)
    loader = SeqDataloader(dataset, BucketSpec(boundaries=(200, 400, 800, 1600, 3200),
                                               batch_sizes=8), shuffle=False)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(iter(loader)).items()
             if k != "utt_ids"}
    word = DL.pack_decode_graph(g, eps_mode="auto").to(dev)
    kw = dict(DEV_DECODE, return_olabels=True)
    obs = forward(batch)
    frontier_compare("decode word loop, phase 14(c)'s first batch", word, obs,
                     batch["num_frames"].long(), min(DEV_DECODE["max_active"], word.num_states),
                     DEV_DECODE["beam"], DEV_DECODE["lattice_beam"])
    search_compare(dev, "decode word loop", obs, word, batch["num_frames"], kw)


def device_search_phase(dev, root: str, ce_ckpt: str, se_cfg: str, se_data: str,
                        se_ckpt: str, dec: dict, data_yaml: str, base: dict) -> tuple:
    """Phase 14: K12 against its plain version and timed, the other
    backbones (a), and the search on the card in training (b) and decoding
    (c), each captured search held against the eager loops (d). Returns
    (K12's kernel row, its launches in (b)'s MMI run)."""
    t_phase = time.perf_counter()
    row = frontier_checks(dev)
    backbone_phase(dev, root, data_yaml, base)
    t_b = time.perf_counter()
    launches = device_se_phase(dev, root, ce_ckpt, se_cfg, se_data)
    t_c = time.perf_counter()
    device_decode_phase(dev, root, se_cfg, se_data, se_ckpt, dec)
    t_end = time.perf_counter()
    print(f"phase 14 (K12 and backbones {t_b - t_phase:.1f} s, device-search SE "
          f"{t_c - t_b:.1f} s, device decode {t_end - t_c:.1f} s): {t_end - t_phase:.1f} s",
          flush=True)
    return row, launches


# phase 15: the data-parallel paths. (b)/(c) hold two ranks to one process at
# the reference's bounds (tests/test_parallel.py:68, :157); (a) and (d) to the
# run without a process group: relative to the leaf's max |p|
P15_TOL = {"dp": {"rtol": 3e-5, "atol": 3e-6}, "bf16": {"rtol": 2e-2, "atol": 2e-3},
           "same": 1e-6}
P15_OPT = {"type": "momentum", "momentum": 0.9, "lr": 0.01, "grad_clip": 5.0}
P15_TIMEOUT_S = 240


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(what: str, specs: list, envs: list) -> list:
    """Start one ``rank_main`` child per spec (this script's functions, in
    their own processes) with its environment, wait for all under one
    timeout, kill every child on the way out; returns their JSON results."""
    p15 = os.path.join(HERE, "build", "chip_smoke", "p15")
    os.makedirs(p15, exist_ok=True)
    procs, logs = [], []
    try:
        for i, (spec, env) in enumerate(zip(specs, envs)):
            spec = dict(spec, out=os.path.join(p15, f"{what}{i}.json"))
            path = os.path.join(p15, f"{what}{i}.spec.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            logs.append(open(os.path.join(p15, f"{what}{i}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", f"import chip_smoke; chip_smoke.rank_main({path!r})"],
                cwd=HERE, env={**os.environ, **env}, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + P15_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                fail(f"phase 15 {what}: a rank did not finish in {P15_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    out = []
    for i, p in enumerate(procs):
        with open(os.path.join(p15, f"{what}{i}.log")) as f:
            log = f.read()
        if p.returncode != 0:
            fail(f"phase 15 {what}: rank {i} exited {p.returncode}:\n{log[-4000:]}")
        with open(os.path.join(p15, f"{what}{i}.json")) as f:
            out.append(json.load(f))
    return out


def torchrun_env(port: int) -> dict:
    """torchrun's variables for a one-rank group on this card."""
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
            "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


def rank_main(spec_path: str) -> None:
    """A child of phase 15: runs ``spec["job"]`` and writes its JSON result."""
    sys.path.insert(0, HERE)
    with open(spec_path) as f:
        spec = json.load(f)
    out = {"ce_ddp": p15_ce_ddp, "two_ranks": p15_two_ranks, "se_ddp": p15_se_ddp}[
        spec["job"]](spec)
    with open(spec["out"], "w") as f:
        json.dump(out, f)


def p15_batch(spec: dict, dev):
    """Phase 3's first batch of B x T (no shuffle), the flagship's frontend
    and config with dropout 0."""
    import torch

    from pykaldi2_tpu_torch.config import load_config, load_data_config
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.pipeline import build_frontend

    cfg = load_config(spec["cfg"])
    cfg.data = load_data_config(spec["data"])
    dataset, feat_fn, _ = build_frontend(cfg.data)
    cfg.model.input_size = feat_fn.dim
    cfg.model.dropout = 0.0
    batch = next(iter(ChunkDataloader(dataset, B, T, shuffle=False)))
    return cfg, feat_fn, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def p15_model(cfg, dev, opt_cfg=None):
    import torch

    from pykaldi2_tpu_torch.config import OptimizerConfig
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.utils import make_optimizer

    model = build_model(cfg.model, generator=torch.Generator().manual_seed(11)).to(dev)
    opt = make_optimizer(OptimizerConfig(**opt_cfg) if opt_cfg else cfg.optimizer,
                         model.parameters())
    return model, opt


def queued_ms(step, batch, gen, n: int = 50) -> float:
    import torch

    for _ in range(3):
        step(batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        m = step(batch, gen)
    float(m["loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def p15_ce_ddp(spec: dict) -> dict:
    """(a) in a one-rank nccl group from torchrun's environment:
    ``bin/train_ce.main -multihost`` on phase 3's corpus and config with the
    counts zeroed and read around it; then (e) the flagship step queued with
    DDP and without a process group, in turns."""
    import torch

    from pykaldi2_tpu_torch.bin import train_ce
    from pykaldi2_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from pykaldi2_tpu_torch.trainer import make_ce_train_step

    dev, _ = init_distributed(True)  # env:// and nccl, as under torchrun
    backend = torch.distributed.get_backend()
    zero_counts()
    rc = train_ce.main(["-config", spec["cfg"], "-data", spec["data"], "-exp_dir", spec["exp"],
                        "-multihost"])
    launches = read_counts()
    cfg, feat_fn, batch = p15_batch(spec, dev)
    mesh = make_mesh()
    steps = {}
    for what in ("plain", "ddp"):
        model, opt = p15_model(cfg, dev)
        steps[what] = make_ce_train_step(model, feat_fn, opt, mesh if what == "ddp" else None)
    gen = torch.Generator(device=dev).manual_seed(1)
    times = {"plain": [], "ddp": []}
    for what in ("plain", "ddp", "ddp", "plain"):
        times[what].append(queued_ms(steps[what], batch, gen))
    torch.distributed.destroy_process_group()
    return {"rc": rc, "launches": launches, "backend": backend, "times": times}


def p15_two_ranks(spec: dict) -> dict:
    """(b)/(c): one of two gloo ranks on this card (a FileStore), its half of
    phase 3's first batch; one momentum step with fp32 sums, one from the same
    weights with bf16 sums, each saved; then fenced fp32 steps for the wall."""
    import torch
    import torch.distributed as dist

    from pykaldi2_tpu_torch.parallel.mesh import make_mesh
    from pykaldi2_tpu_torch.trainer import make_ce_train_step

    rank = spec["rank"]
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}", rank=rank,
                            world_size=2)
    dev = torch.device("cuda", 0)
    cfg, feat_fn, batch = p15_batch(spec, dev)
    half = {k: v[rank * B // 2:(rank + 1) * B // 2] for k, v in batch.items()}
    mesh = make_mesh()
    out, steps = {"walls_ms": []}, {}
    for comp in ("none", "bf16"):
        model, opt = p15_model(cfg, dev, P15_OPT)
        steps[comp] = make_ce_train_step(model, feat_fn, opt, mesh, grad_compression=comp)
        out[f"loss_{comp}"] = float(steps[comp](half)["loss"])
        torch.save(model.state_dict(), spec[f"params_{comp}"])
    for _ in range(5):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        steps["none"](half)
        torch.cuda.synchronize()
        out["walls_ms"].append((time.perf_counter() - t0) * 1e3)
    dist.destroy_process_group()
    return out


def p15_se_ddp(spec: dict) -> dict:
    """(d) in a one-rank nccl group: ``bin/train_se.main -multihost
    -on_the_fly -decoder device -criterion mmi`` at phase 14(b)'s argv, every
    torch.distributed collective and DDP forward recorded with whether the
    current stream was capturing a CUDA graph, and the captures counted."""
    import torch
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from pykaldi2_tpu_torch.bin import train_se

    seen = {"collectives": 0, "in_capture": 0, "captures": 0}

    def watch(fn):
        def call(*a, **kw):
            seen["collectives"] += 1
            seen["in_capture"] += int(torch.cuda.is_current_stream_capturing())
            return fn(*a, **kw)
        return call

    for name in ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "barrier",
                 "all_gather_into_tensor", "reduce_scatter_tensor", "_broadcast_coalesced"):
        if hasattr(dist, name):
            setattr(dist, name, watch(getattr(dist, name)))
    DistributedDataParallel.forward = watch(DistributedDataParallel.forward)
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, *a, **kw):
        seen["captures"] += 1
        return begin(self, *a, **kw)

    torch.cuda.CUDAGraph.capture_begin = capture_begin
    zero_counts()
    rc = train_se.main(spec["argv"] + ["-multihost"])
    return {"rc": rc, "launches": read_counts(), "seen": seen,
            "steps": step_records(spec["exp"])}


def p15_same(what: str, got: dict, want: dict, tol: float) -> float:
    """Largest |got − want| / max|want| over the leaves; fails above tol."""
    worst, where = 0.0, ""
    for k, w in want.items():
        g = got[k].to(w.device).float()
        rel = float((g - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
        if rel > worst:
            worst, where = rel, k
    print(f"{what}: largest difference {worst:.3e} of the leaf's max |p| ({where or 'none'}; "
          f"tolerance {tol:g})", flush=True)
    if not worst <= tol:
        fail(f"{what}: parameters differ by {worst:.3e} relative (> {tol:g}) in {where}")
    return worst


def p15_close(what: str, got: dict, want: dict, rtol: float, atol: float) -> None:
    """allclose over every leaf; prints the largest |diff| / (atol + rtol|want|)."""
    worst, where = 0.0, ""
    for k, w in want.items():
        r = float(((got[k] - w).abs() / (atol + rtol * w.abs())).max())
        if r > worst:
            worst, where = r, k
    print(f"{what}: largest |diff| is {worst:.3g} of atol {atol:g} + rtol {rtol:g}·|p| "
          f"({where})", flush=True)
    if not worst <= 1.0:
        fail(f"{what}: parameters outside rtol {rtol:g}, atol {atol:g} ({where}: {worst:.3f})")


def ckpt_params(path: str, dev) -> dict:
    import numpy as np
    import torch

    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(dev) for k in z.files if k.startswith("['params']")}


def parallel_phase(dev, root: str, exp: str, cfg_yaml: str, data_yaml: str, se_cfg: str,
                   se_data: str, ce_ckpt: str) -> None:
    """Phase 15: (a) ``train_ce -multihost`` in a one-rank nccl group equals
    phase 3's run without a group; (b) two gloo ranks on this card against
    one process; (c) the same with bf16 sums; (d) ``train_se -multihost
    -decoder device`` equals phase 14(b)'s MMI run, no collective inside the
    search's capture; (e) the times."""
    import torch

    from pykaldi2_tpu_torch.trainer import make_ce_train_step

    t_phase = time.perf_counter()
    p15 = os.path.join(root, "p15")
    shutil.rmtree(p15, ignore_errors=True)
    os.makedirs(p15)
    base = {"cfg": cfg_yaml, "data": data_yaml}

    (a,) = run_ranks("ce_ddp", [dict(base, job="ce_ddp", exp=os.path.join(p15, "ce"))],
                     [torchrun_env(free_port())])
    if a["rc"] != 0 or a["backend"] != "nccl":
        fail(f"phase 15(a): train_ce -multihost returned {a['rc']} on {a['backend']}")
    need_launches("DDP CE path (one nccl rank)", a["launches"],
                  positive=("fbank", "lstm_fwd", "lstm_bwd"))
    print(f"phase 15(a) launches: {json.dumps(a['launches'])}", flush=True)
    p15_same("phase 15(a) train_ce -multihost (one nccl rank) vs phase 3 (no group)",
             ckpt_params(os.path.join(p15, "ce", "model.0.npz"), dev),
             ckpt_params(os.path.join(exp, "model.0.npz"), dev), P15_TOL["same"])
    t_a = time.perf_counter()

    store = os.path.join(p15, "pg_gloo")
    specs = [dict(base, job="two_ranks", rank=r, store=store,
                  params_none=os.path.join(p15, f"fp32_{r}.pt"),
                  params_bf16=os.path.join(p15, f"bf16_{r}.pt")) for r in range(2)]
    two = run_ranks("two_ranks", specs, [{}, {}])
    cfg, feat_fn, batch = p15_batch(base, dev)
    model, opt = p15_model(cfg, dev, P15_OPT)
    single_loss = float(make_ce_train_step(model, feat_fn, opt)(batch)["loss"])
    single = model.state_dict()
    ranks = {comp: [torch.load(s[f"params_{comp}"], map_location=dev) for s in specs]
             for comp in ("none", "bf16")}
    for comp, (r0, r1) in ranks.items():
        for k in r0:
            if not torch.equal(r0[k], r1[k]):
                fail(f"phase 15({'b' if comp == 'none' else 'c'}): the two ranks' {k} differ")
    print(f"phase 15(b) two gloo ranks at B=2x{B // 2}: loss {two[0]['loss_none']:.6f} "
          f"(one process at B={B}: {single_loss:.6f}); ranks bit-identical", flush=True)
    p15_close("phase 15(b) two gloo ranks vs one process", ranks["none"][0], single,
              **P15_TOL["dp"])
    p15_close("phase 15(c) bf16 sums vs fp32 sums", ranks["bf16"][0], ranks["none"][0],
              **P15_TOL["bf16"])
    t_b = time.perf_counter()

    mdl = os.path.join(root, "se_corpus", "final.mdl")
    se_exp = os.path.join(p15, "se")
    argv = ["-config", se_cfg, "-data", se_data, "-exp_dir", se_exp, "-on_the_fly",
            "-decoder", "device", "-criterion", "mmi", "-seed_model", ce_ckpt,
            "-trans_model", mdl, "-beam", str(DEV_SE["beam"]), "-lattice_beam",
            str(DEV_SE["lattice_beam"]), "-max_active", str(DEV_SE["max_active"]),
            "-max_arcs", str(DEV_SE["max_arcs"])]
    (d,) = run_ranks("se_ddp", [dict(job="se_ddp", argv=argv, exp=se_exp)],
                     [torchrun_env(free_port())])
    seen = d["seen"]
    print(f"phase 15(d) launches: {json.dumps(d['launches'])}; collectives and DDP forwards "
          f"{seen['collectives']}, inside a capture {seen['in_capture']}, captures "
          f"{seen['captures']}", flush=True)
    if d["rc"] != 0 or len(d["steps"]) != SE_UTTS // SE_B:
        fail(f"phase 15(d): train_se -multihost returned {d['rc']}, steps {d['steps']}")
    need_launches("DDP device-search SE path (one nccl rank)", d["launches"],
                  positive=("fbank", "lstm_fwd", "lstm_bwd", "latfb_logz_fwd",
                            "latfb_occupancies_bwd"))
    if seen["captures"] < 1 or seen["collectives"] < 1 or seen["in_capture"] != 0:
        fail(f"phase 15(d): captures {seen['captures']}, collectives {seen['collectives']}, "
             f"{seen['in_capture']} of them inside a capture")
    p15_same("phase 15(d) train_se -multihost -decoder device (one nccl rank) vs phase 14(b)",
             ckpt_params(os.path.join(se_exp, "model.0.npz"), dev),
             ckpt_params(os.path.join(root, "se_dev_mmi", "model.0.npz"), dev),
             P15_TOL["same"])
    t_d = time.perf_counter()

    smi = card_name_and_limit()
    t = a["times"]
    print(f"phase 15(e) [{smi}]: flagship CE step queued (50 steps, B={B}x{T}) without a "
          f"process group {t['plain'][0]:.3f}, {t['plain'][1]:.3f} ms; with DDP over one "
          f"nccl rank {t['ddp'][0]:.3f}, {t['ddp'][1]:.3f} ms (turns: plain, DDP, DDP, "
          f"plain); two gloo ranks on this card, fenced step wall (B=2x{B // 2}, momentum): "
          f"rank 0 {', '.join(f'{w:.1f}' for w in two[0]['walls_ms'])} ms, rank 1 "
          f"{', '.join(f'{w:.1f}' for w in two[1]['walls_ms'])} ms", flush=True)
    print(f"phase 15 ((a) {t_a - t_phase:.1f} s, (b)/(c) {t_b - t_a:.1f} s, (d) "
          f"{t_d - t_b:.1f} s): {time.perf_counter() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 16: the generic per-utterance lattice route (ops/fb_batched.py) at
# phase 9's full width, held to the banded kernels K7-K10 on the same decoded
# lattices, to the CPU, and trained through make_se_lattice_steps
# ---------------------------------------------------------------------------

# 16(b)/(c): LAT_TOL's bounds (the two routes and the two devices sum the same
# fp32 terms in other orders): log Z within 1e-4·max(1, |x|); gamma within
# 1e-5 + 1e-4·|gamma|; the expected accuracy f and its gradient within
# 1e-5·max(1, |f|) + 1e-4·|x| (f and the arcs' c are frame counts up to T).
# 16(d): the first step's per-frame objective within 1e-4·max(1, |objective|)
# of the banded step's; each parameter's gradient within 1e-2 of the banded
# gradient's largest element: the obs gradients agree to ~1e-4, and a bf16
# rounding that flips in K3's operands moves one element by 2^-8 of it. (The
# updates themselves are not compared: at lr 1e-5 an update is a few fp32
# ulps of its parameter, so one ulp is half of it.)
GENERIC_GRAD_TOL = 1e-2


def decode_pairs(decoders, obs_np, nf_np) -> list:
    """(DenseFsa, state frames) per utterance from phase 9's host decoders,
    one thread each, as bin/train_se.py's ``decode_batch`` decodes them."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(decoders)
    pairs = [None] * obs_np.shape[0]

    def shard(k):
        for i in range(k, len(pairs), n):
            fsa, frames, _score = decoders[k].decode_lattice(obs_np[i, : nf_np[i]],
                                                             with_frames=True)
            pairs[i] = (fsa, frames)

    with ThreadPoolExecutor(n) as pool:
        list(pool.map(shard, range(n)))
    return pairs


def fenced(fn):
    """(fn's result, its wall ms, synchronised on both sides)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def value_and_grad(fn, obs, *args) -> tuple:
    """(fn(obs, *args) [B], d sum / d obs)."""
    o = obs.detach().clone().requires_grad_(True)
    f = fn(o, *args)
    f.sum().backward()
    return f.detach(), o.grad


def close_acc(what: str, got, want, f) -> float:
    """An expected accuracy or its gradient within 1e-5·max(1, |f|) +
    1e-4·|want|, f [B] the rows' expected accuracies."""
    import torch

    atol = LAT_TOL["abs"] * torch.clamp(f.abs(), min=1.0)
    return close(what, got, want, atol.reshape(-1, *([1] * (want.dim() - 1))), LAT_TOL["rel"])


def generic_vs_banded(obs, bg, lat, nf, ref, p2p, smi: str) -> dict:
    """16(b): the generic route against K7-K10 on the same lattices; returns
    the generic route's outputs for (c)."""
    import torch

    from pykaldi2_tpu_torch.ops import fb_batched as GB
    from pykaldi2_tpu_torch.ops import fb_lattice as FL

    t = obs.shape[1]
    (gz, ggam), g_ms = fenced(lambda: GB.fsa_occupancies_b(obs, bg, nf))
    (bz, bgam), b_ms = fenced(lambda: FL.lattice_occupancies_ts(obs, lat, nf))
    close("16(b) generic log Z vs K7", gz, bz, LAT_TOL["log"], LAT_TOL["log"])
    close("16(b) generic gamma vs K7/K8", ggam, bgam, LAT_TOL["abs"], LAT_TOL["rel"])
    print(f"16(b) [{smi}] fsa_occupancies_b {g_ms:.1f} ms ({g_ms / t:.3f} ms a frame) | "
          f"K7+K8 lattice_occupancies_ts {b_ms:.1f} ms", flush=True)
    out = {"logz": gz, "gamma": ggam}
    for level in ("pdf", "phone"):
        r = ref if level == "pdf" else p2p[ref]
        (gf, gg), ga_ms = fenced(lambda: value_and_grad(GB.batched_expected_accuracy, obs, bg,
                                                        r, nf, level, p2p))
        (bf, bgr), ba_ms = fenced(lambda: value_and_grad(FL.lattice_expected_accuracy_ts, obs,
                                                         lat, r, nf, level, p2p))
        close_acc(f"16(b) generic expected accuracy vs K9 ({level})", gf, bf, bf)
        close_acc(f"16(b) generic accuracy gradient vs K9/K10 ({level})", gg, bgr, bf)
        print(f"16(b) [{smi}] batched_expected_accuracy ({level}) value and gradient "
              f"{ga_ms:.1f} ms ({ga_ms / t:.3f} ms a frame) | K9+K10 {ba_ms:.1f} ms", flush=True)
        if level == "pdf":
            out.update(f=gf, grad=gg)
    return out


def generic_scatter_probe(bg, p_dim: int, smi: str) -> None:
    """16(b), P10: one frame's three ``scatter_add_`` passes of the generic
    route (arcs into their destination states, their source states, their
    pdfs) timed by CUDA events, as packed and with the padding arcs' ids
    (all one dead state, or pdf 0) spread over distinct ids: what the
    atomics on one address cost."""
    import torch

    from pykaldi2_tpu_torch.ops.fb import NEG_INF
    from pykaldi2_tpu_torch.ops.fb_batched import _seg_sum_b

    vals = torch.rand(bg.weight.shape, device=bg.weight.device)
    pad = bg.weight <= 0.5 * NEG_INF
    spread = torch.arange(pad.shape[1], device=pad.device).expand_as(pad)
    parts = []
    for name, ids, n in (("dst", bg.dst, bg.num_states), ("src", bg.src, bg.num_states),
                         ("pdf", bg.pdf, p_dim)):
        other = torch.where(pad, spread % n, ids)
        packed = timed(lambda: _seg_sum_b(vals, ids, n), n=10)
        parts.append(f"{name} {packed:.3f} ms ({timed(lambda: _seg_sum_b(vals, other, n), n=10):.3f} "
                     f"spread)")
    print(f"16(b) [{smi}] scatter_add_ of [B, E] = {list(pad.shape)} ({float(pad.float().mean()):.1%} "
          f"padding arcs) a call: {', '.join(parts)}", flush=True)


def generic_card_vs_cpu(pairs, obs, nf, ref, card: dict) -> None:
    """16(c): the generic route on the CPU for the two shortest rows (packed
    alone, cut to their frames: padding is inert) against the card's rows."""
    import torch

    from pykaldi2_tpu_torch.ops import fb_batched as GB

    rows = torch.argsort(nf)[:2]
    t2 = int(nf[rows].max())
    cpu_bg = GB.pack_graph_batch([pairs[i][0] for i in rows.tolist()])
    o, n, r = obs[rows, :t2].cpu(), nf[rows].cpu(), ref[rows, :t2].cpu()
    t0 = time.perf_counter()
    cz, cgam = GB.fsa_occupancies_b(o, cpu_bg, n)
    cf, cg = value_and_grad(GB.batched_expected_accuracy, o, cpu_bg, r, n, "pdf", None)
    cpu_s = time.perf_counter() - t0
    what = f"rows {rows.tolist()}, {t2} frames, E={cpu_bg.src.shape[1]}"
    close(f"16(c) generic log Z card vs CPU ({what})", card["logz"][rows].cpu(), cz,
          LAT_TOL["log"], LAT_TOL["log"])
    close("16(c) generic gamma card vs CPU", card["gamma"][rows, :t2].cpu(), cgam,
          LAT_TOL["abs"], LAT_TOL["rel"])
    close_acc("16(c) generic expected accuracy card vs CPU", card["f"][rows].cpu(), cf, cf)
    close_acc("16(c) generic accuracy gradient card vs CPU", card["grad"][rows, :t2].cpu(), cg,
              cf)
    if card["gamma"][rows, t2:].abs().max() > 0 or card["grad"][rows, t2:].abs().max() > 0:
        fail("16(c): the generic route wrote occupancies or gradients past the rows' frames")
    print(f"16(c) the CPU's generic route on {what}: {cpu_s:.1f} s", flush=True)


def generic_train_steps(dev, cfg, feat_fn, batch, log_prior, ckpt: str, bg, lat,
                        smi: str) -> None:
    """16(d): ``make_se_lattice_steps``' train_fn on the BatchedGraphs, 3 steps
    per criterion from phase 9's start: the first against the same step on
    the TimeSyncLattice, K1-K3 launched and K7-K10 not."""
    import torch

    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.trainer import make_se_lattice_steps
    from pykaldi2_tpu_torch.utils import load_checkpoint, make_optimizer

    banded = tuple(LATFB)
    t = batch["labels"].shape[1]
    for crit in ("mmi", "smbr"):
        def steps():
            model = build_model(cfg.model).to(dev)
            load_checkpoint(ckpt, model)
            _fwd, train = make_se_lattice_steps(
                model, feat_fn, make_optimizer(cfg.optimizer, model.parameters()),
                log_prior=log_prior, acoustic_scale=cfg.trainer.acoustic_scale,
                ce_ratio=cfg.trainer.ce_ratio, criterion=crit)
            return model, train, torch.Generator(device=dev).manual_seed(2)

        def grads(model):
            return {k: v.grad.detach().clone() for k, v in model.named_parameters()}

        model, train, gen = steps()
        want = float(train(batch, lat, gen)["objective"])
        want_g = grads(model)
        model, train, gen = steps()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        m, ms1 = fenced(lambda: train(batch, bg, gen))
        obj = [float(m["objective"])]
        got_g = grads(model)
        m, ms2 = fenced(lambda: train(batch, bg, gen))
        obj.append(float(m["objective"]))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        busy, ops = profile_steps(lambda: train(batch, bg, gen), 1,
                                  f"16(d) generic {crit} step profile ({smi})", top=10)
        launches = read_counts()
        print(f"16(d) generic {crit} path launches: {json.dumps(launches)}", flush=True)
        need_launches(f"generic {crit} step", launches, positive=("fbank", "lstm_fwd", "lstm_bwd"),
                      zero=banded)
        if not all(math.isfinite(x) for x in obj):
            fail(f"16(d) generic {crit} steps reached objectives {obj}")
        if abs(obj[0] - want) > LAT_TOL["log"] * max(1.0, abs(want)):
            fail(f"16(d) generic {crit} first step objective {obj[0]} vs banded {want}")
        worst = max(float((got_g[k] - want_g[k]).abs().max() / want_g[k].abs().max())
                    for k in want_g)
        if not worst <= GENERIC_GRAD_TOL:
            fail(f"16(d) generic {crit} first gradient vs banded: {worst} of the largest element")
        print(f"16(d) [{smi}] generic {crit} train step (B={SE_B}, T={t}, S={bg.num_states}, "
              f"E={bg.src.shape[1]}): fenced {ms1:.1f}, {ms2:.1f} ms; objectives "
              f"{', '.join(f'{x:.6f}' for x in obj)} (banded first step {want:.6f}); first "
              f"gradient within {worst:.2e} of the banded one's largest element (bound "
              f"{GENERIC_GRAD_TOL:g}); peak {peak:.2f} GiB; busy {100 * busy:.1f}%, "
              f"{ops:.0f} device operations a step, {ops / t:.1f} a frame", flush=True)


def generic_lattice_phase(dev, root: str, first: dict, se_cfg: str, se_data: str,
                          ce_ckpt: str) -> None:
    """Phase 16: phase 9's first sMBR batch decoded again by phase 9's host
    decoders into (DenseFsa, frames) pairs and packed both ways; (a) the
    buckets and the saved history's bytes against the card's free memory;
    (b) the generic route against K7-K10; (c) card against CPU; (d) the
    train step on BatchedGraphs."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch.graph import TransitionModel
    from pykaldi2_tpu_torch.ops.fb_batched import pack_graph_batch
    from pykaldi2_tpu_torch.ops.fb_lattice import pack_time_sync

    t_phase = time.perf_counter()
    smi = card_name_and_limit()
    _lat, obs_np, nf_np = first["smbr"]
    pairs = decode_pairs(first["decoders"], obs_np, nf_np)
    t_dec = time.perf_counter()
    bg = pack_graph_batch([f for f, _ in pairs])
    t_pack = time.perf_counter()
    lat = pack_time_sync(pairs, t_pad=obs_np.shape[1])
    same = all(torch.equal(a, b) for a, b in zip(lat, _lat))
    b, t = obs_np.shape[:2]
    s, e = bg.num_states, bg.src.shape[1]
    states = [f.num_states for f, _ in pairs]
    arcs = [f.num_arcs for f, _ in pairs]
    hist = {"mmi": t * b * s * 4, "smbr": 2 * t * b * s * 4}
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    print(f"16(a) {b} lattices decoded on {len(first['decoders'])} threads in "
          f"{t_dec - t_phase:.1f} s: states {min(states)}-{max(states)} (mean "
          f"{np.mean(states):.0f}), arcs {min(arcs)}-{max(arcs)} (mean {np.mean(arcs):.0f}); "
          f"pack_graph_batch S={s} E={e} in {1e3 * (t_pack - t_dec):.1f} ms; pack_time_sync "
          f"K={lat.num_slots} A={lat.src.shape[2]}, {'equal to' if same else 'unlike'} phase "
          f"9's band; saved history T*B*S*4 = {hist['mmi'] / 2**30:.2f} GiB (MMI alphas), "
          f"{hist['smbr'] / 2**30:.2f} GiB (sMBR alphas and accuracy alphas); free "
          f"{free / 2**30:.2f} GiB", flush=True)
    if hist["smbr"] >= free:
        fail(f"16(a): the generic route's saved history ({hist['smbr']} bytes at B={b}, T={t}, "
             f"S={s}) does not fit the card's {free} free bytes")
    obs = torch.from_numpy(obs_np).to(dev)
    nf = torch.from_numpy(nf_np).to(dev)
    ref = se_reference(dev, (b, t))
    tm = TransitionModel.read_kaldi(os.path.join(root, "se_corpus", "final.mdl"))
    p2p = torch.zeros(tm.num_pdfs, dtype=torch.long)
    for (phone, _j, pdf) in tm.tuples:
        p2p[pdf] = phone
    p2p = p2p.to(dev)
    bg, lat = bg.to(dev), lat.to(dev)
    card = generic_vs_banded(obs, bg, lat, nf, ref, p2p, smi)
    generic_scatter_probe(bg, obs.shape[2], smi)
    t_b = time.perf_counter()
    generic_card_vs_cpu(pairs, obs, nf, ref, card)
    del card
    t_c = time.perf_counter()
    cfg, feat_fn, batch, log_prior = se_first_batch(dev, se_cfg, se_data, nf_np)
    generic_train_steps(dev, cfg, feat_fn, batch, log_prior, ce_ckpt, bg, lat, smi)
    t_end = time.perf_counter()
    print(f"phase 16 ((a) {t_dec - t_phase:.1f} s decode, (b) {t_b - t_dec:.1f} s, (c) "
          f"{t_c - t_b:.1f} s, (d) {t_end - t_c:.1f} s): {t_end - t_phase:.1f} s", flush=True)


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
    padded = latfb_padded(dev)
    blstm_grad_check(dev)
    blstm_grad_check(dev, proj=128)
    root = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)  # the trainers resume from checkpoints they find
    exp, cfg_yaml, data_yaml, launches = main_path(dev, root)
    eval_check(dev, exp, cfg_yaml, data_yaml)
    base = step_timing(dev, cfg_yaml, data_yaml)
    recurrence_sweep(dev)
    proj_launches, _ = blstmp_path(dev, root, data_yaml)
    launches.update({k: proj_launches[k] for k in ("lstm_proj_fwd", "lstm_proj_bwd")})
    launches["mfcc"] = mfcc_path(dev, root, data_yaml, cfg_yaml)["mfcc"]
    se_launches, first, se_cfg, se_data = se_path(dev, root, os.path.join(exp, "model.0.npz"))
    decoded = se_step_checks(dev, first, se_cfg, se_data,
                             os.path.join(root, "se_smbr", "model.0.npz"))
    rows["block_matvec"], launches["block_matvec"] = fixed_den_phase(
        dev, root, os.path.join(exp, "model.0.npz"), se_cfg, se_data)
    simulation_phase(dev, root, cfg_yaml, data_yaml, base)
    se_ckpt = os.path.join(root, "se_mmi", "model.0.npz")
    dec = decode_phase(dev, root, se_cfg, se_data, se_ckpt)
    align_graph_phase(dev, root, se_cfg, se_data, se_ckpt, dec)
    rows["search_frontier"], launches["search_frontier"] = device_search_phase(
        dev, root, os.path.join(exp, "model.0.npz"), se_cfg, se_data, se_ckpt, dec, data_yaml,
        base)
    parallel_phase(dev, root, exp, cfg_yaml, data_yaml, se_cfg, se_data,
                   os.path.join(exp, "model.0.npz"))
    generic_lattice_phase(dev, root, first, se_cfg, se_data, os.path.join(exp, "model.0.npz"))

    smi = card_name_and_limit()
    print(smi, flush=True)
    # K7-K10: times and bounds at the decoded batch (the main path's shapes),
    # the error the largest of the probe's, the padded band's and the decoded
    # batch's
    for name, r in decoded.items():
        rows[name] = dict(r, max_abs_err=max(r["max_abs_err"], probe[name]["max_abs_err"],
                                             padded[name]))
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
