"""Sequence-discriminative trainer entry point (MMI / sMBR / MPE), PyTorch port.

Same CLI as pykaldi2_tpu/bin/train_se.py (reference behavior:
pykaldi2/bin/train_se.py — seeds from a CE model, computes scaled
pseudo-log-likelihoods, and trains with a lattice criterion):

    python -m pykaldi2_tpu_torch.bin.train_se -config se.yaml -data data.yaml \\
        -exp_dir exp/se -seed_model exp/ce/model.7.npz -criterion mmi \\
        [-den_graph den.npz | -generic_den | -on_the_fly -decoder host]

Two modes, as in the reference:

  * fixed denominator (the default): one denominator graph for the whole
    run, forward-backward on the device through one of four routes —
    the structured phone-bigram kernels (ops/fb_bigram.py) when no
    ``-den_graph`` is given (the recipe's stage 3), else ``pack_graph_auto``
    on the loaded (or ``-generic_den``: the alignment-estimated) graph:
    the dense state matrix up to 16,384 states (ops/fb_dense.py), the
    block-sparse tiles above that (ops/fb_block.py, kernel K11), the arc
    tables for graphs that break the state-emission rule (ops/fb.py);
  * ``-on_the_fly -decoder host``, the reference's signature mode: per
    batch the eval forward runs on the device, the native C++ decoder
    (decode/decoder.py) decodes one denominator lattice per utterance on
    host threads, the lattices are packed into frame bands
    (ops/fb_lattice.py), and the banded forward-backward runs on the device
    (kernels K7-K10).

Runs on one CUDA device unless ``PK2_PLATFORM=cpu`` (or ``main(...,
device="cpu")``) asks for the CPU. ``-decoder device`` and ``-multihost``
raise until their slices.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.config import load_config, load_data_config
from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
from pykaldi2_tpu_torch.data.prefetch import device_prefetch
from pykaldi2_tpu_torch.device import resolve_device
from pykaldi2_tpu_torch.graph import (HmmTopology, TransitionModel, estimate_phone_bigram,
                                      make_den_graph)
from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.ops.fsa import load_fsa
from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts
from pykaldi2_tpu_torch.pipeline import build_frontend
from pykaldi2_tpu_torch.trainer import Throughput
from pykaldi2_tpu_torch.utils import (
    MetricsLogger,
    PlateauAnnealer,
    latest_checkpoint,
    load_checkpoint,
    make_optimizer,
    save_checkpoint,
    setup_logging,
)
from pykaldi2_tpu_torch.utils.lr import set_lr_scale


def build_argparser():
    p = argparse.ArgumentParser(description="sequence-discriminative training")
    p.add_argument("-config", default=None)
    p.add_argument("-data", default=None)
    p.add_argument("-exp_dir", required=True)
    p.add_argument("-criterion", choices=["mmi", "smbr", "mpfe", "mpe"], default=None)
    p.add_argument("-seed_model", default=None, help="CE checkpoint to start from")
    p.add_argument("-resume_from_model", default=None)
    p.add_argument("-den_graph", default=None, help="prebuilt den graph (.npz)")
    p.add_argument("-prior_path", default=None, help="log-prior vector (.npy)")
    p.add_argument("-trans_model", default=None, help="final.mdl (ours or Kaldi)")
    p.add_argument("-lr", type=float, default=None)
    p.add_argument("-batch_size", type=int, default=None)
    p.add_argument("-num_epochs", type=int, default=None)
    p.add_argument("-acoustic_scale", type=float, default=None)
    p.add_argument("-den_scale", type=float, default=None)
    p.add_argument("-ce_ratio", type=float, default=None)
    p.add_argument("-no_drop_frames", action="store_true")
    p.add_argument("-multihost", action="store_true",
                   help="multi-host training (not ported yet: comes with the DDP slice)")
    p.add_argument("-debug_nans", action="store_true",
                   help="torch.autograd anomaly detection (sanitizer mode)")
    p.add_argument("-single_device", action="store_true",
                   help="accepted for the reference's CLI; the port runs on one device")
    p.add_argument("-log_interval", type=int, default=None)
    p.add_argument("-on_the_fly", action="store_true",
                   help="decode per-utterance denominator lattices with the "
                        "native decoder (reference train_se mode) instead of "
                        "the fixed denominator graph")
    p.add_argument("-den_hclg", default=None,
                   help="pdf-level decoding FST (text) for -on_the_fly; "
                        "default: phone-loop graph from the den phone LM")
    p.add_argument("-decoder", choices=["host", "device"], default="host",
                   help="-on_the_fly lattice generator: 'host' = native C++ "
                        "decoder fed by a device->host obs copy; 'device' comes "
                        "with the device-decoder slice")
    p.add_argument("-max_arcs", type=int, default=None,
                   help="-decoder device: lattice-link band width per frame")
    p.add_argument("-max_active", type=int, default=None,
                   help="decoder frontier cap (overrides trainer.max_active)")
    p.add_argument("-beam", type=float, default=None)
    p.add_argument("-lattice_beam", type=float, default=None)
    p.add_argument("-num_threads", type=int, default=4,
                   help="host decoder threads for -on_the_fly (one stateful "
                        "decoder handle per thread)")
    p.add_argument("-no_overlap", action="store_true",
                   help="disable the decode/train overlap in -on_the_fly: "
                        "lattices then use same-step params")
    p.add_argument("-obs_transfer", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="dtype of the device->host obs copy the -on_the_fly "
                        "decoder reads (bf16 halves the transfer; decode "
                        "beams dwarf the rounding)")
    p.add_argument("-generic_den", action="store_true",
                   help="fixed-denominator mode: pack the alignment-estimated den graph "
                        "with pack_graph_auto (dense, block-sparse or arc tables) instead "
                        "of the structured bigram kernels")
    p.add_argument("-silence_phones", default=None,
                   help="colon-separated silence phone ids (Kaldi "
                        "MpeVariants accuracy rules for smbr/mpfe; ignored "
                        "for mmi, as in Kaldi)")
    p.add_argument("-one_silence_class", action="store_true",
                   help="collapse all silence phones into one accuracy class")
    return p


def _build_tm_and_den(cfg, args, dataset, log):
    """TransitionModel + denominator graph + pdf→phone map."""
    if args.trans_model or cfg.data.trans_model:
        tm = TransitionModel.read_kaldi(args.trans_model or cfg.data.trans_model)
        log.info("loaded transition model: %d pdfs, %d tids", tm.num_pdfs, tm.num_tids)
    else:
        # standalone fallback: CI 1-state topology, phone i+1 <-> pdf i
        num_pdfs = 1 + max(int(np.max(l)) for l in dataset.labels.values())
        tm = TransitionModel(HmmTopology.one_state(range(1, num_pdfs + 1)))
        log.info("built CI 1-state transition model over %d pdfs", num_pdfs)
    pdf_to_phone = np.zeros(tm.num_pdfs, np.int32)
    for (p, _j, pdf) in tm.tuples:
        pdf_to_phone[pdf] = p
    if args.den_graph or cfg.trainer.den_graph:
        den = load_fsa(args.den_graph or cfg.trainer.den_graph)
        log.info("loaded den graph: %d states, %d arcs", den.num_states, den.num_arcs)
    else:
        seqs = [collapse_to_phones(pdf_to_phone[l]) for l in dataset.labels.values()]
        lm = estimate_phone_bigram(seqs, tm.topo.phones)
        den = make_den_graph(tm, lm)
        log.info("built den graph from alignments: %d states, %d arcs",
                 den.num_states, den.num_arcs)
    return tm, den, pdf_to_phone


def phone_loop_den_fst(tm: TransitionModel, lm: dict):
    """The pdf-level phone-loop denominator HCLG of ``-on_the_fly``: start →
    a junction per phone, bigram arcs between junctions, every junction final,
    expanded through the HMM topology (ilabel = pdf+1)."""
    from pykaldi2_tpu_torch.graph.compile import expand_to_pdf_fst
    from pykaldi2_tpu_torch.graph.fst import EPS, Fst

    f = Fst()
    start = f.add_state()
    f.set_start(start)
    junction = {p: f.add_state() for p in tm.topo.phones}
    for p in tm.topo.phones:
        if np.isfinite(lm["log_init"][p]):
            f.add_arc(start, p, EPS, float(lm["log_init"][p]), junction[p])
        for q in tm.topo.phones:
            if np.isfinite(lm["log_bigram"][p, q]):
                f.add_arc(junction[p], q, EPS, float(lm["log_bigram"][p, q]), junction[q])
        f.set_final(junction[p], float(lm["log_final"][p]))
    return expand_to_pdf_fst(f, tm)


def main(argv=None, device: Optional[str] = None):
    args = build_argparser().parse_args(argv)
    if args.multihost:
        raise NotImplementedError("-multihost comes with the DDP slice (ROADMAP.md Queue 1)")
    if args.on_the_fly and args.decoder == "device":
        raise NotImplementedError(
            "-decoder device (the batched beam search on the GPU) comes with the "
            "device-decoder slice (ROADMAP.md Queue 1)")
    dev = resolve_device(device)
    cfg = load_config(args.config)
    if args.data:
        cfg.data = load_data_config(args.data)
    if cfg.trainer.mesh_shape:
        raise NotImplementedError(
            "trainer.mesh_shape (data/model parallel meshes) comes with the DDP slice")
    if cfg.optimizer.grad_compression != "none":
        raise NotImplementedError("gradient compression comes with the DDP slice")
    if args.lr is not None:
        cfg.optimizer.lr = args.lr
    for name in ("batch_size", "num_epochs", "log_interval"):
        if getattr(args, name) is not None:
            setattr(cfg.trainer, name, getattr(args, name))
    for name in ("criterion", "acoustic_scale", "den_scale", "ce_ratio"):
        if getattr(args, name) is not None:
            setattr(cfg.trainer, name, getattr(args, name))
    if args.no_drop_frames:
        cfg.trainer.drop_frames = False
    if args.silence_phones is not None:
        cfg.trainer.silence_phones = tuple(
            int(x) for x in args.silence_phones.split(":") if x)
    if args.one_silence_class:
        cfg.trainer.one_silence_class = True
    cfg.trainer.exp_dir = args.exp_dir
    torch.autograd.set_detect_anomaly(args.debug_nans)

    log = setup_logging(args.exp_dir)
    metrics_log = MetricsLogger(args.exp_dir)
    log.info("device: %s%s", dev,
             f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
    dataset, feat_fn, extras_fn = build_frontend(cfg.data)
    if dataset.labels is None:
        raise SystemExit("train_se requires alignments (label_ark)")
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model, generator=torch.Generator().manual_seed(cfg.trainer.seed))
    model = model.to(dev)
    optimizer = make_optimizer(cfg.optimizer, model.parameters())

    tm, den, pdf_to_phone = _build_tm_and_den(cfg, args, dataset, log)
    if cfg.model.output_size < tm.num_pdfs:
        raise SystemExit(f"model output {cfg.model.output_size} < num pdfs {tm.num_pdfs}")
    crit = {"mpe": "mpfe"}.get(cfg.trainer.criterion, cfg.trainer.criterion)
    silence = None
    if cfg.trainer.silence_phones:
        from pykaldi2_tpu_torch.ops.fb import make_silence_opts

        unknown = [p for p in cfg.trainer.silence_phones if p not in set(tm.topo.phones)]
        if unknown:
            raise SystemExit(f"silence_phones {unknown} not in the "
                             f"transition model's phone set")
        silence = make_silence_opts(tm, cfg.trainer.silence_phones,
                                    cfg.trainer.one_silence_class)
        if crit == "mmi":
            log.warning("silence_phones is ignored for mmi (Kaldi "
                        "LatticeForwardBackwardMmi has no silence handling)")
        else:
            log.info("silence phones %s (one_silence_class=%s)",
                     sorted(cfg.trainer.silence_phones), cfg.trainer.one_silence_class)

    if args.prior_path or cfg.trainer.prior_path:
        log_prior = np.load(args.prior_path or cfg.trainer.prior_path)
    else:
        counts = count_labels(dataset.labels.values(), cfg.model.output_size)
        log_prior = priors_from_counts(counts)
        log.info("estimated priors from alignments")

    start_epoch = 0
    resume_meta = {}
    resume = args.resume_from_model or latest_checkpoint(args.exp_dir)
    if resume:
        resume_meta = load_checkpoint(resume, model, optimizer)
        start_epoch = int(resume_meta.get("epoch", -1)) + 1
        log.info("resumed from %s (epoch %d)", resume, start_epoch)
    elif args.seed_model or cfg.trainer.seed_model:
        load_checkpoint(args.seed_model or cfg.trainer.seed_model, model)
        log.info("seeded from CE model %s", args.seed_model or cfg.trainer.seed_model)
    else:
        log.warning("no seed model — SE training from random init is unusual")

    if args.on_the_fly:
        return _run_on_the_fly(args, cfg, log, metrics_log, dataset, feat_fn, model, optimizer,
                               tm, pdf_to_phone, log_prior, start_epoch, dev,
                               resume_meta=resume_meta, crit=crit, extras_fn=extras_fn,
                               silence=silence)
    den_packed = pack_denominator(args, cfg, log, dataset, tm, den, pdf_to_phone, crit)
    return _run_fixed(args, cfg, log, metrics_log, dataset, feat_fn, model, optimizer,
                      den_packed, pdf_to_phone, log_prior, start_epoch, dev,
                      resume_meta=resume_meta, crit=crit, extras_fn=extras_fn, silence=silence)


def pack_denominator(args, cfg, log, dataset, tm, den, pdf_to_phone, crit: str):
    """The fixed denominator's packing (route), as the reference picks it:
    without ``-den_graph`` and ``-generic_den``, the structured bigram graph
    of the alignment phone LM; otherwise ``pack_graph_auto`` on ``den`` (dense,
    block-sparse or arc tables), with the arc tables for MPFE when a dense
    packing has no phone labels."""
    from pykaldi2_tpu_torch.ops import fb_dense
    from pykaldi2_tpu_torch.ops.fb import pack_graph

    if not args.generic_den and not (args.den_graph or cfg.trainer.den_graph):
        from pykaldi2_tpu_torch.ops.fb_bigram import make_bigram_den

        try:
            seqs = [collapse_to_phones(pdf_to_phone[l]) for l in dataset.labels.values()]
            packed = make_bigram_den(tm, estimate_phone_bigram(seqs, tm.topo.phones),
                                     num_pdfs=cfg.model.output_size)
            log.info("using structured bigram den kernels (%d phones x %d states)",
                     *packed.pdf.shape)
            return packed
        except ValueError as e:
            log.warning("structured den unavailable (%s); using generic kernels", e)
    packed = fb_dense.pack_graph_auto(den, num_pdfs=cfg.model.output_size)
    if (crit == "mpfe" and isinstance(packed, fb_dense.DenseStateGraph)
            and packed.state_phone is None):
        packed = pack_graph(den)  # needs per-arc phones
    log.info("generic den graph packed as %s (%d states, %d arcs)", type(packed).__name__,
             den.num_states, den.num_arcs)
    return packed


def _run_fixed(args, cfg, log, metrics_log, dataset, feat_fn, model, optimizer, den_packed,
               pdf_to_phone, log_prior, start_epoch, dev, resume_meta=None, crit="mmi",
               extras_fn=None, silence=None):
    """Fixed-denominator epochs: SeqDataloader buckets, one train step per
    batch, the plateau annealer, a checkpoint and ``metrics.jsonl`` lines
    per epoch. Each logged step also records ``train_ms`` (CUDA events; the
    host clock on the CPU) and the batch's padded frame count ``t_len``."""
    from pykaldi2_tpu_torch.trainer import make_se_train_step

    step = make_se_train_step(
        model, feat_fn, optimizer, den_packed, crit, log_prior=log_prior,
        acoustic_scale=cfg.trainer.acoustic_scale, den_scale=cfg.trainer.den_scale,
        drop_frames=cfg.trainer.drop_frames, ce_ratio=cfg.trainer.ce_ratio,
        pdf_to_phone=pdf_to_phone, silence=silence)
    annealer = PlateauAnnealer(cfg.optimizer.anneal_factor, cfg.optimizer.anneal_patience)
    annealer.restore_from_checkpoint(resume_meta, optimizer)
    bucket = BucketSpec(boundaries=tuple(cfg.trainer.bucket_boundaries),
                        batch_sizes=cfg.trainer.batch_size)
    gen = torch.Generator(device=dev).manual_seed(cfg.trainer.seed + 1)
    step_no = 0
    try:
        for epoch in range(start_epoch, cfg.trainer.num_epochs):
            loader = SeqDataloader(dataset, bucket, shuffle=cfg.data.shuffle,
                                   seed=cfg.trainer.seed, num_workers=cfg.data.num_workers,
                                   extras_fn=extras_fn)
            loader.set_epoch(epoch)
            tp = Throughput()
            # device-scalar accumulation: reading a value per step would make
            # the host wait for the device
            ep_obj = torch.zeros((), device=dev)
            ep_frames = torch.zeros((), device=dev)
            synced_frames = 0.0
            for batch in device_prefetch(equalized_steps(loader, iter(loader)), dev):
                utt_ids = batch.pop("utt_ids")
                start = _mark(dev)
                m = step(batch, gen)
                end = _mark(dev)
                step_no += 1
                ep_obj += m["objective"] * m["frames"]
                ep_frames += m["frames"]
                tp.update(len(utt_ids), 0.0)
                if step_no % cfg.trainer.log_interval == 0:
                    gf = float(ep_frames)
                    tp.update(0, gf - synced_frames)
                    synced_frames = gf
                    u_s, f_s = tp.rates()
                    obj, acc = float(m["objective"]), float(m["frame_acc"])
                    train_ms, t_len = _ms(start, end), int(batch["labels"].shape[1])
                    log.info("epoch %d step %d %s %.4f acc %.4f | %.1f utt/s %.0f frames/s | "
                             "T %d train_ms %.1f", epoch, step_no, crit, obj, acc, u_s, f_s,
                             t_len, train_ms)
                    metrics_log.log(epoch=epoch, step=step_no, objective=obj, frame_acc=acc,
                                    utt_per_sec=u_s, frames_per_sec=f_s, train_ms=train_ms,
                                    t_len=t_len)
            _end_epoch(args, log, metrics_log, model, optimizer, annealer, epoch, crit,
                       ep_obj, ep_frames)
    finally:
        metrics_log.close()
    return 0


def _end_epoch(args, log, metrics_log, model, optimizer, annealer, epoch: int, what: str,
               ep_obj, ep_frames) -> None:
    """The epoch's objective per frame → the plateau annealer's lr scale, a
    checkpoint and a ``metrics.jsonl`` line."""
    ep = float(ep_obj) / max(float(ep_frames), 1.0)
    scale = annealer.step(-ep)  # objective is maximized
    set_lr_scale(optimizer, scale)
    ckpt = os.path.join(args.exp_dir, f"model.{epoch}.npz")
    save_checkpoint(ckpt, model, optimizer, {"epoch": epoch, "objective": ep, "lr_scale": scale,
                                             "anneal": annealer.state()})
    log.info("epoch %d done: %s objective %.4f → %s", epoch, what, ep, ckpt)
    metrics_log.log(epoch=epoch, epoch_objective=ep, lr_scale=scale)


def equalized_steps(loader, batch_iter):
    """Single-process form of pykaldi2_tpu/parallel/mesh.py:equalized_steps:
    one process runs every batch, so the iterator passes through. Truncating
    to the smallest per-process batch count comes with the DDP slice."""
    return batch_iter


def _mark(dev: torch.device):
    """A point in time on the device's stream (CUDA event) or the host clock."""
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(start, end) -> float:
    if isinstance(start, float):
        return (end - start) * 1e3
    end.synchronize()
    return start.elapsed_time(end)


def decode_batch(decoders, pool: ThreadPoolExecutor, obs: np.ndarray, nf: np.ndarray):
    """Decode one denominator lattice per utterance of ``obs`` [B, T, P]
    (scaled log-likelihoods, fp32) on the host, ``decoders[i]`` on pool
    thread i, and pack them into frame bands. Returns (TimeSyncLattice of
    CPU tensors, decode ms, pack ms). Rows with ``nf == 0`` get a one-frame
    dummy chain."""
    from pykaldi2_tpu_torch.ops.fb_lattice import pack_time_sync
    from pykaldi2_tpu_torch.ops.fsa import linear_chain_fsa

    n_threads = len(decoders)
    t0 = time.perf_counter()
    lats = [None] * obs.shape[0]

    def shard(t):
        dec = decoders[t]
        for i in range(t, obs.shape[0], n_threads):
            if nf[i] == 0:
                lats[i] = (linear_chain_fsa(np.zeros(1, np.int32)), np.array([0, 1], np.int32))
            else:
                fsa, frames, _score = dec.decode_lattice(obs[i, : nf[i]], with_frames=True)
                lats[i] = (fsa, frames)

    list(pool.map(shard, range(n_threads)))
    t1 = time.perf_counter()
    lat = pack_time_sync(lats, t_pad=obs.shape[1])
    return lat, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def _run_on_the_fly(args, cfg, log, metrics_log, dataset, feat_fn, model, optimizer,
                    tm, pdf_to_phone, log_prior, start_epoch, dev, resume_meta=None,
                    crit="mmi", extras_fn=None, silence=None):
    """Reference train_se semantics: per-utterance denominator lattices
    decoded on the host per batch, forward-backward on the device.

    One-deep pipeline, as in the reference: batch N+1's eval forward and its
    device→host copy run on the main thread BEFORE step N's update, then the
    host decode of N+1 runs on a thread pool (ctypes releases the GIL in the
    C++ search) while the device trains on N. Lattices therefore use
    one-step-stale parameters, exactly the reference's staleness; the
    optimizer updates parameters in place, so no forward may run off the
    main thread. -no_overlap decodes strictly in-step.

    Each logged step also records its time split: ``forward_ms`` and
    ``train_ms`` on the device (CUDA events; host clock on the CPU),
    ``decode_ms`` and ``pack_ms`` on the decode thread, ``wait_ms`` the main
    thread's wait for the lattices, and the packed band's ``lat_k`` and
    ``lat_a``.
    """
    from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder
    from pykaldi2_tpu_torch.graph.fst import Fst
    from pykaldi2_tpu_torch.ops.fb_lattice import set_den_pdf_ids
    from pykaldi2_tpu_torch.trainer import make_se_lattice_steps

    if args.den_hclg:
        den_fst = Fst.read_text(args.den_hclg)
    else:
        seqs = [collapse_to_phones(pdf_to_phone[l]) for l in dataset.labels.values()]
        den_fst = phone_loop_den_fst(tm, estimate_phone_bigram(seqs, tm.topo.phones))
    set_den_pdf_ids([a.ilabel - 1 for s_arcs in den_fst.arcs
                     for a in s_arcs if a.ilabel > 0] or [0])
    beam = args.beam if args.beam is not None else cfg.trainer.beam
    max_active = args.max_active if args.max_active is not None else cfg.trainer.max_active
    lat_beam = args.lattice_beam if args.lattice_beam is not None else cfg.trainer.lattice_beam
    n_threads = max(int(args.num_threads or 4), 1)
    decoders = [LatticeDecoder(den_fst, beam=beam, max_active=max_active,
                               lattice_beam=lat_beam) for _ in range(n_threads)]
    log.info("on-the-fly den decoding: graph %d states %d arcs, beam %.1f "
             "lat_beam %.1f max_active %d, %d decode threads, overlap=%s",
             den_fst.num_states, den_fst.num_arcs, beam, lat_beam, max_active, n_threads,
             not args.no_overlap)

    forward_fn, train_fn = make_se_lattice_steps(
        model, feat_fn, optimizer,
        log_prior=log_prior, acoustic_scale=cfg.trainer.acoustic_scale,
        den_scale=cfg.trainer.den_scale, drop_frames=cfg.trainer.drop_frames,
        ce_ratio=cfg.trainer.ce_ratio, criterion=crit,
        pdf_to_phone=pdf_to_phone, silence=silence, obs_transfer_dtype=args.obs_transfer)
    annealer = PlateauAnnealer(cfg.optimizer.anneal_factor, cfg.optimizer.anneal_patience)
    annealer.restore_from_checkpoint(resume_meta, optimizer)
    bucket = BucketSpec(boundaries=tuple(cfg.trainer.bucket_boundaries),
                        batch_sizes=cfg.trainer.batch_size)
    utt_pool = ThreadPoolExecutor(max_workers=n_threads)
    pipe_pool = ThreadPoolExecutor(max_workers=1)
    gen = torch.Generator(device=dev).manual_seed(cfg.trainer.seed + 1)

    def submit(batch):
        """Forward on the main thread with the current parameters, then the
        decode on the pipeline thread."""
        start = _mark(dev)
        obs = forward_fn(batch)
        end = _mark(dev)
        # the copy is bf16 by default (half the bytes); the C++ decoder wants
        # fp32 rows — upcast on the host
        obs_np = obs.cpu().float().numpy()
        nf = batch["num_frames"].cpu().numpy()
        # supervised frames for the throughput log, read while the stream is
        # drained anyway
        sup = float((batch["mask"] * (batch["labels"] >= 0)).sum())
        return (pipe_pool.submit(decode_batch, decoders, utt_pool, obs_np, nf), (start, end),
                sup)

    step_no = 0
    try:
        for epoch in range(start_epoch, cfg.trainer.num_epochs):
            loader = SeqDataloader(dataset, bucket, shuffle=cfg.data.shuffle,
                                   seed=cfg.trainer.seed, num_workers=cfg.data.num_workers,
                                   extras_fn=extras_fn)
            loader.set_epoch(epoch)
            tp = Throughput()
            ep_obj = torch.zeros((), device=dev)
            ep_frames = torch.zeros((), device=dev)

            def run_step(item):
                nonlocal step_no, ep_obj, ep_frames
                utt_ids, batch, fut, fwd, sup = item
                t0 = time.perf_counter()
                lat, decode_ms, pack_ms = fut.result()
                wait_ms = (time.perf_counter() - t0) * 1e3
                lat_k, lat_a = lat.num_slots, lat.src.shape[2]
                start = _mark(dev)
                m = train_fn(batch, lat.to(dev), gen)
                end = _mark(dev)
                step_no += 1
                # device-scalar accumulation: reading a value per step would
                # make the host wait for the device
                ep_obj += m["objective"] * m["frames"]
                ep_frames += m["frames"]
                tp.update(len(utt_ids), sup)
                if step_no % cfg.trainer.log_interval == 0:
                    u_s, f_s = tp.rates()
                    obj, acc = float(m["objective"]), float(m["frame_acc"])
                    times = {"forward_ms": _ms(*fwd), "train_ms": _ms(start, end),
                             "decode_ms": decode_ms, "pack_ms": pack_ms, "wait_ms": wait_ms}
                    log.info("epoch %d step %d %s(lat) %.4f acc %.4f | %.1f utt/s %.0f "
                             "frames/s | K %d A %d | %s", epoch, step_no, crit, obj, acc,
                             u_s, f_s, lat_k, lat_a,
                             " ".join(f"{k} {v:.1f}" for k, v in times.items()))
                    metrics_log.log(epoch=epoch, step=step_no, objective=obj, frame_acc=acc,
                                    utt_per_sec=u_s, frames_per_sec=f_s, lat_k=lat_k,
                                    lat_a=lat_a, **times)

            pending = None  # one-deep pipeline: decode N+1 while training on N
            for batch in device_prefetch(equalized_steps(loader, iter(loader)), dev):
                utt_ids = batch.pop("utt_ids")
                item = (utt_ids, batch, *submit(batch))
                if args.no_overlap:
                    run_step(item)
                else:
                    if pending is not None:
                        run_step(pending)
                    pending = item
            if pending is not None:
                run_step(pending)
            _end_epoch(args, log, metrics_log, model, optimizer, annealer, epoch,
                       f"{crit}(lat)", ep_obj, ep_frames)
    finally:
        utt_pool.shutdown()
        pipe_pool.shutdown()
        metrics_log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
