"""Frame cross-entropy trainer entry point (PyTorch port).

Same CLI as pykaldi2_tpu/bin/train_ce.py (reference behavior:
pykaldi2/bin/train_ce.py):

    python -m pykaldi2_tpu_torch.bin.train_ce -config exp.yaml -data data.yaml \\
        -exp_dir exp/ce [-lr ...] [-batch_size ...]

Runs on one CUDA device unless ``PK2_PLATFORM=cpu`` (or ``main(..., device=
"cpu")``) asks for the CPU. Writes ``metrics.jsonl``, ``train.log`` and one
``model.<epoch>.npz`` checkpoint per epoch, in the JAX package's format.
Multi-host and mesh options come with the DDP slice and raise until then.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from pykaldi2_tpu_torch.config import load_config, load_data_config
from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.data.prefetch import device_prefetch
from pykaldi2_tpu_torch.device import resolve_device
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.pipeline import build_frontend
from pykaldi2_tpu_torch.trainer import Throughput, make_ce_train_step, make_eval_step
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

PROFILE_START, PROFILE_STEPS = 2, 20


def build_argparser():
    p = argparse.ArgumentParser(description="frame-CE acoustic model training")
    p.add_argument("-config", default=None, help="model/optimizer/trainer YAML")
    p.add_argument("-data", default=None, help="corpus/simulation YAML")
    p.add_argument("-cv_data", default=None,
                   help="held-out corpus YAML; per-epoch CV loss drives LR "
                        "annealing (reference behavior) instead of train loss")
    p.add_argument("-exp_dir", required=True)
    p.add_argument("-lr", type=float, default=None)
    p.add_argument("-batch_size", type=int, default=None)
    p.add_argument("-num_epochs", type=int, default=None)
    p.add_argument("-sweep_size", type=float, default=None)
    p.add_argument("-seed_model", default=None, help="warm-start params only")
    p.add_argument("-resume_from_model", default=None, help="resume params+optimizer")
    p.add_argument("-dropout", type=float, default=None)
    p.add_argument("-log_interval", type=int, default=None)
    p.add_argument("-multihost", action="store_true",
                   help="multi-host training (not ported yet: comes with the DDP slice)")
    p.add_argument("-debug_nans", action="store_true",
                   help="torch.autograd anomaly detection (sanitizer mode)")
    p.add_argument("-single_device", action="store_true",
                   help="accepted for the reference's CLI; the port runs on one device")
    p.add_argument("-profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of steps "
                        f"{PROFILE_START}..{PROFILE_START + PROFILE_STEPS} into DIR")
    return p


def _profiler(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def main(argv=None, device: Optional[str] = None):
    args = build_argparser().parse_args(argv)
    if args.multihost:
        raise NotImplementedError("-multihost comes with the DDP slice (ROADMAP.md Queue 1)")
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
    for name in ("batch_size", "num_epochs", "sweep_size", "log_interval"):
        if getattr(args, name) is not None:
            setattr(cfg.trainer, name, getattr(args, name))
    if args.dropout is not None:
        cfg.model.dropout = args.dropout
    cfg.trainer.exp_dir = args.exp_dir
    torch.autograd.set_detect_anomaly(args.debug_nans)

    log = setup_logging(args.exp_dir)
    metrics_log = MetricsLogger(args.exp_dir)
    log.info("device: %s%s", dev,
             f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")

    dataset, feat_fn, extras_fn = build_frontend(cfg.data)
    cv_dataset = None
    if args.cv_data:
        cv_cfg = load_data_config(args.cv_data)
        cv_cfg.feat = cfg.data.feat  # same features as training
        cv_cfg.simulation.enabled = False
        cv_dataset = SpeechDataset.from_config(cv_cfg)
    cfg.model.input_size = feat_fn.dim
    init_gen = torch.Generator().manual_seed(cfg.trainer.seed)
    model = build_model(cfg.model, generator=init_gen).to(dev)
    optimizer = make_optimizer(cfg.optimizer, model.parameters())
    start_epoch = 0
    resume_meta = {}

    resume = args.resume_from_model or latest_checkpoint(args.exp_dir)
    if resume:
        resume_meta = load_checkpoint(resume, model, optimizer)
        start_epoch = int(resume_meta.get("epoch", -1)) + 1
        log.info("resumed from %s (epoch %d)", resume, start_epoch)
    elif args.seed_model:
        load_checkpoint(args.seed_model, model)
        log.info("seeded params from %s", args.seed_model)

    train_step = make_ce_train_step(model, feat_fn, optimizer)
    eval_step = make_eval_step(model, feat_fn) if cv_dataset is not None else None
    annealer = PlateauAnnealer(cfg.optimizer.anneal_factor, cfg.optimizer.anneal_patience)
    annealer.restore_from_checkpoint(resume_meta, optimizer)

    num_params = sum(p.numel() for p in model.parameters())
    log.info("model: %s input=%d params=%.2fM output=%d",
             cfg.model.type, feat_fn.dim, num_params / 1e6, cfg.model.output_size)

    # dither and dropout draw from one device generator, seeded per run
    gen = torch.Generator(device=dev).manual_seed(cfg.trainer.seed + 1)
    profiler = None
    step_no = 0
    for epoch in range(start_epoch, cfg.trainer.num_epochs):
        sweep_world = max(int(round(1.0 / max(cfg.trainer.sweep_size, 1e-6))), 1)
        loader = ChunkDataloader(
            dataset, cfg.trainer.batch_size, cfg.trainer.chunk_len,
            # sweep_size < 1 visits a rotating 1/sweep_size slice per epoch
            rank=epoch % sweep_world, world_size=sweep_world,
            shuffle=cfg.data.shuffle, seed=cfg.trainer.seed,
            num_workers=cfg.data.num_workers,
            extras_fn=extras_fn, chunk_overlap=cfg.trainer.chunk_overlap,
        )
        loader.set_epoch(epoch)
        tp = Throughput()
        ep_nll = torch.zeros((), device=dev)
        ep_frames = torch.zeros((), device=dev)
        synced_frames = 0.0
        for batch in device_prefetch(loader, dev):
            if args.profile and step_no == PROFILE_START and profiler is None:
                profiler = _profiler(dev)
                profiler.__enter__()
            m = train_step(batch, gen)
            step_no += 1
            if profiler is not None and step_no == PROFILE_START + PROFILE_STEPS:
                _close_profiler(profiler, args.profile, dev, log)
                profiler = None
            # device-scalar accumulation: reading a value per step would make
            # the host wait for the device and drain the prefetch run-ahead
            ep_nll += m["loss"] * m["frames"]
            ep_frames += m["frames"]
            tp.update(cfg.trainer.batch_size, 0.0)
            if step_no % cfg.trainer.log_interval == 0:
                gf = float(ep_frames)
                tp.update(0, gf - synced_frames)
                synced_frames = gf
                u_s, f_s = tp.rates()
                loss, acc = float(m["loss"]), float(m["frame_acc"])
                log.info("epoch %d step %d loss %.4f acc %.4f | %.1f utt/s %.0f frames/s",
                         epoch, step_no, loss, acc, u_s, f_s)
                metrics_log.log(epoch=epoch, step=step_no, loss=loss, frame_acc=acc,
                                utt_per_sec=u_s, frames_per_sec=f_s)
        if profiler is not None:
            _close_profiler(profiler, args.profile, dev, log)
            profiler = None
        ep_loss = float(ep_nll) / max(float(ep_frames), 1.0)
        anneal_loss = ep_loss
        if eval_step is not None:
            cv_nll = cv_frames = 0.0
            cv_loader = ChunkDataloader(
                cv_dataset, cfg.trainer.batch_size, cfg.trainer.chunk_len, shuffle=False,
                extras_fn=feat_fn.batch_extras if feat_fn.has_extras else None,
                chunk_overlap=cfg.trainer.chunk_overlap)
            for cb in device_prefetch(cv_loader, dev):
                nll, cnt, _cor = eval_step(cb)
                cv_nll += float(nll)
                cv_frames += float(cnt)
            anneal_loss = cv_nll / max(cv_frames, 1.0)
            log.info("epoch %d cv loss %.4f", epoch, anneal_loss)
            metrics_log.log(epoch=epoch, cv_loss=anneal_loss)
        scale = annealer.step(anneal_loss)
        set_lr_scale(optimizer, scale)
        ckpt = os.path.join(args.exp_dir, f"model.{epoch}.npz")
        save_checkpoint(ckpt, model, optimizer,
                        {"epoch": epoch, "loss": ep_loss, "lr_scale": scale,
                         "anneal": annealer.state()})
        log.info("epoch %d done: loss %.4f lr_scale %.3g → %s", epoch, ep_loss, scale, ckpt)
        metrics_log.log(epoch=epoch, epoch_loss=ep_loss, lr_scale=scale)
    metrics_log.close()
    return 0


def _close_profiler(profiler, trace_dir: str, dev: torch.device, log) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    profiler.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    profiler.export_chrome_trace(path)
    sort = "device_time_total" if dev.type == "cuda" else "cpu_time_total"
    log.info("profile (sorted by %s):\n%s", sort,
             profiler.key_averages().table(sort_by=sort, row_limit=25))
    log.info("profiler trace written to %s", path)


if __name__ == "__main__":
    raise SystemExit(main())
