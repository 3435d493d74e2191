"""Train steps: CE, sequence training over a fixed denominator graph and
over decoded lattices; the eval step; throughput.

Port of pykaldi2_tpu/trainer.py (reference behavior: pykaldi2/bin/
train_ce.py's and train_se.py's hot loops — forward, loss, backward,
clipped SGD/Adam step, loss/frame-acc logging). One step runs front end →
model → loss → backward → optimizer update on the batch's device. Losses
are normalized by the supervised frame count, so padding contributes
exactly nothing. Data parallelism (the JAX mesh, bf16 gradient
compression) comes with the DDP slice.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from pykaldi2_tpu_torch.models.nnet_am import NnetAM
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.utils.lr import Optimizer

Tensor = torch.Tensor


def ce_forward(model: NnetAM, feat_fn: FeaturePipeline, batch: dict,
               generator: Optional[torch.Generator], train: bool
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (sum_nll, count, correct) as device scalars.

    ``mask`` is frame validity (feeds the model); supervision is mask AND
    labels >= 0 — they differ when labels are absent. Dither and dropout
    draw, in that order, from ``generator``."""
    feats = feat_fn(batch, generator=generator)
    mask = batch["mask"].to(torch.float32)
    logits = model(feats, mask, train=train, generator=generator)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = batch["labels"].long()
    sup = mask * (labels >= 0)
    ll = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
    sum_nll = -torch.sum(ll * sup)
    count = torch.sum(sup)
    correct = torch.sum((torch.argmax(logits, -1) == labels) * sup)
    return sum_nll, count, correct


def make_ce_train_step(model: NnetAM, feat_fn: FeaturePipeline,
                       optimizer: Optimizer) -> Callable:
    """Build step(batch, generator) → metrics dict(loss, frame_acc, frames) of
    device scalars; the model's parameters and the optimizer state update in
    place."""

    def step(batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        optimizer.zero_grad()
        sum_nll, count, correct = ce_forward(model, feat_fn, batch, generator, True)
        denom = torch.clamp(count, min=1.0)
        (sum_nll / denom).backward()
        optimizer.step()
        with torch.no_grad():
            return {"loss": sum_nll.detach() / denom, "frame_acc": correct / denom,
                    "frames": count}

    return step


def _se_setup(model: NnetAM, criterion: str, log_prior, pdf_to_phone, silence):
    """Checks and device copies shared by the SE steps: (criterion, device,
    log-prior, pdf→phone map, silence tables)."""
    crit = {"mpe": "mpfe"}.get(criterion, criterion)
    if crit not in ("mmi", "smbr", "mpfe"):
        raise ValueError(f"unknown criterion {criterion!r}")
    if crit == "mpfe" and pdf_to_phone is None:
        raise ValueError("mpfe needs a pdf_to_phone mapping")
    dev = next(model.parameters()).device
    lp = None if log_prior is None else torch.as_tensor(log_prior, dtype=torch.float32,
                                                        device=dev)
    p2p = None if pdf_to_phone is None else torch.as_tensor(pdf_to_phone, device=dev).long()
    sil = None if silence is None else silence.to(dev)
    return crit, dev, lp, p2p, sil


def _se_update(optimizer: Optimizer, logits: Tensor, obj_rows: Tensor, labels: Tensor,
               sup: Tensor, nf: Tensor, ce_ratio: float) -> dict:
    """The SE step's tail: −objective per supervised frame (+ ce_ratio × CE,
    f-smoothing), backward, optimizer step; → metrics dict(objective,
    frame_acc, frames, ce) of device scalars."""
    # zero-length padded rows would contribute num − logZ(dead) ≈ +1e30
    obj = torch.sum(torch.where(nf > 0, obj_rows, torch.zeros_like(obj_rows)))
    count = torch.sum(sup)
    denom = torch.clamp(count, min=1.0)
    loss = -obj / denom
    sum_nll = torch.zeros((), device=logits.device)
    if ce_ratio > 0.0:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
        sum_nll = -torch.sum(ll * sup)
        loss = loss + ce_ratio * sum_nll / denom
    loss.backward()
    optimizer.step()
    with torch.no_grad():
        correct = torch.sum((torch.argmax(logits, -1) == labels) * sup)
        return {"objective": obj.detach() / denom, "frame_acc": correct / denom,
                "frames": count, "ce": sum_nll.detach() / denom}


def make_se_train_step(
    model: NnetAM,
    feat_fn: FeaturePipeline,
    optimizer: Optimizer,
    den_graph,
    criterion: str = "mmi",
    log_prior=None,
    acoustic_scale: float = 0.1,
    den_scale: float = 1.0,
    drop_frames: bool = True,
    ce_ratio: float = 0.0,
    pdf_to_phone=None,
    silence=None,
) -> Callable:
    """Sequence-discriminative train step over a fixed denominator graph
    (reference train_se hot loop). Port of pykaldi2_tpu/trainer.py:129-245 on
    one device.

    step(batch, generator) → metrics dict(objective, frame_acc, frames, ce)
    of device scalars; parameters and optimizer state update in place.
    batch needs wave|feats, labels (pdf alignment), mask, num_frames.
    ``den_graph`` is any of the four packings (ops/se_losses.py), moved to
    the model's device here. criterion: mmi | smbr | mpfe (mpe); ce_ratio
    adds f-smoothing CE; ``silence`` applies Kaldi's MpeVariants silence
    rules to the sMBR/MPE accuracies (ignored for MMI, as in Kaldi).
    """
    from pykaldi2_tpu_torch.ops.se_losses import (acoustic_scores, graph_expected_accuracy,
                                                  mmi_objective)

    crit, dev, lp, p2p, sil = _se_setup(model, criterion, log_prior, pdf_to_phone, silence)
    den = den_graph.to(dev)

    def step(batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        optimizer.zero_grad()
        mask = batch["mask"].to(torch.float32)
        nf = batch["num_frames"]
        labels = batch["labels"].long()
        feats = feat_fn(batch, generator=generator)
        logits = model(feats, mask, train=True, generator=generator)
        obs = acoustic_scores(logits, lp, acoustic_scale)
        sup = mask * (labels >= 0)
        if crit == "mmi":
            obj_rows = mmi_objective(obs, labels, den, nf, sup, drop_frames, den_scale)
        else:
            ref, level = labels, "pdf"
            if crit == "mpfe":
                ref, level = p2p[torch.clamp(labels, min=0)], "phone"
            obj_rows = graph_expected_accuracy(obs, den, torch.clamp(ref, min=0), nf, level,
                                               sil)
        return _se_update(optimizer, logits, obj_rows, labels, sup, nf, ce_ratio)

    return step


def make_se_lattice_steps(
    model: NnetAM,
    feat_fn: FeaturePipeline,
    optimizer: Optimizer,
    log_prior=None,
    acoustic_scale: float = 0.1,
    den_scale: float = 1.0,
    drop_frames: bool = True,
    ce_ratio: float = 0.0,
    criterion: str = "mmi",
    pdf_to_phone=None,
    silence=None,
    obs_transfer_dtype: str = "bfloat16",
) -> Tuple[Callable, Callable]:
    """On-the-fly denominator-lattice training (the reference's signature
    mode): returns (forward_fn, train_fn). Port of pykaldi2_tpu/trainer.py:
    248-377 on one device.

    forward_fn(batch) → scaled obs [B, T, P] in ``obs_transfer_dtype`` (the
    host decodes lattices from it): the eval pipeline (no dither, no
    dropout), without gradients. "bfloat16" halves the device→host copy;
    the loss-side forward recomputes obs in fp32, so training math is
    unaffected.

    train_fn(batch, lattice, generator) → metrics dict(objective, frame_acc,
    frames, ce) of device scalars; applies the lattice update in place,
    recomputing the forward with dither and dropout. ``lattice`` is a
    TimeSyncLattice on the batch's device. criterion: mmi (num alignment −
    lattice logZ) or smbr/mpfe (expected frame accuracy over the decoded
    lattice, Kaldi LatticeForwardBackwardMpeVariants semantics); ce_ratio
    adds the CE f-smoothing term.
    """
    from pykaldi2_tpu_torch.ops.fb_lattice import (lattice_expected_accuracy_ts,
                                                   mmi_objective_lattice_ts)
    from pykaldi2_tpu_torch.ops.se_losses import acoustic_scores

    crit, _dev, lp, p2p, sil = _se_setup(model, criterion, log_prior, pdf_to_phone, silence)
    out_dtype = getattr(torch, obs_transfer_dtype)
    eval_feat_fn = feat_fn.for_eval()

    @torch.no_grad()
    def forward_fn(batch: dict) -> Tensor:
        logits = model(eval_feat_fn(batch), batch["mask"])
        return acoustic_scores(logits, lp, acoustic_scale).to(out_dtype)

    def train_fn(batch: dict, lattice, generator: Optional[torch.Generator] = None) -> dict:
        optimizer.zero_grad()
        mask = batch["mask"].to(torch.float32)
        nf = batch["num_frames"]
        labels = batch["labels"].long()
        feats = feat_fn(batch, generator=generator)
        logits = model(feats, mask, train=True, generator=generator)
        obs = acoustic_scores(logits, lp, acoustic_scale)
        sup = mask * (labels >= 0)
        if crit == "mmi":
            obj_rows = mmi_objective_lattice_ts(obs, labels, lattice, nf, sup,
                                                drop_frames, den_scale)
        else:
            ref, level = labels, "pdf"
            if crit == "mpfe":
                ref, level = p2p[torch.clamp(labels, min=0)], "phone"
            obj_rows = lattice_expected_accuracy_ts(obs, lattice, torch.clamp(ref, min=0),
                                                    nf, level, p2p, sil)
        return _se_update(optimizer, logits, obj_rows, labels, sup, nf, ce_ratio)

    return forward_fn, train_fn


def make_eval_step(model: NnetAM, feat_fn: FeaturePipeline) -> Callable:
    """step(batch) → (sum_nll, frames, correct) — for dev-loss tracking."""
    eval_fn = feat_fn.for_eval()  # deterministic: no dither at eval

    @torch.no_grad()
    def step(batch: dict):
        return ce_forward(model, eval_fn, batch, None, False)

    return step


class Throughput:
    """utt/sec and frames/sec over a sliding window (the reference logs utt/sec)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.time()
        self.utts = 0
        self.frames = 0

    def update(self, utts: int, frames: float):
        self.utts += utts
        self.frames += frames

    def rates(self):
        dt = max(time.time() - self.t0, 1e-9)
        return self.utts / dt, self.frames / dt
