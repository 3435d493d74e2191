"""CE training: the single-device train step, the eval step, throughput.

Port of pykaldi2_tpu/trainer.py:29-126 and 380-422 (reference behavior:
pykaldi2/bin/train_ce.py's hot loop — forward, CE loss, backward, clipped
SGD/Adam step, loss/frame-acc logging). One step runs front end → model →
masked CE → backward → optimizer update on the batch's device. The loss is
normalized by the supervised frame count, so padding contributes exactly
nothing. Data parallelism (the JAX mesh, bf16 gradient compression) comes
with the DDP slice.
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
