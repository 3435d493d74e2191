"""Optimizers and LR scheduling on torch.optim.

Port of pykaldi2_tpu/utils/lr.py, which builds the optax chain
clip_by_global_norm → add_decayed_weights → (sgd | momentum | adam with the
warmup schedule) → scale(lr_scale). Here the same update:

  * the clip is written out to match ``optax.clip_by_global_norm`` exactly
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm and differs);
  * coupled weight decay is torch.optim's ``weight_decay`` (wd·p added to the
    clipped gradient before the base optimizer, as add_decayed_weights does);
  * every base update is linear in the learning rate, so the warmup schedule
    and the plateau ``lr_scale`` multiply into the param groups' ``lr``
    before each step.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from pykaldi2_tpu_torch.config import OptimizerConfig
from pykaldi2_tpu_torch.utils import tracing


class Optimizer:
    """clip → decay → (sgd | momentum | adam) → lr_scale, over ``params``.

    ``step()`` applies one update from the parameters' ``.grad`` and advances
    the schedule count; ``lr_scale`` is the plateau annealer's multiplier.
    """

    def __init__(self, cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]):
        self.cfg = cfg
        self.params = [p for p in params]
        self.count = 0
        self.lr_scale = 1.0
        wd = cfg.weight_decay if cfg.weight_decay > 0 else 0.0
        if cfg.type == "sgd":
            self.base = torch.optim.SGD(self.params, lr=cfg.lr, weight_decay=wd)
        elif cfg.type == "momentum":
            self.base = torch.optim.SGD(self.params, lr=cfg.lr, momentum=cfg.momentum,
                                        weight_decay=wd)
        elif cfg.type == "adam":
            self.base = torch.optim.Adam(self.params, lr=cfg.lr, betas=(0.9, 0.999),
                                         eps=1e-8, weight_decay=wd)
        else:
            raise ValueError(f"unknown optimizer {cfg.type!r}")

    def schedule(self, count: int) -> float:
        lr = self.cfg.lr
        if self.cfg.warmup_steps > 0:
            lr = lr * min(1.0, (count + 1) / self.cfg.warmup_steps)
        return lr

    def zero_grad(self) -> None:
        self.base.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        with tracing.span("pk2/optimizer.step"):
            if self.cfg.grad_clip > 0:
                clip_by_global_norm([p.grad for p in self.params if p.grad is not None],
                                    self.cfg.grad_clip)
            lr = self.schedule(self.count) * self.lr_scale
            for group in self.base.param_groups:
                group["lr"] = lr
            self.base.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"base": self.base.state_dict(), "count": self.count,
                "lr_scale": self.lr_scale}

    def load_state_dict(self, state: dict) -> None:
        self.base.load_state_dict(state["base"])
        self.count = int(state["count"])
        self.lr_scale = float(state["lr_scale"])


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """In place, as optax.clip_by_global_norm: g ← g if ‖g‖ < max_norm else
    g / ‖g‖ · max_norm, with ‖g‖ the norm over all gradients together.
    Returns the norm (a device scalar; nothing is synchronised)."""
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def make_optimizer(cfg: OptimizerConfig, params: Iterable[torch.nn.Parameter]) -> Optimizer:
    """Build the optimizer for ``params`` (clip → decay → base → lr_scale)."""
    return Optimizer(cfg, params)


def set_lr_scale(optimizer: Optimizer, scale: float) -> Optimizer:
    """Set the plateau multiplier (in place); returns the optimizer."""
    optimizer.lr_scale = float(scale)
    return optimizer


class PlateauAnnealer:
    """Halve LR when the tracked loss stops improving (reference anneal-lr)."""

    def __init__(self, factor: float = 0.5, patience: int = 1, min_scale: float = 1e-3):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_scale
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, loss: float) -> float:
        """Feed the epoch loss; returns the (possibly reduced) lr scale."""
        if loss < self.best - 1e-6:
            self.best = loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale

    def state(self) -> dict:
        """JSON-serializable state for checkpoint meta (resume support)."""
        return {"best": self.best, "bad_epochs": self.bad_epochs, "scale": self.scale}

    def restore_from_checkpoint(self, resume_meta: Optional[dict], optimizer: Optimizer):
        """Restore plateau state from checkpoint meta and re-apply the LR scale
        (old checkpoints without "anneal" still carry lr_scale)."""
        if not resume_meta:
            return optimizer
        self.restore(resume_meta.get("anneal")
                     or {"scale": resume_meta.get("lr_scale", 1.0)})
        return set_lr_scale(optimizer, self.scale)

    def restore(self, state: Optional[dict]):
        """Restore from checkpoint meta; tolerates missing/old checkpoints."""
        if not state:
            return
        self.best = float(state.get("best", self.best))
        self.bad_epochs = int(state.get("bad_epochs", self.bad_epochs))
        self.scale = float(state.get("scale", self.scale))
