"""BMUF: blockwise model-update filtering (Chen & Huo style).

Port of pykaldi2_tpu/parallel/bmuf.py. Workers train independently for a
block of steps, then synchronize with block momentum:

    G_t  = mean_w(W_w) − W_global          (block gradient)
    Δ_t  = η·Δ_{t−1} + ζ·G_t               (block momentum η, block lr ζ)
    W    = W_global + Δ_t ;  workers restart from W (+ optional Nesterov η·Δ)

One rank is one worker: it keeps its own parameters and optimizer and
steps with the plain (non-DDP) train step; the sync is one all-reduce mean
of the parameters over the ``data`` group. The trainer CLIs do not use it.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple

import torch

from pykaldi2_tpu_torch.parallel.data_parallel import psum, psum_mean, replicate
from pykaldi2_tpu_torch.parallel.mesh import Mesh


class BmufState(NamedTuple):
    global_params: List[torch.Tensor]
    delta: List[torch.Tensor]
    block_momentum: float
    block_lr: float


def bmuf_init(model: torch.nn.Module, mesh: Mesh, block_momentum: float = 0.9,
              block_lr: float = 1.0, axis: str = "data") -> BmufState:
    """Every worker starts from the first rank's parameters; returns the
    state (global parameters, zero block momentum)."""
    if mesh.distributed:
        replicate(model, mesh.group(axis))
    params = [p.detach().clone() for p in model.parameters()]
    return BmufState(params, [torch.zeros_like(p) for p in params], block_momentum, block_lr)


def make_bmuf_sync(mesh: Mesh, axis: str = "data", nesterov: bool = True) -> Callable:
    """sync(model, state) → new state; the model's parameters become the
    restart point, the same on every worker."""
    group = mesh.group(axis)

    @torch.no_grad()
    def sync(model: torch.nn.Module, state: BmufState) -> BmufState:
        params = list(model.parameters())
        avg = [p.detach().clone() for p in params]
        if mesh.distributed:
            psum_mean(avg, group)
        delta = [state.block_momentum * d + state.block_lr * (a - w)
                 for d, a, w in zip(state.delta, avg, state.global_params)]
        new_global = [w + d for w, d in zip(state.global_params, delta)]
        restart = new_global
        if nesterov:  # CBM: workers restart ahead along the momentum direction
            restart = [w + state.block_momentum * d for w, d in zip(new_global, delta)]
        for p, r in zip(params, restart):
            p.copy_(r)
        return BmufState(new_global, delta, state.block_momentum, state.block_lr)

    return sync


def make_bmuf_local_step(local_train_step: Callable, mesh: Mesh,
                         axis: str = "data") -> Callable:
    """Lift step(batch, generator) → metrics to a worker step whose metrics
    are averaged over the workers (the reference's pmean). Each worker
    passes its own generator (``parallel.mesh.rank_seed``)."""
    group, n = mesh.group(axis), mesh.axis_size(axis)

    def step(batch: dict, generator=None) -> dict:
        metrics = local_train_step(batch, generator)
        if not mesh.distributed:
            return metrics
        return {k: v / n for k, v in zip(metrics, psum(list(metrics.values()), group))}

    return step
