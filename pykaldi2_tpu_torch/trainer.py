"""Train steps: CE, sequence training over a fixed denominator graph and
over decoded lattices; the eval step; throughput.

Port of pykaldi2_tpu/trainer.py (reference behavior: pykaldi2/bin/
train_ce.py's and train_se.py's hot loops — forward, loss, backward,
clipped SGD/Adam step, loss/frame-acc logging). One step runs front end →
model → loss → backward → optimizer update on the batch's device. Losses
are normalized by the supervised frame count, so padding contributes
exactly nothing.

With a ``mesh`` (parallel/mesh.py) over a process group, each step's
train forward runs through ``DistributedDataParallel`` over the ``data``
group, as the reference's shard_map steps do over the ``data`` axis:

  * the loss is the local sum over the GLOBAL supervised count (one
    all-reduce of the detached count, before the backward), and the comm
    hook of parallel/data_parallel.py SUMS the gradients (DDP's own hook
    averages), so every rank holds the gradient of the global loss;
  * ``grad_compression="bf16"`` rounds each local gradient bucket to bf16,
    sums in bf16 and casts back (reference trainer.py:86-94); on a one-rank
    mesh without a process group the gradients are rounded in place;
  * the optimizer's global-norm clip then runs on the reduced gradients,
    as optax's chain runs after the psum;
  * the metrics (loss or objective, frame accuracy, frames, ce) are sums
    over the group, so logs do not depend on the world size;
  * eval forwards (``make_eval_step``, the lattice ``forward_fn``) call the
    module itself, never the wrapper, so no collective runs off the main
    thread or inside a CUDA-graph capture.

The caller seeds each rank's generator (``parallel.mesh.rank_seed``).

Spans (utils/tracing.py): ``pk2/train.forward`` around the CE step's
forward and loss and the lattice ``train_fn``'s forward to its objective
rows, ``pk2/train.backward`` around a train step's backward pass (on the
thread that runs it), ``pk2/eval.forward`` around the lattice
``forward_fn``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from pykaldi2_tpu_torch.models.nnet_am import NnetAM
from pykaldi2_tpu_torch.parallel.data_parallel import COMPRESSIONS, psum, wrap_ddp
from pykaldi2_tpu_torch.parallel.mesh import Mesh
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.utils import tracing
from pykaldi2_tpu_torch.utils.lr import Optimizer

Tensor = torch.Tensor


def ce_forward(model: NnetAM, feat_fn: FeaturePipeline, batch: dict,
               generator: Optional[torch.Generator], train: bool
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns (sum_nll, count, correct) as device scalars.

    ``mask`` is frame validity (feeds the model); supervision is mask AND
    labels >= 0 — they differ when labels are absent. The on-device
    simulation (when configured), dither and dropout draw, in that order,
    from ``generator``."""
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


def _data_parallel(model: NnetAM, mesh: Optional[Mesh], grad_compression: str):
    """(data group or None, the train forward's module, round grads to bf16
    locally): DDP over the mesh's ``data`` group when it has a process group."""
    if grad_compression not in COMPRESSIONS:
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    if mesh is None or not mesh.distributed:
        return None, model, mesh is not None and grad_compression == "bf16"
    group = mesh.group("data")
    return group, wrap_ddp(model, group, grad_compression), False


def _global(group, *values: Tensor) -> list:
    """Detached sums over the data group (the values themselves without one)."""
    if group is None:
        return [v.detach() for v in values]
    return psum(values, group)


def _round_bf16(optimizer: Optimizer) -> None:
    with torch.no_grad():
        for p in optimizer.params:
            if p.grad is not None:
                p.grad.copy_(p.grad.to(torch.bfloat16))


def _update(optimizer: Optimizer, loss: Tensor, round_local: bool) -> None:
    """Backward of ``loss``, then the optimizer's step."""
    tracing.backward_span(loss)
    loss.backward()
    if round_local:
        _round_bf16(optimizer)
    optimizer.step()


def make_ce_train_step(model: NnetAM, feat_fn: FeaturePipeline, optimizer: Optimizer,
                       mesh: Optional[Mesh] = None, grad_compression: str = "none"
                       ) -> Callable:
    """Build step(batch, generator) → metrics dict(loss, frame_acc, frames) of
    device scalars; the model's parameters and the optimizer state update in
    place. With ``mesh``, ``batch`` is this rank's shard and the metrics are
    global (module docstring)."""
    group, fwd, round_local = _data_parallel(model, mesh, grad_compression)

    def step(batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        optimizer.zero_grad()
        with tracing.span("pk2/train.forward"):
            sum_nll, count, correct = ce_forward(fwd, feat_fn, batch, generator, True)
            gcount, gnll, gcorrect = _global(group, count, sum_nll, correct)
            denom = torch.clamp(gcount, min=1.0)
            loss = sum_nll / denom
        _update(optimizer, loss, round_local)
        with torch.no_grad():
            return {"loss": gnll / denom, "frame_acc": gcorrect / denom, "frames": gcount}

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
               sup: Tensor, nf: Tensor, ce_ratio: float, group=None,
               round_local: bool = False) -> dict:
    """The SE step's tail: −objective per supervised frame (+ ce_ratio × CE,
    f-smoothing) over the global count, backward, optimizer step; →
    metrics dict(objective, frame_acc, frames, ce) of device scalars, summed
    over ``group``."""
    # zero-length padded rows would contribute num − logZ(dead) ≈ +1e30
    obj = torch.sum(torch.where(nf > 0, obj_rows, torch.zeros_like(obj_rows)))
    count = torch.sum(sup)
    sum_nll = torch.zeros((), device=logits.device)
    if ce_ratio > 0.0:
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, torch.clamp(labels, min=0)[..., None])[..., 0]
        sum_nll = -torch.sum(ll * sup)
    with torch.no_grad():
        correct = torch.sum((torch.argmax(logits, -1) == labels) * sup)
    gcount, gobj, gcorrect, gnll = _global(group, count, obj, correct, sum_nll)
    denom = torch.clamp(gcount, min=1.0)
    loss = -obj / denom
    if ce_ratio > 0.0:
        loss = loss + ce_ratio * sum_nll / denom
    _update(optimizer, loss, round_local)
    with torch.no_grad():
        return {"objective": gobj / denom, "frame_acc": gcorrect / denom,
                "frames": gcount, "ce": gnll / denom}


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
    mesh: Optional[Mesh] = None,
    grad_compression: str = "none",
) -> Callable:
    """Sequence-discriminative train step over a fixed denominator graph
    (reference train_se hot loop). Port of pykaldi2_tpu/trainer.py:129-245;
    ``mesh`` and ``grad_compression`` as in the module docstring.

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
    group, fwd, round_local = _data_parallel(model, mesh, grad_compression)

    def step(batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        optimizer.zero_grad()
        mask = batch["mask"].to(torch.float32)
        nf = batch["num_frames"]
        labels = batch["labels"].long()
        feats = feat_fn(batch, generator=generator)
        logits = fwd(feats, mask, train=True, generator=generator)
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
        return _se_update(optimizer, logits, obj_rows, labels, sup, nf, ce_ratio, group,
                          round_local)

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
    mesh: Optional[Mesh] = None,
    grad_compression: str = "none",
) -> Tuple[Callable, Callable]:
    """On-the-fly denominator-lattice training (the reference's signature
    mode): returns (forward_fn, train_fn). Port of pykaldi2_tpu/trainer.py:
    248-377; ``mesh`` and ``grad_compression`` as in the module docstring
    (each rank trains on its own rows and its own lattices, whatever their T,
    K and A).

    forward_fn(batch) → scaled obs [B, T, P] in ``obs_transfer_dtype`` (the
    host decodes lattices from it): the eval pipeline (no dither, no
    dropout), without gradients. "bfloat16" halves the device→host copy;
    the loss-side forward recomputes obs in fp32, so training math is
    unaffected.

    train_fn(batch, lattice, generator) → metrics dict(objective, frame_acc,
    frames, ce) of device scalars; applies the lattice update in place,
    recomputing the forward with dither and dropout. ``lattice`` is on the
    batch's device and picks the route by its type, as the reference's does:
    a TimeSyncLattice (banded decoded lattices, ops/fb_lattice.py: kernels
    K7-K10 on the card; carries [T, B, K]) or a BatchedGraphs (generic
    per-utterance arc tables, ops/fb_batched.py: plain torch ops; carries
    [T, B, num_states]). criterion: mmi (num alignment − lattice logZ) or
    smbr/mpfe (expected frame accuracy over the decoded lattice, Kaldi
    LatticeForwardBackwardMpeVariants semantics); ce_ratio adds the CE
    f-smoothing term.
    """
    from pykaldi2_tpu_torch.ops.fb_batched import (BatchedGraphs, batched_expected_accuracy,
                                                   mmi_objective_lattice)
    from pykaldi2_tpu_torch.ops.fb_lattice import (TimeSyncLattice,
                                                   lattice_expected_accuracy_ts,
                                                   mmi_objective_lattice_ts)
    from pykaldi2_tpu_torch.ops.se_losses import acoustic_scores

    routes = {TimeSyncLattice: (mmi_objective_lattice_ts, lattice_expected_accuracy_ts),
              BatchedGraphs: (mmi_objective_lattice, batched_expected_accuracy)}

    crit, _dev, lp, p2p, sil = _se_setup(model, criterion, log_prior, pdf_to_phone, silence)
    out_dtype = getattr(torch, obs_transfer_dtype)
    eval_feat_fn = feat_fn.for_eval()
    group, fwd, round_local = _data_parallel(model, mesh, grad_compression)

    @torch.no_grad()
    def forward_fn(batch: dict) -> Tensor:
        with tracing.span("pk2/eval.forward"):
            logits = model(eval_feat_fn(batch), batch["mask"])
            return acoustic_scores(logits, lp, acoustic_scale).to(out_dtype)

    def train_fn(batch: dict, lattice, generator: Optional[torch.Generator] = None) -> dict:
        if type(lattice) not in routes:
            raise TypeError(f"lattice must be a TimeSyncLattice or a BatchedGraphs, not "
                            f"{type(lattice).__name__}")
        mmi_fn, acc_fn = routes[type(lattice)]
        optimizer.zero_grad()
        with tracing.span("pk2/train.forward"):
            mask = batch["mask"].to(torch.float32)
            nf = batch["num_frames"]
            labels = batch["labels"].long()
            feats = feat_fn(batch, generator=generator)
            logits = fwd(feats, mask, train=True, generator=generator)
            obs = acoustic_scores(logits, lp, acoustic_scale)
            sup = mask * (labels >= 0)
            if crit == "mmi":
                obj_rows = mmi_fn(obs, labels, lattice, nf, sup, drop_frames, den_scale)
            else:
                ref, level = labels, "pdf"
                if crit == "mpfe":
                    ref, level = p2p[torch.clamp(labels, min=0)], "phone"
                obj_rows = acc_fn(obs, lattice, torch.clamp(ref, min=0), nf, level, p2p, sil)
        return _se_update(optimizer, logits, obj_rows, labels, sup, nf, ce_ratio, group,
                          round_local)

    return forward_fn, train_fn


def make_eval_step(model: NnetAM, feat_fn: FeaturePipeline,
                   mesh: Optional[Mesh] = None) -> Callable:
    """step(batch) → (sum_nll, frames, correct) — for dev-loss tracking;
    sums over the mesh's ``data`` group (the module itself runs the forward)."""
    eval_fn = feat_fn.for_eval()  # deterministic: no dither at eval
    group = mesh.group("data") if mesh is not None and mesh.distributed else None

    @torch.no_grad()
    def step(batch: dict):
        out = ce_forward(model, eval_fn, batch, None, False)
        return out if group is None else tuple(psum(out, group))

    return step


class Throughput:
    """utt/sec and frames/sec since the last reset (the reference logs utt/sec)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.utts = 0
        self.frames = 0

    def update(self, utts: int, frames: float):
        self.utts += utts
        self.frames += frames

    def rates(self):
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return self.utts / dt, self.frames / dt
