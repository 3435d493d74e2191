"""2-D (data × model) parallel CE train step: DP batch + TP output layer.

Port of pykaldi2_tpu/parallel/tensor_parallel.py. Senone output layers are
the one wide tensor here (hidden × ~9k pdf-ids), so ``out_w``/``out_b`` may
be split by columns over the mesh's ``model`` group: each rank computes the
logits of its vocabulary block, the log-sum-exp and the label's logit are
summed over ``model`` with differentiable all-reduces, the max shift and
the argmax with plain ones. Gradients of the replicated backbone are summed
over both groups, those of the output blocks over ``data`` only. The
trainer CLIs do not reach this module (nor do the JAX CLIs reach theirs).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dnn

from pykaldi2_tpu_torch.models.nnet_am import NnetAM
from pykaldi2_tpu_torch.ops.lstm_cuda import linear
from pykaldi2_tpu_torch.parallel.data_parallel import psum
from pykaldi2_tpu_torch.parallel.mesh import Mesh
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.utils.lr import Optimizer

Tensor = torch.Tensor


def shard_params(model: NnetAM, mesh: Mesh) -> NnetAM:
    """Keep this rank's column block of ``out_w`` [H, C] and ``out_b`` [C]
    over the ``model`` group (in place; build the optimizer afterwards)."""
    m, n = mesh.coord("model"), mesh.axis_size("model")
    c = model.out_b.shape[0]
    if c % n:
        raise ValueError(f"output size {c} does not split over {n} model ranks")
    lo, hi = m * (c // n), (m + 1) * (c // n)
    model.out_w = torch.nn.Parameter(model.out_w.detach()[:, lo:hi].clone())
    model.out_b = torch.nn.Parameter(model.out_b.detach()[lo:hi].clone())
    return model


def tp_ce_terms(logits_local: Tensor, labels: Tensor, mask: Tensor, vocab_offset: int,
                group=None):
    """Masked CE over a vocabulary-sharded logit tensor.

    logits_local: [B, T, C_local], this rank's block of the vocabulary,
    starting at ``vocab_offset``. Returns (sum_nll, count, correct), the same
    on every rank of ``group``. The backward of each all-reduce sums the
    gradients of every rank's copy of the loss, so the gradient of sum_nll
    taken on every rank reaches each block once per rank of the group:
    backpropagate ``sum_nll / group size`` (``make_ce_train_step_2d`` does)."""
    logits_local = logits_local.to(torch.float32)
    m = mask.to(torch.float32)
    with torch.no_grad():  # a stability shift only: no gradient
        gmax = logits_local.max(dim=-1).values
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    sumexp = torch.exp(logits_local - gmax[..., None]).sum(dim=-1)
    logz = torch.log(dnn.all_reduce(sumexp, group=group)) + gmax
    c_local = logits_local.shape[-1]
    local_label = labels - vocab_offset
    owned = (local_label >= 0) & (local_label < c_local)
    safe = torch.clamp(local_label, 0, c_local - 1)
    picked = torch.gather(logits_local, -1, safe[..., None])[..., 0]
    label_logit = dnn.all_reduce(torch.where(owned, picked, torch.zeros_like(picked)),
                                 group=group)
    ll = label_logit - logz
    sum_nll = -torch.sum(ll * m)
    count = torch.sum(m)
    with torch.no_grad():  # global argmax for the frame accuracy
        vmax_local, amax_local = logits_local.max(dim=-1)
        vmax = vmax_local.clone()
        dist.all_reduce(vmax, op=dist.ReduceOp.MAX, group=group)
        pred = torch.where(vmax_local >= vmax, amax_local + vocab_offset,
                           torch.full_like(amax_local, torch.iinfo(torch.int64).max))
        dist.all_reduce(pred, op=dist.ReduceOp.MIN, group=group)
        correct = torch.sum((pred == labels) * m)
    return sum_nll, count, correct


def make_ce_train_step_2d(model: NnetAM, feat_fn: FeaturePipeline, optimizer: Optimizer,
                          mesh: Mesh, grad_clip: float = 0.0) -> Callable:
    """DP×TP CE train step over a mesh with ('data', 'model') axes:
    step(batch, generator) → metrics dict(loss, frame_acc, frames), global.

    ``model`` holds this rank's output block (``shard_params``); ``batch`` is
    the rank's data shard (the same on every rank of a ``model`` group). Pass
    an optimizer WITHOUT a clip and the threshold here: the global norm sums
    the sharded leaves' square-sums over ``model``."""
    if set(mesh.axis_names) != {"data", "model"}:
        raise ValueError("mesh must have axes ('data', 'model')")
    dgroup, mgroup = mesh.group("data"), mesh.group("model")
    n_model = mesh.axis_size("model")
    offset = mesh.coord("model") * model.out_w.shape[1]
    shard = [model.out_w, model.out_b]
    rep = [p for p in model.parameters() if all(p is not q for q in shard)]

    def step(batch: dict, generator: Optional[torch.Generator] = None) -> dict:
        optimizer.zero_grad()
        feats = feat_fn(batch, generator=generator)
        mask = batch["mask"].to(torch.float32)
        h = model.nnet(feats, mask, train=True, generator=generator)
        logits_local = linear(h, model.out_w, model.compute_dtype) + model.out_b
        sum_nll, count, correct = tp_ce_terms(logits_local, batch["labels"].long(), mask,
                                              offset, mgroup)
        gnll, gcount, gcorrect = psum([sum_nll, count, correct], dgroup)
        denom = torch.clamp(gcount, min=1.0)
        (sum_nll / (denom * n_model)).backward()
        with torch.no_grad():
            for p in rep:
                dist.all_reduce(p.grad, group=mgroup)
            for p in rep + shard:
                dist.all_reduce(p.grad, group=dgroup)
            if grad_clip > 0.0:
                sq_rep = sum(torch.sum(p.grad * p.grad) for p in rep)
                sq_shard = sum(torch.sum(p.grad * p.grad) for p in shard)
                dist.all_reduce(sq_shard, group=mgroup)
                gnorm = torch.sqrt(sq_rep + sq_shard)
                scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
                for p in rep + shard:
                    p.grad.mul_(scale)
        optimizer.step()
        return {"loss": gnll / denom, "frame_acc": gcorrect / denom, "frames": gcount}

    return step
