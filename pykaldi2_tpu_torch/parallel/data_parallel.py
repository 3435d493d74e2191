"""Data-parallel collectives and the DDP wrapper the train steps use.

Port of pykaldi2_tpu/parallel/data_parallel.py (reference behavior: Horovod
allreduce and broadcast_parameters). The JAX steps psum gradients inside a
shard_map; here ``DistributedDataParallel`` reduces them during the backward
over the mesh's ``data`` group, through one of two comm hooks:

  * ``sum_hook``: fp32 all-reduce SUM (DDP's own hook averages);
  * ``bf16_sum_hook``: each bucket rounded to bf16, summed in bf16, cast
    back to fp32 (``grad_compression: bf16``; reference trainer.py:86-94).

The steps normalise the loss by the global supervised count, so the summed
gradient is the gradient of the global loss, as the reference's psum'd
cotangent is.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

COMPRESSIONS = ("none", "bf16")


def psum_mean(tensors: Sequence[torch.Tensor], group=None) -> None:
    """All-reduce mean over ``group``, in place (Horovod allreduce)."""
    n = dist.get_world_size(group)
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(n)


def psum(values: Sequence[torch.Tensor], group=None) -> list:
    """Sum scalars over ``group`` in one all-reduce; returns new tensors."""
    flat = torch.stack([v.detach().float() for v in values])
    dist.all_reduce(flat, group=group)
    return list(flat.unbind())


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast a module's parameters and buffers from the group's first
    rank (broadcast_parameters), in place; returns the module."""
    src = 0 if group is None or group is dist.group.WORLD else dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


# the hooks carry no annotations: DDP checks them against the classes and
# this module's annotations are strings
def sum_hook(group, bucket):
    """DDP comm hook: fp32 all-reduce SUM of the bucket over ``group``."""
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def bf16_sum_hook(group, bucket):
    """DDP comm hook: the bucket rounded to bf16, all-reduce SUM in bf16,
    cast back into the fp32 bucket."""
    buf = bucket.buffer()
    half = buf.to(torch.bfloat16)
    fut = dist.all_reduce(half, group=group, async_op=True).get_future()

    def back(f):
        buf.copy_(f.value()[0])
        return buf

    return fut.then(back)


def wrap_ddp(model: torch.nn.Module, group, grad_compression: str = "none"):
    """``model`` in DistributedDataParallel over ``group`` with the sum hook
    of ``grad_compression``. Construction broadcasts rank 0's parameters.
    Every parameter takes a gradient every step (``find_unused_parameters``
    off); the port's models hold no buffers, so no forward broadcasts any.
    Only the train forward goes through the wrapper, on the main thread;
    eval forwards call ``model`` itself."""
    from torch.nn.parallel import DistributedDataParallel

    if grad_compression not in COMPRESSIONS:
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    ddp = DistributedDataParallel(model, process_group=group, find_unused_parameters=False)
    ddp.register_comm_hook(group, bf16_sum_hook if grad_compression == "bf16" else sum_hook)
    return ddp
