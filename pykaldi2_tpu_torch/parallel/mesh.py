"""Process groups as meshes: one process per card, ranks laid out on axes.

Port of pykaldi2_tpu/parallel/mesh.py. The JAX package builds one program
over a device mesh in a single controller; the PyTorch idiom is one process
per card, so the mapping is:

  * ``jax.process_count()`` / ``jax.process_index()`` ↔
    ``dist.get_world_size()`` / ``dist.get_rank()``;
  * a mesh axis ↔ the ranks that differ only in that axis' coordinate, as
    one process group per axis and coordinate of the other axes (rank r sits
    at ``np.unravel_index(r, sizes)``, the order of ``devices.reshape``);
  * ``-multihost`` / ``jax.distributed.initialize()`` ↔
    ``dist.init_process_group(init_method="env://")`` from ``torchrun``'s
    environment (``init_distributed``), ``nccl`` on CUDA and ``gloo`` on the
    CPU; the default mesh over every local chip ↔ ``torchrun
    --nproc_per_node=N``.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pykaldi2_tpu_torch.device import resolve_device


def axis_sizes(shape: Optional[dict], n: int) -> Dict[str, int]:
    """Axis name → size for ``n`` ranks. Default: one ``data`` axis over all.
    A -1 size is inferred; sizes that do not multiply to ``n`` raise
    ``ValueError`` (reference make_mesh's check)."""
    if not shape:
        return {"data": n}
    names, sizes = list(shape), list(shape.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} != {n} ranks")
    return dict(zip(names, sizes))


@dataclass
class Mesh:
    """Axis sizes, this rank's coordinates, and one process group per axis
    (the ranks that share every other coordinate). ``distributed`` is False
    for a one-process mesh with no process group: its groups are None and
    every collective is skipped."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object] = field(default_factory=dict)
    distributed: bool = False

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(shape: Optional[dict] = None) -> Mesh:
    """Build a Mesh over the ranks of the default process group (one rank
    when none is initialized). Every rank must call it, in the same order
    as the others: each axis group is a ``dist.new_group`` call on all."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    sizes = axis_sizes(shape, world)
    names, dims = list(sizes), list(sizes.values())
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, dims))))
    if not dist.is_initialized():
        return Mesh(sizes, coords)
    layout = np.arange(world).reshape(dims)
    groups = {}
    for i, name in enumerate(names):
        if dims[i] == world:
            groups[name] = dist.group.WORLD
            continue
        moved = np.moveaxis(layout, i, -1).reshape(-1, dims[i])
        for ranks in moved:  # every rank creates every group, in one order
            g = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[name] = g
    return Mesh(sizes, coords, groups, True)


def describe(mesh: Optional[Mesh], dev) -> str:
    """The trainers' log line of the process layout."""
    if mesh is None:
        return "mesh: none (-single_device: one process, no DDP)"
    if not mesh.distributed:
        return f"mesh {mesh.shape}: one process, no DDP (no process group)"
    return (f"mesh {mesh.shape}: rank {dist.get_rank()} of {dist.get_world_size()} at "
            f"{mesh.coords}, DDP over the data group ({dist.get_backend()}) on {dev}")


def local_batch_shard(mesh: Optional[Mesh], axis: str = "data") -> Tuple[int, int]:
    """(rank, world_size) of this process's batch shard for the loaders:
    the ``axis`` coordinate and size (reference ``local_batch_sharding``;
    ranks that differ only on other axes read the same shard)."""
    if mesh is None:
        return 0, 1
    return mesh.coord(axis), mesh.axis_size(axis)


def collective_device(group=None) -> torch.device:
    """Where a collective's tensors live: the current card for ``nccl``,
    the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def equalized_steps(loader, batch_iter):
    """Truncate a loader's iterator to the smallest per-process batch count.

    Every step holds collectives, so a rank with one extra batch would wait
    for the others forever; uses the loader's metadata-only
    ``num_batches(conservative=True)`` and an ``all_reduce(MIN)`` over every
    rank. Passes ``batch_iter`` through on one process."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return batch_iter
    n = torch.tensor([loader.num_batches(conservative=True)], dtype=torch.int64,
                     device=collective_device())
    dist.all_reduce(n, op=dist.ReduceOp.MIN)
    return itertools.islice(batch_iter, int(n.item()))


def rank_seed(seed: int, mesh: Optional[Mesh], axis: str = "data") -> int:
    """The seed of this rank's dither and dropout generator: ``seed`` at
    data coordinate 0 (so a one-rank run is the single-process run), and one
    seed per coordinate otherwise (reference ``fold_in(key,
    axis_index('data'))``)."""
    return seed + (local_batch_shard(mesh, axis)[0] << 32)


def _wants_cuda(device) -> bool:
    if device is None:
        return os.environ.get("PK2_PLATFORM", "").strip().lower() != "cpu"
    return torch.device(device).type == "cuda" and torch.device(device).index is None


def init_distributed(multihost: bool, single_device: bool = False,
                     device=None) -> Tuple[torch.device, bool]:
    """The trainers' process set-up; returns (device, owns the group).

    A process group is used when ``-multihost`` is given, when ``WORLD_SIZE``
    is in the environment (``torchrun``), or when the caller initialized one
    already; never under ``-single_device``. Each rank first selects its card
    from ``LOCAL_RANK``, then resolves the device as every entry point does,
    then joins the group from ``torchrun``'s ``env://`` variables with
    ``nccl`` on CUDA or ``gloo`` on the CPU. A failed init raises."""
    if single_device:
        return resolve_device(device), False
    want = multihost or "WORLD_SIZE" in os.environ or dist.is_initialized()
    if want and _wants_cuda(device) and "LOCAL_RANK" in os.environ \
            and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dev = resolve_device(device)
    if not want or dist.is_initialized():
        return dev, False
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://")
    return dev, True
