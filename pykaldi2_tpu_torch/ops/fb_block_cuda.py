"""Block-sparse matvec of the fixed-denominator forward-backward: kernel K11
(``csrc/blockfb.cu``) and its plain version.

Counterpart of pykaldi2_tpu/ops/fb_block.py:_bmv_kernel (:297, called by
``_block_matvec_pallas`` :317-346). ``block_matvec(lin, graph, transpose)``
computes ``lin @ W`` (or ``lin @ W^T`` with ``transpose``) for a
``BlockSparseGraph``'s transition matrix W, stored as its nonzero 128×128
tiles in one COO list per orientation, sorted by output block:

    out[:, j_n] += lin[:, i_n] @ W_n     for every tile n (blocks of 128 states)

``lin`` is [R, Sp] fp32, nonnegative (the recursions' linear carries); each
orientation has its own sorted list, CSR row pointer, K11 segment pointer
and segment descriptors (``bi/bj/wb/rowptr/segptr/segdesc`` and
``bit/bjt/wbt/rowptr_t/segptr_t/segdesc_t``). The plain version gathers the
source blocks (``index_select``), multiplies tile by tile (``bmm``) and sums
into the output blocks (``index_add_``). The wrapper takes the plain version only for
CPU tensors; on CUDA tensors it launches K11 or raises, and
``block_matvec.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from pykaldi2_tpu_torch import device as D

Tensor = torch.Tensor


def _orientation(g, transpose: bool):
    """(source blocks, output blocks, tiles, CSR row pointer) of one orientation."""
    return (g.bit, g.bjt, g.wbt, g.rowptr_t) if transpose else (g.bi, g.bj, g.wb, g.rowptr)


# K11 gives each CTA a run of at most this many tiles of one output block
# (the graph's segptr and segdesc; the kernel takes up to 4), so a block that
# gathers from many tiles (a loop state fed by every chain) is spread over
# several CTAs
SEG_TILES = 2

# K11's per-block completion counters, by device: the kernel leaves them at 0,
# so one zeroed buffer serves every call on the device's (single) stream
_COUNTERS = {}


def _counters(dev: torch.device, n: int) -> Tensor:
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def block_matvec_plain(lin: Tensor, g, transpose: bool = False) -> Tensor:
    """K11's function in plain PyTorch: [R, Sp] → [R, Sp]."""
    src_blk, dst_blk, tiles, _ = _orientation(g, transpose)
    r, k = lin.shape[0], g.block
    nblk = g.num_padded // k
    x = lin.reshape(r, nblk, k).index_select(1, src_blk)            # [R, nc, k]
    y = torch.bmm(x.transpose(0, 1), tiles.to(lin.dtype))            # [nc, R, k]
    out = lin.new_zeros(nblk, r, k).index_add_(0, dst_blk, y)
    return out.transpose(0, 1).reshape(r, nblk * k)


def _lib() -> ctypes.CDLL:
    lib = D.load_kernel_lib("blockfb")
    if not getattr(lib, "_pk2_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pk2_blockfb_matvec.argtypes = [vp] * 8 + [ci] * 4 + [vp]
        lib.pk2_blockfb_matvec.restype = ci
        lib.pk2_blockfb_block_size.restype = ci
        lib.pk2_blockfb_row_tile.argtypes = [ci]
        lib.pk2_blockfb_row_tile.restype = ci
        lib._pk2_typed = True
    return lib


def _check(name: str, t: Tensor, dtype: torch.dtype, shape: tuple, dev: torch.device):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, K11 takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def block_matvec(lin: Tensor, g, transpose: bool = False) -> Tensor:
    """K11: ``lin @ W`` (``lin @ W^T`` with ``transpose``) over the graph's
    nonzero tiles. Same contract as ``block_matvec_plain``."""
    if lin.device.type == "cpu":
        return block_matvec_plain(lin, g, transpose)
    src_blk, _dst, tiles, _rowptr = _orientation(g, transpose)
    segptr, segdesc = (g.segptr_t, g.segdesc_t) if transpose else (g.segptr, g.segdesc)
    dev = lin.device
    if tiles.dtype != torch.float32:
        raise ValueError(f"K11 needs float32 tiles, the graph holds {tiles.dtype}: bf16 "
                         "tiles (the reference's TPU default) have no kernel here; pack "
                         "the graph with float32 tiles")
    lib = _lib()
    k = lib.pk2_blockfb_block_size()
    if g.block != k:
        raise ValueError(f"K11 takes {k}x{k} tiles, the graph was packed with block={g.block}")
    nblk = g.num_padded // k
    if lin.dim() != 2 or lin.shape[0] < 1:
        raise ValueError(f"lin must be [R >= 1, {g.num_padded}], got {tuple(lin.shape)}")
    r = lin.shape[0]
    nc = tiles.shape[0]
    _check("lin", lin, torch.float32, (r, g.num_padded), dev)
    _check("tiles", tiles, torch.float32, (nc, k, k), dev)
    _check("src_blk", src_blk, torch.int32, (nc,), dev)
    _check("segptr", segptr, torch.int32, (nblk + 1,), dev)
    nseg = g.num_seg_t if transpose else g.num_seg
    _check("segdesc", segdesc, torch.int32, (nseg, 4), dev)
    for name, t in (("lin", lin), ("tiles", tiles), ("segdesc", segdesc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for K11's vector loads")
    rt = lib.pk2_blockfb_row_tile(r)
    ytiles = -(-r // rt)
    partial = torch.empty((nseg, ytiles, rt, k), dtype=torch.float32, device=dev)
    out = torch.empty_like(lin)
    with torch.cuda.device(dev):
        rc = lib.pk2_blockfb_matvec(D.ptr(lin), D.ptr(tiles), D.ptr(src_blk), D.ptr(segdesc),
                                    D.ptr(segptr), D.ptr(partial),
                                    D.ptr(_counters(dev, nblk * ytiles)), D.ptr(out), r, nblk,
                                    nseg, SEG_TILES, D.current_stream_ptr(dev))
    D.check_launch(rc, "block-sparse matvec (K11)")
    block_matvec.launches += 1
    return out


block_matvec.launches = 0
