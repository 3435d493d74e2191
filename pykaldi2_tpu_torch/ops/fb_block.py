"""Block-sparse forward-backward for graphs too big for the dense [S, S] form.

Port of pykaldi2_tpu/ops/fb_block.py. The dense state-matmul route
(ops/fb_dense.py) stops at 16k states; above that the exp-space transition
matrix is tiled into 128×128 blocks over BFS-reordered states and only the
NONZERO tiles are kept (compiler graphs are chain-structured, so after the
BFS most arcs sit near the block diagonal and the tile count stays ~O(S/128)).
The alpha/beta recursions carry LINEAR renormalised values (the reference's
default, ``PK2_BLOCKFB_LINCARRY`` unset): per frame one block-sparse matvec
(kernel K11, ops/fb_block_cuda.py), a multiply by exp(obs) gathered per
state, and a max-renormalisation.

Backward modes, as in the reference: when the whole [T, B, Sp] alpha
history fits ``PK2_BLOCKFB_SAVE_BYTES`` (default 3 GiB; twice the history
for sMBR), every frame's alpha is saved and the backward is one pass;
otherwise the forward saves each ``seg_len``-frame segment's entry carry and
the backward recomputes one segment at a time (√T memory). Launches of K11
per call: logZ + occupancies 2T (full save) or 3T (remat); expected
accuracy likewise, on 2B stacked rows.

The port packs every tile into one COO list per orientation, sorted by
output block, with a CSR row pointer — the reference's ``band_frac=0``
packing, which is the layout K11 takes. Not carried over (TPU routes to the
same function, or opt-in variants of it; ROADMAP.md lists them): the dense
band and ``_fuse_band``, ``_scan_unroll``, ``_use_pallas_block``, the log
carry (``PK2_BLOCKFB_LINCARRY=0``), ``_defernorm`` and bf16 tiles.
State-emission invariant required (arcs into a state share its pdf).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.ops.fb import (NEG_INF, SilenceOpts, _acc_ratio, _tensor_fields_to,
                                      frame_accuracy, log_safe)
from pykaldi2_tpu_torch.ops.fb_block_cuda import SEG_TILES, block_matvec
from pykaldi2_tpu_torch.ops.fb_dense import (_state_labels, exp_weights, final_weights,
                                            state_emission_pdfs, state_emission_phones)

Tensor = torch.Tensor


class BlockSparseGraph(NamedTuple):
    """Nonzero (k × k) tiles of the exp-space transition matrix over
    BFS-reordered, k-padded states, in both orientations (``wbt`` holds the
    transposed tiles for the beta recursion), each sorted by output block."""

    bi: Tensor             # [nc] int32 source block of each tile
    bj: Tensor             # [nc] int32 output block (sorted)
    wb: Tensor             # [nc, k, k] f32 e^{w}, 0 = no arc
    rowptr: Tensor         # [nblk + 1] int32: tiles of output block j are rowptr[j]:rowptr[j+1]
    bit: Tensor            # [nct] transposed-list source block
    bjt: Tensor            # [nct] transposed-list output block (sorted)
    wbt: Tensor            # [nct, k, k] transposed tiles
    rowptr_t: Tensor       # [nblk + 1] int32
    segptr: Tensor         # [nblk + 1] int32: K11's segments (runs of ≤ SEG_TILES tiles) per block
    segptr_t: Tensor       # [nblk + 1] int32
    segdesc: Tensor        # [num_seg, 4] int32: block, first tile, end tile, block's first segment
    segdesc_t: Tensor      # [num_seg_t, 4] int32
    state_pdf: Tensor      # [Sp] int64 (padded states -> 0, never reached)
    final: Tensor          # [Sp] f32 log-prob, NEG_INF on pads
    start: int             # state index in the reordered space
    num_states: int        # original S
    num_padded: int        # Sp = ceil(S / k) * k
    block: int             # k
    seg_len: int           # remat segment length (frames)
    num_seg: int           # K11 segments, forward orientation (segptr[-1])
    num_seg_t: int         # transposed (segptr_t[-1])
    state_phone: Optional[Tensor] = None  # [Sp] int64 (MPE accuracy)

    def to(self, device) -> "BlockSparseGraph":
        return _tensor_fields_to(self, device)


def _k11_segments(rowptr: np.ndarray):
    """K11's segments of one orientation: the CSR over segments (block j has
    ceil(tiles_j / SEG_TILES) of them) and each segment's descriptor (output
    block, first tile, end tile, the block's first segment)."""
    per_block = -(-np.diff(rowptr) // SEG_TILES)
    segptr = np.concatenate([[0], np.cumsum(per_block)])
    blk = np.repeat(np.arange(len(per_block)), per_block)
    n0 = rowptr[blk] + (np.arange(segptr[-1]) - segptr[blk]) * SEG_TILES
    desc = np.stack([blk, n0, np.minimum(n0 + SEG_TILES, rowptr[blk + 1]), segptr[blk]], 1)
    return segptr, desc


def _bfs_order(num_states: int, src: np.ndarray, dst: np.ndarray, start: int) -> np.ndarray:
    """perm[new] = old, BFS levels from start (stable within a level).

    Chains come out contiguous, so arcs concentrate near the block diagonal;
    unreachable states go last."""
    order = np.argsort(src, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    row_start = np.searchsorted(s_sorted, np.arange(num_states))
    row_end = np.searchsorted(s_sorted, np.arange(num_states) + 1)
    level = np.full(num_states, -1, np.int64)
    level[start] = 0
    frontier = [start]
    lv = 0
    while frontier:
        nxt = []
        for s in frontier:
            for d in d_sorted[row_start[s]:row_end[s]]:
                if level[d] < 0:
                    level[d] = lv + 1
                    nxt.append(int(d))
        frontier = sorted(nxt)
        lv += 1
    level[level < 0] = lv + 1
    return np.lexsort((np.arange(num_states), level))


def _with_zero_tiles(src_blk, dst_blk, tiles, miss, block):
    """Add a zero diagonal tile for each block in ``miss`` and re-sort by
    output block (stable), so every output block has at least one tile."""
    if not len(miss):
        return src_blk, dst_blk, tiles
    order = np.argsort(np.concatenate([dst_blk, miss]), kind="stable")
    z = np.zeros((len(miss), block, block), np.float32)
    return (np.concatenate([src_blk, miss])[order], np.concatenate([dst_blk, miss])[order],
            np.concatenate([tiles, z])[order])


def pack_graph_blocks(fsa, block: int = 128, seg_len: int = 16,
                      max_wb_bytes: int = 2 << 30) -> BlockSparseGraph:
    """DenseFsa → BlockSparseGraph (fp32 tiles, all tiles in the COO lists).
    Raises ValueError when the graph violates the state-emission invariant
    or the tiles of both orientations pass ``max_wb_bytes`` (callers fall
    back to the arc tables)."""
    if os.environ.get("PK2_BLOCKFB_TILE_DTYPE", "float32") != "float32":
        raise ValueError("PK2_BLOCKFB_TILE_DTYPE: the port packs float32 tiles only "
                         "(K11 has no bf16 path)")
    fsa.validate()
    state_pdf = state_emission_pdfs(fsa)
    if state_pdf is None:
        raise ValueError("graph violates the state-emission invariant "
                         "(arcs into one state carry different pdfs)")
    S = int(fsa.num_states)
    src = np.asarray(fsa.src, np.int64)
    dst = np.asarray(fsa.dst, np.int64)
    perm = _bfs_order(S, src, dst, int(fsa.start))      # perm[new] = old
    inv = np.empty(S, np.int64)
    inv[perm] = np.arange(S)
    src, dst = inv[src], inv[dst]
    state_pdf = state_pdf[perm]
    final = final_weights(fsa)[perm]
    phones = state_emission_phones(fsa)
    state_phone = None if phones is None else phones[perm]

    Sp = -(-S // block) * block
    nblk = Sp // block
    pair = (src // block) * nblk + dst // block
    uniq, pair_idx = np.unique(pair, return_inverse=True)
    wb = np.zeros((len(uniq), block, block), np.float32)
    # duplicate arcs between one state pair add in prob space (exact lse)
    np.add.at(wb, (pair_idx, src % block, dst % block), exp_weights(fsa))
    bi = (uniq // nblk).astype(np.int32)
    bj = (uniq % nblk).astype(np.int32)
    t_order = np.argsort(bi, kind="stable")     # transposed orientation
    bit, bjt = bj[t_order], bi[t_order]
    wbt = wb[t_order].transpose(0, 2, 1)
    # each list sorted (stably) by its output block
    order = np.argsort(bj, kind="stable")
    bi, bj, wb = bi[order], bj[order], np.ascontiguousarray(wb[order])
    order = np.argsort(bjt, kind="stable")
    bit, bjt, wbt = bit[order], bjt[order], np.ascontiguousarray(wbt[order])
    # block columns no tile reaches (in either orientation) get a zero
    # diagonal tile, so K11 visits and writes every output block
    every = np.arange(nblk)
    miss = np.union1d(np.setdiff1d(every, bj), np.setdiff1d(every, bjt)).astype(np.int32)
    bi, bj, wb = _with_zero_tiles(bi, bj, wb, miss, block)
    bit, bjt, wbt = _with_zero_tiles(bit, bjt, wbt, miss, block)
    n_slots = len(bi) + len(bit)
    if n_slots * block * block * 4 > max_wb_bytes:
        raise ValueError(f"block structure too dense: {n_slots} {block}x{block} tile "
                         f"slots ({n_slots * block * block * 4 / 1e9:.1f} GB)")

    pad = Sp - S
    i32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    i64 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64))  # noqa: E731
    rowptr = np.searchsorted(bj, np.arange(nblk + 1))
    rowptr_t = np.searchsorted(bjt, np.arange(nblk + 1))
    segptr, segdesc = _k11_segments(rowptr)
    segptr_t, segdesc_t = _k11_segments(rowptr_t)
    return BlockSparseGraph(
        bi=i32(bi), bj=i32(bj), wb=torch.from_numpy(wb), rowptr=i32(rowptr),
        bit=i32(bit), bjt=i32(bjt), wbt=torch.from_numpy(wbt), rowptr_t=i32(rowptr_t),
        segptr=i32(segptr), segptr_t=i32(segptr_t), segdesc=i32(segdesc),
        segdesc_t=i32(segdesc_t),
        state_pdf=i64(np.concatenate([state_pdf, np.zeros(pad, np.int64)])),
        final=torch.as_tensor(np.concatenate([final, np.full(pad, NEG_INF)]),
                              dtype=torch.float32),
        start=int(inv[int(fsa.start)]), num_states=S, num_padded=Sp, block=block,
        seg_len=seg_len, num_seg=int(segptr[-1]), num_seg_t=int(segptr_t[-1]),
        state_phone=None if state_phone is None else i64(
            np.concatenate([state_phone, np.zeros(pad, np.int64)])))


# ---------------------------------------------------------------------------
# linear-carry recursions
# ---------------------------------------------------------------------------


def _save_budget() -> int:
    return int(os.environ.get("PK2_BLOCKFB_SAVE_BYTES", str(3 << 30)))


def _full_save(g: BlockSparseGraph, b: int, t_len: int, histories: int = 1) -> bool:
    """True when ``histories`` [T, B, Sp] fp32 histories fit the save budget
    (1 for logZ/occupancies, 2 for sMBR's alpha and accumulator): the
    backward then skips the per-segment recompute, a third of the work."""
    return histories * t_len * b * g.num_padded * 4 <= _save_budget()


def _exp_obs_tm(obs: Tensor):
    """[B, T, P] log scores → time-major (exp(obs − m) [T, B, P], m [T, B]),
    computed once outside the frame loops."""
    m = obs.max(dim=2).values
    return torch.exp(obs - m[:, :, None]).transpose(0, 1).contiguous(), m.t().contiguous()


def _log_into(lin: Tensor, out: Tensor) -> None:
    """out = log_safe(lin) for a nonnegative ``lin``, written in place."""
    torch.log(lin, out=out)
    out.masked_fill_(lin <= 0.0, NEG_INF)


def _renorm(u: Tensor, norm: Tensor, om_f: Tensor):
    """(u / max_row(u), norm + om + log max_row(u)), a zero row left as is."""
    m2 = u.max(dim=1, keepdim=True).values
    m2s = torch.where(m2 > 0.0, m2, torch.ones_like(m2))
    return u / m2s, norm + om_f + torch.log(m2s[:, 0])


def _fwd_frames(g: BlockSparseGraph, eobs: Tensor, om: Tensor, num_frames: Tensor, carry,
                t0: int, t1: int, save=None):
    """Alpha frames t0..t1-1 from ``carry`` = (ah linear normalised, norm);
    ``save`` = (alphas, norms) buffers get each post-frame (log alpha, norm)
    at t − t0. Returns the carry after t1 − 1."""
    ah, norm = carry
    for t in range(t0, t1):
        u = block_matvec(ah, g, False) * eobs[t][:, g.state_pdf]
        new_ah, new_norm = _renorm(u, norm, om[t])
        active = (t < num_frames)[:, None]
        ah = torch.where(active, new_ah, ah)
        norm = torch.where(active[:, 0], new_norm, norm)
        if save is not None:
            _log_into(ah, save[0][t - t0])
            save[1][t - t0] = norm
    return ah, norm


def _alpha0(g: BlockSparseGraph, b: int, like: Tensor) -> Tensor:
    ah = like.new_zeros(b, g.num_padded)
    ah[:, g.start] = 1.0
    return ah


def _segments(g: BlockSparseGraph, t_len: int):
    return [(s, min(s + g.seg_len, t_len)) for s in range(0, t_len, g.seg_len)]


@torch.no_grad()
def _logz_fwd_block(obs: Tensor, g: BlockSparseGraph, num_frames: Tensor):
    """→ (logz [B], saved): saved is ("full", alphas [T,B,Sp] log, norms
    [T,B]) or ("remat", [entry carry of each segment])."""
    b, t_len, _ = obs.shape
    eobs, om = _exp_obs_tm(obs)
    carry = (_alpha0(g, b, obs), obs.new_zeros(b))
    if _full_save(g, b, t_len):
        alphas = obs.new_empty(t_len, b, g.num_padded)
        norms = obs.new_empty(t_len, b)
        carry = _fwd_frames(g, eobs, om, num_frames, carry, 0, t_len, (alphas, norms))
        saved = ("full", alphas, norms)
    else:
        entries = []
        for t0, t1 in _segments(g, t_len):
            entries.append(carry)
            carry = _fwd_frames(g, eobs, om, num_frames, carry, t0, t1)
        saved = ("remat", entries)
    ah_T, norm_T = carry
    total = torch.clamp(log_safe(ah_T) + g.final, min=NEG_INF)
    return torch.logsumexp(total, dim=1) + norm_T, saved


def _beta0(g: BlockSparseGraph, b: int):
    """Linear normalised beta after the last frame, and its log normaliser."""
    bm0 = g.final.max()
    bm0 = torch.where(bm0 > 0.5 * NEG_INF, bm0, torch.zeros_like(bm0))
    bh = torch.exp(torch.clamp(g.final - bm0, min=NEG_INF)).expand(b, g.num_padded)
    return bh, bm0.expand(b).clone()




def _saved_frames(g: BlockSparseGraph, om: Tensor, saved, fwd, histories: int):
    """Yield (t0, t1, history buffers) per stretch of frames, last stretch
    first: the whole saved history in full-save mode, or each segment
    recomputed from its entry carry by ``fwd(carry, t0, t1, save)`` in remat
    mode. The buffers are ``histories`` [*, B, Sp] tensors and the norms."""
    t_len, b = om.shape
    if saved[0] == "full":
        yield 0, t_len, saved[1:]
        return
    bufs = tuple(om.new_empty(g.seg_len, b, g.num_padded) for _ in range(histories))
    bufs += (om.new_empty(g.seg_len, b),)
    for (t0, t1), entry in reversed(list(zip(_segments(g, t_len), saved[1]))):
        fwd(entry, t0, t1, bufs)
        yield t0, t1, bufs


@torch.no_grad()
def _occupancies_block(obs: Tensor, g: BlockSparseGraph, num_frames: Tensor, logz: Tensor,
                       saved) -> Tensor:
    """gamma [B, T, P]: beta backwards over the saved (or recomputed) alphas."""
    b, t_len, p_dim = obs.shape
    eobs, om = _exp_obs_tm(obs)
    bh, bnorm = _beta0(g, b)
    gamma = obs.new_zeros(t_len, b, p_dim)

    def fwd(carry, t0, t1, save):
        _fwd_frames(g, eobs, om, num_frames, carry, t0, t1, save)

    for t0, t1, (alphas, anorms) in _saved_frames(g, om, saved, fwd, 1):
        for t in range(t1 - 1, t0 - 1, -1):
            active = (t < num_frames)[:, None]
            log_gamma = (alphas[t - t0] + anorms[t - t0][:, None] + log_safe(bh)
                         + bnorm[:, None] - logz[:, None])
            gamma_s = torch.where(active, torch.exp(torch.clamp(log_gamma, max=0.0)),
                                  torch.zeros_like(log_gamma))
            gamma[t].index_add_(1, g.state_pdf, gamma_s)
            new_bh, new_bnorm = _renorm(block_matvec(bh * eobs[t][:, g.state_pdf], g, True),
                                        bnorm, om[t])
            bh = torch.where(active, new_bh, bh)
            bnorm = torch.where(active[:, 0], new_bnorm, bnorm)
    return gamma.transpose(0, 1)


class _BlockLogz(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graph, num_frames):
        logz, saved = _logz_fwd_block(obs, graph, num_frames)
        ctx.graph, ctx.saved = graph, saved
        ctx.save_for_backward(obs, num_frames, logz)
        return logz

    @staticmethod
    def backward(ctx, ct):
        obs, num_frames, logz = ctx.saved_tensors
        gamma = _occupancies_block(obs, ctx.graph, num_frames, logz, ctx.saved)
        ctx.saved = None
        return ct[:, None, None] * gamma, None, None


def fsa_logz_block(obs: Tensor, graph: BlockSparseGraph, num_frames: Tensor) -> Tensor:
    """log partition per batch element: [B] (block-sparse recursion); its
    gradient with respect to obs is the pdf occupancy."""
    return _BlockLogz.apply(obs, graph, num_frames)


def fsa_occupancies_block(obs: Tensor, graph: BlockSparseGraph, num_frames: Tensor):
    """(logZ [B], gamma [B, T, P]) without autograd."""
    logz, saved = _logz_fwd_block(obs, graph, num_frames)
    return logz, _occupancies_block(obs, graph, num_frames, logz, saved)


# ---------------------------------------------------------------------------
# Expected accuracy (sMBR / MPE): the fb_dense factorisation (accuracy sits
# on the destination state) with block matvecs over [2B] stacked rows, so
# each frame reads every tile once for the denominator/numerator pair.
# ---------------------------------------------------------------------------


def _smbr_fwd_frames(g: BlockSparseGraph, acc, eobs: Tensor, om: Tensor, num_frames: Tensor,
                     carry, t0: int, t1: int, save=None):
    """sMBR alpha frames t0..t1-1 from carry (ah, ac, norm); ``acc`` =
    (state labels, ref [B, T], level, silence); ``save`` = (alphas, aaccs,
    norms) buffers get each post-frame (log alpha, acc, norm) at t − t0."""
    lab, ref, level, silence = acc
    ah, ac, norm = carry
    b = ah.shape[0]
    for t in range(t0, t1):
        dn = block_matvec(torch.cat([ah, ah * ac], dim=0), g, False)
        denom, numer = dn[:b], dn[b:]
        a_t = frame_accuracy(lab[None, :], ref[:, t][:, None], level, silence)
        new_ac = _acc_ratio(numer, denom) + a_t
        new_ah, new_norm = _renorm(denom * eobs[t][:, g.state_pdf], norm, om[t])
        active = (t < num_frames)[:, None]
        ah = torch.where(active, new_ah, ah)
        ac = torch.where(active, new_ac, ac)
        norm = torch.where(active[:, 0], new_norm, norm)
        if save is not None:
            _log_into(ah, save[0][t - t0])
            save[1][t - t0] = ac
            save[2][t - t0] = norm
    return ah, ac, norm


@torch.no_grad()
def _smbr_fwd_block(obs, g: BlockSparseGraph, ref, num_frames, level, silence):
    """→ (f [B], saved, logz [B]); saved as in ``_logz_fwd_block`` with
    (alphas, aaccs, norms) histories or (ah, ac, norm) segment entries."""
    b, t_len, _ = obs.shape
    acc = (_state_labels(g, level), ref, level, silence)
    eobs, om = _exp_obs_tm(obs)
    carry = (_alpha0(g, b, obs), obs.new_zeros(b, g.num_padded), obs.new_zeros(b))
    if _full_save(g, b, t_len, histories=2):
        hist = (obs.new_empty(t_len, b, g.num_padded), obs.new_empty(t_len, b, g.num_padded),
                obs.new_empty(t_len, b))
        carry = _smbr_fwd_frames(g, acc, eobs, om, num_frames, carry, 0, t_len, hist)
        saved = ("full",) + hist
    else:
        entries = []
        for t0, t1 in _segments(g, t_len):
            entries.append(carry)
            carry = _smbr_fwd_frames(g, acc, eobs, om, num_frames, carry, t0, t1)
        saved = ("remat", entries)
    ah_T, ac_T, norm_T = carry
    total = torch.clamp(log_safe(ah_T) + g.final, min=NEG_INF)
    f = torch.sum(torch.softmax(total, dim=1) * ac_T, dim=1)
    return f, saved, torch.logsumexp(total, dim=1) + norm_T


@torch.no_grad()
def _smbr_bwd_block(obs, g: BlockSparseGraph, ref, num_frames, level, silence, saved, logz,
                    f) -> Tensor:
    """Kaldi's gradient gamma_state·(aacc + bacc − F) summed by pdf: [B, T, P]."""
    b, t_len, p_dim = obs.shape
    acc = (_state_labels(g, level), ref, level, silence)
    lab = acc[0]
    eobs, om = _exp_obs_tm(obs)
    bh, bnorm = _beta0(g, b)
    bacc = obs.new_zeros(b, g.num_padded)
    grad = obs.new_zeros(t_len, b, p_dim)

    def fwd(carry, t0, t1, save):
        _smbr_fwd_frames(g, acc, eobs, om, num_frames, carry, t0, t1, save)

    for t0, t1, (alphas, aaccs, anorms) in _saved_frames(g, om, saved, fwd, 2):
        for t in range(t1 - 1, t0 - 1, -1):
            active = (t < num_frames)[:, None]
            log_gamma = (alphas[t - t0] + anorms[t - t0][:, None] + log_safe(bh)
                         + bnorm[:, None] - logz[:, None])
            gamma_s = torch.where(active, torch.exp(torch.clamp(log_gamma, max=0.0)),
                                  torch.zeros_like(log_gamma))
            grad[t].index_add_(1, g.state_pdf, gamma_s * (aaccs[t - t0] + bacc - f[:, None]))
            a_t = frame_accuracy(lab[None, :], ref[:, t][:, None], level, silence)
            y = bh * eobs[t][:, g.state_pdf]
            dn = block_matvec(torch.cat([y, y * (a_t + bacc)], dim=0), g, True)
            denom, numer = dn[:b], dn[b:]
            new_bacc = _acc_ratio(numer, denom)
            new_bh, new_bnorm = _renorm(denom, bnorm, om[t])
            bh = torch.where(active, new_bh, bh)
            bacc = torch.where(active, new_bacc, bacc)
            bnorm = torch.where(active[:, 0], new_bnorm, bnorm)
    return grad.transpose(0, 1)


class _BlockExpectedAccuracy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graph, ref, num_frames, level, silence):
        f, saved, logz = _smbr_fwd_block(obs, graph, ref, num_frames, level, silence)
        ctx.graph, ctx.level, ctx.silence, ctx.saved = graph, level, silence, saved
        ctx.save_for_backward(obs, ref, num_frames, logz, f)
        return f

    @staticmethod
    def backward(ctx, ct):
        obs, ref, num_frames, logz, f = ctx.saved_tensors
        grad = _smbr_bwd_block(obs, ctx.graph, ref, num_frames, ctx.level, ctx.silence,
                               ctx.saved, logz, f)
        ctx.saved = None
        return ct[:, None, None] * grad, None, None, None, None, None


def fsa_expected_accuracy_block(obs: Tensor, graph: BlockSparseGraph, ref: Tensor,
                                num_frames: Tensor, level: str = "pdf",
                                silence: Optional[SilenceOpts] = None) -> Tensor:
    """E[#correct frames] under the graph posterior: [B] (block form).
    ``silence`` applies Kaldi's MpeVariants silence-phone rules."""
    return _BlockExpectedAccuracy.apply(obs, graph, ref, num_frames, level, silence)
