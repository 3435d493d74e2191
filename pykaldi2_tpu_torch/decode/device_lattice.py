"""Batched beam-search lattice generation on the card.

Port of pykaldi2_tpu/decode/device_lattice.py. Where the host route ships
[B, T, P] scaled log-likelihoods to the CPU and runs the native lattice
decoder per utterance, this module runs the beam-pruned search for the whole
batch on the device and emits the banded ``ops/fb_lattice.TimeSyncLattice``
there: no device→host copy, no host decode, no host pack, and the lattices
come from the parameters of the same step.

Every frame is dense over the graph's degree-bucketed arc tables:

  pack time:  arcs laid out CSR by DESTINATION state, states split into a
              low in-degree bucket (HMM interiors) and a high one (junction
              entries), each padded to its own width; emissions sit on the
              destination state, so per-arc pdfs are state pdfs.
  per frame:  relax[b,s,d] = alpha[b, in_src[s,d]] + in_w[s,d]
              newalpha     = max_d relax + obs_t[:, state_pdf]
              frontier     = top-K states within ``beam`` of the best
                             (K = max_active)
              links        = the frontier rows' arc scores, kept within
                             ``lattice_beam`` of their destination's best with
                             both ends on emitted slots; one stable sort keeps
                             the best A (overflow drops the worst, counted).

Input-epsilon arcs are folded offline (``eps_mode="fold"``) or closed in
every frame (``"inframe"``: topo-layered eps relaxations, and the link band
extended along eps chains in L age-gated rounds); ``"auto"`` picks inframe
where the graph qualifies.

The frontier (relaxation, eps layers, top K, pruning; decode/frontier.py)
is one launch of kernel K12 a frame on CUDA tensors, and its plain version
on the CPU: its top K and their order are exactly ``lax.top_k``'s (the float
total order, −0.0 below +0.0, ties to the lowest index), at any S. The band
sorts are stable ``torch.sort``s whose payloads follow the
permutation, as the reference's stable multi-operand ``lax.sort``.

On a CUDA device ``DeviceSearch`` captures the T-frame loop once per (B, T,
P, K, A, beams, ``return_olabels``) of its graph as one CUDA graph and
replays it into static buffers: the loop holds no host sync. If the capture
fails the call raises. On the CPU the same loop runs eagerly. Each capture
adds its host seconds to the counter ``search.captures``, each call whose
frames ran through K12 its B × T frames to ``search.frontier``; the spans
``pk2/search.capture``, ``pk2/search.replay`` (a replay or the eager loop)
and ``pk2/search.compact`` (``_compact_band``) mark the calls
(utils/tracing.py).

``banded_to_fsas`` converts the bands to the host decoder's ``(DenseFsa,
frames)`` contract through the native ``banded_trim_extract``
(native/latdec.cc, built by decode/decoder.py); ``_banded_to_fsas_np`` is
the numpy form the tests hold it to. The band is compacted first: valid
links are a per-frame prefix of the A axis, so slicing it to the smallest
128-multiple covering the batch's longest frame drops only padding.

Not carried over: the reference's TPU routes to the same output
(``PK2_DEV_TOPK``'s plain and segment top-K, ``PK2_DEV_SEARCH_MASK8``), its
diagnostic ``PK2_DEV_SEARCH_DEBUG``, the numpy fallback of the epilogue
(``PK2_B2F_NATIVE``) and the switch that turns compaction off
(``PK2_B2F_COMPACT``).
"""

from __future__ import annotations

import itertools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.decode.frontier import frontier, frontier_tables, relax, takes_kernel
from pykaldi2_tpu_torch.graph.fst import EPS, Fst
from pykaldi2_tpu_torch.ops.fb import NEG_INF
from pykaldi2_tpu_torch.ops.fb_lattice import TimeSyncLattice
from pykaldi2_tpu_torch.utils import tracing

Tensor = torch.Tensor
_HALF_NEG = 0.5 * NEG_INF
_TENSORS = ("in_src_lo", "in_w_lo", "in_src_hi", "in_w_hi", "in_ol_lo", "in_ol_hi",
            "state_pdf", "final", "eps_z1", "eps_src_z1", "eps_w_z1", "eps_z2",
            "eps_src_z2", "eps_w_z2", "eps_z3", "eps_src_z3", "eps_w_z3", "eps_out_dst",
            "eps_out_w", "eps0_w")


class DeviceDecodeGraph(NamedTuple):
    """Destination-CSR arc tables and per-state emissions for the search,
    split into two in-degree buckets (states reordered so that the low
    bucket is the prefix [0, s_lo)), plus the in-frame epsilon tables (all
    empty under "fold"). Index tables are int64 tensors, scores fp32; the
    fields after ``eps0_w`` are static Python metadata."""

    in_src_lo: Tensor   # [S1, d_lo] in-arc source state (pad 0)
    in_w_lo: Tensor     # [S1, d_lo] graph score (pad NEG_INF)
    in_src_hi: Tensor   # [S2, d_hi] high-degree bucket (S2 may be 0)
    in_w_hi: Tensor     # [S2, d_hi]
    in_ol_lo: Tensor    # [S1, d_lo] arc word olabel (0 = eps/pad)
    in_ol_hi: Tensor    # [S2, d_hi]
    state_pdf: Tensor   # [S] pdf emitted by arcs INTO the state
    final: Tensor       # [S] log final weight, NEG_INF where non-final
    eps_z1: Tensor      # [Z1] states of the smallest eps in-degree bucket
    eps_src_z1: Tensor  # [Z1, e1] eps in-arc sources (pad 0)
    eps_w_z1: Tensor    # [Z1, e1] (pad NEG_INF)
    eps_z2: Tensor
    eps_src_z2: Tensor
    eps_w_z2: Tensor
    eps_z3: Tensor
    eps_src_z3: Tensor
    eps_w_z3: Tensor
    eps_out_dst: Tensor  # [S, D_out] eps out-arc destinations (pad 0)
    eps_out_w: Tensor    # [S, D_out] (pad NEG_INF)
    eps0_w: Tensor       # [S] best eps-chain weight start→s
    start: int
    num_states: int
    s_lo: int
    d_lo: int
    d_hi: int
    num_pdfs: int        # 1 + max(state_pdf): sizes the sort payload
    has_olabels: bool
    eps_depth: int       # L: longest eps chain (0 = no in-frame eps)
    # per-layer row offsets into the (depth, id)-sorted z tables
    eps_layers_z1: tuple = ()
    eps_layers_z2: tuple = ()
    eps_layers_z3: tuple = ()

    def to(self, device) -> "DeviceDecodeGraph":
        return self._replace(**{k: getattr(self, k).to(device) for k in _TENSORS})


def _eps_dag_depth(S: int, esrc: np.ndarray, edst: np.ndarray):
    """(longest eps-chain length, per-state depth [S]) via Kahn topo order;
    None when cyclic. depth[s] = longest eps chain ENDING at s."""
    order = np.argsort(esrc, kind="stable")
    es, ed = esrc[order], edst[order]
    row_s = np.searchsorted(es, np.arange(S))
    row_e = np.searchsorted(es, np.arange(S) + 1)
    depth = np.zeros(S, np.int64)
    indeg = np.bincount(edst, minlength=S)
    stack = [int(s) for s in range(S) if indeg[s] == 0]
    seen = 0
    while stack:
        s = stack.pop()
        seen += 1
        for d in ed[row_s[s]:row_e[s]]:
            if depth[s] + 1 > depth[d]:
                depth[d] = depth[s] + 1
            indeg[d] -= 1
            if indeg[d] == 0:
                stack.append(int(d))
    if seen != S:
        return None
    return (int(depth.max()) if len(depth) else 0), depth


def _degree_split_tables(items_dst, items_cols, S, fill_vals, n_buckets: int = 2):
    """Compact dst-CSR split into degree buckets: ``n_buckets`` (z, tabs)
    pairs, z the distinct destinations of the bucket, tabs [len(z), width]
    tables of the item columns in item order per destination. The bucket
    bounds minimise the padded slots (brute force over the unique degrees,
    subsampled to 256 candidates)."""
    z, counts = np.unique(items_dst, return_counts=True)
    if not len(z):
        e = [np.zeros((0, 1), c.dtype if hasattr(c, "dtype") else np.int32)
             for c in items_cols]
        return [(np.zeros(0, np.int32), [x.copy() for x in e]) for _ in range(n_buckets)]
    uniq_deg = np.unique(counts)
    counts_sorted = np.sort(counts)

    def slots_for(bounds):
        total, prev = 0, 0
        for t in bounds:
            n = int(np.searchsorted(counts_sorted, t, side="right")
                    - np.searchsorted(counts_sorted, prev, side="right"))
            total += n * int(t)
            prev = t
        return total

    best, best_bounds = None, None
    top = int(counts.max())
    inner = [int(t) for t in uniq_deg if t < top]
    if len(inner) > 256:
        idx = np.unique(np.linspace(0, len(inner) - 1, 256).astype(int))
        inner = [inner[i] for i in idx]
    for r in range(min(n_buckets - 1, len(inner)) + 1):
        for combo in itertools.combinations(inner, r):
            s = slots_for(list(combo) + [top])
            if best is None or s < best:
                best, best_bounds = s, list(combo) + [top]
    bounds = best_bounds + [top] * (n_buckets - len(best_bounds))

    order = np.argsort(items_dst, kind="stable")
    pos_of = {int(s): i for i, s in enumerate(z)}
    didx = np.asarray([pos_of[int(d)] for d in items_dst[order]])
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(items_dst)) - starts[didx]

    def build(sel, width):
        zs = z[sel].astype(np.int32)
        row_of = np.full(len(z), -1, np.int64)
        row_of[np.nonzero(sel)[0]] = np.arange(int(sel.sum()))
        tabs = []
        m = sel[didx]
        for col, fill in zip(items_cols, fill_vals):
            tab = np.full((int(sel.sum()), max(width, 1)), fill, np.asarray(col).dtype)
            tab[row_of[didx[m]], rank[m]] = np.asarray(col)[order][m]
            tabs.append(tab)
        return zs, tabs

    out, prev = [], 0
    for t in bounds:
        sel = (counts > prev) & (counts <= t)
        out.append(build(sel, int(t) if sel.any() else 0))
        prev = t
    return out


def _extract(f: Fst):
    src_, ilab_, olab_, w_, dst_ = [], [], [], [], []
    for s in range(f.num_states):
        for a in f.arcs[s]:
            src_.append(s)
            ilab_.append(a.ilabel)
            olab_.append(a.olabel)
            w_.append(a.weight)
            dst_.append(a.nextstate)
    return (np.asarray(src_, np.int64), np.asarray(ilab_, np.int64),
            np.asarray(olab_, np.int64),
            np.nan_to_num(np.asarray(w_, np.float32), neginf=NEG_INF, posinf=NEG_INF),
            np.asarray(dst_, np.int64))


def _finals(f: Fst, S: int) -> np.ndarray:
    final = np.full(S, NEG_INF, np.float32)
    for s, fw in f.finals.items():
        final[s] = np.float32(np.nan_to_num(fw, neginf=NEG_INF, posinf=NEG_INF))
    return final


def pack_decode_graph(fst: Fst, word_penalty: float = 0.0, max_in_degree: int = 1024,
                      eps_mode: str = "fold", max_eps_depth: int = 8,
                      max_eps_out: int = 16) -> DeviceDecodeGraph:
    """pdf-level decode FST (ilabel = pdf+1, olabel = word) → search tables
    (CPU tensors; move them with ``.to(device)``).

    ``eps_mode``: "fold" folds input-epsilon arcs offline
    (``remove_input_epsilons``); "inframe" keeps them for the in-frame
    closure (an acyclic, olabel-free eps subgraph of depth ≤
    ``max_eps_depth`` and eps out-degree ≤ ``max_eps_out``; raises
    otherwise); "auto" takes inframe where the graph qualifies, else fold.
    ``max_in_degree`` bounds the padded [S, D] tables."""
    if eps_mode not in ("fold", "inframe", "auto"):
        raise ValueError(f"eps_mode={eps_mode!r}")
    start0 = int(fst.start)
    a_src, a_il, a_ol, a_w, a_dst = _extract(fst)
    is_eps = a_il == EPS
    eps_depth = 0
    eps_arcs = (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.float32),)
    S = int(fst.num_states)
    final = _finals(fst, S)
    if is_eps.any():
        esrc, edst, ew = a_src[is_eps], a_dst[is_eps], a_w[is_eps]
        dd = _eps_dag_depth(S, esrc, edst)
        depth, state_depth = dd if dd is not None else (None, None)
        out_deg = int(np.bincount(esrc, minlength=S).max())
        ok_inframe = (depth is not None and depth <= max_eps_depth
                      and out_deg <= max_eps_out and not np.any(a_ol[is_eps]))
        mode = eps_mode if eps_mode != "auto" else ("inframe" if ok_inframe else "fold")
        if mode == "inframe":
            if not ok_inframe:
                raise ValueError(
                    "eps_mode='inframe' needs an acyclic, olabel-free eps "
                    f"subgraph with depth ≤ {max_eps_depth} and out-degree "
                    f"≤ {max_eps_out} (got depth {depth}, out-degree "
                    f"{out_deg}, olabeled {int(np.count_nonzero(a_ol[is_eps]))})")
            eps_depth = depth
            eps_arcs = (esrc, edst, ew)
            # finals stay raw: eps-reached final states become real
            # last-frame lattice nodes with their own finals
            a_src, a_il, a_ol, a_w, a_dst = (x[~is_eps] for x in (a_src, a_il, a_ol, a_w,
                                                                  a_dst))
        else:
            fst2 = fst.remove_input_epsilons()
            S = int(fst2.num_states)
            start0 = int(fst2.start)
            a_src, a_il, a_ol, a_w, a_dst = _extract(fst2)
            final = _finals(fst2, S)
    if np.any(a_il == EPS):
        raise ValueError("decode FST still has epsilon input arcs")
    pdf_arc = (a_il - 1).astype(np.int64)
    state_pdf = np.zeros(S, np.int64)
    state_pdf[a_dst] = pdf_arc
    if np.any(state_pdf[a_dst] != pdf_arc):
        raise ValueError(
            "decode graph violates the destination-emission invariant "
            "(arcs into one state carry different pdfs); the device search "
            "needs compiler-emitted graphs (expand_to_pdf_fst)")
    src = a_src
    dst = a_dst
    w = a_w - np.where(a_ol != 0, np.float32(word_penalty), np.float32(0.0))
    counts = np.bincount(dst, minlength=S)
    d_max = int(counts.max()) if len(counts) else 1
    if d_max > max_in_degree:
        raise ValueError(
            f"graph max in-degree {d_max} exceeds {max_in_degree}; the [S, D] "
            "padded search would be dominated by dead lanes — use the host "
            "decoder for this graph")
    # the low bucket's width minimises S1(t)·t + (S − S1(t))·d_max
    uniq_deg = np.unique(np.maximum(counts, 1))
    slots = [(int((counts <= t).sum()) * int(t) + int((counts > t).sum()) * d_max, int(t))
             for t in uniq_deg]
    _, d_lo = min(slots)
    is_lo = counts <= d_lo
    perm = np.argsort(~is_lo, kind="stable")    # lo states first, order kept
    inv = np.empty(S, np.int64)
    inv[perm] = np.arange(S)
    src, dst = inv[src], inv[dst]
    state_pdf = np.asarray(state_pdf)[perm]
    counts = counts[perm]
    s1 = int(is_lo.sum())
    d_hi = d_max if s1 < S else 0

    order = np.argsort(dst, kind="stable")
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(dst)) - starts[dst[order]]
    in_src_lo = np.zeros((s1, d_lo), np.int32)
    in_w_lo = np.full((s1, d_lo), NEG_INF, np.float32)
    in_src_hi = np.zeros((S - s1, d_hi), np.int32)
    in_w_hi = np.full((S - s1, d_hi), NEG_INF, np.float32)
    ol = a_ol.astype(np.int32)
    in_ol_lo = np.zeros((s1, d_lo), np.int32)
    in_ol_hi = np.zeros((S - s1, d_hi), np.int32)
    ds, rk, ss, ws, ols = dst[order], rank, src[order], w[order], ol[order]
    lo_arc = ds < s1
    in_src_lo[ds[lo_arc], rk[lo_arc]] = ss[lo_arc]
    in_w_lo[ds[lo_arc], rk[lo_arc]] = ws[lo_arc]
    in_ol_lo[ds[lo_arc], rk[lo_arc]] = ols[lo_arc]
    if s1 < S:
        in_src_hi[ds[~lo_arc] - s1, rk[~lo_arc]] = ss[~lo_arc]
        in_w_hi[ds[~lo_arc] - s1, rk[~lo_arc]] = ws[~lo_arc]
        in_ol_hi[ds[~lo_arc] - s1, rk[~lo_arc]] = ols[~lo_arc]
    final = final[perm]

    # in-frame eps tables (empty when eps_depth == 0), three degree buckets,
    # rows sorted by (eps depth, state id) with per-layer offsets: the
    # per-frame closure updates each eps destination once, in topo order
    esrc, edst, ew = eps_arcs
    esrc = inv[esrc] if len(esrc) else esrc.astype(np.int64)
    edst = inv[edst] if len(edst) else edst.astype(np.int64)
    zbuckets = _degree_split_tables(edst, [esrc.astype(np.int32), ew.astype(np.float32)], S,
                                    [0, NEG_INF], n_buckets=3)
    zlay = [(), (), ()]
    if eps_depth:
        sd = state_depth[perm]

        def layer_sort(z, tabs):
            d = sd[z]
            o = np.argsort(d, kind="stable")
            offs = tuple(int(np.searchsorted(d[o], r, side="left"))
                         for r in range(1, eps_depth + 1)) + (len(z),)
            return z[o], [t[o] for t in tabs], offs

        for i, (z, tabs) in enumerate(zbuckets):
            zb, tabs, zlay[i] = layer_sort(z, tabs)
            zbuckets[i] = (zb, tabs)
    (z1, (ez_src1, ez_w1)), (z2, (ez_src2, ez_w2)), (z3, (ez_src3, ez_w3)) = zbuckets
    d_out = int(np.bincount(esrc, minlength=S).max()) if len(esrc) else 0
    eps_out_dst = np.zeros((S, max(d_out, 1) if d_out else 0), np.int32)
    eps_out_w = np.full((S, max(d_out, 1) if d_out else 0), NEG_INF, np.float32)
    if d_out:
        o2 = np.argsort(esrc, kind="stable")
        oc = np.bincount(esrc, minlength=S)
        ost = np.cumsum(oc) - oc
        ork = np.arange(len(esrc)) - ost[esrc[o2]]
        eps_out_dst[esrc[o2], ork] = edst[o2].astype(np.int32)
        eps_out_w[esrc[o2], ork] = ew[o2].astype(np.float32)
    # best eps-chain weight start→s: closes the eps moves before frame 0
    eps0_w = np.full(S, NEG_INF, np.float32)
    eps0_w[int(inv[start0])] = 0.0
    for _ in range(eps_depth):
        cand = eps0_w[esrc] + ew.astype(np.float32)
        np.maximum.at(eps0_w, edst, cand)

    def t(x):
        x = np.asarray(x)
        return torch.from_numpy(x.astype(np.int64) if x.dtype.kind in "iu"
                                else np.ascontiguousarray(x, np.float32))

    return DeviceDecodeGraph(
        in_src_lo=t(in_src_lo), in_w_lo=t(in_w_lo), in_src_hi=t(in_src_hi),
        in_w_hi=t(in_w_hi), in_ol_lo=t(in_ol_lo), in_ol_hi=t(in_ol_hi),
        state_pdf=t(state_pdf), final=t(final),
        eps_z1=t(z1), eps_src_z1=t(ez_src1), eps_w_z1=t(ez_w1),
        eps_z2=t(z2), eps_src_z2=t(ez_src2), eps_w_z2=t(ez_w2),
        eps_z3=t(z3), eps_src_z3=t(ez_src3), eps_w_z3=t(ez_w3),
        eps_out_dst=t(eps_out_dst), eps_out_w=t(eps_out_w), eps0_w=t(eps0_w),
        start=int(inv[start0]), num_states=S, s_lo=s1, d_lo=int(d_lo), d_hi=int(d_hi),
        num_pdfs=int(np.asarray(state_pdf).max()) + 1 if S else 1,
        has_olabels=bool(np.any(ol)), eps_depth=eps_depth,
        eps_layers_z1=zlay[0], eps_layers_z2=zlay[1], eps_layers_z3=zlay[2])


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


def _search_dims(graph: DeviceDecodeGraph, max_active: int, max_arcs: int):
    """(K, A, bits of a frontier position) of a search."""
    K = min(max_active, graph.num_states)
    bound = K * (graph.d_lo + graph.d_hi)
    for _ in range(graph.eps_depth):
        bound = min(bound * (1 + graph.eps_out_dst.shape[1]), 1 << 30)
    bits_k = max((K - 1).bit_length(), 1)
    if (graph.num_pdfs - 1).bit_length() + bits_k > 31:
        raise ValueError(
            f"cannot pack pdf ({graph.num_pdfs}) and max_active ({K}) into one s32 "
            "sort payload; reduce max_active")
    return K, min(max_arcs, bound), bits_k


class _Search:
    """One search configuration: the per-frame body and its output buffers.
    ``run(obs, num_frames)`` fills ``out`` from frames 0..T-1."""

    def __init__(self, g: DeviceDecodeGraph, b: int, t_len: int, dev: torch.device,
                 max_active: int, max_arcs: int, beam: float, lattice_beam: float,
                 return_olabels: bool):
        self.g, self.b, self.t_len = g, b, t_len
        self.beam, self.lattice_beam = float(beam), float(lattice_beam)
        self.return_olabels = return_olabels
        self.K, self.A, self.bits_k = _search_dims(g, max_active, max_arcs)
        K, A = self.K, self.A
        self.S, self.S1 = g.num_states, g.s_lo
        self.S2, self.Dc = self.S - self.S1, g.d_lo + g.d_hi
        self.L = g.eps_depth
        self.tabs = frontier_tables(g)
        self.slot_ids = torch.arange(K, device=dev).expand(b, K)
        self.kpos = torch.arange(K, device=dev)[None, :, None].expand(b, K, self.Dc)
        self.alpha0 = g.eps0_w[None].expand(b, self.S).clone()
        self.slot0 = torch.where(g.eps0_w > _HALF_NEG, 0, -1)[None].expand(b, self.S).clone()
        i32 = dict(dtype=torch.int32, device=dev)
        self.out = {
            "src": torch.zeros(b, t_len, A, **i32), "dst": torch.zeros(b, t_len, A, **i32),
            "pdf": torch.zeros(b, t_len, A, **i32),
            "weight": torch.zeros(b, t_len, A, dtype=torch.float32, device=dev),
            "ol": torch.zeros(b, t_len, A if return_olabels else 0, **i32),
            "idx": torch.zeros(t_len, b, K, dtype=torch.int64, device=dev),
            "vals": torch.zeros(t_len, b, K, dtype=torch.float32, device=dev),
            "dropped": torch.zeros(t_len, b, dtype=torch.int64, device=dev),
        }

    def run(self, obs: Tensor, num_frames: Tensor) -> None:
        alpha, slot_prev = self.alpha0, self.slot0
        for t in range(self.t_len):
            alpha, slot_prev = self.frame(t, obs[:, t], num_frames, alpha, slot_prev)

    def frame(self, t: int, obs_t: Tensor, num_frames: Tensor, alpha: Tensor,
              slot_prev: Tensor):
        g, b, K, A, L = self.g, self.b, self.K, self.A, self.L
        S1, bits_k, beam, lbeam = self.S1, self.bits_k, self.beam, self.lattice_beam
        obs_s, vals, idx, keep_k, emit_k, alpha_next, slot_cur = frontier(
            g, self.tabs, alpha, obs_t, slot_prev, num_frames, t, K, beam, lbeam)
        # link candidates: a second relaxation over the emitted-masked alpha
        alpha_emit = torch.where(slot_prev >= 0, alpha, NEG_INF)
        l_lo, l_hi = relax(g, alpha_emit)
        active = (t < num_frames)[:, None, None]
        lo_m = idx < S1
        idx_lo = torch.where(lo_m, idx, 0)
        # (l + obs)[idx] as l[idx] + obs[idx]: the same sums
        obs_k = obs_s.gather(1, idx)[:, :, None]
        band_lo = l_lo.gather(1, idx_lo[:, :, None].expand(b, K, g.d_lo)) + obs_k
        band_lo = torch.where(lo_m[:, :, None], band_lo, NEG_INF)
        w_band = g.in_w_lo[idx_lo]
        src_band = g.in_src_lo[idx_lo]
        ol_band = g.in_ol_lo[idx_lo] if self.return_olabels else None
        if self.S2:
            idx_hi = torch.where(lo_m, 0, idx - S1)
            band_hi = l_hi.gather(1, idx_hi[:, :, None].expand(b, K, g.d_hi)) + obs_k
            band_hi = torch.where(lo_m[:, :, None], NEG_INF, band_hi)
            link_kd = torch.cat([band_lo, band_hi], dim=2)               # [B, K, Dc]
            w_band = torch.cat([w_band, g.in_w_hi[idx_hi]], dim=2)
            src_band = torch.cat([src_band, g.in_src_hi[idx_hi]], dim=2)
            if self.return_olabels:
                ol_band = torch.cat([ol_band, g.in_ol_hi[idx_hi]], dim=2)
        else:
            link_kd = band_lo
        if L and t == 0:
            # links from eps-reached initial states carry the start→src chain
            w_band = torch.clamp_min(w_band + g.eps0_w[src_band], NEG_INF)
        # under in-frame eps the band also holds expansion carriers within
        # the search beam; the lattice-beam filter re-applies after the rounds
        band_thr = beam if L else lbeam
        band_keep = keep_k if L else emit_k
        keep_kd = ((link_kd >= vals[:, :, None] - band_thr) & (link_kd > _HALF_NEG)
                   & band_keep[:, :, None] & active)
        score_kd = torch.where(keep_kd, link_kd, NEG_INF)
        pdf_k = g.state_pdf[idx]
        pay = (pdf_k[:, :, None] << bits_k) | self.kpos                  # (pdf<<bk)|kpos
        n = K * self.Dc
        skey, perm = torch.sort((-score_kd).reshape(b, n), dim=1, stable=True)
        perm = perm[:, :A]

        def take(x, fill):
            x = x.reshape(b, n).gather(1, perm)
            if A > n:   # eps rounds can outgrow K*Dc
                x = torch.nn.functional.pad(x, (0, A - n), value=fill)
            return x

        score_a = -skey[:, :A]
        if A > n:
            score_a = torch.nn.functional.pad(score_a, (0, A - n), value=NEG_INF)
        pay_a, w_a, src_a = take(pay, 0), take(w_band, NEG_INF), take(src_band, 0)
        ol_a = take(ol_band, 0) if self.return_olabels else None
        dropped_t = torch.clamp_min(keep_kd.sum(dim=(1, 2)) - A, 0)
        pmask = (1 << bits_k) - 1
        if L:
            score_a, pay_a, w_a, src_a, ol_a, dropped_t = self.eps_rounds(
                score_a, pay_a, w_a, src_a, ol_a, dropped_t, idx, vals, keep_k)
        valid = score_a > _HALF_NEG
        k_win = pay_a & pmask
        if L:
            # a link (not an expansion carrier) needs an emitted destination
            # within the per-destination lattice beam
            valid = (valid & emit_k.gather(1, k_win)
                     & (score_a >= vals.gather(1, k_win) - lbeam))
        out = self.out
        out["src"][:, t] = torch.where(valid, slot_prev.gather(1, src_a), 0)
        out["dst"][:, t] = torch.where(valid, k_win, 0)
        out["pdf"][:, t] = torch.where(valid, pay_a >> bits_k, 0)
        out["weight"][:, t] = torch.where(valid, w_a, NEG_INF)
        if self.return_olabels:
            out["ol"][:, t] = torch.where(valid, ol_a, 0)
        out["idx"][t] = idx
        out["vals"][t] = vals
        out["dropped"][t] = dropped_t
        return alpha_next, slot_cur

    def eps_rounds(self, score_a, pay_a, w_a, src_a, ol_a, dropped_t, idx, vals, keep_k):
        """The in-frame eps rounds on the band: each link whose destination
        has eps out-arcs spawns folded links to the eps destinations (weight
        accumulates; pdf, source and olabel ride along); an entry spawned in
        round r expands only in round r+1. One sort per round caps at A."""
        g, b, A, bits_k, beam = self.g, self.b, self.A, self.bits_k, self.beam
        pmask = (1 << bits_k) - 1
        dstst = torch.where(score_a > _HALF_NEG, idx.gather(1, pay_a & pmask), 0)
        d_out = g.eps_out_dst.shape[1]
        slot_keep = torch.full((b, self.S), -1, dtype=torch.int64, device=idx.device)
        slot_keep = slot_keep.scatter_reduce(1, idx, torch.where(keep_k, self.slot_ids, -1),
                                             "amax")
        age_a = torch.zeros_like(pay_a)
        for r in range(self.L):
            va = (score_a > _HALF_NEG) & (age_a == r)
            cdst = g.eps_out_dst[dstst]                                  # [B, A, Do]
            cw_eps = g.eps_out_w[dstst]
            cscore = torch.where(va[:, :, None], score_a[:, :, None] + cw_eps, NEG_INF)
            cslot = slot_keep.gather(1, cdst.reshape(b, A * d_out)).view(b, A, d_out)
            calpha = vals.gather(1, cslot.clamp_min(0).view(b, A * d_out)).view(b, A, d_out)
            ok = (cslot >= 0) & (cscore >= calpha - beam)
            cscore = torch.where(ok, cscore, NEG_INF)
            cpay = ((pay_a[:, :, None] >> bits_k) << bits_k) | cslot.clamp_min(0)
            cw = torch.where(ok, w_a[:, :, None] + cw_eps, NEG_INF)

            def cat(a0, c):
                return torch.cat([a0, c.reshape(b, A * d_out)], dim=1)

            def spread(x):
                return x[:, :, None].expand(b, A, d_out)

            ops2 = [cat(pay_a, cpay), cat(w_a, cw), cat(src_a, spread(src_a)),
                    cat(age_a, torch.full_like(cpay, r + 1))]
            if self.return_olabels:
                ops2.append(cat(ol_a, spread(ol_a)))
            ops2.append(cat(dstst, cdst))
            skey, perm = torch.sort(cat(-score_a, -cscore), dim=1, stable=True)
            n_valid = (-skey > _HALF_NEG).sum(dim=1)
            dropped_t = dropped_t + torch.clamp_min(n_valid - A, 0)
            perm = perm[:, :A]
            score_a = -skey[:, :A]
            sorted2 = [x.gather(1, perm) for x in ops2]
            pay_a, w_a, src_a, age_a = sorted2[:4]
            if self.return_olabels:
                ol_a = sorted2[4]
            dstst = sorted2[-1]
        return score_a, pay_a, w_a, src_a, ol_a, dropped_t

    def finish(self, num_frames: Tensor):
        """(TimeSyncLattice, scores [B], dropped [B], olabels [B, T, A]) from
        the frame outputs: the finals and best scores of each utterance's
        last active frontier (nf == 0: the start token at slot 0)."""
        g, b, K, out = self.g, self.b, self.K, self.out
        beam, lbeam = self.beam, self.lattice_beam
        last_t = torch.clamp_min(num_frames - 1, 0).long()
        has_frames = (num_frames > 0)[:, None]
        bsel = torch.arange(b, device=last_t.device)
        start_vals = torch.full((b, K), NEG_INF, device=last_t.device)
        start_vals[:, 0] = 0.0
        vals_T = torch.where(has_frames, out["vals"][last_t, bsel], start_vals)
        idx_T = torch.where(has_frames, out["idx"][last_t, bsel], g.start)
        best_T = vals_T.amax(dim=1)
        keep_T = (vals_T >= best_T[:, None] - beam) & (vals_T > _HALF_NEG)
        emit_T = keep_T & (vals_T >= best_T[:, None] - lbeam)
        slot_alpha = torch.where(keep_T, vals_T, NEG_INF)
        final_slots = torch.where(keep_T, g.final[idx_T], NEG_INF)
        # host-decoder semantics: best = max(alpha + final) over the search
        # tokens, else max(alpha); emitted end slots carry the finals, all 0
        # when none of them is final
        with_final = slot_alpha + final_slots
        wf_max = with_final.amax(dim=1)
        scores = torch.where(wf_max > _HALF_NEG, wf_max, slot_alpha.amax(dim=1))
        emit_final = torch.where(emit_T, final_slots, NEG_INF)
        emit_has_final = emit_final.amax(dim=1) > _HALF_NEG
        final_out = torch.where(emit_has_final[:, None], emit_final,
                                torch.where(emit_T, 0.0, NEG_INF))
        lat = TimeSyncLattice(src=out["src"], dst=out["dst"], pdf=out["pdf"],
                              weight=out["weight"], final=final_out)
        return lat, scores, out["dropped"].sum(dim=0).to(torch.int32), out["ol"]


class _Captured:
    """A ``_Search`` captured as one CUDA graph, with static inputs. The
    capture is thread-local (another thread's unrelated CUDA calls do not
    invalidate it); the CLIs still move batches to the device on the
    capturing thread (``data.prefetch.device_batches``)."""

    def __init__(self, search: _Search, obs: Tensor, num_frames: Tensor):
        self.search = search  # the graph reads its tensors (alpha0, slot0, out)
        self.obs = obs.clone()
        self.nf = num_frames.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up the frame body's kernels
            a, s = search.alpha0, search.slot0
            for t in range(min(2, search.t_len)):
                a, s = search.frame(t, self.obs[:, t], self.nf, a, s)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            search.run(self.obs, self.nf)
            self.result = search.finish(self.nf)

    def replay(self, obs: Tensor, num_frames: Tensor):
        self.obs.copy_(obs)
        self.nf.copy_(num_frames)
        self.graph.replay()
        return self.result


class DeviceSearch:
    """Beam searches over one graph. On CUDA tensors each configuration
    (B, T, P, K, A, beams, ``return_olabels``) is captured on first use as
    one CUDA graph and replayed after; the captures live as long as this
    object."""

    def __init__(self, graph: DeviceDecodeGraph):
        self.graph = graph
        self._captured: dict = {}

    def __call__(self, obs: Tensor, num_frames: Tensor, *, max_active: int = 256,
                 max_arcs: int = 1024, beam: float = 16.0, lattice_beam: float = 8.0,
                 return_olabels: bool = False, capture: Optional[bool] = None):
        """Batched beam search → (TimeSyncLattice, best scores [B], dropped
        [B]), plus the links' word olabels [B, T, A] as a 4th element with
        ``return_olabels``.

        obs [B, T, P]: acoustic-scaled scores (the matrix the lattice FB will
        consume), on the graph's device; gradients do not flow (the SE loss
        refolds obs through the lattice's pdfs). Slots are frontier positions
        (K = min(max_active, S)), A = max_arcs links a frame; ``dropped``
        counts the band entries cut to A (the worst ones; under in-frame eps a
        conservative count, since it includes expansion carriers).

        ``capture`` (default: on CUDA tensors) replays the captured CUDA
        graph of this configuration; ``False`` runs the same loop eagerly.
        The outputs are fresh tensors on obs's device."""
        graph = self.graph
        b, t_len, p = obs.shape
        if return_olabels and not graph.has_olabels:
            raise ValueError("return_olabels=True needs a graph packed with word olabels "
                             "(pack_decode_graph of an FST whose arcs carry nonzero output "
                             "labels)")
        if capture is None:
            capture = obs.device.type == "cuda"
        if capture and obs.device.type != "cuda":
            raise ValueError("capture needs CUDA tensors")
        obs = obs.detach().to(torch.float32).contiguous()
        num_frames = num_frames.to(obs.device, torch.int64)
        conf = (int(max_active), int(max_arcs), float(beam), float(lattice_beam),
                bool(return_olabels))
        with torch.no_grad():
            if not capture:
                with tracing.span("pk2/search.replay"):
                    search = _Search(graph, b, t_len, obs.device, *conf)
                    search.run(obs, num_frames)
                    lat, scores, dropped, ol = search.finish(num_frames)
            else:
                key = (b, t_len, p, str(obs.device)) + conf
                captured = self._captured.get(key)
                if captured is None:
                    with tracing.span("pk2/search.capture"):
                        t0 = time.perf_counter()
                        captured = _Captured(_Search(graph, b, t_len, obs.device, *conf), obs,
                                             num_frames)
                        torch.cuda.synchronize(obs.device)
                        self._captured[key] = captured
                        tracing.count("search.captures", time.perf_counter() - t0)
                with tracing.span("pk2/search.replay"):
                    lat, scores, dropped, ol = captured.replay(obs, num_frames)
                    lat = TimeSyncLattice(*(x.clone() for x in lat))
                    scores, dropped, ol = scores.clone(), dropped.clone(), ol.clone()
        if takes_kernel(obs.device):
            tracing.count("search.frontier", b * t_len)
        if return_olabels:
            return lat, scores, dropped, ol
        return lat, scores, dropped


def device_lattice_generate(obs: Tensor, graph: DeviceDecodeGraph, num_frames: Tensor,
                            **kw):
    """One ``DeviceSearch(graph)(obs, num_frames, **kw)`` (the reference's
    function; a capture made here is not kept for another call)."""
    return DeviceSearch(graph)(obs, num_frames, **kw)


# ---------------------------------------------------------------------------
# banded lattices → per-utterance FSAs
# ---------------------------------------------------------------------------


def banded_to_fsas(lat: TimeSyncLattice, num_frames, olabels=None):
    """Banded lattices → per-utterance ``(DenseFsa, frames)`` pairs, the
    host decoder's ``decode_lattice(with_frames=True)`` contract (state 0 at
    frame 0, ``frames[dst] == frames[src] + 1``, graph-score weights), so
    N-best, oracle, MBR and LM-scale sweeps take device lattices unchanged.
    States that cannot reach a final state are trimmed. The band is
    compacted on the device first; the conversion is the native
    ``banded_trim_extract`` (its build or load errors are raised)."""
    lat, olabels = _compact_band(lat, olabels)
    return _banded_to_fsas_native(lat, num_frames, olabels)


def _compact_band(lat: TimeSyncLattice, olabels, min_a: int = 128):
    """Slice the band (A) axis to the smallest 128-multiple covering every
    frame's valid-link count. Valid links are a per-frame prefix (they leave
    the band sort best first, padding last), so only NEG_INF padding goes and
    the lattice is unchanged. Costs one scalar device sync."""
    with tracing.span("pk2/search.compact"):
        a_dim = lat.src.shape[2]
        if a_dim <= min_a:
            return lat, olabels
        w = torch.as_tensor(lat.weight)
        m = int((w > _HALF_NEG).sum(dim=2).max()) if w.numel() else 0
        bucket = max(min_a, -(-max(m, 1) // 128) * 128)
        if bucket >= a_dim:
            return lat, olabels
        lat2 = TimeSyncLattice(*(torch.as_tensor(x)[:, :, :bucket] for x in lat[:4]),
                               final=torch.as_tensor(lat.final))
        return lat2, None if olabels is None else torch.as_tensor(olabels)[:, :, :bucket]


def _host(x, dtype) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype)


def _banded_to_fsas_native(lat: TimeSyncLattice, num_frames, olabels=None):
    """C-pass epilogue (native/latdec.cc ``banded_trim_extract``);
    bit-identical to ``_banded_to_fsas_np``."""
    import ctypes

    from pykaldi2_tpu_torch.decode.decoder import _fptr, _iptr, _load
    from pykaldi2_tpu_torch.ops.fsa import DenseFsa

    lib = _load()
    src_all = _host(lat.src, np.int32)
    dst_all = _host(lat.dst, np.int32)
    pdf_all = _host(lat.pdf, np.int32)
    w_all = _host(lat.weight, np.float32)
    fin_all = _host(lat.final, np.float32)
    ol_all = None if olabels is None else _host(olabels, np.int32)
    nf_all = np.ascontiguousarray(np.clip(_host(num_frames, np.int64), 0, None)
                                  .astype(np.int32))
    b, t_dim, a_dim = src_all.shape
    k = fin_all.shape[1]
    n_states = np.zeros(b, np.int32)
    n_arcs = np.zeros(b, np.int32)
    cap = t_dim * a_dim
    out_src = np.empty((b, cap), np.int32)
    out_dst = np.empty((b, cap), np.int32)
    out_pdf = np.empty((b, cap), np.int32)
    out_w = np.empty((b, cap), np.float32)
    out_ol = None if ol_all is None else np.empty((b, cap), np.int32)
    out_frames = np.empty((b, (t_dim + 1) * k), np.int32)
    out_final_sid = np.empty((b, k), np.int32)
    null_i = ctypes.POINTER(ctypes.c_int)()
    rc = lib.banded_trim_extract(
        b, t_dim, a_dim, k, _iptr(src_all), _iptr(dst_all), _iptr(pdf_all), _fptr(w_all),
        null_i if ol_all is None else _iptr(ol_all), _fptr(fin_all), _iptr(nf_all),
        ctypes.c_float(_HALF_NEG), _iptr(n_states), _iptr(n_arcs), _iptr(out_src),
        _iptr(out_dst), _iptr(out_pdf), _fptr(out_w),
        null_i if out_ol is None else _iptr(out_ol), _iptr(out_frames),
        _iptr(out_final_sid))
    if rc != 0:
        raise RuntimeError(f"banded_trim_extract failed (rc={rc})")
    out = []
    empty_i32 = np.zeros(0, np.int32)
    for i in range(b):
        nf = int(nf_all[i])
        if nf <= 0:
            fsa = DenseFsa(1, empty_i32, empty_i32, empty_i32, np.zeros(0, np.float32),
                           np.zeros(1, np.float32), 0, None,
                           None if ol_all is None else empty_i32)
            out.append((fsa, np.zeros(1, np.int64)))
            continue
        ns, na = int(n_states[i]), int(n_arcs[i])
        final = np.full(ns, -np.inf, np.float32)
        last_sid = out_final_sid[i]
        last = np.nonzero(last_sid >= 0)[0]
        # NEG_INF sentinels become true -inf: downstream any finite value
        # is a real final
        fv = fin_all[i, last]
        final[last_sid[last]] = np.where(fv > _HALF_NEG, fv, -np.inf)
        fsa = DenseFsa(ns, out_src[i, :na].copy(), out_dst[i, :na].copy(),
                       out_pdf[i, :na].copy(), out_w[i, :na].copy(), final, 0, None,
                       None if out_ol is None else out_ol[i, :na].copy())
        out.append((fsa.validate(), out_frames[i, :ns].astype(np.int64)))
    return out


def _banded_to_fsas_np(lat: TimeSyncLattice, num_frames, olabels=None):
    """Numpy epilogue: the reference the native pass is held to."""
    from pykaldi2_tpu_torch.ops.fsa import DenseFsa

    src_all = _host(lat.src, np.int64)
    dst_all = _host(lat.dst, np.int64)
    pdf_all = _host(lat.pdf, np.int32)
    w_all = _host(lat.weight, np.float32)
    fin_all = _host(lat.final, np.float32)
    ol_all = None if olabels is None else _host(olabels, np.int32)
    b, t_dim, a_dim = src_all.shape
    k = fin_all.shape[1]
    nf_all = np.clip(_host(num_frames, np.int64), 0, t_dim)
    t_act = np.arange(t_dim)[None, :, None] < nf_all[:, None, None]
    valid = (w_all > _HALF_NEG) & t_act                            # [B, T, A]
    base_bt = ((np.arange(b, dtype=np.int64)[:, None, None] * (t_dim + 1)
                + np.arange(t_dim, dtype=np.int64)[None, :, None]) * k)
    src_flat = base_bt + src_all
    dst_flat = base_bt + k + dst_all
    # forward liveness: one flat scatter over [B, T+1, K]
    live = np.zeros((b, t_dim + 1, k), bool)
    live[:, 0, 0] = True
    live.reshape(-1)[dst_flat[valid]] = True
    # backward trim, batched over utterances
    alive = np.zeros((b, t_dim + 1, k), bool)
    is_fin = fin_all > _HALF_NEG
    alive[np.arange(b), nf_all] = live[np.arange(b), nf_all] & is_fin
    bcol = np.arange(b)[:, None]
    bmat = np.broadcast_to(bcol, (b, a_dim))
    for t in range(t_dim - 1, -1, -1):
        v = valid[:, t] & alive[:, t + 1][bcol, dst_all[:, t]]
        alive[bmat[v], t, src_all[:, t][v]] = True
    alive &= live
    # utterances whose every final-reaching path was cut: forward liveness
    degen = ~alive[:, 0, 0]
    if degen.any():
        alive[degen] = live[degen]
    t_keep = np.arange(t_dim + 1)[None, :, None] <= nf_all[:, None, None]
    alive &= t_keep
    flat_alive = alive.reshape(b, -1)
    sid = flat_alive.cumsum(axis=1, dtype=np.int64) - 1
    n_states = flat_alive.sum(axis=1)
    sid = sid.reshape(b, t_dim + 1, k)
    alive_flat = alive.reshape(-1)
    keep = valid & np.take(alive_flat, src_flat) & np.take(alive_flat, dst_flat)
    e_flat = np.flatnonzero(keep)
    e_b = e_flat // (t_dim * a_dim)
    splits = np.searchsorted(e_b, np.arange(1, b))
    sid_flat = sid.reshape(-1)
    fsa_src = np.take(sid_flat, np.take(src_flat.reshape(-1), e_flat)).astype(np.int32)
    fsa_dst = np.take(sid_flat, np.take(dst_flat.reshape(-1), e_flat)).astype(np.int32)
    e_pdf = np.take(pdf_all.reshape(-1), e_flat).astype(np.int32, copy=False)
    e_w = np.take(w_all.reshape(-1), e_flat).astype(np.float32, copy=False)
    e_ol = (None if ol_all is None
            else np.take(ol_all.reshape(-1), e_flat).astype(np.int32, copy=False))
    frames_grid = np.broadcast_to(np.arange(t_dim + 1)[None, :, None], alive.shape)
    out = []
    empty_i32 = np.zeros(0, np.int32)
    for i, (s0, s1) in enumerate(zip(np.concatenate([[0], splits]),
                                     np.concatenate([splits, [len(e_b)]]))):
        nf = int(nf_all[i])
        if nf <= 0:
            fsa = DenseFsa(1, empty_i32, empty_i32, empty_i32, np.zeros(0, np.float32),
                           np.zeros(1, np.float32), 0, None,
                           None if ol_all is None else empty_i32)
            out.append((fsa, np.zeros(1, np.int64)))
            continue
        frames = frames_grid[i][alive[i]]
        ns = int(n_states[i])
        final = np.full(ns, -np.inf, np.float32)
        last = np.nonzero(alive[i, nf])[0]
        fv = fin_all[i, last]
        final[sid[i, nf, last]] = np.where(fv > _HALF_NEG, fv, -np.inf)
        fsa = DenseFsa(ns, fsa_src[s0:s1], fsa_dst[s0:s1], e_pdf[s0:s1], e_w[s0:s1],
                       final, 0, None, None if ol_all is None else e_ol[s0:s1])
        out.append((fsa.validate(), frames))
    return out
