"""Vectorized arc-table FST: numpy arrays instead of per-arc Python objects.

Numpy copy of pykaldi2_tpu/graph/vfst.py: the ``VectorFst`` arc table, its
conversions to and from ``graph/fst.Fst``, its ``.npz`` save/load (so an
HCLG-scale decode graph loads without per-arc Python, ``bin/decode -graph
graph.npz``), and the HCLG-scale algorithms, composition and connection, as
batched numpy passes over CSR arc tables. The composition is the OpenFst
epsilon-forwarding composition ``fst.Fst.compose`` implements, re-expressed
as frontier-at-a-time array ops (np.repeat/searchsorted joins instead of
Python loops). Weights are log-probs (higher = better), matching fst.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from pykaldi2_tpu_torch.graph.fst import EPS, Fst

NEG_INF = -np.inf


@dataclasses.dataclass
class VectorFst:
    """Arc-table FST. Arrays are parallel over arcs; ``final`` over states."""

    num_states: int
    start: int
    src: np.ndarray      # [E] int32
    dst: np.ndarray      # [E] int32
    ilabel: np.ndarray   # [E] int32
    olabel: np.ndarray   # [E] int32
    weight: np.ndarray   # [E] float32 log-prob
    final: np.ndarray    # [N] float32 log-prob, -inf = non-final

    @property
    def num_arcs(self) -> int:
        return int(self.src.shape[0])

    # -- conversions --------------------------------------------------------

    @classmethod
    def from_fst(cls, fst: Fst) -> "VectorFst":
        n = fst.num_states
        src, dst, il, ol, w = [], [], [], [], []
        for s in range(n):
            for a in fst.arcs[s]:
                src.append(s)
                dst.append(a.nextstate)
                il.append(a.ilabel)
                ol.append(a.olabel)
                w.append(a.weight)
        final = np.full(n, NEG_INF, np.float32)
        for s, fw in fst.finals.items():
            final[s] = fw
        return cls(n, fst.start,
                   np.asarray(src, np.int32), np.asarray(dst, np.int32),
                   np.asarray(il, np.int32), np.asarray(ol, np.int32),
                   np.asarray(w, np.float32), final)

    def to_fst(self) -> Fst:
        out = Fst()
        for _ in range(self.num_states):
            out.add_state()
        out.set_start(self.start)
        for e in range(self.num_arcs):
            out.add_arc(int(self.src[e]), int(self.ilabel[e]),
                        int(self.olabel[e]), float(self.weight[e]), int(self.dst[e]))
        for s in np.nonzero(np.isfinite(self.final))[0]:
            out.set_final(int(s), float(self.final[s]))
        return out

    # -- CSR helpers ---------------------------------------------------------

    def _csr_by_src(self) -> Tuple[np.ndarray, np.ndarray]:
        """(order, row_off): arc indices sorted by src + per-state offsets."""
        order = np.argsort(self.src, kind="stable")
        row_off = np.zeros(self.num_states + 1, np.int64)
        np.add.at(row_off, self.src + 1, 1)
        np.cumsum(row_off, out=row_off)
        return order.astype(np.int64), row_off

    # -- algorithms ----------------------------------------------------------

    def connect(self) -> "VectorFst":
        """Trim states not on a start→final path (vectorized reachability)."""
        if self.start < 0 or self.num_states == 0:
            return VectorFst(0, -1, *(np.zeros(0, np.int32),) * 4,
                             np.zeros(0, np.float32), np.zeros(0, np.float32))
        fwd = _reachable(self.num_states, self.src, self.dst, [self.start])
        back = _reachable(self.num_states, self.dst, self.src,
                          np.nonzero(np.isfinite(self.final))[0])
        keep = fwd & back
        if not keep[self.start]:
            return VectorFst(0, -1, *(np.zeros(0, np.int32),) * 4,
                             np.zeros(0, np.float32), np.zeros(0, np.float32))
        remap = np.cumsum(keep) - 1            # old id -> new id where kept
        arc_keep = keep[self.src] & keep[self.dst]
        return VectorFst(
            int(keep.sum()), int(remap[self.start]),
            remap[self.src[arc_keep]].astype(np.int32),
            remap[self.dst[arc_keep]].astype(np.int32),
            self.ilabel[arc_keep].copy(), self.olabel[arc_keep].copy(),
            self.weight[arc_keep].copy(), self.final[keep].copy())

    def compose(self, other: "VectorFst") -> "VectorFst":
        """self ∘ other with epsilon forwarding (semantics of fst.Fst.compose,
        executed as vectorized frontier waves).

        The label join expands, per pair state, whichever side has the
        smaller out-degree and key-joins into the other — so a pair of a
        high-degree lexicon loop with a sparse trigram history costs
        O(min degree + matches), not O(max degree). This is what keeps a
        10k-word L ∘ trigram-G composition at seconds scale.
        """
        if self.start < 0 or other.start < 0:
            return VectorFst(0, -1, *(np.zeros(0, np.int32),) * 4,
                             np.zeros(0, np.float32), np.zeros(0, np.float32))
        n2 = max(other.num_states, 1)

        def _subset_csr(src, n_states, mask):
            """(order, off) CSR over the masked arc subset, sorted by src."""
            idx = np.nonzero(mask)[0]
            order = idx[np.argsort(src[idx], kind="stable")]
            off = np.zeros(n_states + 1, np.int64)
            np.add.at(off, src[idx].astype(np.int64) + 1, 1)
            np.cumsum(off, out=off)
            return order, off

        # side 1 (self): eps-OUTPUT arcs forward side 1; non-eps join on olabel
        eps1_m = self.olabel == EPS
        o1e, off1e = _subset_csr(self.src, self.num_states, eps1_m)
        a1e_dst = self.dst[o1e]
        a1e_il = self.ilabel[o1e]
        a1e_w = self.weight[o1e]

        # ONE shared key base for both sides: per-side bases would let a
        # label >= the other side's base alias into the next state's key
        # range and fabricate matches (round-2 review finding, reproduced)
        K = 1 + max(int(self.olabel.max()) if self.num_arcs else 0,
                    int(other.ilabel.max()) if other.num_arcs else 0)
        KO = KI = K
        ne1 = np.nonzero(~eps1_m)[0]
        k1 = (self.src[ne1].astype(np.int64) * KO
              + self.olabel[ne1].astype(np.int64))
        ord1 = np.argsort(k1, kind="stable")
        ne1 = ne1[ord1]
        k1s = k1[ord1]
        a1_dst = self.dst[ne1]
        a1_il = self.ilabel[ne1]
        a1_ol = self.olabel[ne1]
        a1_w = self.weight[ne1]
        # per-src offsets into the key-sorted non-eps table + degrees
        off1n = np.searchsorted(k1s, np.arange(self.num_states + 1, dtype=np.int64) * KO)
        deg1 = off1n[1:] - off1n[:-1]

        # side 2 (other): eps-INPUT arcs forward side 2; non-eps join on ilabel
        eps2_m = other.ilabel == EPS
        o2e, off2e = _subset_csr(other.src, other.num_states, eps2_m)
        a2e_dst = other.dst[o2e]
        a2e_ol = other.olabel[o2e]
        a2e_w = other.weight[o2e]

        ne2 = np.nonzero(~eps2_m)[0]
        k2 = (other.src[ne2].astype(np.int64) * KI
              + other.ilabel[ne2].astype(np.int64))
        ord2 = np.argsort(k2, kind="stable")
        ne2 = ne2[ord2]
        k2s = k2[ord2]
        b_dst = other.dst[ne2]
        b_il = other.ilabel[ne2]
        b_ol = other.olabel[ne2]
        b_w = other.weight[ne2]
        off2n = np.searchsorted(k2s, np.arange(other.num_states + 1, dtype=np.int64) * KI)
        deg2 = off2n[1:] - off2n[:-1]

        start_pid = np.int64(self.start) * n2 + other.start
        known = np.asarray([start_pid], np.int64)
        frontier = known
        arcs_src, arcs_dst = [], []
        arcs_il, arcs_ol, arcs_w = [], [], []

        while frontier.size:
            s1 = (frontier // n2).astype(np.int64)
            s2 = (frontier % n2).astype(np.int64)

            # (a) side-1 eps-output arcs advance side 1 only
            rep, arc = _expand_ranges(off1e[s1], off1e[s1 + 1])
            ea_src = frontier[rep]
            ea_dst = a1e_dst[arc].astype(np.int64) * n2 + s2[rep]
            ea_il = a1e_il[arc].astype(np.int64)
            ea_ol = np.zeros(arc.shape, np.int64)
            ea_w = a1e_w[arc]

            # (b) matched arcs: expand the smaller side per pair, key-join
            small1 = deg1[s1] <= deg2[s2]
            # b1: expand side-1 arcs, join into side-2 by (s2, olabel)
            i1 = np.nonzero(small1)[0]
            rep, arc = _expand_ranges(off1n[s1[i1]], off1n[s1[i1] + 1])
            key = s2[i1][rep] * KI + a1_ol[arc].astype(np.int64)
            lo = np.searchsorted(k2s, key, side="left")
            hi = np.searchsorted(k2s, key, side="right")
            rep_m, arc2 = _expand_ranges(lo, hi)
            m1_src = frontier[i1][rep][rep_m]
            m1_dst = a1_dst[arc][rep_m].astype(np.int64) * n2 + b_dst[arc2]
            m1_il = a1_il[arc][rep_m].astype(np.int64)
            m1_ol = b_ol[arc2].astype(np.int64)
            m1_w = a1_w[arc][rep_m] + b_w[arc2]
            # b2: expand side-2 arcs, join into side-1 by (s1, ilabel)
            i2 = np.nonzero(~small1)[0]
            rep, arc = _expand_ranges(off2n[s2[i2]], off2n[s2[i2] + 1])
            key = s1[i2][rep] * KO + b_il[arc].astype(np.int64)
            lo = np.searchsorted(k1s, key, side="left")
            hi = np.searchsorted(k1s, key, side="right")
            rep_m, arc1 = _expand_ranges(lo, hi)
            m2_src = frontier[i2][rep][rep_m]
            m2_dst = a1_dst[arc1].astype(np.int64) * n2 + b_dst[arc][rep_m]
            m2_il = a1_il[arc1].astype(np.int64)
            m2_ol = b_ol[arc][rep_m].astype(np.int64)
            m2_w = a1_w[arc1] + b_w[arc][rep_m]

            # (c) side-2 eps-input arcs advance side 2 only
            rep_e, arc_e = _expand_ranges(off2e[s2], off2e[s2 + 1])
            ee_src = frontier[rep_e]
            ee_dst = s1[rep_e] * n2 + a2e_dst[arc_e]
            ee_il = np.zeros(arc_e.shape, np.int64)
            ee_ol = a2e_ol[arc_e].astype(np.int64)
            ee_w = a2e_w[arc_e]

            w_src = np.concatenate([ea_src, m1_src, m2_src, ee_src])
            w_dst = np.concatenate([ea_dst, m1_dst, m2_dst, ee_dst])
            arcs_src.append(w_src)
            arcs_dst.append(w_dst)
            arcs_il.append(np.concatenate([ea_il, m1_il, m2_il, ee_il]))
            arcs_ol.append(np.concatenate([ea_ol, m1_ol, m2_ol, ee_ol]))
            arcs_w.append(np.concatenate([ea_w, m1_w, m2_w, ee_w]))

            cand = np.unique(w_dst)
            new = cand[~np.isin(cand, known, assume_unique=True)]
            known = np.union1d(known, new)
            frontier = new

        all_src = np.concatenate(arcs_src) if arcs_src else np.zeros(0, np.int64)
        all_dst = np.concatenate(arcs_dst) if arcs_dst else np.zeros(0, np.int64)
        out = VectorFst(
            int(known.size), int(np.searchsorted(known, start_pid)),
            np.searchsorted(known, all_src).astype(np.int32),
            np.searchsorted(known, all_dst).astype(np.int32),
            np.concatenate(arcs_il).astype(np.int32) if arcs_il else np.zeros(0, np.int32),
            np.concatenate(arcs_ol).astype(np.int32) if arcs_ol else np.zeros(0, np.int32),
            np.concatenate(arcs_w).astype(np.float32) if arcs_w else np.zeros(0, np.float32),
            (self.final[(known // n2).astype(np.int64)]
             + other.final[(known % n2).astype(np.int64)]).astype(np.float32))
        return out.connect()


    # -- IO -------------------------------------------------------------------

    def save(self, path: str):
        """npz arc-table serialization (HCLG-scale graphs; text IO would be
        minutes-slow at millions of arcs)."""
        np.savez_compressed(
            path, num_states=self.num_states, start=self.start, src=self.src,
            dst=self.dst, ilabel=self.ilabel, olabel=self.olabel,
            weight=self.weight, final=self.final)

    @classmethod
    def load(cls, path: str) -> "VectorFst":
        with np.load(path) as z:
            return cls(int(z["num_states"]), int(z["start"]),
                       z["src"], z["dst"], z["ilabel"], z["olabel"],
                       z["weight"], z["final"])


def _expand_ranges(lo: np.ndarray, hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """For per-row ranges [lo, hi): (row index per element, flat range values).

    The standard CSR gather trick: counts → np.repeat for row ids, and an
    arithmetic ramp for the in-range positions.
    """
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    counts = hi - lo
    total = int(counts.sum())
    rows = np.repeat(np.arange(lo.shape[0], dtype=np.int64), counts)
    if total == 0:
        return rows, np.zeros(0, np.int64)
    starts = np.cumsum(counts) - counts
    ramp = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    return rows, np.repeat(lo, counts) + ramp


def _reachable(n: int, src: np.ndarray, dst: np.ndarray, seeds) -> np.ndarray:
    """Boolean reachability over arcs src→dst from seed states (BFS waves)."""
    seen = np.zeros(n, bool)
    seeds = np.asarray(list(seeds), np.int64)
    if seeds.size == 0:
        return seen
    seen[seeds] = True
    order = np.argsort(src, kind="stable")
    off = np.zeros(n + 1, np.int64)
    np.add.at(off, np.asarray(src, np.int64) + 1, 1)
    np.cumsum(off, out=off)
    sdst = np.asarray(dst, np.int64)[order]
    frontier = seeds
    while frontier.size:
        _, arc = _expand_ranges(off[frontier], off[frontier + 1])
        nxt = np.unique(sdst[arc])
        nxt = nxt[~seen[nxt]]
        seen[nxt] = True
        frontier = nxt
    return seen
