"""Vectorized arc-table FST: numpy arrays instead of per-arc Python objects.

Numpy copy of the part of pykaldi2_tpu/graph/vfst.py that decoding needs:
the ``VectorFst`` arc table, its conversions to and from ``graph/fst.Fst``
and its ``.npz`` save/load, so an HCLG-scale decode graph loads without
per-arc Python (``bin/decode -graph graph.npz``). Weights are log-probs
(higher = better), matching fst.py. The vectorized composition and
connection come with the graph-building slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pykaldi2_tpu_torch.graph.fst import Fst

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
