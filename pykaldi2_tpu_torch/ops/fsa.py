"""Dense arc-table FSAs: the host container of graphs and decoded lattices.

Numpy copy of pykaldi2_tpu/ops/fsa.py (reference behavior: the OpenFst
lattices + lattice-functions.cc machinery pykaldi2 reaches through Kaldi):

  * every arc EMITS exactly one pdf (epsilon-free by construction — the graph
    compiler folds HMM self-loops/transitions into emitting arcs),
  * a path of T frames traverses exactly T arcs, then pays a final weight,
  * arcs are flat int32/float32 arrays (src, dst, pdf, weight).

Graphs are built host-side by pykaldi2_tpu_torch.graph; decoded lattices
come from decode/decoder.py and are packed into frame bands by
ops/fb_lattice.py for the forward-backward on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DenseFsa:
    """Epsilon-free weighted FSA over pdf-ids (host-side container).

    weight: log-prob contribution of the arc (graph score, e.g. LM/transition).
    final: per-state log final weight (-inf = non-final). start is state 0 by
    convention of the graph compiler.
    """

    num_states: int
    src: np.ndarray      # [E] int32
    dst: np.ndarray      # [E] int32
    pdf: np.ndarray      # [E] int32 (>= 0)
    weight: np.ndarray   # [E] float32
    final: np.ndarray    # [S] float32
    start: int = 0
    # optional per-arc phone id (for MPE phone-level accuracy); -1 = unknown
    phone: np.ndarray | None = None
    # optional per-arc output label (word id; 0 = epsilon) for decoding graphs
    olabel: np.ndarray | None = None

    @property
    def num_arcs(self) -> int:
        return int(self.src.shape[0])

    def validate(self):
        e = self.num_arcs
        for name in ("dst", "pdf", "weight"):
            if getattr(self, name).shape[0] != e:
                raise ValueError(f"{name} length mismatch")
        if self.final.shape[0] != self.num_states:
            raise ValueError("final length mismatch")
        if e and (self.src.min() < 0 or self.src.max() >= self.num_states):
            raise ValueError("src out of range")
        if e and (self.dst.min() < 0 or self.dst.max() >= self.num_states):
            raise ValueError("dst out of range")
        if e and self.pdf.min() < 0:
            raise ValueError("epsilon (pdf<0) arcs are not allowed in DenseFsa")
        return self

    def pad_to(self, num_arcs: int, num_states: int | None = None) -> "DenseFsa":
        """Pad arc table (with dead self-loops at a sink) to static sizes."""
        s = self.num_states if num_states is None else num_states
        if s < self.num_states or num_arcs < self.num_arcs:
            raise ValueError("cannot shrink")
        pad_e = num_arcs - self.num_arcs
        if pad_e == 0 and s == self.num_states:
            return self
        # padding arcs: self-loops on a (possibly new) dead state with -inf weight
        dead = min(s - 1, self.num_states)  # reuse last slot if states grew, else last real state
        src = np.concatenate([self.src, np.full(pad_e, dead, np.int32)])
        dst = np.concatenate([self.dst, np.full(pad_e, dead, np.int32)])
        pdf = np.concatenate([self.pdf, np.zeros(pad_e, np.int32)])
        weight = np.concatenate([self.weight, np.full(pad_e, -np.inf, np.float32)])
        final = np.concatenate([self.final, np.full(s - self.num_states, -np.inf, np.float32)])
        phone = None
        if self.phone is not None:
            phone = np.concatenate([self.phone, np.full(pad_e, -1, np.int32)])
        olabel = None
        if self.olabel is not None:
            olabel = np.concatenate([self.olabel, np.zeros(pad_e, np.int32)])
        return DenseFsa(s, src.astype(np.int32), dst.astype(np.int32), pdf.astype(np.int32),
                        weight.astype(np.float32), final.astype(np.float32), self.start,
                        phone, olabel)

    def scale_weights(self, scale: float) -> "DenseFsa":
        return dataclasses.replace(
            self, weight=(self.weight * scale).astype(np.float32),
            final=(self.final * scale).astype(np.float32))


def save_fsa(path: str, fsa: DenseFsa):
    np.savez(path, num_states=fsa.num_states, src=fsa.src, dst=fsa.dst,
             pdf=fsa.pdf, weight=fsa.weight, final=fsa.final, start=fsa.start,
             phone=fsa.phone if fsa.phone is not None else np.zeros(0, np.int32),
             olabel=fsa.olabel if fsa.olabel is not None else np.zeros(0, np.int32))


def load_fsa(path: str) -> DenseFsa:
    z = np.load(path)
    phone = z["phone"] if z["phone"].size else None
    olabel = z["olabel"] if "olabel" in z.files and z["olabel"].size else None
    return DenseFsa(int(z["num_states"]), z["src"], z["dst"], z["pdf"],
                    z["weight"], z["final"], int(z["start"]), phone, olabel).validate()


def linear_chain_fsa(pdf_seq: np.ndarray, weight: float = 0.0) -> DenseFsa:
    """Exact forced-alignment FSA: state t --pdf[t]--> state t+1, final at T.

    This is the numerator 'graph' for MMI with a fixed alignment (the
    reference's num_ali path, SURVEY.md §4.2).
    """
    t = len(pdf_seq)
    src = np.arange(t, dtype=np.int32)
    dst = src + 1
    final = np.full(t + 1, -np.inf, np.float32)
    final[t] = 0.0
    return DenseFsa(t + 1, src, dst, np.asarray(pdf_seq, np.int32),
                    np.full(t, weight, np.float32), final)
