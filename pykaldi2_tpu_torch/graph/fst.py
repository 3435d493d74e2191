"""Minimal host-side weighted FST (log-prob weights).

Copy of the part of pykaldi2_tpu/graph/fst.py that sequence training needs
(reference behavior: the slice of OpenFst pykaldi2 exercises through graph
construction): mutable construction and OpenFst-compatible text IO.
Weights are **log-probs** (higher = better, additive along paths) — the
negation of OpenFst tropical costs; text IO negates on the way in and out
so ``fstcompile``-style files interoperate. Trimming, composition, epsilon
removal, determinization and minimization come with the decode slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

EPS = 0  # epsilon label, OpenFst convention


@dataclasses.dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float   # log-prob
    nextstate: int


class Fst:
    def __init__(self):
        self.arcs: List[List[Arc]] = []
        self.finals: Dict[int, float] = {}
        self.start: int = -1

    def add_state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def set_start(self, s: int):
        self.start = s

    def set_final(self, s: int, weight: float = 0.0):
        self.finals[s] = weight

    def add_arc(self, s: int, ilabel: int, olabel: int, weight: float, nextstate: int):
        self.arcs[s].append(Arc(ilabel, olabel, weight, nextstate))

    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def write_text(self, path: str):
        """OpenFst text format (costs = −log-prob)."""
        with open(path, "w") as f:
            def emit(s):
                for a in self.arcs[s]:
                    f.write(f"{s} {a.nextstate} {a.ilabel} {a.olabel} {-a.weight:.6f}\n")
                if s in self.finals:
                    f.write(f"{s} {-self.finals[s]:.6f}\n")
            if self.start >= 0:
                emit(self.start)
            for s in range(self.num_states):
                if s != self.start:
                    emit(s)

    @classmethod
    def read_text(cls, path: str) -> "Fst":
        fst = cls()
        first_state = None

        def need(s):
            while fst.num_states <= s:
                fst.add_state()
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) >= 4:
                    s, ns, il, ol = (int(x) for x in parts[:4])
                    w = -float(parts[4]) if len(parts) > 4 else 0.0
                    need(max(s, ns))
                    fst.add_arc(s, il, ol, w, ns)
                else:
                    s = int(parts[0])
                    w = -float(parts[1]) if len(parts) > 1 else 0.0
                    need(s)
                    fst.set_final(s, w)
                if first_state is None:
                    first_state = s
        if first_state is not None:
            fst.set_start(first_state)
        return fst
