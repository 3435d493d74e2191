"""HMM topology: per-phone state graphs with pdf-classes and transition probs.

Reference behavior: kaldi/src/hmm/hmm-topology.{h,cc} (SURVEY.md §3.2). A
topology entry is a list of emitting states (plus an implicit final state);
each emitting state has a pdf-class and a transition list. Helpers build the
two standard shapes: 3-state Bakis (Kaldi default) and 1-state chain-style.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


@dataclasses.dataclass
class HmmState:
    pdf_class: int
    # (next_state, prob); next_state == num_states means the final state
    transitions: List[Tuple[int, float]]


@dataclasses.dataclass
class HmmTopology:
    # phone id (1-based, Kaldi convention) → list of emitting states
    entries: Dict[int, List[HmmState]]

    def states_for(self, phone: int) -> List[HmmState]:
        return self.entries[phone]

    def num_pdf_classes(self, phone: int) -> int:
        return 1 + max(s.pdf_class for s in self.entries[phone])

    @staticmethod
    def three_state(phones: Sequence[int], self_loop: float = 0.5) -> "HmmTopology":
        """Kaldi default: 3 emitting states, left-to-right, self-loops."""
        fwd = 1.0 - self_loop
        entries = {}
        for p in phones:
            entries[p] = [
                HmmState(0, [(0, self_loop), (1, fwd)]),
                HmmState(1, [(1, self_loop), (2, fwd)]),
                HmmState(2, [(2, self_loop), (3, fwd)]),
            ]
        return HmmTopology(entries)

    @staticmethod
    def one_state(phones: Sequence[int], self_loop: float = 0.5) -> "HmmTopology":
        """Chain/LF-MMI-style single emitting state per phone."""
        entries = {p: [HmmState(0, [(0, self_loop), (1, 1.0 - self_loop)])] for p in phones}
        return HmmTopology(entries)

    @property
    def phones(self) -> List[int]:
        return sorted(self.entries)
