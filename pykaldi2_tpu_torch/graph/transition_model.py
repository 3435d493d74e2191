"""TransitionModel: (phone, hmm-state, pdf) tuples + transition-id mapping.

Reference behavior: kaldi/src/hmm/transition-model.{h,cc} (SURVEY.md §3.2
"Kaldi HMM/transition model"). Provides the tid→pdf / tid→phone lookup arrays
the data and loss layers need (device-resident int32 arrays), transition
probabilities for graph weights, and best-effort binary interchange with
Kaldi ``final.mdl`` files (modern <Tuples> format; uniform topologies).

Conventions match Kaldi: phones are 1-based; transition-ids are 1-based;
pdf-ids are 0-based.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.graph.topology import HmmState, HmmTopology


class TransitionModel:
    """Built from a topology + a (phone, pdf_class)→pdf-id map.

    ``pdf_map`` defaults to context-independent numbering: consecutive pdf-ids
    over sorted (phone, pdf_class).
    """

    def __init__(self, topo: HmmTopology, pdf_map: Optional[Dict[Tuple[int, int], int]] = None):
        self.topo = topo
        if pdf_map is None:
            pdf_map = {}
            nxt = 0
            for p in topo.phones:
                for c in range(topo.num_pdf_classes(p)):
                    pdf_map[(p, c)] = nxt
                    nxt += 1
        self.pdf_map = pdf_map
        # tuples[i] = (phone, hmm_state, pdf) for tuple-index i (0-based)
        tuples: List[Tuple[int, int, int]] = []
        for p in topo.phones:
            for j, st in enumerate(topo.states_for(p)):
                tuples.append((p, j, pdf_map[(p, st.pdf_class)]))
        self._init_from_tuples(tuples)

    @classmethod
    def from_tuples(cls, topo: HmmTopology,
                    tuples: Sequence[Tuple[int, int, int]]) -> "TransitionModel":
        """Build from an explicit (phone, hmm_state, pdf) tuple list.

        Unlike the pdf_map constructor this represents context-DEPENDENT
        models, where one (phone, hmm_state) appears with several pdfs (one
        per tree leaf) — the layout of real Kaldi final.mdl files. The
        tid→pdf/phone lookup arrays are exact; (phone, hmm_state)-keyed
        helpers (``pdf_for``, graph building) use the first matching tuple
        and are only meaningful for CI models.
        """
        self = cls.__new__(cls)
        self.topo = topo
        self.pdf_map = {}
        for (p, j, pdf) in tuples:
            self.pdf_map.setdefault((p, topo.states_for(p)[j].pdf_class), pdf)
        self._init_from_tuples(list(tuples))
        return self

    def _init_from_tuples(self, tuples: List[Tuple[int, int, int]]):
        topo = self.topo
        self.tuples = tuples
        self._tuple_index: Dict[Tuple[int, int], int] = {}
        for i, (p, j, _pdf) in enumerate(tuples):
            self._tuple_index.setdefault((p, j), i)
        # transition-ids: 1-based, ordered by tuple then transition index
        # (matches kaldi/src/hmm/transition-model.cc ComputeDerived)
        self._tid2tuple: List[int] = [0]        # dummy for tid 0
        self._tid2trans: List[int] = [0]
        self._state2tid_offset: Dict[int, int] = {}
        for i, (p, j, _pdf) in enumerate(self.tuples):
            self._state2tid_offset[i] = len(self._tid2tuple)
            for k, _ in enumerate(topo.states_for(p)[j].transitions):
                self._tid2tuple.append(i)
                self._tid2trans.append(k)
        self.num_tids = len(self._tid2tuple) - 1
        self.num_pdfs = 1 + max(pdf for _, _, pdf in self.tuples)
        # log transition probs per tid (1-based; index 0 unused)
        self.log_probs = np.zeros(self.num_tids + 1, np.float32)
        for tid in range(1, self.num_tids + 1):
            p, j, _ = self.tuples[self._tid2tuple[tid]]
            k = self._tid2trans[tid]
            self.log_probs[tid] = np.log(topo.states_for(p)[j].transitions[k][1])

    # -- lookups ----------------------------------------------------------

    def tid_to_pdf_array(self) -> np.ndarray:
        """[num_tids+1] int32; index 0 → -1 (invalid)."""
        out = np.full(self.num_tids + 1, -1, np.int32)
        for tid in range(1, self.num_tids + 1):
            out[tid] = self.tuples[self._tid2tuple[tid]][2]
        return out

    def tid_to_phone_array(self) -> np.ndarray:
        out = np.full(self.num_tids + 1, -1, np.int32)
        for tid in range(1, self.num_tids + 1):
            out[tid] = self.tuples[self._tid2tuple[tid]][0]
        return out

    def tid_is_self_loop_array(self) -> np.ndarray:
        out = np.zeros(self.num_tids + 1, bool)
        for tid in range(1, self.num_tids + 1):
            p, j, _ = self.tuples[self._tid2tuple[tid]]
            k = self._tid2trans[tid]
            out[tid] = self.topo.states_for(p)[j].transitions[k][0] == j
        return out

    def pdf_silence_mask(self, silence_phones: Sequence[int]) -> np.ndarray:
        """[num_pdfs] bool: pdf belongs to a silence phone.

        Stands in for Kaldi's per-transition-id "phone is silence" test
        (kaldi/src/lat/lattice-functions.cc MpeVariants; SURVEY.md:234):
        equivalent whenever silence pdfs are not tree-shared with speech
        phones, which holds for every tree Kaldi recipes build (silence gets
        its own roots). A pdf shared across both is conservatively silence.
        """
        sil = {int(p) for p in silence_phones}
        out = np.zeros(self.num_pdfs, bool)
        for (p, _j, pdf) in self.tuples:
            if p in sil:
                out[pdf] = True
        return out

    def phone_silence_mask(self, silence_phones: Sequence[int]) -> np.ndarray:
        """[max_phone+1] bool: phone id is a silence phone."""
        sil = {int(p) for p in silence_phones}
        out = np.zeros(max(self.topo.phones) + 1, bool)
        for p in self.topo.phones:
            if p in sil:
                out[p] = True
        return out

    def tids_for_state(self, phone: int, hmm_state: int) -> List[int]:
        i = self._tuple_index[(phone, hmm_state)]
        p, j, _ = self.tuples[i]
        off = self._state2tid_offset[i]
        return [off + k for k in range(len(self.topo.states_for(p)[j].transitions))]

    def pdf_for(self, phone: int, hmm_state: int) -> int:
        return self.tuples[self._tuple_index[(phone, hmm_state)]][2]

    def transition(self, phone: int, hmm_state: int, k: int) -> Tuple[int, float, int]:
        """(next_hmm_state, log_prob, tid) for transition k of a state."""
        i = self._tuple_index[(phone, hmm_state)]
        tid = self._state2tid_offset[i] + k
        nxt = self.topo.states_for(phone)[hmm_state].transitions[k][0]
        return nxt, float(self.log_probs[tid]), tid

    # -- Kaldi final.mdl interchange ---------------------------------------

    def write_kaldi(self, path: str):
        """Binary final.mdl-compatible write, real Kaldi HMM layout
        (kaldi/src/hmm/transition-model.cc Write): since forward and
        self-loop pdfs coincide in HMM (non-chain) models, Kaldi writes the
        compact ``<Triples>`` list and one pdf-class per topology state;
        identical topology entries are shared across phones via phone2idx.
        """
        with open(path, "wb") as f:
            f.write(kaldi_io.BINARY_MARKER)
            f.write(b"<TransitionModel> ")
            self._write_topo(f)
            f.write(b"<Triples> ")
            f.write(b"\x04" + struct.pack("<i", len(self.tuples)))
            for (p, j, pdf) in self.tuples:
                f.write(b"\x04" + struct.pack("<i", p))
                f.write(b"\x04" + struct.pack("<i", j))
                f.write(b"\x04" + struct.pack("<i", pdf))
            f.write(b"</Triples> ")
            f.write(b"<LogProbs> ")
            kaldi_io.write_vector(f, self.log_probs.astype(np.float32))
            f.write(b"</LogProbs> ")
            f.write(b"</TransitionModel> ")

    def _write_topo(self, f):
        """kaldi/src/hmm/hmm-topology.cc binary Write, HMM (non-extended)
        format: no -1 sentinel, one pdf-class per state. Entries shared by
        multiple phones are written once and referenced through phone2idx.
        """
        f.write(b"<Topology> ")
        phones = self.topo.phones
        kaldi_io.write_int_vector(f, np.asarray(phones, np.int32))
        # deduplicate identical entries (real Kaldi shares e.g. one 3-state
        # entry across all speech phones)
        entry_keys: Dict[tuple, int] = {}
        entry_of_phone = {}
        entry_list = []
        for p in phones:
            states = self.topo.states_for(p)
            key = tuple((s.pdf_class, tuple(s.transitions)) for s in states)
            if key not in entry_keys:
                entry_keys[key] = len(entry_list)
                entry_list.append(states)
            entry_of_phone[p] = entry_keys[key]
        max_p = max(phones)
        phone2idx = np.full(max_p + 1, -1, np.int32)
        for p in phones:
            phone2idx[p] = entry_of_phone[p]
        kaldi_io.write_int_vector(f, phone2idx)
        f.write(b"\x04" + struct.pack("<i", len(entry_list)))
        for states in entry_list:
            # +1 for the explicit non-emitting final state
            f.write(b"\x04" + struct.pack("<i", len(states) + 1))
            for st in states:
                f.write(b"\x04" + struct.pack("<i", st.pdf_class))
                f.write(b"\x04" + struct.pack("<i", len(st.transitions)))
                for (nxt, prob) in st.transitions:
                    f.write(b"\x04" + struct.pack("<i", nxt))
                    f.write(b"\x04" + struct.pack("<f", prob))
            # final state: kNoPdf pdf-class, no transitions
            f.write(b"\x04" + struct.pack("<i", -1))
            f.write(b"\x04" + struct.pack("<i", 0))
        f.write(b"</Topology> ")

    @classmethod
    def read_kaldi(cls, path: str) -> "TransitionModel":
        """Parse a binary final.mdl written by this class or modern Kaldi."""
        with open(path, "rb") as f:
            if f.read(2) != kaldi_io.BINARY_MARKER:
                raise ValueError("final.mdl must be binary")
            _expect_token(f, "<TransitionModel>")
            topo = cls._read_topo(f)
            tok = _read_token(f)
            tuples = []
            if tok == "<Tuples>":
                # extended (chain-capable) 4-int layout: forward and
                # self-loop pdfs must coincide for the HMM systems we model
                n = _read_int(f)
                for _ in range(n):
                    p = _read_int(f)
                    j = _read_int(f)
                    fwd_pdf = _read_int(f)
                    self_pdf = _read_int(f)
                    if self_pdf != fwd_pdf:
                        raise ValueError(
                            f"tuple ({p},{j}) has forward_pdf {fwd_pdf} != "
                            f"self_loop_pdf {self_pdf} (chain model): not supported")
                    tuples.append((p, j, fwd_pdf))
                _expect_token(f, "</Tuples>")
            elif tok == "<Triples>":
                n = _read_int(f)
                for _ in range(n):
                    tuples.append((_read_int(f), _read_int(f), _read_int(f)))
                _expect_token(f, "</Triples>")
            else:
                raise ValueError(f"unexpected token {tok!r}")
            _expect_token(f, "<LogProbs>")
            log_probs = kaldi_io.read_vector(f)
            _expect_token(f, "</LogProbs>")
        # preserve the file's exact tuple list (CD models have several pdfs
        # per (phone, hmm_state)); transition-id order then matches Kaldi's
        tm = cls.from_tuples(topo, tuples)
        if tm.num_tids != len(log_probs) - 1:
            raise ValueError(
                f"final.mdl LogProbs dim {len(log_probs)} != num tids+1 "
                f"{tm.num_tids + 1}: tuple/topology mismatch")
        tm.log_probs = log_probs.astype(np.float32)
        return tm

    @staticmethod
    def _read_topo(f) -> HmmTopology:
        """kaldi/src/hmm/hmm-topology.cc binary Read: a -1 where the entry
        count belongs signals the extended (chain) format carrying a separate
        self-loop pdf-class per state; plain HMM files carry one pdf-class.
        """
        _expect_token(f, "<Topology>")
        phones = kaldi_io.read_int_vector(f)
        phone2idx = kaldi_io.read_int_vector(f)
        n_entries = _read_int(f)
        extended = n_entries == -1
        if extended:
            n_entries = _read_int(f)
        entry_list = []
        for _ in range(n_entries):
            n_states = _read_int(f)
            states = []
            for j in range(n_states):
                fwd_cls = _read_int(f)
                self_cls = _read_int(f) if extended else fwd_cls
                if fwd_cls >= 0 and self_cls != fwd_cls:
                    raise ValueError(
                        "topology entry with forward_pdf_class != "
                        "self_loop_pdf_class (chain-style): not supported")
                n_trans = _read_int(f)
                trans = [(_read_int(f), _read_float(f)) for _ in range(n_trans)]
                if fwd_cls >= 0:
                    states.append(HmmState(fwd_cls, trans))
            entry_list.append(states)
        _expect_token(f, "</Topology>")
        # real Kaldi shares one entry across many phones (n_entries can be
        # < n_phones): map each phone through phone2idx, NOT positionally
        # (kaldi/src/hmm/hmm-topology.cc layout; ADVICE round 1)
        entries = {}
        for p in phones:
            p = int(p)
            idx = int(phone2idx[p]) if p < len(phone2idx) else -1
            if idx < 0 or idx >= n_entries:
                raise ValueError(f"phone {p} has no topology entry (phone2idx={idx})")
            # copy so per-phone mutation never aliases a shared entry
            entries[p] = [HmmState(s.pdf_class, list(s.transitions)) for s in entry_list[idx]]
        return HmmTopology(entries)


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok.decode()


def _expect_token(f, want: str):
    got = _read_token(f)
    if got != want:
        raise ValueError(f"expected {want!r}, got {got!r}")


def _read_int(f) -> int:
    sz = f.read(1)
    if sz != b"\x04":
        raise ValueError(f"bad int marker {sz!r}")
    return struct.unpack("<i", f.read(4))[0]


def _read_float(f) -> float:
    sz = f.read(1)
    if sz != b"\x04":
        raise ValueError(f"bad float marker {sz!r}")
    return struct.unpack("<f", f.read(4))[0]
