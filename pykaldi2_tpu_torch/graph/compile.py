"""Graph compilers: phone-level FSTs → dense emitting graphs / decoder FSTs.

Copy of the part of pykaldi2_tpu/graph/compile.py that sequence training
and decoding need (reference behavior: Kaldi's mkgraph.sh +
compile-train-graphs): the HMM expansion that emits

  * DenseFsa graphs (every arc emits a pdf) — the LF-MMI-style denominator
    graph from a phone bigram (``make_den_graph``);
  * pdf-labeled FSTs (ilabel = pdf+1, olabel = word) for the host decoder
    (``expand_to_pdf_fst``), e.g. the phone-loop denominator HCLG that
    ``train_se -on_the_fly`` decodes lattices over, and the small word
    decoding graph H∘L∘G (``make_decode_graph``) ``bin/decode`` reads.

HMM expansion convention: an arc *into* an HMM state emits that state's pdf,
so entry arcs emit the first frame of a phone and self-loops emit subsequent
frames; phone-level junction states are collapsed away (product of in/out
ports), leaving a fully emitting graph. Numerator graphs and the HCLG-scale
word-LM graph come with the graph-building slice.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from pykaldi2_tpu_torch.graph.fst import EPS, Fst, make_lexicon_fst
from pykaldi2_tpu_torch.graph.transition_model import TransitionModel
from pykaldi2_tpu_torch.ops.fsa import DenseFsa


def _expand(phone_fst: Fst, tm: TransitionModel, want_olabels: bool):
    """Shared HMM expansion over a phone-level FST (no input-epsilon arcs).

    Returns (states_count, arcs, finals) where arcs are
    (src, dst, pdf, weight, phone, olabel) over emitting states; state 0 is
    start.
    """
    for s in range(phone_fst.num_states):
        for a in phone_fst.arcs[s]:
            if a.ilabel == EPS:
                raise ValueError("phone FST has input epsilons; remove them first")
    # allocate emitting states: per phone arc, one per HMM state
    next_state = 1  # 0 = start
    arc_states: List[List[int]] = []
    for s in range(phone_fst.num_states):
        for a in phone_fst.arcs[s]:
            n = len(tm.topo.states_for(a.ilabel))
            arc_states.append(list(range(next_state, next_state + n)))
            next_state += n

    arcs: List[Tuple[int, int, int, float, int, int]] = []  # src,dst,pdf,w,phone,olabel
    finals: Dict[int, float] = {}

    # ports per junction (phone-fst state):
    #   out-ports: (entry_state, entry_pdf, entry_weight, phone, olabel)
    #   in-ports:  (exit_state, exit_weight)
    out_ports: Dict[int, List[Tuple[int, int, float, int, int]]] = defaultdict(list)
    in_ports: Dict[int, List[Tuple[int, float]]] = defaultdict(list)

    idx = 0
    for s in range(phone_fst.num_states):
        for a in phone_fst.arcs[s]:
            phone = a.ilabel
            states = arc_states[idx]
            idx += 1
            topo_states = tm.topo.states_for(phone)
            # internal transitions
            for j, st in enumerate(topo_states):
                for k, (nxt, _prob) in enumerate(st.transitions):
                    _, logp, _tid = tm.transition(phone, j, k)
                    if nxt < len(topo_states):
                        arcs.append((states[j], states[nxt], tm.pdf_for(phone, nxt),
                                     logp, phone, EPS))
                    else:
                        in_ports[a.nextstate].append((states[j], logp))
            entry_pdf = tm.pdf_for(phone, 0)
            out_ports[s].append((states[0], entry_pdf, a.weight, phone,
                                 a.olabel if want_olabels else EPS))

    # virtual start in-port
    in_ports[phone_fst.start].append((0, 0.0))

    seen_arc = {}
    for junction in range(phone_fst.num_states):
        for (xs, xw) in in_ports.get(junction, ()):  # entering the junction
            for (es, epdf, ew, eph, eol) in out_ports.get(junction, ()):
                key = (xs, es, epdf, eph, eol)
                w = xw + ew
                if key in seen_arc:
                    i = seen_arc[key]
                    old = arcs[i]
                    arcs[i] = old[:3] + (float(np.logaddexp(old[3], w)),) + old[4:]
                else:
                    seen_arc[key] = len(arcs)
                    arcs.append((xs, es, epdf, w, eph, eol))
            if junction in phone_fst.finals:
                wf = xw + phone_fst.finals[junction]
                finals[xs] = float(np.logaddexp(finals.get(xs, -np.inf), wf))
    return next_state, arcs, finals


def _to_dense(num_states, arcs, finals) -> DenseFsa:
    if not arcs:
        raise ValueError("empty graph")
    src = np.array([a[0] for a in arcs], np.int32)
    dst = np.array([a[1] for a in arcs], np.int32)
    pdf = np.array([a[2] for a in arcs], np.int32)
    w = np.array([a[3] for a in arcs], np.float32)
    phone = np.array([a[4] for a in arcs], np.int32)
    olabel = np.array([a[5] for a in arcs], np.int32)
    final = np.full(num_states, -np.inf, np.float32)
    for s, fw in finals.items():
        final[s] = fw
    return DenseFsa(num_states, src, dst, pdf, w, final, 0, phone, olabel).validate()


def expand_to_dense(phone_fst: Fst, tm: TransitionModel, want_olabels: bool = False) -> DenseFsa:
    n, arcs, finals = _expand(phone_fst, tm, want_olabels=want_olabels)
    return _to_dense(n, arcs, finals)


def expand_to_pdf_fst(phone_fst: Fst, tm: TransitionModel) -> Fst:
    """For the host decoder: ilabel = pdf+1 (0 = eps), olabel = word."""
    n, arcs, finals = _expand(phone_fst, tm, want_olabels=True)
    out = Fst()
    for _ in range(n):
        out.add_state()
    out.set_start(0)
    for (s, d, pdf, w, _ph, ol) in arcs:
        out.add_arc(s, pdf + 1, ol, w, d)
    for s, w in finals.items():
        out.set_final(s, w)
    return out


def make_den_graph(tm: TransitionModel, phone_lm: dict) -> DenseFsa:
    """Phone-bigram denominator graph: every phone sequence, LM-weighted."""
    phones = phone_lm["phones"]
    li, lb, lf = phone_lm["log_init"], phone_lm["log_bigram"], phone_lm["log_final"]
    fst = Fst()
    start = fst.add_state()
    fst.set_start(start)
    junction = {p: fst.add_state() for p in phones}
    for p in phones:
        if np.isfinite(li[p]):
            fst.add_arc(start, p, EPS, float(li[p]), junction[p])
    for p in phones:
        for q in phones:
            if np.isfinite(lb[p, q]):
                fst.add_arc(junction[p], q, EPS, float(lb[p, q]), junction[q])
        if np.isfinite(lf[p]):
            fst.set_final(junction[p], float(lf[p]))
    return expand_to_dense(fst, tm)


# ---------------------------------------------------------------------------
# Decoding graph (HCLG-style, CI phones: H ∘ L ∘ G)
# ---------------------------------------------------------------------------


def make_decode_graph(
    tm: TransitionModel,
    lexicon: Dict[str, List[List[int]]],
    word_ids: Dict[str, int],
    grammar: Optional[Fst] = None,
    sil_phone: int = 0,
    sil_prob: float = 0.0,
) -> Fst:
    """pdf-level decoding FST (ilabel=pdf+1, olabel=word id).

    grammar: word acceptor G (e.g. unigram/bigram LM); None → free word loop.
    Small-graph path (fully emitting, junctions collapsed); the word-LM
    scale HCLG builder comes with the graph-building slice.
    """
    lex = make_lexicon_fst(lexicon, word_ids, sil_phone, sil_prob)
    if grammar is None:
        grammar = Fst()
        s = grammar.add_state()
        grammar.set_start(s)
        grammar.set_final(s, 0.0)
        uni = float(np.log(1.0 / max(len(word_ids), 1)))
        for w, wid in word_ids.items():
            grammar.add_arc(s, wid, wid, uni, s)
    phone_fst = lex.compose(grammar).remove_input_epsilons()
    return expand_to_pdf_fst(phone_fst, tm)

