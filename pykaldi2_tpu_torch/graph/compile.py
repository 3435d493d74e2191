"""Graph compilers: phone-level FSTs → dense emitting graphs / decoder FSTs.

Numpy copy of pykaldi2_tpu/graph/compile.py (reference behavior: Kaldi's
mkgraph.sh + compile-train-graphs). Builders that emit

  * DenseFsa graphs (every arc emits a pdf) for the forward-backward and
    Viterbi recursions — numerator graphs from transcripts or phone
    sequences (``make_num_graph``, ``make_linear_num_graph``; forced
    alignment), the LF-MMI-style denominator graph from a phone bigram
    (``make_den_graph``);
  * pdf-labeled FSTs (ilabel = pdf+1, olabel = word) for the host decoder
    (``expand_to_pdf_fst``), e.g. the phone-loop denominator HCLG that
    ``train_se -on_the_fly`` decodes lattices over, the small word decoding
    graph H∘L∘G (``make_decode_graph``), and the HCLG-scale graph against an
    ARPA word LM (``make_word_decode_graph``, vectorized over ``VectorFst``).

HMM expansion convention: an arc *into* an HMM state emits that state's pdf,
so entry arcs emit the first frame of a phone and self-loops emit subsequent
frames; phone-level junction states are collapsed away (product of in/out
ports), leaving a fully emitting graph (``expand_to_pdf_vfst`` keeps them as
epsilon junctions instead, for the decoder).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pykaldi2_tpu_torch.graph.fst import EPS, Fst, linear_acceptor, make_lexicon_fst
from pykaldi2_tpu_torch.graph.transition_model import TransitionModel
from pykaldi2_tpu_torch.ops.fsa import DenseFsa


def _logaddexp(a, b):
    return np.logaddexp(a, b)


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
                    arcs[i] = old[:3] + (float(_logaddexp(old[3], w)),) + old[4:]
                else:
                    seen_arc[key] = len(arcs)
                    arcs.append((xs, es, epdf, w, eph, eol))
            if junction in phone_fst.finals:
                wf = xw + phone_fst.finals[junction]
                finals[xs] = float(_logaddexp(finals.get(xs, -np.inf), wf))
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


# ---------------------------------------------------------------------------
# Numerator graphs
# ---------------------------------------------------------------------------


def make_linear_num_graph(tm: TransitionModel, phone_seq: Sequence[int]) -> DenseFsa:
    """Exact phone sequence, flexible durations (forced-alignment graph)."""
    fst = Fst()
    s = fst.add_state()
    fst.set_start(s)
    for p in phone_seq:
        n = fst.add_state()
        fst.add_arc(s, int(p), EPS, 0.0, n)
        s = n
    fst.set_final(s, 0.0)
    return expand_to_dense(fst, tm)


def make_num_graph(
    tm: TransitionModel,
    words: Sequence[str],
    lexicon: Dict[str, List[List[int]]],
    word_ids: Dict[str, int],
    sil_phone: int = 0,
    sil_prob: float = 0.0,
) -> DenseFsa:
    """Transcript → numerator graph via L (alternative prons + opt. silence)."""
    word_acc = linear_acceptor([word_ids[w] for w in words])
    lex = make_lexicon_fst(lexicon, word_ids, sil_phone, sil_prob)
    phone_fst = lex.compose(word_acc).remove_input_epsilons()
    if not phone_fst.finals and phone_fst.num_states == 0:
        raise ValueError("empty composition: transcript not covered by lexicon")
    return expand_to_dense(phone_fst, tm)


# ---------------------------------------------------------------------------
# Denominator graph (LF-MMI style)
# ---------------------------------------------------------------------------


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
    Small-graph path (fully emitting, junctions collapsed); for word-LM scale
    use ``make_word_decode_graph``.
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

# ---------------------------------------------------------------------------
# HCLG-scale decoding graphs (trie lexicon ∘ ARPA G, vectorized; VERDICT r1
# item 2 — replaces Kaldi mkgraph.sh's L∘G + H expansion for eval decoding)
# ---------------------------------------------------------------------------


def make_lexicon_trie_fst(
    lexicon: Dict[str, List[List[int]]],
    word_ids: Dict[str, int],
    sil_phone: int = 0,
    sil_prob: float = 0.0,
) -> Fst:
    """Prefix-tree lexicon with the word olabel (and the pronunciation
    probability) on the LAST phone arc.

    Prefix sharing makes internal trie arcs deterministic; residual
    nondeterminism remains where one pronunciation prefixes another (the
    shorter word's final arc coexists with the trie-continuation arc) and
    at homophones (one final arc per word). Do NOT compose it naively with
    a word LM:
    the late word output keeps G from advancing until a word completes, so
    pair states grow as |trie|×|G|. ``make_word_decode_graph`` uses the
    early-output ``make_lexicon_fst`` instead, where L∘G grows as
    #G_arcs × pronunciation length (the un-determinized Kaldi LG shape).
    """
    fst = Fst()
    use_sil = sil_phone > 0 and sil_prob > 0.0
    wend = fst.add_state()
    fst.set_start(wend)
    if use_sil:
        log_sil = float(np.log(sil_prob))
        log_nosil = float(np.log(1.0 - sil_prob))
        loop = fst.add_state()
        sil_state = fst.add_state()
        fst.add_arc(wend, EPS, EPS, log_nosil, loop)
        fst.add_arc(wend, sil_phone, EPS, log_sil, sil_state)
        fst.add_arc(sil_state, sil_phone, EPS, 0.0, sil_state)
        fst.add_arc(sil_state, EPS, EPS, 0.0, loop)
        fst.set_final(wend, 0.0)
        fst.set_final(sil_state, 0.0)
    else:
        loop = wend
        fst.set_final(loop, 0.0)

    # trie over pronunciation prefixes (excluding the final phone, which
    # carries the word identity)
    children: Dict[Tuple[int, int], int] = {}
    for word, prons in lexicon.items():
        wid = word_ids[word]
        pron_w = float(np.log(1.0 / max(len(prons), 1)))
        for pron in prons:
            if not pron:
                raise ValueError(f"empty pronunciation for {word!r} is not "
                                 "supported by the trie lexicon")
            s = loop
            for ph in pron[:-1]:
                key = (s, ph)
                if key not in children:
                    n = fst.add_state()
                    fst.add_arc(s, ph, EPS, 0.0, n)
                    children[key] = n
                s = children[key]
            fst.add_arc(s, pron[-1], wid, pron_w, wend)
    return fst


def expand_to_pdf_vfst(phone_vfst, tm: TransitionModel):
    """Vectorized H-level expansion keeping junction states.

    Input: phone-level VectorFst (eps arcs allowed — LM backoff etc. pass
    through). Output: VectorFst with ilabel = pdf+1 (0 = eps), olabel = word;
    each phone arc becomes its topology's emitting states, entered by an
    emitting arc carrying the arc's weight+olabel and left by an EPS arc per
    exit transition. Junctions survive as states (no in×out product — the
    native decoder's epsilon closure handles them), so size stays linear in
    the input. Numerator/denominator DenseFsa builders keep using the exact
    collapsing ``_expand`` (FB kernels need fully-emitting graphs).
    """
    from pykaldi2_tpu_torch.graph.vfst import VectorFst

    g = phone_vfst
    n_junc = g.num_states
    phones_used = np.unique(g.ilabel[g.ilabel != EPS])
    n_states_of = {int(p): len(tm.topo.states_for(int(p))) for p in phones_used}
    arc_sizes = np.zeros(g.num_arcs, np.int64)
    for p, ns in n_states_of.items():
        arc_sizes[g.ilabel == p] = ns
    base = n_junc + np.cumsum(arc_sizes) - arc_sizes  # block start per arc
    total_states = n_junc + int(arc_sizes.sum())

    src_l, dst_l, il_l, ol_l, w_l = [], [], [], [], []

    eps_sel = g.ilabel == EPS
    if eps_sel.any():
        src_l.append(g.src[eps_sel].astype(np.int64))
        dst_l.append(g.dst[eps_sel].astype(np.int64))
        il_l.append(np.zeros(int(eps_sel.sum()), np.int64))
        ol_l.append(g.olabel[eps_sel].astype(np.int64))
        w_l.append(g.weight[eps_sel].astype(np.float32))

    for p in (int(x) for x in phones_used):
        sel = np.nonzero(g.ilabel == p)[0]
        b = base[sel]
        topo_states = tm.topo.states_for(p)
        nb = len(topo_states)
        # entry: junction src → state 0, emits pdf(p, 0), carries arc w + ol
        src_l.append(g.src[sel].astype(np.int64))
        dst_l.append(b)
        il_l.append(np.full(sel.size, tm.pdf_for(p, 0) + 1, np.int64))
        ol_l.append(g.olabel[sel].astype(np.int64))
        w_l.append(g.weight[sel].astype(np.float32))
        for j, st in enumerate(topo_states):
            for k, (nxt, _prob) in enumerate(st.transitions):
                _, logp, _tid = tm.transition(p, j, k)
                if nxt < nb:   # internal: emits the destination state's pdf
                    src_l.append(b + j)
                    dst_l.append(b + nxt)
                    il_l.append(np.full(sel.size, tm.pdf_for(p, nxt) + 1, np.int64))
                else:          # exit: EPS arc to the destination junction
                    src_l.append(b + j)
                    dst_l.append(g.dst[sel].astype(np.int64))
                    il_l.append(np.zeros(sel.size, np.int64))
                ol_l.append(np.zeros(sel.size, np.int64))
                w_l.append(np.full(sel.size, logp, np.float32))

    final = np.full(total_states, -np.inf, np.float32)
    final[:n_junc] = g.final
    out = VectorFst(
        total_states, g.start,
        np.concatenate(src_l).astype(np.int32),
        np.concatenate(dst_l).astype(np.int32),
        np.concatenate(il_l).astype(np.int32),
        np.concatenate(ol_l).astype(np.int32),
        np.concatenate(w_l).astype(np.float32),
        final)
    return out.connect()


def make_word_decode_graph(
    tm: TransitionModel,
    lexicon: Dict[str, List[List[int]]],
    word_ids: Dict[str, int],
    grammar,
    sil_phone: int = 0,
    sil_prob: float = 0.0,
):
    """Full HCLG-style decode graph against a word LM, at scale.

    grammar: a VectorFst word acceptor (e.g. ``arpa.arpa_to_fst`` output) or
    an ``arpa.ArpaModel``. Returns a VectorFst consumable directly by
    decode.decoder.LatticeDecoder (ilabel = pdf+1, eps arcs carried through
    to the decoder's epsilon closure).

    Uses the early-output lexicon (word label + LM weight meet on the first
    phone arc) so L∘G size is Θ(#G_arcs × pronunciation length) — the
    shape Kaldi's LG has before determinization; the beam search absorbs
    the first-phone nondeterminism.
    """
    from pykaldi2_tpu_torch.graph.arpa import ArpaModel, arpa_to_fst
    from pykaldi2_tpu_torch.graph.vfst import VectorFst

    if isinstance(grammar, ArpaModel):
        grammar = arpa_to_fst(grammar, word_ids)
    lex = VectorFst.from_fst(
        make_lexicon_fst(lexicon, word_ids, sil_phone, sil_prob))
    lg = lex.compose(grammar)
    if lg.num_states == 0:
        raise ValueError("empty L∘G composition: lexicon/LM vocabulary mismatch")
    return expand_to_pdf_vfst(lg, tm)
