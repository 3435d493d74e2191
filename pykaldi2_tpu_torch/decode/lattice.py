"""Lattice post-processing: word graphs, N-best, oracle WER, LM rescoring,
and Kaldi CompactLattice text interchange.

Numpy copy of pykaldi2_tpu/decode/lattice.py for the PyTorch port.

Reference behavior: the Kaldi lattice functions pykaldi2's eval pipeline
drives through PyKaldi / Kaldi CLI (SURVEY.md §3.2 "Kaldi lattice functions",
§4.4 decode/eval): ``lattice-to-nbest``, ``lattice-oracle``,
``lattice-lmrescore``, ``lattice-copy`` (text format), ``lattice-best-path``.

The native decoder (decode/decoder.py) emits time-synchronous DenseFsa
lattices whose arc weights are graph scores; this module folds in the
acoustic scores, projects onto word labels, and runs the word-level
algorithms on the host object-FST layer (graph/fst.py) — lattices at
realistic beams are thousands of arcs, far below where the vectorized layer
is needed. Weights everywhere are log-probs (higher = better); the Kaldi
text format negates into costs on the way out/in.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pykaldi2_tpu_torch.graph.fst import EPS, Fst
from pykaldi2_tpu_torch.ops.fsa import DenseFsa


# ---------------------------------------------------------------------------
# lattice → word acceptor
# ---------------------------------------------------------------------------


def lattice_word_fst(
    lat: DenseFsa,
    loglikes: Optional[np.ndarray] = None,
    frames: Optional[np.ndarray] = None,
    acoustic_scale: float = 1.0,
    graph_scale: float = 1.0,
) -> Fst:
    """Project a decoded lattice onto its word labels (epsilon-free acceptor).

    ``loglikes`` [T, P] + per-state ``frames`` [S] fold the acoustic scores
    into the arc weights (``decode_lattice(with_frames=True)`` provides
    frames); omit both to keep graph scores only. The lattice is acyclic, so
    the epsilon removal is exact.

    ``graph_scale`` multiplies the lattice's graph (LM+transition) scores
    before folding — the decoder lattice keeps graph and acoustic scores
    separate, so Kaldi's ``lattice-scale --lm-scale`` / scoring-time LM
    weight sweeps are a re-fold per scale, no re-decode.
    """
    if lat.olabel is None:
        raise ValueError("lattice has no word labels (olabel is None)")
    f = Fst()
    for _ in range(lat.num_states):
        f.add_state()
    f.set_start(lat.start)
    w = graph_scale * lat.weight.astype(np.float64)
    if loglikes is not None:
        if frames is None:
            raise ValueError("need per-state frames to fold acoustic scores")
        # arc acoustic score: emission of its pdf at the source state's frame
        w = w + acoustic_scale * loglikes[frames[lat.src], lat.pdf]
    for e in range(lat.num_arcs):
        lab = int(lat.olabel[e])
        f.add_arc(int(lat.src[e]), lab, lab, float(w[e]), int(lat.dst[e]))
    for s in range(lat.num_states):
        if np.isfinite(lat.final[s]):
            f.set_final(s, float(lat.final[s]) * graph_scale)
    return f.remove_input_epsilons().connect()


def frame_lattice_best_path(lat: DenseFsa, frames: np.ndarray, loglikes=None,
                            acoustic_scale: float = 1.0) -> Tuple[List[int], float]:
    """Best word sequence of a time-synchronous lattice and its log-prob:
    ``best_path(lattice_word_fst(lat, loglikes, frames, acoustic_scale))``
    computed as one Viterbi pass over the frames, vectorised over each
    frame's arcs (no word acceptor and no epsilon removal, which are Python
    per arc and state: a lattice of the device search at wide beams holds
    hundreds of thousands of states). Arc weights and finals are summed in
    float64 as ``lattice_word_fst`` sums them. Raises ValueError when no
    path reaches a final state."""
    if lat.olabel is None:
        raise ValueError("lattice has no word labels (olabel is None)")
    frames = np.asarray(frames)
    src, dst = np.asarray(lat.src, np.int64), np.asarray(lat.dst, np.int64)
    w = lat.weight.astype(np.float64)
    if loglikes is not None:
        w = w + acoustic_scale * loglikes[frames[src], lat.pdf]
    order = np.argsort(frames[src], kind="stable")
    bounds = np.searchsorted(frames[src][order], np.arange(int(frames.max()) + 2))
    best = np.full(lat.num_states, -np.inf)
    best[lat.start] = 0.0
    back = np.full(lat.num_states, -1, np.int64)
    for t in range(len(bounds) - 1):
        e = order[bounds[t]:bounds[t + 1]]
        if not len(e):
            continue
        cand = best[src[e]] + w[e]
        # per destination, its best arc (the first in arc order among ties)
        o = np.lexsort((-cand, dst[e]))
        first = np.ones(len(o), bool)
        first[1:] = dst[e][o][1:] != dst[e][o][:-1]
        win = e[o[first]]
        ok = cand[o[first]] > best[dst[win]]
        best[dst[win[ok]]] = cand[o[first]][ok]
        back[dst[win[ok]]] = win[ok]
    total = best + np.where(np.isfinite(lat.final), lat.final.astype(np.float64), -np.inf)
    s = int(np.argmax(total))
    if not np.isfinite(total[s]):
        raise ValueError("no complete path in lattice")
    score, words = float(total[s]), []
    while back[s] >= 0:
        a = back[s]
        if lat.olabel[a] != EPS:
            words.append(int(lat.olabel[a]))
        s = int(src[a])
    return words[::-1], score


# ---------------------------------------------------------------------------
# topological order + N-best
# ---------------------------------------------------------------------------


def _topo_order(f: Fst) -> List[int]:
    """Kahn topological order; raises on a cyclic FST."""
    indeg = [0] * f.num_states
    for s in range(f.num_states):
        for a in f.arcs[s]:
            indeg[a.nextstate] += 1
    stack = [s for s in range(f.num_states) if indeg[s] == 0]
    order = []
    while stack:
        s = stack.pop()
        order.append(s)
        for a in f.arcs[s]:
            indeg[a.nextstate] -= 1
            if indeg[a.nextstate] == 0:
                stack.append(a.nextstate)
    if len(order) != f.num_states:
        raise ValueError("FST is cyclic — N-best/oracle need acyclic input")
    return order


def _best_suffix(f: Fst, order: List[int]) -> np.ndarray:
    """Best log-prob from each state to a final state (−inf = dead end)."""
    v = np.full(f.num_states, -np.inf)
    for s in reversed(order):
        best = f.finals.get(s, -np.inf)
        for a in f.arcs[s]:
            cand = a.weight + v[a.nextstate]
            if cand > best:
                best = cand
        v[s] = best
    return v


def nbest(word_fst: Fst, n: int, unique: bool = True) -> List[Tuple[List[int], float]]:
    """N best word sequences with their total log-probs, best first.

    With ``unique=True`` (Kaldi ``lattice-to-nbest`` semantics) each word
    sequence appears once at its best score, via *lazy* best-first
    determinization: A* over weighted state-subsets with best-suffix
    potentials. Only the explored frontier materializes — a full eager
    ``determinize()`` of a dense decoded lattice can blow up exponentially,
    which is exactly why Kaldi ships a specialized lattice determinizer.
    Requires an acyclic, epsilon-free acceptor (what ``lattice_word_fst``
    produces).
    """
    if word_fst.start < 0 or not word_fst.finals:
        return []
    f = word_fst
    order = _topo_order(f)
    suffix = _best_suffix(f, order)
    if not np.isfinite(suffix[f.start]):
        return []
    import heapq

    out: List[Tuple[List[int], float]] = []
    cnt = 0
    if not unique:
        # plain path enumeration (duplicates possible)
        heap = [(-suffix[f.start], cnt, f.start, 0.0, [])]
        while heap and len(out) < n:
            neg, _, s, pw, words = heapq.heappop(heap)
            if s is None:
                out.append((words, pw))
                continue
            fw = f.finals.get(s)
            if fw is not None:
                cnt += 1
                heapq.heappush(heap, (-(pw + fw), cnt, None, pw + fw, words))
            for a in f.arcs[s]:
                tot = pw + a.weight + suffix[a.nextstate]
                if np.isfinite(tot):
                    cnt += 1
                    heapq.heappush(
                        heap,
                        (-tot, cnt, a.nextstate, pw + a.weight,
                         words + ([a.ilabel] if a.ilabel != EPS else [])))
        return out

    for s in range(f.num_states):
        for a in f.arcs[s]:
            if a.ilabel == EPS:
                raise ValueError("unique nbest needs an epsilon-free acceptor")
    # subset = tuple of (state, residual); priority uses the subset's best
    # residual+suffix. Each word prefix maps to exactly one subset, so each
    # word sequence is enumerated at most once, at its best total score.
    start = ((f.start, 0.0),)
    heap = [(-suffix[f.start], cnt, start, 0.0, [])]
    while heap and len(out) < n:
        neg, _, subset, pw, words = heapq.heappop(heap)
        if subset is None:
            out.append((words, pw))
            continue
        fin = None
        by_label: Dict[int, Dict[int, float]] = {}
        for (st, res) in subset:
            fw = f.finals.get(st)
            if fw is not None and (fin is None or res + fw > fin):
                fin = res + fw
            for a in f.arcs[st]:
                d = by_label.setdefault(a.ilabel, {})
                w = res + a.weight
                if a.nextstate not in d or w > d[a.nextstate]:
                    d[a.nextstate] = w
        if fin is not None:
            cnt += 1
            heapq.heappush(heap, (-(pw + fin), cnt, None, pw + fin, words))
        for lab, dests in by_label.items():
            w_max = max(dests.values())
            nxt = tuple(sorted(dests.items()))
            nxt = tuple((ns, w - w_max) for ns, w in nxt)
            best_tail = max(w + suffix[ns] for ns, w in nxt)
            tot = pw + w_max + best_tail
            if np.isfinite(tot):
                cnt += 1
                heapq.heappush(heap, (-tot, cnt, nxt, pw + w_max, words + [lab]))
    return out


def best_path(word_fst: Fst) -> Tuple[List[int], float]:
    """Best word sequence (Kaldi ``lattice-best-path``)."""
    top = nbest(word_fst, 1, unique=False)
    if not top:
        raise ValueError("no complete path in lattice")
    return top[0]


# ---------------------------------------------------------------------------
# oracle WER (Kaldi lattice-oracle)
# ---------------------------------------------------------------------------


def oracle_errors(word_fst: Fst, ref: Sequence[int]) -> int:
    """Minimum edit distance between the reference and ANY lattice path.

    DP over (state, ref position) on the acyclic word acceptor — the product
    with a Levenshtein automaton, like Kaldi's ``lattice-oracle``.
    """
    order = _topo_order(word_fst)
    R = len(ref)
    INF = 1 << 30
    d = np.full((word_fst.num_states, R + 1), INF, np.int64)
    if word_fst.start < 0:
        raise ValueError("empty FST")
    # deletions from the start onward are handled by the j-loop below
    d[word_fst.start, 0] = 0
    for s in order:
        row = d[s]
        # deletion: consume a ref word without moving in the lattice
        for j in range(R):
            if row[j] + 1 < row[j + 1]:
                row[j + 1] = row[j] + 1
        for a in word_fst.arcs[s]:
            nrow = d[a.nextstate]
            if a.ilabel == EPS:
                np.minimum(nrow, row, out=nrow)
                continue
            # insertion: hyp word with no ref word
            np.minimum(nrow, row + 1, out=nrow)
            # match / substitution
            for j in range(R):
                cost = row[j] + (0 if a.ilabel == ref[j] else 1)
                if cost < nrow[j + 1]:
                    nrow[j + 1] = cost
    best = INF
    for s, _w in word_fst.finals.items():
        # remaining ref words are deletions
        for j in range(R + 1):
            cand = d[s, j] + (R - j)
            if cand < best:
                best = int(cand)
    if best >= INF:
        raise ValueError("no complete path in lattice")
    return best


# ---------------------------------------------------------------------------
# LM rescoring (Kaldi lattice-lmrescore)
# ---------------------------------------------------------------------------


def lmrescore(word_fst: Fst, g_old: Optional[Fst], g_new: Fst,
              lm_scale: float = 1.0) -> Fst:
    """Replace the LM scores in a word acceptor: subtract ``g_old`` (the LM
    baked into HCLG), add ``lm_scale``·``g_new``.

    Composition with the negated old G mirrors Kaldi's
    ``lattice-lmrescore`` semantics, with the same caveat: backoff arcs are
    epsilon alternatives, so subtraction is exact only when the old G scores
    each word sequence on a unique path (e.g. an exact/no-backoff n-gram, or
    matching backoff structure); otherwise the best-path approximation
    standard in this pipeline applies.
    """
    out = word_fst
    if g_old is not None:
        neg = Fst()
        for _ in range(g_old.num_states):
            neg.add_state()
        neg.set_start(g_old.start)
        for s in range(g_old.num_states):
            for a in g_old.arcs[s]:
                neg.add_arc(s, a.ilabel, a.olabel, -a.weight, a.nextstate)
            if s in g_old.finals:
                neg.set_final(s, -g_old.finals[s])
        out = out.compose(neg)
    if lm_scale != 1.0:
        g_new = _scale_fst(g_new, lm_scale)
    # Composition with an ARPA G emits eps-labeled arcs for backoff
    # transitions; fold them away so downstream consumers (unique N-best
    # needs an eps-free acceptor) keep working. The backoff eps subgraph is
    # acyclic (backoff strictly lowers the n-gram order), so this is exact.
    return out.compose(g_new).remove_input_epsilons()


def _scale_fst(f: Fst, scale: float) -> Fst:
    out = Fst()
    for _ in range(f.num_states):
        out.add_state()
    out.set_start(f.start)
    for s in range(f.num_states):
        for a in f.arcs[s]:
            out.add_arc(s, a.ilabel, a.olabel, a.weight * scale, a.nextstate)
        if s in f.finals:
            out.set_final(s, f.finals[s] * scale)
    return out


# ---------------------------------------------------------------------------
# Kaldi CompactLattice text interchange (lattice-copy text form)
# ---------------------------------------------------------------------------


def write_lattices_text(path: str, lattices: Dict[str, Fst]) -> None:
    """Write word acceptors as Kaldi CompactLattice TEXT archives.

    Arc lines are ``src dst word graph_cost,acoustic_cost,tid-sequence``;
    the combined score goes in the graph field (acoustic 0, empty tid
    string — this framework folds acoustics before word projection), costs
    are −log-probs per the Kaldi convention. Readable by ``lattice-copy``
    and the downstream lattice-* tools.
    """
    with open(path, "w") as f:
        for uid in sorted(lattices):
            lat = lattices[uid]
            f.write(uid + "\n")
            if lat.start >= 0:
                order = [lat.start] + [s for s in range(lat.num_states)
                                       if s != lat.start]
                for s in order:
                    for a in lat.arcs[s]:
                        f.write(f"{s} {a.nextstate} {a.ilabel} "
                                f"{-a.weight:.6f},0,\n")
                    if s in lat.finals:
                        f.write(f"{s} {-lat.finals[s]:.6f},0,\n")
            f.write("\n")


def read_lattices_text(path: str) -> Dict[str, Fst]:
    """Read Kaldi CompactLattice TEXT archives into word acceptors.

    Graph+acoustic costs are summed into the single log-prob weight; the
    transition-id sequence (if present) is dropped — alignments live in the
    time-synchronous DenseFsa form on this side.
    """
    out: Dict[str, Fst] = {}
    cur_name = None
    cur: Optional[Fst] = None
    first_state: Optional[int] = None

    def finish():
        nonlocal cur_name, cur, first_state
        if cur_name is not None and cur is not None:
            if first_state is not None:
                cur.set_start(first_state)
            out[cur_name] = cur
        cur_name, cur, first_state = None, None, None

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                finish()
                continue
            if cur_name is None:
                cur_name = parts[0]
                cur = Fst()
                continue

            def need(s):
                while cur.num_states <= s:
                    cur.add_state()

            def weight_of(tok: str) -> float:
                fields = tok.split(",")
                g = float(fields[0]) if fields[0] else 0.0
                a = float(fields[1]) if len(fields) > 1 and fields[1] else 0.0
                return -(g + a)

            if len(parts) >= 4:
                s, ns, w_lab = int(parts[0]), int(parts[1]), int(parts[2])
                need(max(s, ns))
                cur.add_arc(s, w_lab, w_lab, weight_of(parts[3]), ns)
            elif len(parts) == 3:
                # 'src dst word' — legal OpenFst/Kaldi text arc with the
                # weight omitted, meaning Weight::One (zero cost)
                s, ns, w_lab = int(parts[0]), int(parts[1]), int(parts[2])
                need(max(s, ns))
                cur.add_arc(s, w_lab, w_lab, 0.0, ns)
            elif len(parts) == 2:
                s = int(parts[0])
                need(s)
                cur.set_final(s, weight_of(parts[1]))
            else:  # single token: final state with Weight::One
                s = int(parts[0])
                need(s)
                cur.set_final(s, 0.0)
            if first_state is None:
                first_state = s
    finish()
    return out
