"""Minimal host-side weighted FST (log-prob weights).

Copy of the part of pykaldi2_tpu/graph/fst.py that sequence training and
decoding need (reference behavior: the slice of OpenFst pykaldi2 exercises
through graph construction): mutable construction, connection (trim),
composition, input-epsilon removal, determinization, weight pushing and
minimization, OpenFst-compatible text IO, and the lexicon and linear
acceptors the decode and numerator graphs are built from. Weights are
**log-probs** (higher = better, additive along paths) — the negation of
OpenFst tropical costs; text IO negates on the way in and out so
``fstcompile``-style files interoperate.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

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

    # -- algorithms -------------------------------------------------------

    def connect(self) -> "Fst":
        """Trim states not on a start→final path."""
        if self.start < 0:
            return Fst()
        fwd = {self.start}
        stack = [self.start]
        while stack:
            s = stack.pop()
            for a in self.arcs[s]:
                if a.nextstate not in fwd:
                    fwd.add(a.nextstate)
                    stack.append(a.nextstate)
        back = defaultdict(list)
        for s in range(self.num_states):
            for a in self.arcs[s]:
                back[a.nextstate].append(s)
        rev = set(self.finals)
        stack = list(self.finals)
        while stack:
            s = stack.pop()
            for p in back[s]:
                if p not in rev:
                    rev.add(p)
                    stack.append(p)
        keep = fwd & rev
        remap = {}
        out = Fst()
        for s in sorted(keep):
            remap[s] = out.add_state()
        if self.start in remap:
            out.set_start(remap[self.start])
        for s in sorted(keep):
            for a in self.arcs[s]:
                if a.nextstate in remap:
                    out.add_arc(remap[s], a.ilabel, a.olabel, a.weight, remap[a.nextstate])
            if s in self.finals:
                out.set_final(remap[s], self.finals[s])
        return out

    def compose(self, other: "Fst") -> "Fst":
        """self ∘ other: self's olabels matched against other's ilabels.

        Epsilon handling: simple epsilon-forwarding (sufficient for L∘G with
        epsilon word outputs); may create redundant (not incorrect) paths.
        """
        out = Fst()
        index: Dict[Tuple[int, int], int] = {}

        def state(a, b):
            if (a, b) not in index:
                index[(a, b)] = out.add_state()
            return index[(a, b)]

        if self.start < 0 or other.start < 0:
            return out
        out.set_start(state(self.start, other.start))
        queue = deque([(self.start, other.start)])
        seen = {(self.start, other.start)}
        # arc-index other's arcs by ilabel
        other_by_il: List[Dict[int, List[Arc]]] = []
        for s in range(other.num_states):
            d = defaultdict(list)
            for a in other.arcs[s]:
                d[a.ilabel].append(a)
            other_by_il.append(d)
        while queue:
            s1, s2 = queue.popleft()
            cur = state(s1, s2)
            if s1 in self.finals and s2 in other.finals:
                out.set_final(cur, self.finals[s1] + other.finals[s2])
            for a in self.arcs[s1]:
                if a.olabel == EPS:
                    nxt = (a.nextstate, s2)
                    out.add_arc(cur, a.ilabel, EPS, a.weight, state(*nxt))
                    if nxt not in seen:
                        seen.add(nxt)
                        queue.append(nxt)
                else:
                    for b in other_by_il[s2].get(a.olabel, ()):
                        nxt = (a.nextstate, b.nextstate)
                        out.add_arc(cur, a.ilabel, b.olabel, a.weight + b.weight, state(*nxt))
                        if nxt not in seen:
                            seen.add(nxt)
                            queue.append(nxt)
            for b in other.arcs[s2]:
                if b.ilabel == EPS:
                    nxt = (s1, b.nextstate)
                    out.add_arc(cur, EPS, b.olabel, b.weight, state(*nxt))
                    if nxt not in seen:
                        seen.add(nxt)
                        queue.append(nxt)
        return out.connect()

    def remove_input_epsilons(self, semiring: str = "tropical") -> "Fst":
        """Eliminate ilabel==EPS arcs by exact epsilon-closure folding.

        Parallel epsilon routes between the same state pair are combined by
        the semiring plus: ``"tropical"`` keeps the best route (max log-prob
        — Viterbi/N-best/decode-graph semantics, matching OpenFst tropical
        eps removal and the Kaldi mkgraph convention), ``"log"`` log-adds
        them (sum-exact — what forward-backward/posterior consumers need;
        the two agree exactly whenever no parallel eps routes exist, which
        is the common HCLG case). The closure runs once per source state in
        topological order over the eps subgraph, so every route is counted
        exactly once (the previous DFS both Viterbi-collapsed parallel
        routes and emitted duplicate arcs with stale weights when a route
        improved after first visit).

        Exact only for ACYCLIC epsilon subgraphs (which our builders
        produce); a cyclic epsilon subgraph would carry unbounded (log) or
        ill-defined weight mass, so it is rejected here instead (VERDICT
        r1)."""
        if semiring not in ("tropical", "log"):
            raise ValueError(f"semiring={semiring!r}: expected tropical|log")
        self._check_eps_acyclic()
        import math

        if semiring == "tropical":
            def plus(a, b):
                return a if a >= b else b
        else:
            def plus(a, b):
                m, n = (a, b) if a >= b else (b, a)
                return m + math.log1p(math.exp(n - m))

        # one global topological order over the (acyclic) eps subgraph;
        # per-source relaxation in this order counts each route once
        indeg = [0] * self.num_states
        eps_out: List[List[Tuple[int, float]]] = [[] for _ in range(self.num_states)]
        for s in range(self.num_states):
            for a in self.arcs[s]:
                if a.ilabel == EPS and a.olabel == EPS:
                    eps_out[s].append((a.nextstate, a.weight))
                    indeg[a.nextstate] += 1
        stack = [s for s in range(self.num_states) if indeg[s] == 0]
        topo_pos = [0] * self.num_states
        order = []
        while stack:
            s = stack.pop()
            topo_pos[s] = len(order)
            order.append(s)
            for (d, _w) in eps_out[s]:
                indeg[d] -= 1
                if indeg[d] == 0:
                    stack.append(d)

        out = Fst()
        for _ in range(self.num_states):
            out.add_state()
        out.set_start(self.start)

        import heapq

        for s in range(self.num_states):
            dist: Dict[int, float] = {s: 0.0}
            if eps_out[s]:
                # relax eps-reachable states in topo order (min-heap on the
                # global topo position): every predecessor of a state is
                # relaxed before it, so each route is counted exactly once
                heap = [(topo_pos[s], s)]
                seen = {s}
                while heap:
                    _, cur = heapq.heappop(heap)
                    for (d, w) in eps_out[cur]:
                        nw = dist[cur] + w
                        dist[d] = plus(dist[d], nw) if d in dist else nw
                        if d not in seen:
                            seen.add(d)
                            heapq.heappush(heap, (topo_pos[d], d))
            for c, w in dist.items():
                for a in self.arcs[c]:
                    if not (a.ilabel == EPS and a.olabel == EPS):
                        out.add_arc(s, a.ilabel, a.olabel, w + a.weight, a.nextstate)
                if c in self.finals:
                    cand = w + self.finals[c]
                    prev = out.finals.get(s)
                    out.set_final(s, cand if prev is None else plus(prev, cand))
        return out.connect()

    def _check_eps_acyclic(self):
        """Raise if the eps/eps arc subgraph has a cycle (iterative DFS)."""
        WHITE, GRAY, BLACK = 0, 1, 2
        color = [WHITE] * self.num_states
        for root in range(self.num_states):
            if color[root] != WHITE:
                continue
            stack = [(root, 0)]
            color[root] = GRAY
            while stack:
                s, i = stack[-1]
                arcs = self.arcs[s]
                advanced = False
                while i < len(arcs):
                    a = arcs[i]
                    i += 1
                    if a.ilabel != EPS or a.olabel != EPS:
                        continue
                    if color[a.nextstate] == GRAY:
                        raise ValueError(
                            "epsilon cycle detected: remove_input_epsilons is "
                            "only exact for acyclic epsilon subgraphs")
                    if color[a.nextstate] == WHITE:
                        stack[-1] = (s, i)
                        stack.append((a.nextstate, 0))
                        color[a.nextstate] = GRAY
                        advanced = True
                        break
                if not advanced:
                    color[s] = BLACK
                    stack.pop()

    def determinize(self, encode_labels: bool = False, delta: float = 1e-6,
                    max_states: int = 10_000_000) -> "Fst":
        """Weighted subset determinization (max/tropical over log-probs).

        Replaces OpenFst's ``fstdeterminize`` for the slice the graph build
        exercises (SURVEY.md §3.2 "OpenFst"). The input must be
        epsilon-free (run :meth:`remove_input_epsilons` first).

        By default the FST must be an acceptor (ilabel == olabel on every
        arc). With ``encode_labels=True`` a transducer is determinized over
        encoded (ilabel, olabel) pairs — OpenFst's encode→determinize→decode
        recipe — which is exact for any transducer but yields determinism
        w.r.t. the label *pairs*, not ilabels alone.

        Residual weights inside subsets are quantized to ``delta`` so that
        cyclic (e.g. backoff-LM) inputs converge; a non-determinizable input
        trips the ``max_states`` guard and raises.
        """
        if self.start < 0:
            return Fst()
        for s in range(self.num_states):
            for a in self.arcs[s]:
                if a.ilabel == EPS and a.olabel == EPS:
                    raise ValueError("determinize requires an epsilon-free FST "
                                     "(run remove_input_epsilons first)")
                if not encode_labels and a.ilabel != a.olabel:
                    raise ValueError("determinize: transducer arcs need "
                                     "encode_labels=True")

        def q(w: float) -> float:
            return round(w / delta) * delta

        out = Fst()
        start_subset = ((self.start, 0.0),)
        index: Dict[tuple, int] = {start_subset: out.add_state()}
        out.set_start(0)
        queue = deque([start_subset])
        while queue:
            subset = queue.popleft()
            cur = index[subset]
            # final weight: best residual+final over member states
            fin = None
            by_label: Dict[tuple, Dict[int, float]] = {}
            for (st, res) in subset:
                fw = self.finals.get(st)
                if fw is not None and (fin is None or res + fw > fin):
                    fin = res + fw
                for a in self.arcs[st]:
                    key = (a.ilabel, a.olabel) if encode_labels else (a.ilabel, a.ilabel)
                    d = by_label.setdefault(key, {})
                    w = res + a.weight
                    if a.nextstate not in d or w > d[a.nextstate]:
                        d[a.nextstate] = w
            if fin is not None:
                out.set_final(cur, fin)
            for (il, ol), dests in sorted(by_label.items()):
                w_max = max(dests.values())
                nxt = tuple(sorted((ns, q(w - w_max)) for ns, w in dests.items()))
                if nxt not in index:
                    if len(index) >= max_states:
                        raise ValueError(
                            f"determinize exceeded {max_states} subsets — "
                            "input is likely non-determinizable in the "
                            "tropical semiring")
                    index[nxt] = out.add_state()
                    queue.append(nxt)
                out.add_arc(cur, il, ol, w_max, index[nxt])
        return out

    def push_weights(self, delta: float = 1e-9, max_iters: Optional[int] = None) -> "Fst":
        """Push weights toward the initial state (max/log-prob potentials).

        Potential V(s) = best log-prob from s to a final state; each arc
        becomes w + V(ns) − V(s) and finals become f − V(s), so all
        equivalent suffixes carry identical weights — the precondition for
        weighted minimization. V(start) is folded back into the start
        state's outgoing arcs/final so total path weights are preserved
        exactly. Raises on a positive-weight cycle (diverging potentials).

        If the start state has incoming arcs (e.g. word-loop graphs), it is
        split first — the V(start) fold-back is only exact when the start
        state is entered exactly once per path. Costs at most one extra
        state in the minimized result.
        """
        if self.start >= 0 and any(
            a.nextstate == self.start
            for s in range(self.num_states) for a in self.arcs[s]
        ):
            split = Fst()
            for _ in range(self.num_states):
                split.add_state()
            for s in range(self.num_states):
                for a in self.arcs[s]:
                    split.add_arc(s, a.ilabel, a.olabel, a.weight, a.nextstate)
            for s, w in self.finals.items():
                split.set_final(s, w)
            new_start = split.add_state()
            for a in self.arcs[self.start]:
                split.add_arc(new_start, a.ilabel, a.olabel, a.weight, a.nextstate)
            if self.start in self.finals:
                split.set_final(new_start, self.finals[self.start])
            split.set_start(new_start)
            return split.push_weights()
        n = self.num_states
        if n == 0 or self.start < 0:
            return Fst()
        NEG = -np.inf
        V = np.full(n, NEG)
        for s, w in self.finals.items():
            V[s] = w
        iters = max_iters if max_iters is not None else n + 1
        changed = True
        it = 0
        while changed:
            changed = False
            it += 1
            for s in range(n):
                best = self.finals.get(s, NEG)
                for a in self.arcs[s]:
                    if V[a.nextstate] > NEG:
                        cand = a.weight + V[a.nextstate]
                        if cand > best:
                            best = cand
                if best > V[s] + delta:
                    V[s] = best
                    changed = True
            if it > iters:
                raise ValueError("push_weights: positive-weight cycle "
                                 "(potentials diverge)")
        out = Fst()
        for _ in range(n):
            out.add_state()
        out.set_start(self.start)
        for s in range(n):
            vs = 0.0 if s == self.start else (V[s] if V[s] > NEG else 0.0)
            for a in self.arcs[s]:
                vn = V[a.nextstate] if V[a.nextstate] > NEG else 0.0
                out.add_arc(s, a.ilabel, a.olabel, a.weight + vn - vs, a.nextstate)
            if s in self.finals:
                out.set_final(s, self.finals[s] - vs)
        return out

    def minimize(self, delta: float = 1e-6) -> "Fst":
        """Weighted minimization: push weights, then merge bisimilar states.

        Replaces OpenFst's ``fstminimize`` for our graph-build usage. Moore
        partition refinement over (ilabel, olabel, quantized weight,
        next-class) signatures after weight pushing: exactly minimal for
        deterministic input, and a safe (language-preserving) bisimulation
        quotient for non-deterministic input.
        """
        f = self.connect().push_weights()
        n = f.num_states
        if n == 0:
            return f

        def qw(w: float) -> int:
            return int(round(w / delta))

        # initial partition: finality + final weight
        cls = {}
        part: List[int] = [0] * n
        for s in range(n):
            key = (s in f.finals, qw(f.finals.get(s, 0.0)))
            part[s] = cls.setdefault(key, len(cls))
        while True:
            sig_ids: Dict[tuple, int] = {}
            new_part = [0] * n
            for s in range(n):
                sig = (part[s], tuple(sorted(
                    (a.ilabel, a.olabel, qw(a.weight), part[a.nextstate])
                    for a in f.arcs[s])))
                new_part[s] = sig_ids.setdefault(sig, len(sig_ids))
            if len(sig_ids) == len(cls):
                break
            cls = sig_ids
            part = new_part
        # build the quotient
        out = Fst()
        for _ in range(len(cls)):
            out.add_state()
        out.set_start(part[f.start])
        emitted = set()
        for s in range(n):
            c = part[s]
            if c in emitted:
                continue
            emitted.add(c)
            for a in f.arcs[s]:
                out.add_arc(c, a.ilabel, a.olabel, a.weight, part[a.nextstate])
            if s in f.finals:
                out.set_final(c, f.finals[s])
        return out

    # -- IO ---------------------------------------------------------------

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


def linear_acceptor(labels: Iterable[int], weight: float = 0.0) -> Fst:
    fst = Fst()
    s = fst.add_state()
    fst.set_start(s)
    for lab in labels:
        n = fst.add_state()
        fst.add_arc(s, lab, lab, weight, n)
        s = n
    fst.set_final(s, 0.0)
    return fst


def make_lexicon_fst(
    lexicon: Dict[str, List[List[int]]],
    word_ids: Dict[str, int],
    sil_phone: int = 0,
    sil_prob: float = 0.0,
) -> Fst:
    """L: phones in → words out, optional silence between words.

    lexicon: word → list of pronunciations (phone-id lists).
    sil_phone > 0 adds optional silence (prob sil_prob) at sentence start and
    after each word, like Kaldi's L_disambig-less lexicon.
    """
    fst = Fst()
    use_sil = sil_phone > 0 and sil_prob > 0.0
    # Kaldi L structure: after each word (and at sentence start), either take
    # optional silence with prob sil_prob or proceed directly with 1−sil_prob.
    wend = fst.add_state()        # start: "word boundary" state
    fst.set_start(wend)
    if use_sil:
        log_sil = float(np.log(sil_prob))
        log_nosil = float(np.log(1.0 - sil_prob))
        loop = fst.add_state()    # words begin here
        sil_state = fst.add_state()
        fst.add_arc(wend, EPS, EPS, log_nosil, loop)          # skip silence
        fst.add_arc(wend, sil_phone, EPS, log_sil, sil_state) # take silence
        fst.add_arc(sil_state, sil_phone, EPS, 0.0, sil_state)
        fst.add_arc(sil_state, EPS, EPS, 0.0, loop)
        fst.set_final(wend, 0.0)  # may end at a word boundary (opt. final sil)
        fst.set_final(sil_state, 0.0)
    else:
        loop = wend
        fst.set_final(loop, 0.0)
    for word, prons in lexicon.items():
        wid = word_ids[word]
        pron_w = float(np.log(1.0 / max(len(prons), 1)))
        for pron in prons:
            s = loop
            for i, ph in enumerate(pron):
                n = fst.add_state() if i < len(pron) - 1 else wend
                fst.add_arc(s, ph, wid if i == 0 else EPS,
                            pron_w if i == 0 else 0.0, n)
                s = n
            if not pron:  # empty pronunciation: eps arc
                fst.add_arc(loop, EPS, wid, pron_w, wend)
    return fst
