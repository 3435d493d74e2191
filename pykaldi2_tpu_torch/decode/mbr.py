"""Minimum-Bayes-Risk (consensus) decoding, word confidences, sausages,
and lattice posterior pruning.

Numpy copy of pykaldi2_tpu/decode/mbr.py for the PyTorch port.

Reference behavior: the Kaldi lattice tools the reference's eval pipeline can
drive after decoding (SURVEY.md §3.2 "Kaldi lattice functions", §4.4):
``lattice-mbr-decode`` / ``lattice-to-ctm-conf`` (both are thin CLIs over
``kaldi/src/lat/sausages.{h,cc}``'s ``MinimumBayesRisk`` class — the
edit-distance-recursion MBR algorithm of Xu, Povey, Mangu & Zhu, "Minimum
Bayes Risk decoding and system combination based on a recursion for edit
distance", CSL 2011) and ``lattice-prune``
(``kaldi/src/latbin/lattice-prune.cc``).

The algorithm here is implemented from the paper's recursion, not from the
Kaldi source: the hypothesis R is iteratively refined against per-position
word posteriors ("sausage bins") obtained from a soft Levenshtein alignment
of the whole lattice against R, until the expected word-error (the Bayes
risk) stops improving.  Outputs: the consensus transcript, per-word
confidences, expected word times (for CTM), and the full confusion network.

Weights follow this package's convention: log-probs, higher = better
(graph/fst.py) — the negation of Kaldi's costs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pykaldi2_tpu_torch.graph.fst import EPS, Fst
from pykaldi2_tpu_torch.ops.fsa import DenseFsa

ArcTimes = List[List[Tuple[float, float]]]  # per state, per arc: (begin, end)


# ---------------------------------------------------------------------------
# timed word lattice (keeps arcs 1:1 with the decoder's lattice — eps kept)
# ---------------------------------------------------------------------------


def lattice_word_fst_timed(
    lat: DenseFsa,
    loglikes: Optional[np.ndarray] = None,
    frames: Optional[np.ndarray] = None,
    acoustic_scale: float = 1.0,
) -> Tuple[Fst, ArcTimes]:
    """Like lattice.lattice_word_fst but WITHOUT epsilon removal, returning
    per-arc frame times.  MBR consumes epsilon word arcs natively (Kaldi
    lattices likewise carry word-0 arcs for optional silence), so keeping the
    arcs 1:1 with the time-synchronous lattice preserves exact times for the
    CTM / sausage output.
    """
    if lat.olabel is None:
        raise ValueError("lattice has no word labels (olabel is None)")
    f = Fst()
    for _ in range(lat.num_states):
        f.add_state()
    f.set_start(lat.start)
    w = lat.weight.astype(np.float64).copy()
    if loglikes is not None:
        if frames is None:
            raise ValueError("need per-state frames to fold acoustic scores")
        w = w + acoustic_scale * loglikes[frames[lat.src], lat.pdf]
    times: ArcTimes = [[] for _ in range(lat.num_states)]
    for e in range(lat.num_arcs):
        s, d = int(lat.src[e]), int(lat.dst[e])
        lab = int(lat.olabel[e])
        f.add_arc(s, lab, lab, float(w[e]), d)
        times[s].append((float(frames[s]), float(frames[d]))
                        if frames is not None else (0.0, 0.0))
    for s in range(lat.num_states):
        if np.isfinite(lat.final[s]):
            f.set_final(s, float(lat.final[s]))
    return f, times


def _trim_with_times(f: Fst, times: Optional[ArcTimes]
                     ) -> Tuple[Fst, Optional[ArcTimes]]:
    """connect() that carries the parallel arc-times structure along."""
    if f.start < 0 or not f.finals:
        raise ValueError("empty lattice (no start or no final states)")
    n = f.num_states
    fwd = [[] for _ in range(n)]
    bwd = [[] for _ in range(n)]
    for s in range(n):
        for a in f.arcs[s]:
            fwd[s].append(a.nextstate)
            bwd[a.nextstate].append(s)
    acc = np.zeros(n, bool)
    stack = [f.start]
    acc[f.start] = True
    while stack:
        s = stack.pop()
        for d in fwd[s]:
            if not acc[d]:
                acc[d] = True
                stack.append(d)
    coacc = np.zeros(n, bool)
    stack = [s for s in f.finals if acc[s]]
    for s in stack:
        coacc[s] = True
    while stack:
        s = stack.pop()
        for m in bwd[s]:
            if not coacc[m]:
                coacc[m] = True
                stack.append(m)
    keep = acc & coacc
    if not keep[f.start]:
        raise ValueError("no complete path in lattice")
    if keep.all():
        return f, times
    remap = np.full(n, -1, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    out = Fst()
    out_times: ArcTimes = []
    for _ in range(int(keep.sum())):
        out.add_state()
        out_times.append([])
    out.set_start(int(remap[f.start]))
    for s in range(n):
        if not keep[s]:
            continue
        ns = int(remap[s])
        for k, a in enumerate(f.arcs[s]):
            if keep[a.nextstate]:
                out.add_arc(ns, a.ilabel, a.olabel, a.weight,
                            int(remap[a.nextstate]))
                out_times[ns].append(times[s][k] if times else (0.0, 0.0))
        if s in f.finals:
            out.set_final(ns, f.finals[s])
    return out, (out_times if times else None)


# ---------------------------------------------------------------------------
# posterior machinery shared by pruning and MBR
# ---------------------------------------------------------------------------


def _flatten(f: Fst, times: Optional[ArcTimes]):
    """Arc arrays + a single superfinal state (finals become eps arcs)."""
    src, dst, word, w, tb, te = [], [], [], [], [], []
    t_end = 0.0
    if times:
        for per_state in times:
            for (_b, e) in per_state:
                t_end = max(t_end, e)
    for s in range(f.num_states):
        for k, a in enumerate(f.arcs[s]):
            src.append(s)
            dst.append(a.nextstate)
            word.append(a.ilabel)
            w.append(a.weight)
            b, e = times[s][k] if times else (0.0, 0.0)
            tb.append(b)
            te.append(e)
    sf = f.num_states
    for s, fw in f.finals.items():
        src.append(s)
        dst.append(sf)
        word.append(EPS)
        w.append(fw)
        tb.append(t_end)
        te.append(t_end)
    return (np.asarray(src), np.asarray(dst), np.asarray(word),
            np.asarray(w, np.float64), np.asarray(tb), np.asarray(te),
            sf, t_end)


def _topo_states(n_states: int, src: np.ndarray, dst: np.ndarray,
                 start: int) -> List[int]:
    indeg = np.zeros(n_states, np.int64)
    np.add.at(indeg, dst, 1)
    out_arcs: List[List[int]] = [[] for _ in range(n_states)]
    for e in range(len(src)):
        out_arcs[int(src[e])].append(e)
    stack = [s for s in range(n_states) if indeg[s] == 0]
    order = []
    while stack:
        s = stack.pop()
        order.append(s)
        for e in out_arcs[s]:
            d = int(dst[e])
            indeg[d] -= 1
            if indeg[d] == 0:
                stack.append(d)
    if len(order) != n_states:
        raise ValueError("lattice is cyclic — MBR/pruning need acyclic input")
    return order


def arc_log_posteriors(f: Fst) -> Tuple[List[np.ndarray], float]:
    """Log arc posteriors of an acyclic lattice (log-semiring FB).

    Returns (per-state arrays aligned with ``f.arcs[s]``, total log-prob).
    The raw material for word confidences and posterior-based pruning —
    Kaldi's ``LatticeForwardBackward`` over a word lattice.
    """
    ft, _ = _trim_with_times(f, None)
    src, dst, word, w, tb, te, sf, _ = _flatten(ft, None)
    n = sf + 1
    order = _topo_states(n, src, dst, ft.start)
    in_arcs: List[List[int]] = [[] for _ in range(n)]
    for e in range(len(src)):
        in_arcs[int(dst[e])].append(e)
    alpha = np.full(n, -np.inf)
    alpha[ft.start] = 0.0
    for s in order:
        for e in in_arcs[s]:
            alpha[s] = np.logaddexp(alpha[s], alpha[src[e]] + w[e])
    beta = np.full(n, -np.inf)
    beta[sf] = 0.0
    out_arcs: List[List[int]] = [[] for _ in range(n)]
    for e in range(len(src)):
        out_arcs[int(src[e])].append(e)
    for s in reversed(order):
        for e in out_arcs[s]:
            beta[s] = np.logaddexp(beta[s], w[e] + beta[dst[e]])
    log_z = alpha[sf]
    post: List[np.ndarray] = []
    e = 0
    for s in range(ft.num_states):
        k = len(ft.arcs[s])
        post.append(alpha[src[e:e + k]] + w[e:e + k] + beta[dst[e:e + k]]
                    - log_z)
        e += k
    # NB: post is aligned with the TRIMMED fst; same shape as f when f was
    # already trimmed (decoder lattices are).
    if ft.num_states != f.num_states:
        raise ValueError("lattice has useless states — trim it first "
                         "(decode-side lattices are already trimmed)")
    return post, float(log_z)


def prune_posterior(f: Fst, beam: float) -> Fst:
    """Kaldi ``lattice-prune``: drop arcs/states whose best path through them
    falls more than ``beam`` below the lattice best path (tropical scores).
    """
    ft, _ = _trim_with_times(f, None)
    src, dst, word, w, tb, te, sf, _ = _flatten(ft, None)
    n = sf + 1
    order = _topo_states(n, src, dst, ft.start)
    in_arcs: List[List[int]] = [[] for _ in range(n)]
    out_arcs: List[List[int]] = [[] for _ in range(n)]
    for e in range(len(src)):
        in_arcs[int(dst[e])].append(e)
        out_arcs[int(src[e])].append(e)
    valpha = np.full(n, -np.inf)
    valpha[ft.start] = 0.0
    for s in order:
        for e in in_arcs[s]:
            valpha[s] = max(valpha[s], valpha[src[e]] + w[e])
    vbeta = np.full(n, -np.inf)
    vbeta[sf] = 0.0
    for s in reversed(order):
        for e in out_arcs[s]:
            vbeta[s] = max(vbeta[s], w[e] + vbeta[dst[e]])
    best = valpha[sf]
    out = Fst()
    for _ in range(ft.num_states):
        out.add_state()
    out.set_start(ft.start)
    e = 0
    for s in range(ft.num_states):
        for a in ft.arcs[s]:
            if valpha[s] + a.weight + vbeta[a.nextstate] >= best - beam:
                out.add_arc(s, a.ilabel, a.olabel, a.weight, a.nextstate)
            e += 1
    for s, fw in ft.finals.items():
        if valpha[s] + fw >= best - beam:
            out.set_final(s, fw)
    return out.connect()


# ---------------------------------------------------------------------------
# MBR / consensus decoding
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MbrResult:
    words: List[int]                      # consensus transcript (eps-free)
    confidences: List[float]              # per output word, in [0, 1]
    times: List[Tuple[float, float]]      # per output word (frames)
    bayes_risk: float                     # expected #word errors of `words`
    bins: List[Dict[int, float]]          # full sausage (eps bins included)
    bin_times: List[Tuple[float, float]]  # per sausage bin


def _l(a: int, b: int) -> float:
    return 0.0 if a == b else 1.0


def _normalize_eps(words: Sequence[int]) -> List[int]:
    """eps-interleave: (w1..wN) → (eps, w1, eps, w2, …, wN, eps).

    The eps slots give lattice insertions a sausage bin to land in, per the
    Xu et al. formulation (Kaldi sausages.cc does the same normalization).
    """
    out = [EPS]
    for w in words:
        if w != EPS:
            out.append(w)
            out.append(EPS)
    return out


def _viterbi_words(start: int, n: int, order: List[int],
                   in_arcs: List[List[int]], src, word, w, sf) -> List[int]:
    best = np.full(n, -np.inf)
    best[start] = 0.0
    back = np.full(n, -1, np.int64)
    for s in order:
        for e in in_arcs[s]:
            cand = best[src[e]] + w[e]
            if cand > best[s]:
                best[s] = cand
                back[s] = e
    words: List[int] = []
    s = sf
    while s != start:
        e = int(back[s])
        if e < 0:
            raise ValueError("no complete path in lattice")
        if word[e] != EPS:
            words.append(int(word[e]))
        s = int(src[e])
    words.reverse()
    return words


def _prep(f: Fst, arc_times: Optional[ArcTimes]):
    """Trim/flatten a lattice and precompute the alignment machinery."""
    ft, times = _trim_with_times(f, arc_times)
    src, dst, word, w, tb, te, sf, _t_end = _flatten(ft, times)
    n = sf + 1
    n_arc = len(src)
    order = _topo_states(n, src, dst, ft.start)
    in_arcs: List[List[int]] = [[] for _ in range(n)]
    for e in range(n_arc):
        in_arcs[int(dst[e])].append(e)

    # forward log-probs → per-arc conditional weights cw(a) = P(a | reach dst):
    # the backward Markov chain of the exact posterior path distribution.
    alpha = np.full(n, -np.inf)
    alpha[ft.start] = 0.0
    for s in order:
        for e in in_arcs[s]:
            alpha[s] = np.logaddexp(alpha[s], alpha[src[e]] + w[e])
    cw = np.exp(alpha[src] + w - alpha[dst])
    topo_tail = [s for s in order if s != ft.start]
    ins_cost = np.array([_l(int(word[e]), EPS) for e in range(n_arc)])
    return (ft, src, dst, word, w, tb, te, sf, n, n_arc, order, in_arcs, cw,
            topo_tail, ins_cost)


def _forward_pass(rn, start, sf, n, n_arc, src, word, cw, topo_tail, in_arcs,
                  ins_cost):
    """One soft-Levenshtein forward pass of the lattice against rn.

    Returns (expected edit distance, per-state rows, per-arc choices)."""
    q_len = len(rn)
    sub_cost = np.empty((n_arc, q_len + 1))
    sub_cost[:, 0] = np.inf
    for q in range(1, q_len + 1):
        r = rn[q - 1]
        sub_cost[:, q] = [_l(int(word[e]), r) for e in range(n_arc)]
    del_cost = np.concatenate([[0.0], [_l(EPS, r) for r in rn]])
    cumdel = np.cumsum(del_cost)

    alpha_dash = np.zeros((n, q_len + 1))
    alpha_dash[start] = cumdel
    bchoice = np.zeros((n_arc, q_len + 1), np.int8)
    for s in topo_tail:
        acc = np.zeros(q_len + 1)
        for e in in_arcs[s]:
            m = int(src[e])
            sub = np.empty(q_len + 1)
            sub[0] = np.inf
            sub[1:] = alpha_dash[m][:-1] + sub_cost[e, 1:]
            ins = alpha_dash[m] + ins_cost[e]
            c12 = np.minimum(sub, ins)
            b12 = np.where(sub <= ins, 1, 2).astype(np.int8)
            b12[0] = 2
            # deletion closure: row[q] = min(c12[q], row[q-1]+del[q])
            row = np.minimum.accumulate(c12 - cumdel) + cumdel
            b = np.where(row < c12 - 1e-12, 3, b12)
            acc += cw[e] * row
            bchoice[e] = b
        alpha_dash[s] = acc
    return float(alpha_dash[sf][q_len]), alpha_dash, bchoice


def expected_edit_distance(f: Fst, hyp: Sequence[int]) -> float:
    """Lattice-expected edit distance of a fixed hypothesis.

    The same recursion ``mbr_decode`` minimizes, evaluated once for ``hyp``
    — e.g. to compare the consensus against the best path under the SAME
    posterior measure, or to score an external hypothesis against a lattice
    (confidence-style risk).
    """
    (ft, src, dst, word, w, tb, te, sf, n, n_arc, order, in_arcs, cw,
     topo_tail, ins_cost) = _prep(f, None)
    rn = _normalize_eps(list(hyp))
    risk, _, _ = _forward_pass(rn, ft.start, sf, n, n_arc, src, word, cw,
                               topo_tail, in_arcs, ins_cost)
    return risk


def mbr_decode(f: Fst, arc_times: Optional[ArcTimes] = None,
               max_iters: int = 20) -> MbrResult:
    """Consensus decoding of an acyclic word lattice (eps arcs allowed).

    Each iteration soft-aligns the whole lattice against the current
    hypothesis R with the edit-distance recursion, producing per-position
    word posteriors gamma (the sausage); R is replaced by the per-bin argmax
    until it stops changing.  ``bayes_risk`` is the lattice-expected number
    of word errors of the returned transcript; per-word ``confidences`` are
    its bin posteriors (what ``lattice-to-ctm-conf`` prints).

    The risk estimate carries the recursion's standard approximation (the
    per-arc min over edit choices is taken against prefix-averaged
    accumulators, as in Kaldi): exact when merged paths share edit-distance
    rows (e.g. disjoint suffixes), a close estimate otherwise — the
    tests verify the *decisions* against brute-force expected WER.
    """
    (ft, src, dst, word, w, tb, te, sf, n, n_arc, order, in_arcs, cw,
     topo_tail, ins_cost) = _prep(f, arc_times)

    R = _viterbi_words(ft.start, n, order, in_arcs, src, word, w, sf)

    gamma: List[Dict[int, float]] = []
    tau = None
    risk = 0.0
    rn: List[int] = []
    r_hat: List[int] = []
    for _ in range(max(max_iters, 1)):
        rn = _normalize_eps(R)
        q_len = len(rn)
        risk, alpha_dash, bchoice = _forward_pass(
            rn, ft.start, sf, n, n_arc, src, word, cw, topo_tail, in_arcs,
            ins_cost)

        # ---- backward occupancy pass → sausage stats ---------------------
        beta_dash = np.zeros((n, q_len + 1))
        beta_dash[sf][q_len] = 1.0
        gamma = [dict() for _ in range(q_len + 1)]
        tau = np.zeros((q_len + 1, 3))  # (sum begin, sum end, mass)
        for s in reversed(topo_tail):
            bd = beta_dash[s]
            if not bd.any():
                continue
            for e in in_arcs[s]:
                if cw[e] == 0.0:
                    continue
                occ = cw[e] * bd
                if not occ.any():
                    continue
                m = int(src[e])
                wd = int(word[e])
                b = bchoice[e]
                carry = 0.0
                for q in range(q_len, -1, -1):
                    mass = occ[q] + carry
                    carry = 0.0
                    if mass == 0.0:
                        continue
                    if b[q] == 3:          # deletion of rn[q]
                        gamma[q][EPS] = gamma[q].get(EPS, 0.0) + mass
                        carry = mass
                    elif b[q] == 1:        # wd aligned to bin q
                        gamma[q][wd] = gamma[q].get(wd, 0.0) + mass
                        tau[q] += (mass * tb[e], mass * te[e], mass)
                        beta_dash[m][q - 1] += mass
                    else:                  # insertion: credit the bin it
                        # passes over (renormalized below); an eps "insertion"
                        # is a pure pass-through, not an alignment event —
                        # decoded lattices are mostly eps word arcs
                        if wd != EPS and q_len:
                            qq = max(q, 1)
                            gamma[qq][wd] = gamma[qq].get(wd, 0.0) + mass
                            tau[qq] += (mass * tb[e], mass * te[e], mass)
                        beta_dash[m][q] += mass

        # occupancy resting at the start state with q > 0 is the base-case
        # alpha_dash[start] = cumdel: those bins were deleted before the
        # path's first arc — credit them as eps alignments
        rest = 0.0
        for q in range(q_len, 0, -1):
            rest += beta_dash[ft.start][q]
            if rest > 0.0:
                gamma[q][EPS] = gamma[q].get(EPS, 0.0) + rest

        for q in range(1, q_len + 1):
            tot = sum(gamma[q].values())
            if tot > 0:
                for k in gamma[q]:
                    gamma[q][k] /= tot
        r_hat = []
        for q in range(1, q_len + 1):
            if not gamma[q]:
                r_hat.append(rn[q - 1])
                continue
            cur = rn[q - 1]
            best_w, best_p = cur, gamma[q].get(cur, 0.0)
            for k in sorted(gamma[q]):
                if gamma[q][k] > best_p + 1e-12:
                    best_w, best_p = k, gamma[q][k]
            r_hat.append(best_w)
        if r_hat == rn:
            break
        R = [x for x in r_hat if x != EPS]

    # ---- outputs: aligned to the last-scored rn (gamma/tau/r_hat) --------
    q_len = len(rn)
    bins = [gamma[q] for q in range(1, q_len + 1)]
    bin_times: List[Tuple[float, float]] = []
    prev_end = 0.0
    for q in range(1, q_len + 1):
        if tau is not None and tau[q, 2] > 0:
            b0, e0 = tau[q, 0] / tau[q, 2], tau[q, 1] / tau[q, 2]
        else:  # pure-deletion bin: zero-width at the running position
            b0 = e0 = prev_end
        b0 = max(b0, prev_end)        # keep CTM times monotonic
        e0 = max(e0, b0)
        bin_times.append((b0, e0))
        prev_end = b0  # begins must not go backwards; ends may interleave
    words, confs, wtimes = [], [], []
    for q in range(1, q_len + 1):
        wd = r_hat[q - 1]
        if wd == EPS:
            continue
        words.append(wd)
        confs.append(float(bins[q - 1].get(wd, 1.0)))
        wtimes.append(bin_times[q - 1])
    return MbrResult(words=words, confidences=confs, times=wtimes,
                     bayes_risk=risk, bins=bins, bin_times=bin_times)


def write_ctm(fh, uid: str, res: MbrResult, frame_shift: float = 0.01,
              id2w: Optional[Dict[int, str]] = None, channel: int = 1
              ) -> None:
    """One utterance of NIST CTM with confidences (lattice-to-ctm-conf)."""
    for wd, conf, (b, e) in zip(res.words, res.confidences, res.times):
        name = id2w.get(wd, f"<{wd}>") if id2w else str(wd)
        dur = max(e - b, 1.0) * frame_shift
        fh.write(f"{uid} {channel} {b * frame_shift:.3f} {dur:.3f} "
                 f"{name} {conf:.3f}\n")
