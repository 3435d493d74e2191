"""ARPA n-gram language models: reader → backoff G FST, trainer/writer.

Numpy copy of pykaldi2_tpu/graph/arpa.py. It replaces the Kaldi/OpenFst
word-LM path of the reference's eval decode (SURVEY.md §3.2 "Kaldi graph
build", §4.4): reference recipes build G.fst from an ARPA file with
arpa2fst; here ``read_arpa`` parses the ARPA text and
``arpa_to_fst`` emits the standard backoff acceptor (one state per seen
history, eps backoff arcs, per-history </s> final weights) as a VectorFst
ready for ``VectorFst.compose`` with the lexicon.

A small Witten-Bell trainer (``train_arpa``) covers recipe bootstrapping and
tests — the reference consumed externally-trained LMs, so any smoothing that
yields a valid normalized backoff model suffices for parity of mechanism.

Weights: ARPA stores log10 probabilities; FST weights are natural-log probs
(higher = better) per graph/fst.py convention.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from pykaldi2_tpu_torch.graph.fst import EPS
from pykaldi2_tpu_torch.graph.vfst import VectorFst

LN10 = math.log(10.0)
BOS, EOS, UNK = "<s>", "</s>", "<unk>"


class ArpaModel:
    """Parsed ARPA model: ngrams[order][(w1..wn)] = (logp_e, backoff_e)."""

    def __init__(self, order: int):
        self.order = order
        self.ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [
            {} for _ in range(order + 1)]  # index by order, [0] unused

    def logp(self, words: Sequence[str]) -> float:
        """Backoff probability ln p(w_n | w_1..w_{n-1})."""
        words = tuple(words)
        n = len(words)
        if n == 0:
            raise ValueError("empty query")
        table = self.ngrams[min(n, self.order)]
        if n <= self.order and words in table:
            return table[words][0]
        if n == 1:
            return float("-inf")  # true OOV
        hist = words[:-1]
        bow = 0.0
        if len(hist) < self.order:
            ent = self.ngrams[len(hist)].get(hist)
            if ent is not None:
                bow = ent[1]
        return bow + self.logp(words[1:])


def read_arpa(path: str) -> ArpaModel:
    """Parse an ARPA file (log10 → natural log)."""
    counts: Dict[int, int] = {}
    model: Optional[ArpaModel] = None
    section = 0
    with open(path, encoding="utf-8", errors="replace") as f:
        it = iter(f)
        for line in it:
            line = line.strip()
            if not line:
                continue
            if line == "\\data\\":
                section = -1
                continue
            if section == -1 and line.startswith("ngram "):
                lhs, rhs = line[len("ngram "):].split("=")
                counts[int(lhs)] = int(rhs)
                continue
            if line.endswith("-grams:") and line.startswith("\\"):
                section = int(line[1:line.index("-")])
                if model is None:
                    model = ArpaModel(max(counts) if counts else section)
                continue
            if line == "\\end\\":
                break
            if section > 0:
                parts = line.split()
                logp = float(parts[0]) * LN10
                words = tuple(parts[1 : 1 + section])
                backoff = 0.0
                if len(parts) > 1 + section:
                    backoff = float(parts[1 + section]) * LN10
                model.ngrams[section][words] = (logp, backoff)
    if model is None:
        raise ValueError(f"{path}: not an ARPA file (missing \\data\\ section)")
    return model


def arpa_to_fst(model: ArpaModel, word_ids: Dict[str, int],
                unk: Optional[str] = None) -> VectorFst:
    """Standard backoff acceptor over word ids.

    States: one per seen history (orders 0..order-1). For ngram (h, w):
    arc state(h) --w/w--> state(longest seen suffix of h+w); (h, </s>)
    becomes a final weight; each history backs off to its suffix state via
    an eps arc weighted by the backoff weight. Start = state((<s>,)) when
    the LM has one, else the unigram state. Words absent from ``word_ids``
    are dropped (or mapped to ``unk`` if given).
    """
    hist_id: Dict[Tuple[str, ...], int] = {(): 0}

    def hist_state(h: Tuple[str, ...]) -> int:
        if h not in hist_id:
            hist_id[h] = len(hist_id)
        return hist_id[h]

    # materialize states for every history that can be a context
    for n in range(1, model.order):
        for words in model.ngrams[n]:
            if words[-1] != EOS:
                hist_state(words)

    def dest_hist(full: Tuple[str, ...]) -> Tuple[str, ...]:
        h = full[-(model.order - 1):] if model.order > 1 else ()
        while h and h not in hist_id:
            h = h[1:]
        return h

    src_l, dst_l, lab_l, w_l = [], [], [], []
    finals: Dict[int, float] = {}
    for n in range(1, model.order + 1):
        for words, (logp, _bow) in model.ngrams[n].items():
            hist, w = words[:-1], words[-1]
            if hist not in hist_id and n > 1:
                continue  # unreachable context (pruned LM)
            s = hist_state(hist) if n > 1 else hist_state(())
            if w == EOS:
                finals[s] = logp
                continue
            if w == BOS:
                continue  # <s> is a history, never an emitted symbol
            wid = word_ids.get(w)
            if wid is None and unk is not None:
                wid = word_ids.get(unk)
            if wid is None:
                continue
            src_l.append(s)
            dst_l.append(hist_state(dest_hist(words)))
            lab_l.append(wid)
            w_l.append(logp)
    # backoff arcs
    for h, s in list(hist_id.items()):
        if not h:
            continue
        ent = model.ngrams[len(h)].get(h)
        bow = ent[1] if ent is not None else 0.0
        suf = h[1:]
        while suf and suf not in hist_id:
            suf = suf[1:]
        src_l.append(s)
        dst_l.append(hist_id.get(suf, 0))
        lab_l.append(EPS)
        w_l.append(bow)

    n_states = len(hist_id)
    final = np.full(n_states, -np.inf, np.float32)
    for s, fw in finals.items():
        final[s] = fw
    start = hist_id.get((BOS,), 0)
    return VectorFst(
        n_states, start,
        np.asarray(src_l, np.int32), np.asarray(dst_l, np.int32),
        np.asarray(lab_l, np.int32), np.asarray(lab_l, np.int32),
        np.asarray(w_l, np.float32), final)


# ---------------------------------------------------------------------------
# Witten-Bell ARPA trainer (for recipes/tests; reference LMs come pre-built)
# ---------------------------------------------------------------------------


def train_arpa(sentences: Iterable[Sequence[str]], order: int = 3,
               path: Optional[str] = None) -> ArpaModel:
    """Interpolated Witten-Bell n-gram LM over tokenized sentences.

    p(w|h) = (c(hw) + T(h)·p(w|h')) / (c(h) + T(h)), with backoff weights
    chosen so the ARPA backoff representation reproduces the interpolated
    probabilities for seen ngrams and normalizes over unseen ones.
    """
    counts: List[Dict[Tuple[str, ...], int]] = [defaultdict(int) for _ in range(order + 1)]
    for sent in sentences:
        toks = [BOS] + list(sent) + [EOS]
        for n in range(1, order + 1):
            lo = 1 if n == 1 else 0   # skip the bare <s> unigram event
            for i in range(lo, len(toks) - n + 1):
                counts[n][tuple(toks[i : i + n])] += 1

    vocab = sorted({w for (w,) in counts[1]} | {EOS})

    # unigram distribution with a uniform interpolation floor (keeps every
    # vocab word probable so backoff always terminates)
    total1 = sum(counts[1].values())
    t1 = len(counts[1])
    v = len(vocab)
    p1: Dict[Tuple[str, ...], float] = {}
    for w in vocab:
        c = counts[1].get((w,), 0)
        p1[(w,)] = (c + t1 / v) / (total1 + t1)

    probs: List[Dict[Tuple[str, ...], float]] = [dict(), p1]
    for n in range(2, order + 1):
        # history stats
        hist_count: Dict[Tuple[str, ...], int] = defaultdict(int)
        hist_types: Dict[Tuple[str, ...], int] = defaultdict(int)
        for ng, c in counts[n].items():
            hist_count[ng[:-1]] += c
            hist_types[ng[:-1]] += 1
        pn: Dict[Tuple[str, ...], float] = {}
        for ng, c in counts[n].items():
            h = ng[:-1]
            T = hist_types[h]
            lower = probs[n - 1].get(ng[1:], p1.get(ng[-1:], 1.0 / max(v, 1)))
            pn[ng] = (c + T * lower) / (hist_count[h] + T)
        probs.append(pn)

    model = ArpaModel(order)
    # backoff weights per history of each order < order
    for n in range(1, order + 1):
        for ng, p in probs[n].items():
            model.ngrams[n][ng] = (math.log(p), 0.0)
    # also keep <s> as a unigram entry (prob ~0, it is never predicted) so
    # the (<s>,) history exists
    model.ngrams[1][(BOS,)] = (math.log(1e-99), 0.0)
    for n in range(1, order):
        seen_sum: Dict[Tuple[str, ...], float] = defaultdict(float)
        lower_sum: Dict[Tuple[str, ...], float] = defaultdict(float)
        for ng, p in probs[n + 1].items():
            h = ng[:-1]
            seen_sum[h] += p
            lower_sum[h] += probs[n].get(ng[1:], p1.get(ng[-1:], 0.0))
        for h in seen_sum:
            bow = (1.0 - seen_sum[h]) / max(1.0 - lower_sum[h], 1e-12)
            bow = max(bow, 1e-12)
            ent = model.ngrams[n].get(h, (math.log(1e-99), 0.0))
            model.ngrams[n][h] = (ent[0], math.log(bow))
    if path is not None:
        write_arpa(model, path)
    return model


def write_arpa(model: ArpaModel, path: str):
    """Serialize to ARPA text (natural log → log10)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        for n in range(1, model.order + 1):
            f.write(f"ngram {n}={len(model.ngrams[n])}\n")
        for n in range(1, model.order + 1):
            f.write(f"\n\\{n}-grams:\n")
            for words, (logp, bow) in sorted(model.ngrams[n].items()):
                line = f"{logp / LN10:.6f}\t{' '.join(words)}"
                if n < model.order and bow != 0.0:
                    line += f"\t{bow / LN10:.6f}"
                f.write(line + "\n")
        f.write("\n\\end\\\n")
