"""WER scoring: Levenshtein alignment + corpus aggregation.

Copy of pykaldi2_tpu/decode/wer.py for the PyTorch port.

Reference behavior: Kaldi compute-wer / score.sh (SURVEY.md §4.4).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> Dict[str, int]:
    """Levenshtein with sub/ins/del counts (all cost 1, Kaldi convention)."""
    r, h = len(ref), len(hyp)
    # dp[j] = (cost, subs, ins, dels)
    prev = [(j, 0, j, 0) for j in range(h + 1)]
    for i in range(1, r + 1):
        cur = [(i, 0, 0, i)] + [None] * h
        for j in range(1, h + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0], prev[j - 1], (0, 0, 0))]
            else:
                cand = [(prev[j - 1][0] + 1, prev[j - 1], (1, 0, 0))]
            cand.append((cur[j - 1][0] + 1, cur[j - 1], (0, 1, 0)))   # insertion
            cand.append((prev[j][0] + 1, prev[j], (0, 0, 1)))         # deletion
            cost, base, (ds, di, dd) = min(cand, key=lambda x: x[0])
            cur[j] = (cost, base[1] + ds, base[2] + di, base[3] + dd)
        prev = cur
    cost, subs, ins, dels = prev[h]
    return {"errors": cost, "subs": subs, "ins": ins, "dels": dels, "ref_len": r}


def score_corpus(refs: Dict[str, Sequence], hyps: Dict[str, Sequence]) -> Dict[str, float]:
    """Aggregate WER over utterances (missing hyps count as all-deletions)."""
    tot = {"errors": 0, "subs": 0, "ins": 0, "dels": 0, "ref_len": 0}
    n_utt = n_fail = 0
    for uid, ref in refs.items():
        hyp = hyps.get(uid)
        if hyp is None:
            hyp = []
            n_fail += 1
        d = edit_distance(list(ref), list(hyp))
        for k in tot:
            tot[k] += d[k]
        n_utt += 1
    wer = 100.0 * tot["errors"] / max(tot["ref_len"], 1)
    return {**tot, "wer": wer, "num_utts": n_utt, "num_missing": n_fail}
