"""Phone-bigram LM estimation from alignments (LF-MMI-style denominator LM).

Reference context: Kaldi's chain denominator graph uses a phone LM estimated
from training alignments; the reference's on-the-fly den lattices come from a
word-level HCLG instead (SURVEY.md §8 hard part 2). The fixed-graph path here
needs this LM.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


def collapse_to_phones(frame_phones: np.ndarray) -> np.ndarray:
    """Per-frame phone labels → phone sequence (collapse runs)."""
    fp = np.asarray(frame_phones)
    if fp.size == 0:
        return fp
    keep = np.concatenate([[True], fp[1:] != fp[:-1]])
    return fp[keep]


def estimate_phone_bigram(
    phone_seqs: Iterable[Sequence[int]],
    phones: Sequence[int],
    smoothing: float = 1.0,
) -> dict:
    """Add-k smoothed bigram over phone ids.

    Returns dict with 1-based phone-id-indexed arrays (index 0 unused):
      log_init[p]      = log P(p | <s>)
      log_bigram[p, q] = log P(q | p)
      log_final[p]     = log P(</s> | p)
    """
    phones = sorted(phones)
    max_p = max(phones)
    init = np.full(max_p + 1, smoothing)
    big = np.full((max_p + 1, max_p + 1), smoothing)
    fin = np.full(max_p + 1, smoothing)
    valid = np.zeros(max_p + 1, bool)
    valid[np.asarray(phones)] = True
    init[~valid] = 0
    big[~valid, :] = 0
    big[:, ~valid] = 0
    fin[~valid] = 0
    for seq in phone_seqs:
        seq = [int(p) for p in seq]
        if not seq:
            continue
        init[seq[0]] += 1
        for a, b in zip(seq[:-1], seq[1:]):
            big[a, b] += 1
        fin[seq[-1]] += 1
    log_init = np.full(max_p + 1, -np.inf)
    log_init[valid] = np.log(init[valid] / init[valid].sum())
    log_big = np.full((max_p + 1, max_p + 1), -np.inf)
    log_fin = np.full(max_p + 1, -np.inf)
    for p in phones:
        tot = big[p, valid].sum() + fin[p]
        log_big[p, valid] = np.log(big[p, valid] / tot)
        log_fin[p] = np.log(fin[p] / tot)
    return {"log_init": log_init.astype(np.float32),
            "log_bigram": log_big.astype(np.float32),
            "log_final": log_fin.astype(np.float32),
            "phones": list(phones)}
