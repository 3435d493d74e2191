"""Sequence-training scores and priors.

Port of ``acoustic_scores``, ``priors_from_counts`` and ``count_labels``
from pykaldi2_tpu/ops/se_losses.py (reference behavior: the SE loss code in
pykaldi2/bin/train_se.py: scaled log-likelihoods (log-softmax − log-prior)
× acoustic_scale feed the denominator decode and forward-backward). The
fixed-denominator MMI/sMBR losses come with the fixed-denominator slice.
"""

from __future__ import annotations

import numpy as np
import torch


def acoustic_scores(logits: torch.Tensor, log_prior, acoustic_scale: float) -> torch.Tensor:
    """Pseudo-log-likelihoods: ascale * (log-softmax − log-prior), fp32."""
    logpost = torch.log_softmax(logits.to(torch.float32), dim=-1)
    if log_prior is not None:
        logpost = logpost - log_prior
    return acoustic_scale * logpost


def priors_from_counts(counts: np.ndarray, floor: float = 1e-10) -> np.ndarray:
    """Label counts → log-prior vector (the CE-stage prior for SE/decoding)."""
    counts = np.asarray(counts, np.float64)
    p = counts / max(counts.sum(), 1.0)
    return np.log(np.maximum(p, floor)).astype(np.float32)


def count_labels(label_iter, num_pdfs: int) -> np.ndarray:
    counts = np.zeros(num_pdfs, np.float64)
    for labels in label_iter:
        labels = np.asarray(labels)
        labels = labels[labels >= 0]
        counts += np.bincount(labels, minlength=num_pdfs)
    return counts
