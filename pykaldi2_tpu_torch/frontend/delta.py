"""Delta features, Kaldi semantics, in torch.

Port of pykaldi2_tpu/frontend/delta.py (reference behavior:
kaldi/src/feat/feature-functions.cc ``DeltaFeatures`` — regression
coefficients built recursively per order; edge frames use replicated
(clamped) context).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def delta_matrix(order: int = 2, window: int = 2) -> np.ndarray:
    """Per-order filter taps; returns [order+1, max_len] (centered, zero-padded).

    Matches Kaldi's DeltaFeaturesOptions(order, window) coefficient recursion:
    taps_o = taps_{o-1} * d where d = [-w..w]/sum(i^2).
    """
    scales = [np.array([1.0])]
    for _ in range(order):
        prev = scales[-1]
        w = window
        norm = sum(i * i for i in range(-w, w + 1))
        cur = np.zeros(prev.size + 2 * w)
        for off in range(-w, w + 1):
            cur[off + w : off + w + prev.size] += (off / norm) * prev
        scales.append(cur)
    max_len = scales[-1].size
    out = np.zeros((order + 1, max_len), dtype=np.float32)
    for o, s in enumerate(scales):
        pad = (max_len - s.size) // 2
        out[o, pad : pad + s.size] = s
    return out


def add_deltas(feats: torch.Tensor, order: int = 2, window: int = 2) -> torch.Tensor:
    """[..., T, D] → [..., T, D*(order+1)] with edge replication like Kaldi."""
    taps = delta_matrix(order, window)  # [order+1, K]
    k = taps.shape[1]
    half = k // 2
    t = feats.shape[-2]
    # replicate edges (Kaldi clamps the frame index at the boundaries)
    first = feats[..., :1, :].expand(*feats.shape[:-2], half, feats.shape[-1])
    last = feats[..., -1:, :].expand(*feats.shape[:-2], half, feats.shape[-1])
    padded = torch.cat([first, feats, last], dim=-2)
    outs = []
    for o in range(order + 1):
        # correlation: out[t] = sum_j taps[o, j] * padded[t + j]
        acc = torch.zeros_like(feats)
        for j in range(k):
            w = float(taps[o, j])
            if w == 0.0:
                continue
            acc = acc + w * padded[..., j : j + t, :]
        outs.append(acc)
    return torch.cat(outs, dim=-1)
