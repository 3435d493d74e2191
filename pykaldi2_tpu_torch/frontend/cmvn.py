"""Cepstral mean/variance normalization, Kaldi semantics, in torch.

Port of pykaldi2_tpu/frontend/cmvn.py (reference behavior:
kaldi/src/transform/cmvn.{h,cc} and featbin/{compute-cmvn-stats,apply-cmvn}.cc).

Stats layout follows Kaldi: a [2, dim+1] matrix — row 0 = per-dim sums with
count in the last column; row 1 = per-dim sum-of-squares (last col unused).
"""

from __future__ import annotations

import numpy as np
import torch


def acc_cmvn_stats(feats: np.ndarray, stats: np.ndarray | None = None, mask=None) -> np.ndarray:
    """Accumulate Kaldi-layout CMVN stats from [T, D] features (host-side)."""
    feats = np.asarray(feats, dtype=np.float64)
    t, d = feats.shape
    if stats is None:
        stats = np.zeros((2, d + 1), dtype=np.float64)
    if mask is not None:
        mask = np.asarray(mask, dtype=np.float64)[:, None]
        feats = feats * mask
        count = float(mask.sum())
    else:
        count = float(t)
    stats = stats.astype(np.float64).copy()
    stats[0, :d] += feats.sum(axis=0)
    stats[0, d] += count
    stats[1, :d] += (feats * feats).sum(axis=0)
    return stats


def cmvn_mean_std(stats: np.ndarray, norm_vars: bool, var_floor: float = 1e-20):
    """stats [2, D+1] → (mean [D], scale [D]) with Kaldi's variance flooring."""
    stats = np.asarray(stats, dtype=np.float64)
    d = stats.shape[1] - 1
    count = stats[0, d]
    if count < 1.0:
        raise ValueError("CMVN stats have zero count")
    mean = stats[0, :d] / count
    if norm_vars:
        var = stats[1, :d] / count - mean * mean
        var = np.maximum(var, var_floor)
        scale = 1.0 / np.sqrt(var)
    else:
        scale = np.ones(d)
    return mean.astype(np.float32), scale.astype(np.float32)


def apply_cmvn(feats: torch.Tensor, mean, scale, norm_means: bool = True) -> torch.Tensor:
    """[..., T, D] → normalized; mean/scale broadcast over leading dims."""
    mean = torch.as_tensor(mean, dtype=feats.dtype, device=feats.device)
    scale = torch.as_tensor(scale, dtype=feats.dtype, device=feats.device)
    if norm_means:
        feats = feats - mean
    return feats * scale


def utterance_cmvn(
    feats: torch.Tensor, norm_vars: bool = False, mask: torch.Tensor | None = None,
    var_floor: float = 1e-20,
) -> torch.Tensor:
    """Per-utterance CMVN; ``mask`` [.., T] excludes padding frames."""
    # Centered two-pass variance: E[(x-m)^2], not E[x^2]-E[x]^2 — the latter
    # catastrophically cancels in fp32 for near-constant dims.
    if mask is None:
        mean = torch.mean(feats, dim=-2, keepdim=True)
        out = feats - mean
        if norm_vars:
            var = torch.mean(out * out, dim=-2, keepdim=True)
    else:
        m = mask[..., None].to(feats.dtype)
        count = torch.clamp(torch.sum(m, dim=-2, keepdim=True), min=1.0)
        mean = torch.sum(feats * m, dim=-2, keepdim=True) / count
        out = feats - mean
        if norm_vars:
            var = torch.sum(out * out * m, dim=-2, keepdim=True) / count
    if norm_vars:
        out = out * torch.rsqrt(torch.clamp(var, min=var_floor))
    return out


class SpeakerCmvn:
    """Per-speaker CMVN (Kaldi ``apply-cmvn --utt2spk=ark:utt2spk
    scp:cmvn.scp`` semantics): an utt2spk table plus per-speaker [2, D+1]
    stats resolve each utterance to its speaker's (mean, scale)."""

    def __init__(self, utt2spk_path: str, spk_stats_scp: str,
                 norm_means: bool = True, norm_vars: bool = False):
        from pykaldi2_tpu_torch.data import kaldi_io

        self.norm_means = norm_means
        self.utt2spk = {}
        with open(utt2spk_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    self.utt2spk[parts[0]] = parts[1]
        self.spk_ms = {}
        for spk, rx in kaldi_io.read_scp(spk_stats_scp):
            stats = kaldi_io.read_scp_entry(rx, "mat")
            self.spk_ms[spk] = cmvn_mean_std(stats, norm_vars)
        self.dim = next(iter(self.spk_ms.values()))[0].shape[0] if self.spk_ms else 0

    def lookup(self, utt_id: str):
        """(mean [D], scale [D]) for an utterance; KeyError like Kaldi if the
        utterance or its speaker has no stats."""
        spk = self.utt2spk.get(utt_id)
        if spk is None:
            raise KeyError(f"utterance {utt_id!r} missing from utt2spk")
        ms = self.spk_ms.get(spk)
        if ms is None:
            raise KeyError(f"speaker {spk!r} has no CMVN stats")
        return ms

    def batch(self, utt_ids):
        """Stacked (mean [B, D], scale [B, D]) numpy arrays for a batch."""
        ms = [self.lookup(u) for u in utt_ids]
        return (np.stack([m for m, _ in ms]).astype(np.float32),
                np.stack([s for _, s in ms]).astype(np.float32))


def apply_cmvn_sliding(
    feats: torch.Tensor, window: int = 600, norm_vars: bool = False, var_floor: float = 1e-10
) -> torch.Tensor:
    """Sliding-window CMVN (kaldi apply-cmvn-sliding, center=true semantics),
    with cumulative sums — O(T)."""
    t = feats.shape[-2]
    cs = torch.cumsum(feats, dim=-2)
    cs2 = torch.cumsum(feats * feats, dim=-2)
    zeros = torch.zeros_like(cs[..., :1, :])
    cs = torch.cat([zeros, cs], dim=-2)
    cs2 = torch.cat([zeros, cs2], dim=-2)
    idx = torch.arange(t, device=feats.device)
    lo = torch.clamp(idx - window // 2, 0, t)
    hi = torch.clamp(idx + (window + 1) // 2, 0, t)
    # widen truncated edge windows to `window` frames where possible, as Kaldi does
    lo2 = torch.where(hi - lo < window, torch.clamp(hi - window, 0, t), lo)
    hi2 = torch.where(hi - lo2 < window, torch.clamp(lo2 + window, 0, t), hi)
    lo, hi = lo2, hi2
    count = (hi - lo).to(feats.dtype)[..., None]
    s = cs[..., hi, :] - cs[..., lo, :]
    s2 = cs2[..., hi, :] - cs2[..., lo, :]
    mean = s / count
    out = feats - mean
    if norm_vars:
        var = s2 / count - mean * mean
        out = out * torch.rsqrt(torch.clamp(var, min=var_floor))
    return out
