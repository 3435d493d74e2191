"""Frame splicing (context windows), Kaldi ``splice-feats`` semantics, in torch.

Port of pykaldi2_tpu/frontend/splice.py (reference behavior:
kaldi/src/feat/feature-functions.cc ``SpliceFrames`` — concatenate frames
t-L..t+R with clamped (replicated) edges).
"""

from __future__ import annotations

import torch


def splice_frames(feats: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """[..., T, D] → [..., T, D*(left+1+right)]."""
    if left == 0 and right == 0:
        return feats
    t = feats.shape[-2]
    lead, d = feats.shape[:-2], feats.shape[-1]
    first = feats[..., :1, :].expand(*lead, left, d)
    last = feats[..., -1:, :].expand(*lead, right, d)
    padded = torch.cat([first, feats, last], dim=-2)
    cols = [padded[..., off : off + t, :] for off in range(left + 1 + right)]
    return torch.cat(cols, dim=-1)
