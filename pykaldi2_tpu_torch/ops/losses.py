"""Frame-level cross-entropy with padding masks.

Port of pykaldi2_tpu/ops/losses.py (reference behavior:
``nn.CrossEntropyLoss`` over [B*T, C] with padded frames excluded); padding
contributes exactly zero loss and gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, T, C], labels [B, T] (-1 on padding), mask [B, T] →
    (mean CE over supervised frames, supervised frame count)."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    safe = torch.clamp(labels.long(), min=0)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    m = mask.to(torch.float32)
    count = torch.clamp(torch.sum(m), min=1.0)
    return -torch.sum(ll * m) / count, count


def frame_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).to(torch.float32) * mask
    return torch.sum(correct) / torch.clamp(torch.sum(mask), min=1.0)
