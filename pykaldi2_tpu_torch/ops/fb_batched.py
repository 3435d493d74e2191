"""Per-utterance segment sums and arc accuracies shared by the lattice kernels.

Port of ``_seg_sum_b`` and ``_arc_acc_b`` from pykaldi2_tpu/ops/fb_batched.py
(reference behavior: the per-lattice sums of Kaldi's lattice-functions.cc).
The generic per-utterance arc-table forward-backward (``BatchedGraphs``),
which only the reference's tests reach, is not ported yet: ROADMAP.md Queue
1, item 20.
"""

from __future__ import annotations

from typing import Optional

import torch

from pykaldi2_tpu_torch.ops.fb import SilenceOpts, frame_accuracy


def _seg_sum_b(values: torch.Tensor, ids: torch.Tensor, num_states: int) -> torch.Tensor:
    """values [B, E], ids [B, E] → [B, S] scatter-add per batch row."""
    out = values.new_zeros(values.shape[0], num_states)
    return out.scatter_add_(1, ids.long(), values)


def _arc_acc_b(pdf: torch.Tensor, ref_t: torch.Tensor, level: str, pdf_to_phone,
               silence: Optional[SilenceOpts] = None) -> torch.Tensor:
    """[B, E] per-arc frame accuracy of arc labels ``pdf`` vs ref_t [B]."""
    if level == "pdf":
        lab = pdf
    elif level == "phone":
        if pdf_to_phone is None:
            raise ValueError("level='phone' needs pdf_to_phone")
        lab = pdf_to_phone[torch.clamp(pdf, min=0).long()]
    else:
        raise ValueError(level)
    return frame_accuracy(lab, ref_t[:, None], level, silence)
