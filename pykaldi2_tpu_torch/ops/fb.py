"""Shared pieces of the forward-backward kernels: NEG_INF, the guarded log,
and Kaldi's silence rules for the sMBR/MPE frame accuracies.

Port of the part of pykaldi2_tpu/ops/fb.py that the banded lattice path
needs (reference behavior: kaldi/src/lat/lattice-functions.cc
LatticeForwardBackwardMpeVariants). The arc-table forward-backward over a
shared graph comes with the fixed-denominator slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# a finite "minus infinity": exp() of it underflows to 0, sums of two stay
# finite in fp32, and padding arcs and dead slots behave as in the reference
NEG_INF = -1e30


def log_safe(lin: torch.Tensor) -> torch.Tensor:
    """log of a nonneg linear value with 0 → NEG_INF."""
    pos = lin > 0.0
    return torch.where(pos, torch.log(torch.where(pos, lin, torch.ones_like(lin))),
                       torch.full_like(lin, NEG_INF))


class SilenceOpts(NamedTuple):
    """Kaldi silence-phone handling for the sMBR/MPE frame accuracies.

    With ``one_silence_class=False`` (the Kaldi default) a frame is correct
    iff its label matches the reference AND the hypothesis phone is NOT
    silence; with ``one_silence_class=True`` iff the label matches OR both
    hypothesis and reference are silence. ``sil_pdf`` [num_pdfs] /
    ``sil_phone`` [max_phone+1] are f32 {0,1} indicators in the label space
    each accuracy level compares (pdf for sMBR, phone for MPE/MPFE). Build
    with ``make_silence_opts``; ``to(device)`` moves the tables.
    """

    sil_pdf: Optional[torch.Tensor]
    sil_phone: Optional[torch.Tensor]
    one_silence_class: bool = False

    def to(self, device) -> "SilenceOpts":
        return self._replace(
            sil_pdf=None if self.sil_pdf is None else self.sil_pdf.to(device),
            sil_phone=None if self.sil_phone is None else self.sil_phone.to(device))


def make_silence_opts(tm, silence_phones,
                      one_silence_class: bool = False) -> Optional[SilenceOpts]:
    """SilenceOpts from a TransitionModel + silence phone ids (None if empty)."""
    sp = tuple(int(p) for p in (silence_phones or ()))
    if not sp:
        return None
    return SilenceOpts(
        sil_pdf=torch.as_tensor(tm.pdf_silence_mask(sp), dtype=torch.float32),
        sil_phone=torch.as_tensor(tm.phone_silence_mask(sp), dtype=torch.float32),
        one_silence_class=bool(one_silence_class))


def frame_accuracy(lab: torch.Tensor, ref: torch.Tensor, level: str,
                   silence: Optional[SilenceOpts]) -> torch.Tensor:
    """Per-frame accuracy of hypothesis labels vs reference labels
    (broadcastable int tensors in the ``level`` label space, pdf or phone):
    plain equality, or the MpeVariants silence rules with ``silence``."""
    match = (lab == ref).to(torch.float32)
    if silence is None:
        return match
    tbl = silence.sil_pdf if level == "pdf" else silence.sil_phone
    if tbl is None:
        raise ValueError(f"SilenceOpts lacks the {level!r}-level table")
    hyp_sil = tbl[torch.clamp(lab, min=0).long()]
    ref_sil = tbl[torch.clamp(ref, min=0).long()]
    if silence.one_silence_class:
        return torch.maximum(match, hyp_sil * ref_sil)
    return match * (1.0 - hyp_sil)
