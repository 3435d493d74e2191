"""Sequence-discriminative losses over a fixed denominator graph (MMI,
sMBR, MPE), the scaled scores they take, and priors.

Port of pykaldi2_tpu/ops/se_losses.py (reference behavior: the SE loss code
in pykaldi2/bin/train_se.py wrapping Kaldi's LatticeForwardBackwardMmi /
LatticeForwardBackwardMpeVariants): per batch, scaled log-likelihoods
(log-softmax − log-prior) × acoustic_scale feed a forward-backward over
the denominator; the MMI gradient is (num_post − den_post) with Kaldi's
drop_frames; sMBR/MPE use frame-accuracy-weighted posteriors. The
denominator graph is one of four packings, each with its own
forward-backward: the structured bigram graph (ops/fb_bigram.py), the dense
state matrix (ops/fb_dense.py), the block-sparse tiles (ops/fb_block.py,
kernel K11) or the arc tables (ops/fb.py). The decoded-lattice
denominators of ``train_se -on_the_fly`` live in ops/fb_lattice.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.ops.fb import (SilenceOpts, fsa_expected_accuracy, fsa_logz,
                                      fsa_occupancies)
from pykaldi2_tpu_torch.ops.fb_bigram import (BigramDenGraph, bigram_expected_accuracy,
                                             bigram_logz, bigram_occupancies)
from pykaldi2_tpu_torch.ops.fb_block import (BlockSparseGraph, fsa_expected_accuracy_block,
                                            fsa_logz_block, fsa_occupancies_block)
from pykaldi2_tpu_torch.ops.fb_dense import (DenseStateGraph, fsa_expected_accuracy_dense,
                                            fsa_logz_dense, fsa_occupancies_dense)

Tensor = torch.Tensor


def acoustic_scores(logits: torch.Tensor, log_prior, acoustic_scale: float) -> torch.Tensor:
    """Pseudo-log-likelihoods: ascale * (log-softmax − log-prior), fp32."""
    logpost = torch.log_softmax(logits.to(torch.float32), dim=-1)
    if log_prior is not None:
        logpost = logpost - log_prior
    return acoustic_scale * logpost


# the forward-backward functions of each denominator packing: (logZ with an
# occupancy gradient, (logZ, occupancies), expected accuracy); anything else
# is the arc tables
_ROUTES = (
    (BigramDenGraph, bigram_logz, bigram_occupancies, bigram_expected_accuracy),
    (DenseStateGraph, fsa_logz_dense, fsa_occupancies_dense, fsa_expected_accuracy_dense),
    (BlockSparseGraph, fsa_logz_block, fsa_occupancies_block, fsa_expected_accuracy_block),
)


def _route(graph):
    for cls, *fns in _ROUTES:
        if isinstance(graph, cls):
            return fns
    return fsa_logz, fsa_occupancies, fsa_expected_accuracy


def _graph_logz(obs: Tensor, graph, num_frames: Tensor) -> Tensor:
    """Dispatch: structured bigram / dense state-matmul / block-sparse /
    generic arc tables."""
    return _route(graph)[0](obs, graph, num_frames)


def _graph_occupancies(obs: Tensor, graph, num_frames: Tensor):
    return _route(graph)[1](obs, graph, num_frames)


def graph_expected_accuracy(obs: Tensor, graph, ref: Tensor, num_frames: Tensor,
                            level: str = "pdf",
                            silence: Optional[SilenceOpts] = None) -> Tensor:
    """E[#correct frames] [B] over any of the four denominator packings."""
    return _route(graph)[2](obs, graph, ref, num_frames, level, silence)


# ---------------------------------------------------------------------------
# MMI with a fixed numerator alignment (an autograd Function, so drop_frames
# acts on the gradient exactly like Kaldi's --drop-frames)
# ---------------------------------------------------------------------------


class _MmiObjective(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, ali, den_graph, num_frames, mask, drop_frames, den_scale):
        # logZ and the occupancies in one go: the backward only rescales them
        with torch.no_grad():
            logz_den, gamma_den = _graph_occupancies(obs, den_graph, num_frames)
            safe = torch.clamp(ali, min=0).long()
            num = torch.sum(torch.gather(obs, 2, safe[..., None])[..., 0] * mask, dim=-1)
        ctx.drop_frames, ctx.den_scale = drop_frames, den_scale
        ctx.save_for_backward(safe, mask, gamma_den)
        return num - den_scale * logz_den

    @staticmethod
    def backward(ctx, ct):
        safe, mask, gamma_den = ctx.saved_tensors
        ali = safe[..., None]
        m = mask[..., None]
        if ctx.drop_frames:
            # drop frames whose numerator pdf is (numerically) absent from the den
            m = m * (torch.gather(gamma_den, 2, ali) > 1e-20).to(torch.float32)
        # one_hot(ali) − den_scale·gamma
        grad = (gamma_den * -ctx.den_scale).scatter_add_(2, ali, torch.ones_like(m))
        return ct[:, None, None] * (grad * m), None, None, None, None, None, None


def mmi_objective(obs: Tensor, ali: Tensor, den_graph, num_frames: Tensor, mask: Tensor,
                  drop_frames: bool = True, den_scale: float = 1.0) -> Tensor:
    """Per-sequence MMI objective: logZ_num − den_scale·logZ_den  [B].

    obs: [B, T, P] scaled scores; ali: [B, T] numerator pdf alignment
    (mask == 0 frames ignored). The gradient is (num_onehot −
    den_scale·gamma_den), with frames dropped where the numerator pdf has
    ~zero denominator occupancy (Kaldi drop_frames semantics)."""
    return _MmiObjective.apply(obs, ali, den_graph, num_frames, mask, drop_frames, den_scale)


def mmi_loss(logits: Tensor, ali: Tensor, mask: Tensor, den_graph, num_frames: Tensor,
             log_prior=None, acoustic_scale: float = 0.1, drop_frames: bool = True,
             den_scale: float = 1.0):
    """Mean −MMI objective per supervised frame (lower is better).
    Returns (loss, aux) with aux = dict(mmi_obj_per_frame)."""
    obs = acoustic_scores(logits, log_prior, acoustic_scale)
    obj = mmi_objective(obs, ali, den_graph, num_frames, mask, drop_frames, den_scale)
    frames = torch.clamp(torch.sum(mask), min=1.0)
    total = torch.sum(obj)
    return -total / frames, {"mmi_obj_per_frame": total.detach() / frames}


def smbr_loss(logits: Tensor, ref: Tensor, mask: Tensor, den_graph, num_frames: Tensor,
              log_prior=None, acoustic_scale: float = 0.1, level: str = "pdf",
              silence: Optional[SilenceOpts] = None):
    """Mean −E[frame accuracy] per supervised frame.

    level='pdf' → sMBR; level='phone' → MPE/MPFE (ref then holds phone ids
    and den_graph must carry phones). ``silence`` applies Kaldi's
    MpeVariants silence-phone accuracy rules."""
    obs = acoustic_scores(logits, log_prior, acoustic_scale)
    f = graph_expected_accuracy(obs, den_graph, torch.clamp(ref, min=0), num_frames, level,
                                silence)
    frames = torch.clamp(torch.sum(mask), min=1.0)
    total = torch.sum(f)
    return -total / frames, {"expected_acc_per_frame": total.detach() / frames}


# ---------------------------------------------------------------------------
# Priors
# ---------------------------------------------------------------------------


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
