"""Forward-backward over PER-UTTERANCE graphs (batched arc tables).

Port of pykaldi2_tpu/ops/fb_batched.py (reference behavior: Kaldi's
LatticeForwardBackwardMmi / LatticeForwardBackwardMpeVariants over the
per-utterance denominator lattices of pykaldi2's train_se). The shared-graph
recursions of ops/fb.py cover a fixed denominator; this module covers a
graph per utterance: decoded denominator lattices and transcript numerator
graphs of any topology. Graphs are padded to a common (num_arcs, num_states)
bucket (``pack_graph_batch``); padding arcs carry NEG_INF weights and are
exact no-ops.

  * ``fsa_logz_b``       — log partition per utterance; its gradient with
                           respect to obs is the pdf occupancy;
  * ``fsa_occupancies_b`` — (logZ, gamma) without autograd;
  * ``mmi_objective_lattice`` — MMI against the per-utterance lattices, with
                           Kaldi's --drop-frames and a denominator scale;
  * ``batched_expected_accuracy`` — the sMBR/MPE double forward-backward
                           whose gradient is Kaldi's gamma·(c_arc − F).

Each frame gathers the carry at every arc's source (``torch.gather`` along
the arc axis), adds weight and obs, and sums into the destination states
(``scatter_add_``, per batch row); the recursions renormalise per frame by
the row max, and ``active = t < num_frames`` stays on the device, so the
frame loop holds no host sync. Each backward is the reference's explicit
beta recursion over the saved forward carries, not autograd through the
frame loop (which would keep every frame's [B, E] intermediates).

The banded time-synchronous form of the same lattices (ops/fb_lattice.py,
kernels K7-K10) is the scalable route; this one reaches no TPU kernel in
the reference either (an XLA scan there, plain torch ops here) and carries
[T, B, num_states] activations. ``make_se_lattice_steps`` takes either.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.ops.fb import (NEG_INF, SilenceOpts, _acc_ratio, _clamped_max,
                                       _tensor_fields_to, frame_accuracy, log_safe)
from pykaldi2_tpu_torch.ops.fsa import DenseFsa

Tensor = torch.Tensor


class BatchedGraphs(NamedTuple):
    """Per-utterance arc tables padded to one bucket. Every graph starts at
    state 0; padding arcs are NEG_INF-weight self-loops on a dead state."""

    src: Tensor      # [B, E] int64
    dst: Tensor      # [B, E] int64
    pdf: Tensor      # [B, E] int64
    weight: Tensor   # [B, E] f32 (NEG_INF on padding arcs)
    final: Tensor    # [B, S] f32

    @property
    def num_states(self) -> int:
        return self.final.shape[1]

    def to(self, device) -> "BatchedGraphs":
        return _tensor_fields_to(self, device)


def _round_bucket(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def pack_graph_batch(fsas: List[DenseFsa], bucket: bool = True) -> BatchedGraphs:
    """Pad per-utterance graphs to a common arc/state budget (a power of two
    from 64 with ``bucket``); CPU tensors."""
    e_max = max(f.num_arcs for f in fsas)
    s_max = max(f.num_states for f in fsas)
    if bucket:
        e_max, s_max = _round_bucket(e_max), _round_bucket(s_max)
    padded = [f.pad_to(e_max, s_max) for f in fsas]
    for f in padded:
        if f.start != 0:
            raise ValueError("batched graphs must start at state 0")

    def clean(name):
        a = np.stack([getattr(f, name) for f in padded])
        return torch.from_numpy(np.nan_to_num(a, neginf=NEG_INF, posinf=NEG_INF)
                                .astype(np.float32))

    def ids(name):
        return torch.from_numpy(np.stack([getattr(f, name) for f in padded]).astype(np.int64))

    return BatchedGraphs(src=ids("src"), dst=ids("dst"), pdf=ids("pdf"),
                         weight=clean("weight"), final=clean("final"))


def _gather_state(x: Tensor, idx: Tensor) -> Tensor:
    """x [B, S], idx [B, E] → [B, E]."""
    return torch.gather(x, 1, idx)


def _seg_sum_b(values: Tensor, ids: Tensor, num_states: int) -> Tensor:
    """values [B, E], ids [B, E] → [B, S] scatter-add per batch row."""
    out = values.new_zeros(values.shape[0], num_states)
    return out.scatter_add_(1, ids.long(), values)


def _alpha0(g: BatchedGraphs, like: Tensor) -> Tensor:
    """[B, S] log-alpha at t = 0: log 1 on the start state 0."""
    a = like.new_full((g.src.shape[0], g.num_states), NEG_INF)
    a[:, 0] = 0.0
    return a


def _obs_arc(obs_t: Tensor, g: BatchedGraphs) -> Tensor:
    """obs_t [B, P] at each arc's pdf: [B, E]."""
    return torch.gather(obs_t, 1, g.pdf)


def _renorm(x: Tensor, norm: Tensor, old: Tensor, active: Tensor):
    """(carry, norm) after a frame: x − its row max where ``active``, the old
    carry elsewhere; the max joins the running log normaliser."""
    m2 = x.max(dim=1, keepdim=True).values
    return (torch.where(active, x - m2, old),
            torch.where(active[:, 0], norm + m2[:, 0], norm))


# ---------------------------------------------------------------------------
# logZ with occupancy gradient
# ---------------------------------------------------------------------------


@torch.no_grad()
def _logz_fwd_scan_b(obs: Tensor, g: BatchedGraphs, num_frames: Tensor):
    """→ (logz [B], alphas [T, B, S], norms [T, B]): the carry after each frame."""
    b, t_len, _ = obs.shape
    alpha = _alpha0(g, obs)
    norm = obs.new_zeros(b)
    alphas = obs.new_empty(t_len, b, g.num_states)
    norms = obs.new_empty(t_len, b)
    for t in range(t_len):
        score = _gather_state(alpha, g.src) + g.weight + _obs_arc(obs[:, t], g)    # [B, E]
        mx = _clamped_max(score)
        new_alpha = log_safe(_seg_sum_b(torch.exp(score - mx), g.dst, g.num_states)) + mx
        alpha, norm = _renorm(new_alpha, norm, alpha, (t < num_frames)[:, None])
        alphas[t] = alpha
        norms[t] = norm
    logz = torch.logsumexp(torch.clamp(alpha + g.final, min=NEG_INF), dim=1) + norm
    return logz, alphas, norms


def _prev_carry(carries: Tensor, t: int, first: Tensor) -> Tensor:
    """The carry entering frame t: carries[t-1], or ``first`` at t = 0."""
    return carries[t - 1] if t else first


@torch.no_grad()
def _occupancies_b(obs: Tensor, g: BatchedGraphs, num_frames: Tensor, logz: Tensor,
                   alphas: Tensor, norms: Tensor) -> Tensor:
    """gamma [B, T, P]: per-frame pdf posterior under each utterance's graph."""
    b, t_len, p_dim = obs.shape
    beta = g.final.clone()
    bnorm = obs.new_zeros(b)
    alpha0, zero = _alpha0(g, obs), obs.new_zeros(b)
    gammas = obs.new_empty(t_len, b, p_dim)
    for t in range(t_len - 1, -1, -1):
        obs_arc = _obs_arc(obs[:, t], g)
        beta_dst = _gather_state(beta, g.dst)
        score = g.weight + obs_arc + beta_dst
        mx = _clamped_max(score)
        new_beta = log_safe(_seg_sum_b(torch.exp(score - mx), g.src, g.num_states)) + mx
        log_gamma = (_gather_state(_prev_carry(alphas, t, alpha0), g.src)
                     + _prev_carry(norms, t, zero)[:, None] + g.weight + obs_arc + beta_dst
                     + bnorm[:, None] - logz[:, None])
        active = (t < num_frames)[:, None]
        gamma_arc = torch.where(active, torch.exp(torch.clamp(log_gamma, max=0.0)),
                                torch.zeros_like(log_gamma))
        gammas[t] = _seg_sum_b(gamma_arc, g.pdf, p_dim)
        beta, bnorm = _renorm(new_beta, bnorm, beta, active)
    return gammas.transpose(0, 1)


class _FsaLogzB(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graphs, num_frames):
        logz, alphas, norms = _logz_fwd_scan_b(obs, graphs, num_frames)
        ctx.graphs = graphs
        ctx.save_for_backward(obs, num_frames, logz, alphas, norms)
        return logz

    @staticmethod
    def backward(ctx, ct):
        obs, num_frames, logz, alphas, norms = ctx.saved_tensors
        gamma = _occupancies_b(obs, ctx.graphs, num_frames, logz, alphas, norms)
        return ct[:, None, None] * gamma, None, None


def fsa_logz_b(obs: Tensor, graphs: BatchedGraphs, num_frames: Tensor) -> Tensor:
    """Per-sequence log partition over per-utterance graphs: [B]."""
    return _FsaLogzB.apply(obs, graphs, num_frames)


def fsa_occupancies_b(obs: Tensor, graphs: BatchedGraphs, num_frames: Tensor):
    """(logZ [B], gamma [B, T, P]) without autograd."""
    logz, alphas, norms = _logz_fwd_scan_b(obs, graphs, num_frames)
    return logz, _occupancies_b(obs, graphs, num_frames, logz, alphas, norms)


# ---------------------------------------------------------------------------
# MMI over decoded lattices (per-utterance den graphs)
# ---------------------------------------------------------------------------


class _MmiLatticeB(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, ali, den, num_frames, mask, drop_frames, den_scale):
        # as the reference's forward rule: gamma now, the [T, B, S] alphas freed
        logz, gamma = fsa_occupancies_b(obs, den, num_frames)
        with torch.no_grad():
            safe = torch.clamp(ali, min=0).long()
            num = torch.sum(torch.gather(obs, 2, safe[..., None])[..., 0] * mask, dim=-1)
        ctx.drop_frames, ctx.den_scale = drop_frames, den_scale
        ctx.save_for_backward(safe, mask, gamma)
        return num - den_scale * logz

    @staticmethod
    def backward(ctx, ct):
        safe, mask, gamma = ctx.saved_tensors
        ali = safe[..., None]
        m = mask[..., None]
        if ctx.drop_frames:
            m = m * (torch.gather(gamma, 2, ali) > 1e-20).to(torch.float32)
        # one_hot(ali) − den_scale·gamma
        grad = (gamma * -ctx.den_scale).scatter_add_(2, ali, torch.ones_like(m))
        return ct[:, None, None] * grad * m, None, None, None, None, None, None


def mmi_objective_lattice(obs: Tensor, ali: Tensor, den: BatchedGraphs, num_frames: Tensor,
                          mask: Tensor, drop_frames: bool = True,
                          den_scale: float = 1.0) -> Tensor:
    """MMI with per-utterance denominator lattices: [B] objectives (numerator
    alignment score − den_scale · lattice logZ). The gradient is
    (one_hot(ali) − den_scale·gamma) on supervised frames; ``drop_frames``
    zeroes frames whose alignment pdf has no denominator occupancy (Kaldi
    --drop-frames: gamma at the numerator pdf ≤ 1e-20)."""
    return _MmiLatticeB.apply(obs, ali, den, num_frames, mask, drop_frames, den_scale)


# ---------------------------------------------------------------------------
# Expected accuracy (sMBR / MPE) over decoded per-utterance lattices
# ---------------------------------------------------------------------------


def _arc_acc_b(pdf: Tensor, ref_t: Tensor, level: str, pdf_to_phone,
               silence: Optional[SilenceOpts] = None) -> Tensor:
    """[B, E] per-arc frame accuracy of arc labels ``pdf`` vs ref_t [B].

    Shared with the banded kernels (ops/fb_lattice.py). Phone level (MPE/
    MPFE) maps arc pdfs through ``pdf_to_phone``, since decoded lattices
    label arcs by pdf; ``silence`` applies Kaldi's MpeVariants silence rules.
    """
    if level == "pdf":
        lab = pdf
    elif level == "phone":
        if pdf_to_phone is None:
            raise ValueError("level='phone' needs pdf_to_phone")
        lab = pdf_to_phone[torch.clamp(pdf, min=0).long()]
    else:
        raise ValueError(level)
    return frame_accuracy(lab, ref_t[:, None], level, silence)


@torch.no_grad()
def _smbr_fwd_scan_b(obs: Tensor, g: BatchedGraphs, ref: Tensor, num_frames: Tensor, level,
                     pdf_to_phone, silence=None):
    """→ (f [B], alphas, aaccs [T, B, S], norms [T, B], logz [B])."""
    b, t_len, _ = obs.shape
    alpha = _alpha0(g, obs)
    aacc = obs.new_zeros(b, g.num_states)
    norm = obs.new_zeros(b)
    alphas = obs.new_empty(t_len, b, g.num_states)
    aaccs = torch.empty_like(alphas)
    norms = obs.new_empty(t_len, b)
    for t in range(t_len):
        score = _gather_state(alpha, g.src) + g.weight + _obs_arc(obs[:, t], g)    # [B, E]
        mx = _clamped_max(score)
        lin = torch.exp(score - mx)
        # expected accumulated accuracy arriving via each arc
        acc_in = (_gather_state(aacc, g.src)
                  + _arc_acc_b(g.pdf, ref[:, t], level, pdf_to_phone, silence))
        denom = _seg_sum_b(lin, g.dst, g.num_states)
        numer = _seg_sum_b(lin * acc_in, g.dst, g.num_states)
        active = (t < num_frames)[:, None]
        aacc = torch.where(active, _acc_ratio(numer, denom), aacc)
        alpha, norm = _renorm(log_safe(denom) + mx, norm, alpha, active)
        alphas[t], aaccs[t], norms[t] = alpha, aacc, norm
    total = torch.clamp(alpha + g.final, min=NEG_INF)
    f = torch.sum(torch.softmax(total, dim=1) * aacc, dim=1)    # final-state posterior
    logz = torch.logsumexp(total, dim=1) + norm
    return f, alphas, aaccs, norms, logz


@torch.no_grad()
def _smbr_bwd_b(obs: Tensor, g: BatchedGraphs, ref: Tensor, num_frames: Tensor, level,
                pdf_to_phone, silence, alphas, aaccs, norms, logz, f) -> Tensor:
    """Kaldi's gradient gamma·(c_arc − F) summed onto pdfs: [B, T, P]."""
    b, t_len, p_dim = obs.shape
    beta = g.final.clone()
    bacc = obs.new_zeros(b, g.num_states)
    bnorm = obs.new_zeros(b)
    alpha0, zero, acc0 = _alpha0(g, obs), obs.new_zeros(b), torch.zeros_like(bacc)
    grads = obs.new_empty(t_len, b, p_dim)
    for t in range(t_len - 1, -1, -1):
        arc_acc = _arc_acc_b(g.pdf, ref[:, t], level, pdf_to_phone, silence)
        obs_arc = _obs_arc(obs[:, t], g)
        beta_dst, bacc_dst = _gather_state(beta, g.dst), _gather_state(bacc, g.dst)
        log_gamma = (_gather_state(_prev_carry(alphas, t, alpha0), g.src)
                     + _prev_carry(norms, t, zero)[:, None] + g.weight + obs_arc + beta_dst
                     + bnorm[:, None] - logz[:, None])
        gamma = torch.exp(torch.clamp(log_gamma, max=0.0))
        c_arc = (_gather_state(_prev_carry(aaccs, t, acc0), g.src)
                 + arc_acc + bacc_dst)                                       # E[acc | arc]
        active = (t < num_frames)[:, None]
        contrib = torch.where(active, gamma * (c_arc - f[:, None]), torch.zeros_like(gamma))
        grads[t] = _seg_sum_b(contrib, g.pdf, p_dim)
        score = g.weight + obs_arc + beta_dst
        mx = _clamped_max(score)
        lin = torch.exp(score - mx)
        denom = _seg_sum_b(lin, g.src, g.num_states)
        numer = _seg_sum_b(lin * (arc_acc + bacc_dst), g.src, g.num_states)
        bacc = torch.where(active, _acc_ratio(numer, denom), bacc)
        beta, bnorm = _renorm(log_safe(denom) + mx, bnorm, beta, active)
    return grads.transpose(0, 1)


class _BatchedExpectedAccuracy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graphs, ref, num_frames, level, pdf_to_phone, silence):
        f, alphas, aaccs, norms, logz = _smbr_fwd_scan_b(obs, graphs, ref, num_frames, level,
                                                         pdf_to_phone, silence)
        ctx.graphs, ctx.level, ctx.pdf_to_phone, ctx.silence = (graphs, level, pdf_to_phone,
                                                                silence)
        ctx.save_for_backward(obs, ref, num_frames, alphas, aaccs, norms, logz, f)
        return f

    @staticmethod
    def backward(ctx, ct):
        obs, ref, num_frames, alphas, aaccs, norms, logz, f = ctx.saved_tensors
        grad = _smbr_bwd_b(obs, ctx.graphs, ref, num_frames, ctx.level, ctx.pdf_to_phone,
                           ctx.silence, alphas, aaccs, norms, logz, f)
        return ct[:, None, None] * grad, None, None, None, None, None, None


def batched_expected_accuracy(obs: Tensor, graphs: BatchedGraphs, ref: Tensor,
                              num_frames: Tensor, level: str = "pdf",
                              pdf_to_phone: Optional[Tensor] = None,
                              silence: Optional[SilenceOpts] = None) -> Tensor:
    """E[#correct frames] under each utterance's lattice posterior: [B].

    ref: [B, T] reference pdf (level='pdf') or phone (level='phone', with
    ``pdf_to_phone``) ids; ``silence`` applies Kaldi's MpeVariants silence
    rules. The gradient is Kaldi's γ·(c_arc − f) per arc, summed onto its pdf.
    """
    return _BatchedExpectedAccuracy.apply(obs, graphs, ref, num_frames, level, pdf_to_phone,
                                          silence)
