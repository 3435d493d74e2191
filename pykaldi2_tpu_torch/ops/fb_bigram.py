"""Structured forward-backward for bigram phone-LM denominator graphs.

Port of pykaldi2_tpu/ops/fb_bigram.py. Graphs built by ``make_den_graph``
have exact structure: per-phone left-to-right HMM chains joined by one dense
phone-bigram crossbar. The recursion factors into O(P·J) elementwise work,
a [B, P] × [P, P] crossbar product and, for the occupancies, one
[T·B, P·J] × [P·J, num_pdfs] one-hot product after the frame loop — no
per-arc gathers or scatters. This is ``train_se``'s default route (the
recipe's stage 3); it runs no TPU kernel, and its products are plain
``torch.matmul`` (fp32; TF32 off on the card).

States are (phone p, hmm-state j); arcs emit the DESTINATION state's pdf:

  alpha'[p,0]  = obs[pdf(p,0)]  + lse(alpha[p,0]+w_self[p,0], cross_in[p])
  alpha'[p,j]  = obs[pdf(p,j)]  + lse(alpha[p,j]+w_self[p,j],
                                      alpha[p,j-1]+w_fwd[p,j-1])
  cross_in[p]  = lse_q(alpha[q,J-1] + w_exit[q] + logLM[q,p])   (product)
                 ⊕ start_mass + log_init[p]                      (t=0 only)
  logZ         = lse_p(alpha_T[p,J-1] + w_exit[p] + log_final[p])
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.graph.transition_model import TransitionModel
from pykaldi2_tpu_torch.ops.fb import (NEG_INF, SilenceOpts, _acc_ratio, _tensor_fields_to,
                                      frame_accuracy, log_safe)

Tensor = torch.Tensor


class BigramDenGraph(NamedTuple):
    """Structured denominator graph (uniform J states per phone)."""

    pdf: Tensor        # [P, J] int64 pdf of each (phone, state)
    w_self: Tensor     # [P, J] log self-loop prob
    w_fwd: Tensor      # [P, J] log forward prob (j→j+1; j=J-1 is exit)
    log_init: Tensor   # [P]
    lm_lin: Tensor     # [P, P] exp(log P(q|p)) crossbar
    log_final: Tensor  # [P]
    onehot: Tensor     # [P*J, num_pdfs] f32 one-hot of pdf (gamma product)
    phone_ids: Tensor  # [P] int64 phone id of each row (MPE accuracy)
    num_pdfs: int

    def to(self, device) -> "BigramDenGraph":
        return _tensor_fields_to(self, device)


def make_bigram_den(tm: TransitionModel, phone_lm: dict,
                    num_pdfs: Optional[int] = None) -> BigramDenGraph:
    """Build the structured graph (topology must be uniform left-to-right)."""
    phones = phone_lm["phones"]
    J = len(tm.topo.states_for(phones[0]))
    num_pdfs = num_pdfs or tm.num_pdfs
    P = len(phones)
    pdf = np.zeros((P, J), np.int64)
    w_self = np.zeros((P, J), np.float32)
    w_fwd = np.zeros((P, J), np.float32)
    for i, p in enumerate(phones):
        states = tm.topo.states_for(p)
        if len(states) != J:
            raise ValueError("bigram den kernel needs a uniform topology")
        for j, st in enumerate(states):
            pdf[i, j] = tm.pdf_for(p, j)
            for k, (nxt, _prob) in enumerate(st.transitions):
                _, logp, _ = tm.transition(p, j, k)
                if nxt == j:
                    w_self[i, j] = logp
                else:
                    w_fwd[i, j] = logp
    li = phone_lm["log_init"][phones].astype(np.float32)
    lb = phone_lm["log_bigram"][np.ix_(phones, phones)].astype(np.float32)
    lf = phone_lm["log_final"][phones].astype(np.float32)
    onehot = np.zeros((P * J, num_pdfs), np.float32)
    onehot[np.arange(P * J), pdf.reshape(-1)] = 1.0
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return BigramDenGraph(
        pdf=torch.from_numpy(pdf), w_self=f32(w_self), w_fwd=f32(w_fwd),
        log_init=f32(np.nan_to_num(li, neginf=NEG_INF)),
        lm_lin=f32(np.exp(np.nan_to_num(lb, neginf=-np.inf))),
        log_final=f32(np.nan_to_num(lf, neginf=NEG_INF)),
        onehot=torch.from_numpy(onehot),
        phone_ids=torch.as_tensor(np.asarray(phones, np.int64)), num_pdfs=num_pdfs)


def _lse2(a: Tensor, b: Tensor) -> Tensor:
    m = torch.clamp(torch.maximum(a, b), min=NEG_INF)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def _gather_obs(obs: Tensor, g: BigramDenGraph) -> Tensor:
    """[B, T, num_pdfs] → [T, B, P, J], once, outside the frame loops."""
    b, t_len, _ = obs.shape
    P, J = g.pdf.shape
    return obs[:, :, g.pdf.reshape(-1)].transpose(0, 1).reshape(t_len, b, P, J)


def _where(active: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """Blend by a [B] mask over [B, ...] carries."""
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def _flat_max(x: Tensor) -> Tensor:
    return torch.clamp(x.reshape(x.shape[0], -1).max(dim=1).values, min=NEG_INF)


@torch.no_grad()
def _fwd_scan(obs: Tensor, g: BigramDenGraph, num_frames: Tensor):
    b, t_len, _ = obs.shape
    P, J = g.pdf.shape
    alpha = obs.new_full((b, P, J), NEG_INF)
    norm = obs.new_zeros(b)
    start_mass = obs.new_zeros(b)
    obs_sel = _gather_obs(obs, g)
    alphas = obs.new_empty(t_len, b, P, J)
    norms = obs.new_empty(t_len, b)
    for t in range(t_len):
        # crossbar: exit scores → entry of every phone (linear-domain product)
        exit_score = alpha[:, :, J - 1] + g.w_fwd[None, :, J - 1]        # [B, P]
        mx = torch.clamp(exit_score.max(dim=1, keepdim=True).values, min=NEG_INF)
        cross = log_safe(torch.exp(exit_score - mx) @ g.lm_lin) + mx
        cross = _lse2(cross, start_mass[:, None] + g.log_init[None, :])
        stay = alpha + g.w_self[None]
        enter_j = alpha[:, :, :-1] + g.w_fwd[None, :, :-1]
        prev = torch.cat([cross[:, :, None], enter_j], dim=2)            # [B, P, J]
        new_alpha = obs_sel[t] + _lse2(stay, prev)
        m2 = _flat_max(new_alpha)
        active = t < num_frames
        alpha = _where(active, new_alpha - m2[:, None, None], alpha)
        norm = torch.where(active, norm + m2, norm)
        start_mass = torch.where(active, torch.full_like(start_mass, NEG_INF), start_mass)
        alphas[t], norms[t] = alpha, norm
    final = alpha[:, :, J - 1] + g.w_fwd[None, :, J - 1] + g.log_final[None, :]
    logz = torch.logsumexp(torch.clamp(final, min=NEG_INF), dim=1) + norm
    return logz, alphas, norms


def _beta_T(g: BigramDenGraph, b: int, like: Tensor) -> Tensor:
    P, J = g.pdf.shape
    beta = like.new_full((b, P, J), NEG_INF)
    beta[:, :, J - 1] = g.w_fwd[None, :, J - 1] + g.log_final[None, :]
    return beta


def _pdf_sums(per_state: Tensor, g: BigramDenGraph) -> Tensor:
    """[T, B, P, J] → [B, T, num_pdfs] as ONE product with the one-hot."""
    t_len, b = per_state.shape[:2]
    P, J = g.pdf.shape
    out = per_state.reshape(t_len * b, P * J) @ g.onehot
    return out.reshape(t_len, b, g.num_pdfs).transpose(0, 1)


@torch.no_grad()
def bigram_occupancies_from(obs: Tensor, g: BigramDenGraph, num_frames: Tensor,
                            logz: Tensor, alphas: Tensor, norms: Tensor) -> Tensor:
    """gamma [B, T, num_pdfs] via the structured beta recursion."""
    b, t_len, _ = obs.shape
    P, J = g.pdf.shape
    lm_lin_T = g.lm_lin.t()
    beta = _beta_T(g, b, obs)
    bnorm = obs.new_zeros(b)
    obs_sel = _gather_obs(obs, g)
    gammas = obs.new_empty(t_len, b, P, J)
    for t in range(t_len - 1, -1, -1):
        active = t < num_frames
        # gamma at frame t: state posterior with alpha AFTER frame t
        g_state = (alphas[t] + norms[t][:, None, None] + beta + bnorm[:, None, None]
                   - logz[:, None, None])
        gammas[t] = _where(active, torch.exp(torch.clamp(g_state, max=0.0)),
                           torch.zeros_like(g_state))
        # beta recursion to frame t (consuming obs at t)
        arrive = obs_sel[t] + beta                                       # [B, P, J]
        stay = g.w_self[None] + arrive
        fwd = torch.cat([g.w_fwd[None, :, :-1] + arrive[:, :, 1:],
                         arrive.new_full((b, P, 1), NEG_INF)], dim=2)
        # the last state also exits through the crossbar
        entry = arrive[:, :, 0]                                          # [B, P]
        mx = torch.clamp(entry.max(dim=1, keepdim=True).values, min=NEG_INF)
        cross = log_safe(torch.exp(entry - mx) @ lm_lin_T) + mx
        cross_full = arrive.new_full((b, P, J), NEG_INF)
        cross_full[:, :, J - 1] = g.w_fwd[None, :, J - 1] + cross
        new_beta = _lse2(_lse2(stay, fwd), cross_full)
        m2 = _flat_max(new_beta)
        beta = _where(active, new_beta - m2[:, None, None], beta)
        bnorm = torch.where(active, bnorm + m2, bnorm)
    return _pdf_sums(gammas, g)


class _BigramLogz(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graph, num_frames):
        logz, alphas, norms = _fwd_scan(obs, graph, num_frames)
        ctx.graph = graph
        ctx.save_for_backward(obs, num_frames, logz, alphas, norms)
        return logz

    @staticmethod
    def backward(ctx, ct):
        obs, num_frames, logz, alphas, norms = ctx.saved_tensors
        gamma = bigram_occupancies_from(obs, ctx.graph, num_frames, logz, alphas, norms)
        return ct[:, None, None] * gamma, None, None


def bigram_logz(obs: Tensor, graph: BigramDenGraph, num_frames: Tensor) -> Tensor:
    """[B] log partition over the structured bigram den graph."""
    return _BigramLogz.apply(obs, graph, num_frames)


def bigram_occupancies(obs: Tensor, graph: BigramDenGraph, num_frames: Tensor):
    logz, alphas, norms = _fwd_scan(obs, graph, num_frames)
    return logz, bigram_occupancies_from(obs, graph, num_frames, logz, alphas, norms)


# ---------------------------------------------------------------------------
# expected accuracy (sMBR / MPE) on the structured graph
# ---------------------------------------------------------------------------


def _state_acc(g: BigramDenGraph, ref_t: Tensor, level: str, silence=None) -> Tensor:
    """[B, P, J] per-frame accuracy of being in each state vs ref labels."""
    if level == "pdf":
        lab = g.pdf[None]                              # [1, P, J]
    elif level == "phone":
        lab = g.phone_ids[None, :, None]
    else:
        raise ValueError(level)
    return frame_accuracy(lab, ref_t[:, None, None], level, silence)


@torch.no_grad()
def _smbr_fwd_scan(obs, g: BigramDenGraph, ref, num_frames, level, silence=None):
    b, t_len, _ = obs.shape
    P, J = g.pdf.shape
    alpha = obs.new_full((b, P, J), NEG_INF)
    aacc = obs.new_zeros(b, P, J)
    norm = obs.new_zeros(b)
    start_mass = obs.new_zeros(b)
    obs_sel = _gather_obs(obs, g)
    alphas = obs.new_empty(t_len, b, P, J)
    aaccs = torch.empty_like(alphas)
    norms = obs.new_empty(t_len, b)
    max_init = g.log_init.max()
    for t in range(t_len):
        a_t = _state_acc(g, ref[:, t], level, silence)                  # [B, P, J]
        # linear-domain path weights relative to a per-batch max
        exit_score = alpha[:, :, J - 1] + g.w_fwd[None, :, J - 1]
        stay = alpha + g.w_self[None]
        enter_j = alpha[:, :, :-1] + g.w_fwd[None, :, :-1]
        # the normaliser covers the start mass too: at t = 0 alpha is all
        # NEG_INF and the start term is the only live path
        m = torch.clamp(torch.maximum(alpha.reshape(b, -1).max(dim=1).values,
                                      start_mass + max_init), min=NEG_INF)[:, None, None]
        stay_lin = torch.exp(stay - m)
        enter_lin = torch.cat([alpha.new_zeros(b, P, 1), torch.exp(enter_j - m)], dim=2)
        exit_lin = torch.exp(exit_score - m[:, :, 0])
        cross_lin = exit_lin @ g.lm_lin                                  # [B, P]
        cross_acc_num = (exit_lin * aacc[:, :, J - 1]) @ g.lm_lin        # [B, P]
        start_lin = torch.exp(start_mass[:, None] + g.log_init[None, :] - m[:, :, 0])
        # denominator (prob mass) and numerator (acc-weighted)
        denom = stay_lin + enter_lin
        denom[:, :, 0] += cross_lin + start_lin
        acc_prev = torch.cat([aacc.new_zeros(b, P, 1), aacc[:, :, :-1]], dim=2)
        numer = stay_lin * aacc + enter_lin * acc_prev
        numer[:, :, 0] += cross_acc_num                                  # start path acc = 0
        new_alpha = log_safe(denom) + m + obs_sel[t]
        new_aacc = _acc_ratio(numer, denom) + a_t  # every arc into (p,j) at t scores a_t(p,j)
        m2 = _flat_max(new_alpha)
        active = t < num_frames
        alpha = _where(active, new_alpha - m2[:, None, None], alpha)
        aacc = _where(active, new_aacc, aacc)
        norm = torch.where(active, norm + m2, norm)
        start_mass = torch.where(active, torch.full_like(start_mass, NEG_INF), start_mass)
        alphas[t], aaccs[t], norms[t] = alpha, aacc, norm
    final = torch.clamp(alpha[:, :, J - 1] + g.w_fwd[None, :, J - 1] + g.log_final[None, :],
                        min=NEG_INF)
    f = torch.sum(torch.softmax(final, dim=1) * aacc[:, :, J - 1], dim=1)
    logz = torch.logsumexp(final, dim=1) + norm
    return f, (alphas, aaccs, norms, logz)


@torch.no_grad()
def _bsmbr_bwd(obs, g: BigramDenGraph, ref, num_frames, level, silence, alphas, aaccs, norms,
               logz, f) -> Tensor:
    b, t_len, _ = obs.shape
    P, J = g.pdf.shape
    lm_lin_T = g.lm_lin.t()
    beta = _beta_T(g, b, obs)
    bacc = obs.new_zeros(b, P, J)
    bnorm = obs.new_zeros(b)
    obs_sel = _gather_obs(obs, g)
    ex_lin = torch.exp(g.w_fwd[None, :, J - 1])        # exit prob of each phone
    contribs = obs.new_empty(t_len, b, P, J)
    for t in range(t_len - 1, -1, -1):
        active = t < num_frames
        # gradient at frame t: gamma_state * (E[acc|state] − F)
        g_state = (alphas[t] + norms[t][:, None, None] + beta + bnorm[:, None, None]
                   - logz[:, None, None])
        gamma = torch.exp(torch.clamp(g_state, max=0.0))
        contrib = gamma * (aaccs[t] + bacc - f[:, None, None])
        contribs[t] = _where(active, contrib, torch.zeros_like(contrib))
        # beta/bacc recursion through frame t
        a_t = _state_acc(g, ref[:, t], level, silence)
        arrive = obs_sel[t] + beta                                     # to-state score
        arr_acc = a_t + bacc                                           # acc from t onward
        m = _flat_max(arrive)[:, None, None]
        stay_lin = torch.exp(g.w_self[None] + arrive - m)
        fwd_lin = torch.cat([torch.exp(g.w_fwd[None, :, :-1] + arrive[:, :, 1:] - m),
                             arrive.new_zeros(b, P, 1)], dim=2)
        entry_lin = torch.exp(arrive[:, :, 0] - m[:, :, 0])            # [B, P]
        cross_lin = entry_lin @ lm_lin_T
        cross_acc = (entry_lin * arr_acc[:, :, 0]) @ lm_lin_T
        denom = stay_lin + fwd_lin
        acc_next = torch.cat([arr_acc[:, :, 1:], arr_acc.new_zeros(b, P, 1)], dim=2)
        numer = stay_lin * arr_acc + fwd_lin * acc_next
        denom[:, :, J - 1] += ex_lin * cross_lin
        numer[:, :, J - 1] += ex_lin * cross_acc
        new_beta = log_safe(denom) + m
        new_bacc = _acc_ratio(numer, denom)
        m2 = _flat_max(new_beta)
        beta = _where(active, new_beta - m2[:, None, None], beta)
        bacc = _where(active, new_bacc, bacc)
        bnorm = torch.where(active, bnorm + m2, bnorm)
    return _pdf_sums(contribs, g)


class _BigramExpectedAccuracy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graph, ref, num_frames, level, silence):
        f, (alphas, aaccs, norms, logz) = _smbr_fwd_scan(obs, graph, ref, num_frames, level,
                                                         silence)
        ctx.graph, ctx.level, ctx.silence = graph, level, silence
        ctx.save_for_backward(obs, ref, num_frames, alphas, aaccs, norms, logz, f)
        return f

    @staticmethod
    def backward(ctx, ct):
        obs, ref, num_frames, alphas, aaccs, norms, logz, f = ctx.saved_tensors
        grad = _bsmbr_bwd(obs, ctx.graph, ref, num_frames, ctx.level, ctx.silence, alphas,
                          aaccs, norms, logz, f)
        return ct[:, None, None] * grad, None, None, None, None, None


def bigram_expected_accuracy(obs: Tensor, graph: BigramDenGraph, ref: Tensor,
                             num_frames: Tensor, level: str = "pdf",
                             silence: Optional[SilenceOpts] = None) -> Tensor:
    """E[#correct frames] under the structured den posterior: [B].
    ``silence`` applies Kaldi's MpeVariants silence-phone rules."""
    return _BigramExpectedAccuracy.apply(obs, graph, ref, num_frames, level, silence)
