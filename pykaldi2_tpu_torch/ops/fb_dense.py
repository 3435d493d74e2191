"""Forward-backward as dense [B, S] × [S, S] products (state-emission form).

Port of pykaldi2_tpu/ops/fb_dense.py. Every graph the compilers emit has
one invariant: all arcs into a state carry that state's pdf (emission on
the destination state, as in Kaldi's H). The per-arc observation term then
factors out of the log-sum-exp, and the alpha recursion becomes

    alpha'[d] = obs_t[pdf(d)] + log( (exp(alpha) @ W)[d] )     W[s, d] = e^{w(s→d)}

— one matrix product in exp space per frame (the running renormalisation
keeps exp(alpha) ≤ 1) plus elementwise work. W is dense fp32, so this route
takes graphs up to ``max_states`` (16,384 states ≈ 1 GB); ``pack_graph_auto``
sends larger ones to the block-sparse tiles (ops/fb_block.py) and graphs
that break the invariant to the arc tables (ops/fb.py).

The product is a plain ``torch.matmul`` in fp32 (the reference left it to
XLA); on the card it runs in full fp32, TF32 off (``device.set_fp32_exact``).
The reference's ``_gemm_precision`` and its environment variable are TPU MXU
settings and are not carried over.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.ops.fb import (NEG_INF, SilenceOpts, _acc_ratio, _clamped_max,
                                      _tensor_fields_to, frame_accuracy, log_safe, pack_graph)

Tensor = torch.Tensor


class DenseStateGraph(NamedTuple):
    """Dense exp-weight transition matrix + per-state pdf labels."""

    w_exp: Tensor          # [S, S] f32, e^{graph weight}, 0 = no arc
    state_pdf: Tensor      # [S] int64 pdf emitted by arcs INTO each state
    final: Tensor          # [S] f32 log-prob
    start: int
    num_states: int
    state_phone: Optional[Tensor] = None  # [S] int64 (MPE/MPFE accuracy)

    def to(self, device) -> "DenseStateGraph":
        return _tensor_fields_to(self, device)


def state_emission_pdfs(fsa) -> Optional[np.ndarray]:
    """Per-state pdf if every arc into a state shares one pdf, else None."""
    S = int(fsa.num_states)
    dst = np.asarray(fsa.dst)
    pdf = np.asarray(fsa.pdf)
    state_pdf = np.full(S, -1, np.int64)
    state_pdf[dst] = pdf          # last write per state wins...
    if np.any(state_pdf[dst] != pdf):   # ...then every arc must agree
        return None
    # states with no in-arcs (start) emit nothing; pdf slot unused → 0
    state_pdf[state_pdf < 0] = 0
    return state_pdf.astype(np.int32)


def state_emission_phones(fsa) -> Optional[np.ndarray]:
    """Per-state phone under the same invariant (None without phones or when
    arcs into one state carry different phones)."""
    if fsa.phone is None:
        return None
    dst, ph = np.asarray(fsa.dst), np.asarray(fsa.phone)
    sp = np.full(int(fsa.num_states), -1, np.int64)
    sp[dst] = ph
    if np.any(sp[dst] != ph):
        return None
    sp[sp < 0] = 0
    return sp.astype(np.int32)


def exp_weights(fsa) -> np.ndarray:
    """Arc weights in prob space (float32): exp taken in float64 so very
    negative weights underflow toward 0 faithfully; NEG_INF/-inf padding
    arcs give exactly 0; only the positive side is clamped (at 80)."""
    w = np.nan_to_num(np.asarray(fsa.weight, np.float64), neginf=NEG_INF, posinf=NEG_INF)
    return np.where(w <= 0.5 * NEG_INF, 0.0, np.exp(np.minimum(w, 80.0))).astype(np.float32)


def final_weights(fsa) -> np.ndarray:
    return np.nan_to_num(np.asarray(fsa.final, np.float64), neginf=NEG_INF, posinf=NEG_INF)


def pack_graph_dense(fsa) -> DenseStateGraph:
    fsa.validate()
    state_pdf = state_emission_pdfs(fsa)
    if state_pdf is None:
        raise ValueError("graph violates the state-emission invariant "
                         "(arcs into one state carry different pdfs)")
    S = int(fsa.num_states)
    w_exp = np.zeros((S, S), np.float32)
    # duplicate arcs between the same state pair add in prob space (their
    # logsumexp), which the accumulation here performs exactly
    np.add.at(w_exp, (np.asarray(fsa.src), np.asarray(fsa.dst)), exp_weights(fsa))
    phones = state_emission_phones(fsa)
    return DenseStateGraph(
        w_exp=torch.from_numpy(w_exp), state_pdf=torch.from_numpy(state_pdf.astype(np.int64)),
        final=torch.as_tensor(final_weights(fsa), dtype=torch.float32),
        start=int(fsa.start), num_states=S,
        state_phone=None if phones is None else torch.from_numpy(phones.astype(np.int64)))


def pack_graph_auto(fsa, num_pdfs: Optional[int] = None, max_states: int = 16384):
    """Route by state count: dense state-matmul (≤ max_states), block-sparse
    tiles above that (ops/fb_block.py), the arc tables as the last resort
    (invariant violations, degenerate block structure). num_pdfs is accepted
    for the reference's API (obs width comes from the observations)."""
    if state_emission_pdfs(fsa) is not None:
        if fsa.num_states <= max_states:
            return pack_graph_dense(fsa)
        from pykaldi2_tpu_torch.ops.fb_block import pack_graph_blocks

        try:
            return pack_graph_blocks(fsa)
        except ValueError:
            pass  # degenerate block structure → arc tables
    return pack_graph(fsa)


def _alpha_init_d(g: DenseStateGraph, batch: int, like: Tensor) -> Tensor:
    a = like.new_full((batch, g.num_states), NEG_INF)
    a[:, g.start] = 0.0
    return a


def _log_matvec(x_log: Tensor, w_exp: Tensor) -> Tensor:
    """[B, S] log-values → log(exp(x) @ w_exp), NEG_INF-safe (the caller keeps
    x_log ≤ 0 by renormalising, so exp never overflows)."""
    return log_safe(torch.matmul(torch.exp(torch.clamp(x_log, min=NEG_INF)), w_exp))


def _gather_obs_d(obs: Tensor, g: DenseStateGraph) -> Tensor:
    """[B, T, num_pdfs] → per-state obs [T, B, S], once, outside the frame loop."""
    return obs[:, :, g.state_pdf].transpose(0, 1)


def _pdf_sums(per_state: Tensor, state_pdf: Tensor, p_dim: int) -> Tensor:
    """[T, B, S] → [B, T, P]: state values summed onto their pdfs."""
    t_len, b, _ = per_state.shape
    out = per_state.new_zeros(t_len, b, p_dim)
    return out.index_add_(2, state_pdf, per_state).transpose(0, 1)


@torch.no_grad()
def _logz_fwd_scan_d(obs: Tensor, g: DenseStateGraph, num_frames: Tensor):
    b, t_len, _ = obs.shape
    alpha = _alpha_init_d(g, b, obs)
    norm = obs.new_zeros(b)
    obs_s = _gather_obs_d(obs, g)
    alphas = obs.new_empty(t_len, b, g.num_states)
    norms = obs.new_empty(t_len, b)
    for t in range(t_len):
        new_alpha = _log_matvec(alpha, g.w_exp) + obs_s[t]
        m2 = _clamped_max(new_alpha)
        active = (t < num_frames)[:, None]
        alpha = torch.where(active, new_alpha - m2, alpha)
        norm = torch.where(active[:, 0], norm + m2[:, 0], norm)
        alphas[t], norms[t] = alpha, norm
    logz = torch.logsumexp(torch.clamp(alpha + g.final, min=NEG_INF), dim=1) + norm
    return logz, alphas, norms


@torch.no_grad()
def _occupancies_d(obs: Tensor, g: DenseStateGraph, num_frames: Tensor, logz: Tensor,
                   alphas: Tensor, norms: Tensor) -> Tensor:
    """gamma [B, T, P]: the state posterior alpha·beta/Z summed by state pdf."""
    b, t_len, p_dim = obs.shape
    beta = g.final.expand(b, g.num_states)
    bnorm = obs.new_zeros(b)
    w_exp_t = g.w_exp.t()
    obs_s = _gather_obs_d(obs, g)
    gammas = obs.new_empty(t_len, b, g.num_states)
    for t in range(t_len - 1, -1, -1):
        # state posterior at frame t: alpha (through t) · beta (after t)
        log_gamma = alphas[t] + norms[t][:, None] + beta + bnorm[:, None] - logz[:, None]
        active = (t < num_frames)[:, None]
        gammas[t] = torch.where(active, torch.exp(torch.clamp(log_gamma, max=0.0)),
                                torch.zeros_like(log_gamma))
        # beta'[s] = lse_d(w(s→d) + obs_t[pdf(d)] + beta[d])
        y = obs_s[t] + beta
        m = _clamped_max(y)
        new_beta = _log_matvec(y - m, w_exp_t) + m
        m2 = _clamped_max(new_beta)
        beta = torch.where(active, new_beta - m2, beta)
        bnorm = torch.where(active[:, 0], bnorm + m2[:, 0], bnorm)
    return _pdf_sums(gammas, g.state_pdf, p_dim)


class _DenseLogz(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graph, num_frames):
        logz, alphas, norms = _logz_fwd_scan_d(obs, graph, num_frames)
        ctx.graph = graph
        ctx.save_for_backward(obs, num_frames, logz, alphas, norms)
        return logz

    @staticmethod
    def backward(ctx, ct):
        obs, num_frames, logz, alphas, norms = ctx.saved_tensors
        gamma = _occupancies_d(obs, ctx.graph, num_frames, logz, alphas, norms)
        return ct[:, None, None] * gamma, None, None


def fsa_logz_dense(obs: Tensor, graph: DenseStateGraph, num_frames: Tensor) -> Tensor:
    """log partition per batch element: [B] (dense-matmul recursion)."""
    return _DenseLogz.apply(obs, graph, num_frames)


def fsa_occupancies_dense(obs: Tensor, graph: DenseStateGraph, num_frames: Tensor):
    logz, alphas, norms = _logz_fwd_scan_d(obs, graph, num_frames)
    return logz, _occupancies_d(obs, graph, num_frames, logz, alphas, norms)


# ---------------------------------------------------------------------------
# Expected accuracy (sMBR / MPE) in dense state-matmul form: the per-arc
# accuracy A_t[dst] = (label(dst) == ref_t) sits on the destination state,
# so the expected incoming accuracy is (exp(alpha)·aacc @ W) / (exp(alpha) @ W)
# + A_t, and the gradient collapses to gamma_state · (aacc_t + bacc_t − F).
# ---------------------------------------------------------------------------


def _state_labels(g, level: str) -> Tensor:
    if level == "pdf":
        return g.state_pdf
    if level == "phone":
        if g.state_phone is None:
            raise ValueError("graph has no phone labels; cannot do phone-level accuracy")
        return g.state_phone
    raise ValueError(level)


@torch.no_grad()
def _smbr_fwd_scan_dense(obs, g: DenseStateGraph, ref, num_frames, level, silence=None):
    b, t_len, _ = obs.shape
    lab = _state_labels(g, level)
    alpha = _alpha_init_d(g, b, obs)
    aacc = obs.new_zeros(b, g.num_states)
    norm = obs.new_zeros(b)
    obs_s = _gather_obs_d(obs, g)
    alphas = obs.new_empty(t_len, b, g.num_states)
    aaccs = torch.empty_like(alphas)
    norms = obs.new_empty(t_len, b)
    for t in range(t_len):
        ea = torch.exp(torch.clamp(alpha, min=NEG_INF))
        denom = torch.matmul(ea, g.w_exp)
        numer = torch.matmul(ea * aacc, g.w_exp)
        a_t = frame_accuracy(lab[None, :], ref[:, t][:, None], level, silence)
        new_alpha = log_safe(denom) + obs_s[t]
        m2 = _clamped_max(new_alpha)
        active = (t < num_frames)[:, None]
        alpha = torch.where(active, new_alpha - m2, alpha)
        aacc = torch.where(active, _acc_ratio(numer, denom) + a_t, aacc)
        norm = torch.where(active[:, 0], norm + m2[:, 0], norm)
        alphas[t], aaccs[t], norms[t] = alpha, aacc, norm
    total = torch.clamp(alpha + g.final, min=NEG_INF)
    f = torch.sum(torch.softmax(total, dim=1) * aacc, dim=1)
    logz = torch.logsumexp(total, dim=1) + norm
    return f, (alphas, aaccs, norms, logz)


@torch.no_grad()
def _smbr_dense_bwd(obs, g: DenseStateGraph, ref, num_frames, level, silence, alphas, aaccs,
                    norms, logz, f) -> Tensor:
    b, t_len, p_dim = obs.shape
    lab = _state_labels(g, level)
    w_exp_t = g.w_exp.t()
    beta = g.final.expand(b, g.num_states)
    bacc = obs.new_zeros(b, g.num_states)
    bnorm = obs.new_zeros(b)
    obs_s = _gather_obs_d(obs, g)
    contribs = obs.new_empty(t_len, b, g.num_states)
    for t in range(t_len - 1, -1, -1):
        # gradient at frame t: gamma_state · (E[acc through t] + E[acc after t] − F)
        log_gamma = alphas[t] + norms[t][:, None] + beta + bnorm[:, None] - logz[:, None]
        active = (t < num_frames)[:, None]
        gamma_s = torch.where(active, torch.exp(torch.clamp(log_gamma, max=0.0)),
                              torch.zeros_like(log_gamma))
        contribs[t] = gamma_s * (aaccs[t] + bacc - f[:, None])
        a_t = frame_accuracy(lab[None, :], ref[:, t][:, None], level, silence)
        y_log = obs_s[t] + beta
        m = _clamped_max(y_log)
        y = torch.exp(y_log - m)
        denom = torch.matmul(y, w_exp_t)
        numer = torch.matmul(y * (a_t + bacc), w_exp_t)
        new_beta = log_safe(denom) + m
        m2 = _clamped_max(new_beta)
        beta = torch.where(active, new_beta - m2, beta)
        bacc = torch.where(active, _acc_ratio(numer, denom), bacc)
        bnorm = torch.where(active[:, 0], bnorm + m2[:, 0], bnorm)
    return _pdf_sums(contribs, g.state_pdf, p_dim)


class _DenseExpectedAccuracy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graph, ref, num_frames, level, silence):
        f, (alphas, aaccs, norms, logz) = _smbr_fwd_scan_dense(obs, graph, ref, num_frames,
                                                               level, silence)
        ctx.graph, ctx.level, ctx.silence = graph, level, silence
        ctx.save_for_backward(obs, ref, num_frames, alphas, aaccs, norms, logz, f)
        return f

    @staticmethod
    def backward(ctx, ct):
        obs, ref, num_frames, alphas, aaccs, norms, logz, f = ctx.saved_tensors
        grad = _smbr_dense_bwd(obs, ctx.graph, ref, num_frames, ctx.level, ctx.silence,
                               alphas, aaccs, norms, logz, f)
        return ct[:, None, None] * grad, None, None, None, None, None


def fsa_expected_accuracy_dense(obs: Tensor, graph: DenseStateGraph, ref: Tensor,
                                num_frames: Tensor, level: str = "pdf",
                                silence: Optional[SilenceOpts] = None) -> Tensor:
    """E[#correct frames] under the graph posterior: [B] (dense form).
    ``silence`` applies Kaldi's MpeVariants silence-phone rules."""
    return _DenseExpectedAccuracy.apply(obs, graph, ref, num_frames, level, silence)
