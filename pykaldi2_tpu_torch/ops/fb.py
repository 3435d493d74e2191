"""Forward-backward over a shared graph stored as arc tables: logZ,
occupancies and the sMBR/MPE expected accuracy; and the shared pieces of
every forward-backward kernel (NEG_INF, the guarded log, Kaldi's silence
rules for the frame accuracies).

Port of pykaldi2_tpu/ops/fb.py (reference behavior: kaldi/src/lat/
lattice-functions.cc LatticeForwardBackwardMmi / LatticeForwardBackwardMpeVariants):

  * ``fsa_logz``     — log partition over a graph shared by the batch; its
                       gradient with respect to obs is the per-frame pdf
                       occupancy gamma (the MMI denominator gradient);
  * ``fsa_occupancies`` — (logZ, gamma) without autograd;
  * ``fsa_viterbi``  — best path score and per-frame arc sequence (the
                       forced-alignment primitive of ``bin/align``);
  * ``fsa_expected_accuracy`` — the sMBR/MPE double forward-backward whose
                       gradient is Kaldi's gamma·(c_arc − F).

Shapes: obs [B, T, P]; graph shared across the batch; num_frames [B] masks
each sequence's tail. Every frame gathers the carry at each arc's source,
adds weight and obs, and sums into the destination states (``index_add_``);
the recursions renormalise per frame (a running log normaliser), so fp32
never overflows. This is the fallback route of ``fb_dense.pack_graph_auto``
(graphs that break the state-emission rule) and the reference the other
routes are tested against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

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


def _tensor_fields_to(tup, device):
    """A NamedTuple with every tensor field moved to ``device``."""
    return tup._replace(**{k: v.to(device) for k, v in tup._asdict().items()
                           if torch.is_tensor(v)})


class GraphArrays(NamedTuple):
    """Arc tables of a graph on the device (see ops/fsa.DenseFsa)."""

    src: Tensor        # [E] int64
    dst: Tensor        # [E] int64
    pdf: Tensor        # [E] int64
    weight: Tensor     # [E] f32 (graph score; -inf padding encoded as NEG_INF)
    final: Tensor      # [S] f32
    start: int
    num_states: int
    phone: Optional[Tensor] = None
    olabel: Optional[Tensor] = None

    def to(self, device) -> "GraphArrays":
        return _tensor_fields_to(self, device)


def pack_graph(fsa) -> GraphArrays:
    fsa.validate()

    def clean(a):
        return torch.as_tensor(np.nan_to_num(np.asarray(a, np.float32), neginf=NEG_INF,
                                             posinf=NEG_INF), dtype=torch.float32)

    def ids(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.int64))

    return GraphArrays(src=ids(fsa.src), dst=ids(fsa.dst), pdf=ids(fsa.pdf),
                       weight=clean(fsa.weight), final=clean(fsa.final),
                       start=int(fsa.start), num_states=int(fsa.num_states),
                       phone=ids(fsa.phone), olabel=ids(fsa.olabel))


def _seg_sum(values: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """values [B, E] → [B, num_segments] sums over ids [E]."""
    return values.new_zeros(values.shape[0], num_segments).index_add_(1, ids, values)


def _seg_max(values: Tensor, ids: Tensor, num_segments: int, empty) -> Tensor:
    """values [B, E] → [B, num_segments] maxima over ids [E]; a segment that
    no arc enters holds ``empty`` (``jax.ops.segment_max`` gives the dtype's
    minimum there)."""
    out = values.new_full((values.shape[0], num_segments), empty)
    return out.scatter_reduce_(1, ids.expand_as(values), values, "amax", include_self=False)


def _alpha_init(g: GraphArrays, batch: int, like: Tensor) -> Tensor:
    """[B, S] log-alpha at t = 0: log 1 on the start state."""
    a = like.new_full((batch, g.num_states), NEG_INF)
    a[:, g.start] = 0.0
    return a


def _clamped_max(x: Tensor) -> Tensor:
    return torch.clamp(x.max(dim=1, keepdim=True).values, min=NEG_INF)


def _acc_ratio(numer: Tensor, denom: Tensor) -> Tensor:
    pos = denom > 0
    return torch.where(pos, numer / torch.where(pos, denom, torch.ones_like(denom)),
                       torch.zeros_like(numer))


# ---------------------------------------------------------------------------
# logZ with occupancy gradient
# ---------------------------------------------------------------------------


@torch.no_grad()
def _logz_fwd_scan(obs: Tensor, g: GraphArrays, num_frames: Tensor):
    """→ (logz [B], alphas [T, B, S], norms [T, B]): the carry after each frame."""
    b, t_len, _ = obs.shape
    alpha = _alpha_init(g, b, obs)
    norm = obs.new_zeros(b)
    alphas, norms = [], []
    for t in range(t_len):
        obs_t = obs[:, t]
        score = alpha[:, g.src] + g.weight + obs_t[:, g.pdf]            # [B, E]
        mx = _clamped_max(score)
        new_alpha = log_safe(_seg_sum(torch.exp(score - mx), g.dst, g.num_states)) + mx
        m2 = new_alpha.max(dim=1, keepdim=True).values
        active = (t < num_frames)[:, None]
        alpha = torch.where(active, new_alpha - m2, alpha)
        norm = torch.where(active[:, 0], norm + m2[:, 0], norm)
        alphas.append(alpha)
        norms.append(norm)
    logz = torch.logsumexp(torch.clamp(alpha + g.final, min=NEG_INF), dim=1) + norm
    return logz, torch.stack(alphas), torch.stack(norms)


@torch.no_grad()
def _occupancies(obs: Tensor, g: GraphArrays, num_frames: Tensor, logz: Tensor,
                 alphas: Tensor, norms: Tensor) -> Tensor:
    """gamma [B, T, P]: per-frame pdf posterior under the graph."""
    b, t_len, p_dim = obs.shape
    beta = g.final.expand(b, g.num_states)
    bnorm = obs.new_zeros(b)
    alpha0 = _alpha_init(g, b, obs)
    gammas = obs.new_zeros(t_len, b, p_dim)
    for t in range(t_len - 1, -1, -1):
        # the carry entering frame t is alphas[t-1] (the start one-hot at t = 0)
        a_prev = alphas[t - 1] if t else alpha0
        an_prev = norms[t - 1] if t else torch.zeros_like(bnorm)
        obs_w = g.weight + obs[:, t][:, g.pdf]                          # [B, E]
        beta_dst = beta[:, g.dst]
        score = obs_w + beta_dst
        mx = _clamped_max(score)
        new_beta = log_safe(_seg_sum(torch.exp(score - mx), g.src, g.num_states)) + mx
        m2 = new_beta.max(dim=1, keepdim=True).values
        log_gamma = (a_prev[:, g.src] + an_prev[:, None] + obs_w + beta_dst
                     + bnorm[:, None] - logz[:, None])
        active = (t < num_frames)[:, None]
        gamma_arc = torch.where(active, torch.exp(torch.clamp(log_gamma, max=0.0)),
                                torch.zeros_like(log_gamma))
        gammas[t] = _seg_sum(gamma_arc, g.pdf, p_dim)
        beta = torch.where(active, new_beta - m2, beta)
        bnorm = torch.where(active[:, 0], bnorm + m2[:, 0], bnorm)
    return gammas.transpose(0, 1)


class _FsaLogz(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graph, num_frames):
        logz, alphas, norms = _logz_fwd_scan(obs, graph, num_frames)
        ctx.graph = graph
        ctx.save_for_backward(obs, num_frames, logz, alphas, norms)
        return logz

    @staticmethod
    def backward(ctx, ct):
        obs, num_frames, logz, alphas, norms = ctx.saved_tensors
        gamma = _occupancies(obs, ctx.graph, num_frames, logz, alphas, norms)
        return ct[:, None, None] * gamma, None, None


def fsa_logz(obs: Tensor, graph: GraphArrays, num_frames: Tensor) -> Tensor:
    """log partition function per batch element: [B]."""
    return _FsaLogz.apply(obs, graph, num_frames)


def fsa_occupancies(obs: Tensor, graph: GraphArrays, num_frames: Tensor):
    """(logZ [B], gamma [B, T, P]) without autograd."""
    logz, alphas, norms = _logz_fwd_scan(obs, graph, num_frames)
    return logz, _occupancies(obs, graph, num_frames, logz, alphas, norms)


# ---------------------------------------------------------------------------
# Viterbi (max semiring + backpointers)
# ---------------------------------------------------------------------------

_INT32_MAX = 2 ** 31 - 1


@torch.no_grad()
def fsa_viterbi(obs: Tensor, graph: GraphArrays, num_frames: Tensor):
    """Best-path score and arc sequence: ([B], [B, T] best arc index per frame).

    Per-frame pdf labels are graph.pdf[best_arcs]; t >= num_frames[b] → -1.
    Ties go as in the reference: the lowest winning arc id per state, the
    first maximal end state. The frame loop and the backtrace hold no host
    sync (``active`` stays on the device).
    """
    b, t_len, _ = obs.shape
    g = graph
    n_arcs = g.src.shape[0]
    alpha = _alpha_init(g, b, obs)
    norm = obs.new_zeros(b)
    e_ids = torch.arange(n_arcs, device=obs.device).expand(b, n_arcs)
    bps = []
    for t in range(t_len):
        score = alpha[:, g.src] + g.weight + obs[:, t][:, g.pdf]          # [B, E]
        best = _seg_max(score, g.dst, g.num_states, torch.finfo(score.dtype).min)
        best = torch.clamp(best, min=NEG_INF)
        # an arc wins if its score equals its state's max (the max selects one
        # of these very values, so some arc of a live state compares equal)
        cand = torch.where(score == best[:, g.dst], e_ids, _INT32_MAX)
        # the lowest winning arc id; where no arc enters, the reference's
        # negated int32 minimum wraps to -2^31, as -(2^31) does here
        bp = -_seg_max(-cand, g.dst, g.num_states, 2 ** 31)
        m2 = best.max(dim=1, keepdim=True).values
        active = (t < num_frames)[:, None]
        alpha = torch.where(active, best - m2, alpha)
        norm = torch.where(active[:, 0], norm + m2[:, 0], norm)
        bps.append(torch.where(active, bp, -1))
    total = alpha + g.final
    best_score = total.max(dim=1).values + norm
    state = torch.argmax(total, dim=1)                                    # first max
    arcs = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        arc = torch.gather(bps[t], 1, state[:, None])[:, 0]
        arc = torch.where(t < num_frames, arc, -1)
        # the reference's gather clamps an out-of-range arc id
        prev = torch.where(arc >= 0, g.src[torch.clamp(arc, 0, n_arcs - 1)], state)
        arcs[t], state = arc, prev
    return best_score, torch.stack(arcs, dim=1)


# ---------------------------------------------------------------------------
# Expected accuracy (sMBR / MPE)
# ---------------------------------------------------------------------------


def _arc_acc(g: GraphArrays, ref_t: Tensor, level: str,
             silence: Optional[SilenceOpts] = None) -> Tensor:
    """[B, E] per-arc frame accuracy vs reference labels ref_t [B]."""
    if level == "pdf":       # sMBR
        lab = g.pdf
    elif level == "phone":   # MPE/MPFE
        if g.phone is None:
            raise ValueError("graph has no phone labels; cannot do phone-level accuracy")
        lab = g.phone
    else:
        raise ValueError(level)
    return frame_accuracy(lab[None, :], ref_t[:, None], level, silence)


@torch.no_grad()
def _smbr_fwd_scan(obs, g: GraphArrays, ref, num_frames, level, silence=None):
    b, t_len, _ = obs.shape
    alpha = _alpha_init(g, b, obs)
    aacc = obs.new_zeros(b, g.num_states)
    norm = obs.new_zeros(b)
    alphas, aaccs, norms = [], [], []
    for t in range(t_len):
        score = alpha[:, g.src] + g.weight + obs[:, t][:, g.pdf]        # [B, E]
        mx = _clamped_max(score)
        lin = torch.exp(score - mx)
        # expected accumulated accuracy arriving via each arc
        acc_in = aacc[:, g.src] + _arc_acc(g, ref[:, t], level, silence)
        denom = _seg_sum(lin, g.dst, g.num_states)
        numer = _seg_sum(lin * acc_in, g.dst, g.num_states)
        new_alpha = log_safe(denom) + mx
        m2 = new_alpha.max(dim=1, keepdim=True).values
        active = (t < num_frames)[:, None]
        alpha = torch.where(active, new_alpha - m2, alpha)
        aacc = torch.where(active, _acc_ratio(numer, denom), aacc)
        norm = torch.where(active[:, 0], norm + m2[:, 0], norm)
        alphas.append(alpha)
        aaccs.append(aacc)
        norms.append(norm)
    total = torch.clamp(alpha + g.final, min=NEG_INF)
    f = torch.sum(torch.softmax(total, dim=1) * aacc, dim=1)    # final-state posterior
    logz = torch.logsumexp(total, dim=1) + norm
    return f, (torch.stack(alphas), torch.stack(aaccs), torch.stack(norms), logz)


@torch.no_grad()
def _smbr_bwd(obs, g: GraphArrays, ref, num_frames, level, silence, alphas, aaccs, norms,
              logz, f) -> Tensor:
    """Kaldi's gradient gamma·(c_arc − F) summed onto pdfs: [B, T, P]."""
    b, t_len, p_dim = obs.shape
    beta = g.final.expand(b, g.num_states)
    bacc = obs.new_zeros(b, g.num_states)
    bnorm = obs.new_zeros(b)
    alpha0 = _alpha_init(g, b, obs)
    grads = obs.new_zeros(t_len, b, p_dim)
    for t in range(t_len - 1, -1, -1):
        a_prev = alphas[t - 1] if t else alpha0
        aa_prev = aaccs[t - 1] if t else torch.zeros_like(bacc)
        an_prev = norms[t - 1] if t else torch.zeros_like(bnorm)
        arc_acc = _arc_acc(g, ref[:, t], level, silence)               # [B, E]
        obs_w = g.weight + obs[:, t][:, g.pdf]
        beta_dst, bacc_dst = beta[:, g.dst], bacc[:, g.dst]
        log_gamma = (a_prev[:, g.src] + an_prev[:, None] + obs_w + beta_dst
                     + bnorm[:, None] - logz[:, None])
        gamma = torch.exp(torch.clamp(log_gamma, max=0.0))
        c_arc = aa_prev[:, g.src] + arc_acc + bacc_dst                  # E[acc | arc]
        active = (t < num_frames)[:, None]
        contrib = torch.where(active, gamma * (c_arc - f[:, None]), torch.zeros_like(gamma))
        grads[t] = _seg_sum(contrib, g.pdf, p_dim)
        score = obs_w + beta_dst
        mx = _clamped_max(score)
        lin = torch.exp(score - mx)
        denom = _seg_sum(lin, g.src, g.num_states)
        numer = _seg_sum(lin * (arc_acc + bacc_dst), g.src, g.num_states)
        new_beta = log_safe(denom) + mx
        m2 = new_beta.max(dim=1, keepdim=True).values
        beta = torch.where(active, new_beta - m2, beta)
        bacc = torch.where(active, _acc_ratio(numer, denom), bacc)
        bnorm = torch.where(active[:, 0], bnorm + m2[:, 0], bnorm)
    return grads.transpose(0, 1)


class _FsaExpectedAccuracy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, graph, ref, num_frames, level, silence):
        f, (alphas, aaccs, norms, logz) = _smbr_fwd_scan(obs, graph, ref, num_frames,
                                                         level, silence)
        ctx.graph, ctx.level, ctx.silence = graph, level, silence
        ctx.save_for_backward(obs, ref, num_frames, alphas, aaccs, norms, logz, f)
        return f

    @staticmethod
    def backward(ctx, ct):
        obs, ref, num_frames, alphas, aaccs, norms, logz, f = ctx.saved_tensors
        grad = _smbr_bwd(obs, ctx.graph, ref, num_frames, ctx.level, ctx.silence, alphas,
                         aaccs, norms, logz, f)
        return ct[:, None, None] * grad, None, None, None, None, None


def fsa_expected_accuracy(obs: Tensor, graph: GraphArrays, ref: Tensor, num_frames: Tensor,
                          level: str = "pdf",
                          silence: Optional[SilenceOpts] = None) -> Tensor:
    """E[#correct frames] under the graph posterior: [B].

    ref: [B, T] reference pdf (level='pdf') or phone (level='phone') per
    frame (the numerator alignment, as in Kaldi's sMBR/MPFE). ``silence``
    applies Kaldi's MpeVariants silence-phone rules (see SilenceOpts).
    """
    return _FsaExpectedAccuracy.apply(obs, graph, ref, num_frames, level, silence)
