"""Banded forward-backward over TIME-SYNCHRONOUS decoded lattices.

Port of pykaldi2_tpu/ops/fb_lattice.py (reference behavior: Kaldi's
LatticeForwardBackwardMmi / LatticeForwardBackwardMpeVariants over the
per-utterance denominator lattices of pykaldi2's train_se).

Beam-decoder lattices are time-synchronous: every state lives at exactly one
frame (native/latdec.cc emits the state→frame map). Re-indexing states as
(frame, slot) bands the recursion: carries are [B, K] with K = max tokens per
frame, per-frame arc tables are [B, T, A] with A = max links per frame, and
the saved activations are [T, B, K] instead of [T, B, num_states].

Covers logZ/occupancies (MMI) and expected accuracy (sMBR/MPE) as
``torch.autograd.Function``s with the reference's explicit backwards. The
recursions are kernels K7-K10 (ops/fb_lattice_cuda.py) on CUDA tensors and
their plain versions on CPU tensors. The reference's XLA matvec and einsum
routes (``use_matvec_latfb``, ``_trans_mats_*``, ``_*_matvec_ts``) and the
Pallas shape gate compute the same functions by other routes chosen for the
TPU; they are not carried over. The arc→pdf reduction is one
``scatter_add_`` over the pdf axis: the reference's one-hot GEMM form of it
(``set_den_pdf_ids``) was a workaround for the TPU's slow scatter. The MMI
function's forward and backward (K7, K8) keep the spans ``pk2/latfb.fwd``
and ``pk2/latfb.bwd`` (utils/tracing.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pykaldi2_tpu_torch.ops import fb_lattice_cuda as K
from pykaldi2_tpu_torch.ops.fb import NEG_INF, SilenceOpts
from pykaldi2_tpu_torch.ops.fb_batched import _arc_acc_b
from pykaldi2_tpu_torch.ops.fsa import DenseFsa
from pykaldi2_tpu_torch.utils import tracing

Tensor = torch.Tensor


class TimeSyncLattice(NamedTuple):
    """Per-frame banded arc tables. Arc a of frame t connects slot src[b,t,a]
    (at frame t) to slot dst[b,t,a] (at frame t+1) emitting pdf[b,t,a] with
    obs[b, t] — i.e. step t consumes observation frame t. Padding arcs carry
    NEG_INF weight. ``final`` holds each utterance's final weights on the
    slots of its LAST frame (frozen alphas line up with it).
    """

    src: Tensor      # [B, T, A] int32
    dst: Tensor      # [B, T, A] int32
    pdf: Tensor      # [B, T, A] int32
    weight: Tensor   # [B, T, A] f32
    final: Tensor    # [B, K] f32

    @property
    def num_slots(self) -> int:
        return self.final.shape[1]

    def to(self, device) -> "TimeSyncLattice":
        return TimeSyncLattice(*(x.to(device) for x in self))


def _round_up(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def time_sync_from_fsa(fsa: DenseFsa, state_frame: np.ndarray):
    """(frame-sorted arc arrays, n_frames, per-frame state counts, finals).

    ``arcs`` is a tuple of flat arrays (frame_of_arc, src_slot, dst_slot, pdf,
    w) SORTED by frame, and ``finals`` are the last frame's slot weights.
    """
    state_frame = np.asarray(state_frame)
    n_frames = int(state_frame.max())
    # slot index = rank of the state within its frame (state ids ascend)
    order = np.argsort(state_frame, kind="stable")
    slot = np.zeros_like(state_frame)
    counts = np.bincount(state_frame, minlength=n_frames + 1)
    starts = np.cumsum(counts) - counts
    slot[order] = np.arange(len(state_frame)) - starts[state_frame[order]]

    src = np.asarray(fsa.src)
    dst = np.asarray(fsa.dst)
    src_f = state_frame[src]
    if np.any(state_frame[dst] != src_f + 1):
        raise ValueError("lattice is not time-synchronous (arc skips frames)")
    a_order = np.argsort(src_f, kind="stable")
    arcs = (src_f[a_order], slot[src[a_order]], slot[dst[a_order]],
            np.asarray(fsa.pdf)[a_order],
            np.nan_to_num(np.asarray(fsa.weight)[a_order], neginf=NEG_INF))
    finals = np.nan_to_num(
        np.asarray(fsa.final)[state_frame == n_frames], neginf=NEG_INF)
    return arcs, n_frames, counts, finals


def pack_time_sync(lattices: Sequence[Tuple[DenseFsa, np.ndarray]],
                   t_pad: Optional[int] = None,
                   bucket: bool = True) -> TimeSyncLattice:
    """Pad per-utterance time-sync lattices to a common [B, T, A]/[B, K]
    (CPU tensors). With ``bucket``, K rounds up to a power of two ≥ 8 and A
    to one ≥ 64."""
    per_utt = [time_sync_from_fsa(fsa, frames) for (fsa, frames) in lattices]
    t_max = max(nf for (_a, nf, _c, _f) in per_utt)
    if t_pad is None:
        t_pad = t_max
    if t_pad < t_max:
        raise ValueError(f"t_pad {t_pad} < longest lattice {t_max}")
    k_max = max(int(c.max()) for (_a, _nf, c, _f) in per_utt)
    a_max = 1
    for (arcs, _nf, _c, _f) in per_utt:
        frame_of_arc = arcs[0]
        if frame_of_arc.size:
            a_max = max(a_max, int(np.bincount(frame_of_arc).max()))
    if bucket:
        k_max, a_max = _round_up(k_max), _round_up(a_max, 64)
    b = len(per_utt)
    src = np.zeros((b, t_pad, a_max), np.int32)
    dst = np.zeros((b, t_pad, a_max), np.int32)
    pdf = np.zeros((b, t_pad, a_max), np.int32)
    w = np.full((b, t_pad, a_max), NEG_INF, np.float32)
    final = np.full((b, k_max), NEG_INF, np.float32)
    for i, (arcs, nf, _counts, fin) in enumerate(per_utt):
        frame_of_arc, s, d, p, ww = arcs
        if frame_of_arc.size:
            # vectorized scatter: (frame, rank-within-frame) per arc
            fcounts = np.bincount(frame_of_arc, minlength=nf)
            fstarts = np.cumsum(fcounts) - fcounts
            rank = np.arange(frame_of_arc.size) - fstarts[frame_of_arc]
            src[i, frame_of_arc, rank] = s
            dst[i, frame_of_arc, rank] = d
            pdf[i, frame_of_arc, rank] = p
            w[i, frame_of_arc, rank] = ww
        final[i, : len(fin)] = fin
    return TimeSyncLattice(*(torch.from_numpy(x) for x in (src, dst, pdf, w, final)))


def pad_time_sync(lat: TimeSyncLattice, k: int, a: int,
                  t: Optional[int] = None) -> TimeSyncLattice:
    """Grow a packed lattice's slot/arc/frame paddings (exact no-op arcs):
    frames past an utterance's ``num_frames`` are masked by ``active`` and
    padding arcs carry NEG_INF, so the math is unchanged."""
    k0, a0, t0 = lat.num_slots, lat.src.shape[2], lat.src.shape[1]
    if t is None:
        t = t0
    if k < k0 or a < a0 or t < t0:
        raise ValueError(
            f"cannot shrink padding ({k0},{a0},{t0}) → ({k},{a},{t})")
    if (k, a, t) == (k0, a0, t0):
        return lat
    pad_a = (0, a - a0, 0, t - t0)  # last dim first, as torch.nn.functional.pad takes it
    pad = torch.nn.functional.pad
    return TimeSyncLattice(
        pad(lat.src, pad_a), pad(lat.dst, pad_a), pad(lat.pdf, pad_a),
        pad(lat.weight, pad_a, value=NEG_INF),
        pad(lat.final, (0, k - k0), value=NEG_INF))


def set_den_pdf_ids(ids) -> None:
    """The reference's routing hint (the static pdf-id set of the
    denominator graph), which sends its arc→pdf sums through a one-hot GEMM
    for the TPU's slow scatter. The port's sum is one ``scatter_add_``,
    exact for any pdf, so the hint changes nothing; the trainer calls it as
    the reference does."""


def _arc_pdf_sums(vals_t: Tensor, pdf: Tensor, p_dim: int) -> Tensor:
    """[T, B, A] arc values + [B, T, A] pdf ids → [B, T, P] per-pdf sums, in
    one scatter after the recursion (never per frame)."""
    b, t_len, _a = pdf.shape
    out = vals_t.new_zeros(b, t_len, p_dim)
    return out.scatter_add_(2, pdf.long(), vals_t.transpose(0, 1).contiguous())


def _obs_arcs_ts(obs: Tensor, lat: TimeSyncLattice) -> Tensor:
    """[B, T, num_pdfs] → per-arc obs [T, B, A], one gather outside the
    recursion."""
    return torch.gather(obs, 2, lat.pdf.long()).transpose(0, 1).contiguous()


def _band(obs: Tensor, lat: TimeSyncLattice):
    """The time-major kernel inputs (obs_arc, src, dst, w), each [T, B, A]."""
    tm = lambda x: x.transpose(0, 1).contiguous()  # noqa: E731
    return _obs_arcs_ts(obs, lat), tm(lat.src), tm(lat.dst), tm(lat.weight)


def _active_ts(t_len: int, num_frames: Tensor) -> Tensor:
    ts = torch.arange(t_len, device=num_frames.device)
    return (ts[:, None] < num_frames[None, :]).to(torch.float32)[:, :, None]


def _prev(x: Tensor, first: Tensor) -> Tensor:
    """[T, ...] → the carry entering each frame: ``first`` then x[:-1]."""
    return torch.cat([first[None], x[:-1]], dim=0)


def _logz_fwd_ts(band, lat: TimeSyncLattice, active: Tensor):
    """K7 + the final log-sum-exp: (logz [B], alphas [T,B,K], norms [T,B])."""
    alphas, norms = K.logz_fwd(*band, active, lat.num_slots)
    total = torch.clamp(alphas[-1] + lat.final, min=NEG_INF)
    return torch.logsumexp(total, dim=1) + norms[-1], alphas, norms


def _occupancies_ts(band, lat: TimeSyncLattice, active: Tensor, logz: Tensor,
                    alphas: Tensor, norms: Tensor, p_dim: int) -> Tensor:
    """K8 + the arc→pdf sum: per-frame pdf occupancies [B, T, P]."""
    b = lat.final.shape[0]
    gamma_arc = K.occupancies_bwd(
        *band, active, _prev(alphas, K.initial_alpha(b, lat.num_slots, alphas)),
        _prev(norms, norms.new_zeros(b))[:, :, None], lat.final, logz[:, None])
    return _arc_pdf_sums(gamma_arc, lat.pdf, p_dim)


class _LatticeLogz(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, lat, num_frames):
        with torch.no_grad():
            band = _band(obs, lat)
            active = _active_ts(obs.shape[1], num_frames)
            logz, alphas, norms = _logz_fwd_ts(band, lat, active)
        ctx.lat, ctx.p_dim = lat, obs.shape[2]
        ctx.save_for_backward(*band, active, logz, alphas, norms)
        return logz

    @staticmethod
    def backward(ctx, ct):
        *band, active, logz, alphas, norms = ctx.saved_tensors
        gamma = _occupancies_ts(band, ctx.lat, active, logz, alphas, norms, ctx.p_dim)
        return ct[:, None, None] * gamma, None, None


def lattice_logz_ts(obs: Tensor, lat: TimeSyncLattice, num_frames: Tensor) -> Tensor:
    """Per-utterance log partition over banded lattices: [B]; its gradient
    with respect to obs [B, T, P] is the pdf occupancy."""
    return _LatticeLogz.apply(obs, lat, num_frames)


@torch.no_grad()
def lattice_occupancies_ts(obs: Tensor, lat: TimeSyncLattice, num_frames: Tensor):
    """(logz [B], occupancies [B, T, P])."""
    band = _band(obs, lat)
    active = _active_ts(obs.shape[1], num_frames)
    logz, alphas, norms = _logz_fwd_ts(band, lat, active)
    return logz, _occupancies_ts(band, lat, active, logz, alphas, norms, obs.shape[2])


# ---------------------------------------------------------------------------
# MMI over banded decoded lattices
# ---------------------------------------------------------------------------


class _MmiLattice(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, ali, lat, num_frames, mask, drop_frames, den_scale):
        with tracing.span("pk2/latfb.fwd"), torch.no_grad():
            band = _band(obs, lat)
            active = _active_ts(obs.shape[1], num_frames)
            logz, alphas, norms = _logz_fwd_ts(band, lat, active)
            safe = torch.clamp(ali, min=0).long()
            num = torch.sum(torch.gather(obs, 2, safe[..., None])[..., 0] * mask, dim=-1)
            ctx.lat, ctx.p_dim = lat, obs.shape[2]
            ctx.drop_frames, ctx.den_scale = drop_frames, den_scale
            ctx.save_for_backward(*band, active, logz, alphas, norms, safe, mask)
            return num - den_scale * logz

    @staticmethod
    def backward(ctx, ct):
        with tracing.span("pk2/latfb.bwd"):
            *band, active, logz, alphas, norms, safe, mask = ctx.saved_tensors
            gamma = _occupancies_ts(band, ctx.lat, active, logz, alphas, norms, ctx.p_dim)
            ali = safe[..., None]
            m = mask[..., None]
            if ctx.drop_frames:
                m = m * (torch.gather(gamma, 2, ali) > 1e-20).to(torch.float32)
            # one_hot(ali) − den_scale·gamma, built in place in gamma's buffer
            grad = gamma.mul_(-ctx.den_scale).scatter_add_(2, ali, torch.ones_like(m))
            return ct[:, None, None] * grad * m, None, None, None, None, None, None


def mmi_objective_lattice_ts(obs: Tensor, ali: Tensor, lat: TimeSyncLattice,
                             num_frames: Tensor, mask: Tensor, drop_frames: bool = True,
                             den_scale: float = 1.0) -> Tensor:
    """MMI with banded per-utterance denominator lattices: [B] objectives
    (numerator alignment score − den_scale · lattice logZ). The gradient is
    (one_hot(ali) − den_scale·gamma) on supervised frames; ``drop_frames``
    zeroes frames whose alignment pdf has no denominator occupancy (Kaldi
    --drop-frames)."""
    return _MmiLattice.apply(obs, ali, lat, num_frames, mask, drop_frames, den_scale)


# ---------------------------------------------------------------------------
# Expected accuracy (sMBR / MPE) over banded decoded lattices
# ---------------------------------------------------------------------------


def _arc_acc_ts(lat: TimeSyncLattice, ref: Tensor, level: str, pdf_to_phone,
                silence: Optional[SilenceOpts]) -> Tensor:
    """Per-arc frame accuracies for all frames at once: [T, B, A]."""
    b, t_len, a = lat.pdf.shape
    pdf_t = lat.pdf.transpose(0, 1).reshape(t_len * b, a)
    ref_t = ref.transpose(0, 1).reshape(t_len * b)
    return _arc_acc_b(pdf_t, ref_t, level, pdf_to_phone, silence).reshape(t_len, b, a)


class _ExpectedAccuracy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, obs, lat, ref, num_frames, level, pdf_to_phone, silence):
        with torch.no_grad():
            band = _band(obs, lat)
            active = _active_ts(obs.shape[1], num_frames)
            arc_acc = _arc_acc_ts(lat, ref, level, pdf_to_phone, silence)
            alphas, aaccs, norms = K.smbr_fwd(*band, active, arc_acc, lat.num_slots)
            total = torch.clamp(alphas[-1] + lat.final, min=NEG_INF)
            f = torch.sum(torch.softmax(total, dim=1) * aaccs[-1], dim=1)
            logz = torch.logsumexp(total, dim=1) + norms[-1]
        ctx.lat, ctx.p_dim = lat, obs.shape[2]
        ctx.save_for_backward(*band, active, arc_acc, alphas, aaccs, norms, logz, f)
        return f

    @staticmethod
    def backward(ctx, ct):
        *band, active, arc_acc, alphas, aaccs, norms, logz, f = ctx.saved_tensors
        lat = ctx.lat
        b, k = lat.final.shape
        contrib = K.smbr_contribs_bwd(
            *band, active, arc_acc, _prev(alphas, K.initial_alpha(b, k, alphas)),
            _prev(aaccs, aaccs.new_zeros(b, k)), _prev(norms, norms.new_zeros(b))[:, :, None],
            lat.final, logz[:, None], f[:, None])
        grads = _arc_pdf_sums(contrib, lat.pdf, ctx.p_dim)
        return ct[:, None, None] * grads, None, None, None, None, None, None


def lattice_expected_accuracy_ts(obs: Tensor, lat: TimeSyncLattice, ref: Tensor,
                                 num_frames: Tensor, level: str = "pdf",
                                 pdf_to_phone: Optional[Tensor] = None,
                                 silence: Optional[SilenceOpts] = None) -> Tensor:
    """E[#correct frames] under the banded lattice posterior: [B]. ``level``
    is "pdf" (sMBR) or "phone" (MPE/MPFE, with ``pdf_to_phone``); ``silence``
    applies Kaldi's MpeVariants silence rules. The gradient is Kaldi's
    γ·(c_arc − f) per arc, summed onto its pdf."""
    return _ExpectedAccuracy.apply(obs, lat, ref, num_frames, level, pdf_to_phone, silence)
