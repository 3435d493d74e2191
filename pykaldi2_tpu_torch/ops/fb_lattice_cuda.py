"""Banded lattice forward-backward: kernels K7-K10 (``csrc/latfb.cu``) and their
plain versions.

Counterpart of pykaldi2_tpu/ops/fb_lattice_pallas.py. Each function keeps
the Pallas kernel's signature (time-major [T,B,A] arc bands, [T,B,1]
``active`` and ``anorm_prev``, [B,K] ``final``, [B,1] ``logz``/``f``):

  K7  ``logz_fwd``          ← ``_fwd_kernel`` (:159, call :207)
  K8  ``occupancies_bwd``   ← ``_bwd_kernel`` (:238, call :291)
  K9  ``smbr_fwd``          ← ``_smbr_fwd_kernel`` (:325, call :381)
  K10 ``smbr_contribs_bwd`` ← ``_smbr_bwd_kernel`` (:413, call :482)

The plain versions are the reference's scan forms (fb_lattice.py:682-1034)
with the kernels' arithmetic: a gather of the carry at each arc's slot, a
clamped max, exp, a segment sum into the slots, the guarded log, the
renormalising max and the ``active`` blend ``act*new + (1-act)*old``.

The kernels run at the lattice's own slot count K: no lane padding. Their
[K] carries live in shared memory, so K is capped (``max_slots``: 29,048
slots for K7/K8, 14,524 for K9/K10); a larger K raises. There is no shape
gate and no fallback: each wrapper takes the plain version only for CPU
tensors and on CUDA tensors launches its kernel or raises. ``<fn>.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pykaldi2_tpu_torch import device as D
from pykaldi2_tpu_torch.ops.fb import NEG_INF, _acc_ratio, _clamped_max, log_safe
from pykaldi2_tpu_torch.ops.fb_batched import _seg_sum_b

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gather(x: Tensor, idx: Tensor) -> Tensor:
    return torch.gather(x, 1, idx.long())


def initial_alpha(b: int, k: int, like: Tensor) -> Tensor:
    """The carry entering frame 0: log 1 on the start slot 0, NEG_INF elsewhere."""
    alpha = like.new_full((b, k), NEG_INF)
    alpha[:, 0] = 0.0
    return alpha


def logz_fwd_plain(obs_arc: Tensor, src: Tensor, dst: Tensor, w: Tensor, active: Tensor,
                   k: int) -> Tuple[Tensor, Tensor]:
    """K7's arithmetic: → (alphas [T,B,k] per-frame renormalised logs,
    norms [T,B] cumulative shifts)."""
    t_len, b, _a = obs_arc.shape
    alpha = initial_alpha(b, k, obs_arc)
    norm = obs_arc.new_zeros(b, 1)
    alphas, norms = [], []
    for t in range(t_len):
        score = _gather(alpha, src[t]) + w[t] + obs_arc[t]
        mx = _clamped_max(score)
        summed = _seg_sum_b(torch.exp(score - mx), dst[t], k)
        new_alpha = log_safe(summed) + mx
        m2 = new_alpha.max(dim=1, keepdim=True).values
        act = active[t]
        alpha = act * (new_alpha - m2) + (1.0 - act) * alpha
        norm = norm + act * m2
        alphas.append(alpha)
        norms.append(norm)
    return torch.stack(alphas), torch.stack(norms)[:, :, 0]


def occupancies_bwd_plain(obs_arc: Tensor, src: Tensor, dst: Tensor, w: Tensor,
                          active: Tensor, alpha_prev: Tensor, anorm_prev: Tensor,
                          final: Tensor, logz: Tensor) -> Tensor:
    """K8's arithmetic: → gamma [T,B,A] per-arc posteriors."""
    t_len, b, _a = obs_arc.shape
    k = final.shape[1]
    beta = final
    bnorm = obs_arc.new_zeros(b, 1)
    gammas = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        obs_w = w[t] + obs_arc[t]
        beta_dst = _gather(beta, dst[t])
        score = obs_w + beta_dst
        mx = _clamped_max(score)
        summed = _seg_sum_b(torch.exp(score - mx), src[t], k)
        new_beta = log_safe(summed) + mx
        m2 = new_beta.max(dim=1, keepdim=True).values
        log_gamma = (_gather(alpha_prev[t], src[t]) + anorm_prev[t] + obs_w + beta_dst
                     + bnorm - logz)
        act = active[t]
        gammas[t] = act * torch.exp(torch.clamp(log_gamma, max=0.0))
        beta = act * (new_beta - m2) + (1.0 - act) * beta
        bnorm = bnorm + act * m2
    return torch.stack(gammas)


def smbr_fwd_plain(obs_arc: Tensor, src: Tensor, dst: Tensor, w: Tensor, active: Tensor,
                   arc_acc: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """K9's arithmetic: → (alphas [T,B,k] log-renormalised, aaccs [T,B,k]
    linear expected accuracies, norms [T,B])."""
    t_len, b, _a = obs_arc.shape
    alpha = initial_alpha(b, k, obs_arc)
    aacc = obs_arc.new_zeros(b, k)
    norm = obs_arc.new_zeros(b, 1)
    alphas, aaccs, norms = [], [], []
    for t in range(t_len):
        score = _gather(alpha, src[t]) + w[t] + obs_arc[t]
        mx = _clamped_max(score)
        lin = torch.exp(score - mx)
        acc_in = _gather(aacc, src[t]) + arc_acc[t]
        denom = _seg_sum_b(lin, dst[t], k)
        numer = _seg_sum_b(lin * acc_in, dst[t], k)
        new_alpha = log_safe(denom) + mx
        m2 = new_alpha.max(dim=1, keepdim=True).values
        act = active[t]
        alpha = act * (new_alpha - m2) + (1.0 - act) * alpha
        aacc = act * _acc_ratio(numer, denom) + (1.0 - act) * aacc
        norm = norm + act * m2
        alphas.append(alpha)
        aaccs.append(aacc)
        norms.append(norm)
    return torch.stack(alphas), torch.stack(aaccs), torch.stack(norms)[:, :, 0]


def smbr_contribs_bwd_plain(obs_arc: Tensor, src: Tensor, dst: Tensor, w: Tensor,
                            active: Tensor, arc_acc: Tensor, alpha_prev: Tensor,
                            aacc_prev: Tensor, anorm_prev: Tensor, final: Tensor,
                            logz: Tensor, f: Tensor) -> Tensor:
    """K10's arithmetic: → contrib [T,B,A] = γ·(c_arc − f) per arc."""
    t_len, b, _a = obs_arc.shape
    k = final.shape[1]
    beta = final
    bacc = obs_arc.new_zeros(b, k)
    bnorm = obs_arc.new_zeros(b, 1)
    contribs = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        obs_w = w[t] + obs_arc[t]
        beta_dst = _gather(beta, dst[t])
        bacc_dst = _gather(bacc, dst[t])
        log_gamma = (_gather(alpha_prev[t], src[t]) + anorm_prev[t] + obs_w + beta_dst
                     + bnorm - logz)
        gamma = torch.exp(torch.clamp(log_gamma, max=0.0))
        c_arc = _gather(aacc_prev[t], src[t]) + arc_acc[t] + bacc_dst
        act = active[t]
        contribs[t] = act * (gamma * (c_arc - f))
        score = obs_w + beta_dst
        mx = _clamped_max(score)
        lin = torch.exp(score - mx)
        denom = _seg_sum_b(lin, src[t], k)
        numer = _seg_sum_b(lin * (arc_acc[t] + bacc_dst), src[t], k)
        new_beta = log_safe(denom) + mx
        m2 = new_beta.max(dim=1, keepdim=True).values
        beta = act * (new_beta - m2) + (1.0 - act) * beta
        bacc = act * _acc_ratio(numer, denom) + (1.0 - act) * bacc
        bnorm = bnorm + act * m2
    return torch.stack(contribs)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = D.load_kernel_lib("latfb")
    if not getattr(lib, "_pk2_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr in (("pk2_latfb_logz_fwd", 7), ("pk2_latfb_occupancies_bwd", 10),
                            ("pk2_latfb_smbr_fwd", 9), ("pk2_latfb_smbr_bwd", 13)):
            fn = getattr(lib, name)
            fn.argtypes = [vp] * n_ptr + [ci] * 4 + [vp]
            fn.restype = ci
        lib.pk2_latfb_max_slots.argtypes = [ci]
        lib.pk2_latfb_max_slots.restype = ci
        for name in ("pk2_latfb_logz_fwd_ring", "pk2_latfb_smbr_fwd_ring"):
            getattr(lib, name).argtypes = [ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
            getattr(lib, name).restype = ci
        lib.pk2_latfb_bwd_ring.argtypes = [ci, ci, ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
        lib.pk2_latfb_bwd_ring.restype = ci
        lib._pk2_typed = True
    return lib


def max_slots(n_bufs: int) -> int:
    """Largest K the kernels take: n_bufs = 2 for K7/K8, 4 for K9/K10."""
    return _lib().pk2_latfb_max_slots(n_bufs)


def logz_fwd_ring(a: int, k: int) -> Tuple[int, int]:
    """K7's band ring at A arcs and K slots a frame: (stages, arcs a stage),
    as ``smbr_fwd_ring`` with two [K] buffers and four arc rows a stage."""
    stages, chunk = ctypes.c_int(), ctypes.c_int()
    D.check_launch(_lib().pk2_latfb_logz_fwd_ring(a, k, ctypes.byref(stages),
                                                  ctypes.byref(chunk)), "K7 ring size")
    return stages.value, chunk.value


def smbr_fwd_ring(a: int, k: int) -> Tuple[int, int]:
    """K9's band ring at A arcs and K slots a frame: (stages, arcs a stage);
    (0, 0) when A is not a multiple of 4 or the carries leave no room for
    two stages, and the band is read from global memory (as it is when a
    band row is not 16-byte aligned)."""
    stages, chunk = ctypes.c_int(), ctypes.c_int()
    D.check_launch(_lib().pk2_latfb_smbr_fwd_ring(a, k, ctypes.byref(stages),
                                                  ctypes.byref(chunk)), "K9 ring size")
    return stages.value, chunk.value


def bwd_ring(a: int, k: int, acc: bool) -> Tuple[int, int]:
    """K8's (``acc`` false) or K10's band ring at A arcs and K slots a frame:
    (stages, arcs a stage). A stage also holds the frame's [K] row of
    alpha_prev (and aacc_prev for K10), so K must be a multiple of 4 as
    well as A; (0, 0) otherwise, or when the carries leave no room for two
    stages, and the band is read from global memory (as it is when a row is
    not 16-byte aligned)."""
    stages, chunk = ctypes.c_int(), ctypes.c_int()
    D.check_launch(_lib().pk2_latfb_bwd_ring(a, k, int(acc), ctypes.byref(stages),
                                             ctypes.byref(chunk)), "K8/K10 ring size")
    return stages.value, chunk.value


def _check(name: str, t: Tensor, dtype: torch.dtype, shape: tuple, dev: torch.device):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_band(obs_arc, src, dst, w, active, k: int, n_bufs: int, extra=()):
    """Validate the shared band inputs; returns (T, B, A, device)."""
    t_len, b, a = obs_arc.shape
    dev = obs_arc.device
    for name, t in (("obs_arc", obs_arc), ("w", w)) + tuple(extra):
        _check(name, t, torch.float32, (t_len, b, a), dev)
    for name, t in (("src", src), ("dst", dst)):
        _check(name, t, torch.int32, (t_len, b, a), dev)
    _check("active", active, torch.float32, (t_len, b, 1), dev)
    cap = max_slots(n_bufs)
    if not 1 <= k <= cap:
        raise ValueError(f"lattice has {k} slots per frame; the banded kernels hold at most "
                         f"{cap} in shared memory")
    return t_len, b, a, dev


def _launch(fn, what: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        rc = fn(*[D.ptr(x) if torch.is_tensor(x) else x for x in args],
                D.current_stream_ptr(dev))
    D.check_launch(rc, what)


def logz_fwd(obs_arc: Tensor, src: Tensor, dst: Tensor, w: Tensor, active: Tensor,
             k: int) -> Tuple[Tensor, Tensor]:
    """K7. Same contract as ``logz_fwd_plain``."""
    if obs_arc.device.type == "cpu":
        return logz_fwd_plain(obs_arc, src, dst, w, active, k)
    t_len, b, a, dev = _check_band(obs_arc, src, dst, w, active, k, 2)
    alphas = torch.empty((t_len, b, k), dtype=torch.float32, device=dev)
    norms = torch.empty((t_len, b), dtype=torch.float32, device=dev)
    _launch(_lib().pk2_latfb_logz_fwd, "banded lattice forward (K7)", dev,
            obs_arc, src, dst, w, active, alphas, norms, t_len, b, a, k)
    logz_fwd.launches += 1
    return alphas, norms


logz_fwd.launches = 0


def occupancies_bwd(obs_arc: Tensor, src: Tensor, dst: Tensor, w: Tensor, active: Tensor,
                    alpha_prev: Tensor, anorm_prev: Tensor, final: Tensor,
                    logz: Tensor) -> Tensor:
    """K8. Same contract as ``occupancies_bwd_plain``."""
    if obs_arc.device.type == "cpu":
        return occupancies_bwd_plain(obs_arc, src, dst, w, active, alpha_prev, anorm_prev,
                                     final, logz)
    k = final.shape[1]
    t_len, b, a, dev = _check_band(obs_arc, src, dst, w, active, k, 2)
    _check("alpha_prev", alpha_prev, torch.float32, (t_len, b, k), dev)
    _check("anorm_prev", anorm_prev, torch.float32, (t_len, b, 1), dev)
    _check("final", final, torch.float32, (b, k), dev)
    _check("logz", logz, torch.float32, (b, 1), dev)
    gamma = torch.empty((t_len, b, a), dtype=torch.float32, device=dev)
    _launch(_lib().pk2_latfb_occupancies_bwd, "banded lattice backward (K8)", dev,
            obs_arc, src, dst, w, active, alpha_prev, anorm_prev, final, logz, gamma,
            t_len, b, a, k)
    occupancies_bwd.launches += 1
    return gamma


occupancies_bwd.launches = 0


def smbr_fwd(obs_arc: Tensor, src: Tensor, dst: Tensor, w: Tensor, active: Tensor,
             arc_acc: Tensor, k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """K9. Same contract as ``smbr_fwd_plain``."""
    if obs_arc.device.type == "cpu":
        return smbr_fwd_plain(obs_arc, src, dst, w, active, arc_acc, k)
    t_len, b, a, dev = _check_band(obs_arc, src, dst, w, active, k, 4,
                                   extra=(("arc_acc", arc_acc),))
    alphas = torch.empty((t_len, b, k), dtype=torch.float32, device=dev)
    aaccs = torch.empty_like(alphas)
    norms = torch.empty((t_len, b), dtype=torch.float32, device=dev)
    _launch(_lib().pk2_latfb_smbr_fwd, "banded sMBR forward (K9)", dev,
            obs_arc, src, dst, w, active, arc_acc, alphas, aaccs, norms, t_len, b, a, k)
    smbr_fwd.launches += 1
    return alphas, aaccs, norms


smbr_fwd.launches = 0


def smbr_contribs_bwd(obs_arc: Tensor, src: Tensor, dst: Tensor, w: Tensor, active: Tensor,
                      arc_acc: Tensor, alpha_prev: Tensor, aacc_prev: Tensor,
                      anorm_prev: Tensor, final: Tensor, logz: Tensor, f: Tensor) -> Tensor:
    """K10. Same contract as ``smbr_contribs_bwd_plain``."""
    if obs_arc.device.type == "cpu":
        return smbr_contribs_bwd_plain(obs_arc, src, dst, w, active, arc_acc, alpha_prev,
                                       aacc_prev, anorm_prev, final, logz, f)
    k = final.shape[1]
    t_len, b, a, dev = _check_band(obs_arc, src, dst, w, active, k, 4,
                                   extra=(("arc_acc", arc_acc),))
    _check("alpha_prev", alpha_prev, torch.float32, (t_len, b, k), dev)
    _check("aacc_prev", aacc_prev, torch.float32, (t_len, b, k), dev)
    _check("anorm_prev", anorm_prev, torch.float32, (t_len, b, 1), dev)
    _check("final", final, torch.float32, (b, k), dev)
    _check("logz", logz, torch.float32, (b, 1), dev)
    _check("f", f, torch.float32, (b, 1), dev)
    contrib = torch.empty((t_len, b, a), dtype=torch.float32, device=dev)
    _launch(_lib().pk2_latfb_smbr_bwd, "banded sMBR backward (K10)", dev,
            obs_arc, src, dst, w, active, arc_acc, alpha_prev, aacc_prev, anorm_prev,
            final, logz, f, contrib, t_len, b, a, k)
    smbr_contribs_bwd.launches += 1
    return contrib


smbr_contribs_bwd.launches = 0
