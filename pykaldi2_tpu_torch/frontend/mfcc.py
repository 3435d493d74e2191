"""MFCC features with Kaldi semantics, batched torch.

Port of pykaldi2_tpu/frontend/mfcc.py (reference behavior:
kaldi/src/feat/feature-mfcc.{h,cc}): orthonormal DCT-II over log-mel
energies, cepstral liftering (coefficient 1 + 0.5*Q*sin(pi*i/Q)), optional
log-energy in c0. ``dct_matrix`` and ``lifter_coeffs`` are numpy copies of
the reference's; the products are fp32 GEMMs, full precision on CUDA
(``device.set_fp32_exact``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pykaldi2_tpu_torch.config import MfccOpts
from pykaldi2_tpu_torch.frontend import window as W
from pykaldi2_tpu_torch.frontend.fbank import power_spectrum
from pykaldi2_tpu_torch.frontend.mel import mel_banks


@functools.lru_cache(maxsize=8)
def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthonormal DCT-II matrix rows 0..num_ceps-1 (Kaldi ComputeDctMatrix)."""
    m = np.zeros((num_ceps, num_bins), dtype=np.float64)
    m[0, :] = np.sqrt(1.0 / num_bins)
    n = np.arange(num_bins, dtype=np.float64)
    for k in range(1, num_ceps):
        m[k, :] = np.sqrt(2.0 / num_bins) * np.cos(np.pi / num_bins * (n + 0.5) * k)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=8)
def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Kaldi ComputeLifterCoeffs: c[i] = 1 + 0.5*Q*sin(pi*i/Q)."""
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(np.pi * i / q)).astype(np.float32)


def compute_mfcc(
    wave: torch.Tensor,
    opts: MfccOpts,
    *,
    generator: torch.Generator | None = None,
    mel_weights: torch.Tensor | None = None,
    warp_select: torch.Tensor | None = None,
) -> torch.Tensor:
    """[..., n_samples] fp32 waveform → [..., n_frames, num_ceps] MFCCs.

    Dither draws from ``generator``; ``mel_weights``/``warp_select`` give
    per-utterance VTLN, as in ``compute_fbank``.
    """
    fopts = opts.frame_opts
    frames = W.extract_frames(wave, fopts)
    need_energy = opts.use_energy and opts.raw_energy
    out = W.process_frames(frames, fopts, generator=generator, return_log_energy=need_energy)
    if need_energy:
        proc, log_energy = out
    else:
        proc = out
        if opts.use_energy:  # non-raw: energy after windowing
            log_energy = torch.log(torch.clamp(torch.sum(proc * proc, dim=-1),
                                               min=W.FLT_EPSILON))
    padded = W.padded_frames(proc, fopts)
    spec = power_spectrum(padded, fopts.padded_window_size)
    if mel_weights is not None and warp_select is not None:
        per_row = mel_weights.to(spec.device)[warp_select]            # [B, M, F]
        mel_e = torch.einsum("btf,bmf->btm", spec, per_row)
    else:
        mel_w = torch.as_tensor(mel_banks(opts.mel_opts, fopts), device=spec.device)
        mel_e = spec @ mel_w.T
    log_mel = torch.log(torch.clamp(mel_e, min=W.FLT_EPSILON))
    dct = torch.as_tensor(dct_matrix(opts.num_ceps, opts.mel_opts.num_bins), device=spec.device)
    ceps = log_mel @ dct.T
    if opts.cepstral_lifter != 0.0:
        ceps = ceps * torch.as_tensor(lifter_coeffs(opts.num_ceps, opts.cepstral_lifter),
                                      device=spec.device)
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_energy = torch.clamp(log_energy, min=float(np.log(opts.energy_floor)))
        ceps = torch.cat([log_energy[..., None], ceps[..., 1:]], dim=-1)
    return ceps
