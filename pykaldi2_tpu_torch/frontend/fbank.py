"""Log-mel filterbank features with Kaldi semantics, batched torch.

Port of pykaldi2_tpu/frontend/fbank.py (reference behavior:
kaldi/src/feat/feature-fbank.{h,cc}). The waveform batch is framed with a
gather, processed elementwise, and the spectrum and mel stages are fp32
GEMMs (the real DFT as products with host-built cos/sin matrices). On CUDA
the products must run in full fp32: ``device.set_fp32_exact`` turns TF32 off
for matmuls and cuDNN, which ``resolve_device`` does for every entry point.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pykaldi2_tpu_torch.config import FbankOpts
from pykaldi2_tpu_torch.frontend import window as W
from pykaldi2_tpu_torch.frontend.mel import mel_banks

# Kaldi floors mel energies at std::numeric_limits<float>::epsilon() before log.
_LOG_FLOOR = W.FLT_EPSILON


@functools.lru_cache(maxsize=8)
def _dft_matrices(n: int):
    """Real-DFT cos/sin matrices [n, n//2] (Nyquist excluded — mel ignores it)."""
    k = np.arange(n // 2, dtype=np.float64)[None, :]
    t = np.arange(n, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * t * k / n
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def power_spectrum(frames: torch.Tensor, n_fft: int) -> torch.Tensor:
    """[..., n_fft] padded frames → [..., n_fft//2] power spectrum (no Nyquist)."""
    cos_m, sin_m = _dft_matrices(n_fft)
    re = frames @ torch.as_tensor(cos_m, device=frames.device)
    im = frames @ torch.as_tensor(sin_m, device=frames.device)
    return re * re + im * im


def fbank_dim(opts: FbankOpts) -> int:
    return opts.mel_opts.num_bins + (1 if opts.use_energy else 0)


def compute_fbank(
    wave: torch.Tensor,
    opts: FbankOpts,
    *,
    generator: torch.Generator | None = None,
    mel_weights: torch.Tensor | None = None,
    warp_select: torch.Tensor | None = None,
) -> torch.Tensor:
    """[..., n_samples] fp32 waveform → [..., n_frames, dim] fbank features.

    Matches Kaldi's FbankComputer pipeline: frame → dither → DC removal →
    (raw energy) → pre-emphasis → window → pad-to-pow2 → power spectrum →
    mel GEMM → log with epsilon floor; energy prepended if use_energy.

    Per-utterance VTLN: pass ``mel_weights`` [W, num_bins, n_fft_bins] (one
    mel matrix per quantized warp factor) and ``warp_select`` [B] row indices.
    """
    fopts = opts.frame_opts
    frames = W.extract_frames(wave, fopts)
    need_energy = opts.use_energy and opts.raw_energy
    out = W.process_frames(frames, fopts, generator=generator,
                           return_log_energy=need_energy)
    if need_energy:
        proc, log_energy = out
    else:
        proc = out
        if opts.use_energy:  # non-raw: energy after windowing
            log_energy = torch.log(torch.clamp(torch.sum(proc * proc, dim=-1), min=W.FLT_EPSILON))
    padded = W.padded_frames(proc, fopts)
    spec = power_spectrum(padded, fopts.padded_window_size)
    if not opts.use_power:
        spec = torch.sqrt(spec)
    if mel_weights is not None and warp_select is not None:
        per_row = mel_weights.to(spec.device)[warp_select]            # [B, M, F]
        mel_e = torch.einsum("btf,bmf->btm", spec, per_row)
    else:
        mel_w = torch.as_tensor(mel_banks(opts.mel_opts, fopts), device=spec.device)
        mel_e = spec @ mel_w.T
    feats = torch.log(torch.clamp(mel_e, min=_LOG_FLOOR)) if opts.use_log_fbank else mel_e
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_energy = torch.clamp(log_energy, min=float(np.log(opts.energy_floor)))
        feats = torch.cat([log_energy[..., None], feats], dim=-1)
    return feats
