"""Mel filterbank construction with Kaldi semantics, incl. VTLN warping.

Reference behavior: kaldi/src/feat/mel-computations.{h,cc} — ``MelBanks``,
``VtlnWarpFreq``, ``VtlnWarpMelFreq`` (SURVEY.md §3.2).

The bank is a host-built [num_bins, num_fft_bins] numpy fp32 matrix
(num_fft_bins = padded_window/2; the Nyquist bin is excluded, as in Kaldi).
Applying it is a single GEMM — MXU-native.
"""

from __future__ import annotations

import numpy as np

from pykaldi2_tpu_torch.config import FrameOpts, MelOpts


def mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1.0)


def _vtln_warp_freq(
    vtln_low_cutoff: float,
    vtln_high_cutoff: float,
    low_freq: float,
    high_freq: float,
    warp: float,
    freq: np.ndarray,
) -> np.ndarray:
    """Piecewise-linear VTLN frequency warp (Kaldi MelBanks::VtlnWarpFreq)."""
    freq = np.asarray(freq, dtype=np.float64)
    l = vtln_low_cutoff * max(1.0, warp)
    h = vtln_high_cutoff * min(1.0, warp)
    scale = 1.0 / warp
    Fl = scale * l
    Fh = scale * h
    scale_left = (Fl - low_freq) / (l - low_freq)
    scale_right = (high_freq - Fh) / (high_freq - h)
    out = np.where(
        freq < l,
        low_freq + scale_left * (freq - low_freq),
        np.where(freq < h, scale * freq, high_freq + scale_right * (freq - high_freq)),
    )
    return np.where((freq < low_freq) | (freq > high_freq), freq, out)


def _vtln_warp_mel_freq(vl, vh, lo, hi, warp, mel):
    return mel_scale(_vtln_warp_freq(vl, vh, lo, hi, warp, inverse_mel_scale(mel)))


def mel_banks(mel_opts: MelOpts, frame_opts: FrameOpts, warp: float | None = None) -> np.ndarray:
    """Build the [num_bins, num_fft_bins] triangular mel weight matrix."""
    warp = mel_opts.vtln_warp if warp is None else warp
    nyquist = 0.5 * frame_opts.samp_freq
    num_fft_bins = frame_opts.padded_window_size // 2
    low_freq = mel_opts.low_freq
    high_freq = mel_opts.high_freq if mel_opts.high_freq > 0 else nyquist + mel_opts.high_freq
    if not (0 <= low_freq < nyquist and 0 < high_freq <= nyquist and low_freq < high_freq):
        raise ValueError(f"bad mel frequency range [{low_freq}, {high_freq}] vs nyquist {nyquist}")

    fft_bin_width = frame_opts.samp_freq / frame_opts.padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (mel_opts.num_bins + 1)

    vtln_high = mel_opts.vtln_high
    if vtln_high < 0:
        vtln_high += nyquist

    bins = np.zeros((mel_opts.num_bins, num_fft_bins), dtype=np.float64)
    fft_mels = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))
    for b in range(mel_opts.num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        if warp != 1.0:
            left = _vtln_warp_mel_freq(mel_opts.vtln_low, vtln_high, low_freq, high_freq, warp, left)
            center = _vtln_warp_mel_freq(mel_opts.vtln_low, vtln_high, low_freq, high_freq, warp, center)
            right = _vtln_warp_mel_freq(mel_opts.vtln_low, vtln_high, low_freq, high_freq, warp, right)
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        w = np.minimum(up, down)
        bins[b] = np.where((fft_mels > left) & (fft_mels < right), np.maximum(w, 0.0), 0.0)
    return bins.astype(np.float32)


def mel_bank_centers(mel_opts: MelOpts, frame_opts: FrameOpts) -> np.ndarray:
    """Center frequencies (Hz) of each mel bin — useful for diagnostics."""
    nyquist = 0.5 * frame_opts.samp_freq
    low = mel_opts.low_freq
    high = mel_opts.high_freq if mel_opts.high_freq > 0 else nyquist + mel_opts.high_freq
    mel_low, mel_high = mel_scale(low), mel_scale(high)
    delta = (mel_high - mel_low) / (mel_opts.num_bins + 1)
    centers = mel_low + (np.arange(mel_opts.num_bins, dtype=np.float64) + 1) * delta
    return inverse_mel_scale(centers).astype(np.float32)
