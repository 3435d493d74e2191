"""Windowed-sinc resampling (Kaldi LinearResample semantics) for speed perturb.

Numpy copy of pykaldi2_tpu/simulation/resample.py for the PyTorch port.

Reference behavior: speed perturbation in the reference stack resamples the
waveform by factors like 0.9/1.0/1.1 (sox speed / Kaldi speed-perturb);
implemented here as a polyphase windowed-sinc resampler (Hann window).
"""

from __future__ import annotations

import numpy as np


def resample(wave: np.ndarray, factor: float, num_zeros: int = 16) -> np.ndarray:
    """Resample so the output is ``len(wave)/factor`` samples (speed=factor).

    factor > 1 → faster (shorter); factor < 1 → slower (longer). Pitch shifts
    with speed, matching sox's `speed` used by Kaldi's speed perturbation.
    """
    wave = np.asarray(wave, np.float64)
    n_in = wave.shape[0]
    n_out = int(round(n_in / factor))
    if abs(factor - 1.0) < 1e-9 or n_in == 0:
        return wave.astype(np.float32)
    # output sample t maps to input position t*factor
    pos = np.arange(n_out) * factor
    i0 = np.floor(pos).astype(np.int64)
    # anti-aliasing cutoff for downsampling (factor > 1)
    cutoff = min(1.0, 1.0 / factor)
    half = num_zeros
    offs = np.arange(-half, half + 1)
    idx = i0[:, None] + offs[None, :]
    frac = pos[:, None] - idx
    x = cutoff * frac
    safe_x = np.where(np.abs(x) < 1e-12, 1.0, x)
    sinc = np.where(np.abs(x) < 1e-12, 1.0, np.sin(np.pi * safe_x) / (np.pi * safe_x)) * cutoff
    win_arg = frac / (half + 1)
    window = np.where(np.abs(win_arg) < 1.0, 0.5 + 0.5 * np.cos(np.pi * win_arg), 0.0)
    taps = sinc * window
    idx = np.clip(idx, 0, n_in - 1)
    out = np.sum(wave[idx] * taps, axis=1)
    return out.astype(np.float32)


def speed_perturb_labels(labels: np.ndarray, factor: float, num_frames_out: int) -> np.ndarray:
    """Map per-frame labels through a speed change: out[t] = in[round(t*factor)]."""
    idx = np.minimum((np.arange(num_frames_out) * factor).astype(np.int64), len(labels) - 1)
    return np.asarray(labels)[idx]
