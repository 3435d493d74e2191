"""Framing and per-frame waveform processing with Kaldi semantics, in torch.

Port of pykaldi2_tpu/frontend/window.py (reference behavior:
kaldi/src/feat/feature-window.{h,cc} — ``NumFrames``, ``ExtractWindow``,
``ProcessWindow``, ``FeatureWindowFunction``).

Processing order inside a frame (ProcessWindow):
  1. dither (Gaussian, amplitude ``dither``)
  2. DC offset removal (subtract frame mean)
  3. [raw log-energy is measured here if requested]
  4. pre-emphasis: w[i] -= coeff * w[i-1]; w[0] -= coeff * w[0]
  5. multiply by the window function (povey = hann**0.85, etc.)
"""

from __future__ import annotations

import numpy as np
import torch

from pykaldi2_tpu_torch.config import FrameOpts

# Matches std::numeric_limits<float>::epsilon() used by Kaldi as the
# log-energy floor.
FLT_EPSILON = float(np.finfo(np.float32).eps)


def num_frames(num_samples: int, opts: FrameOpts, flush: bool = True) -> int:
    """Frame count for a waveform of ``num_samples`` samples (host-side, static)."""
    window = opts.window_size
    shift = opts.window_shift
    if opts.snip_edges:
        if num_samples < window:
            return 0
        return 1 + (num_samples - window) // shift
    else:
        nf = (num_samples + shift // 2) // shift
        if flush:
            return nf
        end = (nf - 1) * shift + window
        while nf > 0 and end > num_samples:
            nf -= 1
            end -= shift
        return nf


def feature_window(opts: FrameOpts) -> np.ndarray:
    """The window function vector (host-built constant), fp64 math then fp32.

    Kaldi computes the window in double and stores float; we do the same so
    golden vectors agree to float precision.
    """
    n = opts.window_size
    a = 2.0 * np.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    wt = opts.window_type
    if wt == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif wt == "sine":
        w = np.sin(0.5 * a * i)
    elif wt == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif wt == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif wt == "rectangular":
        w = np.ones(n)
    elif wt == "blackman":
        b = opts.blackman_coeff
        w = b - 0.5 * np.cos(a * i) + (0.5 - b) * np.cos(2 * a * i)
    else:
        raise ValueError(f"unknown window type {wt!r}")
    return w.astype(np.float32)


def _frame_indices(n_samples: int, n_frames: int, opts: FrameOpts) -> np.ndarray:
    """Sample index matrix [n_frames, window]; reflection at edges if not snip_edges."""
    window = opts.window_size
    shift = opts.window_shift
    frame = np.arange(n_frames, dtype=np.int64)[:, None]
    off = np.arange(window, dtype=np.int64)[None, :]
    if opts.snip_edges:
        idx = frame * shift + off
    else:
        start = frame * shift + shift // 2 - window // 2
        idx = start + off
        # Kaldi reflects out-of-range indices: s<0 → -s-1 ; s>=n → 2n-s-1
        # (applied repeatedly; one application suffices for window < n).
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= n_samples, 2 * n_samples - idx - 1, idx)
        idx = np.clip(idx, 0, n_samples - 1)
    return idx


def extract_frames(wave: torch.Tensor, opts: FrameOpts) -> torch.Tensor:
    """[..., n_samples] → [..., n_frames, window] raw frames (no processing)."""
    n_samples = wave.shape[-1]
    nf = num_frames(n_samples, opts)
    idx = torch.as_tensor(_frame_indices(n_samples, nf, opts), device=wave.device)
    return wave[..., idx]


def process_frames(
    frames: torch.Tensor,
    opts: FrameOpts,
    *,
    window: np.ndarray | None = None,
    generator: torch.Generator | None = None,
    return_log_energy: bool = False,
):
    """Apply dither / DC removal / (raw energy) / pre-emphasis / windowing.

    frames: [..., window_size] fp32.

    Dither draws from ``generator`` (a ``torch.Generator`` on the frames'
    device): bit parity with Kaldi's RandGauss stream, or with the JAX
    package's PRNG, is impossible by construction, so parity runs use
    dither=0.
    """
    x = frames.to(torch.float32)
    if opts.dither != 0.0:
        if generator is None:
            raise ValueError("dither enabled but no torch.Generator supplied")
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=torch.float32)
        x = x + opts.dither * noise
    if opts.remove_dc_offset:
        x = x - torch.mean(x, dim=-1, keepdim=True)
    log_energy = None
    if return_log_energy:
        log_energy = torch.log(torch.clamp(torch.sum(x * x, dim=-1), min=FLT_EPSILON))
    if opts.preemph_coeff != 0.0:
        c = opts.preemph_coeff
        prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - c * prev
    if window is None:
        window = feature_window(opts)
    x = x * torch.as_tensor(window, device=x.device)
    if return_log_energy:
        return x, log_energy
    return x


def padded_frames(frames: torch.Tensor, opts: FrameOpts) -> torch.Tensor:
    """Zero-pad processed frames to the FFT size (round_to_power_of_two)."""
    pad = opts.padded_window_size - opts.window_size
    if pad == 0:
        return frames
    return torch.nn.functional.pad(frames, (0, pad))
