"""Isotropic (diffuse) multichannel noise synthesis.

Numpy copy of pykaldi2_tpu/simulation/iso_noise.py for the PyTorch port.

Reference behavior: pykaldi2/simulation/'s multichannel + isotropic noise
helpers (SURVEY.md §3.1 "Simulation": "single- and multi-channel incl.
isotropic noise fields"). Method: mix independent white noises through a
per-frequency Cholesky factor of the theoretical spherically-isotropic
coherence matrix Γ_ij(f) = sinc(2·f·d_ij/c) (Habets' classic generator).
"""

from __future__ import annotations

import numpy as np

SPEED_OF_SOUND = 343.0


def diffuse_coherence(mics: np.ndarray, freqs: np.ndarray) -> np.ndarray:
    """[F, M, M] spherically isotropic coherence (sinc in natural units)."""
    d = np.linalg.norm(mics[:, None, :] - mics[None, :, :], axis=-1)  # [M, M]
    x = 2.0 * freqs[:, None, None] * d[None] / SPEED_OF_SOUND
    return np.sinc(x)


def isotropic_noise(
    mics: np.ndarray,
    n_samples: int,
    samp_freq: float = 16000.0,
    rng: np.random.RandomState | None = None,
    nfft: int = 512,
) -> np.ndarray:
    """[n_samples, M] diffuse noise field over a mic array (unit variance)."""
    rng = rng or np.random.RandomState(0)
    mics = np.atleast_2d(mics)
    m = mics.shape[0]
    if m == 1:
        return rng.randn(n_samples, 1).astype(np.float32)
    hop = nfft // 2
    n_frames = int(np.ceil(n_samples / hop)) + 2
    freqs = np.fft.rfftfreq(nfft, 1.0 / samp_freq)
    gamma = diffuse_coherence(mics, freqs)                   # [F, M, M]
    # Cholesky with diagonal loading for numerical safety
    chol = np.linalg.cholesky(gamma + 1e-6 * np.eye(m)[None])
    # independent white noise spectra per channel/frame
    spec = (rng.randn(n_frames, freqs.size, m) + 1j * rng.randn(n_frames, freqs.size, m))
    mixed = np.einsum("fij,tfj->tfi", chol, spec)            # [T, F, M]
    # overlap-add synthesis with a sqrt-Hann window
    win = np.sqrt(np.hanning(nfft))
    out = np.zeros((n_frames * hop + nfft, m))
    for t in range(n_frames):
        frame = np.fft.irfft(mixed[t], nfft, axis=0) * win[:, None]
        out[t * hop : t * hop + nfft] += frame
    out = out[nfft // 2 : nfft // 2 + n_samples]
    out /= out.std() + 1e-9
    return out.astype(np.float32)
