"""Room impulse response generation: image-source method (host-side numpy).

Numpy copy of pykaldi2_tpu/simulation/rir.py for the PyTorch port.

Reference behavior: the RIR sampling/generation path of pykaldi2/simulation/
(SURVEY.md §3.1); method per Allen & Berkley's image model as used by the
room-simulator papers in PAPERS.md. Vectorized over image sources; supports
multi-microphone arrays (one RIR per mic).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

SPEED_OF_SOUND = 343.0


def t60_to_reflectivity(room_dim: Sequence[float], t60: float) -> float:
    """Sabine's formula → average wall reflection coefficient."""
    lx, ly, lz = room_dim
    volume = lx * ly * lz
    surface = 2.0 * (lx * ly + lx * lz + ly * lz)
    # Sabine: T60 = 0.161 V / (S * a), absorption a
    absorption = min(0.161 * volume / (surface * max(t60, 1e-3)), 0.9999)
    return float(np.sqrt(1.0 - absorption))


def image_source_rir(
    room_dim: Sequence[float],
    source: Sequence[float],
    mics: np.ndarray,              # [M, 3]
    t60: float,
    samp_freq: float = 16000.0,
    max_order: Optional[int] = None,
    rir_len: Optional[int] = None,
) -> np.ndarray:
    """Image-source RIRs [M, rir_len] (fractional delays via linear interp)."""
    room_dim = np.asarray(room_dim, np.float64)
    source = np.asarray(source, np.float64)
    mics = np.atleast_2d(np.asarray(mics, np.float64))
    beta = t60_to_reflectivity(room_dim, t60)
    if rir_len is None:
        rir_len = int(samp_freq * min(max(t60 * 1.2, 0.05), 1.0))
    max_dist = rir_len / samp_freq * SPEED_OF_SOUND
    if max_order is None:
        max_order = int(np.ceil(max_dist / (2 * room_dim.min()))) + 1
        max_order = min(max_order, 12)

    n = np.arange(-max_order, max_order + 1)
    rirs = np.zeros((mics.shape[0], rir_len), np.float64)
    # image positions per axis: for image index n and reflection parity q:
    #   x_img = (1-2q) * src + 2 n L ; reflections count |n - ... |
    # standard ISM enumeration: for each axis, images at 2nL ± src
    axes_imgs = []
    for ax in range(3):
        L, s = room_dim[ax], source[ax]
        pos = np.concatenate([2 * n * L + s, 2 * n * L - s])
        refl = np.concatenate([np.abs(n) * 2, np.abs(2 * n - 1)])
        axes_imgs.append((pos, refl))

    # cartesian product over 3 axes, vectorized
    px, rx = axes_imgs[0]
    py, ry = axes_imgs[1]
    pz, rz = axes_imgs[2]
    PX, PY, PZ = np.meshgrid(px, py, pz, indexing="ij")
    RX, RY, RZ = np.meshgrid(rx, ry, rz, indexing="ij")
    imgs = np.stack([PX.ravel(), PY.ravel(), PZ.ravel()], axis=1)   # [K, 3]
    refl_count = (RX + RY + RZ).ravel()
    gains_all = beta ** refl_count

    for m in range(mics.shape[0]):
        d = np.linalg.norm(imgs - mics[m], axis=1)
        keep = d < max_dist
        dd = np.maximum(d[keep], 0.1)
        tau = dd / SPEED_OF_SOUND * samp_freq
        g = gains_all[keep] / (4.0 * np.pi * dd)
        i0 = np.floor(tau).astype(np.int64)
        frac = tau - i0
        ok = i0 < rir_len - 1
        np.add.at(rirs[m], i0[ok], g[ok] * (1.0 - frac[ok]))
        np.add.at(rirs[m], i0[ok] + 1, g[ok] * frac[ok])
    return rirs.astype(np.float32)


def sample_room_rir(
    rng: np.random.RandomState,
    samp_freq: float = 16000.0,
    room_dim_range: Tuple[float, float] = (3.0, 10.0),
    t60_range: Tuple[float, float] = (0.1, 0.6),
    num_mics: int = 1,
    mic_spacing: float = 0.05,
) -> np.ndarray:
    """Sample a random room/source/mic geometry → RIRs [num_mics, L]."""
    room = rng.uniform(*room_dim_range, size=3)
    room[2] = min(room[2], 4.0)  # plausible ceiling
    t60 = rng.uniform(*t60_range)
    margin = 0.5
    src = rng.uniform(margin, room - margin)
    center = rng.uniform(margin, room - margin)
    mics = np.stack([center + np.array([i * mic_spacing, 0, 0]) for i in range(num_mics)])
    mics = np.clip(mics, margin / 2, room - margin / 2)
    return image_source_rir(room, src, mics, t60, samp_freq)
