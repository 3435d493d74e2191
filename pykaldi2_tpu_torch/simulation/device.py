"""Batched on-device simulation: reverb + noise + gain inside the train step.

Port of pykaldi2_tpu/simulation/device.py. The host samples the bulky
per-row tensors (one RIR and one noise clip per row, ``DeviceSimulator``, a
numpy copy); the train step applies them to the waveform batch on the
device before the front end: an FFT convolution (``torch.fft``, as the
reference's ``jnp.fft`` runs in XLA outside any Pallas kernel), SNR mixing
and a gain, each row gated by its own draws.

The reference draws its gates, SNRs and gains from a JAX key; here
``draw_simulation`` draws them from the step's ``torch.Generator`` and
``apply_simulation`` is the deterministic rest, so the two packages agree
given the same draws. Speed perturbation changes the sequence length, so it
stays on the host (simulation/resample.py).
"""

from __future__ import annotations

import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from pykaldi2_tpu_torch.simulation.simulator import Simulator

Tensor = torch.Tensor


def batch_fft_convolve(waves: Tensor, rirs: Tensor) -> Tensor:
    """[B, N] ⊛ [B, L] → [B, N] (truncated to keep label alignment)."""
    n = waves.shape[-1]
    nfft = 1 << (n + rirs.shape[-1] - 2).bit_length()
    out = torch.fft.irfft(torch.fft.rfft(waves, nfft) * torch.fft.rfft(rirs, nfft), nfft)
    return out[..., :n].to(torch.float32)


def batch_mix_noise_at_snr(waves: Tensor, noises: Tensor, snr_db: Tensor,
                           mask: Optional[Tensor] = None) -> Tensor:
    """Add each row's noise at its SNR [B] against the row's speech power,
    both measured over ``mask`` [B, N] (1.0 on real samples)."""
    m = torch.ones_like(waves) if mask is None else mask
    count = torch.clamp(torch.sum(m, -1, keepdim=True), min=1.0)
    ps = torch.sum(waves * waves * m, -1, keepdim=True) / count + 1e-10
    pn = torch.sum(noises * noises * m, -1, keepdim=True) / count + 1e-10
    scale = torch.sqrt(ps / (pn * 10.0 ** (snr_db[:, None] / 10.0)))
    return (waves + scale * noises * m).to(torch.float32)


def batch_gain_db(waves: Tensor, gain_db: Tensor) -> Tensor:
    return (waves * 10.0 ** (gain_db[:, None] / 20.0)).to(torch.float32)


class DeviceSimulator:
    """Host half of the on-device simulation path: samples per-row RIR and
    noise tensors (reusing the host Simulator's RIR library / synthesis and
    noise cutting) that the train step then applies through
    ``apply_simulation`` inside FeaturePipeline. Gates, SNR and gain are
    drawn on the device from the step's generator, so only the bulky
    tensors cross from the host.

    ``batch_extras(utt_ids, n_samples)`` plugs into the loaders' extras hook
    alongside FeaturePipeline.batch_extras.
    """

    def __init__(self, cfg, samp_freq: float = 16000.0, rir_len: int = 8000,
                 frame_shift: int = 160):
        self.cfg = cfg
        self.rir_len = rir_len
        self._host = Simulator(cfg, samp_freq=samp_freq, frame_shift=frame_shift)

    def _row_rng(self, utt_id: str) -> np.random.RandomState:
        """Deterministic per-utterance RNG (the host loaders' crc-keyed
        convention): the same utterance gets the same RIR/noise tensors on
        every run and across resumes; step-level variety comes from the
        device-side gate/SNR/gain draws."""
        h = zlib.crc32(f"{self.cfg.seed}|sim|{utt_id}".encode()) & 0x7FFFFFFF
        return np.random.RandomState(h or 1)

    def batch_extras(self, utt_ids, n_samples=None) -> dict:
        out = {}
        b = len(utt_ids)
        if self.cfg.reverb.use_reverb:
            rirs = np.zeros((b, self.rir_len), np.float32)
            for i, uid in enumerate(utt_ids):
                r = self._host._rir(self._row_rng(uid))
                n = min(r.shape[0], self.rir_len)
                rirs[i, :n] = r[:n]
            out["sim_rir"] = rirs
        if self.cfg.noise.use_noise:
            if n_samples is None:
                raise ValueError("on-device noise mixing needs the batch "
                                 "sample length (wave-mode corpora only)")
            noises = np.zeros((b, n_samples), np.float32)
            for i, uid in enumerate(utt_ids):
                nz = self._host._noise(self._row_rng(uid), n_samples)
                if nz.shape[0] < n_samples:
                    nz = np.tile(nz, int(np.ceil(n_samples / nz.shape[0])))
                noises[i] = nz[:n_samples]
            out["sim_noise"] = noises
        return out


Draws = Tuple[Optional[Tensor], Optional[Tensor], Optional[Tensor], Optional[Tensor]]


def draw_simulation(generator: torch.Generator, b: int, cfg) -> Draws:
    """The random part of the step's simulation, from ``generator`` on its
    device: (reverb_gate [B], snr_db [B], noise_gate [B], gain_db [B]),
    None where ``cfg`` (a SimulationConfig) turns the distortion off.

    Order: one uniform [B] for the reverb gate (1.0 where below
    ``reverb.prob``), then one for the SNR (scaled into ``noise.snr_range``)
    and one for the noise gate, then one for the gain (into
    ``perturb.gain_range``); a distortion that is off draws nothing."""
    def uniform(lo: float, hi: float) -> Tensor:
        u = torch.rand(b, generator=generator, device=generator.device)
        return lo + (hi - lo) * u

    reverb_gate = snr = noise_gate = gain = None
    if cfg.reverb.use_reverb:
        reverb_gate = (uniform(0.0, 1.0) < cfg.reverb.prob).to(torch.float32)
    if cfg.noise.use_noise:
        snr = uniform(*cfg.noise.snr_range)
        noise_gate = (uniform(0.0, 1.0) < cfg.noise.prob).to(torch.float32)
    if cfg.perturb.use_gain:
        gain = uniform(*cfg.perturb.gain_range)
    return reverb_gate, snr, noise_gate, gain


def apply_simulation(waves: Tensor, rirs: Optional[Tensor], noises: Optional[Tensor],
                     reverb_gate: Optional[Tensor], snr_db: Optional[Tensor],
                     noise_gate: Optional[Tensor], gain_db: Optional[Tensor],
                     sample_mask: Optional[Tensor] = None) -> Tensor:
    """The deterministic part of the reference's simulate_batch: rows whose
    reverb gate is 1 are convolved with their RIR, rows whose noise gate is
    1 get their noise at ``snr_db`` (powers over ``sample_mask``), then every
    row takes its gain. A None tensor skips its stage."""
    out = waves
    if rirs is not None:
        gate = reverb_gate[:, None]
        out = gate * batch_fft_convolve(out, rirs) + (1.0 - gate) * out
    if noises is not None:
        gate = noise_gate[:, None]
        noisy = batch_mix_noise_at_snr(out, noises, snr_db, sample_mask)
        out = gate * noisy + (1.0 - gate) * out
    if gain_db is not None:
        out = batch_gain_db(out, gain_db)
    return out
