"""Host-side Simulator: the reference's per-utterance distortion pipeline.

Numpy copy of pykaldi2_tpu/simulation/simulator.py for the PyTorch port.

Reference behavior: pykaldi2/simulation/ Simulator (SURVEY.md §3.1, §4.3):
per utterance — maybe reverberate (sampled RIR), maybe add noise at a sampled
SNR, maybe gain-perturb, maybe speed-perturb. Plugs into
SpeechDataset(simulate_fn=...) exactly where the reference runs it in
DataLoader workers. The batched on-device variant lives in device.py.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pykaldi2_tpu_torch.config import SimulationConfig
from pykaldi2_tpu_torch.data.wav import read_wav
from pykaldi2_tpu_torch.simulation.resample import resample, speed_perturb_labels
from pykaldi2_tpu_torch.simulation.rir import sample_room_rir


def fft_convolve(wave: np.ndarray, rir: np.ndarray) -> np.ndarray:
    """Full convolution truncated to len(wave) (keeps alignment timing)."""
    n = wave.shape[0] + rir.shape[-1] - 1
    nfft = 1 << (n - 1).bit_length()
    out = np.fft.irfft(np.fft.rfft(wave, nfft) * np.fft.rfft(rir, nfft), nfft)
    return out[: wave.shape[0]].astype(np.float32)


def mix_at_snr(speech: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    """Scale noise to the target SNR vs speech power and add."""
    ps = np.mean(speech.astype(np.float64) ** 2) + 1e-10
    if noise.shape[0] < speech.shape[0]:
        reps = int(np.ceil(speech.shape[0] / noise.shape[0]))
        noise = np.tile(noise, reps)
    noise = noise[: speech.shape[0]]
    pn = np.mean(noise.astype(np.float64) ** 2) + 1e-10
    scale = np.sqrt(ps / (pn * 10.0 ** (snr_db / 10.0)))
    return (speech + scale * noise).astype(np.float32)


class Simulator:
    """Callable (wave, rng) → distorted wave, with an optional label hook.

    If speed perturbation is enabled, call ``simulate_with_labels`` so frame
    labels are remapped consistently with the new duration.
    ``num_channels > 1`` simulates a mic array: per-mic RIR convolution +
    isotropic (diffuse) noise, then returns ``output_channel`` (the
    reference's multichannel simulation feeding single-channel AMs) or the
    full [n, M] array when ``output_channel`` is None.
    """

    def __init__(self, cfg: SimulationConfig, samp_freq: float = 16000.0,
                 frame_shift: int = 160, num_channels: int = 1,
                 output_channel: Optional[int] = 0, mic_spacing: float = 0.05):
        self.cfg = cfg
        self.samp_freq = samp_freq
        self.frame_shift = frame_shift
        self.num_channels = num_channels
        self.output_channel = output_channel
        self.mic_spacing = mic_spacing
        self.rirs: Optional[List[np.ndarray]] = None
        self.noises: Optional[List[np.ndarray]] = None
        if cfg.reverb.rir_list:
            self.rirs = [read_wav(p.strip())[0] for p in open(cfg.reverb.rir_list)]
        if cfg.noise.noise_list:
            self.noises = [read_wav(p.strip())[0] for p in open(cfg.noise.noise_list)]

    def _rir(self, rng) -> np.ndarray:
        if self.rirs:
            r = self.rirs[rng.randint(len(self.rirs))]
            return r if r.ndim == 1 else r[:, 0]
        return sample_room_rir(rng, self.samp_freq,
                               self.cfg.reverb.room_dim_range,
                               self.cfg.reverb.rt60_range)[0]

    def _noise(self, rng, n: int) -> np.ndarray:
        if self.noises:
            nz = self.noises[rng.randint(len(self.noises))]
            nz = nz if nz.ndim == 1 else nz[:, 0]
            if nz.shape[0] > n:
                off = rng.randint(max(nz.shape[0] - n, 1))
                nz = nz[off : off + n]
            return nz
        # synthetic pink-ish noise fallback
        white = rng.randn(n)
        b = np.fft.rfft(white)
        f = np.maximum(np.arange(b.shape[0]), 1.0)
        return np.fft.irfft(b / np.sqrt(f), n).astype(np.float32) * 3000.0

    def __call__(self, wave: np.ndarray, rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        return self.simulate_with_labels(wave, None, rng)[0]

    def simulate_with_labels(
        self, wave: np.ndarray, labels: Optional[np.ndarray],
        rng: Optional[np.random.RandomState] = None,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        rng = rng or np.random.RandomState(self.cfg.seed)
        cfg = self.cfg
        if cfg.perturb.use_speed:
            factor = float(cfg.perturb.speed_choices[rng.randint(len(cfg.perturb.speed_choices))])
            if factor != 1.0:
                wave = resample(wave, factor)
                if labels is not None:
                    from pykaldi2_tpu_torch.frontend.window import num_frames as _nf
                    from pykaldi2_tpu_torch.config import FrameOpts
                    nf_out = max(_nf(wave.shape[0], FrameOpts(samp_freq=self.samp_freq)), 0)
                    labels = speed_perturb_labels(labels, factor, nf_out)
        if self.num_channels > 1:
            return self._simulate_multichannel(wave, labels, rng)
        if cfg.reverb.use_reverb and rng.rand() < cfg.reverb.prob:
            wave = fft_convolve(wave, self._rir(rng))
        if cfg.noise.use_noise and rng.rand() < cfg.noise.prob:
            snr = rng.uniform(*cfg.noise.snr_range)
            wave = mix_at_snr(wave, self._noise(rng, wave.shape[0]), snr)
        if cfg.perturb.use_gain:
            gain_db = rng.uniform(*cfg.perturb.gain_range)
            wave = (wave * 10.0 ** (gain_db / 20.0)).astype(np.float32)
        return wave.astype(np.float32), labels

    def _simulate_multichannel(self, wave, labels, rng):
        """Mic-array path: per-mic RIRs + isotropic noise field."""
        from pykaldi2_tpu_torch.simulation.iso_noise import isotropic_noise

        cfg = self.cfg
        n = wave.shape[0]
        m = self.num_channels
        chans = np.tile(wave[:, None], (1, m)).astype(np.float32)
        if cfg.reverb.use_reverb and rng.rand() < cfg.reverb.prob:
            rirs = sample_room_rir(rng, self.samp_freq, cfg.reverb.room_dim_range,
                                   cfg.reverb.rt60_range, num_mics=m,
                                   mic_spacing=self.mic_spacing)
            chans = np.stack([fft_convolve(wave, rirs[i]) for i in range(m)], axis=1)
        if cfg.noise.use_noise and rng.rand() < cfg.noise.prob:
            snr = rng.uniform(*cfg.noise.snr_range)
            mics = np.stack([[i * self.mic_spacing, 0.0, 0.0] for i in range(m)])
            iso = isotropic_noise(mics, n, self.samp_freq, rng)
            ps = np.mean(chans.astype(np.float64) ** 2) + 1e-10
            pn = np.mean(iso.astype(np.float64) ** 2) + 1e-10
            chans = chans + iso * np.sqrt(ps / (pn * 10.0 ** (snr / 10.0)))
        if cfg.perturb.use_gain:
            gain_db = rng.uniform(*cfg.perturb.gain_range)
            chans = chans * 10.0 ** (gain_db / 20.0)
        chans = chans.astype(np.float32)
        if self.output_channel is not None:
            return chans[:, self.output_channel], labels
        return chans, labels
