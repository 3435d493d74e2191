"""Feature pipeline on the device: waveform batch → normalized features.

Port of pykaldi2_tpu/pipeline.py. The trainer calls it on the raw waveform
batch already on the device, so the on-device simulation (when configured),
framing, fbank or MFCC, CMVN, deltas and splicing run there; the standard
log-power fbank goes through the fused kernel K1 and MFCC through K4.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.config import FeatConfig
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.frontend import (
    add_deltas,
    apply_cmvn,
    compute_fbank,
    compute_mfcc,
    splice_frames,
    utterance_cmvn,
)
from pykaldi2_tpu_torch.frontend.cmvn import cmvn_mean_std
from pykaldi2_tpu_torch.frontend.fused import fused_fbank, fused_mfcc
from pykaldi2_tpu_torch.simulation.device import (DeviceSimulator, apply_simulation,
                                                  draw_simulation)


def base_feature_dim(cfg: FeatConfig) -> int:
    if cfg.type == "fbank":
        return cfg.fbank.mel_opts.num_bins + (1 if cfg.fbank.use_energy else 0)
    if cfg.type == "mfcc":
        return cfg.mfcc.num_ceps
    raise ValueError(f"unknown feature type {cfg.type!r}")


def feature_dim(cfg: FeatConfig) -> int:
    """Final model input dim after deltas and splicing."""
    d = base_feature_dim(cfg) * (cfg.delta_order + 1)
    return d * (cfg.splice_left + 1 + cfg.splice_right)


def save_cmvn_stats(path: str, stats: np.ndarray):
    """Write [2, D+1] stats as a Kaldi binary double-matrix file."""
    with open(path, "wb") as f:
        f.write(kaldi_io.BINARY_MARKER)
        kaldi_io.write_matrix(f, np.asarray(stats, np.float64))


def load_cmvn_stats(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        marker = f.read(2)
        if marker != kaldi_io.BINARY_MARKER:
            raise ValueError(f"{path} is not a binary Kaldi matrix")
        return kaldi_io.read_matrix(f)


class FeaturePipeline:
    """Configured wave/feats batch → model-input features.

    Call with a batch dict of tensors (``wave`` [B,S] or ``feats`` [B,T,D])
    and the frame ``mask`` [B,T]; returns [B, T, feature_dim] fp32 on the
    batch's device. Dither draws from the ``generator`` passed in.
    """

    def __init__(self, cfg: FeatConfig, cmvn_stats: Optional[np.ndarray] = None,
                 device_sim_cfg=None):
        """device_sim_cfg: a SimulationConfig with on_device=True — a call
        with a generator then applies reverb/noise/gain to the waveform batch
        (simulation/device.py) before feature extraction, using the
        sim_rir/sim_noise rows DeviceSimulator.batch_extras attached.
        Training only: eval copies (for_eval) drop it with the dither."""
        self.cfg = cfg
        self.device_sim_cfg = device_sim_cfg
        self.mean = None
        self.scale = None
        if cfg.cmvn.stats_path and cmvn_stats is None:
            cmvn_stats = load_cmvn_stats(cfg.cmvn.stats_path)
        if cmvn_stats is not None:
            self.mean, self.scale = cmvn_mean_std(cmvn_stats, cfg.cmvn.norm_vars)
        # (device, mean, scale): the global stats on the batch's device, made
        # once; a copy from host memory every step would make the host wait
        # for the device before it can queue the next step
        self._cmvn_on = None
        # per-speaker CMVN: host-side table; rows reach the device through
        # batch["cmvn_mean"/"cmvn_scale"] attached by batch_extras
        self.speaker_cmvn = None
        if cfg.cmvn.utt2spk and cfg.cmvn.spk_stats_scp:
            from pykaldi2_tpu_torch.frontend.cmvn import SpeakerCmvn

            self.speaker_cmvn = SpeakerCmvn(cfg.cmvn.utt2spk, cfg.cmvn.spk_stats_scp,
                                            cfg.cmvn.norm_means, cfg.cmvn.norm_vars)
        # per-utterance VTLN: quantized warp bank of mel matrices + utt→index
        self.warp_bank = None
        self.utt_warp_id = None
        if cfg.utt2warp:
            from pykaldi2_tpu_torch.frontend.mel import mel_banks

            utt_warp = {}
            with open(cfg.utt2warp) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        utt_warp[parts[0]] = float(parts[1])
            mel_opts = cfg.fbank.mel_opts if cfg.type == "fbank" else cfg.mfcc.mel_opts
            fopts = cfg.fbank.frame_opts if cfg.type == "fbank" else cfg.mfcc.frame_opts
            warps = sorted(set(utt_warp.values()))
            self.warp_values = warps
            self.warp_bank = np.stack(
                [mel_banks(mel_opts, fopts, warp=w) for w in warps]).astype(np.float32)
            index = {w: i for i, w in enumerate(warps)}
            self.utt_warp_id = {u: index[w] for u, w in utt_warp.items()}
            # padding rows / unlisted utts fall back to the most neutral warp
            self._neutral_warp = int(np.argmin(np.abs(np.asarray(warps) - 1.0)))
        self.dim = feature_dim(cfg)

    @property
    def has_extras(self) -> bool:
        """True when batches need per-row extras (speaker CMVN / VTLN)."""
        return self.speaker_cmvn is not None or self.warp_bank is not None

    def batch_extras(self, utt_ids, n_samples=None) -> dict:
        """Host-side per-row arrays for a batch (loaders attach these;
        ``n_samples`` is the batch's waveform length, used by other extras
        providers like DeviceSimulator and ignored here).

        An empty utt_id marks a padding row (masked downstream) and gets
        neutral values; a real utterance missing from the tables raises,
        matching Kaldi's apply-cmvn strictness.
        """
        out = {}
        if self.speaker_cmvn is not None:
            d = self.speaker_cmvn.dim
            rows = [(np.zeros(d, np.float32), np.ones(d, np.float32)) if not u
                    else self.speaker_cmvn.lookup(u) for u in utt_ids]
            out["cmvn_mean"] = np.stack([m for m, _ in rows]).astype(np.float32)
            out["cmvn_scale"] = np.stack([s for _, s in rows]).astype(np.float32)
        if self.warp_bank is not None:
            out["warp_id"] = np.asarray(
                [self.utt_warp_id.get(u, self._neutral_warp) for u in utt_ids], np.int32)
        return out

    def for_eval(self) -> "FeaturePipeline":
        """Deterministic copy for eval paths: dither and simulation off."""
        out = copy.copy(self)  # shallow: shares stats, swaps config
        out.cfg = copy.deepcopy(self.cfg)
        out.cfg.fbank.frame_opts.dither = 0.0
        out.cfg.mfcc.frame_opts.dither = 0.0
        out.device_sim_cfg = None  # never simulate at eval
        return out

    def _use_fused(self) -> bool:
        """K1 covers the standard log-power fbank with dither 0 and no energy
        (the conditions of the reference's _use_fused, pipeline.py:185-194)."""
        fb = self.cfg.fbank
        return (fb.frame_opts.dither == 0.0 and not fb.use_energy
                and fb.use_log_fbank and fb.use_power)

    def _use_fused_mfcc(self) -> bool:
        """K4 takes MFCC with dither 0, unless the energy is the windowed one
        (use_energy without raw_energy): the reference's _use_fused_mfcc,
        pipeline.py:196-202."""
        mf = self.cfg.mfcc
        return mf.frame_opts.dither == 0.0 and not (mf.use_energy and not mf.raw_energy)

    def _simulate_on_device(self, batch: dict, generator: torch.Generator) -> torch.Tensor:
        """The on-device reverb/noise/gain stage (reference:
        pipeline.py:204-230): draws from ``generator``, then applies."""
        sim = self.device_sim_cfg
        wave = batch["wave"]
        sample_mask = None
        mask = batch.get("mask")
        if mask is not None:
            # approximate per-sample validity from the frame mask so padded
            # rows don't skew the SNR's speech-power estimate
            fo = (self.cfg.fbank.frame_opts if self.cfg.type == "fbank"
                  else self.cfg.mfcc.frame_opts)
            sm = torch.repeat_interleave(mask.to(torch.float32), fo.window_shift, dim=-1)
            s = wave.shape[-1]
            if sm.shape[-1] < s:
                sm = torch.nn.functional.pad(sm, (0, s - sm.shape[-1]))
            sample_mask = sm[..., :s]
        reverb_gate, snr, noise_gate, gain = draw_simulation(generator, wave.shape[0], sim)
        return apply_simulation(
            wave, batch.get("sim_rir") if sim.reverb.use_reverb else None,
            batch.get("sim_noise") if sim.noise.use_noise else None,
            reverb_gate, snr, noise_gate, gain, sample_mask)

    def __call__(self, batch: dict, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Simulation (training only: with a generator and device_sim_cfg)
        draws from ``generator`` first, then the dither."""
        cfg = self.cfg
        if self.device_sim_cfg is not None and generator is not None and "wave" in batch:
            batch = dict(batch)
            batch["wave"] = self._simulate_on_device(batch, generator)
        warp_sel = batch.get("warp_id") if self.warp_bank is not None else None
        if "feats" in batch:
            feats = batch["feats"].to(torch.float32)
        elif cfg.type == "fbank":
            wave = batch["wave"]
            if warp_sel is not None:
                feats = compute_fbank(wave, cfg.fbank, generator=generator,
                                      mel_weights=torch.as_tensor(self.warp_bank),
                                      warp_select=warp_sel.long())
            elif self._use_fused():
                feats = fused_fbank(wave, cfg.fbank)
            else:
                # dithered (or non-standard) fbank: the plain torch front end,
                # as the reference sends dithered batches to XLA — the
                # kernel draws no random numbers
                feats = compute_fbank(wave, cfg.fbank, generator=generator)
        elif warp_sel is not None:
            feats = compute_mfcc(batch["wave"], cfg.mfcc, generator=generator,
                                 mel_weights=torch.as_tensor(self.warp_bank),
                                 warp_select=warp_sel.long())
        elif self._use_fused_mfcc():
            feats = fused_mfcc(batch["wave"], cfg.mfcc)
        else:
            feats = compute_mfcc(batch["wave"], cfg.mfcc, generator=generator)
        mask = batch.get("mask")
        if "cmvn_mean" in batch:
            # per-speaker CMVN rows (SpeakerCmvn via batch_extras)
            feats = apply_cmvn(feats, batch["cmvn_mean"][:, None, :],
                               batch["cmvn_scale"][:, None, :], cfg.cmvn.norm_means)
        elif self.mean is not None:
            if self._cmvn_on is None or self._cmvn_on[0] != feats.device:
                self._cmvn_on = (feats.device,
                                 *(torch.as_tensor(a, dtype=torch.float32, device=feats.device)
                                   for a in (self.mean, self.scale)))
            feats = apply_cmvn(feats, self._cmvn_on[1], self._cmvn_on[2], cfg.cmvn.norm_means)
        elif cfg.cmvn.norm_means:
            feats = utterance_cmvn(feats, cfg.cmvn.norm_vars, mask=mask)
        if cfg.delta_order > 0:
            feats = add_deltas(feats, cfg.delta_order, cfg.delta_window)
        if cfg.splice_left or cfg.splice_right:
            feats = splice_frames(feats, cfg.splice_left, cfg.splice_right)
        return feats


def compose_extras(*fns):
    """Merge several ``(utt_ids, n_samples) → dict`` extras providers into
    one loader hook (FeaturePipeline.batch_extras, DeviceSimulator); None
    entries are skipped; returns None when nothing remains."""
    fns = [f for f in fns if f is not None]
    if not fns:
        return None

    def extras(utt_ids, n_samples=None):
        out = {}
        for f in fns:
            out.update(f(utt_ids, n_samples))
        return out

    return extras


def build_frontend(data_cfg):
    """(dataset, feat_fn, extras_fn) for the trainers, honoring on-device
    simulation: with simulation.on_device, reverb/noise/gain move into the
    train step (DeviceSimulator samples the tensors on the host;
    FeaturePipeline applies them on the device) and the host keeps only
    duration-changing speed perturbation.

    Note: -on_the_fly SE decodes denominator lattices from the undistorted
    forward (eval pipeline) while training applies the distortion — prefer
    host-side simulation (on_device: false) for that mode so lattices and
    gradients see the same audio."""
    from pykaldi2_tpu_torch.data.dataset import SpeechDataset

    sim = data_cfg.simulation
    dev_sim = None
    dev_cfg = None
    dcfg = data_cfg
    if sim.enabled and sim.on_device:
        if not (data_cfg.wav_scp or (data_cfg.hdf5 and data_cfg.hdf5_kind == "wave")):
            raise ValueError(
                "simulation.on_device needs a waveform corpus (wav_scp or "
                "hdf5 kind=wave); feats-mode corpora would silently skip "
                "the distortion stage")
        dcfg = copy.deepcopy(data_cfg)
        host = dcfg.simulation
        host.reverb.use_reverb = False
        host.noise.use_noise = False
        host.perturb.use_gain = False
        host.enabled = host.perturb.use_speed
        fo = (data_cfg.feat.fbank.frame_opts if data_cfg.feat.type == "fbank"
              else data_cfg.feat.mfcc.frame_opts)
        dev_sim = DeviceSimulator(sim, samp_freq=fo.samp_freq, frame_shift=fo.window_shift)
        dev_cfg = sim
    dataset = SpeechDataset.from_config(dcfg)
    feat_fn = FeaturePipeline(data_cfg.feat, device_sim_cfg=dev_cfg)
    extras_fn = compose_extras(
        feat_fn.batch_extras if feat_fn.has_extras else None,
        dev_sim.batch_extras if dev_sim is not None else None)
    return dataset, feat_fn, extras_fn
