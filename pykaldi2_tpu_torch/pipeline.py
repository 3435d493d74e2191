"""Feature pipeline on the device: waveform batch → normalized features.

Port of pykaldi2_tpu/pipeline.py:30-277 without on-device simulation. The
trainer calls it on the raw waveform batch already on the device, so
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

    def __init__(self, cfg: FeatConfig, cmvn_stats: Optional[np.ndarray] = None):
        self.cfg = cfg
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
        """Host-side per-row arrays for a batch (loaders attach these).

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
        """Deterministic copy for eval paths: dither off."""
        out = copy.copy(self)  # shallow: shares stats, swaps config
        out.cfg = copy.deepcopy(self.cfg)
        out.cfg.fbank.frame_opts.dither = 0.0
        out.cfg.mfcc.frame_opts.dither = 0.0
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

    def __call__(self, batch: dict, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        cfg = self.cfg
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


def build_frontend(data_cfg):
    """(dataset, feat_fn, extras_fn) for the trainer. On-device simulation is
    not ported yet and raises."""
    from pykaldi2_tpu_torch.data.dataset import SpeechDataset

    sim = data_cfg.simulation
    if sim.enabled and sim.on_device:
        raise NotImplementedError(
            "on-device simulation (simulation/device.py) is not ported yet; it "
            "comes with the simulation slice (ROADMAP.md Queue 1)")
    dataset = SpeechDataset.from_config(data_cfg)
    feat_fn = FeaturePipeline(data_cfg.feat)
    return dataset, feat_fn, feat_fn.batch_extras if feat_fn.has_extras else None
