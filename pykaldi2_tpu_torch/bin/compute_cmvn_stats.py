"""Accumulate CMVN stats over a corpus (compute-cmvn-stats equivalent), PyTorch port.

Same CLI as pykaldi2_tpu/bin/compute_cmvn_stats.py (reference behavior:
kaldi featbin/compute-cmvn-stats.cc driven by recipe scripts):

    python -m pykaldi2_tpu_torch.bin.compute_cmvn_stats -data data.yaml -output cmvn.mat
        [-spk2utt spk2utt]

Features are computed with the corpus's FeatConfig minus CMVN, deltas and
splicing (which come after), with dither off, one utterance at a time
through ``FeaturePipeline`` — so fbank goes through kernel K1 and MFCC
through K4, with per-utterance VTLN warps when configured. Global mode
writes one Kaldi binary [2, D+1] matrix; ``-spk2utt`` writes per-speaker
stats as an ark + scp. Runs on one CUDA device unless ``PK2_PLATFORM=cpu``
(or ``main(..., device="cpu")``) asks for the CPU.
"""

from __future__ import annotations

import argparse
import copy
from typing import Optional

import torch

from pykaldi2_tpu_torch.config import FeatConfig, load_data_config
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.device import resolve_device
from pykaldi2_tpu_torch.frontend.cmvn import acc_cmvn_stats
from pykaldi2_tpu_torch.pipeline import FeaturePipeline, save_cmvn_stats


def base_features(feat: FeatConfig) -> FeaturePipeline:
    """A pipeline for the base features: no CMVN, deltas or splicing."""
    cfg = copy.deepcopy(feat)
    cfg.cmvn.norm_means = False
    cfg.cmvn.stats_path = None
    cfg.cmvn.utt2spk = None
    cfg.cmvn.spk_stats_scp = None
    cfg.delta_order = 0
    cfg.splice_left = cfg.splice_right = 0
    return FeaturePipeline(cfg)


def utterance_batch(pipe: FeaturePipeline, uid: str, wave, dev: torch.device) -> dict:
    """One waveform as a [1, S] batch on ``dev``, with the pipeline's extras."""
    batch = {"wave": torch.from_numpy(wave[None]).to(dev)}
    if pipe.has_extras:
        batch.update({k: torch.from_numpy(v).to(dev)
                      for k, v in pipe.batch_extras([uid]).items()})
    return batch


def main(argv=None, device: Optional[str] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-data", required=True, help="corpus YAML (wav_scp/feats + feat config)")
    p.add_argument("-output", required=True, help="output stats file (Kaldi binary matrix)")
    p.add_argument("-spk2utt", default=None,
                   help="'spk utt1 utt2 ...' table → per-speaker stats ark+scp "
                        "at -output(.scp) instead of one global matrix "
                        "(compute-cmvn-stats --spk2utt semantics)")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    cfg = load_data_config(args.data)
    # stats are computed deterministically (dither off)
    cfg.feat.fbank.frame_opts.dither = 0.0
    cfg.feat.mfcc.frame_opts.dither = 0.0
    ds = SpeechDataset.from_config(cfg)
    pipe = base_features(cfg.feat) if ds.mode == "wave" else None

    def utt_feats(uid):
        utt = ds.get(uid)
        if ds.mode == "feats":
            return utt.feats
        with torch.no_grad():
            return pipe(utterance_batch(pipe, uid, utt.wave, dev))[0].cpu().numpy()

    if args.spk2utt:
        spk2utt = {}
        with open(args.spk2utt) as f:
            for line in f:
                parts = line.split()
                if parts:
                    spk2utt[parts[0]] = parts[1:]
        known = set(ds.utt_ids)
        n_spk = 0
        with kaldi_io.ArkWriter(args.output, args.output + ".scp", kind="mat") as w:
            for spk, utts in spk2utt.items():
                stats = None
                for uid in utts:
                    if uid in known:
                        stats = acc_cmvn_stats(utt_feats(uid), stats)
                if stats is not None:
                    w.write(spk, stats)
                    n_spk += 1
        print(f"wrote {args.output}(.scp): per-speaker stats for {n_spk} speakers")
        return 0

    stats = None
    for uid in ds.utt_ids:
        stats = acc_cmvn_stats(utt_feats(uid), stats)
    save_cmvn_stats(args.output, stats)
    d = stats.shape[1] - 1
    print(f"wrote {args.output}: {int(stats[0, d])} frames, dim {d}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
