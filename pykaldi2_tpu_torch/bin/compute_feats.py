"""Dump base features for a corpus to a Kaldi ark(+scp), PyTorch port.

Same CLI as pykaldi2_tpu/bin/compute_feats.py (reference behavior:
``compute-fbank-feats`` / ``compute-mfcc-feats`` as driven by recipe
data-prep scripts):

    python -m pykaldi2_tpu_torch.bin.compute_feats -data data.yaml -out feats.ark
        [-dither D] [-seed N] [-compress]

Raw per-utterance feature matrices, before CMVN, deltas and splicing (the
training pipeline applies those on top of ``feats`` batches), through
``FeaturePipeline``: K1 for the standard fbank, K4 for MFCC, the plain torch
front end for dithered batches (dither draws from a ``torch.Generator``
seeded with ``-seed``). As in the reference, each waveform is zero-padded
to a power-of-two length and the frames of the padding are sliced off
(frame t reads only samples inside its window). Runs on one CUDA device
unless ``PK2_PLATFORM=cpu`` (or ``main(..., device="cpu")``) asks for the
CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.bin.compute_cmvn_stats import base_features, utterance_batch
from pykaldi2_tpu_torch.config import load_data_config
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.device import resolve_device
from pykaldi2_tpu_torch.utils import setup_logging


def main(argv=None, device: Optional[str] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-data", required=True, help="corpus YAML (wav_scp + feat config)")
    p.add_argument("-out", required=True,
                   help="output ark path; an .scp index is written next to it")
    p.add_argument("-dither", type=float, default=None,
                   help="override frame dither (default: config value; Kaldi recipes "
                        "usually keep dither for training features and disable it "
                        "for parity checks)")
    p.add_argument("-seed", type=int, default=0, help="dither generator seed")
    p.add_argument("-compress", action="store_true",
                   help="write Kaldi CompressedMatrix records (the --compress=true "
                        "default of Kaldi feature pipelines: percentile-coded CM, "
                        "~4x smaller arks)")
    args = p.parse_args(argv)
    log = setup_logging(None)
    dev = resolve_device(device)

    cfg = load_data_config(args.data)
    if args.dither is not None:
        cfg.feat.fbank.frame_opts.dither = args.dither
        cfg.feat.mfcc.frame_opts.dither = args.dither
    ds = SpeechDataset.from_config(cfg)
    if ds.mode != "wave":
        raise SystemExit("compute_feats needs a waveform corpus (wav_scp)")
    pipe = base_features(cfg.feat)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    scp = args.out[:-4] + ".scp" if args.out.endswith(".ark") else args.out + ".scp"
    n = 0
    with kaldi_io.ArkWriter(args.out, scp, kind="cmat" if args.compress else "mat") as w:
        for uid in ds.utt_ids:
            utt = ds.get(uid)
            nf = utt.num_frames
            if nf <= 0:
                log.warning("skipping empty utterance %s", uid)
                continue
            wave = np.zeros(1 << int(np.ceil(np.log2(max(len(utt.wave), 2)))), np.float32)
            wave[: len(utt.wave)] = utt.wave
            with torch.no_grad():
                feats = pipe(utterance_batch(pipe, uid, wave, dev), gen)[0, :nf]
            w.write(uid, feats.cpu().numpy().astype(np.float32))
            n += 1
    log.info("wrote %d feature matrices (%d-dim %s) to %s (+.scp)",
             n, pipe.dim, cfg.feat.type, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
