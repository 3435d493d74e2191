"""Forced alignment (PyTorch port): Viterbi over per-utterance numerator graphs.

Same CLI as pykaldi2_tpu/bin/align.py (reference behavior: Kaldi's
align-mapped/gmm-align): given transcripts and a lexicon, it writes an
alignment ark of int32 pdf-ids, the labels train_ce/train_se consume
(run.sh stage 0).

    python -m pykaldi2_tpu_torch.bin.align -config exp.yaml -data data.yaml \\
        -model ckpt.npz -text text.txt -lexicon lexicon.txt -out ali.ark \\
        [-trans_model final.mdl] [-acoustic_scale 1.0] [-sil_phone N -sil_prob P]

lexicon.txt: "word phone1 phone2 ..." (phone ids, 1-based) per line;
text.txt: "utt_id word1 word2 ..." per line.

One utterance at a time on one CUDA device (the front end through K1 or K4,
the LSTM through K2 at B=1; fp32 log-softmax times the acoustic scale, then
``ops.fb.fsa_viterbi`` over the transcript's graph) unless ``PK2_PLATFORM=cpu``
(or ``main(..., device="cpu")``) asks for the CPU. Frames are padded to a
power-of-two bucket of at least 128, as the reference pads them; its padding
of the graph only bounded XLA recompiles and is left out (the alignments do
not change). An utterance whose best path is dead (score <= -1e29: the
transcript is too long for the audio) is skipped with a warning.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.config import load_config, load_data_config
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.device import resolve_device
from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel
from pykaldi2_tpu_torch.graph.compile import make_num_graph
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.ops.fb import fsa_viterbi, pack_graph
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.utils import load_checkpoint, setup_logging


def read_lexicon(path: str):
    lexicon, word_ids = {}, {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            word = parts[0]
            pron = [int(p) for p in parts[1:]]
            lexicon.setdefault(word, []).append(pron)
            if word not in word_ids:
                word_ids[word] = len(word_ids) + 1
    return lexicon, word_ids


def make_forward(model, feat_fn: FeaturePipeline, acoustic_scale: float):
    """forward(wave [1, N], mask [1, T]) → [1, T, P] on the device:
    acoustic_scale · log_softmax(logits)."""

    @torch.no_grad()
    def forward(wave: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        logits = model(feat_fn({"wave": wave, "mask": mask}), mask)
        return acoustic_scale * torch.log_softmax(logits.to(torch.float32), dim=-1)

    return forward


def bucket(n: int, lo: int = 64) -> int:
    while lo < n:
        lo *= 2
    return lo


def main(argv=None, device: Optional[str] = None):
    p = argparse.ArgumentParser()
    p.add_argument("-config", required=True)
    p.add_argument("-data", required=True)
    p.add_argument("-model", required=True)
    p.add_argument("-text", required=True)
    p.add_argument("-lexicon", required=True)
    p.add_argument("-out", required=True, help="output alignment ark (pdf-ids)")
    p.add_argument("-trans_model", default=None)
    p.add_argument("-acoustic_scale", type=float, default=1.0)
    p.add_argument("-sil_phone", type=int, default=0)
    p.add_argument("-sil_prob", type=float, default=0.0)
    args = p.parse_args(argv)
    dev = resolve_device(device)

    log = setup_logging(None)
    cfg = load_config(args.config)
    cfg.data = load_data_config(args.data)
    cfg.data.label_ark = None  # aligning: no labels yet
    dataset = SpeechDataset.from_config(cfg.data)
    feat_fn = FeaturePipeline(cfg.data.feat).for_eval()
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model).to(dev)
    load_checkpoint(args.model, model)
    model.eval()
    forward = make_forward(model, feat_fn, args.acoustic_scale)

    lexicon, word_ids = read_lexicon(args.lexicon)
    if args.trans_model:
        tm = TransitionModel.read_kaldi(args.trans_model)
    else:
        phones = sorted({ph for prons in lexicon.values() for pron in prons for ph in pron}
                        | ({args.sil_phone} if args.sil_phone else set()))
        tm = TransitionModel(HmmTopology.one_state(phones))

    texts = {}
    with open(args.text) as f:
        for line in f:
            parts = line.split()
            if parts:
                texts[parts[0]] = parts[1:]

    n_done = n_fail = 0
    with kaldi_io.ArkWriter(args.out, kind="ivec") as w:
        for uid in dataset.utt_ids:
            if uid not in texts:
                continue
            utt = dataset.get(uid)
            graph = make_num_graph(tm, texts[uid], lexicon, word_ids,
                                   args.sil_phone, args.sil_prob)
            t_pad = bucket(utt.num_frames, 128)
            wave_pad = np.zeros((1, (t_pad - 1) * dataset.frame_opts.window_shift
                                 + dataset.frame_opts.window_size), np.float32)
            wave_pad[0, : utt.wave.shape[0]] = utt.wave[: wave_pad.shape[1]]
            mask = np.zeros((1, t_pad), np.float32)
            mask[0, : utt.num_frames] = 1.0
            obs = forward(torch.from_numpy(wave_pad).to(dev), torch.from_numpy(mask).to(dev))
            score, arcs = fsa_viterbi(obs, pack_graph(graph).to(dev),
                                      torch.tensor([utt.num_frames], device=dev))
            # dead paths score ~NEG_INF (=-1e30, finite) and NaNs fail any
            # comparison — accept only clearly-live scores
            if not (float(score[0]) > -1e29):
                log.warning("alignment failed for %s (transcript too long for audio?)", uid)
                n_fail += 1
                continue
            pdfs = graph.pdf[arcs[0, : utt.num_frames].cpu().numpy()]
            w.write(uid, pdfs.astype(np.int32))
            n_done += 1
    log.info("aligned %d utterances (%d failed) → %s", n_done, n_fail, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
