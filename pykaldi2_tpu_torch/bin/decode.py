"""Decode/eval entry point (PyTorch port): posteriors → beam decode → WER.

Same CLI as pykaldi2_tpu/bin/decode.py with the host decoder (reference
behavior: pykaldi2's decode/forward scripts + Kaldi latgen-faster-mapped /
compute-wer):

    python -m pykaldi2_tpu_torch.bin.decode -config exp.yaml -data data.yaml \\
        -model exp/ce/model.7.npz -graph graph.fst.txt -words words.txt \\
        [-ref ref.txt] [-hyp_out hyp.txt] [-acoustic_scale 0.1] [-prior prior.npy]

The forward runs batched on one CUDA device (front end through K1 or K4, the
LSTM through K2; fp32 log-softmax, minus the log-prior, times the acoustic
scale) unless ``PK2_PLATFORM=cpu`` (or ``main(..., device="cpu")``) asks for
the CPU. Each batch's [B, T, P] scaled log-likelihoods then go to the host,
where ``-num_threads`` native decoder handles (native/latdec.cc), one per
thread, decode its utterances; the lattice modes (``-lattice_out``,
``-nbest``, ``-oracle``, ``-mbr``/``-ctm_out``, ``-lm_scale_sweep``) score
the decoded lattices on the host. Checkpoints of either package load. The
accelerator decoders (``-decoder device``, ``-on_device``) come with a later
slice and raise.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.config import load_config, load_data_config
from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.data.prefetch import device_prefetch
from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder
from pykaldi2_tpu_torch.decode.wer import score_corpus
from pykaldi2_tpu_torch.device import resolve_device
from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.utils import load_checkpoint, setup_logging

UNPORTED = ("comes with the device decoder (ROADMAP.md Queue 1 item 17); "
            "use -decoder host")


def read_symtab(path: str):
    """OpenFst-style symbol table: 'word id' per line."""
    id2w = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                id2w[int(parts[1])] = parts[0]
    return id2w


def load_graph(path: str):
    """.npz → VectorFst, OpenFst binary → Fst, anything else → text Fst."""
    if path.endswith(".npz"):
        from pykaldi2_tpu_torch.graph.vfst import VectorFst

        return VectorFst.load(path)
    with open(path, "rb") as gf:
        magic = gf.read(4)
    if magic == b"\xd6\xfd\xb2\x7e":  # OpenFst binary magic (LE 2125659606)
        from pykaldi2_tpu_torch.graph.openfst_io import read_openfst

        return read_openfst(path)
    return Fst.read_text(path)


def make_forward(model, feat_fn: FeaturePipeline, log_prior: Optional[np.ndarray],
                 acoustic_scale: float, dev: torch.device):
    """forward(batch of device tensors) → host fp32 [B, T, P]:
    acoustic_scale · (log_softmax(logits) − log_prior)."""
    lp = None if log_prior is None else torch.as_tensor(log_prior, dtype=torch.float32,
                                                        device=dev)

    @torch.no_grad()
    def forward(batch: dict) -> np.ndarray:
        logits = model(feat_fn(batch), batch["mask"])
        logpost = torch.log_softmax(logits.to(torch.float32), dim=-1)
        if lp is not None:
            logpost = logpost - lp
        return (acoustic_scale * logpost).cpu().numpy()

    return forward


def build_argparser():
    p = argparse.ArgumentParser(description="decode + WER")
    p.add_argument("-config", required=True)
    p.add_argument("-data", required=True)
    p.add_argument("-model", required=True)
    p.add_argument("-graph", required=True, help="pdf-level decode FST (text format)")
    p.add_argument("-words", required=True, help="word symbol table")
    p.add_argument("-ref", default=None, help="reference transcripts (utt words...)")
    p.add_argument("-hyp_out", default=None)
    p.add_argument("-acoustic_scale", type=float, default=0.1)
    p.add_argument("-prior", default=None, help="log-prior .npy")
    p.add_argument("-beam", type=float, default=16.0)
    p.add_argument("-word_penalty", type=float, default=0.0)
    p.add_argument("-max_active", type=int, default=7000)
    p.add_argument("-on_device", action="store_true",
                   help="exact batched Viterbi decoding on the accelerator (not "
                        "ported yet: ROADMAP.md Queue 1 item 17)")
    p.add_argument("-decoder", choices=("host", "device"), default="host",
                   help="'device' (the batched lattice search on the accelerator) "
                        "is not ported yet: ROADMAP.md Queue 1 item 17")
    p.add_argument("-num_threads", type=int, default=4,
                   help="parallel host decoding threads (ctypes releases the "
                        "GIL during the C++ search)")
    p.add_argument("-dump_ark", default=None,
                   help="also dump scaled pseudo-log-likelihood matrices to this "
                        "ark (+.scp) for external/Kaldi decoders")
    p.add_argument("-compress", action="store_true",
                   help="compress -dump_ark records (Kaldi CompressedMatrix)")
    p.add_argument("-lattice_beam", type=float, default=8.0,
                   help="lattice pruning beam (lattice modes only)")
    p.add_argument("-lattice_out", default=None,
                   help="write word lattices (Kaldi CompactLattice text archive, "
                        "or binary when the path ends in .ark) to this path")
    p.add_argument("-nbest", type=int, default=0,
                   help="emit the N best unique word sequences per utterance")
    p.add_argument("-nbest_out", default=None,
                   help="N-best output path (default: stdout); lines are "
                        "'utt-N score word...'")
    p.add_argument("-oracle", action="store_true",
                   help="also report lattice oracle WER vs -ref (Kaldi lattice-oracle)")
    p.add_argument("-mbr", action="store_true",
                   help="consensus (Minimum-Bayes-Risk) decoding: hypotheses come "
                        "from the lattice sausage argmax instead of the best path "
                        "(Kaldi lattice-mbr-decode)")
    p.add_argument("-ctm_out", default=None,
                   help="write a CTM with per-word times + MBR confidences "
                        "(Kaldi lattice-to-ctm-conf); implies -mbr")
    p.add_argument("-frame_shift", type=float, default=0.01,
                   help="seconds per frame for -ctm_out times")
    p.add_argument("-lm_scale_sweep", default=None,
                   help="'lo:hi[:step]' — score the lattices at each LM (graph) "
                        "scale and report WER per scale + the best (Kaldi "
                        "scoring-script lmwt sweep); needs -ref")
    return p


def sweep_scales_of(spec: Optional[str]) -> list:
    if not spec:
        return []
    parts = [float(x) for x in spec.split(":")]
    lo, hi = parts[0], parts[1]
    step_sz = parts[2] if len(parts) > 2 else 1.0
    scales, s = [], lo
    while s <= hi + 1e-9:
        scales.append(round(s, 6))
        s += step_sz
    return scales


def main(argv=None, device: Optional[str] = None):
    args = build_argparser().parse_args(argv)
    if args.decoder == "device":
        raise NotImplementedError(f"-decoder device {UNPORTED}")
    if args.on_device:
        raise NotImplementedError(f"-on_device {UNPORTED}")
    if args.ctm_out:
        args.mbr = True
    sweep_scales = sweep_scales_of(args.lm_scale_sweep)
    if sweep_scales and not args.ref:
        raise SystemExit("-lm_scale_sweep needs -ref to score")
    if args.oracle and not args.ref:
        raise SystemExit("-oracle needs -ref")
    dev = resolve_device(device)

    log = setup_logging(None)
    cfg = load_config(args.config)
    cfg.data = load_data_config(args.data)
    dataset = SpeechDataset.from_config(cfg.data)
    feat_fn = FeaturePipeline(cfg.data.feat).for_eval()
    cfg.model.input_size = feat_fn.dim
    model = build_model(cfg.model).to(dev)
    load_checkpoint(args.model, model)
    model.eval()
    log_prior = np.load(args.prior) if args.prior else None
    forward = make_forward(model, feat_fn, log_prior, args.acoustic_scale, dev)

    graph = load_graph(args.graph)
    n_threads = max(args.num_threads, 1)
    lattice_mode = bool(args.lattice_out or args.nbest or args.oracle
                        or args.mbr or sweep_scales)
    # decoder handles are stateful — one per thread
    decoders = [LatticeDecoder(graph, beam=args.beam, max_active=args.max_active,
                               lattice_beam=args.lattice_beam,
                               word_penalty=args.word_penalty)
                for _ in range(n_threads)]
    id2w = read_symtab(args.words)

    hyps = {}
    word_fsts = {}
    mbr_results = {}
    sweep_hyps = {}
    dump = None
    if args.dump_ark:
        from pykaldi2_tpu_torch.data.kaldi_io import ArkWriter

        dump = ArkWriter(args.dump_ark, args.dump_ark + ".scp",
                         kind="cmat" if args.compress else "mat")
    loader = SeqDataloader(dataset, BucketSpec(boundaries=(200, 400, 800, 1600, 3200),
                                               batch_sizes=8), shuffle=False,
                           extras_fn=(feat_fn.batch_extras
                                      if feat_fn.has_extras else None))

    def decode_one(i: int, uid: str, dec: LatticeDecoder, obs: np.ndarray, nf: np.ndarray):
        """(uid, hypothesis words) of row i, or (uid, None) when it fails."""
        from pykaldi2_tpu_torch.decode.lattice import best_path, lattice_word_fst

        ll = obs[i, : nf[i]]
        try:
            if not lattice_mode:
                words, _pdfs, _score = dec.decode(ll)
                return uid, [id2w.get(w, f"<{w}>") for w in words]
            lat, frames, _sc = dec.decode_lattice(ll, with_frames=True)
            wf = None
            if args.lattice_out or args.nbest or args.oracle or not args.mbr:
                wf = lattice_word_fst(lat, loglikes=ll, frames=frames, acoustic_scale=1.0)
                if args.lattice_out or args.nbest or args.oracle:
                    word_fsts[uid] = wf
            if sweep_scales:
                per_scale = {}
                for s in sweep_scales:
                    wf_s = lattice_word_fst(lat, loglikes=ll, frames=frames,
                                            acoustic_scale=1.0, graph_scale=s)
                    ws, _ = best_path(wf_s)
                    per_scale[s] = [id2w.get(w, f"<{w}>") for w in ws]
                sweep_hyps[uid] = per_scale
            if args.mbr:
                from pykaldi2_tpu_torch.decode.mbr import lattice_word_fst_timed, mbr_decode

                twf, ttimes = lattice_word_fst_timed(lat, loglikes=ll, frames=frames,
                                                     acoustic_scale=1.0)
                res = mbr_decode(twf, arc_times=ttimes)
                mbr_results[uid] = res
                words = res.words
            else:
                words, _ = best_path(wf)
            return uid, [id2w.get(w, f"<{w}>") for w in words]
        except (RuntimeError, ValueError) as e:
            log.warning("decode failed for %s: %s", uid, e)
            return uid, None

    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        for batch in device_prefetch(loader, dev):
            utt_ids = batch.pop("utt_ids")
            nf = batch["num_frames"].cpu().numpy()
            obs = forward(batch)
            if dump is not None:
                for i, uid in enumerate(utt_ids):
                    dump.write(uid, obs[i, : nf[i]])
            jobs = [(i, uid, decoders[i % n_threads]) for i, uid in enumerate(utt_ids)]

            # shard jobs so each decoder handle is used by exactly one thread
            def run_shard(t):
                return [decode_one(i, uid, dec, obs, nf) for i, uid, dec in jobs[t::n_threads]]

            for shard in pool.map(run_shard, range(n_threads)):
                for uid, words in shard:
                    if words is not None:
                        hyps[uid] = words
    if dump is not None:
        dump.close()
    if args.ctm_out:
        from pykaldi2_tpu_torch.decode.mbr import write_ctm

        with open(args.ctm_out, "w") as f:
            for uid in sorted(mbr_results):
                write_ctm(f, uid, mbr_results[uid], frame_shift=args.frame_shift, id2w=id2w)
        log.info("wrote CTM for %d utterances to %s", len(mbr_results), args.ctm_out)
    if args.hyp_out:
        with open(args.hyp_out, "w") as f:
            for uid in sorted(hyps):
                f.write(uid + " " + " ".join(hyps[uid]) + "\n")
    if args.lattice_out:
        if args.lattice_out.endswith(".ark"):
            from pykaldi2_tpu_torch.decode.lattice_ark import write_lattice_ark

            write_lattice_ark(args.lattice_out, word_fsts)
        else:
            from pykaldi2_tpu_torch.decode.lattice import write_lattices_text

            write_lattices_text(args.lattice_out, word_fsts)
        log.info("wrote %d word lattices to %s", len(word_fsts), args.lattice_out)
    if args.nbest:
        from pykaldi2_tpu_torch.decode.lattice import nbest as lat_nbest

        nb_f = open(args.nbest_out, "w") if args.nbest_out else sys.stdout
        for uid in sorted(word_fsts):
            for k, (ws, score) in enumerate(lat_nbest(word_fsts[uid], args.nbest)):
                text = " ".join(id2w.get(w, f"<{w}>") for w in ws)
                nb_f.write(f"{uid}-{k + 1} {score:.4f} {text}\n")
        if args.nbest_out:
            nb_f.close()
    if args.ref:
        refs = {}
        with open(args.ref) as f:
            for line in f:
                parts = line.split()
                if parts:
                    refs[parts[0]] = parts[1:]
        result = score_corpus(refs, hyps)
        print(f"%WER {result['wer']:.2f} [ {result['errors']} / {result['ref_len']}, "
              f"{result['ins']} ins, {result['dels']} del, {result['subs']} sub ]")
        if args.oracle:
            from pykaldi2_tpu_torch.decode.lattice import oracle_errors

            w2id = {w: i for i, w in id2w.items()}
            o_err, o_len = 0, 0
            for uid, wf in word_fsts.items():
                if uid not in refs:
                    continue
                rids = [w2id.get(w, -1) for w in refs[uid]]
                o_err += oracle_errors(wf, rids)
                o_len += len(rids)
            if o_len:
                print(f"%Oracle WER {100.0 * o_err / o_len:.2f} [ {o_err} / {o_len} ]")
        if sweep_scales:
            # Kaldi scoring-script lmwt sweep: WER per LM scale, best last
            best = None
            for s in sweep_scales:
                hs = {u: per[s] for u, per in sweep_hyps.items()}
                r = score_corpus(refs, hs)
                print(f"lm_scale {s:g}: %WER {r['wer']:.2f} [ {r['errors']} / {r['ref_len']} ]")
                if best is None or r["wer"] < best[1]:
                    best = (s, r["wer"])
            print(f"best lm_scale {best[0]:g}: %WER {best[1]:.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
