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
from contextlib import nullcontext
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from pykaldi2_tpu_torch.config import load_config, load_data_config
from pykaldi2_tpu_torch.data.dataloader import BucketSpec, SeqDataloader
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.data.prefetch import device_batches, device_prefetch
from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder
from pykaldi2_tpu_torch.decode.wer import score_corpus
from pykaldi2_tpu_torch.device import resolve_device
from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.utils import load_checkpoint, setup_logging

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
    """forward(batch of device tensors) → fp32 [B, T, P] on the device:
    acoustic_scale · (log_softmax(logits) − log_prior)."""
    lp = None if log_prior is None else torch.as_tensor(log_prior, dtype=torch.float32,
                                                        device=dev)

    @torch.no_grad()
    def forward(batch: dict) -> np.ndarray:
        logits = model(feat_fn(batch), batch["mask"])
        logpost = torch.log_softmax(logits.to(torch.float32), dim=-1)
        if lp is not None:
            logpost = logpost - lp
        return acoustic_scale * logpost

    return forward


class PdfColumns:
    """Host copy of some pdf columns of one utterance's scaled
    log-likelihoods, indexed as the full [T, P] matrix is by the lattice
    scoring (``loglikes[frames, pdfs]``)."""

    def __init__(self, cols: np.ndarray, remap: np.ndarray):
        self.cols, self.remap = cols, remap

    def __getitem__(self, key):
        rows, pdfs = key
        return self.cols[rows, self.remap[pdfs]]


def graph_pdf_columns(fst: Fst, num_outputs: int):
    """(the graph's pdf ids as a device index, pdf → column map)."""
    pdfs = sorted({a.ilabel - 1 for arcs in fst.arcs for a in arcs if a.ilabel > 0})
    remap = np.zeros(num_outputs, np.int64)
    remap[pdfs] = np.arange(len(pdfs))
    return np.asarray(pdfs, np.int64), remap


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
                   help="exact batched Viterbi decoding on the accelerator "
                        "(no host beam search); best for small/medium graphs")
    p.add_argument("-decoder", choices=("host", "device"), default="host",
                   help="'device' runs the batched beam-pruned lattice search on "
                        "the accelerator (decode/device_lattice) and converts the "
                        "banded lattices for scoring; all lattice modes work. Set "
                        "-max_active to the frontier size (e.g. 200-2000, not the "
                        "host default 7000: it shapes the dense per-frame band)")
    p.add_argument("-max_arcs", type=int, default=1024,
                   help="device decoder: lattice links kept per frame (band cap; "
                        "overflow drops the worst links and warns)")
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
    if args.ctm_out:
        args.mbr = True
    sweep_scales = sweep_scales_of(args.lm_scale_sweep)
    if sweep_scales and not args.ref:
        raise SystemExit("-lm_scale_sweep needs -ref to score")
    lattice_mode = bool(args.lattice_out or args.nbest or args.oracle
                        or args.mbr or sweep_scales)
    if lattice_mode and args.on_device:
        raise SystemExit("-lattice_out/-nbest/-oracle/-mbr need a lattice "
                         "decoder; drop -on_device (or use -decoder device)")
    if args.on_device and args.decoder == "device":
        raise SystemExit("-on_device (exact Viterbi) and -decoder device "
                         "(beam-pruned lattice search) are different "
                         "accelerator paths; pick one")
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
    dense_packed = dev_graph = None
    decoders = []
    if args.decoder == "device":
        from pykaldi2_tpu_torch.decode.device_lattice import DeviceSearch, pack_decode_graph

        fstg = graph.to_fst() if hasattr(graph, "to_fst") else graph
        if not isinstance(fstg, Fst):
            raise SystemExit("-decoder device needs an Fst-convertible "
                             "graph (text / .npz / OpenFst binary)")
        try:
            # in-frame eps closure where the eps subgraph qualifies (backoff
            # word-LM graphs: no offline-fold arc blowup), else the fold
            dev_graph = pack_decode_graph(fstg, word_penalty=args.word_penalty,
                                          eps_mode="auto")
        except ValueError as e:
            raise SystemExit(f"-decoder device cannot run this graph: {e}")
        if not dev_graph.has_olabels:
            raise SystemExit("-decoder device needs word output labels on "
                             "the decode graph")
        log.info("device decoding: %d states, buckets [%d x %d | %d x %d]",
                 dev_graph.num_states, dev_graph.s_lo, dev_graph.d_lo,
                 dev_graph.num_states - dev_graph.s_lo, dev_graph.d_hi)
        device_search = DeviceSearch(dev_graph.to(dev))
        used_pdfs, pdf_remap = graph_pdf_columns(fstg, cfg.model.output_size)
        used_pdfs = torch.as_tensor(used_pdfs, device=dev)
    if args.on_device:
        if not isinstance(graph, Fst):
            raise SystemExit("-on_device needs a fully-emitting text graph "
                             "(eps-free); npz HCLG graphs are host-decoder only")
        from pykaldi2_tpu_torch.decode.on_device import dense_from_pdf_fst
        from pykaldi2_tpu_torch.ops.fb import pack_graph

        dense_packed = pack_graph(dense_from_pdf_fst(graph, word_penalty=args.word_penalty))
        log.info("on-device decoding: %d states, %d arcs",
                 dense_packed.num_states, int(dense_packed.src.shape[0]))
        dense_packed = dense_packed.to(dev)
    elif dev_graph is None:
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

    def decode_one(uid: str, dec: Optional[LatticeDecoder], ll, pre):
        """(uid, hypothesis words) of one utterance, or (uid, None) when it
        fails. ``ll``: its scaled log-likelihoods (host [T, P], or the
        device route's ``PdfColumns``); ``pre``: the device lattice as
        (DenseFsa, frames), else the host decoder ``dec`` decodes ``ll``."""
        from pykaldi2_tpu_torch.decode.lattice import (best_path, frame_lattice_best_path,
                                                       lattice_word_fst)

        try:
            if not lattice_mode:
                if pre is None:
                    words, _pdfs, _score = dec.decode(ll)
                else:  # the device lattice's best path, without the word acceptor
                    words, _score = frame_lattice_best_path(pre[0], pre[1], ll)
                return uid, [id2w.get(w, f"<{w}>") for w in words]
            if pre is not None:
                lat, frames = pre
            else:
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

    def host_side(pool, utt_ids, lls, pre=None, only=None):
        """Decode (or, with device lattices ``pre``, score) the batch's
        utterances on ``n_threads`` threads; ``only`` restricts it to a
        subset of utt_ids without touching results already recorded."""
        jobs = [(uid, decoders[i % n_threads] if decoders else None, lls[i],
                 None if pre is None else pre[i])
                for i, uid in enumerate(utt_ids) if only is None or uid in only]

        # shard jobs so each decoder handle is used by exactly one thread
        def run_shard(t):
            return [decode_one(*job) for job in jobs[t::n_threads]]

        for shard in pool.map(run_shard, range(n_threads)):
            for uid, words in shard:
                if words is not None:
                    hyps[uid] = words

    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def search(obs, nf_dev, lattice_beam):
        lat, _scores, dropped, olab = device_search(
            obs, nf_dev, max_active=args.max_active, max_arcs=args.max_arcs,
            beam=args.beam, lattice_beam=lattice_beam, return_olabels=True)
        done = None
        if copy_stream is not None:
            done = torch.cuda.Event()
            done.record()
        return lat, dropped, olab, done

    def convert(item):
        """Device lattices of one batch → per-utterance (DenseFsa, frames)
        and the log-likelihood rows the scoring reads; on a side stream that
        waits only for this batch's search, so the card searches the next
        batch meanwhile."""
        from pykaldi2_tpu_torch.decode.device_lattice import banded_to_fsas

        utt_ids, obs, obs_np, nf, (lat, dropped, olab, done) = item
        with torch.cuda.stream(copy_stream) if copy_stream is not None else nullcontext():
            if done is not None:
                copy_stream.wait_event(done)
            n_drop = int(dropped.sum())
            if n_drop:
                log.warning("device search dropped %d lattice links to the band cap; "
                            "raise -max_arcs", n_drop)
            framed = banded_to_fsas(lat, nf, olabels=olab)
            if obs_np is not None:
                lls = [obs_np[i, : nf[i]] for i in range(len(utt_ids))]
            else:
                cols = obs.index_select(2, used_pdfs).cpu().numpy()
                lls = [PdfColumns(cols[i, : nf[i]], pdf_remap) for i in range(len(utt_ids))]
        return framed, lls

    def run_batch(pool, item):
        """Score one device-searched batch, then search ONE more time, at
        min(2·lattice_beam, beam), the utterances whose pruned lattice kept
        no complete path (the per-frame lattice beam can prune the best path
        when max_active is narrower than the lattice-beam token set)."""
        utt_ids, obs, obs_np, nf, _dev_out = item
        framed, lls = convert(item)
        host_side(pool, utt_ids, lls, pre=framed)
        failed = {u for u in utt_ids if u not in hyps}
        lb2 = min(args.lattice_beam * 2.0, args.beam)
        if not failed or lb2 <= args.lattice_beam:
            return
        log.warning("%d utterance(s) had no complete lattice path at "
                    "lattice_beam %.1f; retrying on device at %.1f",
                    len(failed), args.lattice_beam, lb2)
        retry = (utt_ids, obs, obs_np, nf,
                 search(obs, torch.as_tensor(nf, device=dev), lb2))
        framed, lls = convert(retry)
        host_side(pool, utt_ids, lls, pre=framed, only=failed)

    pending = None
    with ThreadPoolExecutor(max_workers=n_threads) as pool:
        # the device search captures CUDA graphs: no loader thread may issue
        # CUDA work meanwhile
        batches = (device_batches if dev_graph is not None else device_prefetch)(loader, dev)
        for batch in batches:
            utt_ids = batch.pop("utt_ids")
            nf = batch["num_frames"].cpu().numpy()
            obs = forward(batch)
            # the host decoder reads host rows; the device routes copy whole
            # matrices only for -dump_ark
            obs_np = obs.cpu().numpy() if (dump is not None or not (
                dense_packed is not None or dev_graph is not None)) else None
            if dump is not None:
                for i, uid in enumerate(utt_ids):
                    dump.write(uid, obs_np[i, : nf[i]])
            if dense_packed is not None:
                from pykaldi2_tpu_torch.decode.on_device import viterbi_decode_words

                words_b, _pdfs, _scores = viterbi_decode_words(obs, dense_packed,
                                                               batch["num_frames"])
                for uid, ws in zip(utt_ids, words_b):
                    hyps[uid] = [id2w.get(w, f"<{w}>") for w in ws]
            elif dev_graph is not None:
                item = (utt_ids, obs, obs_np, nf,
                        search(obs, batch["num_frames"], args.lattice_beam))
                if pending is not None:  # the card searches this batch meanwhile
                    run_batch(pool, pending)
                pending = item
            else:
                host_side(pool, utt_ids, [obs_np[i, : nf[i]] for i in range(len(utt_ids))])
        if pending is not None:
            run_batch(pool, pending)
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
