"""Lattice archive tool (PyTorch port): best-path, N-best, oracle WER, LM
rescoring, posterior pruning, MBR/CTM.

Same CLI as pykaldi2_tpu/bin/lattice_tool.py, host-only. Bundles the Kaldi
lattice CLI slice the reference eval pipeline drives (SURVEY.md §3.2 "Kaldi
lattice functions": lattice-best-path, lattice-to-nbest, lattice-oracle,
lattice-lmrescore) into one tool operating on CompactLattice archives (text,
or Kaldi binary) as written by ``bin/decode.py -lattice_out``.

Usage:
  python -m pykaldi2_tpu_torch.bin.lattice_tool -lattices lat.txt -words words.txt \
      [-best_path hyp.txt] [-nbest 10 -nbest_out nb.txt] \
      [-ref ref.txt]                 # oracle WER + best-path WER
      [-arpa_old old.arpa -arpa_new new.arpa [-lm_scale 1.0]
       -rescored_out lat2.txt]       # LM rescoring
"""

from __future__ import annotations

import argparse
import sys

from pykaldi2_tpu_torch.decode.lattice import (best_path, lmrescore, nbest,
                                         oracle_errors, read_lattices_text,
                                         write_lattices_text)
from pykaldi2_tpu_torch.decode.wer import score_corpus
from pykaldi2_tpu_torch.utils import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-lattices", required=True,
                   help="CompactLattice text archive (decode.py -lattice_out)")
    p.add_argument("-words", required=True, help="word symbol table")
    p.add_argument("-best_path", default=None,
                   help="write best-path transcripts here ('-' = stdout)")
    p.add_argument("-nbest", type=int, default=0)
    p.add_argument("-nbest_out", default=None)
    p.add_argument("-ref", default=None,
                   help="reference transcripts: report best-path + oracle WER")
    p.add_argument("-arpa_old", default=None,
                   help="ARPA LM baked into the decode graph (subtracted)")
    p.add_argument("-arpa_new", default=None, help="ARPA LM to add")
    p.add_argument("-lm_scale", type=float, default=1.0)
    p.add_argument("-rescored_out", default=None,
                   help="write rescored lattices to this archive")
    p.add_argument("-mbr", action="store_true",
                   help="consensus (MBR) transcripts instead of best-path "
                        "(Kaldi lattice-mbr-decode)")
    p.add_argument("-ctm_out", default=None,
                   help="CTM with MBR confidences (lattice-to-ctm-conf); "
                        "implies -mbr. NB: text/ark archives carry no frame "
                        "times, so times here are bin order only — decode.py "
                        "-ctm_out has the real times")
    p.add_argument("-frame_shift", type=float, default=0.01)
    p.add_argument("-prune_beam", type=float, default=0.0,
                   help="posterior-prune lattices to this beam first "
                        "(Kaldi lattice-prune)")
    p.add_argument("-pruned_out", default=None,
                   help="write the pruned lattices to this archive")
    args = p.parse_args(argv)
    if args.ctm_out:
        args.mbr = True

    log = setup_logging(None)
    from pykaldi2_tpu_torch.bin.decode import read_symtab

    id2w = read_symtab(args.words)
    w2id = {w: i for i, w in id2w.items()}
    with open(args.lattices, "rb") as f:
        head = f.read(256)
    if b"\x00B" in head:   # Kaldi binary-archive marker after the key
        from pykaldi2_tpu_torch.decode.lattice_ark import read_lattice_ark

        lats = read_lattice_ark(args.lattices)
    else:
        lats = read_lattices_text(args.lattices)
    log.info("read %d lattices", len(lats))

    if args.arpa_new:
        from pykaldi2_tpu_torch.graph.arpa import arpa_to_fst, read_arpa

        def g_of(path):
            if path is None:
                return None
            return arpa_to_fst(read_arpa(path), w2id).to_fst()

        g_old, g_new = g_of(args.arpa_old), g_of(args.arpa_new)
        rescored = {}
        for uid, wf in lats.items():
            try:
                rescored[uid] = lmrescore(wf, g_old, g_new, args.lm_scale)
            except ValueError as e:
                log.warning("rescore failed for %s: %s", uid, e)
        lats = rescored
        if args.rescored_out:
            if args.rescored_out.endswith(".ark"):
                from pykaldi2_tpu_torch.decode.lattice_ark import write_lattice_ark

                write_lattice_ark(args.rescored_out, lats)
            else:
                write_lattices_text(args.rescored_out, lats)
            log.info("wrote %d rescored lattices to %s",
                     len(lats), args.rescored_out)

    if args.prune_beam > 0.0:
        from pykaldi2_tpu_torch.decode.mbr import prune_posterior

        pruned = {}
        for uid, wf in lats.items():
            try:
                pruned[uid] = prune_posterior(wf, args.prune_beam)
            except ValueError as e:
                log.warning("prune failed for %s: %s", uid, e)
        lats = pruned
        if args.pruned_out:
            if args.pruned_out.endswith(".ark"):
                from pykaldi2_tpu_torch.decode.lattice_ark import write_lattice_ark

                write_lattice_ark(args.pruned_out, lats)
            else:
                write_lattices_text(args.pruned_out, lats)
            log.info("wrote %d pruned lattices to %s", len(lats),
                     args.pruned_out)

    hyps = {}
    mbr_results = {}
    for uid, wf in lats.items():
        try:
            if args.mbr:
                from pykaldi2_tpu_torch.decode.mbr import mbr_decode

                res = mbr_decode(wf)
                mbr_results[uid] = res
                words = res.words
            else:
                words, _ = best_path(wf)
            hyps[uid] = [id2w.get(w, f"<{w}>") for w in words]
        except ValueError as e:
            log.warning("%s failed for %s: %s",
                        "mbr" if args.mbr else "best-path", uid, e)

    if args.ctm_out:
        from pykaldi2_tpu_torch.decode.mbr import write_ctm

        with open(args.ctm_out, "w") as f:
            for uid in sorted(mbr_results):
                write_ctm(f, uid, mbr_results[uid],
                          frame_shift=args.frame_shift, id2w=id2w)
        log.info("wrote CTM for %d utterances to %s",
                 len(mbr_results), args.ctm_out)

    if args.best_path:
        f = sys.stdout if args.best_path == "-" else open(args.best_path, "w")
        for uid in sorted(hyps):
            f.write(uid + " " + " ".join(hyps[uid]) + "\n")
        if args.best_path != "-":
            f.close()

    if args.nbest:
        f = open(args.nbest_out, "w") if args.nbest_out else sys.stdout
        for uid in sorted(lats):
            lat = lats[uid]
            try:
                entries = nbest(lat, args.nbest)
            except ValueError:
                # external Kaldi lattices can carry word-0 (eps) silence
                # arcs; unique N-best needs an eps-free acceptor
                try:
                    entries = nbest(lat.remove_input_epsilons(), args.nbest)
                except ValueError as e:
                    log.warning("nbest failed for %s: %s", uid, e)
                    continue
            for k, (ws, score) in enumerate(entries):
                text = " ".join(id2w.get(w, f"<{w}>") for w in ws)
                f.write(f"{uid}-{k + 1} {score:.4f} {text}\n")
        if args.nbest_out:
            f.close()

    if args.ref:
        refs = {}
        with open(args.ref) as f:
            for line in f:
                parts = line.split()
                if parts:
                    refs[parts[0]] = parts[1:]
        result = score_corpus(refs, hyps)
        print(f"%WER {result['wer']:.2f} [ {result['errors']} / "
              f"{result['ref_len']}, {result['ins']} ins, {result['dels']} del, "
              f"{result['subs']} sub ]")
        o_err, o_len = 0, 0
        for uid, wf in lats.items():
            if uid not in refs:
                continue
            rids = [w2id.get(w, -1) for w in refs[uid]]
            try:
                o_err += oracle_errors(wf, rids)
                o_len += len(rids)
            except ValueError:
                pass
        if o_len:
            print(f"%Oracle WER {100.0 * o_err / o_len:.2f} [ {o_err} / {o_len} ]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
