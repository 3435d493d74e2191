"""Graph building CLI (PyTorch port): decode graphs and denominator graphs
(mkgraph.sh-ish).

Same CLI as pykaldi2_tpu/bin/build_graph.py, host-only numpy (run.sh stage
4). Builds either a pdf-level decoding FST (for bin/decode.py and the
on-the-fly lattice mode; with ``-arpa`` the HCLG-scale graph against a word
LM) or a dense denominator graph (.npz, for train_se's fixed-graph hot path)
from a lexicon + optional grammar or an alignment-estimated phone LM.

CLI:
  python -m pykaldi2_tpu_torch.bin.build_graph decode -lexicon lex.txt -out graph.fst.txt \
      [-arpa lm.arpa] [-words_out words.txt] [-trans_model final.mdl] \
      [-topo one|three] [-sil_phone N -sil_prob P]
  python -m pykaldi2_tpu_torch.bin.build_graph den -ali ali.ark -out den.npz \
      [-num_pdfs N] [-trans_model final.mdl] [-smoothing 1.0]

``-out`` ending in .npz writes a VectorFst arc table, in .fst an OpenFst
binary VectorFst, anything else OpenFst text.
"""

from __future__ import annotations

import argparse

import numpy as np

from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.graph import (HmmTopology, TransitionModel, estimate_phone_bigram,
                                      make_decode_graph, make_den_graph)
from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones
from pykaldi2_tpu_torch.ops.fsa import save_fsa
from pykaldi2_tpu_torch.bin.align import read_lexicon


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)
    pd = sub.add_parser("decode")
    pd.add_argument("-lexicon", required=True)
    pd.add_argument("-out", required=True,
                    help=".npz → VectorFst arc table (word-LM scale); .fst → "
                         "OpenFst binary; anything else → OpenFst text")
    pd.add_argument("-arpa", default=None,
                    help="ARPA word LM → full HCLG via the vectorized "
                         "trie-free L∘G pipeline (mkgraph.sh equivalent)")
    pd.add_argument("-words_out", default=None)
    pd.add_argument("-trans_model", default=None)
    pd.add_argument("-sil_phone", type=int, default=0)
    pd.add_argument("-sil_prob", type=float, default=0.0)
    pd.add_argument("-topo", choices=["one", "three"], default="one")
    pn = sub.add_parser("den")
    pn.add_argument("-ali", required=True, help="pdf alignment ark")
    pn.add_argument("-num_pdfs", type=int, default=0, help="0 = infer from ali")
    pn.add_argument("-out", required=True)
    pn.add_argument("-trans_model", default=None)
    pn.add_argument("-smoothing", type=float, default=1.0)
    args = p.parse_args(argv)

    if args.mode == "decode":
        lexicon, word_ids = read_lexicon(args.lexicon)
        if args.trans_model:
            tm = TransitionModel.read_kaldi(args.trans_model)
        else:
            phones = sorted({ph for prons in lexicon.values() for pr in prons for ph in pr}
                            | ({args.sil_phone} if args.sil_phone else set()))
            topo = (HmmTopology.one_state(phones) if args.topo == "one"
                    else HmmTopology.three_state(phones))
            tm = TransitionModel(topo)
        if args.arpa:
            from pykaldi2_tpu_torch.graph.arpa import read_arpa
            from pykaldi2_tpu_torch.graph.compile import make_word_decode_graph

            model = read_arpa(args.arpa)
            g = make_word_decode_graph(tm, lexicon, word_ids, model,
                                       sil_phone=args.sil_phone,
                                       sil_prob=args.sil_prob)
        else:
            g = make_decode_graph(tm, lexicon, word_ids, sil_phone=args.sil_phone,
                                  sil_prob=args.sil_prob)
        if args.out.endswith(".npz"):
            from pykaldi2_tpu_torch.graph.vfst import VectorFst

            if not isinstance(g, VectorFst):
                g = VectorFst.from_fst(g)
            g.save(args.out)
        elif args.out.endswith(".fst"):
            # OpenFst binary VectorFst (interchangeable with Kaldi tooling)
            from pykaldi2_tpu_torch.graph.openfst_io import write_openfst

            if not isinstance(g, Fst):
                g = g.to_fst()
            write_openfst(g, args.out)
        else:
            if not isinstance(g, Fst):
                g = g.to_fst()
            g.write_text(args.out)
        if args.words_out:
            with open(args.words_out, "w") as f:
                f.write("<eps> 0\n")
                for w, i in sorted(word_ids.items(), key=lambda kv: kv[1]):
                    f.write(f"{w} {i}\n")
        print(f"wrote decode graph: {g.num_states} states, {g.num_arcs} arcs → {args.out}")
    else:
        alis = dict(kaldi_io.read_ark(args.ali, kind="ivec"))
        num_pdfs = args.num_pdfs or 1 + max(int(v.max()) for v in alis.values() if v.size)
        if args.trans_model:
            tm = TransitionModel.read_kaldi(args.trans_model)
        else:
            tm = TransitionModel(HmmTopology.one_state(range(1, num_pdfs + 1)))
        pdf_to_phone = np.zeros(tm.num_pdfs, np.int32)
        for (ph, _j, pdf) in tm.tuples:
            pdf_to_phone[pdf] = ph
        seqs = [collapse_to_phones(pdf_to_phone[v]) for v in alis.values() if v.size]
        lm = estimate_phone_bigram(seqs, tm.topo.phones, args.smoothing)
        den = make_den_graph(tm, lm)
        save_fsa(args.out, den)
        print(f"wrote den graph: {den.num_states} states, {den.num_arcs} arcs → {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
