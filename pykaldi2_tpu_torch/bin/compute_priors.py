"""Compute the pdf log-prior vector from alignments, PyTorch port.

Same CLI and output as pykaldi2_tpu/bin/compute_priors.py (reference
behavior: the CE-stage state prior pykaldi2's SE training and decoding
subtract from log-posteriors — Kaldi recipes derive it from final.occs or
alignment counts): count pdf-ids over the alignment archive (transition-ids
are mapped with final.mdl when given) and write log(count/total) floored,
as a .npy vector that ``train_se -prior_path`` reads. Host-only: it touches
no device.

CLI:
  python -m pykaldi2_tpu_torch.bin.compute_priors -ali ali.ark -out prior.npy \\
      [-num_pdfs N] [-model final.mdl] [-floor 1e-10]
"""

from __future__ import annotations

import argparse

import numpy as np

from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts
from pykaldi2_tpu_torch.utils import setup_logging


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-ali", required=True, help="alignment ark (pdf-ids, or "
                   "transition-ids with -model)")
    p.add_argument("-out", required=True, help="output .npy log-prior vector")
    p.add_argument("-num_pdfs", type=int, default=0,
                   help="output dimension (default: inferred from data/model)")
    p.add_argument("-model", default=None,
                   help="final.mdl: alignments are transition-ids to map")
    p.add_argument("-floor", type=float, default=1e-10)
    args = p.parse_args(argv)

    log = setup_logging(None)
    alis = dict(kaldi_io.read_ark(args.ali, kind="ivec"))
    if not alis:
        raise SystemExit(f"no alignments in {args.ali}")
    if args.model:
        from pykaldi2_tpu_torch.graph.transition_model import TransitionModel

        tm = TransitionModel.read_kaldi(args.model)
        t2p = tm.tid_to_pdf_array()
        labels = (t2p[np.asarray(v)] for v in alis.values())
        num_pdfs = args.num_pdfs or tm.num_pdfs
    else:
        labels = alis.values()
        num_pdfs = args.num_pdfs or 1 + max(int(v.max()) for v in alis.values() if v.size)
    counts = count_labels(labels, num_pdfs)
    log_prior = priors_from_counts(counts, floor=args.floor)
    np.save(args.out, log_prior)
    zero = int((counts == 0).sum())
    log.info("priors over %d pdfs from %d utts (%d unseen pdfs floored) → %s",
             num_pdfs, len(alis), zero, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
