"""Posterior/loss parity harness (PyTorch port): compare two dumped matrix
arks.

Same CLI and exit codes as pykaldi2_tpu/bin/compare_posteriors.py, numpy
only. BASELINE.json quality target: "tolerance-level loss/posterior parity"
vs the reference. This tool quantifies it: given two arks of per-utterance
matrices (e.g. decode -dump_ark output from the port and from the JAX
package, or from the card and the CPU), it reports per-utterance and corpus
max/mean absolute error and correlation, and exits nonzero if tolerances
are exceeded (1; 2 when the arks share no utterance).

CLI: python -m pykaldi2_tpu_torch.bin.compare_posteriors a.ark b.ark \
       [-atol 1e-3] [-min_corr 0.999]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from pykaldi2_tpu_torch.data import kaldi_io


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("ark_a")
    p.add_argument("ark_b")
    p.add_argument("-atol", type=float, default=1e-3)
    p.add_argument("-min_corr", type=float, default=0.999)
    p.add_argument("-frames_tol", type=int, default=2,
                   help="allow this many frames of length mismatch (snip-edges)")
    args = p.parse_args(argv)

    a = dict(kaldi_io.read_ark(args.ark_a, kind="mat"))
    b = dict(kaldi_io.read_ark(args.ark_b, kind="mat"))
    common = sorted(set(a) & set(b))
    if not common:
        print("no common utterances", file=sys.stderr)
        return 2
    missing = sorted(set(a) ^ set(b))
    worst_abs = 0.0
    worst_corr = 1.0
    sums = []
    fail = False
    for uid in common:
        x, y = a[uid], b[uid]
        t = min(x.shape[0], y.shape[0])
        if abs(x.shape[0] - y.shape[0]) > args.frames_tol or x.shape[1] != y.shape[1]:
            print(f"{uid}: shape mismatch {x.shape} vs {y.shape}")
            fail = True
            continue
        x, y = x[:t], y[:t]
        err = float(np.abs(x - y).max())
        corr = float(np.corrcoef(x.ravel(), y.ravel())[0, 1])
        sums.append(float(np.abs(x - y).mean()))
        worst_abs = max(worst_abs, err)
        worst_corr = min(worst_corr, corr)
        if err > args.atol or corr < args.min_corr:
            print(f"{uid}: max_abs {err:.3e} corr {corr:.6f}")
            fail = True
    print(f"compared {len(common)} utts ({len(missing)} unmatched): "
          f"worst max_abs {worst_abs:.3e}, mean_abs {np.mean(sums):.3e}, "
          f"worst corr {worst_corr:.6f}")
    if fail:
        print("PARITY FAIL", file=sys.stderr)
        return 1
    print("PARITY OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
