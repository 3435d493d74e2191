"""The denominator graph of the on-the-fly SE mixes: a phone-bigram loop
over 3-state left-to-right phone HMMs, at the pdf level and without input
epsilons, made from a fixed seed of its own (the same for every run seed).

States: 0 is the start; (c, q, j) is HMM state j of phone q entered after
phone c (c = the start context or a phone), so a state's in-arcs all emit
its own pdf, q·3 + j. Arcs, weights in log probability:

  start → (start ctx, q, 0)      log init[q]
  (c, q, j) → (c, q, j)          log self[q, j]
  (c, q, j) → (c, q, j + 1)      log (1 − self[q, j])          (j < 2)
  (c, q, 2) → (q, r, 0)          log (1 − self[q, 2]) + log bigram[q, r]
  final (c, q, 2)                log end[q]

With 41 phones: 1 + 42·41·3 = 5,167 states, the size of the recipe's
phone-loop graph over the same model.
"""

from __future__ import annotations

import numpy as np

HMM_STATES = 3


def make(phones: int, seed: int) -> dict:
    """{"src", "dst", "pdf", "w"} arc arrays, "start", "final" [S] (−inf
    where not final), "num_states", "num_pdfs"."""
    rng = np.random.default_rng(seed)
    init = rng.dirichlet(np.ones(phones))
    bigram = rng.dirichlet(np.ones(phones + 1), size=phones)   # last column: end
    self_p = rng.uniform(0.3, 0.8, (phones, HMM_STATES))
    ctxs = phones + 1                                            # context phones, then start

    def state(c, q, j):
        return 1 + (c * phones + q) * HMM_STATES + j

    src, dst, pdf, w = [], [], [], []

    def arc(s, d, q, j, logp):
        src.append(s)
        dst.append(d)
        pdf.append(q * HMM_STATES + j)
        w.append(logp)

    for q in range(phones):
        arc(0, state(phones, q, 0), q, 0, np.log(init[q]))
    for c in range(ctxs):
        for q in range(phones):
            for j in range(HMM_STATES):
                s = state(c, q, j)
                arc(s, s, q, j, np.log(self_p[q, j]))
                if j + 1 < HMM_STATES:
                    arc(s, state(c, q, j + 1), q, j + 1, np.log1p(-self_p[q, j]))
            last = state(c, q, HMM_STATES - 1)
            leave = np.log1p(-self_p[q, HMM_STATES - 1])
            for r in range(phones):
                arc(last, state(q, r, 0), r, 0, leave + np.log(bigram[q, r]))
    num_states = 1 + ctxs * phones * HMM_STATES
    final = np.full(num_states, -np.inf, np.float32)
    for c in range(ctxs):
        for q in range(phones):
            final[state(c, q, HMM_STATES - 1)] = np.log(bigram[q, phones])
    return {"src": np.asarray(src, np.int64), "dst": np.asarray(dst, np.int64),
            "pdf": np.asarray(pdf, np.int64), "w": np.asarray(w, np.float32),
            "start": 0, "final": final, "num_states": num_states,
            "num_pdfs": phones * HMM_STATES}
