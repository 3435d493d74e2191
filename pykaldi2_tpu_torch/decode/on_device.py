"""Batched exact Viterbi decoding with word outputs, on the card.

Port of pykaldi2_tpu/decode/on_device.py. The whole eval batch runs exact
Viterbi (no beam) over the dense decode graph (``ops.fb.fsa_viterbi``), and
only the per-frame winning arcs come back to the host, where the words are
read off the arcs' output labels. For graphs that fit the arc-table
representation; the beam decoders stay for larger graphs and lattices.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.ops.fb import GraphArrays, fsa_viterbi
from pykaldi2_tpu_torch.ops.fsa import DenseFsa


def dense_from_pdf_fst(fst: Fst, word_penalty: float = 0.0) -> DenseFsa:
    """pdf-level decode FST (ilabel = pdf+1, olabel = word) → DenseFsa.

    ``word_penalty`` subtracts a log-score on word-emitting arcs (the host
    LatticeDecoder's insertion penalty)."""
    src, dst, pdf, w, ol = [], [], [], [], []
    for s in range(fst.num_states):
        for a in fst.arcs[s]:
            if a.ilabel == 0:
                raise ValueError("decode FST has epsilon input arcs")
            src.append(s)
            dst.append(a.nextstate)
            pdf.append(a.ilabel - 1)
            w.append(a.weight - (word_penalty if a.olabel != 0 else 0.0))
            ol.append(a.olabel)
    final = np.full(fst.num_states, -np.inf, np.float32)
    for s, fw in fst.finals.items():
        final[s] = fw
    if fst.start != 0:
        raise ValueError("decode FST must start at state 0")
    return DenseFsa(fst.num_states, np.asarray(src, np.int32), np.asarray(dst, np.int32),
                    np.asarray(pdf, np.int32), np.asarray(w, np.float32), final, 0,
                    None, np.asarray(ol, np.int32)).validate()


def viterbi_decode_words(obs: torch.Tensor, graph: GraphArrays, num_frames: torch.Tensor
                         ) -> Tuple[List[List[int]], np.ndarray, np.ndarray]:
    """[B,T,P] scaled loglikes → (word id lists, per-frame pdfs [B,T], scores [B]).

    ``graph`` must carry olabels (``pack_graph`` of ``dense_from_pdf_fst``'s
    output), on obs's device."""
    if graph.olabel is None:
        raise ValueError("graph has no output labels")
    with torch.no_grad():
        score, arcs = fsa_viterbi(obs, graph, num_frames)
    arcs = arcs.cpu().numpy()
    olab = graph.olabel.cpu().numpy()
    pdfs = graph.pdf.cpu().numpy()
    nf = num_frames.cpu().numpy()
    out_words: List[List[int]] = []
    out_pdfs = np.full(arcs.shape, -1, np.int32)
    for b in range(arcs.shape[0]):
        valid = arcs[b, : nf[b]]
        out_words.append([int(w) for w in olab[valid] if w != 0])
        out_pdfs[b, : nf[b]] = pdfs[valid]
    return out_words, out_pdfs, score.cpu().numpy()
