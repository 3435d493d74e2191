"""Ops: the LSTM recurrence kernels (K2/K3) with autograd, bf16 products, CE loss,
and the forward-backward and Viterbi recursions over arc-table graphs."""

from pykaldi2_tpu_torch.ops.fb import (
    fsa_expected_accuracy,
    fsa_logz,
    fsa_occupancies,
    fsa_viterbi,
    pack_graph,
)
