"""Ops: CE loss, the dense arc-table FSA container, the forward-backward and
Viterbi recursions over shared, per-utterance and bigram graphs, and the SE
losses. The kernels' modules (``lstm_cuda``, ``fb_lattice_cuda``,
``fb_block_cuda``) and the other fixed-denominator routes (``fb_dense``,
``fb_block``) and the banded lattices (``fb_lattice``) are imported by name.

Exports what pykaldi2_tpu/ops/__init__.py exports, from the same modules,
and ``batched_expected_accuracy`` beside the rest of ``fb_batched``.
"""

from pykaldi2_tpu_torch.ops.losses import ce_loss, frame_accuracy
from pykaldi2_tpu_torch.ops.fsa import DenseFsa, linear_chain_fsa, load_fsa, save_fsa
from pykaldi2_tpu_torch.ops.fb import (
    fsa_expected_accuracy,
    fsa_logz,
    fsa_occupancies,
    fsa_viterbi,
    pack_graph,
)
from pykaldi2_tpu_torch.ops.fb_batched import (
    BatchedGraphs,
    batched_expected_accuracy,
    fsa_logz_b,
    fsa_occupancies_b,
    mmi_objective_lattice,
    pack_graph_batch,
)
from pykaldi2_tpu_torch.ops.fb_bigram import (
    BigramDenGraph,
    bigram_expected_accuracy,
    bigram_logz,
    bigram_occupancies,
    make_bigram_den,
)
from pykaldi2_tpu_torch.ops.se_losses import mmi_loss, mmi_objective, smbr_loss
