"""HMM/FST graph layer: topology, transition model, graph compilers.

Numpy copies of the pykaldi2_tpu/graph modules (reference behavior: the
Kaldi HMM/transition model, OpenFst and graph build pykaldi2 reaches through
PyKaldi): a TransitionModel over configurable HMM topologies with Kaldi
final.mdl interchange, a minimal host-side FST (composition, determinization,
minimization), phone-bigram LM estimation, ARPA word LMs (read, train, write,
G acceptor), the compilers for numerator, denominator and decoding graphs
(the small H∘L∘G and the HCLG-scale graph against an ARPA LM), the
vectorized arc-table FST and OpenFst binary IO.
"""

from pykaldi2_tpu_torch.graph.topology import HmmTopology
from pykaldi2_tpu_torch.graph.transition_model import TransitionModel
from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.graph.vfst import VectorFst
from pykaldi2_tpu_torch.graph.phone_lm import estimate_phone_bigram
from pykaldi2_tpu_torch.graph.arpa import (ArpaModel, arpa_to_fst, read_arpa, train_arpa,
                                           write_arpa)
from pykaldi2_tpu_torch.graph.compile import (
    expand_to_pdf_fst,
    make_decode_graph,
    make_den_graph,
    make_linear_num_graph,
    make_num_graph,
    make_word_decode_graph,
)
