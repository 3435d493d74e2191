"""HMM/FST graph layer: topology, transition model, graph compilers.

Numpy copies of the pykaldi2_tpu/graph modules that sequence training and
decoding need (reference behavior: the Kaldi HMM/transition model, OpenFst
and graph build pykaldi2 reaches through PyKaldi): a TransitionModel over
configurable HMM topologies with Kaldi final.mdl interchange, a minimal
host-side FST, phone-bigram LM estimation, the compilers for the
denominator graph, the pdf-labeled decoder FST and the small word decoding
graph, the vectorized arc-table FST and OpenFst binary IO. ARPA LMs and the
HCLG-scale graph build wait for the graph-building slice.
"""

from pykaldi2_tpu_torch.graph.topology import HmmTopology
from pykaldi2_tpu_torch.graph.transition_model import TransitionModel
from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.graph.vfst import VectorFst
from pykaldi2_tpu_torch.graph.phone_lm import estimate_phone_bigram
from pykaldi2_tpu_torch.graph.compile import expand_to_pdf_fst, make_decode_graph, make_den_graph
