"""HMM/FST graph layer: topology, transition model, graph compilers.

Numpy copies of the pykaldi2_tpu/graph modules that sequence training needs
(reference behavior: the Kaldi HMM/transition model, OpenFst and graph build
pykaldi2 reaches through PyKaldi): a TransitionModel over configurable HMM
topologies with Kaldi final.mdl interchange, a minimal host-side FST,
phone-bigram LM estimation, and the compilers for the denominator graph and
the pdf-labeled decoder FST. The vectorized FST, ARPA and OpenFst binary IO
wait for the decode slice.
"""

from pykaldi2_tpu_torch.graph.topology import HmmTopology
from pykaldi2_tpu_torch.graph.transition_model import TransitionModel
from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.graph.phone_lm import estimate_phone_bigram
from pykaldi2_tpu_torch.graph.compile import expand_to_pdf_fst, make_den_graph
