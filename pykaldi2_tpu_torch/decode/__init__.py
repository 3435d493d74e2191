"""Decoding and scoring: the ctypes binding of the native lattice decoder
(native/latdec.cc), WER, lattice word graphs and archives, and MBR.

Importing the package builds nothing: ``build_native`` (g++) runs when it
is called or when a ``LatticeDecoder`` is first made.
"""

from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder, build_native
from pykaldi2_tpu_torch.decode.wer import edit_distance, score_corpus
