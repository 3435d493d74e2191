"""Decoding and scoring: the ctypes binding of the native lattice decoder
(native/latdec.cc), WER, lattice word graphs and archives, and MBR."""
