"""Decoding: the ctypes binding of the native lattice decoder (native/latdec.cc)."""
