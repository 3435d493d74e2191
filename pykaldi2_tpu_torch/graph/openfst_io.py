"""OpenFst binary VectorFst (StdArc) read/write.

Numpy copy of pykaldi2_tpu/graph/openfst_io.py for the PyTorch port.

Reference behavior: OpenFst's ``FstHeader`` + ``VectorFst`` binary layout
(fst/fst.cc FstHeader::Read/Write, fst/vector-fst.h VectorFstBaseImpl) — the
on-disk format of Kaldi decode graphs (``HCLG.fst``) and of anything
``fstcompile`` emits. Transcribed independently from the documented format:

    int32   magic = 2125659606
    string  fst type      ("vector")          [string = int32 len + bytes]
    string  arc type      ("standard")
    int32   version       (2)
    int32   flags         (bit0 = has isymbols, bit1 = has osymbols)
    uint64  properties
    int64   start state   (-1 = none)
    int64   num states
    int64   num arcs
    per state: float final-weight (+inf = non-final), int64 narcs,
               per arc: int32 ilabel, int32 olabel, float weight,
                        int32 nextstate

All integers little-endian. TropicalWeight stores costs = −log-probs, the
negation of this framework's log-prob weights (graph/fst.py docstring);
conversion happens on the way in/out, mirroring ``Fst.write_text``.
"""

from __future__ import annotations

import struct

import numpy as np

from pykaldi2_tpu_torch.graph.fst import Fst

FST_MAGIC = 2125659606
_VECTOR_VERSION = 2
_INF = float("inf")


def _write_string(f, s: str):
    b = s.encode()
    f.write(struct.pack("<i", len(b)))
    f.write(b)


def _read_string(f) -> str:
    (n,) = struct.unpack("<i", f.read(4))
    if not 0 <= n < 1 << 20:
        raise ValueError(f"implausible string length {n} — not an OpenFst file?")
    return f.read(n).decode()


def write_openfst(fst: Fst, path: str):
    """Write as an OpenFst binary VectorFst<StdArc>."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", FST_MAGIC))
        _write_string(f, "vector")
        _write_string(f, "standard")
        f.write(struct.pack("<ii", _VECTOR_VERSION, 0))     # version, flags
        f.write(struct.pack("<Q", 0))                       # properties
        f.write(struct.pack("<qqq", fst.start, fst.num_states, fst.num_arcs))
        for s in range(fst.num_states):
            final = -fst.finals[s] if s in fst.finals else _INF
            f.write(struct.pack("<f", final))
            f.write(struct.pack("<q", len(fst.arcs[s])))
            for a in fst.arcs[s]:
                f.write(struct.pack("<iifi", a.ilabel, a.olabel,
                                    -a.weight, a.nextstate))


def read_openfst(path: str) -> Fst:
    """Read an OpenFst binary VectorFst/ConstFst<StdArc> (e.g. HCLG.fst)."""
    with open(path, "rb") as f:
        (magic,) = struct.unpack("<i", f.read(4))
        if magic != FST_MAGIC:
            raise ValueError(f"bad OpenFst magic {magic:#x} in {path}")
        fsttype = _read_string(f)
        arctype = _read_string(f)
        if arctype != "standard":
            raise ValueError(f"unsupported arc type {arctype!r} "
                             "(only StdArc graphs are read)")
        version, flags = struct.unpack("<ii", f.read(8))
        _props = struct.unpack("<Q", f.read(8))[0]
        start, num_states, _num_arcs = struct.unpack("<qqq", f.read(24))
        if flags & 0x3:
            raise ValueError("embedded symbol tables are not supported — "
                             "strip with fstcompile-style external symtabs")
        if fsttype == "vector":
            return _read_vector_body(f, start, num_states)
        if fsttype == "const":
            return _read_const_body(f, start, num_states, version)
        raise ValueError(f"unsupported fst type {fsttype!r}")


def _read_vector_body(f, start: int, num_states: int) -> Fst:
    fst = Fst()
    for _ in range(max(num_states, 0)):
        fst.add_state()
    if start >= 0:
        fst.set_start(int(start))
    for s in range(num_states):
        (final,) = struct.unpack("<f", f.read(4))
        (narcs,) = struct.unpack("<q", f.read(8))
        if final != _INF:
            fst.set_final(s, -final)
        if narcs:
            raw = np.frombuffer(f.read(16 * narcs), dtype=np.uint8)
            rec = raw.reshape(narcs, 16)
            il = rec[:, 0:4].copy().view("<i4").ravel()
            ol = rec[:, 4:8].copy().view("<i4").ravel()
            w = rec[:, 8:12].copy().view("<f4").ravel()
            ns = rec[:, 12:16].copy().view("<i4").ravel()
            for k in range(narcs):
                fst.add_arc(s, int(il[k]), int(ol[k]), -float(w[k]), int(ns[k]))
    return fst


def _read_const_body(f, start: int, num_states: int, version: int) -> Fst:
    """ConstFst body: states table then one flat arc table.

    Layout (fst/const-fst.h): per state {float final, int32 pos, int32 narcs,
    int32 niepsilons, int32 noepsilons} (pos is int32 in v1, padding/int64
    alignment handled by the fixed 20-byte stride used here for v1), then
    num_arcs records like VectorFst arcs.
    """
    # v1 const-fst states are 20-byte records; newer versions (2) use an
    # aligned layout we don't attempt — convert with fstconvert to vector
    if version != 1:
        raise ValueError("only ConstFst file-version 1 is supported; "
                         "fstconvert --fst_type=vector first")
    fst = Fst()
    for _ in range(max(num_states, 0)):
        fst.add_state()
    if start >= 0:
        fst.set_start(int(start))
    finals = np.empty(num_states, np.float64)
    pos = np.empty(num_states, np.int64)
    cnt = np.empty(num_states, np.int64)
    for s in range(num_states):
        final, p, n, _nie, _noe = struct.unpack("<fiiii", f.read(20))
        finals[s], pos[s], cnt[s] = final, p, n
        if final != _INF:
            fst.set_final(s, -final)
    total = int(cnt.sum())
    raw = np.frombuffer(f.read(16 * total), dtype=np.uint8).reshape(total, 16)
    il = raw[:, 0:4].copy().view("<i4").ravel()
    ol = raw[:, 4:8].copy().view("<i4").ravel()
    w = raw[:, 8:12].copy().view("<f4").ravel()
    ns = raw[:, 12:16].copy().view("<i4").ravel()
    for s in range(num_states):
        for k in range(int(pos[s]), int(pos[s] + cnt[s])):
            fst.add_arc(s, int(il[k]), int(ol[k]), -float(w[k]), int(ns[k]))
    return fst
