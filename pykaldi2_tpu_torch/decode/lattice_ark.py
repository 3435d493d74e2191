"""Kaldi binary CompactLattice archive read/write.

Numpy copy of pykaldi2_tpu/decode/lattice_ark.py for the PyTorch port.

Reference behavior: Kaldi's lattice archives (``lat.1.gz`` etc.) as written
by ``lattice-copy``/decoders — a Kaldi Table archive whose entries are
binary VectorFst<CompactLatticeArc> objects (kaldi/src/lat/kaldi-lattice.cc
WriteCompactLattice, fstext/ lattice-weight.h serialization), transcribed
independently from the format:

  per entry:  "<utt> " + "\\x00B" (binary marker) + FstHeader + body
  FstHeader:  int32 magic 2125659606, string "vector",
              string "compactlattice44" (CompactLatticeWeight<
              LatticeWeight<float>, int32>), int32 version=2, int32 flags,
              uint64 properties, int64 start/numstates/numarcs
  state:      CompactLatticeWeight final, int64 narcs, arcs
  arc:        int32 ilabel (word), int32 olabel (== ilabel; acceptor),
              weight, int32 nextstate
  weight:     float graph_cost, float acoustic_cost,
              int32 len, len × int32 transition-ids

Like the text form in decode/lattice.py, word acceptors on this side fold
graph+acoustic into one log-prob; writing emits the combined cost in the
graph field with an empty tid string, reading sums the fields and drops the
tid strings. Non-final states carry the zero weight (+inf, +inf, empty).
"""

from __future__ import annotations

import struct
from typing import Dict

from pykaldi2_tpu_torch.graph.fst import Fst

_MAGIC = 2125659606
_INF = float("inf")
_ARCTYPE = "compactlattice44"


def _w_str(f, s: str):
    f.write(struct.pack("<i", len(s)))
    f.write(s.encode())


def _r_str(f) -> str:
    (n,) = struct.unpack("<i", f.read(4))
    if not 0 <= n < 1 << 20:
        raise ValueError("implausible string length — not a lattice archive?")
    return f.read(n).decode()


def _w_weight(f, graph_cost: float, acoustic_cost: float, tids=()):
    f.write(struct.pack("<ff", graph_cost, acoustic_cost))
    f.write(struct.pack("<i", len(tids)))
    for t in tids:
        f.write(struct.pack("<i", t))


def _r_weight(f):
    g, a = struct.unpack("<ff", f.read(8))
    (n,) = struct.unpack("<i", f.read(4))
    if not 0 <= n < 1 << 24:
        raise ValueError("implausible tid-string length")
    tids = struct.unpack(f"<{n}i", f.read(4 * n)) if n else ()
    return g, a, tids


def write_lattice_ark(path: str, lattices: Dict[str, Fst]) -> None:
    """Write word acceptors as a binary Kaldi CompactLattice archive."""
    with open(path, "wb") as f:
        for uid in sorted(lattices):
            lat = lattices[uid]
            f.write(uid.encode() + b" \x00B")
            f.write(struct.pack("<i", _MAGIC))
            _w_str(f, "vector")
            _w_str(f, _ARCTYPE)
            f.write(struct.pack("<ii", 2, 0))
            f.write(struct.pack("<Q", 0))
            n_arcs = sum(len(a) for a in lat.arcs)
            f.write(struct.pack("<qqq", lat.start, lat.num_states, n_arcs))
            for s in range(lat.num_states):
                if s in lat.finals:
                    _w_weight(f, -lat.finals[s], 0.0)
                else:
                    _w_weight(f, _INF, _INF)
                f.write(struct.pack("<q", len(lat.arcs[s])))
                for a in lat.arcs[s]:
                    f.write(struct.pack("<ii", a.ilabel, a.ilabel))
                    _w_weight(f, -a.weight, 0.0)
                    f.write(struct.pack("<i", a.nextstate))


def read_lattice_ark(path: str) -> Dict[str, Fst]:
    """Read a binary Kaldi CompactLattice archive into word acceptors."""
    out: Dict[str, Fst] = {}
    with open(path, "rb") as f:
        while True:
            uid = b""
            c = f.read(1)
            if not c:
                break
            while c != b" ":
                uid += c
                c = f.read(1)
                if not c:
                    raise ValueError("truncated archive key")
            marker = f.read(2)
            if marker != b"\x00B":
                raise ValueError(f"non-binary lattice entry for {uid!r} — "
                                 "text archives go through decode/lattice.py")
            (magic,) = struct.unpack("<i", f.read(4))
            if magic != _MAGIC:
                raise ValueError("bad FST magic in lattice archive")
            fsttype = _r_str(f)
            arctype = _r_str(f)
            if fsttype != "vector" or arctype != _ARCTYPE:
                raise ValueError(f"unsupported lattice fst {fsttype}/{arctype}")
            _ver, _flags = struct.unpack("<ii", f.read(8))
            struct.unpack("<Q", f.read(8))
            start, num_states, _na = struct.unpack("<qqq", f.read(24))
            lat = Fst()
            for _ in range(max(num_states, 0)):
                lat.add_state()
            if start >= 0:
                lat.set_start(int(start))
            for s in range(num_states):
                g, a, _tids = _r_weight(f)
                if g != _INF or a != _INF:
                    lat.set_final(s, -(g + a))
                (narcs,) = struct.unpack("<q", f.read(8))
                for _ in range(narcs):
                    il, ol = struct.unpack("<ii", f.read(8))
                    g, a, _tids = _r_weight(f)
                    (ns,) = struct.unpack("<i", f.read(4))
                    lat.add_arc(s, il, ol, -(g + a), ns)
            out[uid.decode()] = lat
    return out
