"""Pure-Python Kaldi ark/scp table IO.

Replaces PyKaldi's ``kaldi.util.table`` readers/writers (SURVEY.md §3.1
"Readers / IO"; binary formats per kaldi/src/{base/io-funcs,matrix/kaldi-matrix,
util/kaldi-table}). Supports:

  * binary float/double matrices ("FM"/"DM") and vectors ("FV"/"DV")
  * compressed matrices ("CM"/"CM2"/"CM3") — read (``_read_compressed_matrix``)
    AND write (``write_compressed_matrix``, percentile-coded, byte-exact vs
    the independent fixture writer); matrix writes default to uncompressed
    "FM" unless compression is requested
  * int32 vectors (alignments, WriteIntegerVector layout)
  * text-mode tables
  * ark, scp (with byte offsets), and ark+scp writing
"""

from __future__ import annotations

import struct
from typing import Iterator, Tuple

import numpy as np

BINARY_MARKER = b"\0B"


# ---------------------------------------------------------------------------
# Low-level object read/write (binary Kaldi format)
# ---------------------------------------------------------------------------


def _read_token(f) -> str:
    tok = b""
    while True:
        c = f.read(1)
        if not c or c == b" ":
            break
        tok += c
    return tok.decode()


def _expect_int32(f) -> int:
    sz = f.read(1)
    if sz != b"\x04":
        raise ValueError(f"expected int32 size marker, got {sz!r}")
    return struct.unpack("<i", f.read(4))[0]


def write_matrix(f, mat: np.ndarray):
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError("matrix must be 2-D")
    if mat.dtype == np.float64:
        f.write(b"DM ")
        dt = "<f8"
    else:
        mat = mat.astype(np.float32)
        f.write(b"FM ")
        dt = "<f4"
    f.write(b"\x04" + struct.pack("<i", mat.shape[0]))
    f.write(b"\x04" + struct.pack("<i", mat.shape[1]))
    f.write(np.ascontiguousarray(mat, dtype=dt).tobytes())


def read_matrix(f) -> np.ndarray:
    tok = _read_token(f)
    if tok == "FM":
        dt, isz = "<f4", 4
    elif tok == "DM":
        dt, isz = "<f8", 8
    elif tok in ("CM", "CM2", "CM3"):
        return _read_compressed_matrix(f, tok)
    else:
        raise ValueError(f"unknown matrix token {tok!r}")
    rows = _expect_int32(f)
    cols = _expect_int32(f)
    data = f.read(rows * cols * isz)
    return np.frombuffer(data, dtype=dt).reshape(rows, cols).copy()


def _read_compressed_matrix(f, tok: str) -> np.ndarray:
    """Kaldi CompressedMatrix (kaldi/src/matrix/compressed-matrix.cc).

    GlobalHeader = {f32 min_value, f32 range, i32 rows, i32 cols} (raw, no
    size markers). CM: per-column {4x u16 percentile codes} headers + u8
    data column-major with piecewise-linear decode; CM2: u16 per element;
    CM3: u8 per element.
    """
    min_v, rng = struct.unpack("<ff", f.read(8))
    rows, cols = struct.unpack("<ii", f.read(8))
    if tok == "CM2":
        u = np.frombuffer(f.read(2 * rows * cols), dtype="<u2").astype(np.float64)
        return (min_v + u * (rng / 65535.0)).reshape(rows, cols).astype(np.float32)
    if tok == "CM3":
        u = np.frombuffer(f.read(rows * cols), dtype=np.uint8).astype(np.float64)
        return (min_v + u * (rng / 255.0)).reshape(rows, cols).astype(np.float32)
    # CM: percentile-coded columns
    heads = np.frombuffer(f.read(8 * cols), dtype="<u2").reshape(cols, 4).astype(np.float64)
    pct = min_v + heads * (rng / 65535.0)                    # [cols, 4] p0,p25,p75,p100
    data = np.frombuffer(f.read(rows * cols), dtype=np.uint8).reshape(cols, rows)
    b = data.astype(np.float64)
    p0, p25, p75, p100 = pct[:, 0:1], pct[:, 1:2], pct[:, 2:3], pct[:, 3:4]
    lo = p0 + (p25 - p0) * (b / 64.0)
    mid = p25 + (p75 - p25) * ((b - 64.0) / 128.0)
    hi = p75 + (p100 - p75) * ((b - 192.0) / 63.0)
    out = np.where(b <= 64, lo, np.where(b <= 192, mid, hi))
    return out.T.astype(np.float32)


def write_compressed_matrix(f, mat: np.ndarray, fmt: str = "CM2"):
    """Write a Kaldi CompressedMatrix — round-trips with read_matrix.

    fmt: "CM" (percentile-coded u8 per element + per-column headers — what
    Kaldi's default ``--compress=true`` feature pipelines emit for feature
    matrices), "CM2" (u16 uniform), "CM3" (u8 uniform), or "auto" (Kaldi's
    kAutomaticMethod: CM when rows > 8, else CM2). CM semantics transcribed
    from kaldi/src/matrix/compressed-matrix.cc (ComputeColHeader /
    FloatToChar, including the percentile monotonicity clamps and the
    fewer-than-5-rows branch).
    """
    mat = np.asarray(mat, np.float64)
    rows, cols = mat.shape
    if fmt == "auto":
        fmt = "CM" if rows > 8 else "CM2"
    min_v = float(mat.min())
    rng = float(mat.max()) - min_v
    if rng <= 0.0:
        rng = 1e-5 if fmt == "CM" else 1e-10
    f.write(fmt.encode() + b" ")
    f.write(struct.pack("<ffii", min_v, rng, rows, cols))
    if fmt == "CM2":
        u = np.clip(np.rint((mat - min_v) * (65535.0 / rng)), 0, 65535).astype("<u2")
        f.write(u.tobytes())
        return
    if fmt == "CM3":
        u = np.clip(np.rint((mat - min_v) * (255.0 / rng)), 0, 255).astype(np.uint8)
        f.write(u.tobytes())
        return
    if fmt != "CM":
        raise ValueError(f"unknown compressed format {fmt!r}")

    def ftu(vals):  # FloatToUint16: truncating +0.499 round, clamped [0,1]
        frac = np.clip((vals - min_v) / rng, 0.0, 1.0)
        return (frac * 65535 + 0.499).astype(np.int64)

    sdata = np.sort(mat, axis=0)                              # [rows, cols]
    if rows >= 5:
        q = rows // 4
        u0 = np.minimum(ftu(sdata[0]), 65532)
        u25 = np.minimum(np.maximum(ftu(sdata[q]), u0 + 1), 65533)
        u75 = np.minimum(np.maximum(ftu(sdata[3 * q]), u25 + 1), 65534)
        u100 = np.maximum(ftu(sdata[rows - 1]), u75 + 1)
    else:  # fewer than 5 rows: use what exists, keep monotone (Kaldi branch)
        u0 = np.minimum(ftu(sdata[0]), 65532)
        u25 = np.minimum(np.maximum(
            ftu(sdata[1]) if rows > 1 else u0 + 1, u0 + 1), 65533)
        u75 = np.minimum(np.maximum(
            ftu(sdata[2]) if rows > 2 else u25 + 1, u25 + 1), 65534)
        u100 = np.maximum(ftu(sdata[3]) if rows > 3 else u75 + 1, u75 + 1)
    heads = np.stack([u0, u25, u75, u100], axis=1).astype("<u2")   # [cols, 4]
    f.write(heads.tobytes())
    # per-column decode anchors (Uint16ToFloat), then piecewise-linear encode
    p = min_v + heads.astype(np.float64) * (rng / 65535.0)         # [cols, 4]
    p0, p25, p75, p100 = (p[:, i:i + 1] for i in range(4))         # [cols, 1]
    v = mat.T                                                       # [cols, rows]
    lo = np.clip(np.floor((v - p0) / (p25 - p0) * 64 + 0.5), 0, 64)
    mid = np.clip(64 + np.floor((v - p25) / (p75 - p25) * 128 + 0.5), 64, 192)
    hi = np.clip(192 + np.floor((v - p75) / (p100 - p75) * 63 + 0.5), 192, 255)
    codes = np.where(v < p25, lo, np.where(v < p75, mid, hi)).astype(np.uint8)
    f.write(codes.tobytes())


def _write_compressed_auto(f, mat: np.ndarray):
    write_compressed_matrix(f, mat, fmt="auto")


def write_vector(f, vec: np.ndarray):
    vec = np.asarray(vec)
    if vec.dtype == np.float64:
        f.write(b"DV ")
        dt = "<f8"
    else:
        vec = vec.astype(np.float32)
        f.write(b"FV ")
        dt = "<f4"
    f.write(b"\x04" + struct.pack("<i", vec.shape[0]))
    f.write(np.ascontiguousarray(vec, dtype=dt).tobytes())


def read_vector(f) -> np.ndarray:
    tok = _read_token(f)
    if tok == "FV":
        dt, isz = "<f4", 4
    elif tok == "DV":
        dt, isz = "<f8", 8
    else:
        raise ValueError(f"unknown vector token {tok!r}")
    dim = _expect_int32(f)
    return np.frombuffer(f.read(dim * isz), dtype=dt).copy()


def write_int_vector(f, vec: np.ndarray):
    """Kaldi WriteIntegerVector<int32>: 1 byte sizeof, raw int32 size, raw data."""
    vec = np.asarray(vec, dtype="<i4")
    f.write(b"\x04")
    f.write(struct.pack("<i", vec.shape[0]))
    f.write(vec.tobytes())


def read_int_vector(f) -> np.ndarray:
    sz = f.read(1)
    if sz != b"\x04":
        raise ValueError(f"expected element size 4, got {sz!r}")
    n = struct.unpack("<i", f.read(4))[0]
    return np.frombuffer(f.read(4 * n), dtype="<i4").copy()


_WRITERS = {"mat": write_matrix, "vec": write_vector, "ivec": write_int_vector,
            "cmat": _write_compressed_auto}
_READERS = {"mat": read_matrix, "vec": read_vector, "ivec": read_int_vector}


# ---------------------------------------------------------------------------
# Ark/scp tables
# ---------------------------------------------------------------------------


class ArkWriter:
    """Write a binary ark (optionally with an scp index), Kaldi layout:
    ``key<space>\\0B<object>`` per record, scp offset pointing at ``\\0B``.
    """

    def __init__(self, ark_path: str, scp_path: str | None = None, kind: str = "mat"):
        self._f = open(ark_path, "wb")
        self._scp = open(scp_path, "w") if scp_path else None
        self._ark_path = ark_path
        self._write = _WRITERS[kind]

    def write(self, key: str, obj: np.ndarray):
        self._f.write(key.encode() + b" ")
        offset = self._f.tell()
        self._f.write(BINARY_MARKER)
        self._write(self._f, obj)
        if self._scp:
            self._scp.write(f"{key} {self._ark_path}:{offset}\n")

    def close(self):
        self._f.close()
        if self._scp:
            self._scp.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _open_maybe_gz(path: str):
    """Transparent gzip: real Kaldi alignment archives ship as ali.*.gz."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        import gzip

        return gzip.open(path, "rb")
    return open(path, "rb")


def read_ark(path: str, kind: str = "mat") -> Iterator[Tuple[str, np.ndarray]]:
    """Sequential reader over a binary ark file (gzipped arks supported)."""
    reader = _READERS[kind]
    with _open_maybe_gz(path) as f:
        while True:
            key = _read_token(f)
            if not key:
                break
            marker = f.read(2)
            if marker != BINARY_MARKER:
                raise ValueError(f"non-binary ark entry for key {key!r} (text arks: use read_text_ark)")
            yield key, reader(f)


def read_scp(path: str) -> Iterator[Tuple[str, str]]:
    """scp lines: ``key rxfilename[:offset]``."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, rx = line.split(None, 1)
            yield key, rx


def read_scp_entry(rx: str, kind: str = "mat") -> np.ndarray:
    """Read one object given an ``path[:offset]`` rxfilename."""
    reader = _READERS[kind]
    if ":" in rx and rx.rsplit(":", 1)[1].isdigit():
        path, off = rx.rsplit(":", 1)
        with open(path, "rb") as f:
            f.seek(int(off))
            marker = f.read(2)
            if marker != BINARY_MARKER:
                raise ValueError(f"bad scp offset into {path}")
            return reader(f)
    with open(rx, "rb") as f:
        marker = f.read(2)
        if marker == BINARY_MARKER:
            return reader(f)
    raise ValueError(f"cannot read object from {rx!r}")


class RandomAccessReader:
    """dict-like random access over an scp (lazy, file-seek based)."""

    def __init__(self, scp_path: str, kind: str = "mat"):
        self._entries = dict(read_scp(scp_path))
        self._kind = kind

    def __contains__(self, key):
        return key in self._entries

    def __getitem__(self, key) -> np.ndarray:
        return read_scp_entry(self._entries[key], self._kind)

    def keys(self):
        return self._entries.keys()

    def __len__(self):
        return len(self._entries)


# ---------------------------------------------------------------------------
# Text-mode tables (alignments and small vectors; handy for debugging)
# ---------------------------------------------------------------------------


def read_text_ark(path: str, dtype=np.int32) -> Iterator[Tuple[str, np.ndarray]]:
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            yield parts[0], np.asarray([dtype(x) for x in parts[1:]], dtype=dtype)


def write_text_ark(path: str, items):
    with open(path, "w") as f:
        for key, vec in items:
            f.write(key + " " + " ".join(str(int(x)) for x in np.asarray(vec).ravel()) + "\n")
