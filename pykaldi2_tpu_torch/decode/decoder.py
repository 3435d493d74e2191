"""ctypes binding of the native lattice decoder (native/latdec.cc).

Port of pykaldi2_tpu/decode/decoder.py: the same C ABI (``latdec_new``,
``latdec_decode``, ``latdec_search``, ``latdec_emit_lattice``,
``latdec_free``, and ``banded_trim_extract`` for the device search's
epilogue, decode/device_lattice.py), loaded from the
port's own build. At first use (or when the source is newer) ``g++`` compiles
``native/latdec.cc`` into ``build/native/liblatdec.so`` at the repository
root, without ``-march=native``, so the library runs on whichever x86-64 host
built it; the committed ``native/liblatdec.so`` is never loaded. The C++
search releases the GIL (ctypes), so one decoder handle per thread decodes
utterances in parallel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.ops.fsa import DenseFsa

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "latdec.cc"
LIB_PATH = _ROOT / "build" / "native" / "liblatdec.so"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_lock = threading.Lock()


def build_native(force: bool = False) -> Path:
    """Compile native/latdec.cc into build/native/liblatdec.so if missing,
    stale or ``force``; returns the library path."""
    stale = (not LIB_PATH.exists()
             or SOURCE.stat().st_mtime > LIB_PATH.stat().st_mtime)
    if force or stale:
        LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
        tmp = LIB_PATH.with_suffix(f".{os.getpid()}.tmp.so")
        out = subprocess.run(["g++", *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SOURCE} (exit {out.returncode}):\n"
                               f"{out.stderr}")
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent build never sees half a file
    return LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native()))
        ip = ctypes.POINTER(ctypes.c_int)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.latdec_new.restype = ctypes.c_void_p
        lib.latdec_new.argtypes = [ctypes.c_int, ctypes.c_int, ip, ip, ip, ip, fp,
                                   ctypes.c_int, fp, ctypes.c_float, ctypes.c_int,
                                   ctypes.c_float]
        lib.latdec_free.argtypes = [ctypes.c_void_p]
        lib.latdec_decode.restype = ctypes.c_int
        lib.latdec_decode.argtypes = [ctypes.c_void_p, fp, ctypes.c_int, ctypes.c_int,
                                      ip, ctypes.c_int, ip, fp]
        lib.latdec_search.restype = ctypes.c_int
        lib.latdec_search.argtypes = [ctypes.c_void_p, fp, ctypes.c_int,
                                      ctypes.c_int, ip, ip, fp]
        lib.latdec_emit_lattice.restype = ctypes.c_int
        lib.latdec_emit_lattice.argtypes = [
            ctypes.c_void_p, ip, ip, ip, fp, ctypes.c_int, ip, fp, ctypes.c_int,
            ip, ip, ip]
        lib.banded_trim_extract.restype = ctypes.c_int
        lib.banded_trim_extract.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ip, ip, fp, ip, fp,
            ip, ctypes.c_float, ip, ip, ip, ip, ip, fp, ip, ip, ip]
        _lib = lib
        return lib


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class LatticeDecoder:
    """Beam decoder over a pdf-labeled FST (``graph.compile.expand_to_pdf_fst``).

    Equivalent to the reference's MappedLatticeFasterRecognizer usage: feed
    acoustic-scaled pseudo-log-likelihoods, get words / alignments, or
    time-synchronous lattices as DenseFsa (for the banded forward-backward
    and the word-lattice tools). One handle is stateful: use one per thread.
    """

    def __init__(self, graph, beam: float = 16.0, max_active: int = 7000,
                 lattice_beam: float = 8.0, word_penalty: float = 0.0):
        """graph: an ``Fst`` or a ``graph.vfst.VectorFst`` (HCLG-scale arc
        tables load without per-arc Python). word_penalty: insertion penalty
        added to every word-emitting arc. Epsilon (ilabel==0) arcs must carry
        olabel==0: the C++ traceback reads word labels off emitting arcs
        only."""
        lib = _load()
        if isinstance(graph, Fst):
            src, dst, il, ol, wt = [], [], [], [], []
            for s in range(graph.num_states):
                for a in graph.arcs[s]:
                    src.append(s)
                    dst.append(a.nextstate)
                    il.append(a.ilabel)
                    ol.append(a.olabel)
                    wt.append(a.weight)
            il = np.asarray(il, np.int32)
            ol = np.asarray(ol, np.int32)
            wt = np.asarray(wt, np.float32)
            finals = np.full(graph.num_states, np.inf, np.float32)
            for s, w in graph.finals.items():
                finals[s] = -w
        else:  # VectorFst arc table
            src, dst, il, ol, wt = graph.src, graph.dst, graph.ilabel, graph.olabel, graph.weight
            finals = np.where(np.isfinite(graph.final), -graph.final,
                              np.float32(np.inf)).astype(np.float32)
        bad = (il == 0) & (ol != 0)
        if bad.any():
            raise ValueError(f"{int(bad.sum())} epsilon-input arcs carry word "
                             "olabels; push words onto emitting arcs first")
        cost = -wt + np.where(ol != 0, np.float32(word_penalty), np.float32(0.0))
        self._src = np.ascontiguousarray(src, np.int32)
        self._dst = np.ascontiguousarray(dst, np.int32)
        self._il = np.ascontiguousarray(il, np.int32)
        self._ol = np.ascontiguousarray(ol, np.int32)
        self._cost = np.ascontiguousarray(cost, np.float32)
        self._finals = np.ascontiguousarray(finals, np.float32)
        self._h = lib.latdec_new(
            graph.num_states, graph.start, _iptr(self._src), _iptr(self._dst),
            _iptr(self._il), _iptr(self._ol), _fptr(self._cost),
            len(self._src), _fptr(self._finals),
            ctypes.c_float(beam), int(max_active), ctypes.c_float(lattice_beam))
        self._lib = lib

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.latdec_free(self._h)
            self._h = None

    def decode(self, loglikes: np.ndarray) -> Tuple[List[int], np.ndarray, float]:
        """loglikes [T, P] (scaled) → (word ids, per-frame pdfs [T], log score)."""
        ll = np.ascontiguousarray(loglikes, np.float32)
        t, p = ll.shape
        max_words = t + 1
        words = np.zeros(max_words, np.int32)
        pdfs = np.zeros(t, np.int32)
        score = ctypes.c_float()
        n = self._lib.latdec_decode(self._h, _fptr(ll), t, p, _iptr(words), max_words,
                                    _iptr(pdfs), ctypes.byref(score))
        if n < 0:
            raise RuntimeError("decoding failed (no surviving tokens — widen beam?)")
        return words[:n].tolist(), pdfs, float(score.value)

    def decode_lattice(self, loglikes: np.ndarray, with_frames: bool = False):
        """loglikes [T, P] → (time-synchronous lattice as DenseFsa, best score).

        The lattice's arc weights are graph scores only; the forward-backward
        adds the same obs matrix. ``with_frames=True`` also returns each
        lattice state's frame index [S] for ops/fb_lattice.pack_time_sync.
        """
        ll = np.ascontiguousarray(loglikes, np.float32)
        t, p = ll.shape
        # search once — it reports the exact lattice size, emit fills
        # exactly-sized buffers
        n_arcs = ctypes.c_int()
        n_states = ctypes.c_int()
        score = ctypes.c_float()
        rc = self._lib.latdec_search(self._h, _fptr(ll), t, p, ctypes.byref(n_arcs),
                                     ctypes.byref(n_states), ctypes.byref(score))
        if rc != 0:
            raise RuntimeError("lattice decoding failed (no surviving tokens)")
        na, ns = n_arcs.value, n_states.value
        src = np.zeros(na, np.int32)
        dst = np.zeros(na, np.int32)
        pdf = np.zeros(na, np.int32)
        w = np.zeros(na, np.float32)
        finals = np.zeros(ns, np.float32)
        frames = np.zeros(ns, np.int32)
        olabel = np.zeros(na, np.int32)
        rc = self._lib.latdec_emit_lattice(
            self._h, _iptr(src), _iptr(dst), _iptr(pdf), _fptr(w), na,
            ctypes.byref(n_arcs), _fptr(finals), ns, ctypes.byref(n_states),
            _iptr(frames), _iptr(olabel))
        if rc != 0:
            raise RuntimeError(f"lattice emit failed (rc={rc})")
        fsa = DenseFsa(ns, src, dst, pdf, w, finals, 0, olabel=olabel).validate()
        if with_frames:
            return fsa, frames, float(score.value)
        return fsa, float(score.value)
