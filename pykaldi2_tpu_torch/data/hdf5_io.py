"""HDF5 corpus archives (reference's hdf5 wave/label store, SURVEY.md §3.1).

Layout: one dataset per utterance under /wave, /feats, /labels groups, e.g.
    /wave/utt001   float32 [n_samples]      (int16-range amplitudes)
    /labels/utt001 int32   [n_frames]
Use ``write_corpus`` to build archives and ``Hdf5Corpus`` to read them; the
dataset layer accepts ``hdf5`` paths wherever scp files are accepted via
``SpeechDataset.from_hdf5``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np


def write_corpus(path: str, utts: Iterable[tuple], kind: str = "wave"):
    """utts: iterable of (utt_id, array[, labels]) tuples."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group(kind)
        lab = None
        for item in utts:
            if len(item) == 3:
                uid, arr, labels = item
                if lab is None:
                    lab = f.require_group("labels")
                lab.create_dataset(uid, data=np.asarray(labels, np.int32))
            else:
                uid, arr = item
            g.create_dataset(uid, data=np.asarray(arr, np.float32))


class Hdf5Corpus:
    """Lazy reader over an archive written by ``write_corpus``."""

    def __init__(self, path: str, kind: str = "wave"):
        import h5py

        self._f = h5py.File(path, "r")
        if kind not in self._f:
            raise ValueError(f"{path} has no /{kind} group")
        self._g = self._f[kind]
        self._labels = self._f["labels"] if "labels" in self._f else None
        self.kind = kind

    def keys(self):
        return list(self._g.keys())

    def __contains__(self, uid):
        return uid in self._g

    def get(self, uid: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        arr = np.asarray(self._g[uid], np.float32)
        labels = None
        if self._labels is not None and uid in self._labels:
            labels = np.asarray(self._labels[uid], np.int32)
        return arr, labels

    def close(self):
        self._f.close()
