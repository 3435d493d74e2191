"""Speech dataset: corpus index + on-demand waveform/label loading.

Numpy copy of pykaldi2_tpu/data/dataset.py for the PyTorch port.
Transition-id alignments are mapped to pdf-ids through the port's
``graph/transition_model.py``; an enabled simulation block builds the port's
host-side ``simulation.Simulator``.

Reference behavior: the ``SpeechDataset``-style class in pykaldi2/data/
(SURVEY.md §3.1 "Dataset") — reads waveforms + frame alignments, applies the
on-the-fly Simulator, computes features, returns {utt_id, feat, label}.

Split here: the host dataset returns raw waveforms + labels (after the
host-side simulation, when it is on); featurization, and the on-device
simulation when ``simulation.on_device`` moves it there
(pipeline.build_frontend), happen inside the train step on the device, where
the front end runs kernel K1 (fbank) or K4 (MFCC). A "feats" mode reads
precomputed feature arks for Kaldi-artifact parity runs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from pykaldi2_tpu_torch.config import DataConfig, FrameOpts
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.data.wav import read_wav
from pykaldi2_tpu_torch.frontend.window import num_frames


@dataclasses.dataclass
class Utterance:
    utt_id: str
    wave: Optional[np.ndarray]      # [n_samples] float32 (int16 range), or None in feats mode
    feats: Optional[np.ndarray]     # [T, D] float32 in feats mode
    labels: Optional[np.ndarray]    # [T] int32 pdf-ids, or None (decode-only)
    num_frames: int


class SpeechDataset:
    """Indexable corpus of (waveform|features, frame labels).

    Args:
      wav_scp: path to ``utt_id wav_path`` scp (wave mode), or None.
      feats_scp: path to feature-matrix scp (feats mode), or None.
      ali: path to alignment ark (binary int-vector ark or text ark); labels
        must already be pdf-ids unless ``tid_to_pdf`` is given.
      frame_opts: used to derive frame counts from waveform lengths.
      simulate_fn: optional host-side callable wave→wave (a Simulator;
        ``simulation.on_device`` moves all but speed perturbation into the
        train step instead).
      tid_to_pdf: optional int array mapping transition-ids → pdf-ids.
    """

    def __init__(
        self,
        wav_scp: Optional[str] = None,
        feats_scp: Optional[str] = None,
        ali: Optional[str] = None,
        frame_opts: Optional[FrameOpts] = None,
        simulate_fn: Optional[Callable] = None,
        tid_to_pdf: Optional[np.ndarray] = None,
    ):
        if (wav_scp is None) == (feats_scp is None):
            raise ValueError("exactly one of wav_scp / feats_scp required")
        self.frame_opts = frame_opts or FrameOpts()
        self.simulate_fn = simulate_fn
        self._h5 = None
        self.mode = "wave" if wav_scp else "feats"
        self._entries = dict(kaldi_io.read_scp(wav_scp or feats_scp))
        self.labels: Optional[dict] = None
        if ali is not None:
            self.labels = _read_label_ark(ali, tid_to_pdf)
            self.utt_ids = [u for u in self._entries if u in self.labels]
        else:
            self.utt_ids = list(self._entries)
        self._frame_counts: dict = {}

    @classmethod
    def from_config(cls, cfg: DataConfig, simulate_fn=None, tid_to_pdf=None):
        frame_opts = cfg.feat.fbank.frame_opts if cfg.feat.type == "fbank" else cfg.feat.mfcc.frame_opts
        if simulate_fn is None and cfg.simulation.enabled:
            from pykaldi2_tpu_torch.simulation.simulator import Simulator

            simulate_fn = Simulator(cfg.simulation, samp_freq=frame_opts.samp_freq,
                                    frame_shift=frame_opts.window_shift)
        if tid_to_pdf is None and cfg.label_ark and not cfg.ali_are_pdf_ids:
            # transition-id alignments must be mapped tid→pdf before training,
            # or the loss gathers rows by transition-ids as if they were pdfs
            if not cfg.trans_model:
                raise ValueError(
                    "data.ali_are_pdf_ids is false but data.trans_model is unset; "
                    "a TransitionModel is required to map transition-ids to pdf-ids")
            from pykaldi2_tpu_torch.graph.transition_model import TransitionModel

            tid_to_pdf = TransitionModel.read_kaldi(cfg.trans_model).tid_to_pdf_array()
        if cfg.hdf5:
            if cfg.wav_scp or cfg.feats_scp:
                raise ValueError("configure either data.hdf5 or "
                                 "data.wav_scp/feats_scp, not both")
            ds = cls.from_hdf5(cfg.hdf5, kind=cfg.hdf5_kind,
                               frame_opts=frame_opts, simulate_fn=simulate_fn)
            if cfg.label_ark:
                # external alignments override matching archive labels and
                # add new ones; archive-only labels are kept
                labels = dict(ds.labels or {})
                labels.update(_read_label_ark(cfg.label_ark, tid_to_pdf))
                ds.labels = labels
                ds.utt_ids = [u for u in ds._entries if u in labels]
            return ds
        return cls(
            wav_scp=cfg.wav_scp,
            feats_scp=cfg.feats_scp,
            ali=cfg.label_ark,
            frame_opts=frame_opts,
            simulate_fn=simulate_fn,
            tid_to_pdf=tid_to_pdf,
        )

    def __len__(self):
        return len(self.utt_ids)

    def utt_num_frames(self, utt_id: str) -> int:
        """Frame count, from the alignment when available (cheap), else the wav."""
        if utt_id in self._frame_counts:
            return self._frame_counts[utt_id]
        if self.labels is not None and utt_id in self.labels:
            nf = len(self.labels[utt_id])
        elif getattr(self, "_h5", None) is not None:
            arr, _ = self._h5.get(utt_id)
            nf = (arr.shape[0] if self.mode == "feats"
                  else num_frames(arr.shape[-1], self.frame_opts))
        elif self.mode == "feats":
            nf = kaldi_io.read_scp_entry(self._entries[utt_id], "mat").shape[0]
        else:
            wave, _ = read_wav(self._entries[utt_id])
            nf = num_frames(wave.shape[-1], self.frame_opts)
        self._frame_counts[utt_id] = nf
        return nf

    def get(self, utt_id: str, rng: Optional[np.random.RandomState] = None) -> Utterance:
        labels = self.labels.get(utt_id) if self.labels is not None else None
        if getattr(self, "_h5", None) is not None:
            arr, _ = self._h5.get(utt_id)
            if self.mode == "feats":
                nf = arr.shape[0]
                if labels is not None:
                    nf = min(nf, len(labels))
                    arr, labels = arr[:nf], labels[:nf]
                return Utterance(utt_id, None, arr, labels, nf)
            wave = arr
            if self.simulate_fn is not None:
                if labels is not None and hasattr(self.simulate_fn, "simulate_with_labels"):
                    wave, labels = self.simulate_fn.simulate_with_labels(wave, labels, rng)
                else:
                    wave = self.simulate_fn(wave, rng)
            nf = num_frames(wave.shape[-1], self.frame_opts)
            if labels is not None:
                nf = min(nf, len(labels))
                labels = labels[:nf]
            return Utterance(utt_id, wave.astype(np.float32), None, labels, nf)
        if self.mode == "feats":
            feats = kaldi_io.read_scp_entry(self._entries[utt_id], "mat").astype(np.float32)
            nf = feats.shape[0]
            if labels is not None:
                nf = min(nf, len(labels))
                feats, labels = feats[:nf], labels[:nf]
            return Utterance(utt_id, None, feats, labels, nf)
        wave, _rate = read_wav(self._entries[utt_id])
        if wave.ndim > 1:
            wave = wave[:, 0]
        if self.simulate_fn is not None:
            # simulators that change duration (speed perturb) remap labels too
            if labels is not None and hasattr(self.simulate_fn, "simulate_with_labels"):
                wave, labels = self.simulate_fn.simulate_with_labels(wave, labels, rng)
            else:
                wave = self.simulate_fn(wave, rng)
        nf = num_frames(wave.shape[-1], self.frame_opts)
        if labels is not None:
            # alignments and snip-edges frame counts can differ by a frame or two
            nf = min(nf, len(labels))
            labels = labels[:nf]
        return Utterance(utt_id, wave.astype(np.float32), None, labels, nf)

    def __getitem__(self, i: int) -> Utterance:
        return self.get(self.utt_ids[i])

    @classmethod
    def from_hdf5(cls, path: str, kind: str = "wave",
                  frame_opts: Optional[FrameOpts] = None, simulate_fn=None):
        """Corpus from an hdf5 archive (data/hdf5_io.py layout)."""
        from pykaldi2_tpu_torch.data.hdf5_io import Hdf5Corpus

        corpus = Hdf5Corpus(path, kind)
        self = cls.__new__(cls)
        self.frame_opts = frame_opts or FrameOpts()
        self.simulate_fn = simulate_fn
        self.mode = "wave" if kind == "wave" else "feats"
        self._entries = {u: u for u in corpus.keys()}
        self._h5 = corpus
        self.labels = {}
        for u in corpus.keys():
            _, lab = corpus.get(u)
            if lab is not None:
                self.labels[u] = lab
        if not self.labels:
            self.labels = None
        self.utt_ids = list(self._entries)
        self._frame_counts = {}
        return self


def _read_label_ark(path: str, tid_to_pdf=None) -> dict:
    """utt → int32 pdf labels from a (text|binary, optionally gzipped)
    alignment ark, mapping transition-ids when tid_to_pdf is given."""
    reader = (kaldi_io.read_text_ark(path) if _looks_text(path)
              else kaldi_io.read_ark(path, kind="ivec"))
    labels = {}
    for key, vec in reader:
        if tid_to_pdf is not None:
            vec = tid_to_pdf[vec]
        labels[key] = vec.astype(np.int32)
    return labels


def _looks_text(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(512)
    return b"\0" not in head
