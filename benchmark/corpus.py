"""Seeded synthetic corpus for the CE traffic mixes: random 16 kHz PCM16
audio and random pdf-id alignments, written as ``wav.scp`` plus a binary
Kaldi int-vector ark, the inputs the recipe's loaders read.

A mix file gives the number of distinct wav files, their length range in
frames, the amplitude and ``epoch_utts``, the utterance ids of an epoch,
each pointing at file ``i % files`` with that file's labels. A driver starts
the next epoch where one ends, as the recipe's epoch loop does, so no rate
of the program can run a window out of data. Every seed draws the same
lengths (from the mix's own seed), so the work of a run does not depend on
the seed: in
another order of the files, or, with ``fixed_order``, with file i always
of the same length (a mix whose steps each take whole utterances, and whose
loader then takes a fixed order too).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

FRAME_SHIFT, FRAME_LENGTH, SAMP_FREQ = 160, 400, 16000


def samples_for_frames(nf: int) -> int:
    """Samples whose snip-edges framing gives exactly ``nf`` frames."""
    return FRAME_LENGTH + (nf - 1) * FRAME_SHIFT


@dataclass
class Corpus:
    root: str
    wav_scp: str
    label_ark: str
    waves: list          # per file: int16 samples
    labels: list         # per file: int32 pdf-ids, one a frame
    index: list          # per utterance id: file number


def file_lengths(mix: dict) -> np.ndarray:
    """Frames of each distinct file: the same for every seed."""
    rng = np.random.default_rng(int(mix["length_seed"]))
    return rng.integers(int(mix["frames_min"]), int(mix["frames_max"]) + 1,
                        int(mix["files"]))


def make(root: str, mix: dict, seed: int, num_labels: int) -> Corpus:
    """Write the corpus of ``seed`` under ``root``."""
    rng = np.random.default_rng(seed)
    lengths = file_lengths(mix)
    if not mix.get("fixed_order", False):
        lengths = rng.permutation(lengths)
    amp = float(mix["amplitude"])
    os.makedirs(os.path.join(root, "wav"), exist_ok=True)
    waves, labels, paths = [], [], []
    for i, nf in enumerate(lengths):
        n = samples_for_frames(int(nf))
        wave = np.clip(np.rint(rng.standard_normal(n, dtype=np.float32) * amp),
                       -32768, 32767).astype(np.int16)
        path = os.path.join(root, "wav", f"f{i:04d}.wav")
        _write_wav(path, wave)
        waves.append(wave)
        labels.append(rng.integers(0, num_labels, int(nf)).astype(np.int32))
        paths.append(path)
    index = [j % len(waves) for j in range(int(mix["epoch_utts"]))]
    scp = os.path.join(root, "wav.scp")
    ark = os.path.join(root, "ali.ark")
    with open(scp, "w") as f:
        f.writelines(f"u{j:07d} {paths[k]}\n" for j, k in enumerate(index))
    with open(ark, "wb") as f:
        for j, k in enumerate(index):
            lab = labels[k]
            f.write(f"u{j:07d} ".encode() + b"\0B\x04" + struct.pack("<i", lab.shape[0])
                    + lab.astype("<i4").tobytes())
    return Corpus(root, scp, ark, waves, labels, index)


def _write_wav(path: str, wave: np.ndarray) -> None:
    data = wave.astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 1, SAMP_FREQ, 2 * SAMP_FREQ, 2, 16))
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)
