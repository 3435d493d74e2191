"""Minimal pure-Python WAV codec (PCM16/PCM32/IEEE-float, mono or multichannel).

Replaces the reference's reliance on external wav readers in
pykaldi2/reader/ (SURVEY.md §3.1 "Readers / IO"). Returns float32 waveforms
in Kaldi's convention: sample values in the int16 range (±32768), NOT
normalized to ±1 — Kaldi front-end dither/energy semantics assume this scale.
"""

from __future__ import annotations

import io
import struct

import numpy as np


def read_wav(path_or_bytes, normalize: bool = False):
    """Read a RIFF WAV file → (waveform [n] or [n, ch] float32, sample_rate).

    ``normalize=False`` (default) keeps int16-range amplitudes like Kaldi.
    Paths of the form ``archive.zip:member.wav`` read from zip archives
    (the reference's zip-of-wav storage, SURVEY.md §3.1 "Readers / IO").
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = io.BytesIO(path_or_bytes)
    elif isinstance(path_or_bytes, str) and path_or_bytes.rstrip().endswith("|"):
        # Kaldi piped rxfilename: "flac -dcs utt.flac |" — run it, read stdout
        import subprocess

        out = subprocess.run(path_or_bytes.rstrip()[:-1], shell=True,
                             capture_output=True, check=True)
        f = io.BytesIO(out.stdout)
    elif isinstance(path_or_bytes, str) and ".zip:" in path_or_bytes:
        import zipfile

        zpath, member = path_or_bytes.split(".zip:", 1)
        with zipfile.ZipFile(zpath + ".zip") as z:
            f = io.BytesIO(z.read(member))
    else:
        f = open(path_or_bytes, "rb")
    try:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, chunk_size = struct.unpack("<4sI", hdr)
            if chunk_id == b"fmt ":
                fmt = f.read(chunk_size)
            elif chunk_id == b"data":
                data = f.read(chunk_size)
            else:
                f.seek(chunk_size + (chunk_size & 1), 1)
            if fmt is not None and data is not None:
                break
        if fmt is None or data is None:
            raise ValueError("missing fmt or data chunk")
        audio_fmt, channels, rate, _br, _ba, bits = struct.unpack("<HHIIHH", fmt[:16])
        if audio_fmt == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
            audio_fmt = struct.unpack("<H", fmt[24:26])[0]
        if audio_fmt == 1:  # PCM
            if bits == 16:
                x = np.frombuffer(data, dtype="<i2").astype(np.float32)
            elif bits == 32:
                x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 65536.0
            elif bits == 8:
                x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) * 256.0
            else:
                raise ValueError(f"unsupported PCM bit depth {bits}")
        elif audio_fmt == 3:  # IEEE float, assumed ±1 → int16 range
            x = np.frombuffer(data, dtype="<f4").astype(np.float32) * 32768.0
        else:
            raise ValueError(f"unsupported WAV format code {audio_fmt}")
        if channels > 1:
            x = x.reshape(-1, channels)
        if normalize:
            x = x / 32768.0
        return x, rate
    finally:
        f.close()


def write_wav(path, wave: np.ndarray, sample_rate: int = 16000):
    """Write float32 (int16-range) or int16 waveform as PCM16 WAV."""
    wave = np.asarray(wave)
    if wave.ndim == 1:
        channels = 1
    else:
        channels = wave.shape[1]
    if wave.dtype != np.int16:
        wave = np.clip(np.rint(wave), -32768, 32767).astype(np.int16)
    data = wave.reshape(-1).tobytes()
    byte_rate = sample_rate * channels * 2
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", 1, channels, sample_rate, byte_rate, channels * 2, 16))
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)
