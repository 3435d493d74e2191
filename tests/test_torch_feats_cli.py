"""The port's ``bin/compute_cmvn_stats`` and ``bin/compute_feats`` CLIs
against the JAX package's, on the toy corpus, for fbank and MFCC features.

Both run on the CPU here (``device="cpu"``): the port through K1's and K4's
plain versions, the JAX package through its XLA front end. The features
agree to fp32 summation-order noise: ~1e-4 on log-mels and cepstra (up to
~100 in c0, atol 1e-3), so the stats (sums over all frames of features and
their squares) agree to rtol 1e-4. Compressed records are 8-bit
percentile codes: the two decoded matrices agree to within one
quantisation step of the column (at most its range over 63 codes) plus one
step of the header's 16-bit grid.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from pykaldi2_tpu.bin import compute_cmvn_stats as jax_stats_cli
from pykaldi2_tpu.bin import compute_feats as jax_feats_cli

from pykaldi2_tpu_torch.bin import compute_cmvn_stats, compute_feats
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.frontend import fused as FU
from pykaldi2_tpu_torch.pipeline import load_cmvn_stats

from toydata import make_toy_corpus

FEATS = {
    "fbank": {"fbank": {"frame_opts": {"dither": 0.0}, "mel_opts": {"num_bins": 24}}},
    # 13 cepstra over 23 bins with energy (Kaldi's default MFCC)
    "mfcc": {"type": "mfcc", "mfcc": {"frame_opts": {"dither": 0.0}}},
    # egs/librispeech/s5/conf/mfcc_hires.conf
    "mfcc_hires": {"type": "mfcc", "mfcc": {
        "frame_opts": {"dither": 0.0}, "num_ceps": 40, "use_energy": False,
        "mel_opts": {"num_bins": 40, "low_freq": 20.0, "high_freq": -400.0}}},
}
FEAT_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("feats_cli")
    paths = make_toy_corpus(str(root / "corpus"), num_utts=4, num_pdfs=3, seed=21)
    spk2utt = root / "spk2utt"
    spk2utt.write_text("spkA utt000 utt002\nspkB utt001 utt003\n")
    data = {}
    for name, feat in FEATS.items():
        p = root / f"{name}.yaml"
        p.write_text(yaml.safe_dump({"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
                                     "feat": feat}))
        data[name] = str(p)
    return root, data, str(spk2utt)


def _ark(path):
    return dict(kaldi_io.read_ark(path))


@pytest.mark.parametrize("feat", sorted(FEATS))
def test_compute_cmvn_stats_global_matches_jax(corpus, tmp_path, feat):
    _, data, _ = corpus
    got, ref = str(tmp_path / "port.mat"), str(tmp_path / "jax.mat")
    assert compute_cmvn_stats.main(["-data", data[feat], "-output", got], device="cpu") == 0
    assert jax_stats_cli.main(["-data", data[feat], "-output", ref]) == 0
    a, b = load_cmvn_stats(got), load_cmvn_stats(ref)
    assert a.shape == b.shape
    assert a[0, -1] == b[0, -1] > 0                # the same frame count
    np.testing.assert_allclose(a, b, rtol=1e-4)


@pytest.mark.parametrize("feat", ["fbank", "mfcc"])
def test_compute_cmvn_stats_per_speaker_matches_jax(corpus, tmp_path, feat):
    _, data, spk2utt = corpus
    got, ref = str(tmp_path / "port.ark"), str(tmp_path / "jax.ark")
    assert compute_cmvn_stats.main(["-data", data[feat], "-output", got, "-spk2utt", spk2utt],
                                   device="cpu") == 0
    assert jax_stats_cli.main(["-data", data[feat], "-output", ref, "-spk2utt", spk2utt]) == 0
    a, b = _ark(got), _ark(ref)
    assert sorted(a) == sorted(b) == ["spkA", "spkB"]
    for spk in a:
        np.testing.assert_allclose(a[spk], b[spk], rtol=1e-4)
    # the scp index resolves to the same records
    for key, rx in kaldi_io.read_scp(got + ".scp"):
        np.testing.assert_array_equal(kaldi_io.read_scp_entry(rx), a[key])


@pytest.mark.parametrize("feat", sorted(FEATS))
def test_compute_feats_matches_jax(corpus, tmp_path, feat):
    _, data, _ = corpus
    got, ref = str(tmp_path / "port.ark"), str(tmp_path / "jax.ark")
    assert compute_feats.main(["-data", data[feat], "-out", got, "-dither", "0"],
                              device="cpu") == 0
    assert jax_feats_cli.main(["-data", data[feat], "-out", ref, "-dither", "0"]) == 0
    a, b = _ark(got), _ark(ref)
    assert list(a) == list(b) and len(a) == 4
    for uid in a:
        assert a[uid].shape == b[uid].shape
        np.testing.assert_allclose(a[uid], b[uid], **FEAT_TOL)
    assert os.path.exists(str(tmp_path / "port.scp"))
    # padding to a power of two and slicing the frames off changes nothing:
    # the first utterance against K4's (K1's) plain version on its own samples
    if feat != "fbank":
        from pykaldi2_tpu_torch.config import load_data_config
        from pykaldi2_tpu_torch.data.dataset import SpeechDataset

        cfg = load_data_config(data[feat])
        utt = SpeechDataset.from_config(cfg).get("utt000")
        want = FU.fused_mfcc_plain(torch.from_numpy(utt.wave[None]), cfg.feat.mfcc)[0]
        np.testing.assert_allclose(a["utt000"], want.numpy(), **FEAT_TOL)


@pytest.mark.parametrize("feat", ["fbank", "mfcc"])
def test_compute_feats_compressed_matches_jax(corpus, tmp_path, feat):
    _, data, _ = corpus
    got, ref = str(tmp_path / "port.ark"), str(tmp_path / "jax.ark")
    assert compute_feats.main(["-data", data[feat], "-out", got, "-compress"],
                              device="cpu") == 0
    assert jax_feats_cli.main(["-data", data[feat], "-out", ref, "-compress"]) == 0
    with open(got, "rb") as f:
        assert b"CM " in f.read()                  # percentile-coded records
    a, b = _ark(got), _ark(ref)
    assert list(a) == list(b)
    for uid in a:
        col_range = b[uid].max(axis=0) - b[uid].min(axis=0)
        header_step = (b[uid].max() - b[uid].min()) / 65535.0
        step = col_range / 63.0 + header_step
        assert np.all(np.abs(a[uid] - b[uid]) <= step[None, :] + 1e-6), uid


def test_feats_clis_need_cuda_unless_cpu_requested(corpus, tmp_path, monkeypatch):
    _, data, _ = corpus
    monkeypatch.delenv("PK2_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_cmvn_stats.main(["-data", data["mfcc"], "-output", str(tmp_path / "s.mat")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_feats.main(["-data", data["mfcc"], "-out", str(tmp_path / "f.ark")])
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    assert compute_feats.main(["-data", data["mfcc"], "-out", str(tmp_path / "f.ark")]) == 0
