"""Data layer of the PyTorch port against pykaldi2_tpu.data.

The host modules are numpy copies, so the comparisons are exact: the same
corpus, seed and loader options give bit-identical batches in both packages.
"""

import numpy as np
import pytest
import torch

from pykaldi2_tpu.config import FrameOpts as JFrameOpts
from pykaldi2_tpu.data import kaldi_io as jkio
from pykaldi2_tpu.data.dataloader import BucketSpec as JBucketSpec
from pykaldi2_tpu.data.dataloader import ChunkDataloader as JChunk
from pykaldi2_tpu.data.dataloader import SeqDataloader as JSeq
from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset

from pykaldi2_tpu_torch.config import DataConfig, FrameOpts
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.data.dataloader import BucketSpec, ChunkDataloader, SeqDataloader
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.data.prefetch import device_prefetch
from pykaldi2_tpu_torch.data.wav import read_wav

from toydata import make_toy_corpus


def _assert_same_batches(a_iter, b_iter):
    a, b = list(a_iter), list(b_iter)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k], k


@pytest.fixture
def corpus(tmp_path):
    paths = make_toy_corpus(str(tmp_path), num_utts=7, min_sec=0.5, max_sec=2.5, seed=11)
    fo, jfo = FrameOpts(dither=0.0), JFrameOpts(dither=0.0)
    ds = SpeechDataset(wav_scp=paths["wav_scp"], ali=paths["ali"], frame_opts=fo)
    jds = JDataset(wav_scp=paths["wav_scp"], ali=paths["ali"], frame_opts=jfo)
    return paths, ds, jds


@pytest.mark.parametrize("kw", [
    dict(shuffle=True, seed=3),
    dict(shuffle=False),
    dict(shuffle=True, seed=5, chunk_overlap=10),
    dict(shuffle=False, drop_last=True),
    dict(shuffle=True, seed=1, rank=1, world_size=2),
    dict(shuffle=True, seed=2, num_workers=2),
])
def test_chunk_loader_yields_identical_batches(corpus, kw):
    _, ds, jds = corpus
    for epoch in (0, 1):
        a = ChunkDataloader(ds, batch_size=3, chunk_len=40, **kw)
        b = JChunk(jds, batch_size=3, chunk_len=40, **kw)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert a.num_batches() == b.num_batches()
        _assert_same_batches(a, b)


def test_seq_loader_yields_identical_batches(corpus):
    _, ds, jds = corpus
    a = SeqDataloader(ds, BucketSpec((100, 200, 300), (2, 2, 1)), shuffle=True, seed=4)
    b = JSeq(jds, JBucketSpec((100, 200, 300), (2, 2, 1)), shuffle=True, seed=4)
    _assert_same_batches(a, b)


def test_dataset_utterances_identical(corpus):
    _, ds, jds = corpus
    assert ds.utt_ids == jds.utt_ids
    for u in ds.utt_ids:
        x, y = ds.get(u), jds.get(u)
        np.testing.assert_array_equal(x.wave, y.wave)
        np.testing.assert_array_equal(x.labels, y.labels)
        assert x.num_frames == y.num_frames == ds.utt_num_frames(u)


def test_kaldi_io_cross_package_roundtrip(tmp_path):
    rng = np.random.RandomState(12)
    mats = {f"u{i}": rng.randn(9 + i, 5).astype(np.float32) for i in range(3)}
    for writer_mod, reader_mod in ((kaldi_io, jkio), (jkio, kaldi_io)):
        ark, scp = str(tmp_path / "m.ark"), str(tmp_path / "m.scp")
        with writer_mod.ArkWriter(ark, scp, kind="mat") as w:
            for k, v in mats.items():
                w.write(k, v)
        for k, rx in reader_mod.read_scp(scp):
            np.testing.assert_array_equal(reader_mod.read_scp_entry(rx, "mat"), mats[k])
        buf = str(tmp_path / "c.ark")
        with open(buf, "wb") as f:
            writer_mod.write_compressed_matrix(f, mats["u2"], fmt="CM")
        with open(buf, "rb") as f:
            got = reader_mod.read_matrix(f)
        with open(buf, "rb") as f:
            want = writer_mod.read_matrix(f)
        np.testing.assert_array_equal(got, want)


def test_wav_reader_matches(corpus):
    from pykaldi2_tpu.data.wav import read_wav as jread

    paths, _, _ = corpus
    for line in open(paths["wav_scp"]):
        p = line.split()[1]
        a, ra = read_wav(p)
        b, rb = jread(p)
        assert ra == rb
        np.testing.assert_array_equal(a, b)


def test_unported_dataset_options_raise(corpus):
    paths, _, _ = corpus
    cfg = DataConfig(wav_scp=paths["wav_scp"], label_ark=paths["ali"])
    cfg.simulation.enabled = True
    with pytest.raises(NotImplementedError, match="simulation"):
        SpeechDataset.from_config(cfg)


@pytest.mark.parametrize("text_ark", [False, True])
def test_transition_id_alignments_map_like_jax(corpus, tmp_path, text_ark):
    """Transition-id alignments (``ali_are_pdf_ids: false``) read through a
    final.mdl written by the port's ``TransitionModel.write_kaldi`` give both
    packages' ``SpeechDataset.from_config`` the same pdf labels; without
    ``trans_model`` both raise."""
    from pykaldi2_tpu.config import DataConfig as JDataConfig

    from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel

    paths, ds, _ = corpus
    tm = TransitionModel(HmmTopology.three_state(range(1, 6)))
    mdl = str(tmp_path / "final.mdl")
    tm.write_kaldi(mdl)
    rng = np.random.RandomState(7)
    tids = {u: rng.randint(1, tm.num_tids + 1, len(lab)).astype(np.int32)
            for u, lab in ds.labels.items()}
    ali = str(tmp_path / ("tid.ali.txt" if text_ark else "tid.ali.ark"))
    if text_ark:
        kaldi_io.write_text_ark(ali, sorted(tids.items()))
    else:
        with kaldi_io.ArkWriter(ali, kind="ivec") as w:
            for u, v in sorted(tids.items()):
                w.write(u, v)
    kw = dict(wav_scp=paths["wav_scp"], label_ark=ali, ali_are_pdf_ids=False)
    got = SpeechDataset.from_config(DataConfig(trans_model=mdl, **kw))
    want = JDataset.from_config(JDataConfig(trans_model=mdl, **kw))
    t2p = tm.tid_to_pdf_array()
    assert got.utt_ids == want.utt_ids and len(got.utt_ids) == len(tids)
    for u in got.utt_ids:
        assert got.labels[u].dtype == want.labels[u].dtype == np.int32
        np.testing.assert_array_equal(got.labels[u], want.labels[u])
        np.testing.assert_array_equal(got.labels[u], t2p[tids[u]])
    for make, cfg in ((SpeechDataset, DataConfig), (JDataset, JDataConfig)):
        with pytest.raises(ValueError, match="trans_model"):
            make.from_config(cfg(**kw))


def test_device_prefetch_cpu_yields_the_batches(corpus):
    _, ds, _ = corpus
    loader = ChunkDataloader(ds, batch_size=2, chunk_len=30, shuffle=False)
    ref = list(loader)
    got = list(device_prefetch(iter(loader), torch.device("cpu"), size=2))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for k, v in r.items():
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), v)


def test_device_prefetch_propagates_errors_and_stops_early():
    def bad():
        yield {"x": np.zeros(3)}
        raise RuntimeError("loader boom")

    with pytest.raises(RuntimeError, match="loader boom"):
        for _ in device_prefetch(bad(), "cpu"):
            pass

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.full(2, i)}
            i += 1

    gen = device_prefetch(endless(), "cpu", size=2)
    first = next(gen)
    assert int(first["x"][0]) == 0
    gen.close()  # joins the worker thread; it must not keep producing
    n = len(produced)
    assert n <= 5


def test_hdf5_corpus_identical_batches(tmp_path):
    from pykaldi2_tpu.data.hdf5_io import write_corpus

    rng = np.random.RandomState(18)
    utts = [(f"u{i}", (rng.randn(4000 + 700 * i) * 2000).astype(np.float32),
             rng.randint(0, 5, 23 + 4 * i).astype(np.int32)) for i in range(4)]
    path = str(tmp_path / "corpus.h5")
    write_corpus(path, utts)
    ds = SpeechDataset.from_hdf5(path, frame_opts=FrameOpts(dither=0.0))
    jds = JDataset.from_hdf5(path, frame_opts=JFrameOpts(dither=0.0))
    _assert_same_batches(ChunkDataloader(ds, batch_size=2, chunk_len=10, seed=1),
                         JChunk(jds, batch_size=2, chunk_len=10, seed=1))


def test_feats_mode_identical_batches(tmp_path):
    rng = np.random.RandomState(19)
    ark, scp = str(tmp_path / "f.ark"), str(tmp_path / "f.scp")
    with kaldi_io.ArkWriter(ark, scp, kind="mat") as w:
        for i in range(4):
            w.write(f"u{i}", rng.randn(25 + 6 * i, 12).astype(np.float32))
    ds, jds = SpeechDataset(feats_scp=scp), JDataset(feats_scp=scp)
    _assert_same_batches(ChunkDataloader(ds, batch_size=3, chunk_len=10, shuffle=False),
                         JChunk(jds, batch_size=3, chunk_len=10, shuffle=False))
