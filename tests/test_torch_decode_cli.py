"""The port's ``bin/decode`` CLI against pykaldi2_tpu/bin/decode.py on the CPU.

One toy corpus, one checkpoint (trained by the port's ``train_ce`` in bf16,
the flagship's compute dtype) and one free word-loop graph go through both
CLIs with the same argv. Hypotheses, WER lines (corpus, oracle, LM-scale
sweep), N-best word strings, CTM words, and the word lattices' shapes and
best paths must be equal; the dumped scaled log-likelihoods, and the CTM's
posterior-weighted times (s) and confidences, which carry the two packages'
bf16 differences, agree within ``POST_TOL`` and ``CTM_TOL``. The argv carries a word insertion penalty:
on a free word loop without one, the consensus (MBR) hypothesis is a long
run of re-entered words whose length turns on score differences far below
those bf16 differences. The accelerator decoders (``-decoder device``, with
and without a lattice mode, and ``-on_device``) give the JAX CLI's
hypotheses on the same argv, and ``-max_arcs`` (fault F4) is accepted with
every decoder, as the reference parses it.
"""

import os

import numpy as np
import pytest
import yaml

from pykaldi2_tpu.bin.decode import main as jax_decode
from pykaldi2_tpu.data import kaldi_io as jkio

from pykaldi2_tpu_torch.bin.decode import main as port_decode
from pykaldi2_tpu_torch.bin.train_ce import main as port_train_ce
from pykaldi2_tpu_torch.decode.lattice import best_path, read_lattices_text
from pykaldi2_tpu_torch.decode.lattice_ark import read_lattice_ark
from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel, make_decode_graph
from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones

from toydata import make_toy_corpus

NUM_PDFS = 4
# dumped log-likelihoods (acoustic scale 1): the JAX package's bf16 scan LSTM
# against the port's plain K2 (bf16 operands, fp32 sums), carried through one
# layer and the log-softmax — the bf16 LSTM tolerance of test_torch_lstm.py
POST_TOL = dict(rtol=2e-2, atol=2e-2)
# CTM times (s) and confidences are lattice posteriors: exponentials of path
# scores summed over ~100 frames, each frame within POST_TOL; they land
# within 0.03 here (the exact-input parity is in test_torch_decode.py)
CTM_TOL = 5e-2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode_cli")
    paths = make_toy_corpus(str(tmp / "c"), num_utts=3, num_pdfs=NUM_PDFS, seed=16)
    dp, cp = str(tmp / "d.yaml"), str(tmp / "c.yaml")
    with open(dp, "w") as f:
        yaml.safe_dump({"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
                        "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                           "mel_opts": {"num_bins": 24}}}}, f)
    with open(cp, "w") as f:
        yaml.safe_dump({"model": {"type": "lstm", "hidden_size": 32, "num_layers": 1,
                                  "output_size": NUM_PDFS, "compute_dtype": "bfloat16"},
                        "optimizer": {"type": "adam", "lr": 0.02},
                        "trainer": {"batch_size": 4, "chunk_len": 40, "num_epochs": 6,
                                    "log_interval": 100}}, f)
    exp = str(tmp / "exp")
    assert port_train_ce(["-config", cp, "-data", dp, "-exp_dir", exp], device="cpu") == 0
    # the graph: one-state HMMs, word w<p> = phone p (pdf p-1), free word loop
    tm = TransitionModel(HmmTopology.one_state(range(1, NUM_PDFS + 1)))
    lexicon = {f"w{p}": [[p]] for p in range(1, NUM_PDFS + 1)}
    word_ids = {w: i + 1 for i, w in enumerate(lexicon)}
    graph, words = str(tmp / "g.txt"), str(tmp / "words.txt")
    make_decode_graph(tm, lexicon, word_ids).write_text(graph)
    with open(words, "w") as f:
        f.write("<eps> 0\n" + "".join(f"{w} {i}\n" for w, i in word_ids.items()))
    ref = str(tmp / "ref.txt")
    with open(ref, "w") as f:
        for uid, lab in jkio.read_ark(paths["ali"], kind="ivec"):
            f.write(uid + " " + " ".join(f"w{p}" for p in collapse_to_phones(lab + 1)) + "\n")
    base = ["-config", cp, "-data", dp, "-model", os.path.join(exp, "model.5.npz"),
            "-graph", graph, "-words", words, "-ref", ref, "-acoustic_scale", "1.0",
            "-num_threads", "2", "-word_penalty", "3"]
    return tmp, base


def _read_lattices(path):
    if path.suffix == ".ark":
        return read_lattice_ark(str(path))
    return read_lattices_text(str(path))


def _run(fn, argv, capsys, **kw):
    capsys.readouterr()
    assert fn(argv, **kw) == 0
    return [line for line in capsys.readouterr().out.splitlines() if "WER" in line]


@pytest.mark.parametrize("mode", [
    ["-dump_ark", "{out}/post.ark"],
    ["-dump_ark", "{out}/post.ark", "-compress", "-lattice_out", "{out}/lat.txt",
     "-nbest", "3", "-nbest_out", "{out}/nbest.txt", "-oracle"],
    ["-lattice_out", "{out}/lat.ark", "-mbr", "-ctm_out", "{out}/out.ctm",
     "-lm_scale_sweep", "0.5:1.5:0.5"],
], ids=["best_path_dump", "lattice_nbest_oracle", "mbr_ctm_sweep"])
def test_decode_cli_matches_jax(setup, capsys, monkeypatch, mode):
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    tmp, base = setup
    outs = {}
    for name, fn, kw in (("jax", jax_decode, {}), ("port", port_decode, {"device": "cpu"})):
        out = tmp / f"{name}_{'_'.join(m.lstrip('-') for m in mode if m.startswith('-'))}"
        out.mkdir()
        argv = base + ["-hyp_out", str(out / "hyp.txt")] + [m.format(out=out) for m in mode]
        outs[name] = (out, _run(fn, argv, capsys, **kw))
    (jout, jwer), (pout, pwer) = outs["jax"], outs["port"]
    assert pwer == jwer and any(line.startswith("%WER") for line in pwer)
    files = sorted(p.name for p in jout.iterdir())
    assert files == sorted(p.name for p in pout.iterdir())
    assert (pout / "hyp.txt").read_text() == (jout / "hyp.txt").read_text()
    if "nbest.txt" in files:  # the same word strings in the same order
        def strings(path):
            return [(ln.split()[0], ln.split()[2:]) for ln in path.read_text().splitlines()]
        assert strings(pout / "nbest.txt") == strings(jout / "nbest.txt")
    if "out.ctm" in files:  # the same words; expected times and confidences close
        def rows(path):
            return [ln.split() for ln in path.read_text().splitlines()]
        got, want = rows(pout / "out.ctm"), rows(jout / "out.ctm")
        assert [(r[0], r[1], r[4]) for r in got] == [(r[0], r[1], r[4]) for r in want]
        np.testing.assert_allclose([[float(r[i]) for i in (2, 3, 5)] for r in got],
                                   [[float(r[i]) for i in (2, 3, 5)] for r in want],
                                   atol=CTM_TOL)
    for name in ("lat.txt", "lat.ark"):
        if name in files:  # the same word lattices: states, arcs and best paths
            got, want = (_read_lattices(out / name) for out in (pout, jout))
            assert sorted(got) == sorted(want)
            for uid in want:
                assert (got[uid].num_states, got[uid].num_arcs) == \
                    (want[uid].num_states, want[uid].num_arcs)
                assert best_path(got[uid])[0] == best_path(want[uid])[0]
    if (jout / "post.ark").exists():
        want = dict(jkio.read_ark(str(jout / "post.ark")))
        got = dict(jkio.read_ark(str(pout / "post.ark")))
        assert sorted(got) == sorted(want)
        for uid in want:
            assert got[uid].shape == want[uid].shape
            np.testing.assert_allclose(got[uid], want[uid], **POST_TOL)


@pytest.mark.parametrize("flags", [["-decoder", "device"], ["-on_device"]])
def test_decode_cli_accelerator_decoders_raise(setup, flags):
    """The accelerator decoders run; they raise, as the reference does, only
    on option combinations they cannot serve."""
    tmp, base = setup
    out = tmp / f"run_{flags[-1].lstrip('-')}"
    out.mkdir()
    assert port_decode(base + flags + ["-hyp_out", str(out / "hyp.txt")], device="cpu") == 0
    assert len((out / "hyp.txt").read_text().splitlines()) == 3
    other = ["-on_device"] if flags[0] == "-decoder" else ["-nbest", "2"]
    with pytest.raises(SystemExit, match="-on_device"):
        port_decode(base + flags + other, device="cpu")


@pytest.mark.parametrize("mode", [
    ["-decoder", "device", "-max_active", "200", "-max_arcs", "256"],
    ["-on_device"],
    ["-decoder", "device", "-max_active", "200", "-nbest", "3", "-nbest_out",
     "{out}/nbest.txt", "-lattice_out", "{out}/lat.txt", "-oracle"],
    ["-decoder", "host", "-max_arcs", "512"],
], ids=["device", "on_device", "device_nbest", "host_max_arcs"])
def test_decode_cli_device_decoders_match_jax(setup, capsys, monkeypatch, mode):
    """One argv through both CLIs: the same hypotheses, WER lines and N-best
    word strings; the host decoder takes ``-max_arcs`` (F4) and ignores it,
    as the reference does."""
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    tmp, base = setup
    outs = {}
    for name, fn, kw in (("jax", jax_decode, {}), ("port", port_decode, {"device": "cpu"})):
        out = tmp / f"{name}_acc_{'_'.join(m.lstrip('-') for m in mode if m.startswith('-'))}"
        out.mkdir()
        argv = base + ["-hyp_out", str(out / "hyp.txt")] + [m.format(out=out) for m in mode]
        outs[name] = (out, _run(fn, argv, capsys, **kw))
    (jout, jwer), (pout, pwer) = outs["jax"], outs["port"]
    assert pwer == jwer and any(line.startswith("%WER") for line in pwer)
    hyp = (pout / "hyp.txt").read_text()
    assert hyp == (jout / "hyp.txt").read_text() and len(hyp.splitlines()) == 3
    if (jout / "nbest.txt").exists():
        def strings(path):
            return [(ln.split()[0], ln.split()[2:]) for ln in path.read_text().splitlines()]
        assert strings(pout / "nbest.txt") == strings(jout / "nbest.txt")
        got, want = (_read_lattices(out / "lat.txt") for out in (pout, jout))
        assert sorted(got) == sorted(want)
        for uid in want:
            assert best_path(got[uid])[0] == best_path(want[uid])[0]
