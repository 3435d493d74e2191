"""Forced alignment in the port against the JAX package on the CPU:
``ops.fb.fsa_viterbi``, the numerator graph builders, and the ``bin/align`` CLI.

The same numpy inputs go through both packages. ``fsa_viterbi`` must give
the reference's arcs exactly on live paths (ties: lowest winning arc id per
state, first maximal end state), the score within ``SCORE_RTOL``, and a
score <= -1e29 on both sides where the best path is dead. The numerator
graphs must be equal array for array. The CLI parity runs one JAX-trained
checkpoint (fp32, dither 0) through both CLIs with the same argv; the
alignment arks must be equal frame for frame (the JAX CLI pads its graphs to
power-of-two sizes, the port does not).
"""

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from pykaldi2_tpu.bin.align import main as jax_align
from pykaldi2_tpu.config import (FbankOpts, FeatConfig, FrameOpts, MelOpts, ModelConfig,
                                 OptimizerConfig)
from pykaldi2_tpu.data.dataloader import ChunkDataloader
from pykaldi2_tpu.data.dataset import SpeechDataset as JaxDataset
from pykaldi2_tpu.graph import HmmTopology as JaxTopo, TransitionModel as JaxTM
from pykaldi2_tpu.graph.compile import (make_linear_num_graph as jax_linear_num,
                                        make_num_graph as jax_num_graph)
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.ops.fb import fsa_viterbi as jax_viterbi, pack_graph as jax_pack
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline
from pykaldi2_tpu.trainer import make_ce_train_step
from pykaldi2_tpu.utils import make_optimizer, save_checkpoint

from pykaldi2_tpu_torch.bin.align import main as port_align, read_lexicon
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel
from pykaldi2_tpu_torch.graph.compile import make_linear_num_graph, make_num_graph
from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones
from pykaldi2_tpu_torch.ops import fsa_viterbi, pack_graph

from toydata import make_toy_corpus
from torch_port_helpers import (both_fsas, chain_fsa_arrays, one_torch_thread,  # noqa: F401
                               state_graph_arrays)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_PDFS = 4
SCORE_RTOL = 1e-5
DEAD = -1e29


def _unentered_arrays():
    """A graph in which states 20-22 have outgoing arcs but no arc enters
    them (their segment max is empty every frame)."""
    a = state_graph_arrays(seed=5, num_states=23, num_arcs=80, all_final=False)
    a["dst"] = (a["dst"] % 20).astype(np.int32)
    a["pdf"] = (a["dst"] % 5).astype(np.int32)
    a["phone"] = a["pdf"] + 1
    return a


def _padded_arrays():
    """A graph padded as the JAX align CLI pads it (dead self-loops, -inf)."""
    from pykaldi2_tpu_torch.ops.fsa import DenseFsa

    g = DenseFsa(**state_graph_arrays(seed=2)).pad_to(128, 32)
    return dict(num_states=g.num_states, src=g.src, dst=g.dst, pdf=g.pdf, weight=g.weight,
                final=g.final, start=g.start, phone=g.phone)


GRAPHS = {
    "state_graph": lambda: state_graph_arrays(seed=0),
    "one_final": lambda: state_graph_arrays(seed=1, all_final=False),
    "chain": lambda: chain_fsa_arrays(num_chains=4, chain_len=6),
    "unentered": _unentered_arrays,
    "padded": _padded_arrays,
    # 20-state chains over at most 17 frames: every path is dead
    "dead": lambda: chain_fsa_arrays(num_chains=3, chain_len=20),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_fsa_viterbi_matches_jax(name):
    jf, tf = both_fsas(GRAPHS[name]())
    rng = np.random.RandomState(11)
    obs = (rng.randn(3, 17, 5) * 2.0).astype(np.float32)
    nf = np.array([17, 11, 1], np.int32)
    js, ja = jax_viterbi(jnp.asarray(obs), jax_pack(jf), jnp.asarray(nf))
    ts, ta = fsa_viterbi(torch.from_numpy(obs), pack_graph(tf), torch.from_numpy(nf))
    js, ja, ts, ta = np.asarray(js), np.asarray(ja), ts.numpy(), ta.numpy()
    assert ta.shape == ja.shape == (3, 17)
    live = js > DEAD
    assert (live == (ts > DEAD)).all()
    if name == "dead":
        assert not live.any()
    else:
        assert live[0]
    for b in np.nonzero(live)[0]:
        np.testing.assert_array_equal(ta[b], ja[b])
        np.testing.assert_allclose(ts[b], js[b], rtol=SCORE_RTOL)
        assert (ta[b, nf[b]:] == -1).all()


def test_fsa_viterbi_ties_take_lowest_arc_and_first_state():
    """Two parallel arcs with equal scores into each state, and two equal
    final states: both packages pick the lower arc id and the first state."""
    arrays = dict(num_states=3, start=0,
                  src=np.array([0, 0, 0, 0, 1, 1, 2, 2], np.int32),
                  dst=np.array([1, 1, 2, 2, 1, 1, 2, 2], np.int32),
                  pdf=np.zeros(8, np.int32), weight=np.zeros(8, np.float32),
                  final=np.array([-np.inf, 0.0, 0.0], np.float32))
    jf, tf = both_fsas(arrays)
    obs = np.zeros((1, 4, 1), np.float32)
    nf = np.array([4], np.int32)
    js, ja = jax_viterbi(jnp.asarray(obs), jax_pack(jf), jnp.asarray(nf))
    ts, ta = fsa_viterbi(torch.from_numpy(obs), pack_graph(tf), torch.from_numpy(nf))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ta.numpy()[0], [0, 4, 4, 4])
    assert float(ts[0]) == float(js[0]) == 0.0


def _assert_fsa_equal(got, ref):
    assert (got.num_states, got.start) == (ref.num_states, ref.start)
    for k in ("src", "dst", "pdf", "weight", "final", "phone", "olabel"):
        a, b = getattr(got, k), getattr(ref, k)
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("topo", ["one_state", "three_state"])
@pytest.mark.parametrize("sil", [(0, 0.0), (3, 0.4)])
def test_num_graphs_match_jax(topo, sil):
    phones = range(1, 6)
    tm, jtm = (TransitionModel(getattr(HmmTopology, topo)(phones)),
               JaxTM(getattr(JaxTopo, topo)(phones)))
    seq = [2, 5, 5, 1, 3]
    _assert_fsa_equal(make_linear_num_graph(tm, seq), jax_linear_num(jtm, seq))
    lexicon = {"a": [[1, 2]], "b": [[2], [4, 5]], "c": [[5, 1, 3]], "d": [[4]]}
    word_ids = {w: i + 1 for i, w in enumerate(lexicon)}
    words = ["b", "a", "c", "b", "d"]
    _assert_fsa_equal(make_num_graph(tm, words, lexicon, word_ids, *sil),
                      jax_num_graph(jtm, words, lexicon, word_ids, *sil))


def test_read_lexicon(tmp_path):
    p = tmp_path / "lex.txt"
    p.write_text("a 1 2\nb 2\n\nb 4 5\n")
    lexicon, word_ids = read_lexicon(str(p))
    assert lexicon == {"a": [[1, 2]], "b": [[2], [4, 5]]}
    assert word_ids == {"a": 1, "b": 2}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Toy corpus, a JAX-trained fp32 BLSTM checkpoint (as
    tests/test_tools.py:_train_quick), a lexicon w<p> → phone p and
    transcripts from the true labels; the last utterance's transcript is far
    too long for its audio (its alignment fails in both CLIs)."""
    tmp = tmp_path_factory.mktemp("align_cli")
    paths = make_toy_corpus(str(tmp / "c"), num_utts=5, num_pdfs=NUM_PDFS, seed=8)
    ds = JaxDataset(wav_scp=paths["wav_scp"], ali=paths["ali"],
                    frame_opts=FrameOpts(dither=0.0))
    feat_fn = JaxPipeline(FeatConfig(fbank=FbankOpts(frame_opts=FrameOpts(dither=0.0),
                                                     mel_opts=MelOpts(num_bins=24))))
    model = jax_build_model(ModelConfig(type="blstm", input_size=feat_fn.dim, hidden_size=32,
                                        num_layers=1, output_size=NUM_PDFS,
                                        compute_dtype="float32"))
    opt = make_optimizer(OptimizerConfig(type="adam", lr=1e-2))
    params = model.init(jax.random.PRNGKey(0))
    opt_state = opt.init(params)
    step = make_ce_train_step(model, feat_fn, opt, mesh=None)
    key = jax.random.PRNGKey(1)
    for epoch in range(12):
        loader = ChunkDataloader(ds, batch_size=8, chunk_len=40, seed=2)
        loader.set_epoch(epoch)
        for batch in loader:
            key, sk = jax.random.split(key)
            params, opt_state, m = step(params, opt_state, batch, sk)
    assert float(m["frame_acc"]) > 0.6
    ckpt = str(tmp / "ce.npz")
    save_checkpoint(ckpt, params)

    lex, text = str(tmp / "lexicon.txt"), str(tmp / "text.txt")
    with open(lex, "w") as f:
        f.write("".join(f"w{p} {p}\n" for p in range(1, NUM_PDFS + 1)))
    with open(text, "w") as f:
        for i, uid in enumerate(ds.utt_ids):
            phones = collapse_to_phones(ds.labels[uid] + 1)
            if i == len(ds.utt_ids) - 1:
                phones = np.tile(phones, 400)
            f.write(uid + " " + " ".join(f"w{p}" for p in phones) + "\n")
    tm = str(tmp / "final.mdl")
    TransitionModel(HmmTopology.one_state(range(1, NUM_PDFS + 1))).write_kaldi(tm)
    dp, cp = str(tmp / "d.yaml"), str(tmp / "c.yaml")
    with open(dp, "w") as f:
        yaml.safe_dump({"wav_scp": paths["wav_scp"],
                        "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                           "mel_opts": {"num_bins": 24}}}}, f)
    with open(cp, "w") as f:
        yaml.safe_dump({"model": {"type": "blstm", "hidden_size": 32, "num_layers": 1,
                                  "output_size": NUM_PDFS, "compute_dtype": "float32"}}, f)
    base = ["-config", cp, "-data", dp, "-model", ckpt, "-text", text, "-lexicon", lex]
    return tmp, base, ds, tm


CLI_CASES = {
    "plain": [],
    "silence": ["-sil_phone", "1", "-sil_prob", "0.3"],
    "trans_model": ["-trans_model", None, "-acoustic_scale", "0.5"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_align_cli_matches_jax_cli(corpus, case):
    tmp, base, ds, tm = corpus
    extra = [tm if a is None else a for a in CLI_CASES[case]]
    j_out, p_out = str(tmp / f"{case}_jax.ark"), str(tmp / f"{case}_port.ark")
    assert jax_align(base + ["-out", j_out] + extra) == 0
    assert port_align(base + ["-out", p_out] + extra, device="cpu") == 0
    ref = dict(kaldi_io.read_ark(j_out, kind="ivec"))
    got = dict(kaldi_io.read_ark(p_out, kind="ivec"))
    assert set(got) == set(ref) == set(ds.utt_ids[:-1])  # the last one fails in both
    agree = total = 0
    for uid in ref:
        assert got[uid].dtype == np.int32
        np.testing.assert_array_equal(got[uid], ref[uid], err_msg=uid)
        assert len(got[uid]) == len(ds.labels[uid])
        agree += int((got[uid] == ds.labels[uid]).sum())
        total += len(got[uid])
    assert agree / total > 0.55, agree / total
