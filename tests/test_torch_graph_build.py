"""Graph building in the port against the JAX package on the CPU: ARPA LMs,
the vectorized FST algorithms, determinize/push/minimize, the HCLG builders
and the ``bin/build_graph`` CLI.

Everything here is host numpy with the same arithmetic in both packages, so
parity is exact: arc tables, weights and written files must be equal (the
port's graphs must also come out in the reference's arc order, or the
decoder's ties would differ). The cases of tests/test_arpa.py run at small
size on the port's own functions too, with that file's tolerances.
"""

import math

import numpy as np
import pytest

from pykaldi2_tpu.bin.build_graph import main as jax_build_graph
from pykaldi2_tpu.graph import arpa as jarpa
from pykaldi2_tpu.graph import compile as jcompile
from pykaldi2_tpu.graph.fst import Fst as JaxFst
from pykaldi2_tpu.graph.topology import HmmTopology as JaxTopo
from pykaldi2_tpu.graph.transition_model import TransitionModel as JaxTM
from pykaldi2_tpu.graph.vfst import VectorFst as JaxVectorFst

from pykaldi2_tpu_torch.bin.build_graph import main as port_build_graph
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder
from pykaldi2_tpu_torch.graph import arpa
from pykaldi2_tpu_torch.graph.compile import (expand_to_pdf_vfst, make_decode_graph,
                                              make_lexicon_trie_fst, make_word_decode_graph)
from pykaldi2_tpu_torch.graph.fst import EPS, Fst
from pykaldi2_tpu_torch.graph.topology import HmmTopology
from pykaldi2_tpu_torch.graph.transition_model import TransitionModel
from pykaldi2_tpu_torch.graph.vfst import VectorFst

SCORE_TOL = 1e-4   # tests/test_arpa.py's bound on path scores (float32 weights)


def _sentences(rng, vocab, n=60, lo=3, hi=9):
    """Markov-ish text (tests/test_arpa.py:_sentences without ``hash``, which
    is salted per process for strings)."""
    out = []
    for _ in range(n):
        s = [rng.randint(len(vocab))]
        for _ in range(rng.randint(lo, hi) - 1):
            s.append((s[-1] * 7 + rng.randint(3)) % len(vocab))
        out.append([vocab[i] for i in s])
    return out


def _toy_system(rng, tm_cls, topo_cls, n_phones=8, n_words=12, pron_len=(2, 5)):
    phones = list(range(1, n_phones + 1))
    tm = tm_cls(topo_cls.one_state(phones))
    vocab = [f"word{i}" for i in range(n_words)]
    word_ids = {w: i + 1 for i, w in enumerate(vocab)}
    lexicon, seen = {}, set()
    for w in vocab:
        while True:
            pron = tuple(int(rng.choice(phones)) for _ in range(rng.randint(*pron_len)))
            if pron not in seen:
                seen.add(pron)
                break
        lexicon[w] = [list(pron)]
    return tm, vocab, word_ids, lexicon


def _obs_for_words(tm, lexicon, words, rng, frames_per_phone=3, strength=8.0):
    pdfs = [tm.pdf_for(ph, 0) for w in words for ph in lexicon[w][0]
            for _ in range(frames_per_phone)]
    obs = rng.randn(len(pdfs), tm.num_pdfs).astype(np.float32) * 0.1
    obs[np.arange(len(pdfs)), pdfs] += strength
    return obs


def _random_fst(cls, seed, n_states, n_arcs, n_ilabels, n_olabels, eps_in=False,
                eps_out=False, acceptor=False):
    """The same random machine in either package (tests/test_arpa.py)."""
    rng = np.random.RandomState(seed)
    f = cls()
    for _ in range(n_states):
        f.add_state()
    f.set_start(0)
    f.set_final(n_states - 1, float(rng.randn() * 0.1))
    for _ in range(n_arcs):
        s, d = rng.randint(n_states), rng.randint(n_states)
        il = rng.randint(0 if eps_in else 1, n_ilabels + 1)
        ol = il if acceptor else rng.randint(0 if eps_out else 1, n_olabels + 1)
        f.add_arc(s, il, ol, float(rng.randn() * 0.3), d)
    return f


def _fst_rows(f):
    return (f.num_states, f.start, sorted(f.finals.items()),
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in f.arcs[s]]
             for s in range(f.num_states)])


def _assert_vfst_equal(got, ref):
    assert (got.num_states, got.start) == (ref.num_states, ref.start)
    for k in ("src", "dst", "ilabel", "olabel", "weight", "final"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)


def _path_set(f, max_len=4):
    """(ilabels, olabels) → max path weight over paths of up to max_len arcs."""
    out = {}
    if f.start < 0:
        return out
    stack = [(f.start, (), (), 0.0, 0)]
    while stack:
        s, il, ol, w, depth = stack.pop()
        if s in f.finals:
            key = (il, ol)
            out[key] = max(out.get(key, -np.inf), w + f.finals[s])
        if depth < max_len:
            for a in f.arcs[s]:
                stack.append((a.nextstate, il + ((a.ilabel,) if a.ilabel else ()),
                              ol + ((a.olabel,) if a.olabel else ()), w + a.weight,
                              depth + 1))
    return out


def _acceptor_best_path(g, labels):
    """Max-semiring score of a label sequence through an acceptor with eps
    (backoff) arcs (tests/test_arpa.py:_acceptor_best_path)."""
    neg = -1e30
    eps = g.ilabel == EPS

    def closure(d):
        for _ in range(g.num_states):
            nd = d.copy()
            np.maximum.at(nd, g.dst[eps], d[g.src[eps]] + g.weight[eps])
            if np.allclose(nd, d):
                return nd
            d = nd
        return d

    d = np.full(g.num_states, neg)
    d[g.start] = 0.0
    d = closure(d)
    for lab in labels:
        nd = np.full(g.num_states, neg)
        sel = g.ilabel == lab
        np.maximum.at(nd, g.dst[sel], d[g.src[sel]] + g.weight[sel])
        d = closure(nd)
    return float((d + np.where(np.isfinite(g.final), g.final, neg)).max())


# ---------------------------------------------------------------------------
# ARPA
# ---------------------------------------------------------------------------


def test_train_arpa_normalizes_roundtrips_and_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    vocab = [f"w{i}" for i in range(20)]
    sents = _sentences(rng, vocab, n=80)
    model = arpa.train_arpa(sents, order=3)
    ref = jarpa.train_arpa(sents, order=3)
    assert model.ngrams == ref.ngrams
    for hist in [(), ("w1",), ("w1", "w8"), (arpa.BOS,), ("w4", "w4")]:
        total = sum(math.exp(model.logp(hist + (w,))) for w in vocab)
        total += math.exp(model.logp(hist + (arpa.EOS,)))
        assert total == pytest.approx(1.0, abs=2e-3), hist
    p, pj = tmp_path / "lm.arpa", tmp_path / "lm_jax.arpa"
    arpa.write_arpa(model, str(p))
    jarpa.write_arpa(ref, str(pj))
    assert p.read_bytes() == pj.read_bytes()
    back = arpa.read_arpa(str(p))
    assert back.order == 3 and back.ngrams == jarpa.read_arpa(str(p)).ngrams
    for ng in [("w1",), ("w1", "w8"), ("w3", "w1", "w8"), (arpa.BOS, "w5")]:
        assert back.logp(ng) == pytest.approx(model.logp(ng), abs=2e-5)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_arpa_fst_matches_jax_and_scores(order):
    rng = np.random.RandomState(1)
    vocab = [f"w{i}" for i in range(15)]
    word_ids = {w: i + 1 for i, w in enumerate(vocab)}
    sents = _sentences(rng, vocab, n=50)
    model = arpa.train_arpa(sents, order=order)
    g = arpa.arpa_to_fst(model, word_ids)
    _assert_vfst_equal(g, jarpa.arpa_to_fst(jarpa.train_arpa(sents, order=order), word_ids))
    # a sentence's best path through G is at least its canonical backoff score
    for _ in range(6):
        sent = [vocab[rng.randint(len(vocab))] for _ in range(rng.randint(1, 6))]
        canonical, ctx = 0.0, (arpa.BOS,)
        for w in sent:
            canonical += model.logp(ctx + (w,))
            ctx = (ctx + (w,))[-(order - 1):] if order > 1 else ()
        canonical += model.logp(ctx + (arpa.EOS,))
        assert _acceptor_best_path(g, [word_ids[w] for w in sent]) >= canonical - SCORE_TOL


# ---------------------------------------------------------------------------
# vectorized FST algorithms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trial", range(4))
def test_vector_compose_matches_object_compose_and_jax(trial):
    kw1 = dict(n_states=5, n_arcs=12, n_ilabels=3, n_olabels=3, eps_out=True)
    kw2 = dict(n_states=4, n_arcs=10, n_ilabels=3, n_olabels=3, eps_in=True)
    f1, f2 = _random_fst(Fst, 10 + trial, **kw1), _random_fst(Fst, 20 + trial, **kw2)
    got = VectorFst.from_fst(f1).compose(VectorFst.from_fst(f2))
    ref = JaxVectorFst.from_fst(_random_fst(JaxFst, 10 + trial, **kw1)).compose(
        JaxVectorFst.from_fst(_random_fst(JaxFst, 20 + trial, **kw2)))
    _assert_vfst_equal(got, ref)
    obj = _path_set(f1.compose(f2))
    vec = _path_set(got.to_fst())
    assert set(obj) == set(vec)
    for k in obj:
        assert vec[k] == pytest.approx(obj[k], abs=SCORE_TOL)


def test_vector_compose_mismatched_label_ranges():
    """L emits olabel 4, G's largest ilabel is 3: the composition is empty."""
    L, G = Fst(), Fst()
    a, b = L.add_state(), L.add_state()
    L.set_start(a)
    L.add_arc(a, 1, 4, 0.0, b)
    L.set_final(b, 0.0)
    c, d = G.add_state(), G.add_state()
    G.set_start(c)
    G.add_arc(c, 3, 3, 0.0, d)
    G.set_final(d, 0.0)
    assert VectorFst.from_fst(L).compose(VectorFst.from_fst(G)).num_states == 0


@pytest.mark.parametrize("trial", range(3))
def test_vector_connect_matches_object_connect_and_jax(trial):
    f = _random_fst(Fst, 30 + trial, 8, 14, 3, 3)
    got = VectorFst.from_fst(f).connect()
    _assert_vfst_equal(got, JaxVectorFst.from_fst(
        _random_fst(JaxFst, 30 + trial, 8, 14, 3, 3)).connect())
    obj = f.connect()
    assert (got.num_states, got.num_arcs) == (obj.num_states, obj.num_arcs)


# ---------------------------------------------------------------------------
# determinize / push_weights / minimize
# ---------------------------------------------------------------------------


def _nondet(cls):
    f = cls()
    for _ in range(5):
        f.add_state()
    f.set_start(0)
    for s, lab, w, d in [(0, 1, -0.5, 1), (0, 1, -1.0, 2), (1, 2, -0.25, 3), (2, 2, -0.1, 3),
                         (2, 3, -0.2, 4)]:
        f.add_arc(s, lab, lab, w, d)
    f.set_final(3, -0.3)
    f.set_final(4, 0.0)
    return f


def _cyclic(cls, w2=-0.3):
    f = cls()
    for _ in range(3):
        f.add_state()
    f.set_start(0)
    for s, lab, w, d in [(0, 1, -0.5, 1), (0, 1, -0.7, 2), (1, 2, -0.3, 1), (2, 2, w2, 2)]:
        f.add_arc(s, lab, lab, w, d)
    f.set_final(1, 0.0)
    f.set_final(2, -0.1)
    return f


def _reentered(cls):
    """A word loop whose start state is re-entered (push_weights splits it)."""
    f = cls()
    for _ in range(3):
        f.add_state()
    f.set_start(0)
    f.add_arc(0, 1, 1, -0.4, 1)
    f.add_arc(0, 2, 2, -1.1, 2)
    f.add_arc(1, 3, 3, -0.2, 0)
    f.add_arc(2, 3, 3, -0.6, 0)
    f.set_final(0, -0.05)
    return f


FSTS = {
    "nondet": _nondet,
    "cyclic": _cyclic,
    "reentered": _reentered,
    "random_acceptor": lambda cls: _random_fst(cls, 7, 6, 14, 3, 3, acceptor=True),
    "transducer": lambda cls: _random_fst(cls, 8, 6, 12, 3, 4),
}


@pytest.mark.parametrize("name", sorted(FSTS))
@pytest.mark.parametrize("op", ["determinize", "push_weights", "minimize"])
def test_determinize_push_minimize_match_jax(name, op):
    kw = {}
    if op == "determinize":
        kw = {"max_states": 5000, "encode_labels": name == "transducer"}
    got = getattr(FSTS[name](Fst), op)(**kw)
    ref = getattr(FSTS[name](JaxFst), op)(**kw)
    assert _fst_rows(got) == _fst_rows(ref)


def test_determinize_nondeterminizable_raises():
    with pytest.raises(ValueError):
        _cyclic(Fst, w2=-0.4).determinize(max_states=5000)
    with pytest.raises(ValueError):
        _random_fst(Fst, 8, 6, 12, 3, 4).determinize()   # a transducer needs encoding


# ---------------------------------------------------------------------------
# HCLG builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sil", [(0, 0.0), (3, 0.3)])
def test_lexicon_trie_and_pdf_expansion_match_jax(sil):
    lexicon = {"a": [[1, 2, 3]], "b": [[1, 2], [4]], "c": [[1, 2, 3, 4]], "d": [[5]]}
    word_ids = {w: i + 1 for i, w in enumerate(lexicon)}
    trie = make_lexicon_trie_fst(lexicon, word_ids, *sil)
    assert _fst_rows(trie) == _fst_rows(jcompile.make_lexicon_trie_fst(lexicon, word_ids, *sil))
    phones = range(1, 6)
    tm = TransitionModel(HmmTopology.three_state(phones))
    jtm = JaxTM(JaxTopo.three_state(phones))
    _assert_vfst_equal(expand_to_pdf_vfst(VectorFst.from_fst(trie), tm),
                       jcompile.expand_to_pdf_vfst(JaxVectorFst.from_fst(
                           jcompile.make_lexicon_trie_fst(lexicon, word_ids, *sil)), jtm))


@pytest.mark.parametrize("order", [2, 3])
def test_word_graph_matches_jax_and_collapsed_graph(order):
    """The HCLG equals the JAX one arc for arc; decoded through the port's
    decoder, it finds the words and score of the collapsed small graph."""
    rng = np.random.RandomState(5)
    tm, vocab, word_ids, lexicon = _toy_system(rng, TransitionModel, HmmTopology)
    sents = _sentences(rng, vocab, n=50, lo=2, hi=5)
    model = arpa.train_arpa(sents, order=order)
    hclg = make_word_decode_graph(tm, lexicon, word_ids, model)
    jtm = JaxTM(JaxTopo.one_state(range(1, 9)))
    _assert_vfst_equal(hclg, jcompile.make_word_decode_graph(
        jtm, lexicon, word_ids, jarpa.train_arpa(sents, order=order)))
    collapsed = make_decode_graph(tm, lexicon, word_ids,
                                  grammar=arpa.arpa_to_fst(model, word_ids).to_fst())
    dec_a = LatticeDecoder(collapsed, beam=1e9, max_active=10 ** 9)
    dec_b = LatticeDecoder(hclg, beam=1e9, max_active=10 ** 9)
    for _ in range(3):
        words = [vocab[rng.randint(len(vocab))] for _ in range(rng.randint(1, 4))]
        obs = _obs_for_words(tm, lexicon, words, rng)
        wa, _, sa = dec_a.decode(obs)
        wb, _, sb = dec_b.decode(obs)
        assert wa == wb == [word_ids[w] for w in words]
        assert sa == pytest.approx(sb, abs=1e-3)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("build_graph")
    rng = np.random.RandomState(9)
    tm, vocab, word_ids, lexicon = _toy_system(rng, TransitionModel, HmmTopology,
                                               n_phones=6, n_words=10)
    lex = tmp / "lexicon.txt"
    lex.write_text("".join(w + " " + " ".join(map(str, lexicon[w][0])) + "\n" for w in vocab))
    lm = tmp / "lm.arpa"
    arpa.write_arpa(arpa.train_arpa(_sentences(rng, vocab, n=40, lo=2, hi=5), order=3),
                    str(lm))
    mdl = tmp / "final.mdl"
    TransitionModel(HmmTopology.three_state(range(1, 7))).write_kaldi(str(mdl))
    ali = tmp / "ali.ark"
    with kaldi_io.ArkWriter(str(ali), kind="ivec") as w:
        for i in range(6):
            runs = rng.randint(0, 18, rng.randint(3, 9))
            w.write(f"u{i}", np.repeat(runs, rng.randint(2, 6, runs.size)).astype(np.int32))
    return tmp, dict(lex=str(lex), lm=str(lm), mdl=str(mdl), ali=str(ali))


CLI_CASES = {
    "decode_text": (["decode", "-lexicon", "{lex}"], "g.fst.txt", True),
    "decode_binary_fst": (["decode", "-lexicon", "{lex}", "-sil_phone", "2", "-sil_prob",
                           "0.2"], "g.fst", False),
    "decode_npz_three": (["decode", "-lexicon", "{lex}", "-topo", "three"], "g.npz", True),
    "decode_arpa_npz": (["decode", "-lexicon", "{lex}", "-arpa", "{lm}"], "hclg.npz", True),
    "decode_arpa_text_tm": (["decode", "-lexicon", "{lex}", "-arpa", "{lm}", "-trans_model",
                             "{mdl}", "-sil_phone", "1", "-sil_prob", "0.5"], "hclg.txt", False),
    "decode_arpa_fst": (["decode", "-lexicon", "{lex}", "-arpa", "{lm}"], "hclg.fst", False),
    "den": (["den", "-ali", "{ali}"], "den.npz", False),
    "den_tm_smoothing": (["den", "-ali", "{ali}", "-trans_model", "{mdl}", "-smoothing",
                          "0.5"], "den.npz", False),
    "den_num_pdfs": (["den", "-ali", "{ali}", "-num_pdfs", "20"], "den.npz", False),
}


def _same_file(a, b):
    if a.suffix != ".npz":
        assert a.read_bytes() == b.read_bytes(), a.name
        return
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_build_graph_cli_matches_jax_cli(inputs, case):
    tmp, files = inputs
    argv, out_name, words = CLI_CASES[case]
    argv = [a.format(**files) for a in argv]
    outs = {}
    for side, fn in (("jax", jax_build_graph), ("port", port_build_graph)):
        d = tmp / f"{case}_{side}"
        d.mkdir()
        extra = ["-out", str(d / out_name)] + (["-words_out", str(d / "words.txt")]
                                               if words else [])
        assert fn(argv + extra) == 0
        outs[side] = d
    for f in sorted(p.name for p in outs["jax"].iterdir()):
        _same_file(outs["port"] / f, outs["jax"] / f)
    assert sorted(p.name for p in outs["port"].iterdir()) == sorted(
        p.name for p in outs["jax"].iterdir())
