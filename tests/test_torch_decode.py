"""Decoding, lattice, MBR and graph layers of the PyTorch port against the JAX package.

These modules are numpy copies (the decoder a ctypes binding of the same
native/latdec.cc), so identical inputs must give identical outputs: FSTs
arc for arc, words, alignments and scores, lattices, N-best lists, MBR
results and the bytes of every file format. The cases follow
tests/test_decode.py, test_lattice_tools.py, test_mbr.py and test_graph.py.
"""

import dataclasses
import io

import numpy as np
import pytest

from pykaldi2_tpu.decode import decoder as jdec
from pykaldi2_tpu.decode import lattice as jlat
from pykaldi2_tpu.decode import lattice_ark as jark
from pykaldi2_tpu.decode import mbr as jmbr
from pykaldi2_tpu.decode import wer as jwer
from pykaldi2_tpu.graph import compile as jcompile
from pykaldi2_tpu.graph import fst as jfst
from pykaldi2_tpu.graph import openfst_io as jofst
from pykaldi2_tpu.graph import vfst as jvfst
from pykaldi2_tpu.graph.topology import HmmTopology as JTopo
from pykaldi2_tpu.graph.transition_model import TransitionModel as JTm

from pykaldi2_tpu_torch.decode import decoder as pdec
from pykaldi2_tpu_torch.decode import lattice as plat
from pykaldi2_tpu_torch.decode import lattice_ark as park
from pykaldi2_tpu_torch.decode import mbr as pmbr
from pykaldi2_tpu_torch.decode import wer as pwer
from pykaldi2_tpu_torch.graph import compile as pcompile
from pykaldi2_tpu_torch.graph import fst as pfst
from pykaldi2_tpu_torch.graph import openfst_io as pofst
from pykaldi2_tpu_torch.graph import vfst as pvfst
from pykaldi2_tpu_torch.graph.topology import HmmTopology as PTopo
from pykaldi2_tpu_torch.graph.transition_model import TransitionModel as PTm

LEXICON = {"wa": [[1]], "wb": [[2, 3]], "wc": [[4]], "wd": [[3, 1], [2]]}
WORD_IDS = {"wa": 1, "wb": 2, "wc": 3, "wd": 4}


def canon(f):
    """An Fst as plain tuples: start, finals, every state's arcs in order."""
    return (f.start, sorted(f.finals.items()),
            [[(a.ilabel, a.olabel, a.weight, a.nextstate) for a in arcs] for arcs in f.arcs])


def random_fst(mod, seed, n=9, arcs=22, labels=4, eps_share=0.25, acyclic_eps=True):
    """The same random transducer built through either package's fst module;
    eps/eps arcs only go forward when ``acyclic_eps``."""
    rng = np.random.RandomState(seed)
    f = mod.Fst()
    for _ in range(n):
        f.add_state()
    f.set_start(0)
    for _ in range(arcs):
        s, d = (int(x) for x in rng.randint(0, n, 2))
        il, ol = (int(x) for x in rng.randint(1, labels + 1, 2))
        if rng.rand() < eps_share:
            il = ol = 0
            if acyclic_eps:
                s, d = min(s, d), max(s, d) + (s == d)
                if d >= n:
                    continue
        elif rng.rand() < 0.2:
            ol = 0
        f.add_arc(s, il, ol, float(np.round(rng.randn(), 3)), d)
    for s in rng.choice(n, 3, replace=False):
        f.set_final(int(s), float(np.round(rng.randn(), 3)))
    return f


def tms(topo="one"):
    make = "one_state" if topo == "one" else "three_state"
    return (JTm(getattr(JTopo, make)(range(1, 5))), PTm(getattr(PTopo, make)(range(1, 5))))


def bigram(mod):
    g = mod.Fst()
    a, b = g.add_state(), g.add_state()
    g.set_start(a)
    g.set_final(b, -0.1)
    for w in WORD_IDS.values():
        g.add_arc(a, w, w, -1.0 - 0.1 * w, b)
        g.add_arc(b, w, w, -0.5 * w, b)
    return g


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fst_algorithms_match(seed):
    jf, pf = random_fst(jfst, seed), random_fst(pfst, seed)
    assert canon(pf.connect()) == canon(jf.connect())
    for semiring in ("tropical", "log"):
        assert canon(pf.remove_input_epsilons(semiring)) == \
            canon(jf.remove_input_epsilons(semiring))
    jg, pg = random_fst(jfst, seed + 10, eps_share=0.1), random_fst(pfst, seed + 10, eps_share=0.1)
    assert canon(pf.compose(pg)) == canon(jf.compose(jg))


def test_eps_cycle_rejected_like_jax():
    for mod in (jfst, pfst):
        f = mod.Fst()
        a, b = f.add_state(), f.add_state()
        f.set_start(a)
        f.add_arc(a, 0, 0, -0.1, b)
        f.add_arc(b, 0, 0, -0.1, a)
        f.set_final(b, 0.0)
        with pytest.raises(ValueError, match="epsilon cycle"):
            f.remove_input_epsilons()


@pytest.mark.parametrize("sil", [(0, 0.0), (5, 0.5)])
def test_lexicon_and_linear_acceptors_match(sil):
    assert canon(pfst.make_lexicon_fst(LEXICON, WORD_IDS, *sil)) == \
        canon(jfst.make_lexicon_fst(LEXICON, WORD_IDS, *sil))
    assert canon(pfst.linear_acceptor([3, 1, 4], -0.5)) == \
        canon(jfst.linear_acceptor([3, 1, 4], -0.5))


@pytest.mark.parametrize("topo,grammar,sil", [
    ("one", False, 0.0), ("three", False, 0.0), ("one", True, 0.0), ("three", True, 0.5)])
def test_make_decode_graph_matches(topo, grammar, sil):
    jtm, ptm = tms(topo)
    kw = dict(sil_phone=1 if sil else 0, sil_prob=sil)
    want = jcompile.make_decode_graph(jtm, LEXICON, WORD_IDS,
                                      bigram(jfst) if grammar else None, **kw)
    got = pcompile.make_decode_graph(ptm, LEXICON, WORD_IDS,
                                     bigram(pfst) if grammar else None, **kw)
    assert canon(got) == canon(want)


def graphs(topo="one"):
    jtm, ptm = tms(topo)
    return (jtm, jcompile.make_decode_graph(jtm, LEXICON, WORD_IDS),
            pcompile.make_decode_graph(ptm, LEXICON, WORD_IDS))


def observations(tm, seed, t=12):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, tm.num_pdfs) * 2).astype(np.float32)


@pytest.mark.parametrize("topo,seed,penalty,vector", [
    ("one", 0, 0.0, False), ("one", 1, 1.5, False), ("three", 2, 0.0, False),
    ("three", 3, 0.5, True)])
def test_decoder_decode_matches(topo, seed, penalty, vector):
    """LatticeDecoder.decode: words, per-frame pdfs and score equal."""
    tm, jg, pg = graphs(topo)
    if vector:
        jg, pg = jvfst.VectorFst.from_fst(jg), pvfst.VectorFst.from_fst(pg)
    obs = observations(tm, seed, 30 if topo == "three" else 12)
    jd = jdec.LatticeDecoder(jg, beam=16.0, lattice_beam=8.0, word_penalty=penalty)
    pd = pdec.LatticeDecoder(pg, beam=16.0, lattice_beam=8.0, word_penalty=penalty)
    jw, jp, js = jd.decode(obs)
    pw, pp, ps = pd.decode(obs)
    assert pw == jw and len(pw) > 0
    np.testing.assert_array_equal(pp, jp)
    assert ps == js


def decoded_word_fsts(seed, topo="one", **kw):
    """The lattice of one decode, as word FSTs from both packages."""
    tm, jg, pg = graphs(topo)
    obs = observations(tm, seed)
    jl, jframes, _ = jdec.LatticeDecoder(jg, beam=32.0, lattice_beam=20.0).decode_lattice(
        obs, with_frames=True)
    pl, pframes, _ = pdec.LatticeDecoder(pg, beam=32.0, lattice_beam=20.0).decode_lattice(
        obs, with_frames=True)
    np.testing.assert_array_equal(pframes, jframes)
    return (jlat.lattice_word_fst(jl, loglikes=obs, frames=jframes, **kw),
            plat.lattice_word_fst(pl, loglikes=obs, frames=pframes, **kw), obs, jl, pl,
            jframes)


@pytest.mark.parametrize("seed,kw", [(1, {}), (4, {"acoustic_scale": 0.5}),
                                     (5, {"graph_scale": 2.0})])
def test_lattice_word_fst_nbest_best_path_oracle_match(seed, kw):
    jw, pw, *_ = decoded_word_fsts(seed, **kw)
    assert canon(pw) == canon(jw)
    assert plat.best_path(pw) == jlat.best_path(jw)
    for unique in (True, False):
        assert plat.nbest(pw, 6, unique) == jlat.nbest(jw, 6, unique)
    for ref in ([1, 2, 3], [4], [2, 2, 1, 3, 4], []):
        assert plat.oracle_errors(pw, ref) == jlat.oracle_errors(jw, ref)


def test_lmrescore_matches():
    def unigram(mod, scores):
        g = mod.Fst()
        s = g.add_state()
        g.set_start(s)
        g.set_final(s, 0.0)
        for w, sc in scores.items():
            g.add_arc(s, w, w, sc, s)
        return g

    jw, pw, *_ = decoded_word_fsts(6)
    old = {1: -1.0, 2: -2.0, 3: -1.5, 4: -0.7}
    new = {1: -3.0, 2: -0.5, 3: -1.0, 4: -2.0}
    for scale in (1.0, 2.0):
        got = plat.lmrescore(pw, unigram(pfst, old), unigram(pfst, new), lm_scale=scale)
        want = jlat.lmrescore(jw, unigram(jfst, old), unigram(jfst, new), lm_scale=scale)
        assert canon(got) == canon(want)
    assert canon(plat.lmrescore(pw, None, unigram(pfst, new))) == \
        canon(jlat.lmrescore(jw, None, unigram(jfst, new)))


@pytest.mark.parametrize("fmt", ["text", "ark"])
def test_lattice_archives_round_trip_across_packages(tmp_path, fmt):
    """Each package writes the same bytes and reads the other's file back
    to the same word FSTs."""
    lats = {}
    for seed in (7, 8):
        jw, pw, *_ = decoded_word_fsts(seed)
        lats[f"utt{seed}"] = (jw, pw)
    jwrite, jread = ((jlat.write_lattices_text, jlat.read_lattices_text) if fmt == "text"
                     else (jark.write_lattice_ark, jark.read_lattice_ark))
    pwrite, pread = ((plat.write_lattices_text, plat.read_lattices_text) if fmt == "text"
                     else (park.write_lattice_ark, park.read_lattice_ark))
    jpath, ppath = str(tmp_path / "j"), str(tmp_path / "p")
    jwrite(jpath, {u: j for u, (j, _) in lats.items()})
    pwrite(ppath, {u: p for u, (_, p) in lats.items()})
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    got, want = pread(jpath), jread(ppath)
    assert sorted(got) == sorted(want) == sorted(lats)
    for u in lats:
        assert canon(got[u]) == canon(want[u])


@pytest.mark.parametrize("seed", [9, 10])
def test_mbr_posteriors_pruning_and_ctm_match(seed):
    jw, pw, obs, jl, pl, frames = decoded_word_fsts(seed)
    jt, jtimes = jmbr.lattice_word_fst_timed(jl, loglikes=obs, frames=frames)
    pt, ptimes = pmbr.lattice_word_fst_timed(pl, loglikes=obs, frames=frames)
    assert canon(pt) == canon(jt) and ptimes == jtimes
    jpost, jz = jmbr.arc_log_posteriors(jw)  # posteriors need a trimmed word FST
    ppost, pz = pmbr.arc_log_posteriors(pw)
    assert pz == jz and len(ppost) == len(jpost)
    for a, b in zip(ppost, jpost):
        np.testing.assert_array_equal(a, b)
    for beam in (0.5, 4.0):
        assert canon(pmbr.prune_posterior(pw, beam)) == canon(jmbr.prune_posterior(jw, beam))
    jres = jmbr.mbr_decode(jt, arc_times=jtimes)
    pres = pmbr.mbr_decode(pt, arc_times=ptimes)
    assert dataclasses.asdict(pres) == dataclasses.asdict(jres) and pres.words
    for hyp in ([1, 2], pres.words):
        assert pmbr.expected_edit_distance(pt, hyp) == jmbr.expected_edit_distance(jt, hyp)
    outs = []
    for mod, res in ((jmbr, jres), (pmbr, pres)):
        buf = io.StringIO()
        mod.write_ctm(buf, "utt1", res, frame_shift=0.01, id2w={1: "wa", 2: "wb", 3: "wc"})
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[0]


def test_vector_fst_load_save_match(tmp_path):
    """Each package loads the other's .npz; conversions agree."""
    tm, jg, pg = graphs("three")
    jv, pv = jvfst.VectorFst.from_fst(jg), pvfst.VectorFst.from_fst(pg)
    jv.save(str(tmp_path / "j.npz"))
    pv.save(str(tmp_path / "p.npz"))
    back_p = pvfst.VectorFst.load(str(tmp_path / "j.npz"))
    back_j = jvfst.VectorFst.load(str(tmp_path / "p.npz"))
    for field in ("src", "dst", "ilabel", "olabel", "weight", "final"):
        np.testing.assert_array_equal(getattr(back_p, field), getattr(jv, field))
        np.testing.assert_array_equal(getattr(back_j, field), getattr(pv, field))
    assert (back_p.num_states, back_p.start, back_p.num_arcs) == \
        (jv.num_states, jv.start, jv.num_arcs)
    assert canon(back_p.to_fst()) == canon(jv.to_fst()) == canon(back_j.to_fst())


def test_openfst_binary_round_trip_across_packages(tmp_path):
    for seed in (11, 12):
        jf, pf = random_fst(jfst, seed), random_fst(pfst, seed)
        jpath, ppath = str(tmp_path / f"j{seed}.fst"), str(tmp_path / f"p{seed}.fst")
        jofst.write_openfst(jf, jpath)
        pofst.write_openfst(pf, ppath)
        assert open(ppath, "rb").read() == open(jpath, "rb").read()
        assert canon(pofst.read_openfst(jpath)) == canon(jofst.read_openfst(ppath))


def test_wer_matches():
    rng = np.random.RandomState(13)
    refs = {f"u{i}": list(rng.randint(0, 5, rng.randint(0, 8))) for i in range(12)}
    hyps = {u: list(rng.randint(0, 5, rng.randint(0, 8))) for u in list(refs)[:10]}
    for u in refs:
        if u in hyps:
            assert pwer.edit_distance(refs[u], hyps[u]) == jwer.edit_distance(refs[u], hyps[u])
    assert pwer.score_corpus(refs, hyps) == jwer.score_corpus(refs, hyps)
