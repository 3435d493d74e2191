"""The port's graph, FSA and decoder host layer against the JAX package.

The port keeps numpy copies of pykaldi2_tpu/graph and ops/fsa and its own
ctypes binding of native/latdec.cc (built into build/native/). Held here:
the on-the-fly denominator HCLG of the bench's 41-phone 3-state model
(bench.py:366-385) and the phone-bigram den graph come out arc for arc
equal; ``TransitionModel`` final.mdl files round-trip between the packages;
the port's decoder returns the JAX binding's lattice on the same obs; and
``pack_time_sync`` packs it into the same arrays.
"""

import numpy as np
import pytest

from pykaldi2_tpu.decode.decoder import LatticeDecoder as JDecoder
from pykaldi2_tpu.graph import HmmTopology as JTopo, TransitionModel as JTM
from pykaldi2_tpu.graph.compile import expand_to_pdf_fst as jax_expand_to_pdf_fst
from pykaldi2_tpu.graph.compile import make_den_graph as jax_make_den_graph
from pykaldi2_tpu.graph.fst import EPS as JEPS, Fst as JFst
from pykaldi2_tpu.graph.phone_lm import estimate_phone_bigram as jax_bigram
from pykaldi2_tpu.ops.fb_lattice import pack_time_sync as jax_pack
from pykaldi2_tpu.ops.fsa import load_fsa as jax_load_fsa, save_fsa as jax_save_fsa

from pykaldi2_tpu_torch.bin.train_se import phone_loop_den_fst
from pykaldi2_tpu_torch.decode.decoder import LatticeDecoder, build_native
from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel, estimate_phone_bigram
from pykaldi2_tpu_torch.graph.compile import make_den_graph
from pykaldi2_tpu_torch.graph.fst import Fst
from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones
from pykaldi2_tpu_torch.ops.fb_lattice import pack_time_sync
from pykaldi2_tpu_torch.ops.fsa import load_fsa, save_fsa

N_PHONES = 41


def _phone_seqs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, N_PHONES + 1, rng.randint(20, 60)).astype(np.int32)
            for _ in range(100)]


def _jax_otf_den_fst(tm, lm):
    """bench.py:373-385, the JAX package's on-the-fly den HCLG."""
    f = JFst()
    start = f.add_state()
    f.set_start(start)
    junction = {p: f.add_state() for p in tm.topo.phones}
    for p in tm.topo.phones:
        if np.isfinite(lm["log_init"][p]):
            f.add_arc(start, p, JEPS, float(lm["log_init"][p]), junction[p])
        for q in tm.topo.phones:
            if np.isfinite(lm["log_bigram"][p, q]):
                f.add_arc(junction[p], q, JEPS, float(lm["log_bigram"][p, q]), junction[q])
        f.set_final(junction[p], float(lm["log_final"][p]))
    return jax_expand_to_pdf_fst(f, tm)


def _fst_rows(fst):
    return ([(s, a.ilabel, a.olabel, a.weight, a.nextstate)
             for s in range(fst.num_states) for a in fst.arcs[s]],
            sorted(fst.finals.items()), fst.start, fst.num_states)


@pytest.fixture(scope="module")
def models():
    jtm = JTM(JTopo.three_state(range(1, N_PHONES + 1)))
    ttm = TransitionModel(HmmTopology.three_state(range(1, N_PHONES + 1)))
    seqs = _phone_seqs()
    jlm, tlm = jax_bigram(seqs, jtm.topo.phones), estimate_phone_bigram(seqs, ttm.topo.phones)
    return jtm, ttm, jlm, tlm


def test_phone_bigram_and_transition_model_match(models):
    jtm, ttm, jlm, tlm = models
    for k in ("log_init", "log_bigram", "log_final"):
        np.testing.assert_array_equal(tlm[k], jlm[k])
    assert tlm["phones"] == jlm["phones"]
    assert ttm.tuples == jtm.tuples and ttm.num_pdfs == jtm.num_pdfs == 123
    np.testing.assert_array_equal(ttm.log_probs, jtm.log_probs)
    np.testing.assert_array_equal(ttm.tid_to_pdf_array(), jtm.tid_to_pdf_array())
    np.testing.assert_array_equal(ttm.pdf_silence_mask([1, 2]), jtm.pdf_silence_mask([1, 2]))
    np.testing.assert_array_equal(collapse_to_phones(np.array([3, 3, 1, 1, 1, 4, 3])),
                                  [3, 1, 4, 3])


def test_otf_den_hclg_equals_jax_arc_for_arc(models):
    jtm, ttm, jlm, tlm = models
    got, want = _fst_rows(phone_loop_den_fst(ttm, tlm)), _fst_rows(_jax_otf_den_fst(jtm, jlm))
    assert got == want
    assert len(got[0]) > 10_000  # the full 41-phone bigram loop, 3-state expansion


def test_den_graph_equals_jax(models, tmp_path):
    jtm, ttm, jlm, tlm = models
    got, want = make_den_graph(ttm, tlm), jax_make_den_graph(jtm, jlm)
    assert got.num_states == want.num_states and got.start == want.start
    for name in ("src", "dst", "pdf", "weight", "final", "phone", "olabel"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    # npz interchange both ways
    save_fsa(str(tmp_path / "t.npz"), got)
    jax_save_fsa(str(tmp_path / "j.npz"), want)
    a, b = jax_load_fsa(str(tmp_path / "t.npz")), load_fsa(str(tmp_path / "j.npz"))
    for name in ("src", "dst", "pdf", "weight", "final"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_transition_model_final_mdl_round_trips_between_packages(models, tmp_path):
    jtm, ttm, _, _ = models
    tp, jp = str(tmp_path / "t.mdl"), str(tmp_path / "j.mdl")
    ttm.write_kaldi(tp)
    jtm.write_kaldi(jp)
    with open(tp, "rb") as f1, open(jp, "rb") as f2:
        assert f1.read() == f2.read()
    back_j, back_t = JTM.read_kaldi(tp), TransitionModel.read_kaldi(jp)
    assert back_j.tuples == ttm.tuples and back_t.tuples == jtm.tuples
    np.testing.assert_array_equal(back_t.log_probs, jtm.log_probs)
    assert back_t.topo.phones == jtm.topo.phones


def test_fst_text_io_interoperates(models, tmp_path):
    jtm, ttm, jlm, tlm = models
    fst = phone_loop_den_fst(ttm, tlm)
    path = str(tmp_path / "den.txt")
    fst.write_text(path)
    jback, tback = JFst.read_text(path), Fst.read_text(path)
    assert _fst_rows(tback)[0][:50] == _fst_rows(jback)[0][:50]
    assert _fst_rows(tback)[1:] == _fst_rows(jback)[1:]


def _decode_both(models, seed, n_utts=3, t_len=60, beam=10.0, lattice_beam=4.0,
                 max_active=200):
    jtm, ttm, jlm, tlm = models
    rng = np.random.RandomState(seed)
    jdec = JDecoder(_jax_otf_den_fst(jtm, jlm), beam=beam, max_active=max_active,
                    lattice_beam=lattice_beam)
    tdec = LatticeDecoder(phone_loop_den_fst(ttm, tlm), beam=beam, max_active=max_active,
                          lattice_beam=lattice_beam)
    out = []
    for _ in range(n_utts):
        # peaked scaled log-likelihoods, as acoustic_scores gives a trained model
        ll = (0.1 * (rng.randn(t_len, jtm.num_pdfs) * 3.0)).astype(np.float32)
        out.append((jdec.decode_lattice(ll, with_frames=True),
                    tdec.decode_lattice(ll, with_frames=True)))
    return out


def test_port_decoder_gives_the_jax_lattice(models):
    assert build_native().exists()
    for (jfsa, jfr, jscore), (tfsa, tfr, tscore) in _decode_both(models, 3):
        assert tfsa.num_states == jfsa.num_states and tfsa.num_arcs == jfsa.num_arcs > 0
        for name in ("src", "dst", "pdf", "olabel"):
            np.testing.assert_array_equal(getattr(tfsa, name), getattr(jfsa, name))
        # graph scores accumulate in the C++ search: the two builds may
        # contract multiply-adds differently (the committed library is built
        # with -march=native), so weights agree to fp32 rounding
        np.testing.assert_allclose(tfsa.weight, jfsa.weight, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(tfsa.final, jfsa.final, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(tfr, jfr)
        assert abs(tscore - jscore) <= 1e-3 * max(1.0, abs(jscore))


def test_pack_time_sync_equals_jax(models):
    pairs = _decode_both(models, 4, n_utts=4, t_len=40)
    jlat = jax_pack([(j[0], j[1]) for j, _ in pairs], t_pad=48)
    tlat = pack_time_sync([(t[0], t[1]) for _, t in pairs], t_pad=48)
    for name in ("src", "dst", "pdf"):
        np.testing.assert_array_equal(getattr(tlat, name).numpy(),
                                      np.asarray(getattr(jlat, name)), err_msg=name)
    np.testing.assert_allclose(tlat.weight.numpy(), np.asarray(jlat.weight),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tlat.final.numpy(), np.asarray(jlat.final),
                               rtol=1e-6, atol=1e-5)
    assert tlat.num_slots >= 8 and tlat.src.shape[2] >= 64
