"""Fixed-denominator forward-backward of the PyTorch port against the JAX
package: the arc tables (ops/fb.py), the dense state matrix
(ops/fb_dense.py), the structured bigram graph (ops/fb_bigram.py) and the
``pack_graph_auto`` routing.

The same numpy graphs and scores go through both packages (the cases of
tests/test_fb.py, test_fb_dense.py, test_fb_bigram.py and test_silence.py):
logZ, occupancies, grad(logZ) and the sMBR/MPE expected accuracy at pdf and
phone level, with and without Kaldi's silence rules, and its gradient.
Tolerances: both sides run the same fp32 recursion in another summation
order, so logZ and accuracies agree to rtol 1e-5 and occupancies and
gradients to rtol 1e-4 (the reference suite's own bounds, test_fb_block.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pykaldi2_tpu.graph import (HmmTopology as JTopo, TransitionModel as JTM,
                                estimate_phone_bigram as jax_bigram, make_den_graph as jax_den)
from pykaldi2_tpu.ops import fb as JF, fb_bigram as JB, fb_dense as JD

from pykaldi2_tpu_torch.graph import (HmmTopology, TransitionModel, estimate_phone_bigram,
                                      make_den_graph)
from pykaldi2_tpu_torch.ops import fb as TF, fb_bigram as TB, fb_dense as TD
from pykaldi2_tpu_torch.ops.fb_block import BlockSparseGraph

from torch_port_helpers import (  # noqa: F401
    both_fsas, state_graph_arrays, value_and_grad_both, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PHONES = [1, 2, 3, 4]
SEQS = [[1, 2, 3, 4], [2, 1], [3, 3, 2, 4]]
SIL = 2


def _den_graphs(nstates=3):
    """The 4-phone den graph of test_silence.py / test_fb_bigram.py in both
    packages: (JAX tm, port tm, JAX DenseFsa, port DenseFsa, JAX lm, port lm)."""
    topo = {1: "one_state", 3: "three_state"}[nstates]
    jtm, ttm = JTM(getattr(JTopo, topo)(PHONES)), TransitionModel(getattr(HmmTopology, topo)(PHONES))
    jlm, tlm = jax_bigram(SEQS, PHONES, smoothing=0.7), estimate_phone_bigram(SEQS, PHONES,
                                                                              smoothing=0.7)
    return jtm, ttm, jax_den(jtm, jlm), make_den_graph(ttm, tlm), jlm, tlm


def _silence(jtm, ttm, mode):
    if mode == "none":
        return None, None
    osc = mode == "one_class"
    return JF.make_silence_opts(jtm, [SIL], osc), TF.make_silence_opts(ttm, [SIL], osc)


def _ref(rng, level, shape, num_pdfs):
    if level == "pdf":
        return rng.randint(0, num_pdfs, shape).astype(np.int32)
    return rng.choice(PHONES, shape).astype(np.int32)


ROUTES = {
    "arc": (JF.pack_graph, TF.pack_graph, JF.fsa_logz, TF.fsa_logz, JF.fsa_occupancies,
            TF.fsa_occupancies, JF.fsa_expected_accuracy, TF.fsa_expected_accuracy),
    "dense": (JD.pack_graph_dense, TD.pack_graph_dense, JD.fsa_logz_dense, TD.fsa_logz_dense,
              JD.fsa_occupancies_dense, TD.fsa_occupancies_dense,
              JD.fsa_expected_accuracy_dense, TD.fsa_expected_accuracy_dense),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("seed,all_final", [(0, True), (1, False), (5, True)])
def test_logz_occupancies_and_grad_match_jax(route, seed, all_final):
    jpack, tpack, jlogz, tlogz, jocc, tocc, _, _ = ROUTES[route]
    jfsa, tfsa = both_fsas(state_graph_arrays(seed, num_states=17, num_arcs=50,
                                              all_final=all_final))
    jg, tg = jpack(jfsa), tpack(tfsa)
    rng = np.random.RandomState(seed + 100)
    obs = rng.randn(3, 7, 5).astype(np.float32)
    lens = np.array([7, 5, 1], np.int32)
    (tz, tgrad), (jz, jgrad) = value_and_grad_both(
        lambda o: jlogz(o, jg, jnp.asarray(lens)), lambda o: tlogz(o, tg, torch.tensor(lens)),
        obs)
    np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-4, atol=1e-5)
    tz2, tgam = tocc(torch.tensor(obs), tg, torch.tensor(lens))
    jz2, jgam = jocc(jnp.asarray(obs), jg, jnp.asarray(lens))
    np.testing.assert_allclose(tz2.numpy(), np.asarray(jz2), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgam.numpy(), np.asarray(jgam), rtol=1e-4, atol=1e-5)
    assert np.all(tgam.numpy()[2, 1:] == 0.0)  # frames past num_frames: no occupancy


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("level", ["pdf", "phone"])
@pytest.mark.parametrize("sil", ["none", "kaldi", "one_class"])
def test_expected_accuracy_and_grad_match_jax(route, level, sil):
    jpack, tpack, *_, jacc, tacc = ROUTES[route]
    jtm, ttm, jden, tden, _, _ = _den_graphs()
    jg, tg = jpack(jden), tpack(tden)
    js, ts = _silence(jtm, ttm, sil)
    rng = np.random.RandomState(3)
    B, T = 2, 11
    obs = rng.randn(B, T, jtm.num_pdfs).astype(np.float32)
    ref = _ref(rng, level, (B, T), jtm.num_pdfs)
    lens = np.array([T, T - 2], np.int32)
    (tf, tgrad), (jf, jgrad) = value_and_grad_both(
        lambda o: jacc(o, jg, jnp.asarray(ref), jnp.asarray(lens), level, js),
        lambda o: tacc(o, tg, torch.tensor(ref), torch.tensor(lens), level, ts), obs)
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-4, atol=1e-5)


def test_dense_packing_equals_jax_with_duplicate_arcs():
    """Duplicate arcs between one state pair add in prob space; -inf arcs
    contribute exactly 0."""
    a = state_graph_arrays(2, num_states=6, num_pdfs=3, num_arcs=18, all_final=False)
    a["src"] = np.concatenate([a["src"], a["src"][:3]])
    a["dst"] = np.concatenate([a["dst"], a["dst"][:3]])
    a["pdf"] = np.concatenate([a["pdf"], a["pdf"][:3]])
    a["weight"] = np.concatenate([a["weight"], np.array([-0.3, -np.inf, 0.2], np.float32)])
    a["phone"] = np.concatenate([a["phone"], a["phone"][:3]])
    jfsa, tfsa = both_fsas(a)
    jg, tg = JD.pack_graph_dense(jfsa), TD.pack_graph_dense(tfsa)
    np.testing.assert_array_equal(tg.w_exp.numpy(), np.asarray(jg.w_exp))
    np.testing.assert_array_equal(tg.state_pdf.numpy(), np.asarray(jg.state_pdf))
    np.testing.assert_array_equal(tg.state_phone.numpy(), np.asarray(jg.state_phone))
    np.testing.assert_array_equal(tg.final.numpy(), np.asarray(jg.final))


def test_pack_graph_auto_routes_as_jax():
    """dense ≤ max_states < block-sparse; invariant violations → arc tables."""
    for arrays, max_states, want in (
            (state_graph_arrays(0), 16384, TD.DenseStateGraph),
            (state_graph_arrays(1, num_states=300, num_arcs=900), 100, BlockSparseGraph)):
        jfsa, tfsa = both_fsas(arrays)
        assert isinstance(TD.pack_graph_auto(tfsa, max_states=max_states), want)
        assert type(JD.pack_graph_auto(jfsa, max_states=max_states)).__name__ == want.__name__
    bad = dict(num_states=3, src=np.array([0, 0], np.int32), dst=np.array([1, 1], np.int32),
               pdf=np.array([0, 1], np.int32), weight=np.zeros(2, np.float32),
               final=np.array([-np.inf, 0.0, -np.inf], np.float32), start=0)
    _jfsa, tfsa = both_fsas(bad)
    assert TD.state_emission_pdfs(tfsa) is None
    assert isinstance(TD.pack_graph_auto(tfsa, max_states=1), TF.GraphArrays)
    with pytest.raises(ValueError, match="state-emission"):
        TD.pack_graph_dense(tfsa)


@pytest.mark.parametrize("nstates", [1, 3])
def test_bigram_graph_equals_jax(nstates):
    jtm, ttm, _, _, jlm, tlm = _den_graphs(nstates)
    jg, tg = JB.make_bigram_den(jtm, jlm), TB.make_bigram_den(ttm, tlm)
    for name in ("pdf", "w_self", "w_fwd", "log_init", "lm_lin", "log_final", "onehot",
                 "phone_ids"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.num_pdfs == jg.num_pdfs


@pytest.mark.parametrize("nstates", [1, 3])
def test_bigram_logz_occupancies_and_grad_match_jax(nstates):
    jtm, ttm, _, _, jlm, tlm = _den_graphs(nstates)
    jg, tg = JB.make_bigram_den(jtm, jlm), TB.make_bigram_den(ttm, tlm)
    rng = np.random.RandomState(0)
    B, T = 3, 14
    obs = rng.randn(B, T, jtm.num_pdfs).astype(np.float32)
    lens = np.array([T, T - 2, nstates * 4], np.int32)  # incl. the minimum-length path
    (tz, tgrad), (jz, jgrad) = value_and_grad_both(
        lambda o: JB.bigram_logz(o, jg, jnp.asarray(lens)),
        lambda o: TB.bigram_logz(o, tg, torch.tensor(lens)), obs)
    np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-4, atol=1e-5)
    _, tgam = TB.bigram_occupancies(torch.tensor(obs), tg, torch.tensor(lens))
    _, jgam = JB.bigram_occupancies(jnp.asarray(obs), jg, jnp.asarray(lens))
    np.testing.assert_allclose(tgam.numpy(), np.asarray(jgam), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nstates", [1, 3])
@pytest.mark.parametrize("level", ["pdf", "phone"])
@pytest.mark.parametrize("sil", ["none", "kaldi", "one_class"])
def test_bigram_expected_accuracy_and_grad_match_jax(nstates, level, sil):
    jtm, ttm, _, _, jlm, tlm = _den_graphs(nstates)
    jg, tg = JB.make_bigram_den(jtm, jlm), TB.make_bigram_den(ttm, tlm)
    js, ts = _silence(jtm, ttm, sil)
    rng = np.random.RandomState(4)
    B, T = 2, 12
    obs = rng.randn(B, T, jtm.num_pdfs).astype(np.float32)
    ref = _ref(rng, level, (B, T), jtm.num_pdfs)
    lens = np.array([T, T - 3], np.int32)
    (tf, tgrad), (jf, jgrad) = value_and_grad_both(
        lambda o: JB.bigram_expected_accuracy(o, jg, jnp.asarray(ref), jnp.asarray(lens),
                                              level, js),
        lambda o: TB.bigram_expected_accuracy(o, tg, torch.tensor(ref), torch.tensor(lens),
                                              level, ts), obs)
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-4, atol=1e-5)


def test_bigram_refuses_mixed_topology():
    from pykaldi2_tpu_torch.graph.topology import HmmState

    topo = HmmTopology.three_state(PHONES)
    topo.entries[1] = [HmmState(j, [(j, 0.5), (j + 1, 0.5)]) for j in range(5)]
    tm = TransitionModel(topo)
    with pytest.raises(ValueError, match="uniform topology"):
        TB.make_bigram_den(tm, estimate_phone_bigram(SEQS, PHONES))
    den = make_den_graph(tm, estimate_phone_bigram(SEQS, PHONES))
    assert isinstance(TD.pack_graph_auto(den), TD.DenseStateGraph)
