"""The port's device search (decode/device_lattice.py) against the JAX package on the CPU.

The same FST (built by the JAX package and copied arc for arc into the
port's ``Fst``) and the same numpy log-likelihoods go through both
``pack_decode_graph``s and both ``device_lattice_generate``s. Every table and
static field must be equal, and the lattices (src, dst, pdf, weight, final),
best scores, dropped counts and olabels bit-equal: the port's loop is the
same fp32 arithmetic in the same order (the frontier's ``torch.topk`` over
unique keys gives ``lax.top_k``'s order exactly, and the band sorts are
stable as ``lax.sort`` is). The graphs are tests/test_device_lattice.py's:
the toy word loop (wide and pruned beams, max_active, word penalty, band
overflow), backoff-style and ARPA word graphs (fold and in-frame eps), deep
eps chains, eps chains through final states and the random eps-DAG seeds.
Also: the frontier top-K against ``jax.lax.top_k``; the band sort's order of
±0.0 against ``lax.sort``; the native epilogue against numpy (the port's and
the JAX package's); compaction; and the MMI and sMBR losses with their
gradients on the device lattices against JAX's (fp32 summation order:
rtol 1e-5).
"""

import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pykaldi2_tpu.decode import device_lattice as JD
from pykaldi2_tpu.graph import HmmTopology, TransitionModel, make_decode_graph
from pykaldi2_tpu.graph.fst import EPS, Fst as JFst
from pykaldi2_tpu.ops import fb_lattice as JL

from pykaldi2_tpu_torch.decode import device_lattice as PD
from pykaldi2_tpu_torch.decode import frontier as FR
from pykaldi2_tpu_torch.graph.fst import Fst as PFst
from pykaldi2_tpu_torch.ops import fb_lattice as PL
from pykaldi2_tpu_torch.ops.fb import NEG_INF

sys.path.insert(0, "tests")

NUM_PDFS = 5
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)


def port_fst(f: JFst) -> PFst:
    """The JAX package's Fst copied arc for arc (the same float weights)."""
    g = PFst()
    for _ in range(f.num_states):
        g.add_state()
    g.set_start(f.start)
    for s in range(f.num_states):
        for a in f.arcs[s]:
            g.add_arc(s, a.ilabel, a.olabel, a.weight, a.nextstate)
    for s, w in f.finals.items():
        g.set_final(s, w)
    return g


def toy():
    tm = TransitionModel(HmmTopology.one_state(range(1, NUM_PDFS + 1)))
    lexicon = {f"w{p}": [[p]] for p in range(1, NUM_PDFS + 1)}
    word_ids = {f"w{p}": p for p in range(1, NUM_PDFS + 1)}
    graph = make_decode_graph(tm, lexicon, word_ids)
    rng = np.random.RandomState(7)
    lens = np.asarray([12, 9, 5], np.int32)
    obs = (rng.randn(len(lens), 12, NUM_PDFS) * 1.5).astype(np.float32)
    return graph, obs, lens


def backoff_style_graph():
    rng = np.random.RandomState(11)
    f = JFst()
    start = f.add_state()
    f.set_start(start)
    backoff = f.add_state()
    units = {p: f.add_state() for p in range(NUM_PDFS)}
    f.add_arc(start, EPS, EPS, -0.3, backoff)
    for p in range(NUM_PDFS):
        f.add_arc(start, p + 1, p + 1, float(-0.5 - rng.rand()), units[p])
        f.add_arc(backoff, p + 1, EPS, float(-0.2 - rng.rand()), units[p])
    for p in range(NUM_PDFS):
        f.add_arc(units[p], EPS, EPS, float(-0.4 - rng.rand()), backoff)
        f.add_arc(units[p], (p % NUM_PDFS) + 1, (p % NUM_PDFS) + 1,
                  float(-0.6 - rng.rand()), units[p % NUM_PDFS])
        f.set_final(units[p], float(-0.1 * p))
    obs = (np.random.RandomState(12).randn(2, 10, NUM_PDFS) * 1.5).astype(np.float32)
    return f, obs, np.asarray([10, 7], np.int32)


def deep_eps_graph():
    """Depth-2 eps chains (test_device_lattice.py's no-duplicate-links case)."""
    rng = np.random.RandomState(13)
    f = JFst()
    start = f.add_state()
    f.set_start(start)
    units = {p: f.add_state() for p in range(NUM_PDFS)}
    h1, h2 = f.add_state(), f.add_state()
    for p in range(NUM_PDFS):
        f.add_arc(start, p + 1, p + 1, float(-0.4 - rng.rand()), units[p])
        f.add_arc(h1, p + 1, EPS, float(-0.8 - rng.rand()), units[p])
        f.add_arc(h2, p + 1, EPS, float(-0.3 - rng.rand()), units[p])
        f.add_arc(units[p], (p + 1) % NUM_PDFS + 1, EPS, float(-0.9 - rng.rand()),
                  units[(p + 1) % NUM_PDFS])
        f.set_final(units[p], float(-0.1 * (p + 1)))
        f.add_arc(units[p], EPS, EPS, float(-0.5 - rng.rand()), h1)
    f.add_arc(h1, EPS, EPS, -0.25, h2)
    obs = (rng.randn(2, 9, NUM_PDFS) * 1.5).astype(np.float32)
    return f, obs, np.asarray([9, 6], np.int32)


def random_eps_dag(seed):
    """test_device_lattice.py's random eps DAGs (chains of depth >= 3)."""
    rng = np.random.RandomState(seed)
    f = JFst()
    start = f.add_state()
    f.set_start(start)
    units = [f.add_state() for _ in range(NUM_PDFS)]
    hubs = [f.add_state() for _ in range(3)]
    eps_rank = {s: r for r, s in enumerate(list(rng.permutation(units)) + hubs)}
    for p, u in enumerate(units):
        f.add_arc(start, p + 1, p + 1, float(-0.4 - rng.rand()), u)
        f.set_final(u, float(-0.1 * (p + 1)))
    f.add_arc(units[0], EPS, EPS, float(-0.5 - rng.rand()), hubs[0])
    f.add_arc(hubs[0], EPS, EPS, float(-0.3 - rng.rand()), hubs[1])
    f.add_arc(hubs[1], EPS, EPS, float(-0.2 - rng.rand()), hubs[2])
    for h in hubs:
        for p in range(NUM_PDFS):
            if rng.rand() < 0.7:
                f.add_arc(h, p + 1, EPS, float(-0.3 - rng.rand()), units[p])
    all_eps_states = units + hubs
    for _ in range(2 * NUM_PDFS):
        a, b = rng.choice(len(all_eps_states), 2, replace=False)
        sa, sb = all_eps_states[a], all_eps_states[b]
        if eps_rank[sa] > eps_rank[sb]:
            sa, sb = sb, sa
        f.add_arc(sa, EPS, EPS, float(-0.2 - rng.rand()), sb)
    for _ in range(2 * NUM_PDFS):
        a, b = rng.randint(NUM_PDFS), rng.randint(NUM_PDFS)
        f.add_arc(units[a], b + 1, EPS, float(-0.6 - rng.rand()), units[b])
    obs = (rng.randn(2, 8, NUM_PDFS) * 1.5).astype(np.float32)
    return f, obs, np.asarray([8, 5], np.int32)


def final_chain_graph():
    rng = np.random.RandomState(14)
    f = JFst()
    start = f.add_state()
    f.set_start(start)
    units = {p: f.add_state() for p in range(NUM_PDFS)}
    fin_hub = f.add_state()
    for p in range(NUM_PDFS):
        f.add_arc(start, p + 1, p + 1, float(-0.4 - rng.rand()), units[p])
        f.add_arc(units[p], (p + 1) % NUM_PDFS + 1, EPS, float(-0.6 - rng.rand()),
                  units[(p + 1) % NUM_PDFS])
        f.set_final(units[p], float(-0.2 * (p + 1)))
        f.add_arc(units[p], EPS, EPS, float(-0.3 - rng.rand()), fin_hub)
    f.set_final(fin_hub, -0.05)
    obs = (rng.randn(2, 8, NUM_PDFS) * 1.5).astype(np.float32)
    return f, obs, np.asarray([8, 5], np.int32)


def arpa_graph(seed=5, n_utts=4):
    """test_device_lattice.py's ARPA word-HCLG (backoff eps arcs, olabels)."""
    from test_arpa import _obs_for_words, _sentences, _toy_system
    from pykaldi2_tpu.graph.arpa import arpa_to_fst, train_arpa
    from pykaldi2_tpu.graph.compile import make_word_decode_graph

    rng = np.random.RandomState(seed)
    tm, vocab, word_ids, lexicon = _toy_system(rng, n_words=12)
    model = train_arpa(_sentences(rng, vocab, n=50, lo=2, hi=5), order=2)
    hclg = make_word_decode_graph(tm, lexicon, word_ids, arpa_to_fst(model, word_ids)).to_fst()
    utts = []
    for _ in range(n_utts):
        words = [vocab[rng.randint(len(vocab))] for _ in range(rng.randint(1, 4))]
        utts.append(_obs_for_words(tm, lexicon, words, rng))
    obs = np.zeros((len(utts), max(o.shape[0] for o in utts), tm.num_pdfs), np.float32)
    for i, o in enumerate(utts):
        obs[i, : o.shape[0]] = o
    return hclg, obs, np.asarray([o.shape[0] for o in utts], np.int32)


GRAPHS = {"toy": toy, "backoff": backoff_style_graph, "deep_eps": deep_eps_graph,
          "final_chain": final_chain_graph, "arpa": arpa_graph,
          "eps_dag21": lambda: random_eps_dag(21), "eps_dag22": lambda: random_eps_dag(22),
          "eps_dag23": lambda: random_eps_dag(23)}


def assert_graphs_equal(jg, tg):
    for f in PD._TENSORS:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for f in ("start", "num_states", "s_lo", "d_lo", "d_hi", "num_pdfs", "has_olabels",
              "eps_depth", "eps_layers_z1", "eps_layers_z2", "eps_layers_z3"):
        assert getattr(tg, f) == getattr(jg, f), f


def both(name, eps_mode="fold", word_penalty=0.0, **kw):
    """Pack one graph in both packages, search it in both; returns the JAX
    and port results ((lat, scores, dropped[, olabels]) each)."""
    f, obs, lens = GRAPHS[name]()
    jg = JD.pack_decode_graph(f, word_penalty=word_penalty, eps_mode=eps_mode)
    tg = PD.pack_decode_graph(port_fst(f), word_penalty=word_penalty, eps_mode=eps_mode)
    assert_graphs_equal(jg, tg)
    want = JD.device_lattice_generate(jnp.asarray(obs), jg, jnp.asarray(lens), **kw)
    got = PD.device_lattice_generate(torch.from_numpy(obs), tg, torch.from_numpy(lens), **kw)
    return want, got, (obs, lens, jg, tg)


def assert_search_equal(want, got):
    (jl, js, jd, *jo), (tl, ts, td, *to) = want, got
    for field, a, b in zip(jl._fields, jl, tl):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=field)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for a, b in zip(jo, to):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


SEARCHES = [
    ("toy", "fold", dict(beam=24.0, max_active=64, lattice_beam=12.0, max_arcs=256)),
    ("toy", "fold", dict(beam=5.0, max_active=64, lattice_beam=2.5, max_arcs=256)),
    ("toy", "fold", dict(beam=24.0, max_active=3, lattice_beam=12.0, max_arcs=256)),
    ("toy", "fold", dict(beam=24.0, max_active=64, lattice_beam=12.0, max_arcs=2)),
    ("toy", "fold", dict(beam=24.0, max_active=16, lattice_beam=12.0, max_arcs=128,
                         return_olabels=True)),
    ("backoff", "fold", dict(beam=24.0, max_active=64, lattice_beam=12.0, max_arcs=256)),
    ("backoff", "inframe", dict(beam=24.0, max_active=64, lattice_beam=12.0, max_arcs=256)),
    ("backoff", "inframe", dict(beam=24.0, max_active=64, lattice_beam=12.0, max_arcs=3)),
    ("deep_eps", "inframe", dict(beam=24.0, max_active=64, lattice_beam=12.0,
                                 max_arcs=2048)),
    ("final_chain", "inframe", dict(beam=24.0, max_active=64, lattice_beam=12.0,
                                    max_arcs=512)),
    ("eps_dag21", "inframe", dict(beam=30.0, max_active=64, lattice_beam=15.0,
                                  max_arcs=4096)),
    ("eps_dag22", "inframe", dict(beam=30.0, max_active=64, lattice_beam=15.0,
                                  max_arcs=4096)),
    ("eps_dag23", "inframe", dict(beam=30.0, max_active=64, lattice_beam=15.0,
                                  max_arcs=4096)),
    ("arpa", "fold", dict(beam=14.0, max_active=64, lattice_beam=7.0, max_arcs=512,
                          return_olabels=True)),
    ("arpa", "inframe", dict(beam=14.0, max_active=64, lattice_beam=7.0, max_arcs=512,
                             return_olabels=True)),
    ("arpa", "auto", dict(beam=14.0, max_active=8, lattice_beam=7.0, max_arcs=64,
                          return_olabels=True)),
]


@pytest.mark.parametrize("name,eps_mode,kw", SEARCHES,
                         ids=[f"{n}-{m}-{i}" for i, (n, m, _) in enumerate(SEARCHES)])
def test_search_matches_jax(name, eps_mode, kw):
    want, got, _ = both(name, eps_mode, **kw)
    assert_search_equal(want, got)
    if kw["max_arcs"] <= 3:
        assert int(got[2].sum()) > 0   # the band overflowed, and was counted


def test_word_penalty_matches_jax():
    want, got, _ = both("toy", word_penalty=2.0, beam=24.0, max_active=64,
                        lattice_beam=12.0, max_arcs=256)
    assert_search_equal(want, got)
    plain = both("toy", beam=24.0, max_active=64, lattice_beam=12.0, max_arcs=256)[1]
    assert not torch.equal(got[1], plain[1])


@pytest.mark.parametrize("name", ["toy", "backoff", "arpa", "deep_eps", "eps_dag21"])
@pytest.mark.parametrize("eps_mode", ["fold", "inframe", "auto"])
def test_pack_tables_match_jax(name, eps_mode):
    f = GRAPHS[name]()[0]
    has_eps = any(a.ilabel == EPS for s in range(f.num_states) for a in f.arcs[s])
    if eps_mode == "inframe" and not has_eps:
        eps_mode = "auto"   # the toy loop has no eps arc: both modes fold nothing
    assert_graphs_equal(JD.pack_decode_graph(f, eps_mode=eps_mode),
                        PD.pack_decode_graph(port_fst(f), eps_mode=eps_mode))


def test_pack_guards_match_jax():
    f2 = backoff_style_graph()[0]
    f2.add_arc(0, EPS, 3, -0.9, 1)
    for mode, msg in (("inframe", "olabel-free"), ("auto", "epsilon input arcs")):
        with pytest.raises(ValueError, match=msg):
            JD.pack_decode_graph(f2, eps_mode=mode)
        with pytest.raises(ValueError, match=msg):
            PD.pack_decode_graph(port_fst(f2), eps_mode=mode)


@pytest.mark.parametrize("b,s,k,tie_q", [(4, 1000, 8, None), (3, 4096, 64, 0.5),
                                         (2, 777, 16, 2.0), (5, 300, 32, 1.0),
                                         (2, 513, 200, 0.25), (3, 129, 129, None)])
def test_frontier_top_k_matches_lax_top_k(b, s, k, tie_q):
    """Values AND indices, ties (quantised values), ±0.0 (lax.top_k ranks
    +0.0 above −0.0), NEG_INF padding, S not a multiple of 128."""
    rng = np.random.RandomState(3 + s)
    a = rng.randn(b, s).astype(np.float32)
    if tie_q is not None:
        a = np.round(a / tie_q) * tie_q
    a[rng.rand(b, s) < 0.6] = NEG_INF
    zeros = rng.rand(b, s) < 0.05
    a[zeros] = np.where(rng.rand(int(zeros.sum())) < 0.5, -0.0, 0.0)
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(a), k)
    got_v, got_i = FR._frontier_top_k(torch.from_numpy(a), k)
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(ref_v).view(np.int32))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def test_band_sort_orders_signed_zeros_as_lax_sort():
    """The band sort's key is -score: lax.sort treats −0.0 and +0.0 as equal
    (stable), unlike lax.top_k; torch.sort(stable=True) does the same."""
    rng = np.random.RandomState(0)
    key = rng.choice(np.asarray([-0.0, 0.0, 1.0, -1.0, 1e30], np.float32), (3, 64))
    pay = np.broadcast_to(np.arange(64, dtype=np.int32), (3, 64))
    jk, jp = jax.lax.sort((jnp.asarray(key), jnp.asarray(pay)), dimension=1, num_keys=1)
    tk, perm = torch.sort(torch.from_numpy(key), dim=1, stable=True)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tk.numpy().view(np.int32), np.asarray(jk).view(np.int32))


def _random_band(seed, b, t, a, k, nf):
    rng = np.random.RandomState(seed)
    w = (rng.randn(b, t, a) * 0.5).astype(np.float32)
    w[rng.rand(b, t, a) < 0.5] = NEG_INF
    src = rng.randint(0, k, (b, t, a)).astype(np.int32)
    dst = rng.randint(0, k, (b, t, a)).astype(np.int32)
    pdf = rng.randint(0, 40, (b, t, a)).astype(np.int32)
    ol = rng.randint(0, 9, (b, t, a)).astype(np.int32)
    fin = np.where(rng.rand(b, k) < 0.3, rng.randn(b, k).astype(np.float32) * 0.2,
                   np.float32(NEG_INF)).astype(np.float32)
    fin[min(2, b - 1)] = NEG_INF     # a degenerate row: no finals at all
    return (src, dst, pdf, w, fin), ol, np.asarray(nf, np.int32)


def _assert_fsas_equal(ref, got):
    assert len(ref) == len(got)
    for (fr, rr), (fg, rg) in zip(ref, got):
        np.testing.assert_array_equal(rg, rr)
        assert fr.num_states == fg.num_states
        for f in ("src", "dst", "pdf", "weight", "final"):
            np.testing.assert_array_equal(getattr(fg, f), getattr(fr, f), err_msg=f)
        if fr.olabel is not None and fr.olabel.size:
            np.testing.assert_array_equal(fg.olabel, fr.olabel)


@pytest.mark.parametrize("with_olabels", [False, True])
def test_banded_to_fsas_native_matches_numpy(with_olabels):
    """The native epilogue against the port's numpy form and the JAX
    package's, on random bands with padding, variable nf, nf=0, nf out of
    range (clipped) and a row with no final."""
    arrs, ol, nf = _random_band(7, 5, 12, 64, 16, [15, 7, 12, -2, 3])
    olab = ol if with_olabels else None
    ref = JD._banded_to_fsas_np(JL.TimeSyncLattice(*arrs), nf, olabels=olab)
    tlat = PL.TimeSyncLattice(*(torch.from_numpy(x) for x in arrs))
    tol = None if olab is None else torch.from_numpy(olab)
    _assert_fsas_equal(ref, PD._banded_to_fsas_np(tlat, nf, olabels=tol))
    _assert_fsas_equal(ref, PD._banded_to_fsas_native(tlat, torch.from_numpy(nf), olabels=tol))


def test_compact_band_identical_output():
    """Extra NEG_INF padding on the band axis changes nothing: compaction
    slices only padding (valid links are a prefix), and the port's
    ``banded_to_fsas`` equals the JAX package's on the same band."""
    arrs, ol, nf = _random_band(11, 3, 9, 40, 16, [9, 5, 7])
    src, dst, pdf, w, fin = arrs
    src[:, 0, :] = 0
    w[:, :, 25:] = NEG_INF

    def padded(x, fill):
        return np.concatenate([x, np.full((3, 9, 600 - 40), fill, x.dtype)], axis=2)

    plain = PL.TimeSyncLattice(*(torch.from_numpy(x) for x in (src, dst, pdf, w, fin)))
    wide = PL.TimeSyncLattice(torch.from_numpy(padded(src, 0)), torch.from_numpy(padded(dst, 0)),
                              torch.from_numpy(padded(pdf, 0)),
                              torch.from_numpy(padded(w, NEG_INF)), torch.from_numpy(fin))
    lat_c, ol_c = PD._compact_band(wide, torch.from_numpy(padded(ol, 0)))
    assert lat_c.src.shape[2] == 128 and ol_c.shape[2] == 128
    for olab, olab_p in ((None, None), (ol, padded(ol, 0))):
        ref = JD.banded_to_fsas(JL.TimeSyncLattice(src, dst, pdf, w, fin), nf, olabels=olab)
        _assert_fsas_equal(ref, PD.banded_to_fsas(
            plain, nf, olabels=None if olab is None else torch.from_numpy(olab)))
        _assert_fsas_equal(ref, PD.banded_to_fsas(
            wide, nf, olabels=None if olab_p is None else torch.from_numpy(olab_p)))


def test_device_lattices_feed_mmi_and_smbr_like_jax():
    """The SE losses and their gradients on the device lattices of both
    packages (the on-the-fly consumer)."""
    want, got, (obs, lens, _jg, _tg) = both("toy", beam=16.0, max_active=32,
                                           lattice_beam=8.0, max_arcs=128)
    jlat, tlat = want[0], got[0]
    t = obs.shape[1]
    ali = np.random.RandomState(0).randint(0, NUM_PDFS, size=(len(lens), t)).astype(np.int32)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    jobs, jlens = jnp.asarray(obs), jnp.asarray(lens)

    def jmmi(o):
        return jnp.sum(JL.mmi_objective_lattice_ts(o, jnp.asarray(ali), jlat, jlens,
                                                   jnp.asarray(mask)))

    def jsmbr(o):
        return jnp.sum(JL.lattice_expected_accuracy_ts(o, jlat, jnp.asarray(ali), jlens,
                                                       "pdf", None, None))

    tlens = torch.from_numpy(lens).long()
    for jfn, tfn in (
            (jmmi, lambda o: PL.mmi_objective_lattice_ts(
                o, torch.from_numpy(ali).long(), tlat, tlens, torch.from_numpy(mask))),
            (jsmbr, lambda o: PL.lattice_expected_accuracy_ts(
                o, tlat, torch.from_numpy(ali).long(), tlens, "pdf", None, None))):
        jv, jgrad = jax.value_and_grad(jfn)(jobs)
        o = torch.tensor(obs, requires_grad=True)
        tv = tfn(o).sum()
        tv.backward()
        np.testing.assert_allclose(float(tv.detach()), float(jv), **LOSS_TOL)
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), **LOSS_TOL)


def test_eager_loop_holds_no_host_sync():
    """The captured loop may not read a tensor's value on the host: on the
    CPU the search runs with every host read of a tensor made an error."""
    f, obs, lens = backoff_style_graph()
    tg = PD.pack_decode_graph(port_fst(f), eps_mode="inframe")
    search = PD._Search(tg, 2, obs.shape[1], torch.device("cpu"), 64, 256, 24.0, 12.0, False)
    o, nf = torch.from_numpy(obs), torch.from_numpy(lens).long()
    banned = ("item", "tolist", "__bool__", "__int__", "__float__", "nonzero")
    saved = {n: getattr(torch.Tensor, n) for n in banned}

    def refuse(*_a, **_k):
        raise AssertionError("host sync inside the frame loop")

    try:
        for n in banned:
            setattr(torch.Tensor, n, refuse)
        search.run(o, nf)
        search.finish(nf)
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


@pytest.mark.parametrize("name,eps_mode,kw", [
    ("toy", "fold", dict(beam=24.0, max_active=16, lattice_beam=12.0, max_arcs=128)),
    ("arpa", "fold", dict(beam=14.0, max_active=64, lattice_beam=7.0, max_arcs=512)),
    ("arpa", "inframe", dict(beam=14.0, max_active=64, lattice_beam=7.0, max_arcs=512)),
    ("arpa", "inframe", dict(beam=14.0, max_active=6, lattice_beam=7.0, max_arcs=24)),
], ids=["toy", "arpa-fold", "arpa-inframe", "arpa-narrow"])
def test_frame_lattice_best_path_matches_word_acceptor(name, eps_mode, kw):
    """The decode CLI's best path over a device lattice (one Viterbi pass)
    gives ``best_path(lattice_word_fst(...))``'s words and score."""
    from pykaldi2_tpu_torch.decode.lattice import (best_path, frame_lattice_best_path,
                                                   lattice_word_fst)

    f, obs, lens = GRAPHS[name]()
    tg = PD.pack_decode_graph(port_fst(f), eps_mode=eps_mode)
    lat, _s, _d, olab = PD.device_lattice_generate(torch.from_numpy(obs), tg,
                                                   torch.from_numpy(lens),
                                                   return_olabels=True, **kw)
    for i, (fsa, frames) in enumerate(PD.banded_to_fsas(lat, lens, olab)):
        ll = obs[i, : lens[i]]
        try:
            want = best_path(lattice_word_fst(fsa, loglikes=ll, frames=frames))
        except ValueError:
            with pytest.raises(ValueError, match="no complete path"):
                frame_lattice_best_path(fsa, frames, ll)
            continue
        words, score = frame_lattice_best_path(fsa, frames, ll)
        assert words == want[0]
        np.testing.assert_allclose(score, want[1], rtol=1e-12)


# ---------------------------------------------------------------------------
# the frontier (decode/frontier.py): the plain version against the frame's
# former code, the K12 wrapper's checks, and the engagement counter
# ---------------------------------------------------------------------------


def _frame_frontier(search, t, obs_t, num_frames, alpha, slot_prev):
    """The first half of ``_Search.frame`` as the frame computed it before
    decode/frontier.py (its relax and eps_layer methods inlined), with the
    frame's closing ``where(active, ...)`` on alpha and slot."""
    g, b, K, L = search.g, search.b, search.K, search.L
    S1, S2 = g.s_lo, g.num_states - g.s_lo
    beam, lbeam, half = search.beam, search.lattice_beam, 0.5 * NEG_INF

    def relax(al):
        r_lo = torch.clamp_min(al.index_select(1, g.in_src_lo.reshape(-1)).view(b, S1, g.d_lo)
                               + g.in_w_lo, NEG_INF)
        if not S2:
            return r_lo, None
        r_hi = torch.clamp_min(al.index_select(1, g.in_src_hi.reshape(-1)).view(b, S2, g.d_hi)
                               + g.in_w_hi, NEG_INF)
        return r_lo, r_hi

    def eps_layer(al, r):
        for z, zsrc, zw, layers in ((g.eps_z1, g.eps_src_z1, g.eps_w_z1, g.eps_layers_z1),
                                    (g.eps_z2, g.eps_src_z2, g.eps_w_z2, g.eps_layers_z2),
                                    (g.eps_z3, g.eps_src_z3, g.eps_w_z3, g.eps_layers_z3)):
            if not z.shape[0]:
                continue
            lo, hi = layers[r], layers[r + 1]
            if hi > lo:
                e = zsrc.shape[1]
                rz = (al.index_select(1, zsrc[lo:hi].reshape(-1)).view(b, hi - lo, e)
                      + zw[lo:hi]).amax(dim=2)
                al = al.scatter_reduce(1, z[lo:hi].expand(b, hi - lo), rz, "amax")
        return al

    r_lo, r_hi = relax(alpha)
    m = r_lo.amax(dim=2)
    if S2:
        m = torch.cat([m, r_hi.amax(dim=2)], dim=1)
    obs_s = obs_t.index_select(1, g.state_pdf)
    new_alpha = torch.where(m > half, m + obs_s, NEG_INF)
    for r in range(L):
        new_alpha = eps_layer(new_alpha, r)
    best = new_alpha.amax(dim=1)
    s = new_alpha.shape[1]
    bits = new_alpha.contiguous().view(torch.int32).to(torch.int64)
    okey = torch.where(bits < 0, -(bits & 0x7FFFFFFF) - 1, bits)
    key = (~okey) * (1 << 32) + torch.arange(s, dtype=torch.int64)
    idx = torch.topk(key, K, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
    vals = new_alpha.gather(1, idx)
    keep_k = (vals >= best[:, None] - beam) & (vals > half)
    emit_k = keep_k & (vals >= best[:, None] - lbeam)
    cutoff = torch.maximum(best - beam, torch.where(keep_k[:, K - 1], vals[:, K - 1],
                                                    best - beam))[:, None]
    alpha_next = torch.where(new_alpha >= cutoff, new_alpha, NEG_INF)
    slot_cur = torch.full_like(slot_prev, -1).scatter_reduce(
        1, idx, torch.where(emit_k, torch.arange(K).expand(b, K), -1), "amax")
    act1 = (t < num_frames)[:, None]
    return (obs_s, vals, idx, keep_k, emit_k, torch.where(act1, alpha_next, alpha),
            torch.where(act1, slot_cur, slot_prev))


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _tied(x, rng, q):
    """x quantised to multiples of q (ties), with ±0.0 and NEG_INF entries,
    and one row all NEG_INF."""
    y = torch.round(x / q) * q
    u = torch.from_numpy(rng.rand(*x.shape))
    y = torch.where(u < 0.05, torch.tensor(-0.0), y)
    y = torch.where((u >= 0.05) & (u < 0.1), torch.tensor(0.0), y)
    y = torch.where((u >= 0.1) & (u < 0.3), torch.tensor(NEG_INF), y)
    y[-1] = NEG_INF
    return y.contiguous()


@pytest.mark.parametrize("inputs", ["search", "ties"])
@pytest.mark.parametrize("name,eps_mode,kw", SEARCHES,
                         ids=[f"{n}-{m}-{i}" for i, (n, m, _) in enumerate(SEARCHES)])
def test_frontier_plain_equals_the_frame(name, eps_mode, kw, inputs):
    """``frontier_plain`` gives, bit for bit, what the frame computed, frame
    by frame along each search (``search``), and on the same frames with
    alpha and the observations quantised so that scores tie, with ±0.0,
    NEG_INF entries and a NEG_INF row (``ties``)."""
    f, obs, lens = GRAPHS[name]()
    g = PD.pack_decode_graph(port_fst(f), eps_mode=eps_mode)
    b, t_len = obs.shape[:2]
    search = PD._Search(g, b, t_len, torch.device("cpu"), kw["max_active"], kw["max_arcs"],
                        kw["beam"], kw["lattice_beam"], kw.get("return_olabels", False))
    o, nf = torch.from_numpy(obs), torch.from_numpy(lens).long()
    rng = np.random.RandomState(len(name) + t_len)
    alpha, slot = search.alpha0, search.slot0
    for t in range(t_len):
        a_in, o_in = alpha, o[:, t]
        if inputs == "ties":
            a_in, o_in = _tied(alpha, rng, 0.5), _tied(o[:, t].clone(), rng, 0.25)
        want = _frame_frontier(search, t, o_in, nf, a_in, slot)
        got = FR.frontier_plain(g, a_in, o_in, slot, nf, t, search.K, search.beam,
                                search.lattice_beam)
        for field, x, y in zip(FR.Frontier._fields, got, want):
            assert x.dtype == y.dtype and x.shape == y.shape, field
            assert torch.equal(_bits(x), _bits(y)), (field, t)
        alpha, slot = search.frame(t, o[:, t], nf, alpha, slot)


def test_frontier_takes_the_plain_form_on_cpu():
    f, obs, lens = GRAPHS["deep_eps"]()
    g = PD.pack_decode_graph(port_fst(f), eps_mode="inframe")
    b, s = obs.shape[0], g.num_states
    alpha = g.eps0_w[None].expand(b, s).clone()
    slot = torch.zeros(b, s, dtype=torch.int64)
    nf = torch.from_numpy(lens).long()
    launches = FR.frontier.launches
    got = FR.frontier(g, FR.frontier_tables(g), alpha, torch.from_numpy(obs[:, 0]), slot, nf, 0,
                      4, 24.0, 12.0)
    want = FR.frontier_plain(g, alpha, torch.from_numpy(obs[:, 0]), slot, nf, 0, 4, 24.0, 12.0)
    for x, y in zip(got, want):
        assert torch.equal(_bits(x), _bits(y))
    assert FR.frontier.launches == launches


class _FakeSearchLib:
    """Stands in for csrc/search.cu's library: records the arguments of each
    launch and returns ``rc``."""

    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def pk2_search_frontier(self, args, smem, stream):
        a = args._obj
        self.calls.append({f: getattr(a, f) for f in ("B", "S", "K", "N", "L", "t", "row_smem",
                                                      "sort_smem", "beam", "lattice_beam")}
                          | {"smem": smem, "scratch": bool(a.scratch)})
        return self.rc


@pytest.fixture
def meta_frontier(monkeypatch):
    """A graph, its K12 tables and the wrapper's inputs as meta tensors (no
    memory: the shapes and dtypes of CUDA ones), with the launch's CUDA
    calls stubbed."""
    monkeypatch.setattr(FR.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(FR.D, "current_stream_ptr", lambda dev: None)
    f, obs, lens = GRAPHS["deep_eps"]()
    g_cpu = PD.pack_decode_graph(port_fst(f), eps_mode="inframe")
    g = g_cpu.to("meta")
    b, p, s = obs.shape[0], obs.shape[2], g.num_states
    meta = torch.device("meta")
    args = dict(alpha=torch.empty(b, s, device=meta),
                obs_t=torch.empty(b, 3, p, device=meta)[:, 1],
                slot_prev=torch.empty(b, s, dtype=torch.int64, device=meta),
                num_frames=torch.empty(b, dtype=torch.int64, device=meta))
    return g, FR.frontier_tables(g), args, g_cpu


def test_frontier_wrapper_launches_k12_off_the_cpu(meta_frontier, monkeypatch):
    g, tabs, args, _ = meta_frontier
    lib = _FakeSearchLib(0)
    monkeypatch.setattr(FR, "_lib", lambda: lib)
    launches = FR.frontier.launches
    out = FR.frontier(g, tabs, **args, t=3, k=4, beam=10.3, lattice_beam=4.0)
    b, s = args["alpha"].shape
    assert FR.frontier.launches == launches + 1
    assert [tuple(x.shape) for x in out] == [(b, s), (b, 4), (b, 4), (b, 4), (b, 4), (b, s),
                                             (b, s)]
    assert [x.dtype for x in out] == [torch.float32, torch.float32, torch.int64, torch.bool,
                                      torch.bool, torch.float32, torch.int64]
    call = lib.calls[0]
    assert (call["B"], call["S"], call["K"], call["N"], call["L"], call["t"]) == (
        b, s, 4, 32, g.eps_depth, 3)
    assert call["row_smem"] and call["sort_smem"] and not call["scratch"]
    assert call["smem"] == FR.FIXED_SMEM + 8 * s + 8 * 32
    assert call["beam"] == np.float32(10.3) and call["lattice_beam"] == 4.0
    lib.rc = 700
    with pytest.raises(RuntimeError, match=r"K12.*cudaError_t 700"):
        FR.frontier(g, tabs, **args, t=0, k=4, beam=10.0, lattice_beam=4.0)
    assert FR.frontier.launches == launches + 1


@pytest.mark.parametrize("fault,match", [
    ("alpha dtype", "alpha has dtype"), ("alpha shape", "alpha must be"),
    ("states", "K12 takes"), ("k zero", "K12 takes"), ("k above S", "K12 takes"),
    ("slot on cpu", "slot_prev is on cpu"), ("slot dtype", "slot_prev has dtype"),
    ("frames shape", "num_frames has shape"), ("obs stride", "unit column stride"),
    ("obs dtype", "obs_t must be"), ("tables on cpu", "tables.lo_src is on cpu"),
    ("tables dtype", "tables.pdf has dtype"), ("alpha strided", "alpha must be contiguous")])
def test_frontier_wrapper_refuses_what_k12_does_not_take(meta_frontier, monkeypatch, fault,
                                                         match):
    g, tabs, args, g_cpu = meta_frontier
    monkeypatch.setattr(FR, "_lib", lambda: pytest.fail("launched"))
    b, s = args["alpha"].shape
    meta = torch.device("meta")
    k = 4
    if fault == "alpha dtype":
        args["alpha"] = args["alpha"].double()
    elif fault == "alpha shape":
        args["alpha"] = args["alpha"][None]
    elif fault == "states":
        args["alpha"] = torch.empty(b, s + 1, device=meta)
    elif fault == "k zero":
        k = 0
    elif fault == "k above S":
        k = s + 1
    elif fault == "slot on cpu":
        args["slot_prev"] = torch.zeros(b, s, dtype=torch.int64)
    elif fault == "slot dtype":
        args["slot_prev"] = args["slot_prev"].int()
    elif fault == "frames shape":
        args["num_frames"] = args["num_frames"][:1]
    elif fault == "obs stride":
        args["obs_t"] = torch.empty(b, 8, device=meta)[:, ::2]
    elif fault == "obs dtype":
        args["obs_t"] = torch.empty(b, 8, dtype=torch.float16, device=meta)
    elif fault == "tables on cpu":
        tabs = FR.frontier_tables(g_cpu)
    elif fault == "tables dtype":
        tabs = tabs._replace(pdf=tabs.pdf.long())
    elif fault == "alpha strided":
        args["alpha"] = torch.empty(s, b, device=meta).t()
    launches = FR.frontier.launches
    with pytest.raises(ValueError, match=match):
        FR.frontier(g, tabs, **args, t=0, k=k, beam=10.0, lattice_beam=4.0)
    assert FR.frontier.launches == launches


@pytest.mark.parametrize("s,k,where", [(5167, 200, "both"), (5167, 5167, "both"), (128, 3, "both"),
                                       (2059, 2000, "both"), (60000, 200, "sort"),
                                       (60000, 7000, "sort"), (60000, 60000, "neither"),
                                       (20000, 20000, "rows")])
def test_frontier_smem_plan(s, k, where):
    """K12's shared memory holds the rows first, then the sort buffer; what
    does not fit is read from global memory, within the H100's limit."""
    row_smem, sort_smem, smem, n = FR.smem_plan(s, k)
    assert n >= max(k, 32) and n & (n - 1) == 0 and n < 2 * max(k, 32)
    assert (row_smem, sort_smem) == {"both": (True, True), "sort": (False, True),
                                     "rows": (True, False), "neither": (False, False)}[where]
    assert smem == FR.FIXED_SMEM + 8 * s * row_smem + 8 * n * sort_smem <= FR.MAX_SMEM


def test_search_frontier_counts_each_calls_frames(monkeypatch):
    """``search.frontier`` adds B x T for each call whose frames ran through
    K12, and nothing where the plain form ran: on the CPU, none; with the
    kernel's route taken (a stand-in that counts its frames and runs the
    plain form), B x T a call."""
    from pykaldi2_tpu_torch.utils import tracing

    f, obs, lens = GRAPHS["backoff"]()
    g = PD.pack_decode_graph(port_fst(f), eps_mode="inframe")
    b, t_len = obs.shape[:2]
    o, nf = torch.from_numpy(obs), torch.from_numpy(lens)
    kw = dict(beam=24.0, max_active=64, lattice_beam=12.0, max_arcs=256)
    search = PD.DeviceSearch(g)
    tracing.take()
    want = search(o, nf, **kw)
    assert "search.frontier" not in tracing.take()["counters"]
    frames = []

    def launch(g_, tabs, alpha, obs_t, *a):
        frames.append(alpha.shape[0])
        return FR.frontier_plain(g_, alpha, obs_t, *a)

    monkeypatch.setattr(FR, "takes_kernel", lambda dev: True)
    monkeypatch.setattr(PD, "takes_kernel", lambda dev: True)
    monkeypatch.setattr(FR, "_launch", launch)
    for calls in (1, 2):
        got = search(o, nf, **kw)
        assert tracing.take()["counters"]["search.frontier"] == (1, b * t_len)
        assert sum(frames) == calls * b * t_len
    for x, y in zip(want, got):
        assert all(map(torch.equal, x, y)) if isinstance(x, tuple) else torch.equal(x, y)
