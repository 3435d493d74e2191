"""Block-sparse forward-backward (ops/fb_block.py) and K11's plain version
(ops/fb_block_cuda.py) against the JAX package's ops/fb_block.py.

  * ``pack_graph_blocks`` equals the reference's all-COO packing
    (``band_frac=0``) array for array, on odd state counts and block 8/16;
  * K11's plain version equals the reference's Pallas kernel
    ``_bmv_kernel`` run in interpret mode (PK2_PALLAS_BLOCKFB=1, as
    tests/test_fb_block.py:266-295 runs it), both orientations, with row
    counts that are not multiples of 8 — to fp32 reassociation (rtol 1e-6);
  * logZ, occupancies, grad(logZ), the expected accuracy (pdf and phone,
    with and without silence rules) and its gradient against the
    reference's default banded packing and against its arc tables, in both
    backward modes (full save, and √T remat forced by
    PK2_BLOCKFB_SAVE_BYTES=0); rtol 1e-5 on values and 1e-4 on gradients,
    the reference suite's own bounds;
  * ``mmi_objective`` (value and gradient, drop_frames and den_scale) on
    every denominator packing, against the reference.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pykaldi2_tpu.ops import fb as JF, fb_block as JB, fb_dense as JD
from pykaldi2_tpu.ops import se_losses as JS

from pykaldi2_tpu_torch.ops import fb as TF, fb_block as TB, fb_dense as TD
from pykaldi2_tpu_torch.ops import se_losses as TS
from pykaldi2_tpu_torch.ops.fb_block_cuda import block_matvec, block_matvec_plain

from torch_port_helpers import (  # noqa: F401
    both_fsas, chain_fsa_arrays, state_graph_arrays, value_and_grad_both, one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(params=["full", "remat"])
def save_mode(request, monkeypatch):
    """Both backward modes, in both packages (they read the same variable)."""
    if request.param == "remat":
        monkeypatch.setenv("PK2_BLOCKFB_SAVE_BYTES", "0")
    return request.param


@pytest.fixture
def pallas_block(monkeypatch):
    """The reference's Pallas matvec through the interpreter on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setenv("PK2_PALLAS_BLOCKFB", "1")


GRAPHS = {
    "random23_b8": (lambda: state_graph_arrays(7, num_states=21, num_arcs=60), 8),
    "random19_b16": (lambda: state_graph_arrays(12, num_states=19, num_arcs=60), 16),
    "random300_b16": (lambda: state_graph_arrays(1, num_states=300, num_arcs=900), 16),
    "chain_b8": (lambda: chain_fsa_arrays(num_chains=4, chain_len=9), 8),
}


@pytest.mark.parametrize("case", sorted(GRAPHS))
def test_pack_graph_blocks_equals_jax_all_coo(case):
    arrays, block = GRAPHS[case]
    jfsa, tfsa = both_fsas(arrays())
    jg = JB.pack_graph_blocks(jfsa, block=block, seg_len=3, band_frac=0)
    tg = TB.pack_graph_blocks(tfsa, block=block, seg_len=3)
    for name in ("bi", "bj", "wb", "bit", "bjt", "wbt", "state_pdf", "final", "state_phone"):
        want = getattr(jg, name)
        if want is None:
            assert getattr(tg, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(want), err_msg=name)
    assert (tg.start, tg.num_states, tg.num_padded, tg.block, tg.seg_len) == (
        jg.start, jg.num_states, jg.num_padded, jg.block, jg.seg_len)
    nblk = tg.num_padded // block
    for ptr, out in ((tg.rowptr, tg.bj), (tg.rowptr_t, tg.bjt)):
        counts = np.diff(ptr.numpy())
        np.testing.assert_array_equal(counts, np.bincount(out.numpy(), minlength=nblk))
        assert counts.min() >= 1  # every output block has a tile: K11 writes every block
    # K11's segments: runs of at most SEG_TILES tiles of one output block
    from pykaldi2_tpu_torch.ops.fb_block_cuda import SEG_TILES

    for ptr, seg, n in ((tg.rowptr, tg.segptr, tg.num_seg), (tg.rowptr_t, tg.segptr_t,
                                                             tg.num_seg_t)):
        per_block = np.diff(seg.numpy())
        np.testing.assert_array_equal(per_block, -(-np.diff(ptr.numpy()) // SEG_TILES))
        assert seg.numpy()[-1] == n
    # ... and their descriptors: (block, first tile, end tile, block's first segment)
    for ptr, seg, desc in ((tg.rowptr, tg.segptr, tg.segdesc),
                           (tg.rowptr_t, tg.segptr_t, tg.segdesc_t)):
        ptr, seg, desc = ptr.numpy(), seg.numpy(), desc.numpy()
        assert desc.shape == (seg[-1], 4) and desc.dtype == np.int32
        for j in range(nblk):
            d = desc[seg[j]:seg[j + 1]]
            assert (d[:, 0] == j).all() and (d[:, 3] == seg[j]).all()
            assert d[0, 1] == ptr[j] and d[-1, 2] == ptr[j + 1]
            np.testing.assert_array_equal(d[1:, 1], d[:-1, 2])
            assert ((d[:, 2] - d[:, 1] >= 1) & (d[:, 2] - d[:, 1] <= SEG_TILES)).all()
    assert tg.wb.dtype == tg.wbt.dtype == torch.float32


def test_pack_refuses_bf16_tiles_and_dense_blocks(monkeypatch):
    _jfsa, tfsa = both_fsas(state_graph_arrays(1, num_states=300, num_arcs=900))
    with pytest.raises(ValueError, match="too dense"):
        TB.pack_graph_blocks(tfsa, block=16, max_wb_bytes=1 << 10)
    monkeypatch.setenv("PK2_BLOCKFB_TILE_DTYPE", "bfloat16")
    with pytest.raises(ValueError, match="float32"):
        TB.pack_graph_blocks(tfsa, block=16)


@pytest.mark.parametrize("rows", [3, 5, 13])
@pytest.mark.parametrize("case", ["random23_b8", "chain_b8"])
def test_plain_matvec_matches_pallas_kernel(pallas_block, case, rows):
    arrays, block = GRAPHS[case]
    jfsa, tfsa = both_fsas(arrays())
    jg = JB.pack_graph_blocks(jfsa, block=block, seg_len=3, band_frac=0)
    tg = TB.pack_graph_blocks(tfsa, block=block, seg_len=3)
    lin = np.abs(np.random.RandomState(rows).randn(rows, tg.num_padded)).astype(np.float32)
    lin[:, tg.num_states:] = 0.0   # padded states carry 0 in linear form
    for transpose in (False, True):
        want = np.asarray(JB._block_matvec(jnp.asarray(lin), jg, transpose))
        got = block_matvec_plain(torch.tensor(lin), tg, transpose).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.all(got[:, tg.num_states:] == 0.0)
        # on a CPU tensor the wrapper is the plain version, and launches nothing
        launches = block_matvec.launches
        np.testing.assert_array_equal(block_matvec(torch.tensor(lin), tg, transpose).numpy(), got)
        assert block_matvec.launches == launches


def test_plain_matvec_matches_banded_reference():
    """The reference's default packing applies a dense band of popular
    block offsets; the port's one tile list gives the same product."""
    jfsa, tfsa = both_fsas(chain_fsa_arrays())
    jg = JB.pack_graph_blocks(jfsa, block=8, seg_len=4)
    assert len(jg.band_off) > 0
    tg = TB.pack_graph_blocks(tfsa, block=8, seg_len=4)
    lin = np.abs(np.random.RandomState(11).randn(2, tg.num_padded)).astype(np.float32)
    for transpose in (False, True):
        np.testing.assert_allclose(
            block_matvec_plain(torch.tensor(lin), tg, transpose).numpy(),
            np.asarray(JB._block_matvec(jnp.asarray(lin), jg, transpose)), rtol=1e-6, atol=1e-6)


CASES = {  # graph, block, seg_len, B, T, lengths (T not a multiple of seg_len in two)
    "random": (lambda: state_graph_arrays(0, num_states=23, num_arcs=70), 8, 3, 3, 7, [7, 5, 1]),
    "random_b16": (lambda: state_graph_arrays(1), 16, 4, 3, 7, [7, 5, 1]),
    "odd_seg": (lambda: state_graph_arrays(9, num_states=15, num_arcs=44), 8, 3, 2, 7, [7, 2]),
    # chains short enough that a final state is reachable within T frames
    "chain": (lambda: chain_fsa_arrays(num_chains=5, chain_len=4), 8, 3, 2, 6, [6, 4]),
}


def _case(name, jax_band=True):
    arrays, block, seg_len, b, t, lens = CASES[name]
    jfsa, tfsa = both_fsas(arrays())
    jg = JB.pack_graph_blocks(jfsa, block=block, seg_len=seg_len,
                              **({} if jax_band else {"band_frac": 0}))
    tg = TB.pack_graph_blocks(tfsa, block=block, seg_len=seg_len)
    obs = np.random.RandomState(b * 100 + t).randn(b, t, 5).astype(np.float32)
    return jfsa, jg, tg, obs, np.asarray(lens, np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_logz_occupancies_and_grad_match_jax(case, save_mode):
    jfsa, jg, tg, obs, lens = _case(case)
    (tz, tgrad), (jz, jgrad) = value_and_grad_both(
        lambda o: JB.fsa_logz_block(o, jg, jnp.asarray(lens)),
        lambda o: TB.fsa_logz_block(o, tg, torch.tensor(lens)), obs)
    np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-4, atol=1e-5)
    # and the arc tables, the reference every route answers to
    za, ga = JF.fsa_occupancies(jnp.asarray(obs), JF.pack_graph(jfsa), jnp.asarray(lens))
    tz2, tgam = TB.fsa_occupancies_block(torch.tensor(obs), tg, torch.tensor(lens))
    np.testing.assert_allclose(tz2.numpy(), np.asarray(za), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgam.numpy(), np.asarray(ga), rtol=1e-4, atol=1e-5)
    for row, n in enumerate(lens):
        assert np.all(tgam.numpy()[row, n:] == 0.0)  # frames past num_frames


@pytest.mark.parametrize("case", ["random", "odd_seg", "chain"])
@pytest.mark.parametrize("level,sil", [("pdf", None), ("phone", None), ("phone", False),
                                       ("pdf", True)])
def test_block_expected_accuracy_and_grad_match_jax(case, level, sil, save_mode):
    _jfsa, jg, tg, obs, lens = _case(case)
    rng = np.random.RandomState(31)
    ref = rng.randint(0, 6 if level == "phone" else 5, obs.shape[:2]).astype(np.int32)
    js = ts = None
    if sil is not None:
        mask = np.isin(np.arange(7), [1]).astype(np.float32)
        js = JF.SilenceOpts(jnp.asarray(mask), jnp.asarray(mask), sil)
        ts = TF.SilenceOpts(torch.tensor(mask), torch.tensor(mask), sil)
    (tf, tgrad), (jf, jgrad) = value_and_grad_both(
        lambda o: JB.fsa_expected_accuracy_block(o, jg, jnp.asarray(ref), jnp.asarray(lens),
                                                 level, js),
        lambda o: TB.fsa_expected_accuracy_block(o, tg, torch.tensor(ref), torch.tensor(lens),
                                                 level, ts), obs)
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-4, atol=1e-5)


def test_block_grad_matches_pallas_route(pallas_block):
    """The reference's own K11 route (all-COO packing, interpreted Pallas
    matvec) through grad(logZ) and the sMBR gradient."""
    _jfsa, jg, tg, obs, lens = _case("random", jax_band=False)
    ref = np.random.RandomState(42).randint(0, 5, obs.shape[:2]).astype(np.int32)
    for jfn, tfn in (
            (lambda o: JB.fsa_logz_block(o, jg, jnp.asarray(lens)),
             lambda o: TB.fsa_logz_block(o, tg, torch.tensor(lens))),
            (lambda o: JB.fsa_expected_accuracy_block(o, jg, jnp.asarray(ref), jnp.asarray(lens)),
             lambda o: TB.fsa_expected_accuracy_block(o, tg, torch.tensor(ref),
                                                      torch.tensor(lens)))):
        (tv, tgrad), (jv, jgrad) = value_and_grad_both(jfn, tfn, obs)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tgrad, jgrad, rtol=1e-4, atol=1e-5)


def _packings(jfsa, tfsa):
    return {"block": (JB.pack_graph_blocks(jfsa, block=8, seg_len=3),
                      TB.pack_graph_blocks(tfsa, block=8, seg_len=3)),
            "dense": (JD.pack_graph_dense(jfsa), TD.pack_graph_dense(tfsa)),
            "arc": (JF.pack_graph(jfsa), TF.pack_graph(tfsa))}


@pytest.mark.parametrize("route", ["block", "dense", "arc"])
@pytest.mark.parametrize("drop_frames,den_scale", [(True, 1.0), (False, 0.5)])
def test_mmi_objective_matches_jax(route, drop_frames, den_scale, save_mode):
    arrays = state_graph_arrays(12, num_states=19, num_arcs=60)
    jg, tg = _packings(*both_fsas(arrays))[route]
    rng = np.random.RandomState(3)
    B, T, P = 3, 6, 6   # pdf 5 is absent from the graph: drop_frames drops its frames
    obs = rng.randn(B, T, P).astype(np.float32)
    ali = rng.randint(0, P, (B, T)).astype(np.int32)
    ali[0, :3] = 5
    ali[1, 4:] = -1
    lens = np.array([6, 4, 6], np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32) * (ali >= 0)
    (tv, tgrad), (jv, jgrad) = value_and_grad_both(
        lambda o: JS.mmi_objective(o, jnp.asarray(ali), jg, jnp.asarray(lens),
                                   jnp.asarray(mask), drop_frames, den_scale),
        lambda o: TS.mmi_objective(o, torch.tensor(ali), tg, torch.tensor(lens),
                                   torch.tensor(mask), drop_frames, den_scale), obs)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgrad, jgrad, rtol=1e-4, atol=1e-5)
    assert np.any(tgrad[0, :3] != 0.0) != drop_frames


def test_mmi_and_smbr_losses_match_jax():
    jfsa, tfsa = both_fsas(state_graph_arrays(2, num_states=19, num_arcs=60))
    jg, tg = JD.pack_graph_dense(jfsa), TD.pack_graph_dense(tfsa)
    rng = np.random.RandomState(5)
    B, T, P = 2, 6, 5
    logits = rng.randn(B, T, P).astype(np.float32)
    ali = rng.randint(0, P, (B, T)).astype(np.int32)
    lens = np.array([6, 4], np.int32)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    prior = np.log(np.full(P, 1.0 / P, np.float32))
    jl, jaux = JS.mmi_loss(jnp.asarray(logits), jnp.asarray(ali), jnp.asarray(mask), jg,
                           jnp.asarray(lens), log_prior=jnp.asarray(prior))
    tl, taux = TS.mmi_loss(torch.tensor(logits), torch.tensor(ali), torch.tensor(mask), tg,
                           torch.tensor(lens), log_prior=torch.tensor(prior))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(taux["mmi_obj_per_frame"]), float(jaux["mmi_obj_per_frame"]),
                               rtol=1e-5)
    # the reference's smbr_loss runs the arc tables
    ja, ta = JF.pack_graph(jfsa), TF.pack_graph(tfsa)
    jl, _ = JS.smbr_loss(jnp.asarray(logits), jnp.asarray(ali), jnp.asarray(mask), ja,
                         jnp.asarray(lens))
    tl, _ = TS.smbr_loss(torch.tensor(logits), torch.tensor(ali), torch.tensor(mask), ta,
                         torch.tensor(lens))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_chip_smoke_chain_graph_is_benchs():
    """chip_smoke.py keeps its own copy of bench.py:463-499's
    ``_make_chain_graph`` (it imports nothing of the JAX side); both make the
    same graph."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    mods = {}
    for name in ("chip_smoke", "bench"):
        spec = importlib.util.spec_from_file_location(f"_{name}_under_test", root / f"{name}.py")
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    got = mods["chip_smoke"].make_chain_graph(7, 5, 20, seed=3)
    want = mods["bench"]._make_chain_graph(7, 5, 20, seed=3)
    assert (got.num_states, got.start) == (want.num_states, want.start)
    for name in ("src", "dst", "pdf", "weight", "final"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
