"""Front end of the PyTorch port against pykaldi2_tpu.frontend and the golden.

Same numpy inputs through both packages. Tolerances: fp32 against fp32 —
the DFT/mel GEMMs sum in another order on each side, so log-mel values
(magnitude ~10) agree to ~1e-4; elementwise stages agree to ~1e-5.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pykaldi2_tpu import frontend as JF
from pykaldi2_tpu import config as JC
from pykaldi2_tpu.frontend import window as JW
from pykaldi2_tpu.frontend.fused import fused_fbank as jax_fused_fbank
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch import frontend as F
from pykaldi2_tpu_torch.frontend import window as W
from pykaldi2_tpu_torch.frontend import fused as FU
from pykaldi2_tpu_torch.frontend.fused import fused_fbank, fused_fbank_plain
from pykaldi2_tpu_torch.pipeline import FeaturePipeline, feature_dim

from kaldi_ref import ref_deltas, ref_fbank, ref_splice
from torch_port_helpers import pallas_interpret, to_np  # noqa: F401

LOGMEL_TOL = dict(rtol=1e-4, atol=1e-4)   # fp32 GEMMs, different summation order
ELEM_TOL = dict(rtol=1e-5, atol=1e-5)     # fp32 elementwise


def _wave(seed, b, s, scale=4000.0):
    return (np.random.RandomState(seed).randn(b, s) * scale).astype(np.float32)


@pytest.mark.parametrize("snip", [True, False])
@pytest.mark.parametrize("n", [0, 399, 400, 401, 1234, 16000])
def test_num_frames_and_indices(snip, n):
    fj, ft = JC.FrameOpts(snip_edges=snip), C.FrameOpts(snip_edges=snip)
    assert W.num_frames(n, ft) == JW.num_frames(n, fj)
    nf = W.num_frames(n, ft)
    if nf:
        np.testing.assert_array_equal(W._frame_indices(n, nf, ft),
                                      JW._frame_indices(n, nf, fj))


@pytest.mark.parametrize("wt", ["povey", "hamming", "hanning", "rectangular", "blackman", "sine"])
def test_feature_window_and_process_frames(wt):
    fj, ft = JC.FrameOpts(window_type=wt), C.FrameOpts(window_type=wt)
    np.testing.assert_array_equal(W.feature_window(ft), JW.feature_window(fj))
    frames = np.random.RandomState(1).randn(3, 5, ft.window_size).astype(np.float32) * 100
    got, e_got = W.process_frames(torch.from_numpy(frames), ft, return_log_energy=True)
    ref, e_ref = JW.process_frames(jnp.asarray(frames), fj, return_log_energy=True)
    np.testing.assert_allclose(to_np(got), to_np(ref), **ELEM_TOL)
    np.testing.assert_allclose(to_np(e_got), to_np(e_ref), **ELEM_TOL)


def test_mel_banks_identical():
    for warp in (1.0, 0.9, 1.1):
        a = F.mel_banks(C.MelOpts(num_bins=80), C.FrameOpts(), warp=warp)
        b = JF.mel_banks(JC.MelOpts(num_bins=80), JC.FrameOpts(), warp=warp)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [
    dict(),
    dict(use_energy=True),
    dict(use_energy=True, raw_energy=False, energy_floor=1.0),
    dict(use_power=False),
    dict(use_log_fbank=False),
    dict(frame=dict(snip_edges=False, window_type="hamming")),
])
def test_compute_fbank_matches_jax(case):
    case = dict(case)
    frame = case.pop("frame", {})
    wave = _wave(2, 2, 6000)
    ot = C.FbankOpts(frame_opts=C.FrameOpts(dither=0.0, **frame),
                     mel_opts=C.MelOpts(num_bins=23), **case)
    oj = JC.FbankOpts(frame_opts=JC.FrameOpts(dither=0.0, **frame),
                      mel_opts=JC.MelOpts(num_bins=23), **case)
    got = F.compute_fbank(torch.from_numpy(wave), ot)
    ref = JF.compute_fbank(jnp.asarray(wave), oj)
    assert got.shape == ref.shape
    tol = LOGMEL_TOL if ot.use_log_fbank else dict(rtol=1e-4, atol=1e-2)  # linear energies ~1e6
    np.testing.assert_allclose(to_np(got), to_np(ref), **tol)


def test_compute_fbank_vtln_bank_matches_jax():
    wave = _wave(3, 3, 5000)
    ot, oj = C.FbankOpts(mel_opts=C.MelOpts(num_bins=20)), JC.FbankOpts(mel_opts=JC.MelOpts(num_bins=20))
    bank = np.stack([F.mel_banks(ot.mel_opts, ot.frame_opts, warp=w) for w in (0.9, 1.0, 1.1)])
    sel = np.array([2, 0, 1], np.int32)
    got = F.compute_fbank(torch.from_numpy(wave), ot, mel_weights=torch.from_numpy(bank),
                          warp_select=torch.from_numpy(sel).long())
    ref = JF.compute_fbank(jnp.asarray(wave), oj, mel_weights=jnp.asarray(bank),
                           warp_select=jnp.asarray(sel))
    np.testing.assert_allclose(to_np(got), to_np(ref), **LOGMEL_TOL)


def test_dither_uses_generator():
    wave = torch.from_numpy(_wave(4, 2, 4000))
    o = C.FbankOpts(frame_opts=C.FrameOpts(dither=1.0))
    with pytest.raises(ValueError, match="Generator"):
        F.compute_fbank(wave, o)
    a = F.compute_fbank(wave, o, generator=torch.Generator().manual_seed(5))
    b = F.compute_fbank(wave, o, generator=torch.Generator().manual_seed(5))
    c = F.compute_fbank(wave, o, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("bins,wt,s", [(40, "povey", 8000), (80, "hamming", 4480),
                                       (80, "povey", 12800 + 240)])
def test_k1_plain_matches_jax_fused_interpret(bins, wt, s):
    """K1's plain version against the Pallas fused fbank in interpret mode."""
    wave = _wave(5, 3, s)
    ot = C.FbankOpts(frame_opts=C.FrameOpts(dither=0.0, window_type=wt),
                     mel_opts=C.MelOpts(num_bins=bins))
    oj = JC.FbankOpts(frame_opts=JC.FrameOpts(dither=0.0, window_type=wt),
                      mel_opts=JC.MelOpts(num_bins=bins))
    got = fused_fbank(torch.from_numpy(wave), ot)       # CPU tensor → plain version
    ref = jax_fused_fbank(jnp.asarray(wave), oj, interpret=True)
    assert got.shape == ref.shape
    np.testing.assert_allclose(to_np(got), to_np(ref), **LOGMEL_TOL)
    np.testing.assert_array_equal(to_np(got), to_np(fused_fbank_plain(torch.from_numpy(wave), ot)))


def test_k1_plain_matches_kaldi_golden():
    """K1's plain version against the scalar double-precision golden."""
    wave = _wave(6, 1, 4000, scale=3000.0)[0]
    ot = C.FbankOpts(frame_opts=C.FrameOpts(dither=0.0), mel_opts=C.MelOpts(num_bins=23))
    got = to_np(fused_fbank(torch.from_numpy(wave[None]), ot))[0]
    ref = ref_fbank(wave.astype(np.float64), num_bins=23)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)  # fp32 vs fp64 golden


# option sets whose mel filters K1/K4 sum over their runs of nonzero bins
# (csrc/fbank.cu): the 80-bin default, Kaldi's mfcc_hires bank, the 23-bin
# default, a VTLN-warped bank and 8 kHz audio
MEL_RANGE_CASES = {
    "80_bins": dict(mel=dict(num_bins=80)),
    "hires_40": dict(mel=dict(num_bins=40, low_freq=20.0, high_freq=-400.0)),
    "23_bins": dict(mel=dict(num_bins=23)),
    "vtln_0.9": dict(mel=dict(num_bins=80, vtln_warp=0.9)),
    "8khz_23": dict(frame=dict(samp_freq=8000.0), mel=dict(num_bins=23)),
}


def _range_opts(case):
    c = MEL_RANGE_CASES[case]
    return C.FbankOpts(frame_opts=C.FrameOpts(dither=0.0, **c.get("frame", {})),
                       mel_opts=C.MelOpts(**c["mel"]))


@pytest.mark.parametrize("case", sorted(MEL_RANGE_CASES))
def test_k1_mel_ranges_and_banded_product(case):
    """The host-built run [lo, hi) of each filter holds all its nonzero
    weights, and the mel product summed over those runs in ascending k in
    fp32 equals the dense product in the same order bit for bit, and the
    plain version's log-mel within 1e-5."""
    opts = _range_opts(case)
    fo = opts.frame_opts
    bank = F.mel_banks(opts.mel_opts, fo)
    rng = FU.mel_ranges(bank)
    m, k = bank.shape
    assert rng.shape == (m, 2) and rng.dtype == np.int32
    inside = (np.arange(k)[None] >= rng[:, :1]) & (np.arange(k)[None] < rng[:, 1:])
    assert not np.any(bank[~inside])
    live = rng[:, 1] > rng[:, 0]
    assert live.all() or case == "8khz_23"
    assert np.all(bank[np.flatnonzero(live), rng[live, 0]] != 0)
    assert np.all(bank[np.flatnonzero(live), rng[live, 1] - 1] != 0)

    wave = torch.from_numpy(_wave(7, 2, fo.window_size + 40 * fo.window_shift))
    idx, win, cos_w, sin_w, mel_t = FU._constants(opts, wave.shape[1], wave.device)
    frames = FU._centred_frames(wave, idx, fo)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    x = (frames - fo.preemph_coeff * prev) * win
    re, im = x @ cos_w, x @ sin_w
    power = (re * re + im * im).reshape(-1, k).numpy()
    dense = np.zeros((power.shape[0], m), np.float32)
    banded = np.zeros_like(dense)
    for f in range(m):
        for b in range(k):  # every term, ascending k
            dense[:, f] = dense[:, f] + power[:, b] * bank[f, b]
        for b in range(rng[f, 0], rng[f, 1]):  # the run's terms only
            banded[:, f] = banded[:, f] + power[:, b] * bank[f, b]
    assert np.array_equal(banded, dense)
    log_banded = np.log(np.maximum(banded, W.FLT_EPSILON))
    want = FU._logmel(frames, fo, win, cos_w, sin_w, mel_t).reshape(-1, m).numpy()
    np.testing.assert_allclose(log_banded, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mfcc", [False, True])
@pytest.mark.parametrize("frame", [dict(), dict(samp_freq=8000.0),
                                   dict(round_to_power_of_two=False),
                                   dict(samp_freq=32000.0)])
def test_k1_kernel_tables_hold_the_plain_tables(frame, mfcc):
    """The kernel's tables carry the plain version's: the same window; the
    blocked DFT table unblocks to cos and -sin of each bin interleaved
    (zeros beyond W rows and K bins); the packed weights with each filter's
    (lo, hi, offset) rebuild the mel bank; and for K4 the same lifted DCT.
    They depend on the options only: one entry serves every length."""
    fo = C.FrameOpts(dither=0.0, **frame)
    if mfcc:
        opts = C.MfccOpts(frame_opts=fo, num_ceps=40,
                          mel_opts=C.MelOpts(num_bins=40, low_freq=20.0, high_freq=-400.0))
        *plain, dct_plain = FU._mfcc_constants(opts, 16000, torch.device("cpu"))
    else:
        opts = C.FbankOpts(frame_opts=fo)
        plain = FU._constants(opts, 16000, torch.device("cpu"))
    _idx, win_plain, cos_w, sin_w, mel_t = plain
    win, cs, melw, band, dct_t, wp, kp = FU._kernel_tables(opts, torch.device("cpu"))
    assert FU._kernel_tables(opts, torch.device("cpu"))[1] is cs
    np.testing.assert_array_equal(win.numpy(), win_plain.numpy())
    if mfcc:
        np.testing.assert_array_equal(dct_t.numpy(), dct_plain.numpy())
    else:
        assert dct_t is None
    w, k = cos_w.shape
    assert (wp, kp) == FU.kernel_table_shape(fo.window_size, fo.padded_window_size // 2)
    assert wp % 16 == 0 and wp >= w and kp >= k and kp & (kp - 1) == 0
    assert tuple(cs.shape) == (2 * kp // 64, wp, 64)
    table = cs.numpy().transpose(1, 0, 2).reshape(wp, kp, 2)
    np.testing.assert_array_equal(table[:w, :k, 0], cos_w.numpy())
    np.testing.assert_array_equal(table[:w, :k, 1], sin_w.numpy())
    assert not table[w:].any() and not table[:, k:].any()
    bank = np.zeros((band.shape[0], k), np.float32)
    for f, (lo, hi, off) in enumerate(band.numpy()):
        bank[f, lo:hi] = melw.numpy()[off:off + hi - lo]
    np.testing.assert_array_equal(bank, mel_t.numpy().T)


@pytest.mark.parametrize("snip", [True, False])
@pytest.mark.parametrize("n", [400, 401, 1234, 16000])
def test_k1_kernel_frame_indices_match_the_table(snip, n):
    """K1/K4 compute each frame's sample indices (frame t starts at
    t * shift + ``_first_sample``, reflected into [0, S) and clipped) where
    the plain version reads ``_frame_indices``: the same indices."""
    fo = C.FrameOpts(snip_edges=snip)
    nf = W.num_frames(n, fo)
    i = (np.arange(nf)[:, None] * fo.window_shift + FU._first_sample(fo)
         + np.arange(fo.window_size)[None])
    i = np.where(i < 0, -i - 1, i)
    i = np.where(i >= n, 2 * n - i - 1, i)
    np.testing.assert_array_equal(np.clip(i, 0, n - 1), W._frame_indices(n, nf, fo))


@pytest.mark.parametrize("bad", [dict(dither=1.0), dict(use_energy=True),
                                 dict(use_log_fbank=False)])
def test_k1_rejects_unsupported_options(bad):
    dither = bad.pop("dither", 0.0)
    o = C.FbankOpts(frame_opts=C.FrameOpts(dither=dither), **bad)
    with pytest.raises(ValueError):
        fused_fbank(torch.zeros(1, 4000), o)


def test_cmvn_variants_match_jax():
    rng = np.random.RandomState(7)
    feats = (rng.randn(3, 50, 13) * 3 + 5).astype(np.float32)
    mask = np.ones((3, 50), np.float32)
    mask[1, 30:] = 0
    ft, fj, mt, mj = torch.from_numpy(feats), jnp.asarray(feats), torch.from_numpy(mask), jnp.asarray(mask)
    for nv in (False, True):
        np.testing.assert_allclose(to_np(F.utterance_cmvn(ft, nv, mask=mt)),
                                   to_np(JF.utterance_cmvn(fj, nv, mask=mj)), **ELEM_TOL)
        np.testing.assert_allclose(to_np(F.utterance_cmvn(ft, nv)),
                                   to_np(JF.utterance_cmvn(fj, nv)), **ELEM_TOL)
        np.testing.assert_allclose(to_np(F.apply_cmvn_sliding(ft, 20, nv)),
                                   to_np(JF.apply_cmvn_sliding(fj, 20, nv)), rtol=1e-4, atol=1e-4)
    stats = F.acc_cmvn_stats(feats[0], mask=mask[0])
    np.testing.assert_array_equal(stats, JF.acc_cmvn_stats(feats[0], mask=mask[0]))
    from pykaldi2_tpu.frontend.cmvn import cmvn_mean_std as jms
    from pykaldi2_tpu_torch.frontend.cmvn import cmvn_mean_std as tms

    for a, b in zip(tms(stats, True), jms(stats, True)):
        np.testing.assert_array_equal(a, b)
    m, s = tms(stats, True)
    np.testing.assert_allclose(to_np(F.apply_cmvn(ft, m, s)),
                               to_np(JF.apply_cmvn(fj, jnp.asarray(m), jnp.asarray(s))), **ELEM_TOL)


@pytest.mark.parametrize("order,window", [(1, 2), (2, 2), (2, 3)])
def test_deltas_match_jax_and_golden(order, window):
    feats = np.random.RandomState(8).randn(2, 30, 5).astype(np.float32)
    got = to_np(F.add_deltas(torch.from_numpy(feats), order, window))
    np.testing.assert_allclose(got, to_np(JF.add_deltas(jnp.asarray(feats), order, window)),
                               **ELEM_TOL)
    np.testing.assert_allclose(got[0], ref_deltas(feats[0].astype(np.float64), order, window),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("left,right", [(0, 0), (2, 0), (3, 2)])
def test_splice_matches_jax_and_golden(left, right):
    feats = np.random.RandomState(9).randn(2, 12, 4).astype(np.float32)
    got = to_np(F.splice_frames(torch.from_numpy(feats), left, right))
    np.testing.assert_array_equal(got, to_np(JF.splice_frames(jnp.asarray(feats), left, right)))
    np.testing.assert_array_equal(got[0], ref_splice(feats[0], left, right))


@pytest.mark.parametrize("delta,splice", [(0, (0, 0)), (2, (0, 0)), (0, (2, 2))])
def test_feature_pipeline_matches_jax_fused_path(pallas_interpret, delta, splice):
    """Waveform batch → features with K1 on the port side and the Pallas
    fused fbank (interpret mode) on the reference side, utterance CMVN over
    the frame mask, deltas and splicing."""
    from pykaldi2_tpu_torch.data.dataloader import chunk_samples

    kw = dict(delta_order=delta, splice_left=splice[0], splice_right=splice[1])
    ct = C.FeatConfig(fbank=C.FbankOpts(mel_opts=C.MelOpts(num_bins=24)), **kw)
    cj = JC.FeatConfig(fbank=JC.FbankOpts(mel_opts=JC.MelOpts(num_bins=24)), **kw)
    s = chunk_samples(20, ct.fbank.frame_opts)
    wave = _wave(10, 4, s)
    mask = np.ones((4, 20), np.float32)
    mask[2, 12:] = 0
    got = FeaturePipeline(ct)({"wave": torch.from_numpy(wave), "mask": torch.from_numpy(mask)})
    ref = JaxPipeline(cj)({"wave": jnp.asarray(wave), "mask": jnp.asarray(mask)})
    assert got.shape[-1] == feature_dim(ct)
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-4, atol=2e-4)


def test_feature_pipeline_global_cmvn_and_mfcc_guard(tmp_path):
    from pykaldi2_tpu.pipeline import save_cmvn_stats as jsave
    from pykaldi2_tpu_torch.pipeline import load_cmvn_stats

    stats = np.random.RandomState(11).rand(2, 25) * 10 + 1
    stats[0, -1] = 100.0
    p = str(tmp_path / "cmvn.mat")
    jsave(p, stats)
    np.testing.assert_array_equal(load_cmvn_stats(p), stats)
    ct = C.FeatConfig(fbank=C.FbankOpts(mel_opts=C.MelOpts(num_bins=24)),
                      cmvn=C.CmvnOpts(stats_path=p, norm_vars=True))
    cj = JC.FeatConfig(fbank=JC.FbankOpts(mel_opts=JC.MelOpts(num_bins=24)),
                       cmvn=JC.CmvnOpts(stats_path=p, norm_vars=True))
    wave = _wave(12, 2, 4000)
    got = FeaturePipeline(ct)({"wave": torch.from_numpy(wave)})
    ref = JaxPipeline(cj)({"wave": jnp.asarray(wave)})
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-4, atol=2e-4)
    # MFCC (through K4's plain version here) with global CMVN stats of its own
    # dimension: the same features as the JAX pipeline (cepstra up to ~100:
    # an atol of 2e-3 for fp32 products summed in another order)
    stats13 = np.random.RandomState(12).rand(2, 14) * 10 + 1
    stats13[0, -1] = 100.0
    p13 = str(tmp_path / "cmvn13.mat")
    jsave(p13, stats13)
    mt = C.MfccOpts(frame_opts=C.FrameOpts(dither=0.0))
    mj = JC.MfccOpts(frame_opts=JC.FrameOpts(dither=0.0))
    got = FeaturePipeline(C.FeatConfig(type="mfcc", mfcc=mt, cmvn=C.CmvnOpts(stats_path=p13)))(
        {"wave": torch.from_numpy(wave)})
    ref = JaxPipeline(JC.FeatConfig(type="mfcc", mfcc=mj, cmvn=JC.CmvnOpts(stats_path=p13)))(
        {"wave": jnp.asarray(wave)})
    assert got.shape == ref.shape and got.shape[-1] == 13
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-4, atol=2e-3)


def test_feature_pipeline_speaker_cmvn_and_vtln_extras_match_jax(tmp_path):
    """Per-row extras (speaker CMVN rows, VTLN warp ids) through batch_extras
    and the pipeline, on the same tables in both packages."""
    from pykaldi2_tpu.data import kaldi_io as jkio
    from pykaldi2_tpu.frontend.cmvn import acc_cmvn_stats as jacc

    rng = np.random.RandomState(13)
    u2s = tmp_path / "utt2spk"
    u2s.write_text("u1 spkA\nu2 spkA\nu3 spkB\n")
    ark, scp = str(tmp_path / "cmvn.ark"), str(tmp_path / "cmvn.scp")
    with jkio.ArkWriter(ark, scp, kind="mat") as w:
        for spk in ("spkA", "spkB"):
            w.write(spk, jacc(rng.randn(40, 24) * 2 + 3))
    warp = tmp_path / "utt2warp"
    warp.write_text("u1 0.9\nu2 1.1\nu3 1.0\n")
    kw = dict(utt2warp=str(warp))
    ct = C.FeatConfig(fbank=C.FbankOpts(mel_opts=C.MelOpts(num_bins=24)),
                      cmvn=C.CmvnOpts(norm_vars=True, utt2spk=str(u2s), spk_stats_scp=scp), **kw)
    cj = JC.FeatConfig(fbank=JC.FbankOpts(mel_opts=JC.MelOpts(num_bins=24)),
                       cmvn=JC.CmvnOpts(norm_vars=True, utt2spk=str(u2s), spk_stats_scp=scp), **kw)
    pt, pj = FeaturePipeline(ct), JaxPipeline(cj)
    ids = ["u2", "u1", "", "u3"]
    et, ej = pt.batch_extras(ids), pj.batch_extras(ids)
    assert sorted(et) == sorted(ej) == ["cmvn_mean", "cmvn_scale", "warp_id"]
    for k in et:
        np.testing.assert_array_equal(et[k], ej[k])
    wave = _wave(14, 4, 4000)
    got = pt({"wave": torch.from_numpy(wave), **{k: torch.from_numpy(v) for k, v in et.items()}})
    ref = pj({"wave": jnp.asarray(wave), **{k: jnp.asarray(v) for k, v in ej.items()}})
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-4, atol=2e-4)


def test_feature_pipeline_feats_mode_matches_jax():
    feats = (np.random.RandomState(15).randn(2, 30, 13) * 2 + 1).astype(np.float32)
    mask = np.ones((2, 30), np.float32)
    mask[1, 20:] = 0
    ct = C.FeatConfig(delta_order=1, splice_left=1, splice_right=1)
    cj = JC.FeatConfig(delta_order=1, splice_left=1, splice_right=1)
    got = FeaturePipeline(ct)({"feats": torch.from_numpy(feats), "mask": torch.from_numpy(mask)})
    ref = JaxPipeline(cj)({"feats": jnp.asarray(feats), "mask": jnp.asarray(mask)})
    np.testing.assert_allclose(to_np(got), to_np(ref), **ELEM_TOL)
