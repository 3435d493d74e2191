"""MFCC of the PyTorch port (``compute_mfcc``, K4's plain version, the
pipeline's routing) against pykaldi2_tpu.frontend and the golden.

Same numpy inputs through both packages. Tolerances: the DFT, mel and DCT
products sum in another order on each side; log-mel values (~10) agree to
~1e-4, and the DCT sums 23-40 of them with weights up to ~0.3 and a lifter
up to ~11.5, so cepstra (up to ~100 in c0) agree to rtol 1e-4 with an atol
of 1e-3 (CEPS_TOL). Against the fp64 golden, fp32 rounding of the log-mels
adds up to ~1e-3 relative: rtol 1e-4, atol 2e-2 (GOLDEN_TOL), the bound
tests/test_fused_frontend.py uses for fp32 against fp64.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pykaldi2_tpu import config as JC
from pykaldi2_tpu import frontend as JF
from pykaldi2_tpu.frontend.fused import fused_mfcc as jax_fused_mfcc
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch import frontend as F
from pykaldi2_tpu_torch import pipeline as P
from pykaldi2_tpu_torch.frontend import fused as FU
from pykaldi2_tpu_torch.frontend.mfcc import dct_matrix, lifter_coeffs

from kaldi_ref import ref_mfcc
from torch_port_helpers import pallas_interpret, to_np  # noqa: F401

CEPS_TOL = dict(rtol=1e-4, atol=1e-3)     # fp32 products in another order
GOLDEN_TOL = dict(rtol=1e-4, atol=2e-2)   # fp32 against the fp64 golden

# Kaldi's default MFCC (13 cepstra over 23 bins, energy in c0), the hires
# options of egs/librispeech/s5/conf/mfcc_hires.conf, and the energy variants
CASES = {
    "default": dict(),
    "hires": dict(num_ceps=40, use_energy=False,
                  mel=dict(num_bins=40, low_freq=20.0, high_freq=-400.0)),
    "windowed_energy": dict(raw_energy=False),
    "energy_floor": dict(energy_floor=1e4),
    "no_lifter_hamming": dict(cepstral_lifter=0.0, frame=dict(window_type="hamming")),
}


def _opts(pkg, case: dict):
    case = dict(case)
    frame = case.pop("frame", {})
    mel = case.pop("mel", {})
    return pkg.MfccOpts(frame_opts=pkg.FrameOpts(dither=0.0, **frame),
                        mel_opts=pkg.MelOpts(**{"num_bins": 23, **mel}), **case)


def _wave(seed, b, s, scale=4000.0):
    return (np.random.RandomState(seed).randn(b, s) * scale).astype(np.float32)


def test_dct_and_lifter_are_the_reference_copies():
    from pykaldi2_tpu.frontend.mfcc import dct_matrix as jdct, lifter_coeffs as jlift

    for c, m in ((13, 23), (40, 40)):
        np.testing.assert_array_equal(dct_matrix(c, m), jdct(c, m))
    np.testing.assert_array_equal(lifter_coeffs(13, 22.0), jlift(13, 22.0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_compute_mfcc_matches_jax(name):
    wave = _wave(1, 2, 6000)
    got = F.compute_mfcc(torch.from_numpy(wave), _opts(C, CASES[name]))
    ref = JF.compute_mfcc(jnp.asarray(wave), _opts(JC, CASES[name]))
    assert got.shape == ref.shape
    np.testing.assert_allclose(to_np(got), to_np(ref), **CEPS_TOL)


@pytest.mark.parametrize("name", ["default", "hires", "windowed_energy", "no_lifter_hamming"])
def test_compute_mfcc_matches_kaldi_golden(name):
    case = dict(CASES[name])
    frame, mel = case.pop("frame", {}), case.pop("mel", {})
    wave = _wave(2, 1, 4000, scale=3000.0)[0]
    got = to_np(F.compute_mfcc(torch.from_numpy(wave[None]), _opts(C, CASES[name])))[0]
    ref = ref_mfcc(wave.astype(np.float64), num_bins=mel.get("num_bins", 23),
                   num_ceps=case.get("num_ceps", 13),
                   cepstral_lifter=case.get("cepstral_lifter", 22.0),
                   use_energy=case.get("use_energy", True),
                   raw_energy=case.get("raw_energy", True),
                   low_freq=mel.get("low_freq", 20.0), high_freq=mel.get("high_freq", 0.0),
                   **frame)
    np.testing.assert_allclose(got, ref, **GOLDEN_TOL)


def test_compute_mfcc_vtln_bank_matches_jax():
    wave = _wave(3, 3, 5000)
    ot, oj = _opts(C, {}), _opts(JC, {})
    bank = np.stack([F.mel_banks(ot.mel_opts, ot.frame_opts, warp=w) for w in (0.9, 1.1)])
    sel = np.array([1, 0, 1], np.int32)
    got = F.compute_mfcc(torch.from_numpy(wave), ot, mel_weights=torch.from_numpy(bank),
                         warp_select=torch.from_numpy(sel).long())
    ref = JF.compute_mfcc(jnp.asarray(wave), oj, mel_weights=jnp.asarray(bank),
                          warp_select=jnp.asarray(sel))
    np.testing.assert_allclose(to_np(got), to_np(ref), **CEPS_TOL)
    # the warp changes the features: row 1 is not row 0's warp
    plain = F.compute_mfcc(torch.from_numpy(wave), ot)
    assert not np.allclose(to_np(got)[1], to_np(plain)[1], **CEPS_TOL)


def test_compute_mfcc_dither_uses_generator():
    wave = torch.from_numpy(_wave(4, 2, 4000))
    o = C.MfccOpts(frame_opts=C.FrameOpts(dither=1.0))
    with pytest.raises(ValueError, match="Generator"):
        F.compute_mfcc(wave, o)
    a = F.compute_mfcc(wave, o, generator=torch.Generator().manual_seed(5))
    b = F.compute_mfcc(wave, o, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["default", "hires", "energy_floor", "no_lifter_hamming"])
def test_k4_plain_matches_jax_fused_interpret(name):
    """K4's plain version against the Pallas fused MFCC in interpret mode."""
    wave = _wave(5, 3, 8000)
    got = FU.fused_mfcc(torch.from_numpy(wave), _opts(C, CASES[name]))  # CPU → plain
    ref = jax_fused_mfcc(jnp.asarray(wave), _opts(JC, CASES[name]), interpret=True)
    assert got.shape == ref.shape
    np.testing.assert_allclose(to_np(got), to_np(ref), **CEPS_TOL)
    np.testing.assert_array_equal(
        to_np(got), to_np(FU.fused_mfcc_plain(torch.from_numpy(wave), _opts(C, CASES[name]))))


def test_k4_on_cpu_is_the_plain_version_and_rejects_dither():
    wave = torch.from_numpy(_wave(6, 2, 4000))
    before = FU.fused_mfcc.launches
    o = _opts(C, {})
    assert torch.equal(FU.fused_mfcc(wave, o), FU.fused_mfcc_plain(wave, o))
    assert FU.fused_mfcc.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="dither"):
        FU.fused_mfcc(wave, C.MfccOpts(frame_opts=C.FrameOpts(dither=1.0)))


@pytest.mark.parametrize("case,dither,fused", [
    (dict(), 0.0, True),                       # Kaldi default, raw energy: K4
    (CASES["hires"], 0.0, True),               # hires, no energy: K4
    (dict(), 1.0, False),                      # dithered: the plain front end
    (dict(raw_energy=False), 0.0, False),      # windowed energy: not K4's energy
])
def test_pipeline_routes_mfcc_like_the_reference(monkeypatch, case, dither, fused):
    calls = []
    monkeypatch.setattr(P, "fused_mfcc", lambda w, o: calls.append("k4") or FU.fused_mfcc(w, o))
    monkeypatch.setattr(P, "compute_mfcc",
                        lambda w, o, **kw: calls.append("plain") or F.compute_mfcc(w, o, **kw))
    opts = _opts(C, case)
    opts.frame_opts.dither = dither
    pipe = P.FeaturePipeline(C.FeatConfig(type="mfcc", mfcc=opts))
    feats = pipe({"wave": torch.from_numpy(_wave(7, 2, 4000))},
                 torch.Generator().manual_seed(0))
    assert calls == (["k4"] if fused else ["plain"])
    assert feats.shape[-1] == P.feature_dim(pipe.cfg)
    # the JAX pipeline makes the same choice (its K4 gate, pipeline.py:196-202,
    # with the Pallas kernels enabled as on the TPU)
    monkeypatch.setenv("PK2_PALLAS_FBANK", "1")
    jpipe = JaxPipeline(JC.FeatConfig(type="mfcc", mfcc=_opts(JC, case)))
    jpipe.cfg.mfcc.frame_opts.dither = dither
    assert jpipe._use_fused_mfcc() == fused


@pytest.mark.parametrize("name,delta", [("default", 2), ("hires", 0)])
def test_feature_pipeline_mfcc_matches_jax_fused_path(pallas_interpret, name, delta):
    """Waveform batch → MFCC features with K4 on the port side and the
    Pallas fused MFCC (interpret mode) on the reference side, utterance CMVN
    over the frame mask, and deltas."""
    from pykaldi2_tpu_torch.data.dataloader import chunk_samples

    ct = C.FeatConfig(type="mfcc", mfcc=_opts(C, CASES[name]), delta_order=delta)
    cj = JC.FeatConfig(type="mfcc", mfcc=_opts(JC, CASES[name]), delta_order=delta)
    s = chunk_samples(20, ct.mfcc.frame_opts)
    wave = _wave(8, 4, s)
    mask = np.ones((4, 20), np.float32)
    mask[2, 12:] = 0
    got = P.FeaturePipeline(ct)({"wave": torch.from_numpy(wave), "mask": torch.from_numpy(mask)})
    ref = JaxPipeline(cj)({"wave": jnp.asarray(wave), "mask": jnp.asarray(mask)})
    assert got.shape[-1] == P.feature_dim(ct) == ref.shape[-1]
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-4, atol=2e-3)


def test_feature_pipeline_mfcc_vtln_extras_match_jax(tmp_path):
    warp = tmp_path / "utt2warp"
    warp.write_text("u1 0.9\nu2 1.1\n")
    ct = C.FeatConfig(type="mfcc", mfcc=_opts(C, {}), utt2warp=str(warp))
    cj = JC.FeatConfig(type="mfcc", mfcc=_opts(JC, {}), utt2warp=str(warp))
    pt, pj = P.FeaturePipeline(ct), JaxPipeline(cj)
    et, ej = pt.batch_extras(["u2", "u1"]), pj.batch_extras(["u2", "u1"])
    np.testing.assert_array_equal(et["warp_id"], ej["warp_id"])
    wave = _wave(9, 2, 4000)
    got = pt({"wave": torch.from_numpy(wave), "warp_id": torch.from_numpy(et["warp_id"])})
    ref = pj({"wave": jnp.asarray(wave), "warp_id": jnp.asarray(ej["warp_id"])})
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=2e-4, atol=2e-3)
