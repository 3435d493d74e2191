"""Banded lattice forward-backward of the PyTorch port against the JAX package.

Two levels, on the cases of tests/test_fb_lattice_pallas.py (random banded
lattices with NEG_INF padding arcs, a slot count off the lane multiple, K≠A,
and a band wide enough that the Pallas kernels chunk it) and one more,
``packed_padding``: padding arcs at src = dst = 0 as ``pack_time_sync``
writes them, inactive frames, and an active frame of padding arcs only, whose
arcs each add exp(0) = 1 to slot 0 (the paths the CUDA K8-K10 skip around):

  * the plain versions of K7-K10 (ops/fb_lattice_cuda.py) against the Pallas
    kernels ``make_logz_fwd`` / ``make_occupancies_bwd`` / ``make_smbr_fwd`` /
    ``make_smbr_contribs_bwd`` in interpret mode, on the same [T,B,A] bands.
    The Pallas kernels run at K padded to 128 as the JAX wrappers call them;
    the port runs at the lattice's own K, and the padded slots must be inert;
  * the port's logZ, occupancies, MMI value and obs-gradient, and sMBR/MPE
    value and gradient (with silence phones) against the JAX scan route
    (PK2_PALLAS_LATFB=0, PK2_LATFB_MATVEC=0).

Tolerances: both sides do the same fp32 arithmetic but sum each slot's arcs
in another order (one-hot matmul or segment_sum vs scatter_add_), so values
agree to rtol 1e-5 and posteriors/gradients to rtol 1e-4, atol 1e-5, as in
tests/test_fb_lattice_pallas.py. Alphas are compared where they are alive
(> -1e29; dead slots sit near NEG_INF, where one ulp is ~1e23) at atol 5e-5:
a slot of the 2048-arc band sums ~60 arcs a frame, and the order of those
sums moves its log by up to ~2e-5 after six frames.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import pykaldi2_tpu.ops.fb_lattice as JFL
from pykaldi2_tpu.ops.fb import SilenceOpts as JSilence
from pykaldi2_tpu.ops.fb_lattice_pallas import (make_logz_fwd, make_occupancies_bwd,
                                                make_smbr_contribs_bwd, make_smbr_fwd)

from pykaldi2_tpu_torch.ops import fb_lattice as FL
from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC
from pykaldi2_tpu_torch.ops.fb import NEG_INF, SilenceOpts

B, T, P = 8, 6, 12


@pytest.fixture
def _interpret(monkeypatch):
    real = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return real(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.fixture
def _jax_scan(monkeypatch):
    monkeypatch.setenv("PK2_PALLAS_LATFB", "0")
    monkeypatch.setenv("PK2_LATFB_MATVEC", "0")


def _lattice(seed, k=128, a=128, live=24, pad_from=None, uneven=False, packed=False):
    """Random banded lattice (numpy): forward-connected live slots, padding
    arcs from ``pad_from`` on, frame 0 leaving the single start slot. With
    ``packed``, padding arcs join slot 0 to slot 0, as ``pack_time_sync``
    writes them, and utterance 0's frame 1 (always active) is all padding."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, live, (B, T, a)).astype(np.int32)
    src[:, 0, :] = 0
    dst = rng.randint(0, live, (B, T, a)).astype(np.int32)
    w = (rng.randn(B, T, a) * 0.3).astype(np.float32)
    if pad_from is not None:
        w[:, :, pad_from:] = NEG_INF
    if packed:
        w[0, 1] = NEG_INF
        src[w == NEG_INF] = 0
        dst[w == NEG_INF] = 0
    final = np.full((B, k), NEG_INF, np.float32)
    final[:, :live] = 0.0 if uneven else (rng.randn(B, live) * 0.2).astype(np.float32)
    pdf = rng.randint(0, P, (B, T, a)).astype(np.int32)
    return dict(src=src, dst=dst, pdf=pdf, weight=w, final=final)


# the cases of tests/test_fb_lattice_pallas.py:34-47, 175-249
CASES = {
    "random": dict(seed=0, pad_from=72),
    "padded_slots": dict(seed=7, k=200, pad_from=96),
    "uneven_k_a": dict(seed=5, k=256, live=30, uneven=True),
    "chunked_band": dict(seed=9, a=2048, pad_from=1536, uneven=True),
    # padding as pack_time_sync writes it, and an active frame of padding only
    "packed_padding": dict(seed=3, pad_from=80, packed=True),
}


def _inputs(case, seed):
    lat = _lattice(**CASES[case])
    rng = np.random.RandomState(seed)
    obs = rng.randn(B, T, P).astype(np.float32)
    lens = rng.randint(2, T + 1, B).astype(np.int32)
    return lat, obs, lens


def _jlat(lat):
    return JFL.TimeSyncLattice(*(jnp.asarray(lat[n]) for n in
                                 ("src", "dst", "pdf", "weight", "final")))


def _tlat(lat):
    return FL.TimeSyncLattice(*(torch.from_numpy(lat[n]) for n in
                                ("src", "dst", "pdf", "weight", "final")))


def _band_np(lat, obs, lens):
    """Time-major kernel inputs, numpy: obs_arc, src, dst, w [T,B,A], active [T,B,1]."""
    obs_arc = np.take_along_axis(obs, lat["pdf"], axis=2).swapaxes(0, 1)
    sw = lambda x: np.ascontiguousarray(x.swapaxes(0, 1))  # noqa: E731
    active = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)[:, :, None]
    return [np.ascontiguousarray(obs_arc), sw(lat["src"]), sw(lat["dst"]),
            sw(lat["weight"]), active]


def _pad_k(x, kp, value):
    k = x.shape[-1]
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, kp - k)], constant_values=value)


def _alive_close(got, want, rtol=1e-5, atol=5e-5):
    alive = want > -1e29
    np.testing.assert_array_equal(got > -1e29, alive)
    np.testing.assert_allclose(got[alive], want[alive], rtol=rtol, atol=atol)


def _t(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _fwd_residuals(band, k, arc_acc=None):
    """The port's forward residuals (plain K7 or K9) as numpy."""
    if arc_acc is None:
        alphas, norms = KC.logz_fwd_plain(*_t(band), k)
        return alphas.numpy(), None, norms.numpy()
    alphas, aaccs, norms = KC.smbr_fwd_plain(*_t(band), torch.from_numpy(arc_acc), k)
    return alphas.numpy(), aaccs.numpy(), norms.numpy()


def _prev_np(x, first):
    return np.concatenate([first[None], x[:-1]], axis=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_logz_fwd_plain_matches_pallas(_interpret, case):
    lat, obs, lens = _inputs(case, 1)
    band = _band_np(lat, obs, lens)
    k = lat["final"].shape[1]
    kp = -(-k // 128) * 128
    ja, jn = make_logz_fwd(kp)(*(jnp.asarray(x) for x in band))
    alphas, _, norms = _fwd_residuals(band, k)
    assert alphas.shape == (T, B, k) and norms.shape == (T, B)
    _alive_close(alphas, np.asarray(ja)[..., :k])
    np.testing.assert_allclose(norms, np.asarray(jn), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_occupancies_bwd_plain_matches_pallas(_interpret, case):
    lat, obs, lens = _inputs(case, 2)
    band = _band_np(lat, obs, lens)
    k = lat["final"].shape[1]
    kp = -(-k // 128) * 128
    alphas, _, norms = _fwd_residuals(band, k)
    total = np.maximum(alphas[-1] + lat["final"], NEG_INF)
    logz = (np.log(np.exp(total - total.max(1, keepdims=True)).sum(1))
            + total.max(1) + norms[-1]).astype(np.float32)[:, None]
    a0 = np.full((B, k), NEG_INF, np.float32)
    a0[:, 0] = 0.0
    alpha_prev = _prev_np(alphas, a0)
    anorm_prev = _prev_np(norms, np.zeros(B, np.float32))[:, :, None]
    jg = make_occupancies_bwd(kp)(
        *(jnp.asarray(x) for x in band), jnp.asarray(_pad_k(alpha_prev, kp, NEG_INF)),
        jnp.asarray(anorm_prev), jnp.asarray(_pad_k(lat["final"], kp, NEG_INF)),
        jnp.asarray(logz))
    got = KC.occupancies_bwd_plain(*_t(band + [alpha_prev, anorm_prev, lat["final"], logz]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)
    assert float(got.sum()) > 0


def _arc_acc_np(lat, seed):
    rng = np.random.RandomState(seed)
    ref = rng.randint(0, P, (B, T))
    return np.ascontiguousarray(
        (lat["pdf"] == ref[:, :, None]).astype(np.float32).swapaxes(0, 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_smbr_fwd_plain_matches_pallas(_interpret, case):
    lat, obs, lens = _inputs(case, 3)
    band = _band_np(lat, obs, lens)
    arc_acc = _arc_acc_np(lat, 4)
    k = lat["final"].shape[1]
    kp = -(-k // 128) * 128
    ja, jc, jn = make_smbr_fwd(kp)(*(jnp.asarray(x) for x in band), jnp.asarray(arc_acc))
    alphas, aaccs, norms = _fwd_residuals(band, k, arc_acc)
    _alive_close(alphas, np.asarray(ja)[..., :k])
    np.testing.assert_allclose(aaccs, np.asarray(jc)[..., :k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(norms, np.asarray(jn), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_smbr_contribs_bwd_plain_matches_pallas(_interpret, case):
    lat, obs, lens = _inputs(case, 5)
    band = _band_np(lat, obs, lens)
    arc_acc = _arc_acc_np(lat, 6)
    k = lat["final"].shape[1]
    kp = -(-k // 128) * 128
    alphas, aaccs, norms = _fwd_residuals(band, k, arc_acc)
    total = np.maximum(alphas[-1] + lat["final"], NEG_INF)
    wsm = np.exp(total - total.max(1, keepdims=True))
    wsm /= wsm.sum(1, keepdims=True)
    f = (wsm * aaccs[-1]).sum(1).astype(np.float32)[:, None]
    logz = (np.log(np.exp(total - total.max(1, keepdims=True)).sum(1))
            + total.max(1) + norms[-1]).astype(np.float32)[:, None]
    a0 = np.full((B, k), NEG_INF, np.float32)
    a0[:, 0] = 0.0
    alpha_prev = _prev_np(alphas, a0)
    aacc_prev = _prev_np(aaccs, np.zeros((B, k), np.float32))
    anorm_prev = _prev_np(norms, np.zeros(B, np.float32))[:, :, None]
    jc = make_smbr_contribs_bwd(kp)(
        *(jnp.asarray(x) for x in band), jnp.asarray(arc_acc),
        jnp.asarray(_pad_k(alpha_prev, kp, NEG_INF)), jnp.asarray(_pad_k(aacc_prev, kp, 0.0)),
        jnp.asarray(anorm_prev), jnp.asarray(_pad_k(lat["final"], kp, NEG_INF)),
        jnp.asarray(logz), jnp.asarray(f))
    got = KC.smbr_contribs_bwd_plain(*_t(band + [arc_acc, alpha_prev, aacc_prev, anorm_prev,
                                                 lat["final"], logz, f]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)


def _bwd_outputs(band, arc_acc, final, kernel, jax_side):
    """K8's gamma or K10's contributions [T,B,A] for one band, from that
    band's own forward residuals: the Pallas kernels (interpret mode, K
    padded to 128) or the port's plain versions."""
    k = final.shape[1]
    kp = -(-k // 128) * 128 if jax_side else k
    fin = _pad_k(final, kp, NEG_INF)
    if jax_side:
        jb = [jnp.asarray(x) for x in band]
        fwd = (make_logz_fwd(kp)(*jb) if kernel == "occupancies"
               else make_smbr_fwd(kp)(*jb, jnp.asarray(arc_acc)))
        fwd = [np.asarray(x) for x in fwd]
    else:
        fwd = _fwd_residuals(band, k, None if kernel == "occupancies" else arc_acc)
        fwd = [x for x in fwd if x is not None]
    alphas, norms = fwd[0], fwd[-1]
    total = np.maximum(alphas[-1] + fin, NEG_INF)
    wsm = np.exp(total - total.max(1, keepdims=True))
    logz = (np.log(wsm.sum(1)) + total.max(1) + norms[-1]).astype(np.float32)[:, None]
    a0 = np.full((B, kp), NEG_INF, np.float32)
    a0[:, 0] = 0.0
    res = [_prev_np(alphas, a0), _prev_np(norms, np.zeros(B, np.float32))[:, :, None]]
    if kernel == "occupancies":
        args = band + res + [fin, logz]
        if jax_side:
            return np.asarray(make_occupancies_bwd(kp)(*(jnp.asarray(x) for x in args)))
        return KC.occupancies_bwd_plain(*_t(args)).numpy()
    f = ((wsm / wsm.sum(1, keepdims=True)) * fwd[1][-1]).sum(1).astype(np.float32)[:, None]
    args = band + [arc_acc, res[0], _prev_np(fwd[1], np.zeros((B, kp), np.float32)), res[1],
                   fin, logz, f]
    if jax_side:
        return np.asarray(make_smbr_contribs_bwd(kp)(*(jnp.asarray(x) for x in args)))
    return KC.smbr_contribs_bwd_plain(*_t(args)).numpy()


@pytest.mark.parametrize("kernel", ["occupancies", "contribs"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_outputs_ignore_inactive_frames(_interpret, case, kernel):
    """What lets K8 and K10 skip an inactive frame without reading its arcs:
    the reference's backward kernels (``_bwd_kernel``, ``_smbr_bwd_kernel``)
    and the port's plain versions give the same gamma and contributions, by
    value, whatever finite live arcs the frames past an utterance's end
    hold, and 0 on those frames (the blend keeps the carries exactly)."""
    lat, obs, lens = _inputs(case, 21)
    lens[0] = T - 2
    band = _band_np(lat, obs, lens)
    arc_acc = _arc_acc_np(lat, 22)
    k, a = lat["final"].shape[1], lat["src"].shape[2]
    live, live_acc = [x.copy() for x in band], arc_acc.copy()
    rng = np.random.RandomState(23)
    for i in np.flatnonzero(lens < T):
        n = T - lens[i]
        live[0][lens[i]:, i] = rng.randn(n, a)
        live[1][lens[i]:, i] = rng.randint(0, k, (n, a))
        live[2][lens[i]:, i] = rng.randint(0, k, (n, a))
        live[3][lens[i]:, i] = rng.randn(n, a) * 0.3
        live_acc[lens[i]:, i] = rng.randint(0, 2, (n, a))
    inactive = band[4][:, :, 0] == 0
    assert inactive.any()
    for jax_side in (True, False):
        want = _bwd_outputs(band, arc_acc, lat["final"], kernel, jax_side)
        got = _bwd_outputs(live, live_acc, lat["final"], kernel, jax_side)
        assert np.array_equal(got, want), f"jax={jax_side}: inactive frames' arcs leak"
        assert np.array_equal(got[inactive], np.zeros_like(got[inactive]))
        assert np.abs(want).sum() > 0


def _fwd_outputs(band, arc_acc, k, kernel, jax_side):
    """K7's (alphas, norms) or K9's (alphas, aaccs, norms) for one band, at
    the lattice's K: the Pallas kernels (interpret mode, K padded to 128) or
    the port's plain versions, as numpy."""
    if not jax_side:
        fwd = _fwd_residuals(band, k, None if kernel == "logz" else arc_acc)
        return [x for x in fwd if x is not None]
    kp = -(-k // 128) * 128
    jb = [jnp.asarray(x) for x in band]
    out = (make_logz_fwd(kp)(*jb) if kernel == "logz"
           else make_smbr_fwd(kp)(*jb, jnp.asarray(arc_acc)))
    return [np.asarray(x)[..., :k] if np.ndim(x) == 3 else np.asarray(x) for x in out]


@pytest.mark.parametrize("kernel", ["logz", "smbr"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fwd_carries_ignore_inactive_frames(_interpret, case, kernel):
    """What lets K7 and K9 skip an inactive frame without reading its arcs:
    the reference's forward kernels (``_fwd_kernel``, ``_smbr_fwd_kernel``)
    and the port's plain versions give the same alphas, aaccs and norms, by
    value, whatever finite live arcs the frames past an utterance's end
    hold, and an inactive frame repeats the previous frame's carries (the
    blend keeps them exactly)."""
    lat, obs, lens = _inputs(case, 31)
    lens[0] = T - 2
    band = _band_np(lat, obs, lens)
    arc_acc = _arc_acc_np(lat, 32)
    k, a = lat["final"].shape[1], lat["src"].shape[2]
    live, live_acc = [x.copy() for x in band], arc_acc.copy()
    rng = np.random.RandomState(33)
    for i in np.flatnonzero(lens < T):
        n = T - lens[i]
        live[0][lens[i]:, i] = rng.randn(n, a)
        live[1][lens[i]:, i] = rng.randint(0, k, (n, a))
        live[2][lens[i]:, i] = rng.randint(0, k, (n, a))
        live[3][lens[i]:, i] = rng.randn(n, a) * 0.3
        live_acc[lens[i]:, i] = rng.randint(0, 2, (n, a))
    inactive = band[4][:, :, 0] == 0
    assert inactive.any() and not inactive[0].any()
    for jax_side in (True, False):
        want = _fwd_outputs(band, arc_acc, k, kernel, jax_side)
        got = _fwd_outputs(live, live_acc, k, kernel, jax_side)
        assert len(got) == (2 if kernel == "logz" else 3)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), f"jax={jax_side}: inactive frames' arcs leak"
            assert np.array_equal(g[1:][inactive[1:]], g[:-1][inactive[1:]])
        assert np.abs(want[-1]).sum() > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_logz_and_occupancies_match_jax_scan(_jax_scan, case):
    lat, obs, lens = _inputs(case, 11)
    jz, jg = JFL.lattice_occupancies_ts(jnp.asarray(obs), _jlat(lat), jnp.asarray(lens))
    tz, tg = FL.lattice_occupancies_ts(torch.from_numpy(obs), _tlat(lat),
                                       torch.from_numpy(lens))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)
    # logZ's gradient is the occupancy
    o = torch.from_numpy(obs).requires_grad_(True)
    FL.lattice_logz_ts(o, _tlat(lat), torch.from_numpy(lens)).sum().backward()
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("drop_frames,den_scale", [(True, 1.0), (False, 0.5)])
@pytest.mark.parametrize("case", ["random", "padded_slots"])
def test_mmi_value_and_grad_match_jax_scan(_jax_scan, case, drop_frames, den_scale):
    lat, obs, lens = _inputs(case, 12)
    rng = np.random.RandomState(13)
    ali = rng.randint(-1, P, (B, T)).astype(np.int32)
    mask = ((np.arange(T)[None, :] < lens[:, None]) & (ali >= 0)).astype(np.float32)

    def jobj(o):
        return jnp.sum(JFL.mmi_objective_lattice_ts(
            o, jnp.asarray(ali), _jlat(lat), jnp.asarray(lens), jnp.asarray(mask),
            drop_frames, den_scale) * jnp.arange(1, B + 1))

    jv, jgrad = jax.value_and_grad(jobj)(jnp.asarray(obs))
    o = torch.from_numpy(obs).requires_grad_(True)
    rows = FL.mmi_objective_lattice_ts(o, torch.from_numpy(ali), _tlat(lat),
                                       torch.from_numpy(lens), torch.from_numpy(mask),
                                       drop_frames, den_scale)
    tv = (rows * torch.arange(1, B + 1)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)


SMBR_VARIANTS = {
    "pdf": dict(level="pdf", silence=None),
    "phone_silence": dict(level="phone", silence="sil"),
    "phone_one_silence_class": dict(level="phone", silence="one"),
    "pdf_silence": dict(level="pdf", silence="sil"),
}


@pytest.mark.parametrize("variant", sorted(SMBR_VARIANTS))
@pytest.mark.parametrize("case", ["random", "padded_slots"])
def test_expected_accuracy_value_and_grad_match_jax_scan(_jax_scan, case, variant):
    """sMBR (pdf level) and MPE (phone level, pdf_to_phone) with Kaldi's
    silence rules: phone 1 is silence."""
    lat, obs, lens = _inputs(case, 14)
    v = SMBR_VARIANTS[variant]
    rng = np.random.RandomState(15)
    p2p = (np.arange(P, dtype=np.int32) % 3 + 1)
    ref = (rng.randint(1, 4, (B, T)) if v["level"] == "phone"
           else rng.randint(0, P, (B, T))).astype(np.int32)
    sil_pdf = (p2p == 1).astype(np.float32)
    sil_phone = np.array([0, 1, 0, 0], np.float32)
    jsil = tsil = None
    if v["silence"]:
        one = v["silence"] == "one"
        jsil = JSilence(jnp.asarray(sil_pdf), jnp.asarray(sil_phone), one)
        tsil = SilenceOpts(torch.from_numpy(sil_pdf), torch.from_numpy(sil_phone), one)

    def jobj(o):
        return jnp.sum(JFL.lattice_expected_accuracy_ts(
            o, _jlat(lat), jnp.asarray(ref), jnp.asarray(lens), v["level"],
            jnp.asarray(p2p), jsil) * jnp.arange(1, B + 1))

    jv, jgrad = jax.value_and_grad(jobj)(jnp.asarray(obs))
    o = torch.from_numpy(obs).requires_grad_(True)
    rows = FL.lattice_expected_accuracy_ts(o, _tlat(lat), torch.from_numpy(ref),
                                           torch.from_numpy(lens), v["level"],
                                           torch.from_numpy(p2p), tsil)
    tv = (rows * torch.arange(1, B + 1)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)


def test_pad_time_sync_matches_jax_and_is_inert(_jax_scan):
    lat, obs, lens = _inputs("random", 16)
    jp = JFL.pad_time_sync(_jlat(lat), 160, 192, T + 3)
    tp = FL.pad_time_sync(_tlat(lat), 160, 192, T + 3)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    obs_p = np.pad(obs, [(0, 0), (0, 3), (0, 0)])
    z0, _ = FL.lattice_occupancies_ts(torch.from_numpy(obs), _tlat(lat), torch.from_numpy(lens))
    z1, _ = FL.lattice_occupancies_ts(torch.from_numpy(obs_p), tp, torch.from_numpy(lens))
    np.testing.assert_allclose(z1.numpy(), z0.numpy(), rtol=1e-6)
    with pytest.raises(ValueError, match="cannot shrink"):
        FL.pad_time_sync(_tlat(lat), 64, 192)


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    lat, obs, lens = _inputs("random", 17)
    band = _t(_band_np(lat, obs, lens))
    before = (KC.logz_fwd.launches, KC.smbr_fwd.launches)
    got = KC.logz_fwd(*band, 128)
    want = KC.logz_fwd_plain(*band, 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    KC.smbr_fwd(*band, torch.zeros_like(band[0]), 128)
    assert (KC.logz_fwd.launches, KC.smbr_fwd.launches) == before
