"""LSTM recurrence (K2/K3 plain versions), LSTMStack and NnetAM of the port
against the JAX package.

The reference is the Pallas path (``lstm_seq_pallas`` in interpret mode) at
its supported shapes (B=8, H=128): it rounds Wh and h to bf16 for the
recurrent product exactly as the port does, so forward values agree to
fp32 summation-order noise. Tolerances: 1e-5 where both sides do the same
bf16-operand arithmetic; 2e-2 (the bound tests/test_lstm_pallas.py uses)
against the fp32 lax.scan; bf16 compute for the input/output GEMMs adds
~1e-2 on logits.
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pykaldi2_tpu.ops.lstm_pallas as LP
from pykaldi2_tpu.config import ModelConfig as JaxModelConfig
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.models.lstm import lstm_layer_apply as jax_layer_apply
from pykaldi2_tpu.models.lstm import lstm_layer_init as jax_layer_init

from pykaldi2_tpu_torch.config import ModelConfig
from pykaldi2_tpu_torch.convert import params_from_jax, params_to_jax
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.models.lstm import LSTMStack, lstm_layer_apply
from pykaldi2_tpu_torch.ops import lstm_cuda as L

from torch_port_helpers import pallas_interpret, to_np  # noqa: F401

SAME_ARITH = dict(rtol=1e-5, atol=1e-5)   # same bf16-operand math, fp32 sum order
VS_SCAN = dict(rtol=2e-2, atol=2e-2)      # bf16 Wh/h against the fp32 scan


def _seq_data(seed=0, t=6, b=8, h=128, w_scale=0.15):
    rng = np.random.RandomState(seed)
    xp = (rng.randn(t, b, 4 * h) * 0.7).astype(np.float32)
    wh = rng.uniform(-w_scale, w_scale, (h, 4 * h)).astype(np.float32)
    mask = np.ones((t, b), np.float32)
    mask[t // 2:, -1] = 0.0      # one right-padded row
    if b > 2:
        mask[1:, 2] = 0.0        # one row with a single valid frame
    for r in range(8, b, 3):     # beyond 8 rows, tails from different frames
        mask[1 + r % (t - 1):, r] = 0.0
    return xp, wh, mask


# K2/K3 (csrc/lstm.cu) split the batch into launches of 64 rows and H over
# H/8 (K2) or H/16 (K3) CTAs in clusters; chip_smoke.py checks the kernels
# against the plain versions at such shapes, and these cases hold the plain
# versions to the reference there. The Pallas kernels take B a multiple of 8
# (any H in interpret mode): B=8..72 at H=128, 256 and the small grids of
# H=16, 48, 64. At B=1 and B=17 they refuse the shape (``_tile_b`` finds no
# batch tile), and a float64 numpy recurrence is the reference.
#
# Each side rounds h (or dgates) to bf16 after fp32 sums taken in another
# order, so a value within ~1e-7 of a rounding edge can round either way;
# later steps then differ by ~2^-9·|h|·|Wh|. Over the ~10^5 rounded values of
# the largest shapes such a flip is likely, so above B·H = 8192 Wh is drawn
# from ±0.01, which keeps a flip's effect below SAME_ARITH; a wrong product
# still moves the gates by ~1e-2.
PALLAS_SHAPES = [(8, 128), (24, 128), (64, 128), (72, 128), (8, 256), (24, 256), (64, 256),
                 (72, 256), (8, 16), (8, 48), (8, 64)]
EDGE_SHAPES = [(1, 16), (17, 16), (1, 48), (17, 48), (1, 64), (17, 64)]


def _w_scale(b, h):
    return 0.15 if b * h <= 8192 else 0.01


def _bf16(x):
    """x rounded to bf16 (nearest, ties to even) through float32, as float64."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return u.view(np.float32).astype(np.float64)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _np_lstm_fwd(xp, wh, mask):
    """float64 recurrence with the kernels' rounding points: bf16 h and Wh
    into the product, everything else float64; gates unrounded."""
    t_len, b, h4 = xp.shape
    h = h4 // 4
    w = _bf16(wh)
    hs, c = np.zeros((b, h)), np.zeros((b, h))
    ys, cs, gates = [], [], []
    for t in range(t_len):
        pre = xp[t].astype(np.float64) + _bf16(hs) @ w
        i, f = _sigmoid(pre[:, :h]), _sigmoid(pre[:, h:2 * h])
        g, o = np.tanh(pre[:, 2 * h:3 * h]), _sigmoid(pre[:, 3 * h:])
        c_new = f * c + i * g
        m = mask[t][:, None]
        hs = m * (o * np.tanh(c_new)) + (1.0 - m) * hs
        c = m * c_new + (1.0 - m) * c
        ys.append(hs)
        cs.append(c)
        gates.append(np.concatenate([i, f, g, o], axis=-1))
    return np.stack(ys), np.stack(cs), np.stack(gates)


def _np_lstm_bwd(dys, gates, cs, mask, wh):
    """float64 reverse recurrence with bf16 dgates and Wh into dh's product."""
    t_len, b, h = dys.shape
    wt = _bf16(wh).T
    dh_s, dc_s = np.zeros((b, h)), np.zeros((b, h))
    out = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        m = mask[t][:, None]
        dh_total = dh_s + dys[t]
        i, f, g, o = (gates[t][:, k * h:(k + 1) * h].astype(np.float64) for k in range(4))
        c_prev = cs[t - 1] if t > 0 else np.zeros((b, h))
        tanh_c = np.tanh(cs[t].astype(np.float64))
        dh_m = m * dh_total
        dc = dh_m * o * (1.0 - tanh_c * tanh_c) + m * dc_s
        dg = np.concatenate([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                             dc * i * (1.0 - g * g), dh_m * tanh_c * o * (1.0 - o)], axis=-1)
        out[t] = dg
        dh_s = _bf16(dg) @ wt + (1.0 - m) * dh_total
        dc_s = dc * f + (1.0 - m) * dc_s
    return np.stack(out)


def test_lstm_seq_forward_matches_pallas(pallas_interpret):
    xp, wh, mask = _seq_data()
    ref = LP.lstm_seq_pallas(jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(mask[..., None]))
    got = L.LstmSeq.apply(torch.from_numpy(xp), torch.from_numpy(wh), torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(got), to_np(ref), **SAME_ARITH)


def test_lstm_seq_gradients_match_pallas(pallas_interpret):
    xp, wh, mask = _seq_data(seed=1, t=5)
    w = (np.arange(5 * 8 * 128, dtype=np.float32).reshape(5, 8, 128) % 17 - 8) * 1e-2

    def loss(a, b):
        return jnp.sum(LP.lstm_seq_pallas(a, b, jnp.asarray(mask[..., None])) * w)

    gx_ref, gw_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(wh))
    xt = torch.from_numpy(xp).requires_grad_(True)
    wt = torch.from_numpy(wh).requires_grad_(True)
    (L.LstmSeq.apply(xt, wt, torch.from_numpy(mask)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to_np(xt.grad), to_np(gx_ref), **SAME_ARITH)
    # dWh: one bf16-operand GEMM on each side over T*B rows
    np.testing.assert_allclose(to_np(wt.grad), to_np(gw_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,h", PALLAS_SHAPES + EDGE_SHAPES)
def test_k3_plain_matches_pallas_bwd_kernel(pallas_interpret, b, h):
    """K3's plain version against ``_lstm_bwd_pallas`` in interpret mode on
    the Pallas forward's saved tensors; at B=1 and 17 against
    ``_np_lstm_bwd`` on the plain forward's."""
    xp, wh, mask = _seq_data(seed=2, b=b, h=h, w_scale=_w_scale(b, h))
    wh_t = torch.from_numpy(wh).to(torch.bfloat16)
    if LP._tile_b(b, h) == 0:
        ys, cs, gates = L.lstm_fwd_plain(torch.from_numpy(xp), wh_t, torch.from_numpy(mask))
        dys = np.random.RandomState(3).randn(*ys.shape).astype(np.float32)
        ref = _np_lstm_bwd(dys.astype(np.float64), to_np(gates), to_np(cs), mask, wh)
        got = L.lstm_bwd(torch.from_numpy(dys), gates, cs, torch.from_numpy(mask), wh_t)
        np.testing.assert_allclose(to_np(got), ref, **SAME_ARITH)
        return
    wh_b = jnp.asarray(wh).astype(jnp.bfloat16)
    m3 = jnp.asarray(mask[..., None])
    ys, cs, gates = LP._lstm_fwd_pallas(jnp.asarray(xp), wh_b, m3)
    dys = np.random.RandomState(3).randn(*ys.shape).astype(np.float32)
    cs_prev = jnp.concatenate([jnp.zeros_like(cs[:1]), cs[:-1]], axis=0)
    ref = LP._lstm_bwd_pallas(jnp.asarray(dys), gates, cs, cs_prev, m3,
                              jnp.swapaxes(wh_b, 0, 1), jnp.float32)
    t_gates = torch.from_numpy(np.array(gates.astype(jnp.float32))).to(torch.bfloat16)
    got = L.lstm_bwd(torch.from_numpy(dys), t_gates, torch.from_numpy(np.array(cs)),
                     torch.from_numpy(mask), wh_t)
    np.testing.assert_allclose(to_np(got), to_np(ref), **SAME_ARITH)


@pytest.mark.parametrize("b,h", PALLAS_SHAPES + EDGE_SHAPES)
def test_k2_plain_outputs_match_pallas_fwd_kernel(pallas_interpret, b, h):
    """K2's plain version against ``_lstm_fwd_pallas`` in interpret mode; at
    B=1 and 17 against ``_np_lstm_fwd``."""
    xp, wh, mask = _seq_data(seed=4, b=b, h=h, w_scale=_w_scale(b, h))
    if LP._tile_b(b, h) == 0:
        ys, cs, gates = _np_lstm_fwd(xp, wh, mask)
    else:
        ys, cs, gates = LP._lstm_fwd_pallas(jnp.asarray(xp), jnp.asarray(wh).astype(jnp.bfloat16),
                                            jnp.asarray(mask[..., None]))
        gates = gates.astype(jnp.float32)
    y2, c2, g2 = L.lstm_fwd(torch.from_numpy(xp), torch.from_numpy(wh).to(torch.bfloat16),
                            torch.from_numpy(mask))
    np.testing.assert_allclose(to_np(y2), to_np(ys), **SAME_ARITH)
    np.testing.assert_allclose(to_np(c2), to_np(cs), **SAME_ARITH)
    assert g2.dtype == torch.bfloat16
    # saved gates are bf16: allow one bf16 ulp where fp32 noise crosses a rounding edge
    np.testing.assert_allclose(to_np(g2), np.asarray(gates), atol=4e-3)


@pytest.mark.parametrize("reverse", [False, True])
def test_layer_apply_matches_jax_pallas_path(pallas_interpret, reverse):
    """Input projection + recurrence, forward and reversed, on right-padded rows."""
    rng = np.random.RandomState(5)
    x = rng.randn(8, 7, 16).astype(np.float32)
    mask = np.ones((8, 7), np.float32)
    mask[-1, 4:] = 0.0
    p = {k: np.array(v) for k, v in jax_layer_init(jax.random.PRNGKey(5), 16, 128).items()}
    ref = jax_layer_apply(p, jnp.asarray(x), jnp.asarray(mask), reverse=reverse,
                          compute_dtype=jnp.float32, use_pallas=True)
    got = lstm_layer_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                           torch.from_numpy(mask), reverse=reverse, compute_dtype=torch.float32)
    np.testing.assert_allclose(to_np(got), to_np(ref), **SAME_ARITH)
    scan = jax_layer_apply(p, jnp.asarray(x), jnp.asarray(mask), reverse=reverse,
                           compute_dtype=jnp.float32, use_pallas=False)
    np.testing.assert_allclose(to_np(got), to_np(scan), **VS_SCAN)


def test_masked_frames_carry_state():
    xp, wh, mask = _seq_data(seed=6)
    ys = L.LstmSeq.apply(torch.from_numpy(xp), torch.from_numpy(wh), torch.from_numpy(mask))
    # padded frames repeat the last valid state
    assert torch.equal(ys[3:, -1], ys[2:3, -1].expand(3, -1))
    assert torch.equal(ys[1:, 2], ys[0:1, 2].expand(5, -1))


def test_kernel_wrappers_on_cpu_are_the_plain_versions():
    xp, wh, mask = _seq_data(seed=7)
    a, b_ = torch.from_numpy(xp), torch.from_numpy(wh).to(torch.bfloat16)
    m = torch.from_numpy(mask)
    before = (L.lstm_fwd.launches, L.lstm_bwd.launches)
    for u, v in zip(L.lstm_fwd(a, b_, m), L.lstm_fwd_plain(a, b_, m)):
        assert torch.equal(u, v)
    ys, cs, gates = L.lstm_fwd_plain(a, b_, m)
    dys = torch.randn_like(ys)
    assert torch.equal(L.lstm_bwd(dys, gates, cs, m, b_), L.lstm_bwd_plain(dys, gates, cs, m, b_))
    assert (L.lstm_fwd.launches, L.lstm_bwd.launches) == before  # no kernel ran


def test_bf16_matmul_matches_jax_preferred_f32():
    rng = np.random.RandomState(8)
    a, b = rng.randn(33, 20).astype(np.float32), rng.randn(20, 7).astype(np.float32)
    ref = jnp.dot(jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    got = L.mm_bf16(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(ref), **SAME_ARITH)


def _models(kind, layers, compute):
    jcfg = JaxModelConfig(type=kind, input_size=12, hidden_size=128, num_layers=layers,
                          output_size=10, compute_dtype=compute)
    tcfg = ModelConfig(type=kind, input_size=12, hidden_size=128, num_layers=layers,
                       output_size=10, compute_dtype=compute)
    jm = jax_build_model(jcfg)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(layers)))
    tm = build_model(tcfg)
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


@pytest.mark.parametrize("kind,layers,compute,tol", [
    ("lstm", 2, "float32", 1e-5),
    ("blstm", 2, "float32", 1e-5),
    ("lstm", 2, "bfloat16", 2e-2),   # bf16 input/output GEMMs round at other places
])
def test_nnet_am_with_carried_weights_matches_jax(pallas_interpret, kind, layers, compute, tol):
    jm, params, tm = _models(kind, layers, compute)
    rng = np.random.RandomState(9)
    x = rng.randn(8, 9, 12).astype(np.float32)
    mask = np.ones((8, 9), np.float32)
    mask[3, 5:] = 0.0
    ref = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == ref.shape == (8, 9, 10)
    np.testing.assert_allclose(to_np(got), to_np(ref), rtol=tol, atol=tol)


def test_convert_round_trip_and_layout():
    _, params, tm = _models("blstm", 2, "float32")
    sd = tm.state_dict()
    assert tuple(sd["nnet.layers.0.fwd.wx"].shape) == (12, 512)      # [D, 4H], not transposed
    assert tuple(sd["nnet.layers.1.bwd.wh"].shape) == (128, 512)     # [H, 4H]
    back = params_to_jax(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_unported_model_options_raise():
    # proj_size is ported (K5/K6): an LSTMP stack outputs P per direction
    stack = LSTMStack(8, 16, 1, proj_size=8, compute_dtype=torch.float32)
    assert stack.output_size == 8
    with torch.no_grad():
        assert stack(torch.randn(2, 5, 8)).shape == (2, 5, 8)
    # tdnn and transformer build and run (tests/test_torch_backbones.py holds
    # them to the JAX package); an unknown type still raises
    for kind, extra in (("tdnn", {"tdnn_dilations": (1, 2)}),
                        ("transformer", {"num_heads": 2, "ffn_size": 16})):
        model = build_model(ModelConfig(type=kind, input_size=8, hidden_size=16, num_layers=2,
                                        output_size=5, compute_dtype="float32", **extra))
        with torch.no_grad():
            assert model(torch.randn(2, 5, 8), torch.ones(2, 5)).shape == (2, 5, 5)
    with pytest.raises(ValueError, match="unknown model type"):
        build_model(ModelConfig(type="cnn"))


def test_dropout_draws_from_generator():
    stack = LSTMStack(6, 16, 3, dropout=0.5, compute_dtype=torch.float32)
    x = torch.randn(2, 5, 6)
    with pytest.raises(ValueError, match="Generator"):
        stack(x, train=True)
    with torch.no_grad():
        a = stack(x, train=True, generator=torch.Generator().manual_seed(1))
        b = stack(x, train=True, generator=torch.Generator().manual_seed(1))
        c = stack(x, train=False)
    assert torch.equal(a, b) and not torch.equal(a, c)


# the (H, P) grid of the kernels' shape gate: H a multiple of 16 in [16, 1024],
# P a multiple of 16 in [16, H] (P = 0: no projection)
SHAPE_GRID = [(h, p) for h in (8, 16, 40, 48, 64, 1000, 1024, 1040, 1536, 2048)
              for p in (0, 8, 16, 24, 48, 64, 512, 1024, 2048)]


@pytest.mark.parametrize("h,p", SHAPE_GRID)
def test_kernel_shape_predicate(h, p):
    h_ok = h % 16 == 0 and 16 <= h <= 1024
    want = h_ok and (p == 0 or (p % 16 == 0 and 16 <= p <= h))
    assert L.kernel_supported(h, p) is want
    # on the CPU the plain versions run whatever the shape
    assert L._use_kernel(h, p, torch.device("cpu")) is False


class _NoClusterLib:
    """A kernel library whose cluster queries say the clusters do not fit
    (0), and whose launches fail as the card refuses them."""
    TOO_LARGE = 720   # cudaErrorCooperativeLaunchTooLarge

    def pk2_lstm_max_batch(self):
        return 64

    def pk2_lstm_clusters(self, h, k2, k3):
        return 0

    def pk2_lstmp_fwd_cluster(self, h, p, c):
        return 0

    def pk2_lstm_fwd(self, *args):
        return self.TOO_LARGE

    def pk2_lstmp_fwd(self, *args):
        return self.TOO_LARGE


def test_cuda_route_uses_cluster_queries_and_warns_once(monkeypatch, caplog):
    """On CUDA the route is decided by the shape alone, before any launch:
    the cluster queries are never asked, and a shape outside takes the
    plain versions with one warning per shape. A shape inside whose
    clusters do not fit (a query's 0) takes the kernel, which raises."""
    cuda = torch.device("cuda", 0)

    def no_query(*args):
        raise AssertionError("the route asked a cluster query")

    monkeypatch.setattr(L, "lstm_clusters", no_query)
    monkeypatch.setattr(L, "lstmp_fwd_cluster", no_query)
    monkeypatch.setattr(L, "lstmp_bwd_cluster", no_query)
    L._warn_plain.cache_clear()
    with caplog.at_level("WARNING", logger=L.__name__):
        assert L._use_kernel(1024, 0, cuda) is True
        assert L._use_kernel(1024, 512, cuda) is True
        for _ in range(3):
            assert L._use_kernel(512, 0, cuda) is True       # inside: no query
            assert L._use_kernel(1024, 256, cuda) is True
            assert L._use_kernel(1040, 0, cuda) is False     # shape
            assert L._use_kernel(48, 64, cuda) is False      # P > H
    warned = [r.getMessage() for r in caplog.records]
    assert len(warned) == 2
    assert any("hidden size 1040 " in m for m in warned)
    assert any("hidden size 48 and projection 64" in m for m in warned)
    L._warn_plain.cache_clear()

    # a card that cannot hold the clusters: the kernels' route raises, and
    # nothing runs the plain versions in their place. Meta tensors stand in
    # for CUDA ones (no memory, right shapes and dtypes).
    monkeypatch.setattr(L, "_lib", lambda: _NoClusterLib())
    monkeypatch.setattr(L.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(L.D, "current_stream_ptr", lambda dev: None)
    monkeypatch.setattr(L, "lstm_fwd_plain", no_query)
    monkeypatch.setattr(L, "lstm_proj_fwd_plain", no_query)
    meta = torch.device("meta")
    t_len, b, h, p = 3, 2, 512, 256
    launches = L.lstm_fwd.launches, L.lstm_proj_fwd.launches
    with pytest.raises(RuntimeError, match="K2.*cudaError_t 720"):
        L.lstm_fwd(torch.empty(t_len, b, 4 * h, device=meta),
                   torch.empty(h, 4 * h, dtype=torch.bfloat16, device=meta),
                   torch.empty(t_len, b, device=meta))
    with pytest.raises(RuntimeError, match="K5.*cudaError_t 720"):
        L.lstm_proj_fwd(torch.empty(t_len, b, 4 * h, device=meta),
                        torch.empty(p, 4 * h, dtype=torch.bfloat16, device=meta),
                        torch.empty(h, p, dtype=torch.bfloat16, device=meta),
                        torch.empty(t_len, b, device=meta))
    assert (L.lstm_fwd.launches, L.lstm_proj_fwd.launches) == launches
