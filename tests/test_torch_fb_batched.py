"""The generic per-utterance lattice route of the PyTorch port
(ops/fb_batched.py) against the JAX package, and ``make_se_lattice_steps``
on ``BatchedGraphs``.

The same numpy graphs and scores go through both packages (the cases of
tests/test_fb_batched.py and test_silence.py:240-280): logZ, occupancies
and grad(logZ) on graphs of different sizes with unequal lengths, padding
invariance, the exhaustive oracles, MMI with and without --drop-frames and
a denominator scale, and the sMBR/MPE expected accuracy with Kaldi's
silence rules; the generic route against the port's banded route on the
same time-synchronous lattices; and the lattice train step on
``BatchedGraphs`` against the JAX step, on two gloo ranks against one
process, and routed by the lattice's type.

Tolerances: both packages run the same fp32 recursion (the port sums with
``scatter_add_``, the reference with ``segment_sum``), so values agree to
rtol 1e-5 and occupancies and gradients to rtol 1e-4, atol 1e-5 (the
reference suite's own bounds, test_fb_batched.py:43-53). Padding arcs add
exact zeros: bucketed and unbucketed packs agree to 1e-6. The generic and
banded routes order their sums differently: values rtol 1e-5, occupancies
and gradients rtol 1e-4, atol 1e-5. The train steps take
tests/test_torch_train_se.py's bounds (objective rtol 1e-4, atol 1e-6;
frame accuracy 1e-6; parameters after 3 momentum steps rtol 1e-3, atol
2e-5) and tests/test_torch_parallel.py's for the ranks (parameters rtol
3e-5, atol 3e-6 after one step; objective 1e-5).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.data.dataloader import BucketSpec as JBucket, SeqDataloader as JSeq
from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.ops import fb_batched as JB
from pykaldi2_tpu.ops.fb import SilenceOpts as JSilence
from pykaldi2_tpu.ops.fsa import DenseFsa as JFsa, brute_force_logz as jax_brute_logz
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline
from pykaldi2_tpu.trainer import make_se_lattice_steps as jax_lattice_steps
from pykaldi2_tpu.utils import make_optimizer as jax_make_optimizer

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.convert import keystr, params_from_jax, params_to_jax, walk
from pykaldi2_tpu_torch.frontend.window import num_frames
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.ops import fb_batched as TB
from pykaldi2_tpu_torch.ops import fb_lattice as FL
from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC
from pykaldi2_tpu_torch.ops.fb import NEG_INF, SilenceOpts
from pykaldi2_tpu_torch.ops.fsa import DenseFsa, brute_force_logz, brute_force_paths
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.trainer import make_se_lattice_steps
from pykaldi2_tpu_torch.utils import load_checkpoint, make_optimizer, save_checkpoint

from toydata import make_toy_corpus
from torch_dist_worker import spawn_ranks
from torch_port_helpers import pallas_interpret, torch_batch  # noqa: F401

P = 4


def _toy(seed, num_states=4, num_pdfs=3, num_arcs=10):
    """tests/test_fb_batched.py:19-29's random graph (start 0, one final
    state besides the start's -0.5), as numpy fields."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, num_states, num_arcs).astype(np.int32)
    src[0] = 0
    dst = rng.randint(0, num_states, num_arcs).astype(np.int32)
    pdf = rng.randint(0, num_pdfs, num_arcs).astype(np.int32)
    weight = (rng.randn(num_arcs) * 0.5).astype(np.float32)
    final = np.full(num_states, -np.inf, np.float32)
    final[rng.randint(1, num_states)] = 0.0
    final[0] = -0.5
    return dict(num_states=num_states, src=src, dst=dst, pdf=pdf, weight=weight, final=final)


def _full(seed, num_states, num_pdfs):
    """A graph with an arc from every state to every state (a path of every
    length reaches a final state), random pdfs and weights."""
    rng = np.random.RandomState(seed)
    src, dst = (a.ravel().astype(np.int32) for a in np.meshgrid(
        np.arange(num_states), np.arange(num_states), indexing="ij"))
    final = np.full(num_states, -np.inf, np.float32)
    final[rng.choice(num_states, max(1, num_states // 2), replace=False)] = 0.0
    return dict(num_states=num_states, src=src, dst=dst,
                pdf=rng.randint(0, num_pdfs, src.size).astype(np.int32),
                weight=(rng.randn(src.size) * 0.3).astype(np.float32), final=final)


def _both(graphs, bucket=True):
    """(JAX BatchedGraphs, port BatchedGraphs) of numpy graph fields."""
    return (JB.pack_graph_batch([JFsa(**g).validate() for g in graphs], bucket),
            TB.pack_graph_batch([DenseFsa(**g).validate() for g in graphs], bucket))


# three graphs of different sizes (test_fb_batched.py's seeds 0 and 1, and a
# larger one), and three of the fully connected kind
GRAPH_SETS = {
    "toy": ([_toy(0), _toy(1, num_states=5, num_arcs=14), _toy(2, num_states=7, num_arcs=30)],
            [6, 4, 5]),
    "full": ([_full(3, 3, P), _full(4, 6, P), _full(5, 9, P)], [7, 7, 3]),
}


def _obs(seed, b, t):
    return np.random.RandomState(seed).randn(b, t, P).astype(np.float32)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("name", sorted(GRAPH_SETS))
def test_logz_occupancies_and_grad_match_jax(name, bucket):
    graphs, lens = GRAPH_SETS[name]
    jg, tg = _both(graphs, bucket)
    assert tg.src.dtype == torch.int64 and tg.src.device.type == "cpu"
    for x, y in zip(tg, jg):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    obs = _obs(7, len(graphs), max(lens))
    lens = np.asarray(lens, np.int32)
    jz, jgam = JB.fsa_occupancies_b(jnp.asarray(obs), jg, jnp.asarray(lens))
    tz, tgam = TB.fsa_occupancies_b(torch.from_numpy(obs), tg, torch.from_numpy(lens))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgam.numpy(), np.asarray(jgam), rtol=1e-4, atol=1e-5)
    # grad(sum logZ) is the occupancy, as the reference's custom VJP gives it
    jgrad = jax.grad(lambda o: jnp.sum(JB.fsa_logz_b(o, jg, jnp.asarray(lens))))(
        jnp.asarray(obs))
    o = torch.from_numpy(obs).requires_grad_(True)
    TB.fsa_logz_b(o, tg, torch.from_numpy(lens)).sum().backward()
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)
    # padding invariance: the other packing gives the same numbers
    _, other = _both(graphs, not bucket)
    assert other.num_states != tg.num_states
    oz, ogam = TB.fsa_occupancies_b(torch.from_numpy(obs), other, torch.from_numpy(lens))
    np.testing.assert_allclose(oz.numpy(), tz.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ogam.numpy(), tgam.numpy(), rtol=1e-6, atol=1e-6)


def test_pack_graph_batch_buckets_and_start_check():
    _, tg = _both([_toy(0), _toy(2, num_states=7, num_arcs=70)])
    assert (tg.src.shape, tg.num_states) == ((2, 128), 64)
    assert torch.all(tg.weight[0, 10:] == NEG_INF) and torch.all(tg.final[0, 4:] == NEG_INF)
    assert torch.all(tg.to("cpu").final == tg.final)
    with pytest.raises(ValueError, match="start at state 0"):
        TB.pack_graph_batch([DenseFsa(**_toy(1), start=1)])


@pytest.mark.parametrize("oracle", ["logz", "phone_accuracy"])
def test_exhaustive_oracles(oracle):
    """logZ against the O(S·E·T) dynamic program (the port's copy equals the
    reference's), and the phone-level expected accuracy against the
    enumerated paths (tests/test_fb_batched.py:169-196)."""
    g = _toy(23)
    fsa = DenseFsa(**g).validate()
    t_len = 4
    obs = _obs(24, 1, t_len)[..., :3]
    tg = TB.pack_graph_batch([fsa])
    if oracle == "logz":
        want = brute_force_logz(fsa, obs[0])
        assert want == jax_brute_logz(JFsa(**g), obs[0])
        got = float(TB.fsa_logz_b(torch.from_numpy(obs), tg, torch.tensor([t_len]))[0])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    p2p = np.array([1, 1, 2], np.int32)
    ref = np.random.RandomState(24).randint(1, 3, (1, t_len)).astype(np.int32)
    got = float(TB.batched_expected_accuracy(
        torch.from_numpy(obs), tg, torch.from_numpy(ref), torch.tensor([t_len]), "phone",
        torch.from_numpy(p2p))[0])
    scores, accs = [], []
    for arcs, w in brute_force_paths(fsa, t_len):
        scores.append(w + sum(obs[0, t, fsa.pdf[e]] for t, e in enumerate(arcs)))
        accs.append(sum(1.0 for t, e in enumerate(arcs) if p2p[fsa.pdf[e]] == ref[0, t]))
    post = np.exp(np.array(scores) - max(scores))
    np.testing.assert_allclose(got, float((post / post.sum() * np.array(accs)).sum()),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("drop_frames,den_scale", [(True, 1.0), (False, 0.5), (True, 0.7)])
def test_mmi_value_and_grad_match_jax(drop_frames, den_scale):
    """The graphs emit pdfs 0-2 only, and the alignment names pdf 3 on some
    supervised frames: those frames have no denominator occupancy, so
    --drop-frames zeroes their gradient."""
    graphs, lens = GRAPH_SETS["toy"]
    jg, tg = _both(graphs)
    b, t = len(graphs), max(lens)
    obs = _obs(12, b, t)
    lens = np.asarray(lens, np.int32)
    rng = np.random.RandomState(13)
    ali = rng.randint(-1, 3, (b, t)).astype(np.int32)
    ali[:, 1] = 3
    mask = ((np.arange(t)[None, :] < lens[:, None]) & (ali >= 0)).astype(np.float32)
    scale = np.arange(1, b + 1, dtype=np.float32)

    def jobj(o):
        return jnp.sum(JB.mmi_objective_lattice(
            o, jnp.asarray(ali), jg, jnp.asarray(lens), jnp.asarray(mask), drop_frames,
            den_scale) * scale)

    jv, jgrad = jax.value_and_grad(jobj)(jnp.asarray(obs))
    o = torch.from_numpy(obs).requires_grad_(True)
    rows = TB.mmi_objective_lattice(o, torch.from_numpy(ali), tg, torch.from_numpy(lens),
                                    torch.from_numpy(mask), drop_frames, den_scale)
    tv = (rows * torch.from_numpy(scale)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)
    dropped = np.abs(o.grad.numpy()[:, 1]).sum()
    assert (dropped == 0.0) == drop_frames, dropped


SMBR_VARIANTS = {
    "pdf": dict(level="pdf", silence=None),
    "pdf_silence": dict(level="pdf", silence=False),
    "pdf_one_silence_class": dict(level="pdf", silence=True),
    "phone": dict(level="phone", silence=None),
    "phone_silence": dict(level="phone", silence=False),
    "phone_one_silence_class": dict(level="phone", silence=True),
}
P2P = np.array([1, 2, 1, 3], np.int32)   # phone 1 is silence: pdfs 0 and 2


def _smbr_inputs(variant, b, t, seed):
    """(level, ref [B, T], pdf→phone, JAX silence, port silence)."""
    v = SMBR_VARIANTS[variant]
    rng = np.random.RandomState(seed)
    ref = (rng.randint(1, 4, (b, t)) if v["level"] == "phone"
           else rng.randint(0, P, (b, t))).astype(np.int32)
    jsil = tsil = None
    if v["silence"] is not None:
        sil_pdf, sil_phone = (P2P == 1).astype(np.float32), np.array([0, 1, 0, 0], np.float32)
        jsil = JSilence(jnp.asarray(sil_pdf), jnp.asarray(sil_phone), v["silence"])
        tsil = SilenceOpts(torch.from_numpy(sil_pdf), torch.from_numpy(sil_phone), v["silence"])
    return v["level"], ref, jsil, tsil


@pytest.mark.parametrize("variant", sorted(SMBR_VARIANTS))
def test_expected_accuracy_value_and_grad_match_jax(variant):
    graphs, lens = GRAPH_SETS["full"]
    jg, tg = _both(graphs)
    b, t = len(graphs), max(lens)
    obs = _obs(14, b, t)
    lens = np.asarray(lens, np.int32)
    level, ref, jsil, tsil = _smbr_inputs(variant, b, t, 15)
    scale = np.arange(1, b + 1, dtype=np.float32)

    def jobj(o):
        return jnp.sum(JB.batched_expected_accuracy(
            o, jg, jnp.asarray(ref), jnp.asarray(lens), level, jnp.asarray(P2P), jsil) * scale)

    jv, jgrad = jax.value_and_grad(jobj)(jnp.asarray(obs))
    o = torch.from_numpy(obs).requires_grad_(True)
    rows = TB.batched_expected_accuracy(o, tg, torch.from_numpy(ref), torch.from_numpy(lens),
                                        level, torch.from_numpy(P2P), tsil)
    tv = (rows * torch.from_numpy(scale)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)


def _time_sync_fsa(seed, t_len, k, num_pdfs):
    """tests/test_silence.py:211-234's time-synchronous lattice: state 0 at
    frame 0, k states at each later frame, every state joined to every
    state of the next frame; (DenseFsa, state→frame)."""
    rng = np.random.RandomState(seed)
    n_states = 1 + t_len * k
    frames = np.zeros(n_states, np.int32)
    for t in range(1, t_len + 1):
        frames[1 + (t - 1) * k: 1 + t * k] = t
    src, dst, pdf, w = [], [], [], []
    for t in range(t_len):
        cur = [0] if t == 0 else list(range(1 + (t - 1) * k, 1 + t * k))
        for s in cur:
            for d in range(1 + t * k, 1 + (t + 1) * k):
                src.append(s)
                dst.append(d)
                pdf.append(rng.randint(0, num_pdfs))
                w.append(rng.randn() * 0.3)
    final = np.full(n_states, -np.inf, np.float32)
    final[1 + (t_len - 1) * k:] = rng.randn(k).astype(np.float32) * 0.1
    fsa = DenseFsa(n_states, np.asarray(src, np.int32), np.asarray(dst, np.int32),
                   np.asarray(pdf, np.int32), np.asarray(w, np.float32), final, 0)
    return fsa.validate(), frames


@pytest.mark.parametrize("variant", ["pdf", "phone_silence", "pdf_one_silence_class"])
def test_generic_route_matches_banded_route(variant):
    """One set of time-synchronous lattices packed both ways: the generic
    route against the banded one (the plain versions of K7-K10 here) —
    logZ, occupancies, and the expected accuracy with its gradient."""
    t_len, k = 6, 3
    pairs = [_time_sync_fsa(s, t_len, k, P) for s in (0, 1, 2)]
    bg = TB.pack_graph_batch([f for f, _ in pairs])
    lat = FL.pack_time_sync(pairs, t_pad=t_len)
    obs = torch.from_numpy(_obs(9, 3, t_len))
    lens = torch.tensor([t_len, t_len, t_len], dtype=torch.int32)
    gz, ggam = TB.fsa_occupancies_b(obs, bg, lens)
    bz, bgam = FL.lattice_occupancies_ts(obs, lat, lens)
    np.testing.assert_allclose(gz.numpy(), bz.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ggam.numpy(), bgam.numpy(), rtol=1e-4, atol=1e-5)
    level, ref, _, tsil = _smbr_inputs(variant, 3, t_len, 10)
    ref, p2p = torch.from_numpy(ref), torch.from_numpy(P2P)
    out = []
    for fn, graphs in ((TB.batched_expected_accuracy, bg),
                       (FL.lattice_expected_accuracy_ts, lat)):
        o = obs.clone().requires_grad_(True)
        f = fn(o, graphs, ref, lens, level, p2p, tsil)
        f.sum().backward()
        out.append((f.detach().numpy(), o.grad.numpy()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# make_se_lattice_steps on BatchedGraphs (F6)
# ---------------------------------------------------------------------------

NUM_PDFS, HIDDEN, BATCH, T_MAX = 5, 32, 3, 80
OPT = dict(type="momentum", lr=0.05, momentum=0.9, grad_clip=5.0)


def _feat_cfgs():
    fo, mo = dict(dither=0.0), dict(num_bins=24)
    return (C.FeatConfig(fbank=C.FbankOpts(frame_opts=C.FrameOpts(**fo), mel_opts=C.MelOpts(**mo))),
            JC.FeatConfig(fbank=JC.FbankOpts(frame_opts=JC.FrameOpts(**fo),
                                             mel_opts=JC.MelOpts(**mo))))


@pytest.mark.parametrize("criterion", ["mmi", "smbr"])
def test_lattice_steps_on_batched_graphs_track_jax(tmp_path, pallas_interpret, criterion):
    """tests/test_fb_batched.py:72-135 and :222-248 in the port: 3 train
    steps on one batch of the toy corpus and one BatchedGraphs of graphs of
    different sizes, from the same initial parameters, in fp32 with dither
    and dropout 0."""
    paths = make_toy_corpus(str(tmp_path), num_utts=BATCH, num_pdfs=NUM_PDFS, min_sec=0.5,
                            max_sec=0.8, seed=21)
    jds = JDataset(wav_scp=paths["wav_scp"], ali=paths["ali"],
                   frame_opts=JC.FrameOpts(dither=0.0))
    batch = next(iter(JSeq(jds, JBucket(boundaries=(T_MAX,), batch_sizes=BATCH),
                           shuffle=False)))
    batch.pop("utt_ids")
    graphs = [_full(30 + i, 4 + 3 * i, NUM_PDFS) for i in range(BATCH)]
    jg, tg = _both(graphs)
    ct, cj = _feat_cfgs()
    mk = dict(type="lstm", input_size=24, hidden_size=HIDDEN, num_layers=1,
              output_size=NUM_PDFS, compute_dtype="float32")
    jm = jax_build_model(JC.ModelConfig(**mk))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tm = build_model(C.ModelConfig(**mk))
    tm.load_state_dict(params_from_jax(params))
    log_prior = np.log(np.full(NUM_PDFS, 1.0 / NUM_PDFS, np.float32)) + np.linspace(
        -0.2, 0.2, NUM_PDFS).astype(np.float32)
    kw = dict(log_prior=log_prior, acoustic_scale=0.5, ce_ratio=0.1, criterion=criterion)
    jopt = jax_make_optimizer(JC.OptimizerConfig(**OPT))
    _jfwd, jtrain = jax_lattice_steps(jm, JaxPipeline(cj), jopt, **kw)
    _tfwd, ttrain = make_se_lattice_steps(
        tm, FeaturePipeline(ct), make_optimizer(C.OptimizerConfig(**OPT), tm.parameters()),
        **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = torch_batch(batch)
    for _ in range(3):
        jp, jstate, jm_ = jtrain(jp, jstate, jb, jg, jax.random.PRNGKey(0))
        tm_ = ttrain(tb, tg)
        np.testing.assert_allclose(float(tm_["objective"]), float(jm_["objective"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tm_["frame_acc"]), float(jm_["frame_acc"]), atol=1e-6)
        assert float(tm_["frames"]) == float(jm_["frames"])
    got = params_to_jax(tm.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _small_setup(seed=0, b=4, samples=4000):
    """A 1×16 LSTM over 16 fbank bins and a random-wave batch of B rows
    (tests/test_fb_batched.py:250-294's lattice mesh test)."""
    feat = FeaturePipeline(C.FeatConfig(fbank=C.FbankOpts(
        frame_opts=C.FrameOpts(dither=0.0), mel_opts=C.MelOpts(num_bins=16))))
    model_cfg = {"type": "lstm", "hidden_size": 16, "num_layers": 1, "output_size": 3,
                 "compute_dtype": "float32"}
    model = build_model(C.ModelConfig(input_size=16, **model_cfg),
                        generator=torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(30)
    t = num_frames(samples, C.FrameOpts(dither=0.0))
    batch = {"wave": (rng.randn(b, samples) * 1000).astype(np.float32),
             "labels": rng.randint(0, 3, (b, t)).astype(np.int32),
             "mask": np.ones((b, t), np.float32),
             "num_frames": np.full((b,), t, np.int32)}
    return feat, model, model_cfg, batch


def test_lattice_steps_route_by_lattice_type(monkeypatch):
    """A TimeSyncLattice takes K7-K10's wrappers; a BatchedGraphs reaches
    none of them; anything else is refused."""
    feat, model, _, batch = _small_setup(b=2)
    calls = []
    for name in ("logz_fwd", "occupancies_bwd", "smbr_fwd", "smbr_contribs_bwd"):
        real = getattr(KC, name)

        def spy(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)

        monkeypatch.setattr(KC, name, spy)
    t = batch["labels"].shape[1]
    pairs = [_time_sync_fsa(s, t, 2, 3) for s in (0, 1)]
    tb = torch_batch(batch)
    for crit, kernels in (("mmi", ["logz_fwd", "occupancies_bwd"]),
                          ("smbr", ["smbr_fwd", "smbr_contribs_bwd"])):
        _fwd, train = make_se_lattice_steps(
            model, feat, make_optimizer(C.OptimizerConfig(**OPT), model.parameters()),
            acoustic_scale=1.0, criterion=crit)
        calls.clear()
        m = train(tb, TB.pack_graph_batch([f for f, _ in pairs]))
        assert calls == [] and np.isfinite(float(m["objective"]))
        train(tb, FL.pack_time_sync(pairs, t_pad=t))
        assert calls == kernels
        with pytest.raises(TypeError, match="BatchedGraphs"):
            train(tb, tuple(FL.pack_time_sync(pairs, t_pad=t)))


def test_lattice_steps_two_gloo_ranks_match_one_process(tmp_path):
    """tests/test_fb_batched.py:250-294 with two gloo ranks for its 8-device
    mesh: each rank steps on half the rows and its own graphs, packed to its
    own bucket (64 and 128 arcs), against one process on all rows and
    graphs in one bucket; MMI and sMBR, each from the initial parameters."""
    feat, model, model_cfg, batch = _small_setup()
    init = str(tmp_path / "init.npz")
    save_checkpoint(init, model)
    graphs = [_full(40 + i, n, 3) for i, n in enumerate((3, 4, 7, 9))]
    se = dict(acoustic_scale=1.0, ce_ratio=0.1)
    spec = {"bins": 16, "model": model_cfg, "init": init, "opt": OPT, "se": se,
            "criteria": ["mmi", "smbr"]}
    inputs = {}
    for r in range(2):
        rows = slice(2 * r, 2 * r + 2)
        g = TB.pack_graph_batch([DenseFsa(**x) for x in graphs[rows]])
        inputs.update({f"{r}/{k}": v[rows] for k, v in batch.items()})
        inputs.update({f"{r}/g_{k}": v.numpy() for k, v in g._asdict().items()})
    ranks = spawn_ranks("se_lattice", 2, tmp_path / "ranks", spec, inputs)
    assert [int(r["arcs"]) for r in ranks] == [64, 128]
    whole = TB.pack_graph_batch([DenseFsa(**x) for x in graphs])
    for crit in spec["criteria"]:
        model = build_model(C.ModelConfig(input_size=16, **model_cfg))
        load_checkpoint(init, model)
        _fwd, train = make_se_lattice_steps(
            model, feat, make_optimizer(C.OptimizerConfig(**OPT), model.parameters()),
            criterion=crit, **se)
        m = train(torch_batch(batch), whole)
        single = {keystr(p): v for p, v in walk(params_to_jax(model.state_dict()))}
        p0, p1 = ({k[len(f"{crit}/p"):]: v for k, v in r.items()
                   if k.startswith(f"{crit}/p")} for r in ranks)
        assert set(p0) == set(single)
        for k in single:
            np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
            np.testing.assert_allclose(p0[k], single[k], rtol=3e-5, atol=3e-6, err_msg=k)
        for r in ranks:
            assert abs(float(r[f"{crit}/m/objective"]) - float(m["objective"])) < 1e-5
            assert float(r[f"{crit}/m/frames"]) == float(m["frames"])
