"""The port's data and tensor parallelism (torch.distributed, gloo on the CPU)
against the JAX package's meshes.

Each test spawns 2 or 4 ranks (``tests/torch_dist_worker.py``, a FileStore
per group) and holds what they compute against the JAX steps on meshes of
``jax.devices()[:n]`` (conftest gives 8 CPU devices) and against the port
in one process, from one JAX-made initial checkpoint, in fp32 with dither 0
and dropout 0. Bounds are the reference's (tests/test_parallel.py:64-68,
:157): parameters rtol 3e-5, atol 3e-6 after one step (momentum SGD: Adam's
rsqrt amplifies fp32 summation-order noise), losses 1e-5; bf16 gradient
compression against fp32 rtol 2e-2, atol 2e-3.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline
from pykaldi2_tpu.utils import make_optimizer as jax_make_optimizer
from pykaldi2_tpu.utils import save_checkpoint as jax_save

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.data.dataloader import BucketSpec, ChunkDataloader, SeqDataloader
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.parallel.mesh import axis_sizes, make_mesh
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.utils import load_checkpoint, make_optimizer

from toydata import make_toy_corpus
from torch_dist_worker import _bigram_den, spawn_ranks
from torch_port_helpers import torch_batch

BINS = 24
PARAMS_TOL = dict(rtol=3e-5, atol=3e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-3)
OPT = dict(type="momentum", momentum=0.9, lr=0.05, grad_clip=1.0)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _prefixed(out: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in out.items() if k.startswith(prefix)}


def _assert_params(got: dict, want: dict, tol: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{what} {k}", **tol)


def _feats():
    fo = dict(dither=0.0)
    return (FeaturePipeline(C.FeatConfig(fbank=C.FbankOpts(
                frame_opts=C.FrameOpts(**fo), mel_opts=C.MelOpts(num_bins=BINS)))),
            JaxPipeline(JC.FeatConfig(fbank=JC.FbankOpts(
                frame_opts=JC.FrameOpts(**fo), mel_opts=JC.MelOpts(num_bins=BINS)))))


def _models(root, model: dict, seed: int = 0):
    """(JAX model, its initial params, checkpoint path, spec for the ranks)."""
    jm = jax_build_model(JC.ModelConfig(input_size=BINS, **model))
    params = jm.init(jax.random.PRNGKey(seed))
    init = str(root / "init.npz")
    jax_save(init, params)
    return jm, params, init, {"bins": BINS, "model": model, "init": init, "opt": OPT}


def _port_step(spec, batch, make_step):
    """The port in one process from the initial checkpoint: (params, metrics)."""
    from pykaldi2_tpu_torch.convert import keystr, params_to_jax, walk

    feat, _ = _feats()
    model = build_model(C.ModelConfig(input_size=BINS, **spec["model"]))
    load_checkpoint(spec["init"], model)
    step = make_step(model, feat, make_optimizer(C.OptimizerConfig(**spec["opt"]),
                                                 model.parameters()))
    m = step(torch_batch(batch))
    return ({keystr(p): v for p, v in walk(params_to_jax(model.state_dict()))},
            {k: float(v) for k, v in m.items()})


def _jax_sharded(mesh, batch):
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data")))
            for k, v in batch.items()}


def test_make_mesh_shapes():
    """axis_sizes is the reference make_mesh's shape check (-1 inferred,
    ValueError on a product other than the world); without a process group
    make_mesh gives a one-rank mesh with no collectives."""
    for shape in (None, {"data": 4, "model": 2}, {"data": -1, "model": 2}):
        want = jax_make_mesh(shape)
        assert tuple(axis_sizes(shape, 8)) == want.axis_names
        assert tuple(axis_sizes(shape, 8).values()) == want.devices.shape
    for shape in ({"data": 3}, {"data": 3, "model": 2}):
        with pytest.raises(ValueError):
            jax_make_mesh(shape)
        with pytest.raises(ValueError):
            axis_sizes(shape, 8)
    one = make_mesh()
    assert one.shape == {"data": 1} and one.coords == {"data": 0} and not one.distributed
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh({"data": 2})


@pytest.fixture(scope="module")
def ce_runs(tmp_path_factory):
    """One CE step from the same parameters: 2 gloo ranks (fp32 and bf16
    gradient sums), the port in one process, and the JAX step on a 2-device
    data mesh with and without bf16 compression."""
    from pykaldi2_tpu.trainer import make_ce_train_step as jax_ce_step
    from pykaldi2_tpu_torch.trainer import make_ce_train_step

    root = tmp_path_factory.mktemp("ce_dp")
    paths = make_toy_corpus(str(root / "corpus"), num_utts=8, num_pdfs=6, seed=0)
    ds = SpeechDataset(wav_scp=paths["wav_scp"], ali=paths["ali"],
                       frame_opts=C.FrameOpts(dither=0.0))
    batch = next(iter(ChunkDataloader(ds, batch_size=4, chunk_len=40, shuffle=False)))
    jm, params, init, spec = _models(root, {"type": "lstm", "hidden_size": 16,
                                            "num_layers": 1, "output_size": 6,
                                            "compute_dtype": "float32"})
    ranks = spawn_ranks("ce", 2, root / "ranks", {**spec, "compressions": ["none", "bf16"]},
                        {f"{r}/{k}": v[2 * r: 2 * r + 2] for r in range(2)
                         for k, v in batch.items()})
    single = _port_step(spec, batch, make_ce_train_step)
    _, jfeat = _feats()
    mesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    opt = jax_make_optimizer(JC.OptimizerConfig(**OPT))
    jax_out = {}
    for comp in ("none", "bf16"):
        step = jax_ce_step(jm, jfeat, opt, mesh, donate=False, grad_compression=comp)
        p, _, m = step(params, opt.init(params), _jax_sharded(mesh, batch),
                       jax.random.PRNGKey(3))
        jax_out[comp] = (_flat(p), float(m["loss"]))
    return ranks, single, jax_out


def test_ce_dp_step_matches_jax_and_single_process(ce_runs):
    ranks, (single_p, single_m), jax_out = ce_runs
    p0, p1 = (_prefixed(r, "none/p") for r in ranks)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)  # replicas in lock step
    _assert_params(p0, jax_out["none"][0], PARAMS_TOL, "vs JAX mesh")
    _assert_params(p0, single_p, PARAMS_TOL, "vs one process")
    # the metrics are global: the same on both ranks and equal to one process's
    for r in ranks:
        assert abs(float(r["none/m/loss"]) - jax_out["none"][1]) < 1e-5
        assert abs(float(r["none/m/loss"]) - single_m["loss"]) < 1e-5
        assert float(r["none/m/frames"]) == single_m["frames"]
        assert abs(float(r["none/m/frame_acc"]) - single_m["frame_acc"]) < 1e-6


def test_bf16_grad_compression_close_to_fp32_and_jax(ce_runs):
    ranks, _, jax_out = ce_runs
    fp32, bf16 = _prefixed(ranks[0], "none/p"), _prefixed(ranks[0], "bf16/p")
    for k in bf16:
        np.testing.assert_array_equal(bf16[k], _prefixed(ranks[1], "bf16/p")[k], err_msg=k)
    _assert_params(bf16, fp32, BF16_TOL, "bf16 vs fp32")
    _assert_params(bf16, jax_out["bf16"][0], BF16_TOL, "bf16 vs JAX bf16")
    # the loss is taken before the update: compression cannot change it
    assert float(ranks[0]["bf16/m/loss"]) == float(ranks[0]["none/m/loss"])
    assert any(not np.array_equal(bf16[k], fp32[k]) for k in bf16)  # it did round


def _se_setup(root):
    """The reference's test_se_dp_step_matches_single_device configuration:
    (ranks' spec, numpy prior, the SE dataset)."""
    from pykaldi2_tpu_torch.ops.se_losses import count_labels, priors_from_counts

    num_pdfs = 4
    paths = make_toy_corpus(str(root / "corpus"), num_utts=8, num_pdfs=num_pdfs, seed=22)
    ds = SpeechDataset(wav_scp=paths["wav_scp"], ali=paths["ali"],
                       frame_opts=C.FrameOpts(dither=0.0))
    _, params, init, spec = _models(root, {"type": "lstm", "hidden_size": 16, "num_layers": 1,
                                           "output_size": num_pdfs,
                                           "compute_dtype": "float32"})
    spec.update(opt={**OPT, "lr": 0.01, "grad_clip": 5.0}, wav_scp=paths["wav_scp"],
                ali=paths["ali"], num_pdfs=num_pdfs)
    prior = priors_from_counts(count_labels(ds.labels.values(), num_pdfs))
    return spec, params, prior, ds


def _port_se(spec, prior, batch):
    from pykaldi2_tpu_torch.trainer import make_se_train_step

    den = _bigram_den(spec)
    return _port_step(spec, batch, lambda model, feat, opt: make_se_train_step(
        model, feat, opt, den, "mmi", log_prior=prior, acoustic_scale=1.0, ce_ratio=0.1))


def test_se_dp_step_matches_jax_and_single_process(tmp_path):
    """The fixed-denominator MMI step (bigram den, ce_ratio 0.1) on 2 ranks
    against the JAX step on a 2-device data mesh and the port in one process
    (the reference's test_se_dp_step_matches_single_device, :71-112, and its
    bounds; the objective against JAX as noted below)."""
    from pykaldi2_tpu.data.dataloader import BucketSpec as JBucket, SeqDataloader as JSeq
    from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
    from pykaldi2_tpu.graph import HmmTopology, TransitionModel, estimate_phone_bigram
    from pykaldi2_tpu.graph.phone_lm import collapse_to_phones
    from pykaldi2_tpu.ops.fb_bigram import make_bigram_den
    from pykaldi2_tpu.trainer import make_se_train_step as jax_se_step

    spec, params, prior, _ = _se_setup(tmp_path)
    jds = JDataset(wav_scp=spec["wav_scp"], ali=spec["ali"], frame_opts=JC.FrameOpts(dither=0.0))
    batch = next(iter(JSeq(jds, JBucket(boundaries=(256,), batch_sizes=8), shuffle=False)))
    batch.pop("utt_ids")
    ranks = spawn_ranks("se", 2, tmp_path / "ranks", spec,
                        {"all/prior": prior, **{f"{r}/{k}": v[4 * r: 4 * r + 4]
                                                for r in range(2) for k, v in batch.items()}})
    single_p, single_m = _port_se(spec, prior, batch)

    tm = TransitionModel(HmmTopology.one_state(range(1, spec["num_pdfs"] + 1)))
    p2p = np.array([p for (p, _j, _pdf) in tm.tuples], np.int32)
    lm = estimate_phone_bigram([collapse_to_phones(p2p[l]) for l in jds.labels.values()],
                               tm.topo.phones)
    jm = jax_build_model(JC.ModelConfig(input_size=BINS, **spec["model"]))
    opt = jax_make_optimizer(JC.OptimizerConfig(**spec["opt"]))
    mesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    step = jax_se_step(jm, _feats()[1], opt, make_bigram_den(tm, lm), "mmi", mesh,
                       donate=False, log_prior=prior, acoustic_scale=1.0, ce_ratio=0.1)
    jp, _, jmet = step(params, opt.init(params), _jax_sharded(mesh, batch),
                       jax.random.PRNGKey(3))

    p0, p1 = (_prefixed(r, "p") for r in ranks)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    _assert_params(p0, _flat(jp), PARAMS_TOL, "vs JAX mesh")
    _assert_params(p0, single_p, PARAMS_TOL, "vs one process")
    for r in ranks:
        assert abs(float(r["m/objective"]) - single_m["objective"]) < 1e-5
        assert abs(float(r["m/ce"]) - single_m["ce"]) < 1e-5
        # against JAX, tests/test_torch_train_se_fixed_cli.py's objective bound:
        # the port's recurrence takes K2's bf16 h·Wh at every H, the JAX mesh
        # its fp32 scan (its Pallas route does not run in a CPU shard_map)
        assert abs(float(r["m/objective"]) - float(jmet["objective"])) < 1e-4


def _pad_frames(batch: dict, t: int, s: int) -> dict:
    """A sequence batch padded to t frames and s samples, as SeqDataloader
    pads (labels -1, mask and wave 0)."""
    out = dict(batch)
    for k, fill in (("labels", -1), ("mask", 0)):
        v = batch[k]
        out[k] = np.pad(v, [(0, 0), (0, t - v.shape[1])], constant_values=fill)
    out["wave"] = np.pad(batch["wave"], [(0, 0), (0, s - batch["wave"].shape[1])])
    return out


def test_ranks_on_different_bucket_t_match_single_process(tmp_path):
    """DDP needs no cross-rank padding: rank 0 steps on a 128-frame bucket,
    rank 1 on a 256-frame one, and the result is the single process's on
    their rows padded to 256 frames (the reference pads every rank to the
    largest T, bin/train_se.py:118-140)."""
    spec, _, prior, ds = _se_setup(tmp_path)
    loader = SeqDataloader(ds, BucketSpec(boundaries=(128, 256), batch_sizes=2), shuffle=False)
    by_t = {}
    for b in loader:
        b.pop("utt_ids")
        by_t.setdefault(b["labels"].shape[1], b)
    short, long_ = by_t[128], by_t[256]
    assert short["mask"].sum() > 0 and long_["mask"].sum(axis=1).max() > 128
    ranks = spawn_ranks("se", 2, tmp_path / "ranks", spec,
                        {"all/prior": prior, **{f"0/{k}": v for k, v in short.items()},
                         **{f"1/{k}": v for k, v in long_.items()}})
    assert [int(r["t_len"]) for r in ranks] == [128, 256]
    padded = _pad_frames(short, 256, long_["wave"].shape[1])
    single_p, single_m = _port_se(spec, prior, {k: np.concatenate([padded[k], long_[k]])
                                                for k in long_})
    p0, p1 = (_prefixed(r, "p") for r in ranks)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    _assert_params(p0, single_p, PARAMS_TOL, "different T vs one process")
    assert abs(float(ranks[0]["m/objective"]) - single_m["objective"]) < 1e-5
    assert float(ranks[0]["m/frames"]) == single_m["frames"]


def test_equalized_steps_lets_unequal_ranks_finish(tmp_path):
    """5 utterances over 2 ranks: the loaders hold different batch counts,
    every step all-reduces, and both ranks stop at the smallest conservative
    count instead of waiting forever (reference parallel/mesh.py:41-58)."""
    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=5, num_pdfs=4, seed=3)
    ranks = spawn_ranks("equalized", 2, tmp_path / "ranks",
                        {"wav_scp": paths["wav_scp"], "ali": paths["ali"], "batch": 2,
                         "chunk": 40})
    local = [int(r["local"]) for r in ranks]
    assert local[0] != local[1]
    steps = {int(r["steps"]) for r in ranks}
    assert steps == {min(int(r["conservative"]) for r in ranks)} and steps != {0}


def test_tp2d_step_matches_jax_and_single_device(tmp_path):
    """make_ce_train_step_2d on 4 ranks as {data: 2, model: 2} (each rank the
    rank-major coordinate of the reference's devices.reshape), the output
    layer split by columns, the clip's norm summed over 'model', against the
    JAX 2-D step on 4 devices and the single-device step (the reference's
    test_tp2d_matches_single_device): a gradient summed over 'model' that
    came out twice as large would fail here."""
    from pykaldi2_tpu.data.dataloader import ChunkDataloader as JChunk
    from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
    from pykaldi2_tpu.parallel.tensor_parallel import (_opt_specs, make_ce_train_step_2d,
                                                       shard_params)
    from pykaldi2_tpu.trainer import make_ce_train_step as jax_ce_step

    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=8, num_pdfs=6, seed=0)
    jds = JDataset(wav_scp=paths["wav_scp"], ali=paths["ali"], frame_opts=JC.FrameOpts(dither=0.0))
    batch = next(iter(JChunk(jds, batch_size=4, chunk_len=40, shuffle=False)))
    jm, params, init, spec = _models(tmp_path, {"type": "lstm", "hidden_size": 16,
                                                "num_layers": 1, "output_size": 6,
                                                "compute_dtype": "float32"})
    ranks = spawn_ranks("tp2d", 4, tmp_path / "ranks", spec,
                        {f"{d}/{k}": v[2 * d: 2 * d + 2] for d in range(2)
                         for k, v in batch.items()})
    assert [tuple(r["coords"]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]

    feat = _feats()[1]
    opt = jax_make_optimizer(JC.OptimizerConfig(**OPT))
    p1, _, m1 = jax_ce_step(jm, feat, opt, mesh=None, donate=False)(
        params, opt.init(params), batch, jax.random.PRNGKey(3))
    mesh = jax_make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    opt_nc = jax_make_optimizer(JC.OptimizerConfig(**{**OPT, "grad_clip": 0.0}))
    o = opt_nc.init(params)
    so = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), o,
                      _opt_specs(o, params), is_leaf=lambda x: isinstance(x, P))
    p2, _, m2 = make_ce_train_step_2d(jm, feat, opt_nc, mesh, donate=False, grad_clip=1.0)(
        shard_params(params, mesh), so, _jax_sharded(mesh, batch), jax.random.PRNGKey(3))

    # the port's full parameters: rank (0, m)'s output block m, the backbone of any rank
    port = {k: v for k, v in _prefixed(ranks[0], "p").items() if "out_" not in k}
    for k in ("['out_w']", "['out_b']"):
        port[k] = np.concatenate([_prefixed(ranks[m], "p")[k] for m in (0, 1)], axis=-1)
        for r in ranks[2:]:  # the other data row holds the same blocks
            np.testing.assert_array_equal(_prefixed(r, "p")[k],
                                          _prefixed(ranks[int(r["coords"][1])], "p")[k])
    for r in ranks[1:]:
        for k, v in _prefixed(r, "p").items():
            if "out_" not in k:
                np.testing.assert_array_equal(v, port[k], err_msg=k)
    _assert_params(port, _flat(p2), PARAMS_TOL, "vs JAX 2-D")
    _assert_params(port, _flat(p1), PARAMS_TOL, "vs single device")
    for r in ranks:
        assert abs(float(r["m/loss"]) - float(m2["loss"])) < 1e-5
        assert abs(float(r["m/loss"]) - float(m1["loss"])) < 1e-5
        assert float(r["m/frame_acc"]) == pytest.approx(float(m1["frame_acc"]), abs=1e-6)
