"""On-the-fly lattice sequence training of the PyTorch port against the JAX package.

  * ``make_se_lattice_steps``: 3 train steps under MMI, sMBR and MPFE on one
    fixed batch and one fixed banded lattice, from the same initial
    parameters (carried over by convert.py), in fp32 with dropout 0 and
    dither 0. The JAX side runs its Pallas LSTM and fbank in interpret mode
    and its lattice recursions on the scan route; objective and frame
    accuracy track per step, parameters after 3 momentum updates.
  * ``bin/train_se.main -on_the_fly`` on the CPU (PK2_PLATFORM=cpu) on the
    toy corpus, as tests/test_fb_batched.py:222-247 runs the JAX CLI: the run
    finishes with a finite objective, and its checkpoint loads in the JAX
    package's ``load_checkpoint``; and the same run from the same seed model
    through both CLIs gives the same per-step objectives, which holds the
    decode/train overlap to the reference's one-step staleness;
  * ``-on_the_fly -decoder device`` (the device search, same-step
    parameters) under MMI and sMBR through both CLIs: the same per-step
    objectives, and ``lattice_links_dropped`` in ``metrics.jsonl``.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
import jax
import jax.numpy as jnp

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.bin.train_se import main as jax_se_main
from pykaldi2_tpu.data.dataloader import BucketSpec as JBucket, SeqDataloader as JSeq
from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.ops.fb_lattice import TimeSyncLattice as JLattice
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline
from pykaldi2_tpu.trainer import make_se_lattice_steps as jax_lattice_steps
from pykaldi2_tpu.utils import load_checkpoint as jax_load
from pykaldi2_tpu.utils import make_optimizer as jax_make_optimizer

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.bin.train_se import main
from pykaldi2_tpu_torch.convert import params_from_jax, params_to_jax
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.ops.fb import NEG_INF
from pykaldi2_tpu_torch.ops.fb_lattice import TimeSyncLattice
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.trainer import make_se_lattice_steps
from pykaldi2_tpu_torch.utils import make_optimizer, save_checkpoint

from toydata import make_toy_corpus
from torch_dist_worker import one_rank_group
from torch_port_helpers import pallas_interpret, torch_batch  # noqa: F401

NUM_PDFS, HIDDEN, BATCH, T_MAX = 5, 32, 3, 80
OPT = dict(type="momentum", lr=0.05, momentum=0.9, grad_clip=5.0)


def _feat_cfgs():
    fo, mo = dict(dither=0.0), dict(num_bins=24)
    return (C.FeatConfig(fbank=C.FbankOpts(frame_opts=C.FrameOpts(**fo), mel_opts=C.MelOpts(**mo))),
            JC.FeatConfig(fbank=JC.FbankOpts(frame_opts=JC.FrameOpts(**fo),
                                             mel_opts=JC.MelOpts(**mo))))


def _random_lattice(t_len, seed=0, k=32, a=64, live=16):
    """A forward-connected banded lattice over the toy pdfs (numpy)."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, live, (BATCH, t_len, a)).astype(np.int32)
    src[:, 0, :] = 0
    dst = rng.randint(0, live, (BATCH, t_len, a)).astype(np.int32)
    w = (rng.randn(BATCH, t_len, a) * 0.3).astype(np.float32)
    w[:, :, 48:] = NEG_INF
    final = np.full((BATCH, k), NEG_INF, np.float32)
    final[:, :live] = 0.0
    pdf = rng.randint(0, NUM_PDFS, (BATCH, t_len, a)).astype(np.int32)
    return src, dst, pdf, w, final


@pytest.mark.parametrize("criterion", ["mmi", "smbr", "mpfe"])
def test_three_lattice_steps_track_jax(tmp_path, pallas_interpret, monkeypatch, criterion):
    monkeypatch.setenv("PK2_PALLAS_LATFB", "0")
    monkeypatch.setenv("PK2_LATFB_MATVEC", "0")
    paths = make_toy_corpus(str(tmp_path), num_utts=3, num_pdfs=NUM_PDFS, min_sec=0.5,
                            max_sec=0.8, seed=21)
    jds = JDataset(wav_scp=paths["wav_scp"], ali=paths["ali"],
                   frame_opts=JC.FrameOpts(dither=0.0))
    batch = next(iter(JSeq(jds, JBucket(boundaries=(T_MAX,), batch_sizes=BATCH),
                           shuffle=False)))
    batch.pop("utt_ids")
    lat_np = _random_lattice(T_MAX)
    ct, cj = _feat_cfgs()
    mk = dict(type="lstm", input_size=24, hidden_size=HIDDEN, num_layers=1,
              output_size=NUM_PDFS, compute_dtype="float32")
    jm = jax_build_model(JC.ModelConfig(**mk))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tm = build_model(C.ModelConfig(**mk))
    tm.load_state_dict(params_from_jax(params))
    log_prior = np.log(np.full(NUM_PDFS, 1.0 / NUM_PDFS, np.float32)) + np.linspace(
        -0.2, 0.2, NUM_PDFS).astype(np.float32)
    p2p = (np.arange(NUM_PDFS) % 2 + 1).astype(np.int32)
    kw = dict(log_prior=log_prior, acoustic_scale=0.5, ce_ratio=0.1, criterion=criterion,
              pdf_to_phone=p2p)
    jopt = jax_make_optimizer(JC.OptimizerConfig(**OPT))
    _jfwd, jtrain = jax_lattice_steps(jm, JaxPipeline(cj), jopt, **kw)
    _tfwd, ttrain = make_se_lattice_steps(
        tm, FeaturePipeline(ct), make_optimizer(C.OptimizerConfig(**OPT), tm.parameters()),
        **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlat = JLattice(*(jnp.asarray(x) for x in lat_np))
    tb = torch_batch(batch)
    tlat = TimeSyncLattice(*(torch.from_numpy(x) for x in lat_np))
    for _ in range(3):
        jp, jstate, jm_ = jtrain(jp, jstate, jb, jlat, jax.random.PRNGKey(0))
        tm_ = ttrain(tb, tlat)
        np.testing.assert_allclose(float(tm_["objective"]), float(jm_["objective"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tm_["frame_acc"]), float(jm_["frame_acc"]), atol=1e-6)
        assert float(tm_["frames"]) == float(jm_["frames"])
    got = params_to_jax(tm.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def _cli_config(tmp_path, num_epochs=2):
    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=6, num_pdfs=4, seed=8)
    cfg = {
        "model": {"type": "lstm", "hidden_size": 24, "num_layers": 1,
                  "output_size": 4, "compute_dtype": "float32"},
        "optimizer": {"type": "momentum", "momentum": 0.9, "lr": 1e-3},
        "trainer": {"batch_size": 3, "num_epochs": num_epochs, "log_interval": 1,
                    "beam": 24.0, "lattice_beam": 12.0, "acoustic_scale": 1.0},
        "data": {"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
                 "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                    "mel_opts": {"num_bins": 24}}}},
    }
    cfg_path = tmp_path / "se.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(cfg_path), cfg


def _jax_template(cfg):
    jm = jax_build_model(JC.ModelConfig(**{**cfg["model"], "input_size": 24}))
    return jm, jm.init(jax.random.PRNGKey(5))


def _step_records(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "step" in r]


@pytest.mark.parametrize("criterion,extra", [
    ("mmi", []),
    ("smbr", ["-no_overlap"]),
    ("mpfe", ["-silence_phones", "1"]),
])
def test_train_se_on_the_fly_cli_on_cpu(tmp_path, monkeypatch, criterion, extra):
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    cfg_path, cfg = _cli_config(tmp_path)
    exp = str(tmp_path / "exp")
    assert main(["-config", cfg_path, "-exp_dir", exp, "-on_the_fly", "-criterion",
                 criterion, "-num_threads", "2", *extra]) == 0
    with open(os.path.join(exp, "model.1.npz.json")) as f:
        assert np.isfinite(json.load(f)["objective"])
    steps = _step_records(exp)
    assert steps and all(np.isfinite(r["objective"]) for r in steps)
    for key in ("forward_ms", "decode_ms", "pack_ms", "train_ms", "lat_k", "lat_a"):
        assert key in steps[0]
    assert steps[0]["lat_k"] >= 8 and steps[0]["lat_a"] >= 64
    _jm, template = _jax_template(cfg)
    loaded, _opt, meta = jax_load(os.path.join(exp, "model.1.npz"), template)
    assert meta["epoch"] == 1
    for leaf in jax.tree.leaves(loaded):
        assert np.all(np.isfinite(np.asarray(leaf)))


def test_train_se_cli_tracks_jax_cli(tmp_path, pallas_interpret, monkeypatch):
    """Both CLIs from one seed model, fp32 obs to the decoder: the same
    lattices, the same one-step-stale overlap, the same per-step objectives."""
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    cfg_path, cfg = _cli_config(tmp_path, num_epochs=1)
    jm, params = _jax_template(cfg)
    tm = build_model(C.ModelConfig(**{**cfg["model"], "input_size": 24}))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    seed = str(tmp_path / "seed.npz")
    save_checkpoint(seed, tm)
    argv = ["-config", cfg_path, "-on_the_fly", "-criterion", "mmi", "-num_threads", "2",
            "-obs_transfer", "float32", "-seed_model", seed]
    assert jax_se_main(argv + ["-exp_dir", str(tmp_path / "jax"), "-single_device"]) == 0
    assert main(argv + ["-exp_dir", str(tmp_path / "port")]) == 0
    jr, tr = _step_records(str(tmp_path / "jax")), _step_records(str(tmp_path / "port"))
    assert len(jr) == len(tr) == 2
    # the per-frame objective is the small difference of numerator and logZ
    # row sums some 1e4 times larger: their fp32 noise shows at ~1e-5
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a["objective"], b["objective"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["frame_acc"], b["frame_acc"], atol=1e-6)


@pytest.mark.parametrize("criterion", ["mmi", "smbr"])
def test_train_se_device_decoder_tracks_jax_cli(tmp_path, pallas_interpret, monkeypatch,
                                                criterion):
    """-on_the_fly -decoder device through both CLIs from one seed model: the
    same device lattices from the same-step parameters, the same per-step
    objectives (the host-decoder test's tolerance), and the dropped-link
    count logged."""
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    cfg_path, cfg = _cli_config(tmp_path, num_epochs=1)
    jm, params = _jax_template(cfg)
    tm = build_model(C.ModelConfig(**{**cfg["model"], "input_size": 24}))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    seed = str(tmp_path / "seed.npz")
    save_checkpoint(seed, tm)
    # K = 16 frontier slots of 8 in-arcs each: a band of 128 drops nothing (a
    # band cut mid-way keeps links by score ranks that fp32 noise reorders)
    argv = ["-config", cfg_path, "-on_the_fly", "-decoder", "device", "-criterion", criterion,
            "-max_active", "16", "-max_arcs", "128", "-seed_model", seed]
    assert jax_se_main(argv + ["-exp_dir", str(tmp_path / "jax"), "-single_device"]) == 0
    assert main(argv + ["-exp_dir", str(tmp_path / "port")]) == 0
    jr, tr = _step_records(str(tmp_path / "jax")), _step_records(str(tmp_path / "port"))
    assert len(jr) == len(tr) == 2
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a["objective"], b["objective"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["frame_acc"], b["frame_acc"], atol=1e-6)
        assert a["lattice_links_dropped"] == b["lattice_links_dropped"] == 0
        for key in ("forward_ms", "search_ms", "compact_ms", "train_ms", "lat_k", "lat_a"):
            assert key in a


def test_train_se_device_decoder_trains(tmp_path, monkeypatch):
    """-on_the_fly -decoder device (it raised before the device search was
    ported) trains two epochs with finite objectives and a checkpoint."""
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    cfg_path, _ = _cli_config(tmp_path)
    exp = str(tmp_path / "exp")
    assert main(["-config", cfg_path, "-exp_dir", exp, "-on_the_fly", "-decoder", "device",
                 "-criterion", "mpfe", "-max_arcs", "64"]) == 0
    with open(os.path.join(exp, "model.1.npz.json")) as f:
        assert np.isfinite(json.load(f)["objective"])
    steps = _step_records(exp)
    assert steps and all(np.isfinite(r["objective"]) for r in steps)
    assert all(r["lat_a"] <= 64 for r in steps)


@pytest.mark.parametrize("argv,logged", [
    (["-multihost"], "DDP"),
    (["-on_the_fly", "-multihost"], "DDP"),
])
def test_train_se_unported_modes_raise(tmp_path, monkeypatch, argv, logged):
    """-multihost raised until the data-parallel slice was ported; now both
    modes train in a one-rank gloo group that the test starts, as a launcher
    may, and train.log names the layout (it mentions ``logged``)."""
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    cfg_path, _ = _cli_config(tmp_path, num_epochs=1)
    exp = str(tmp_path / "x")
    with one_rank_group(tmp_path):
        assert main(["-config", cfg_path, "-exp_dir", exp, *argv]) == 0
    assert os.path.exists(os.path.join(exp, "model.0.npz"))
    with open(os.path.join(exp, "train.log")) as f:
        assert logged in f.read()


def test_train_se_needs_cuda_unless_cpu_requested(tmp_path, monkeypatch):
    monkeypatch.delenv("PK2_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path, _ = _cli_config(tmp_path, num_epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-config", cfg_path, "-exp_dir", str(tmp_path / "x"), "-on_the_fly"])
    assert main(["-config", cfg_path, "-exp_dir", str(tmp_path / "y"), "-on_the_fly"],
                device="cpu") == 0
