"""The port's ``bin/train_ce`` CLI on a toy corpus on the CPU (PK2_PLATFORM=cpu).

Same flags, JSONL metrics and checkpoints as pykaldi2_tpu/bin/train_ce.py;
options that wait for later slices raise. A BLSTMP model on MFCC features
tracks the JAX trainer step by step from the same seed checkpoint.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from pykaldi2_tpu_torch.bin.train_ce import main

from toydata import make_toy_corpus
from torch_port_helpers import pallas_interpret  # noqa: F401


@pytest.fixture
def cli_files(tmp_path, monkeypatch):
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=5, num_pdfs=4, seed=17)
    data = {"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
            "feat": {"fbank": {"frame_opts": {"dither": 0.0}, "mel_opts": {"num_bins": 24}}}}
    cfg = {"model": {"type": "lstm", "hidden_size": 16, "num_layers": 2, "output_size": 4,
                     "compute_dtype": "float32"},
           "optimizer": {"type": "adam", "lr": 0.01},
           "trainer": {"batch_size": 4, "chunk_len": 40, "num_epochs": 2, "log_interval": 1}}
    dp, cp = str(tmp_path / "data.yaml"), str(tmp_path / "exp.yaml")

    def write(data_over=None, cfg_over=None):
        d = json.loads(json.dumps(data))
        c = json.loads(json.dumps(cfg))
        for k, v in (data_over or {}).items():
            d[k] = v
        for sect, v in (cfg_over or {}).items():
            c[sect].update(v)
        with open(dp, "w") as f:
            yaml.safe_dump(d, f)
        with open(cp, "w") as f:
            yaml.safe_dump(c, f)
        return cp, dp

    write()
    return tmp_path, write


def _metrics(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_ce_cli_trains_checkpoints_and_resumes(cli_files):
    tmp, write = cli_files
    cp, dp = write()
    exp = str(tmp / "exp")
    assert main(["-config", cp, "-data", dp, "-exp_dir", exp]) == 0
    assert os.path.exists(os.path.join(exp, "model.1.npz"))
    assert os.path.exists(os.path.join(exp, "train.log"))
    lines = _metrics(exp)
    steps = [r for r in lines if "step" in r]
    assert steps and all(np.isfinite(r["loss"]) for r in steps)
    assert {"loss", "frame_acc", "utt_per_sec", "frames_per_sec"} <= set(steps[0])
    ep = [r for r in lines if "epoch_loss" in r]
    assert len(ep) == 2 and ep[1]["epoch_loss"] < ep[0]["epoch_loss"] * 1.05
    # resume from the latest checkpoint: only epoch 2 runs
    assert main(["-config", cp, "-data", dp, "-exp_dir", exp, "-num_epochs", "3"]) == 0
    assert os.path.exists(os.path.join(exp, "model.2.npz"))
    assert [r["epoch"] for r in _metrics(exp) if "epoch_loss" in r] == [0, 1, 2]


def test_train_ce_cli_cv_profile_and_overrides(cli_files):
    tmp, write = cli_files
    cp, dp = write(cfg_over={"model": {"compute_dtype": "bfloat16", "dropout": 0.2}})
    exp, prof = str(tmp / "exp"), str(tmp / "prof")
    assert main(["-config", cp, "-data", dp, "-cv_data", dp, "-exp_dir", exp,
                 "-lr", "0.002", "-batch_size", "3", "-num_epochs", "1",
                 "-log_interval", "2", "-profile", prof]) == 0
    lines = _metrics(exp)
    assert sum(1 for r in lines if "cv_loss" in r) == 1
    assert all(r["step"] % 2 == 0 for r in lines if "step" in r)
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0


def test_train_ce_cli_seed_model(cli_files):
    tmp, write = cli_files
    cp, dp = write(cfg_over={"trainer": {"num_epochs": 1}})
    exp1, exp2 = str(tmp / "a"), str(tmp / "b")
    assert main(["-config", cp, "-data", dp, "-exp_dir", exp1]) == 0
    assert main(["-config", cp, "-data", dp, "-exp_dir", exp2,
                 "-seed_model", os.path.join(exp1, "model.0.npz")]) == 0
    assert os.path.exists(os.path.join(exp2, "model.0.npz"))


@pytest.mark.parametrize("over,argv,err", [
    ({}, ["-multihost"], "DDP"),
    ({"trainer": {"mesh_shape": {"data": 2}}}, [], "DDP"),
    ({"optimizer": {"grad_compression": "bf16"}}, [], "DDP"),
    ({"model": {"type": "tdnn"}}, [], "not ported"),
])
def test_train_ce_cli_unported_options_raise(cli_files, over, argv, err):
    tmp, write = cli_files
    cp, dp = write(cfg_over=over)
    with pytest.raises(NotImplementedError, match=err):
        main(["-config", cp, "-data", dp, "-exp_dir", str(tmp / "x"), *argv])


def test_train_ce_cli_needs_cuda_unless_cpu_requested(cli_files, monkeypatch):
    tmp, write = cli_files
    cp, dp = write()
    monkeypatch.delenv("PK2_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-config", cp, "-data", dp, "-exp_dir", str(tmp / "x")])
    assert main(["-config", cp, "-data", dp, "-exp_dir", str(tmp / "y"), "-num_epochs", "1"],
                device="cpu") == 0


def test_train_ce_cli_blstmp_mfcc_tracks_jax(cli_files, pallas_interpret):
    """A 2-layer BLSTMP (H=256, P=128) on 13 MFCCs with energy through the
    port's CLI (K4 and K5/K6 plain versions) against the JAX trainer (its
    Pallas fused MFCC and LSTMP kernels in interpret mode), from one JAX-made
    seed checkpoint, on the same batches: 4 momentum steps in fp32, dither 0,
    dropout 0. Step i's loss is taken before update i, so it differs only by
    the drift of the earlier updates (rtol 2e-5, as tests/test_torch_trainer.py
    holds the LSTM)."""
    import jax
    import jax.numpy as jnp

    from pykaldi2_tpu import config as JC
    from pykaldi2_tpu.data.dataloader import ChunkDataloader as JChunk
    from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
    from pykaldi2_tpu.models import build_model as jax_build_model
    from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline
    from pykaldi2_tpu.trainer import make_ce_train_step as jax_train_step
    from pykaldi2_tpu.utils import make_optimizer as jax_make_optimizer
    from pykaldi2_tpu.utils import save_checkpoint as jax_save

    tmp, write = cli_files
    mfcc = {"frame_opts": {"dither": 0.0}}
    model = {"type": "blstm", "hidden_size": 256, "proj_size": 128, "num_layers": 2,
             "output_size": 4, "compute_dtype": "float32", "dropout": 0.0}
    opt = {"type": "momentum", "momentum": 0.9, "lr": 0.01, "grad_clip": 5.0}
    trainer = {"batch_size": 8, "chunk_len": 24, "num_epochs": 1, "log_interval": 1,
               "seed": 3}
    cp, dp = write(data_over={"feat": {"type": "mfcc", "mfcc": mfcc}},
                   cfg_over={"model": model, "optimizer": opt, "trainer": trainer})
    with open(dp) as f:
        data = yaml.safe_load(f)
    jmodel = jax_build_model(JC.ModelConfig(input_size=13, **model))
    params = jmodel.init(jax.random.PRNGKey(5))
    seed_ckpt = str(tmp / "seed.npz")
    jax_save(seed_ckpt, params)

    exp = str(tmp / "exp")
    assert main(["-config", cp, "-data", dp, "-exp_dir", exp, "-seed_model", seed_ckpt]) == 0
    port_losses = [r["loss"] for r in _metrics(exp) if "step" in r]
    assert len(port_losses) >= 4

    fo = JC.FrameOpts(dither=0.0)
    jds = JDataset(wav_scp=data["wav_scp"], ali=data["label_ark"], frame_opts=fo)
    loader = JChunk(jds, batch_size=8, chunk_len=24, shuffle=True, seed=3)
    loader.set_epoch(0)
    feat = JaxPipeline(JC.FeatConfig(type="mfcc", mfcc=JC.MfccOpts(frame_opts=fo)))
    jopt = jax_make_optimizer(JC.OptimizerConfig(**opt))
    step = jax_train_step(jmodel, feat, jopt, mesh=None, donate=False)
    state = jopt.init(params)
    for i, b in zip(range(4), loader):
        params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in b.items()},
                                jax.random.PRNGKey(0))
        np.testing.assert_allclose(port_losses[i], float(m["loss"]), rtol=2e-5)


def test_train_ce_cli_reference_flags_match_jax_cli(cli_files):
    """A reference command line with ``-single_device`` and ``-debug_nans``
    through both CLIs, warm-started from one JAX-made checkpoint: both exit
    0 and log the same per-step losses on the same batches (Adam, fp32,
    dither 0, dropout 0; rtol 2e-5, as the BLSTMP case above). The JAX CLI's
    ``-debug_nans`` sets ``jax_debug_nans`` for the whole process, and the
    port's sets autograd anomaly detection: both are set back afterwards."""
    import jax

    from pykaldi2_tpu import config as JC
    from pykaldi2_tpu.bin.train_ce import main as jax_main
    from pykaldi2_tpu.models import build_model as jax_build_model
    from pykaldi2_tpu.utils import save_checkpoint as jax_save

    tmp, write = cli_files
    model = {"type": "lstm", "hidden_size": 16, "num_layers": 2, "output_size": 4,
             "compute_dtype": "float32", "dropout": 0.0}
    cp, dp = write(cfg_over={"model": model, "trainer": {"num_epochs": 1, "seed": 4}})
    params = jax_build_model(JC.ModelConfig(input_size=24, **model)).init(jax.random.PRNGKey(9))
    seed_ckpt = str(tmp / "seed.npz")
    jax_save(seed_ckpt, params)
    losses = {}
    try:
        for name, run in (("jax", jax_main), ("port", main)):
            exp = str(tmp / name)
            assert run(["-config", cp, "-data", dp, "-exp_dir", exp, "-seed_model", seed_ckpt,
                        "-single_device", "-debug_nans"]) == 0
            losses[name] = [r["loss"] for r in _metrics(exp) if "step" in r]
    finally:
        jax.config.update("jax_debug_nans", False)
        torch.autograd.set_detect_anomaly(False)
    assert len(losses["port"]) == len(losses["jax"]) >= 2
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=2e-5)
