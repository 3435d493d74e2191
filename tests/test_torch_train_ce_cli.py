"""The port's ``bin/train_ce`` CLI on a toy corpus on the CPU (PK2_PLATFORM=cpu).

Same flags, JSONL metrics and checkpoints as pykaldi2_tpu/bin/train_ce.py;
options that wait for later slices raise.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from pykaldi2_tpu_torch.bin.train_ce import main

from toydata import make_toy_corpus


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
    ({"model": {"proj_size": 8}}, [], "K5/K6"),
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
