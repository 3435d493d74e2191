"""Fault F5: resuming a JAX package checkpoint in the port carries the optax state.

The JAX CLI trains one epoch of ``train_ce`` on the toy corpus (Adam with a
warmup schedule, and momentum SGD); both CLIs then resume that checkpoint
(``-resume_from_model``) for a second epoch on the same batches. The port
maps the optax chain's leaves into its optimizer (Adam's moments and count,
the momentum trace, the schedule count, the injected lr_scale), so the
resumed epochs agree: per-step losses to rtol 2e-5 (as
tests/test_torch_train_ce_cli.py holds the CLIs) and parameters to
tests/test_torch_trainer.py's bounds (rtol 1e-3, atol 2e-5; under Adam, whose
steps are ~lr whatever the gradient, all but 5 in 1e3 elements so and every
element within 5 lr). The LSTM is H=128 with 8 rows a batch, the shapes of the JAX
package's Pallas kernels, run in interpret mode: the port's recurrence
takes their bf16 h·Wh. With the mapping disabled the port restarts the
optimizer, as it did before the repair, and the same comparison fails.
An optax state the port cannot map is named in one warning.
"""

import json
import os

import numpy as np
import pytest
import yaml

from pykaldi2_tpu_torch.bin.train_ce import main
from pykaldi2_tpu_torch.utils import checkpoint

from toydata import make_toy_corpus

OPTS = {"adam": {"type": "adam", "lr": 0.01, "warmup_steps": 10, "grad_clip": 5.0},
        "momentum": {"type": "momentum", "momentum": 0.9, "lr": 0.05, "grad_clip": 5.0}}
LOSS_RTOL = 2e-5
PARAMS_TOL = dict(rtol=1e-3, atol=2e-5)


def _losses(exp: str) -> list:
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if "step" in r]


def _agree(got: dict, want: dict, name: str) -> list:
    """The parameters outside tests/test_torch_trainer.py's bounds."""
    bad = []
    for k in want:
        close = np.isclose(got[k], want[k], **PARAMS_TOL)
        if name != "adam" and not close.all():
            bad.append(k)
        elif name == "adam" and (close.mean() <= 0.995 or np.abs(got[k] - want[k]).max()
                                 > 5 * OPTS["adam"]["lr"]):
            bad.append(k)
    return bad


def _params(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("['params']")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{optimizer: (config, the JAX epoch-0 checkpoint, the JAX resumed
    epoch's exp_dir)}, with the JAX Pallas kernels in interpret mode."""
    from jax.experimental import pallas as pl

    from pykaldi2_tpu.bin.train_ce import main as jax_main

    root = tmp_path_factory.mktemp("resume")
    paths = make_toy_corpus(str(root / "corpus"), num_utts=6, num_pdfs=4, seed=17)
    data = str(root / "data.yaml")
    with open(data, "w") as f:
        yaml.safe_dump({"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
                        "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                           "mel_opts": {"num_bins": 24}}}}, f)
    orig = pl.pallas_call
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
        mp.setenv("PK2_PALLAS_LSTM", "1")
        mp.setenv("PK2_PALLAS_FBANK", "1")
        for name, opt in OPTS.items():
            cfg = str(root / f"{name}.yaml")
            with open(cfg, "w") as f:
                yaml.safe_dump({
                    "model": {"type": "lstm", "hidden_size": 128, "num_layers": 1,
                              "output_size": 4, "compute_dtype": "float32", "dropout": 0.0},
                    "optimizer": opt,
                    "trainer": {"batch_size": 8, "chunk_len": 40, "num_epochs": 1,
                                "log_interval": 1, "seed": 5}}, f)
            first, resumed = str(root / f"{name}_jax0"), str(root / f"{name}_jax1")
            # one device: interpret-mode Pallas does not run in a CPU shard_map
            assert jax_main(["-config", cfg, "-data", data, "-exp_dir", first,
                             "-single_device"]) == 0
            ckpt = os.path.join(first, "model.0.npz")
            assert jax_main(["-config", cfg, "-data", data, "-exp_dir", resumed,
                             "-resume_from_model", ckpt, "-num_epochs", "2",
                             "-single_device"]) == 0
            out[name] = (cfg, data, ckpt, resumed)
    return out


def _port_resume(runs, name: str, exp: str):
    cfg, data, ckpt, jax_exp = runs[name]
    assert main(["-config", cfg, "-data", data, "-exp_dir", exp, "-resume_from_model", ckpt,
                 "-num_epochs", "2"], device="cpu") == 0
    return (_losses(exp), _params(os.path.join(exp, "model.1.npz")),
            _losses(jax_exp), _params(os.path.join(jax_exp, "model.1.npz")))


@pytest.mark.parametrize("name", sorted(OPTS))
def test_port_resumes_jax_checkpoint_with_its_optimizer_state(runs, name, tmp_path):
    got_l, got_p, want_l, want_p = _port_resume(runs, name, str(tmp_path / "port"))
    assert len(got_l) == len(want_l) >= 2
    np.testing.assert_allclose(got_l, want_l, rtol=LOSS_RTOL)
    assert set(got_p) == set(want_p)
    assert not _agree(got_p, want_p, name)
    with open(tmp_path / "port" / "train.log") as f:
        assert "not carried over" not in f.read()


@pytest.mark.parametrize("name", sorted(OPTS))
def test_resume_without_the_mapping_shows_the_fault(runs, name, tmp_path, monkeypatch):
    """The fault as it was: the optax state dropped, now with a warning."""
    monkeypatch.setattr(checkpoint, "opt_state_from_jax",
                        lambda *a: ["the mapping, disabled by the test"])
    got_l, got_p, want_l, want_p = _port_resume(runs, name, str(tmp_path / "port"))
    with open(tmp_path / "port" / "train.log") as f:
        assert "not carried over from the JAX checkpoint" in f.read()
    assert _agree(got_p, want_p, name), "a restarted optimizer should move past the bounds"
    assert not np.allclose(got_l[1:], want_l[1:], rtol=LOSS_RTOL)


def test_unmappable_opt_state_is_named_in_one_warning(runs, caplog):
    """A momentum run's optax state resumed by an Adam optimizer: nothing is
    loaded, and one warning names the checkpoint and what was dropped."""
    from pykaldi2_tpu_torch import config as C
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.utils import make_optimizer

    _cfg, _data, ckpt, _ = runs["momentum"]
    model = build_model(C.ModelConfig(type="lstm", input_size=24, hidden_size=128,
                                      num_layers=1, output_size=4, compute_dtype="float32"))
    opt = make_optimizer(C.OptimizerConfig(**OPTS["adam"]), model.parameters())
    with caplog.at_level("WARNING", logger="pykaldi2_tpu_torch"):
        checkpoint.load_checkpoint(ckpt, model, opt)
    warned = [r for r in caplog.records if "not carried over" in r.getMessage()]
    assert len(warned) == 1 and ckpt in warned[0].getMessage()
    assert "trace" in warned[0].getMessage()
    assert opt.count == 0 and not opt.base.state_dict()["state"]
