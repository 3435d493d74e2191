"""Two-process runs of the port's trainer CLIs with ``-multihost`` (gloo, CPU).

The claim of the reference's tests/test_multihost.py:1-12, for the port: two
OS processes in one process group (a FileStore; the launcher starts the group
before ``main``, as the reference's test calls jax.distributed.initialize)
run the real CLI on a shared toy corpus and (a) end — the step counts are
equalized, so no all-reduce waits forever — and (b) end with bit-identical
parameters on both ranks: DDP keeps the replicas in lock step. Each rank
writes to its own ``-exp_dir``.
"""

import os

import numpy as np
import pytest
import yaml

from toydata import make_toy_corpus
from torch_dist_worker import spawn_ranks


def _corpus(tmp_path, n: int, seed: int, name: str = "corpus") -> dict:
    paths = make_toy_corpus(str(tmp_path / name), num_utts=n, num_pdfs=4, seed=seed)
    return {"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
            "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                               "mel_opts": {"num_bins": 24}}}}


def _write(path, obj) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(obj, f)
    return str(path)


def _run(tmp_path, cli: str, argv: list, ckpt: str, world: int = 2, name: str = "ranks"):
    ranks = spawn_ranks("cli", world, tmp_path / name, {"cli": cli, "argv": argv, "ckpt": ckpt})
    assert len({str(r["sha"]) for r in ranks}) == 1
    for r in range(world):
        assert os.path.exists(tmp_path / name / f"exp{r}" / ckpt)
    return str(ranks[0]["sha"])


def test_two_process_train_ce(tmp_path):
    """train_ce -multihost with dropout (each rank draws its own masks) and a
    CV corpus of 3 utterances, so the ranks' CV loaders hold different batch
    counts (reference test_two_process_train_ce)."""
    data = _write(tmp_path / "data.yaml", _corpus(tmp_path, 10, 3))
    cv = _write(tmp_path / "cv.yaml", _corpus(tmp_path, 3, 4, "cv"))
    cfg = _write(tmp_path / "ce.yaml", {
        "model": {"type": "lstm", "hidden_size": 16, "num_layers": 1, "output_size": 4,
                  "compute_dtype": "float32", "dropout": 0.1},
        "optimizer": {"type": "adam", "lr": 0.01, "grad_compression": "bf16"},
        "trainer": {"batch_size": 4, "chunk_len": 40, "num_epochs": 2, "log_interval": 1}})
    _run(tmp_path, "train_ce", ["-config", cfg, "-data", data, "-cv_data", cv], "model.1.npz")
    with open(tmp_path / "ranks" / "exp0" / "train.log") as f:
        log = f.read()
    assert "rank 0 of 2" in log and "cv loss" in log
    assert not os.path.exists(tmp_path / "ranks" / "exp1" / "metrics.jsonl")  # rank 0 logs


@pytest.mark.parametrize("argv", [[], ["-on_the_fly", "-num_threads", "2"]],
                         ids=["fixed_den", "on_the_fly_host"])
def test_two_process_train_se(tmp_path, argv):
    """train_se -multihost over the fixed bigram denominator and on the fly
    with the host decoder: ranks decode their own rows on their own threads,
    and only the train step all-reduces."""
    cfg = _write(tmp_path / "se.yaml", {
        "model": {"type": "lstm", "hidden_size": 16, "num_layers": 1, "output_size": 4,
                  "compute_dtype": "float32"},
        "optimizer": {"type": "momentum", "momentum": 0.9, "lr": 1e-3},
        "trainer": {"batch_size": 2, "num_epochs": 1, "log_interval": 1, "beam": 24.0,
                    "lattice_beam": 12.0, "acoustic_scale": 1.0},
        "data": _corpus(tmp_path, 7, 8)})
    _run(tmp_path, "train_se", ["-config", cfg, *argv], "model.0.npz")
    with np.load(tmp_path / "ranks" / "exp0" / "model.0.npz") as z:
        assert all(np.isfinite(z[k]).all() for k in z.files)


def test_model_axis_gives_the_data_parallel_result(tmp_path):
    """trainer.mesh_shape {data: 2, model: 2} over 4 ranks: ranks that share a
    data coordinate read the same shard and draw the same dropout, and the
    gradients are summed over the data group only, so every rank ends with
    the parameters of the 2-rank data-parallel run, bit for bit (the JAX CLI
    also trains data-parallel on such a mesh)."""
    data = _write(tmp_path / "data.yaml", _corpus(tmp_path, 8, 5))
    cfg = {"model": {"type": "lstm", "hidden_size": 16, "num_layers": 1, "output_size": 4,
                     "compute_dtype": "float32", "dropout": 0.1},
           "optimizer": {"type": "momentum", "momentum": 0.9, "lr": 0.05},
           "trainer": {"batch_size": 4, "chunk_len": 40, "num_epochs": 1, "log_interval": 1}}
    shas = []
    for world, shape in ((2, {"data": 2}), (4, {"data": 2, "model": 2})):
        cfg["trainer"]["mesh_shape"] = shape
        path = _write(tmp_path / f"ce{world}.yaml", cfg)
        shas.append(_run(tmp_path, "train_ce", ["-config", path, "-data", data],
                         "model.0.npz", world, f"ranks{world}"))
    assert shas[0] == shas[1]
