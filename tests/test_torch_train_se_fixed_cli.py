"""``bin/train_se`` in fixed-denominator mode and ``bin/compute_priors`` of
the PyTorch port against the JAX CLIs, on the CPU (PK2_PLATFORM=cpu).

Both CLIs run from one seed model on the toy corpus, as tests/test_se.py
runs the JAX CLI, through each denominator route: the default structured
bigram graph (MMI, sMBR, MPFE with silence phones), ``-generic_den`` (the
dense state matrix), ``-den_graph`` above a lowered ``pack_graph_auto``
state cap (the block-sparse tiles) and ``-den_graph`` with a graph that
breaks the state-emission rule (the arc tables). The per-step objectives
agree to 1e-4 (the fp32 noise of a difference of row sums ~1e4 times
larger), the frame accuracies exactly; the checkpoints load in the JAX
package. ``compute_priors`` writes the same .npy as the JAX CLI.
"""

import functools
import json
import os

import numpy as np
import pytest
import yaml
import jax

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.bin.compute_priors import main as jax_priors_main
from pykaldi2_tpu.bin.train_se import main as jax_se_main
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.ops import fb_dense as JD
from pykaldi2_tpu.utils import load_checkpoint as jax_load

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.bin.compute_priors import main as priors_main
from pykaldi2_tpu_torch.bin.train_se import main
from pykaldi2_tpu_torch.convert import params_from_jax
from pykaldi2_tpu_torch.data import kaldi_io
from pykaldi2_tpu_torch.graph import (HmmTopology, TransitionModel, estimate_phone_bigram,
                                      make_den_graph)
from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.ops import fb_dense as TD
from pykaldi2_tpu_torch.ops.fsa import DenseFsa, save_fsa
from pykaldi2_tpu_torch.utils import save_checkpoint

from toydata import make_toy_corpus
from torch_port_helpers import pallas_interpret, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_PDFS = 4


def _setup(tmp_path):
    """Config, seed checkpoint, and the JAX model template."""
    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=6, num_pdfs=NUM_PDFS, seed=8)
    cfg = {
        "model": {"type": "lstm", "hidden_size": 16, "num_layers": 1,
                  "output_size": NUM_PDFS, "compute_dtype": "float32"},
        "optimizer": {"type": "momentum", "momentum": 0.9, "lr": 1e-3},
        "trainer": {"batch_size": 3, "num_epochs": 1, "log_interval": 1,
                    "acoustic_scale": 1.0, "ce_ratio": 0.1},
        "data": {"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
                 "feat": {"fbank": {"frame_opts": {"dither": 0.0},
                                    "mel_opts": {"num_bins": 24}}}},
    }
    cfg_path = str(tmp_path / "se.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    jm = jax_build_model(JC.ModelConfig(**{**cfg["model"], "input_size": 24}))
    template = jm.init(jax.random.PRNGKey(5))
    tm = build_model(C.ModelConfig(**{**cfg["model"], "input_size": 24}))
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, template)))
    seed = str(tmp_path / "seed.npz")
    save_checkpoint(seed, tm)
    return cfg_path, paths, seed, template


def _den_graph(paths, broken: bool):
    """The alignment phone-LM den graph of the CI 1-state model; ``broken``
    adds an arc whose pdf differs from its destination's (state-emission
    rule broken)."""
    tm = TransitionModel(HmmTopology.one_state(range(1, NUM_PDFS + 1)))
    p2p = np.arange(1, NUM_PDFS + 1)
    seqs = [collapse_to_phones(p2p[lab]) for _, lab in kaldi_io.read_ark(paths["ali"], "ivec")]
    den = make_den_graph(tm, estimate_phone_bigram(seqs, tm.topo.phones))
    if broken:
        e = 1
        other = (int(den.pdf[e]) + 1) % NUM_PDFS
        den = DenseFsa(den.num_states, np.append(den.src, den.src[e]),
                       np.append(den.dst, den.dst[e]), np.append(den.pdf, other).astype(np.int32),
                       np.append(den.weight, -3.0).astype(np.float32), den.final, den.start,
                       np.append(den.phone, other + 1).astype(np.int32))
        assert TD.state_emission_pdfs(den) is None
    return den


def _steps(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "step" in r]


ROUTES = {  # extra CLI arguments, criterion, den graph (None / "block" / "arc")
    "bigram-mmi": ([], "mmi", None),
    "bigram-smbr": ([], "smbr", None),
    "bigram-mpfe-silence": (["-silence_phones", "1"], "mpfe", None),
    "dense-mmi": (["-generic_den"], "mmi", None),
    "block-mmi": ([], "mmi", "block"),
    "block-smbr": ([], "smbr", "block"),
    "arc-mmi": ([], "mmi", "arc"),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_train_se_fixed_den_cli_tracks_jax_cli(tmp_path, pallas_interpret, monkeypatch, route):
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    extra, crit, den_kind = ROUTES[route]
    cfg_path, paths, seed, template = _setup(tmp_path)
    if den_kind is not None:
        den_path = str(tmp_path / "den.npz")
        save_fsa(den_path, _den_graph(paths, broken=den_kind == "arc"))
        extra = extra + ["-den_graph", den_path]
        # the toy graph has 5 states: a lowered cap sends it past the dense route
        for mod in (JD, TD):
            monkeypatch.setattr(mod, "pack_graph_auto",
                                functools.partial(mod.pack_graph_auto, max_states=2))
    argv = ["-config", cfg_path, "-criterion", crit, "-seed_model", seed, *extra]
    assert jax_se_main(argv + ["-exp_dir", str(tmp_path / "jax"), "-single_device"]) == 0
    assert main(argv + ["-exp_dir", str(tmp_path / "port")]) == 0
    jr, tr = _steps(str(tmp_path / "jax")), _steps(str(tmp_path / "port"))
    assert len(jr) == len(tr) == 2
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a["objective"], b["objective"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["frame_acc"], b["frame_acc"], atol=1e-6)
        assert a["t_len"] > 0 and a["train_ms"] > 0
    loaded, _opt, meta = jax_load(str(tmp_path / "port" / "model.0.npz"), template)
    assert meta["epoch"] == 0
    assert all(np.all(np.isfinite(np.asarray(x))) for x in jax.tree.leaves(loaded))


def test_train_se_fixed_den_logs_its_route(tmp_path, monkeypatch, caplog):
    """Which packing each route produced, as the log names it."""
    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    cfg_path, paths, seed, _ = _setup(tmp_path)
    den_path = str(tmp_path / "den.npz")
    save_fsa(den_path, _den_graph(paths, broken=False))
    monkeypatch.setattr(TD, "pack_graph_auto",
                        functools.partial(TD.pack_graph_auto, max_states=2))
    for extra, want in (([], "structured bigram"), (["-generic_den"], "BlockSparseGraph"),
                        (["-den_graph", den_path], "BlockSparseGraph")):
        caplog.clear()
        assert main(["-config", cfg_path, "-seed_model", seed, "-exp_dir",
                     str(tmp_path / want.replace(" ", "_") / str(len(extra))), *extra]) == 0
        assert want in caplog.text


def test_compute_priors_cli_equals_jax(tmp_path):
    rng = np.random.RandomState(21)
    ali = str(tmp_path / "ali.ark")
    with kaldi_io.ArkWriter(ali, kind="ivec") as w:
        for i in range(5):
            w.write(f"u{i}", rng.randint(0, 4, 30).astype(np.int32))
    for extra in ([], ["-num_pdfs", "7", "-floor", "1e-6"]):
        got, want = str(tmp_path / "port.npy"), str(tmp_path / "jax.npy")
        assert priors_main(["-ali", ali, "-out", got, *extra]) == 0
        assert jax_priors_main(["-ali", ali, "-out", want, *extra]) == 0
        np.testing.assert_array_equal(np.load(got), np.load(want))
    # transition-id alignments mapped through final.mdl
    tm = TransitionModel(HmmTopology.three_state([1, 2, 3]))
    mdl = str(tmp_path / "final.mdl")
    tm.write_kaldi(mdl)
    tali = str(tmp_path / "tali.ark")
    with kaldi_io.ArkWriter(tali, kind="ivec") as w:
        for i in range(4):
            w.write(f"u{i}", rng.randint(1, tm.num_tids + 1, 40).astype(np.int32))
    got, want = str(tmp_path / "tport.npy"), str(tmp_path / "tjax.npy")
    assert priors_main(["-ali", tali, "-out", got, "-model", mdl]) == 0
    assert jax_priors_main(["-ali", tali, "-out", want, "-model", mdl]) == 0
    assert np.load(got).shape == (tm.num_pdfs,)
    np.testing.assert_array_equal(np.load(got), np.load(want))
