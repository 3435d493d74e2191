"""Data simulation of the PyTorch port against pykaldi2_tpu.simulation.

Host side (numpy copies, so the same ``RandomState`` seeds give equal
outputs bit for bit): resampling, RIRs, isotropic noise, FFT convolution,
SNR mixing, the ``Simulator`` with and without labels and mic arrays, the
loaders' batches with the recipe's simulation block, and
``DeviceSimulator.batch_extras``. Device side: ``apply_simulation`` takes
the draws the JAX ``simulate_batch`` makes from a key and must give its
output within ``SIM_TOL`` of ``max|wave|``; the on-device
``FeaturePipeline`` likewise. Then the recipe's CLIs (run.sh stages 1-3)
with examples/librispeech/data.yaml's simulation block on the CPU, host-side
and on the device. Cases follow tests/test_simulation.py.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.data.dataloader import BucketSpec as JBucketSpec
from pykaldi2_tpu.data.dataloader import ChunkDataloader as JChunk
from pykaldi2_tpu.data.dataloader import SeqDataloader as JSeq
from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
from pykaldi2_tpu.pipeline import FeaturePipeline as JPipe
from pykaldi2_tpu.simulation import device as jdevice
from pykaldi2_tpu.simulation import iso_noise as jiso
from pykaldi2_tpu.simulation import resample as jres
from pykaldi2_tpu.simulation import rir as jrir
from pykaldi2_tpu.simulation import simulator as jsim

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch import pipeline as P
from pykaldi2_tpu_torch.data.dataloader import BucketSpec, ChunkDataloader, SeqDataloader
from pykaldi2_tpu_torch.data.dataset import SpeechDataset
from pykaldi2_tpu_torch.data.wav import write_wav
from pykaldi2_tpu_torch.simulation import device as pdevice
from pykaldi2_tpu_torch.simulation import iso_noise as piso
from pykaldi2_tpu_torch.simulation import resample as pres
from pykaldi2_tpu_torch.simulation import rir as prir
from pykaldi2_tpu_torch.simulation import simulator as psim

from toydata import make_toy_corpus
from torch_port_helpers import to_np, torch_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
RECIPE = ROOT / "examples" / "librispeech" / "data.yaml"
# apply_simulation vs simulate_batch: float32 FFTs of two libraries (pocketfft
# in torch, ducc in XLA) over a [B, 2^k] batch, then the same elementwise
# mixing: each output within 1e-5 of the batch's max|wave| (measured <= 3e-7)
SIM_TOL = 1e-5
# log-mel features of those waves: the FFT difference plus the two front
# ends' fp32 GEMM order (test_torch_frontend.py's LOGMEL_TOL)
FEAT_TOL = dict(rtol=1e-4, atol=1e-3)


def recipe_block() -> dict:
    """The recipe's simulation block, verbatim."""
    with open(RECIPE) as f:
        return yaml.safe_load(f)["simulation"]


def sim_cfgs(block: dict):
    """(JAX, port) SimulationConfigs from one raw block."""
    return JC._build(JC.SimulationConfig, block), C._build(C.SimulationConfig, block)


def same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("factor", [0.9, 1.0, 1.1])
def test_resample_and_labels_match(factor):
    rng = np.random.RandomState(3)
    wave = (rng.randn(16000) * 2000).astype(np.float32)
    same(pres.resample(wave, factor), jres.resample(wave, factor))
    labels = rng.randint(0, 9, 98)
    n_out = int(98 / factor)
    same(pres.speed_perturb_labels(labels, factor, n_out),
         jres.speed_perturb_labels(labels, factor, n_out))


@pytest.mark.parametrize("num_mics", [1, 3])
def test_room_rirs_match(num_mics):
    for seed in range(3):
        same(prir.sample_room_rir(np.random.RandomState(seed), num_mics=num_mics),
             jrir.sample_room_rir(np.random.RandomState(seed), num_mics=num_mics))
    mics = np.array([[3.0, 2.0, 1.5], [3.05, 2.0, 1.5]])[:num_mics]
    args = ([5.0, 4.0, 3.0], [1.0, 2.0, 1.5], mics, 0.3)
    same(prir.image_source_rir(*args), jrir.image_source_rir(*args))
    assert prir.t60_to_reflectivity([5, 4, 3], 0.4) == jrir.t60_to_reflectivity([5, 4, 3], 0.4)


@pytest.mark.parametrize("mics", [[[0.0, 0, 0]], [[0.0, 0, 0], [0.01, 0, 0], [2.0, 0, 0]]])
def test_isotropic_noise_matches(mics):
    mics = np.array(mics)
    same(piso.isotropic_noise(mics, 8000, 16000.0, np.random.RandomState(7)),
         jiso.isotropic_noise(mics, 8000, 16000.0, np.random.RandomState(7)))
    freqs = np.linspace(0, 8000, 5)
    same(piso.diffuse_coherence(mics, freqs), jiso.diffuse_coherence(mics, freqs))


def test_fft_convolve_and_mix_at_snr_match():
    rng = np.random.RandomState(1)
    wave = (rng.randn(5000) * 1000).astype(np.float32)
    rir = (rng.randn(640) * np.exp(-np.arange(640) / 100)).astype(np.float32)
    same(psim.fft_convolve(wave, rir), jsim.fft_convolve(wave, rir))
    for noise_len in (5000, 1234):  # a short noise is tiled
        noise = rng.randn(noise_len).astype(np.float32)
        same(psim.mix_at_snr(wave, noise, 7.5), jsim.mix_at_snr(wave, noise, 7.5))


def _wav_list(tmp_path, name, n, length, seed):
    rng = np.random.RandomState(seed)
    lst = tmp_path / f"{name}.list"
    with open(lst, "w") as f:
        for i in range(n):
            p = tmp_path / f"{name}{i}.wav"
            write_wav(str(p), (rng.randn(length) * 0.1 * np.exp(-np.arange(length) / 900)
                               ).astype(np.float32))
            f.write(f"{p}\n")
    return str(lst)


@pytest.mark.parametrize("case", ["recipe", "recipe_no_labels", "lists", "mics_one",
                                  "mics_all"])
def test_simulator_matches(tmp_path, case):
    """Simulator waves and speed-perturbed labels, bit for bit, over seeds."""
    block = recipe_block()
    kw = {}
    if case == "lists":
        block["reverb"]["rir_list"] = _wav_list(tmp_path, "rir", 3, 2000, 1)
        block["noise"]["noise_list"] = _wav_list(tmp_path, "noise", 2, 9000, 2)
    if case.startswith("mics"):
        kw = dict(num_channels=3, output_channel=1 if case == "mics_one" else None)
    jcfg, pcfg = sim_cfgs(block)
    js, ps = jsim.Simulator(jcfg, **kw), psim.Simulator(pcfg, **kw)
    rng = np.random.RandomState(5)
    wave = (rng.randn(12000) * 2000).astype(np.float32)
    labels = None if case == "recipe_no_labels" else rng.randint(0, 7, 73).astype(np.int32)
    for seed in range(6):
        got = ps.simulate_with_labels(wave, labels, np.random.RandomState(seed))
        want = js.simulate_with_labels(wave, labels, np.random.RandomState(seed))
        same(got, want)
    same(ps(wave), js(wave))  # no rng: the config's seed


@pytest.fixture
def recipe_corpus(tmp_path):
    paths = make_toy_corpus(str(tmp_path / "c"), num_utts=6, num_pdfs=4, seed=9)
    raw = {"wav_scp": paths["wav_scp"], "label_ark": paths["ali"],
           "feat": {"fbank": {"frame_opts": {"dither": 0.0}, "mel_opts": {"num_bins": 24}}},
           "simulation": recipe_block()}
    return paths, raw


@pytest.mark.parametrize("loader", ["chunk", "chunk_workers", "seq_workers"])
def test_loader_batches_with_recipe_simulation_match(recipe_corpus, loader):
    """SpeechDataset.from_config builds each package's Simulator; the
    loaders yield the same batches, also with worker threads."""
    _, raw = recipe_corpus
    jds = JDataset.from_config(JC._build(JC.DataConfig, raw))
    pds = SpeechDataset.from_config(C._build(C.DataConfig, raw))
    assert isinstance(pds.simulate_fn, psim.Simulator)
    workers = 2 if loader.endswith("workers") else 0
    if loader.startswith("chunk"):
        kw = dict(batch_size=3, chunk_len=40, shuffle=True, seed=5, num_workers=workers)
        jl, pl = JChunk(jds, **kw), ChunkDataloader(pds, **kw)
    else:
        kw = dict(shuffle=True, seed=2, num_workers=workers)
        jl = JSeq(jds, JBucketSpec(boundaries=(150, 300), batch_sizes=2), **kw)
        pl = SeqDataloader(pds, BucketSpec(boundaries=(150, 300), batch_sizes=2), **kw)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        a, b = list(pl), list(jl)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            for k in x:
                same(x[k], y[k])


def test_device_simulator_extras_match():
    jcfg, pcfg = sim_cfgs(recipe_block())
    jd, pd = jdevice.DeviceSimulator(jcfg), pdevice.DeviceSimulator(pcfg)
    uids = ["utt000", "utt001", "", "utt007"]  # "" is a padding row
    for n in (3000, 9000):
        got, want = pd.batch_extras(uids, n), jd.batch_extras(uids, n)
        assert sorted(got) == sorted(want) == ["sim_noise", "sim_rir"]
        assert got["sim_rir"].shape == (4, 8000) and got["sim_noise"].shape == (4, n)
        for k in got:
            same(got[k], want[k])
    with pytest.raises(ValueError, match="sample length"):
        pd.batch_extras(uids)


def jax_draws(key, b, cfg):
    """The draws simulate_batch makes from ``key`` (device.py:119-131)."""
    k1, k2, k3, _k4, _k5 = jax.random.split(key, 5)
    gate = lambda k, p: np.asarray(jax.random.bernoulli(k, p, (b, 1)), np.float32)[:, 0]
    snr = np.asarray(jax.random.uniform(k2, (b,), minval=cfg.noise.snr_range[0],
                                        maxval=cfg.noise.snr_range[1]))
    gain = np.asarray(jax.random.uniform(_k4, (b,), minval=cfg.perturb.gain_range[0],
                                         maxval=cfg.perturb.gain_range[1]))
    return [torch.tensor(x) for x in (gate(k1, cfg.reverb.prob), snr,
                                          gate(k3, cfg.noise.prob), gain)]


@pytest.mark.parametrize("probs,masked", [((0.4, 0.5), True), ((1.0, 1.0), False),
                                          ((1.0, 0.0), True)])
def test_apply_simulation_matches_jax_simulate_batch(probs, masked):
    block = recipe_block()
    block["reverb"]["prob"], block["noise"]["prob"] = probs
    jcfg, _ = sim_cfgs(block)
    rng = np.random.RandomState(11)
    b, n = 6, 4000
    waves = (rng.randn(b, n) * 1500).astype(np.float32)
    extras = jdevice.DeviceSimulator(jcfg).batch_extras([f"u{i}" for i in range(b)], n)
    mask = None
    if masked:
        mask = np.ones((b, n), np.float32)
        mask[1, 2500:] = 0.0
        mask[4, 100:] = 0.0
    key = jax.random.PRNGKey(3)
    want = np.asarray(jdevice.simulate_batch(
        jnp.asarray(waves), key, rirs=jnp.asarray(extras["sim_rir"]),
        noises=jnp.asarray(extras["sim_noise"]), snr_range=tuple(jcfg.noise.snr_range),
        gain_range=tuple(jcfg.perturb.gain_range), reverb_prob=jcfg.reverb.prob,
        noise_prob=jcfg.noise.prob, sample_mask=None if mask is None else jnp.asarray(mask)))
    draws = jax_draws(key, b, jcfg)
    got = to_np(pdevice.apply_simulation(
        torch.from_numpy(waves), torch.from_numpy(extras["sim_rir"]),
        torch.from_numpy(extras["sim_noise"]), *draws,
        None if mask is None else torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=SIM_TOL * np.abs(want).max())
    assert not np.allclose(got, waves)


def test_draw_simulation_order_and_switches():
    """The draws come from the generator in the documented order; a
    distortion that is off draws nothing."""
    _, pcfg = sim_cfgs(recipe_block())
    rg, sn, ng, ga = pdevice.draw_simulation(torch.Generator().manual_seed(4), 500, pcfg)
    u = torch.rand(4, 500, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(rg, (u[0] < 0.4).float())
    torch.testing.assert_close(sn, 20.0 * u[1])
    torch.testing.assert_close(ng, (u[2] < 0.5).float())
    torch.testing.assert_close(ga, -10.0 + 15.0 * u[3])
    assert 0.3 < float(rg.mean()) < 0.5 and 0.4 < float(ng.mean()) < 0.6
    pcfg.reverb.use_reverb = pcfg.perturb.use_gain = False
    rg, sn, ng, ga = pdevice.draw_simulation(torch.Generator().manual_seed(4), 500, pcfg)
    assert rg is None and ga is None
    torch.testing.assert_close(sn, 20.0 * u[0])


def test_on_device_pipeline_features_match_jax(monkeypatch):
    """The port's FeaturePipeline(device_sim_cfg=...) against the
    reference's on the same batch, with the reference's draws fed to the
    port; eval copies never simulate."""
    block = dict(recipe_block(), on_device=True)
    block["reverb"]["prob"], block["noise"]["prob"] = 0.5, 0.5
    jcfg, pcfg = sim_cfgs(block)
    feat = {"fbank": {"frame_opts": {"dither": 0.0}, "mel_opts": {"num_bins": 24}}}
    jfeat, pfeat = JC._build(JC.FeatConfig, feat), C._build(C.FeatConfig, feat)
    rng = np.random.RandomState(0)
    b, s = 4, 6000
    t = 36
    mask = np.ones((b, t), np.float32)
    mask[2, 20:] = 0.0
    batch = {"wave": (rng.randn(b, s) * 1000).astype(np.float32), "mask": mask}
    batch.update(jdevice.DeviceSimulator(jcfg).batch_extras(["a", "b", "c", "d"], s))
    key = jax.random.PRNGKey(2)
    jpipe = JPipe(jfeat, device_sim_cfg=jcfg)
    want = np.asarray(jpipe({k: jnp.asarray(v) for k, v in batch.items()}, dither_key=key))
    draws = jax_draws(jax.random.fold_in(key, 7), b, jcfg)
    monkeypatch.setattr(P, "draw_simulation", lambda gen, n, cfg: draws)
    ppipe = P.FeaturePipeline(pfeat, device_sim_cfg=pcfg)
    tb = torch_batch(batch)
    got = to_np(ppipe(tb, generator=torch.Generator()))
    np.testing.assert_allclose(got, want, **FEAT_TOL)
    clean = to_np(P.FeaturePipeline(pfeat)(tb))
    assert np.abs(got - clean).max() > 0.1
    np.testing.assert_array_equal(to_np(ppipe.for_eval()(tb, generator=torch.Generator())),
                                  clean)
    np.testing.assert_array_equal(to_np(ppipe(tb)), clean)  # no generator: no simulation


def _write_cli_files(tmp_path, raw, on_device):
    raw = json.loads(json.dumps(raw))
    raw["simulation"]["on_device"] = on_device
    model = {"type": "lstm", "hidden_size": 16, "num_layers": 1, "output_size": 4,
             "compute_dtype": "float32", "dropout": 0.0}
    cfg = {"model": model, "optimizer": {"type": "adam", "lr": 0.01},
           "trainer": {"batch_size": 3, "chunk_len": 40, "num_epochs": 1, "log_interval": 1,
                       "seed": 4, "acoustic_scale": 1.0}}
    dp, cp = str(tmp_path / "data.yaml"), str(tmp_path / "exp.yaml")
    with open(dp, "w") as f:
        yaml.safe_dump(raw, f)
    with open(cp, "w") as f:
        yaml.safe_dump(cfg, f)
    return dp, cp, model


def _records(exp, key):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [r[key] for r in map(json.loads, f) if "step" in r]


@pytest.mark.parametrize("on_device", [False, True])
def test_recipe_simulation_block_runs_stages_1_to_3(recipe_corpus, tmp_path, monkeypatch,
                                                   on_device):
    """compute_cmvn_stats, train_ce and train_se (run.sh stages 1-3) with
    data.yaml's simulation block: host-side, the port tracks the JAX CLIs
    (stats and CE losses from one seed checkpoint); on the device, the CE
    and SE steps run on distorted audio and stay finite."""
    from pykaldi2_tpu.bin.compute_cmvn_stats import main as jax_cmvn
    from pykaldi2_tpu.bin.train_ce import main as jax_ce
    from pykaldi2_tpu.models import build_model as jax_build_model
    from pykaldi2_tpu.pipeline import load_cmvn_stats
    from pykaldi2_tpu.utils import save_checkpoint as jax_save

    from pykaldi2_tpu_torch.bin.compute_cmvn_stats import main as cmvn
    from pykaldi2_tpu_torch.bin.train_ce import main as ce
    from pykaldi2_tpu_torch.bin.train_se import main as se

    monkeypatch.setenv("PK2_PLATFORM", "cpu")
    _, raw = recipe_corpus
    dp, cp, model = _write_cli_files(tmp_path, raw, on_device)
    stats = {}
    for name, fn in (("jax", jax_cmvn), ("port", cmvn)):
        out = str(tmp_path / f"{name}.cmvn")
        assert fn(["-data", dp, "-output", out]) == 0
        stats[name] = load_cmvn_stats(out)
    np.testing.assert_allclose(stats["port"], stats["jax"], rtol=1e-4)

    params = jax_build_model(JC.ModelConfig(input_size=24, **model)).init(jax.random.PRNGKey(9))
    seed_ckpt = str(tmp_path / "seed.npz")
    jax_save(seed_ckpt, params)
    losses = {}
    runs = (("jax", jax_ce), ("port", ce)) if not on_device else (("port", ce),)
    for name, fn in runs:
        exp = str(tmp_path / f"ce_{name}")
        assert fn(["-config", cp, "-data", dp, "-exp_dir", exp, "-seed_model", seed_ckpt,
                   "-single_device"]) == 0
        losses[name] = _records(exp, "loss")
    assert len(losses["port"]) >= 2 and np.isfinite(losses["port"]).all()
    if not on_device:
        np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    exp = str(tmp_path / "se")
    assert se(["-config", cp, "-data", dp, "-exp_dir", exp, "-criterion", "mmi",
               "-seed_model", os.path.join(str(tmp_path / "ce_port"), "model.0.npz")]) == 0
    objs = _records(exp, "objective")
    assert len(objs) >= 1 and np.isfinite(objs).all()
