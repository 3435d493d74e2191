"""CE training of the PyTorch port against the JAX trainer.

Same initial parameters (JAX init carried over by convert.py), same batches
(the loaders are identical, see test_torch_data.py), 5 steps under SGD,
momentum and Adam, in fp32 with dropout 0 and dither 0. The JAX side runs
its Pallas LSTM and fused fbank in interpret mode, the arithmetic the port's
kernels reproduce (bf16 recurrent products, fp32 everything else), so loss
and frame accuracy track to fp32 noise amplified over 5 updates. Also: the
optimizer pieces against optax, and params checkpoints both ways.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.data.dataloader import ChunkDataloader as JChunk
from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.ops.losses import ce_loss as jax_ce_loss, frame_accuracy as jax_frame_acc
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline
from pykaldi2_tpu.trainer import make_ce_train_step as jax_train_step
from pykaldi2_tpu.trainer import make_eval_step as jax_eval_step
from pykaldi2_tpu.utils import load_checkpoint as jax_load, save_checkpoint as jax_save
from pykaldi2_tpu.utils import make_optimizer as jax_make_optimizer
from pykaldi2_tpu.utils.lr import PlateauAnnealer as JAnnealer, set_lr_scale as jax_set_scale

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.convert import params_from_jax, params_to_jax
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.ops.losses import ce_loss, frame_accuracy
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.trainer import make_ce_train_step, make_eval_step
from pykaldi2_tpu_torch.utils import load_checkpoint, save_checkpoint
from pykaldi2_tpu_torch.utils.lr import (PlateauAnnealer, clip_by_global_norm,
                                         make_optimizer, set_lr_scale)

from toydata import make_toy_corpus
from torch_port_helpers import pallas_interpret, torch_batch  # noqa: F401

NUM_PDFS, HIDDEN, BATCH, CHUNK = 5, 128, 8, 24


def _feat_cfgs():
    kw = dict(frame_opts=dict(dither=0.0), mel_opts=dict(num_bins=24))
    return (C.FeatConfig(fbank=C.FbankOpts(frame_opts=C.FrameOpts(**kw["frame_opts"]),
                                           mel_opts=C.MelOpts(**kw["mel_opts"]))),
            JC.FeatConfig(fbank=JC.FbankOpts(frame_opts=JC.FrameOpts(**kw["frame_opts"]),
                                             mel_opts=JC.MelOpts(**kw["mel_opts"]))))


def _setup(tmp_path, layers=1):
    paths = make_toy_corpus(str(tmp_path), num_utts=6, num_pdfs=NUM_PDFS, seed=13)
    jds = JDataset(wav_scp=paths["wav_scp"], ali=paths["ali"],
                   frame_opts=JC.FrameOpts(dither=0.0))
    batches = list(JChunk(jds, batch_size=BATCH, chunk_len=CHUNK, shuffle=True, seed=2))
    ct, cj = _feat_cfgs()
    mk = dict(type="lstm", input_size=24, hidden_size=HIDDEN, num_layers=layers,
              output_size=NUM_PDFS, compute_dtype="float32")
    jm = jax_build_model(JC.ModelConfig(**mk))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    tm = build_model(C.ModelConfig(**mk))
    tm.load_state_dict(params_from_jax(params))
    return batches, (FeaturePipeline(ct), tm), (JaxPipeline(cj), jm, params)


@pytest.mark.parametrize("opt", [
    dict(type="sgd", lr=0.5, grad_clip=5.0),
    dict(type="momentum", lr=0.2, momentum=0.9, grad_clip=0.5),   # clip active
    dict(type="adam", lr=3e-3, grad_clip=5.0, weight_decay=1e-3),
])
def test_five_ce_steps_track_jax(tmp_path, pallas_interpret, opt):
    batches, (feat_t, tm), (feat_j, jm, params) = _setup(tmp_path)
    assert len(batches) >= 5
    jopt = jax_make_optimizer(JC.OptimizerConfig(**opt))
    jstep = jax_train_step(jm, feat_j, jopt, mesh=None, donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tstep = make_ce_train_step(tm, feat_t, make_optimizer(C.OptimizerConfig(**opt),
                                                          tm.parameters()))
    key = jax.random.PRNGKey(0)
    for i, b in enumerate(batches[:5]):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jp, jstate, jm_ = jstep(jp, jstate, jb, key)
        tm_ = tstep(torch_batch(b))
        # loss is computed before the update: step i differs only by the
        # drift of the i earlier updates
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(tm_["frame_acc"]), float(jm_["frame_acc"]), atol=1e-6)
        assert float(tm_["frames"]) == float(jm_["frames"])
    got = params_to_jax(tm.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jp)):
        b = np.asarray(b)
        if opt["type"] != "adam":
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=2e-5,
                                       err_msg=jax.tree_util.keystr(path))
            continue
        # Adam normalises each element's step to ~lr, so an element whose
        # gradient is only rounding noise (bf16 dWh) can move by up to lr
        # per step on either side: bound those by 5 * lr, and require all
        # but a few in 1e3 to agree to the SGD tolerance
        close = np.isclose(a, b, rtol=1e-3, atol=2e-5)
        assert close.mean() > 0.995, (jax.tree_util.keystr(path), close.mean())
        assert np.abs(a - b).max() <= 5 * opt["lr"], jax.tree_util.keystr(path)


def test_eval_step_matches_jax(tmp_path, pallas_interpret):
    batches, (feat_t, tm), (feat_j, jm, params) = _setup(tmp_path, layers=2)
    jeval = jax_eval_step(jm, feat_j)
    teval = make_eval_step(tm, feat_t)
    for b in batches[:2]:
        jn, jc, jcor = jeval(jax.tree.map(jnp.asarray, params),
                             {k: jnp.asarray(v) for k, v in b.items()})
        tn, tc, tcor = teval(torch_batch(b))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
        assert float(tc) == float(jc) and float(tcor) == float(jcor)


def test_ce_loss_and_accuracy_match_jax():
    rng = np.random.RandomState(14)
    logits = rng.randn(3, 7, 11).astype(np.float32) * 3
    labels = rng.randint(-1, 11, (3, 7)).astype(np.int32)
    mask = (labels >= 0).astype(np.float32)
    tl, tcnt = ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(mask))
    jl, jcnt = jax_ce_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tcnt) == float(jcnt)
    np.testing.assert_allclose(
        float(frame_accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                             torch.from_numpy(mask))),
        float(jax_frame_acc(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))),
        rtol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.RandomState(15)
    grads = [rng.randn(4, 5).astype(np.float32) * scale, rng.randn(7).astype(np.float32) * scale]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    tg = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm(tg, 1.0)
    for a, b in zip(tg, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("opt", [
    dict(type="sgd", lr=0.1, warmup_steps=3, weight_decay=0.01, grad_clip=1.0),
    dict(type="momentum", lr=0.1, momentum=0.8, warmup_steps=2),
    dict(type="adam", lr=0.01, weight_decay=0.02, grad_clip=0.3),
])
def test_optimizer_updates_match_optax(opt):
    """Warmup schedule, coupled weight decay, clip and lr_scale on a quadratic."""
    rng = np.random.RandomState(16)
    p0 = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    target = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
    jopt = jax_make_optimizer(JC.OptimizerConfig(**opt))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = make_optimizer(C.OptimizerConfig(**opt), list(tp.values()))
    for step in range(6):
        if step == 3:  # the plateau annealer halves the LR
            js = jax_set_scale(js, 0.5)
            set_lr_scale(topt, 0.5)
        grads = jax.grad(lambda p: sum(jnp.sum((p[k] - target[k]) ** 2) for k in p))(jp)
        upd, js = jopt.update(grads, js, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        sum(((tp[k] - torch.from_numpy(target[k])) ** 2).sum() for k in tp).backward()
        topt.step()
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


def test_plateau_annealer_matches_jax():
    a, b = PlateauAnnealer(0.5, 2), JAnnealer(0.5, 2)
    for loss in (3.0, 2.0, 2.5, 2.4, 2.6, 1.0, 1.5, 1.5):
        assert a.step(loss) == b.step(loss)
    assert a.state() == b.state()


def test_params_checkpoint_loads_in_both_packages(tmp_path):
    _, (_, tm), (_, jm, params) = _setup(tmp_path / "c", layers=2)
    # port → JAX
    p = str(tmp_path / "port.npz")
    save_checkpoint(p, tm, None, {"epoch": 0})
    template = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, params))
    loaded, opt_state, meta = jax_load(p, template)
    assert opt_state is None and meta == {"epoch": 0}
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # JAX → port (JAX checkpoint with its optax state next to the params)
    shifted = jax.tree.map(lambda x: x + 1.0, params)
    jopt = jax_make_optimizer(JC.OptimizerConfig(type="adam"))
    q = str(tmp_path / "jax.npz")
    jax_save(q, shifted, jopt.init(jax.tree.map(jnp.asarray, shifted)), {"epoch": 3})
    meta = load_checkpoint(q, tm)
    assert meta == {"epoch": 3}
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(params_to_jax(tm.state_dict())),
                                 jax.tree_util.tree_leaves_with_path(shifted)):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_checkpoint_resume_restores_optimizer(tmp_path):
    _, (feat_t, tm), _ = _setup(tmp_path / "c")
    cfg = C.OptimizerConfig(type="adam", lr=1e-3)
    opt = make_optimizer(cfg, tm.parameters())
    x = torch.randn(2, 5, 24)
    tm(x).sum().backward()
    opt.step()
    set_lr_scale(opt, 0.25)
    p = str(tmp_path / "r.npz")
    save_checkpoint(p, tm, opt, {"epoch": 1})
    with open(p + ".json") as f:
        assert json.load(f) == {"epoch": 1}
    tm2 = build_model(C.ModelConfig(type="lstm", input_size=24, hidden_size=HIDDEN,
                                    num_layers=1, output_size=NUM_PDFS))
    opt2 = make_optimizer(cfg, tm2.parameters())
    load_checkpoint(p, tm2, opt2)
    assert opt2.count == 1 and opt2.lr_scale == 0.25
    for a, b in zip(tm.state_dict().values(), tm2.state_dict().values()):
        assert torch.equal(a, b)
    s1, s2 = opt.base.state_dict()["state"], opt2.base.state_dict()["state"]
    assert s1.keys() == s2.keys()
    for i in s1:
        for k in s1[i]:
            assert torch.equal(torch.as_tensor(s1[i][k]), torch.as_tensor(s2[i][k]))
