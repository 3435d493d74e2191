"""Fixed-denominator sequence training of the PyTorch port against the JAX
package: ``trainer.make_se_train_step`` on each denominator route.

3 train steps per route (structured bigram, dense state matrix, block-sparse
tiles, arc tables) and criterion (MMI, sMBR, MPFE) on one fixed batch, from
the same initial parameters (carried over by convert.py), in fp32 with
dropout 0 and dither 0. The JAX side runs its Pallas LSTM and fbank in
interpret mode and its default packings (the block route with its dense
band); the port's block route runs K11's plain version on its one tile list.
Objective and frame accuracy track per step (rtol 1e-4, the fp32 noise of a
difference of row sums), parameters after 3 momentum updates (rtol 1e-3,
atol 2e-5, as tests/test_torch_train_se.py holds the lattice path).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.data.dataloader import BucketSpec as JBucket, SeqDataloader as JSeq
from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
from pykaldi2_tpu.graph import (HmmTopology as JTopo, TransitionModel as JTM,
                                estimate_phone_bigram as jax_bigram, make_den_graph as jax_den)
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.ops import fb as JF, fb_bigram as JBG, fb_block as JBL, fb_dense as JD
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline
from pykaldi2_tpu.trainer import make_se_train_step as jax_se_step
from pykaldi2_tpu.utils import make_optimizer as jax_make_optimizer

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.convert import params_from_jax, params_to_jax
from pykaldi2_tpu_torch.graph import (HmmTopology, TransitionModel, estimate_phone_bigram,
                                      make_den_graph)
from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones
from pykaldi2_tpu_torch.models import build_model
from pykaldi2_tpu_torch.ops import fb as TF, fb_bigram as TBG, fb_block as TBL, fb_dense as TD
from pykaldi2_tpu_torch.pipeline import FeaturePipeline
from pykaldi2_tpu_torch.trainer import make_se_train_step
from pykaldi2_tpu_torch.utils import make_optimizer

from toydata import make_toy_corpus
from torch_port_helpers import pallas_interpret, torch_batch, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PHONES, HIDDEN, BATCH, T_MAX = [1, 2, 3, 4, 5], 32, 3, 80
OPT = dict(type="momentum", lr=0.05, momentum=0.9, grad_clip=5.0)

ROUTES = {
    "bigram": (lambda tm, lm, den: JBG.make_bigram_den(tm, lm),
               lambda tm, lm, den: TBG.make_bigram_den(tm, lm)),
    "dense": (lambda tm, lm, den: JD.pack_graph_dense(den),
              lambda tm, lm, den: TD.pack_graph_dense(den)),
    "block": (lambda tm, lm, den: JBL.pack_graph_blocks(den, block=8, seg_len=4),
              lambda tm, lm, den: TBL.pack_graph_blocks(den, block=8, seg_len=4)),
    "arc": (lambda tm, lm, den: JF.pack_graph(den), lambda tm, lm, den: TF.pack_graph(den)),
}


def make_optimizer_for(model):
    return make_optimizer(C.OptimizerConfig(**OPT), model.parameters())


def _feat_cfgs():
    fo, mo = dict(dither=0.0), dict(num_bins=24)
    return (C.FeatConfig(fbank=C.FbankOpts(frame_opts=C.FrameOpts(**fo), mel_opts=C.MelOpts(**mo))),
            JC.FeatConfig(fbank=JC.FbankOpts(frame_opts=JC.FrameOpts(**fo),
                                             mel_opts=JC.MelOpts(**mo))))


@pytest.mark.parametrize("criterion", ["mmi", "smbr", "mpfe"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_three_fixed_den_steps_track_jax(tmp_path, pallas_interpret, route, criterion):
    jtm, ttm = JTM(JTopo.one_state(PHONES)), TransitionModel(HmmTopology.one_state(PHONES))
    paths = make_toy_corpus(str(tmp_path), num_utts=3, num_pdfs=jtm.num_pdfs, min_sec=0.5,
                            max_sec=0.8, seed=21)
    jds = JDataset(wav_scp=paths["wav_scp"], ali=paths["ali"],
                   frame_opts=JC.FrameOpts(dither=0.0))
    batch = next(iter(JSeq(jds, JBucket(boundaries=(T_MAX,), batch_sizes=BATCH),
                           shuffle=False)))
    batch.pop("utt_ids")
    p2p = np.zeros(jtm.num_pdfs, np.int32)
    for (p, _j, pdf) in jtm.tuples:
        p2p[pdf] = p
    seqs = [collapse_to_phones(p2p[lab]) for lab in jds.labels.values()]
    jlm, tlm = jax_bigram(seqs, PHONES), estimate_phone_bigram(seqs, PHONES)
    jmake, tmake = ROUTES[route]
    jg = jmake(jtm, jlm, jax_den(jtm, jlm))
    tg = tmake(ttm, tlm, make_den_graph(ttm, tlm))
    ct, cj = _feat_cfgs()
    mk = dict(type="lstm", input_size=24, hidden_size=HIDDEN, num_layers=1,
              output_size=jtm.num_pdfs, compute_dtype="float32")
    jm = jax_build_model(JC.ModelConfig(**mk))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tm = build_model(C.ModelConfig(**mk))
    tm.load_state_dict(params_from_jax(params))
    log_prior = np.log(np.full(jtm.num_pdfs, 1.0 / jtm.num_pdfs, np.float32)) + np.linspace(
        -0.2, 0.2, jtm.num_pdfs).astype(np.float32)
    kw = dict(log_prior=log_prior, acoustic_scale=0.5, ce_ratio=0.1, pdf_to_phone=p2p)
    jopt = jax_make_optimizer(JC.OptimizerConfig(**OPT))
    jstep = jax_se_step(jm, JaxPipeline(cj), jopt, jg, criterion, None, **kw)
    tstep = make_se_train_step(tm, FeaturePipeline(ct),
                               make_optimizer_for(tm), tg, criterion, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = torch_batch(batch)
    for _ in range(3):
        jp, jstate, jm_ = jstep(jp, jstate, jb, jax.random.PRNGKey(0))
        tm_ = tstep(tb)
        np.testing.assert_allclose(float(tm_["objective"]), float(jm_["objective"]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tm_["frame_acc"]), float(jm_["frame_acc"]), atol=1e-6)
        np.testing.assert_allclose(float(tm_["ce"]), float(jm_["ce"]), rtol=1e-4)
        assert float(tm_["frames"]) == float(jm_["frames"])
    got = params_to_jax(tm.state_dict())
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_se_step_rejects_bad_criterion_and_mpfe_without_phones():
    tm = build_model(C.ModelConfig(type="lstm", input_size=24, hidden_size=8, num_layers=1,
                                   output_size=5, compute_dtype="float32"))
    g = TBG.make_bigram_den(TransitionModel(HmmTopology.one_state(PHONES)),
                            estimate_phone_bigram([[1, 2, 3]], PHONES))
    with pytest.raises(ValueError, match="unknown criterion"):
        make_se_train_step(tm, FeaturePipeline(_feat_cfgs()[0]), make_optimizer_for(tm), g,
                           "ctc")
    with pytest.raises(ValueError, match="pdf_to_phone"):
        make_se_train_step(tm, FeaturePipeline(_feat_cfgs()[0]), make_optimizer_for(tm), g,
                           "mpe")
