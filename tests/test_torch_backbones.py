"""The port's TDNN and Transformer backbones against the JAX package on the CPU.

The same parameters (a JAX ``init`` carried across by ``convert.params_from_jax``)
and the same numpy inputs, with a padding mask, go through
``pykaldi2_tpu.models.build_model(...).apply`` and the port's ``NnetAM``:
logits and the gradients of a masked weighted sum against ``jax.grad``, in
fp32 (summation order only: 2e-5) and bf16 (``BF16_TOL``, stated below).
The JAX TDNN has no bf16 gradient (``jax.grad`` of its convolution with
``preferred_element_type=float32`` on bf16 operands raises in the transpose
rule), so the port's bf16 TDNN gradients are held to JAX's fp32 ones at the
bf16 bound.
Checkpoints of either package load in the other. Both backbones train
through the port's CE step with falling loss, as
tests/test_cli_tools.py::test_tdnn_and_transformer_training checks the JAX
package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.models import build_model as jax_build_model

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.convert import params_from_jax, params_to_jax
from pykaldi2_tpu_torch.models import build_model

from torch_port_helpers import to_np

B, T, D, OUT = 3, 13, 12, 7
LENS = (13, 9, 5)
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16: both sides round the same operands to bf16 and sum in fp32, but in
# other orders, and the port's backward rounds the incoming fp32 cotangent to
# bf16 where JAX keeps it fp32 (ops/lstm_cuda.MatmulBf16): a bf16 rounding
# (2^-8 relative) that flips carries ~4e-3 of a value through the next
# products; gradients relative to the largest entry of their tensor (the
# Transformer's reach 0.85e-2). The forwards agree to 2.4e-7.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_GRAD_REL = 2e-2
# the bf16 TDNN's gradients against JAX's fp32 ones: every product's operands
# rounded to bf16 or not, through three layer norms at width 16, differ by up
# to 9.1e-2 of the tensor's largest entry (layer 1's w)
TDNN_BF16_VS_FP32 = 0.15

CASES = {
    "tdnn": dict(type="tdnn", hidden_size=16, tdnn_dilations=(1, 2, 3), tdnn_kernel=3),
    "tdnn_k5": dict(type="tdnn", hidden_size=16, tdnn_dilations=(1, 3), tdnn_kernel=5),
    "transformer": dict(type="transformer", hidden_size=16, num_layers=2, num_heads=4,
                        ffn_size=24),
}


def _models(case, dtype, seed=0):
    kw = dict(CASES[case], input_size=D, output_size=OUT, compute_dtype=dtype)
    jm = jax_build_model(JC.ModelConfig(**kw))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    tm = build_model(C.ModelConfig(**kw))
    tm.load_state_dict(params_from_jax(params))
    return jm, params, tm


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, D).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.asarray(LENS)[:, None]).astype(np.float32)
    cot = rng.randn(B, T, OUT).astype(np.float32)
    return x, mask, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case, dtype):
    jm, params, tm = _models(case, dtype)
    x, mask, cot = _inputs()

    def jloss(p, xx):
        y = jm.apply(p, xx, jnp.asarray(mask))
        return jnp.sum(y * cot * mask[..., None]), y

    jp, jx = jax.tree.map(jnp.asarray, params), jnp.asarray(x)
    jy = jm.apply(jp, jx, jnp.asarray(mask))
    if CASES[case]["type"] == "tdnn" and dtype == "bfloat16":
        jm = _models(case, "float32")[0]
    jg, jgx = jax.grad(lambda p, xx: jloss(p, xx)[0], argnums=(0, 1))(jp, jx)
    xt = torch.tensor(x, requires_grad=True)
    ty = tm(xt, torch.from_numpy(mask))
    (ty * torch.from_numpy(cot) * torch.from_numpy(mask)[..., None]).sum().backward()
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    assert ty.shape == (B, T, OUT) and ty.dtype == torch.float32
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), **tol)
    grads = {name: p.grad for name, p in tm.named_parameters()}
    want = params_from_jax(jax.tree.map(np.asarray, jg))
    assert sorted(grads) == sorted(want)
    pairs = [(name, to_np(grads[name]), want[name].numpy()) for name in sorted(want)]
    pairs.append(("x", to_np(xt.grad), np.asarray(jgx)))
    bound = BF16_GRAD_REL
    if CASES[case]["type"] == "tdnn" and dtype == "bfloat16":
        bound = TDNN_BF16_VS_FP32
    for name, got, ref in pairs:
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6)
            assert err < bound, (name, err)


@pytest.mark.parametrize("case", ["tdnn", "transformer"])
def test_params_round_trip_and_padding_does_not_leak(case):
    """params_to_jax gives back the JAX tree exactly, and the logits of valid
    frames do not change when the padded frames' features do."""
    _jm, params, tm = _models(case, "float32", seed=3)
    back = params_to_jax(tm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    x, mask, _ = _inputs(2)
    x2 = x.copy()
    x2[mask == 0] = 100.0
    with torch.no_grad():
        y1 = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        y2 = tm(torch.from_numpy(x2), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(y1[mask > 0], y2[mask > 0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["tdnn", "transformer"])
def test_checkpoints_load_across_packages(tmp_path, case):
    """A checkpoint the JAX package writes loads in the port, and the
    port's loads in the JAX package, with every parameter equal."""
    from pykaldi2_tpu.utils import load_checkpoint as jax_load, save_checkpoint as jax_save
    from pykaldi2_tpu_torch.utils import load_checkpoint, save_checkpoint

    jm, params, _tm = _models(case, "bfloat16", seed=4)
    jax_save(str(tmp_path / "jax.npz"), params, meta={"epoch": 0})
    port = build_model(C.ModelConfig(**dict(CASES[case], input_size=D, output_size=OUT)))
    load_checkpoint(str(tmp_path / "jax.npz"), port)
    for name, value in params_from_jax(params).items():
        assert torch.equal(port.state_dict()[name], value), name
    save_checkpoint(str(tmp_path / "port.npz"), port)
    template = jax.tree.map(np.zeros_like, params)
    loaded, _opt, _meta = jax_load(str(tmp_path / "port.npz"), template)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("case", ["tdnn", "transformer"])
def test_dropout_draws_from_generator(case):
    kw = dict(CASES[case], input_size=D, output_size=OUT, compute_dtype="float32",
              dropout=0.5)
    tm = build_model(C.ModelConfig(**kw), generator=torch.Generator().manual_seed(0))
    x = torch.randn(B, T, D)
    with pytest.raises(ValueError, match="Generator"):
        tm(x, train=True)
    with torch.no_grad():
        a = tm(x, train=True, generator=torch.Generator().manual_seed(1))
        b = tm(x, train=True, generator=torch.Generator().manual_seed(1))
        c = tm(x)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("mtype,extra", [
    ("tdnn", {"tdnn_dilations": (1, 2)}),
    ("transformer", {"num_heads": 4, "ffn_size": 64}),
])
def test_ce_training_loss_falls(tmp_path, mtype, extra):
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.data.dataset import SpeechDataset
    from pykaldi2_tpu_torch.pipeline import FeaturePipeline
    from pykaldi2_tpu_torch.trainer import make_ce_train_step
    from pykaldi2_tpu_torch.utils import make_optimizer

    from toydata import make_toy_corpus
    from torch_port_helpers import torch_batch

    paths = make_toy_corpus(str(tmp_path), num_utts=6, num_pdfs=4, seed=17)
    ds = SpeechDataset(wav_scp=paths["wav_scp"], ali=paths["ali"],
                       frame_opts=C.FrameOpts(dither=0.0))
    feat_fn = FeaturePipeline(C.FeatConfig(fbank=C.FbankOpts(
        frame_opts=C.FrameOpts(dither=0.0), mel_opts=C.MelOpts(num_bins=24))))
    model = build_model(C.ModelConfig(type=mtype, input_size=feat_fn.dim, hidden_size=32,
                                      num_layers=2, output_size=4, compute_dtype="float32",
                                      **extra), generator=torch.Generator().manual_seed(0))
    step = make_ce_train_step(model, feat_fn,
                              make_optimizer(C.OptimizerConfig(type="adam", lr=5e-3),
                                             model.parameters()))
    losses = []
    for _epoch in range(6):
        for batch in ChunkDataloader(ds, batch_size=8, chunk_len=40, seed=4):
            batch.pop("utt_ids", None)
            losses.append(float(step(torch_batch(batch))["loss"]))
    assert losses[-1] < losses[0], (mtype, losses[0], losses[-1])
