"""The port's BMUF (parallel/bmuf.py) on 2 gloo ranks against the JAX package's
bmuf on a 2-device mesh.

One block of 2 plain CE steps per worker, each on its own rows of the same
batches, then a block-momentum sync with Nesterov restart (block momentum
0.5, block lr 1.0, as tests/test_bmuf.py), from one JAX-made initial
checkpoint in fp32 with dither 0 and dropout 0 and momentum SGD (Adam's
rsqrt amplifies fp32 summation-order noise). The JAX workers are the JAX
package's plain step on each worker's rows with its Pallas LSTM in interpret
mode (H=128, 8 rows a worker: the kernel's shapes), whose bf16 h·Wh the
port's recurrence takes at every shape (the reference's make_bmuf_local_step
runs that step under shard_map, where interpret mode does not run on the
CPU), and its ``make_bmuf_sync`` on the 2-device mesh. The workers diverge
within the block, every parameter before and after the sync agrees with the
JAX workers' to 1e-5, the averaged losses to 1e-5, and after the sync both
ranks hold the same parameters.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from pykaldi2_tpu import config as JC
from pykaldi2_tpu.data.dataloader import ChunkDataloader as JChunk
from pykaldi2_tpu.data.dataset import SpeechDataset as JDataset
from pykaldi2_tpu.models import build_model as jax_build_model
from pykaldi2_tpu.parallel.bmuf import bmuf_init, make_bmuf_sync
from pykaldi2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pykaldi2_tpu.pipeline import FeaturePipeline as JaxPipeline
from pykaldi2_tpu.trainer import make_ce_train_step as jax_ce_step
from pykaldi2_tpu.utils import make_optimizer as jax_make_optimizer
from pykaldi2_tpu.utils import save_checkpoint as jax_save

from toydata import make_toy_corpus
from torch_dist_worker import spawn_ranks
from torch_port_helpers import pallas_interpret  # noqa: F401

BINS, STEPS, ROWS = 24, 2, 8
MODEL = {"type": "lstm", "hidden_size": 128, "num_layers": 1, "output_size": 4,
         "compute_dtype": "float32"}
OPT = {"type": "momentum", "momentum": 0.9, "lr": 0.05, "grad_clip": 5.0}
BMUF = {"block_momentum": 0.5, "block_lr": 1.0}


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_bmuf_block_and_sync_match_jax(tmp_path, pallas_interpret):
    paths = make_toy_corpus(str(tmp_path / "corpus"), num_utts=8, num_pdfs=4, seed=9)
    ds = JDataset(wav_scp=paths["wav_scp"], ali=paths["ali"], frame_opts=JC.FrameOpts(dither=0.0))
    batches = [b for _, b in zip(range(STEPS), JChunk(ds, batch_size=2 * ROWS, chunk_len=40,
                                                        shuffle=False))]
    jm = jax_build_model(JC.ModelConfig(input_size=BINS, **MODEL))
    params = jm.init(jax.random.PRNGKey(0))
    init = str(tmp_path / "init.npz")
    jax_save(init, params)
    ranks = spawn_ranks("bmuf", 2, tmp_path / "ranks",
                        {"bins": BINS, "model": MODEL, "init": init, "opt": OPT,
                         "bmuf": BMUF, "steps": STEPS},
                        {f"{r}.{i}/{k}": v[ROWS * r: ROWS * (r + 1)] for r in range(2)
                         for i, b in enumerate(batches) for k, v in b.items()})

    mesh = jax_make_mesh({"data": 2}, devices=jax.devices()[:2])
    feat = JaxPipeline(JC.FeatConfig(fbank=JC.FbankOpts(
        frame_opts=JC.FrameOpts(dither=0.0), mel_opts=JC.MelOpts(num_bins=BINS))))
    opt = jax_make_optimizer(JC.OptimizerConfig(**OPT))
    step = jax_ce_step(jm, feat, opt, mesh=None, donate=False)
    worker, state = bmuf_init(params, mesh, **BMUF)
    local = [(params, opt.init(params)) for _ in range(2)]
    losses = []
    for b in batches:
        out = [step(p, o, {k: v[ROWS * r: ROWS * (r + 1)] for k, v in b.items()},
                    jax.random.PRNGKey(1)) for r, (p, o) in enumerate(local)]
        local = [(p, o) for p, o, _ in out]
        losses.append(np.mean([float(m["loss"]) for _, _, m in out]))  # the pmean
    worker = jax.tree.map(
        lambda a, b: jax.device_put(jnp.stack([a, b]), NamedSharding(mesh, P("data"))),
        local[0][0], local[1][0])
    block = _flat(worker)
    worker, _ = make_bmuf_sync(mesh)(worker, state)
    synced = _flat(worker)

    blocks = [{k[len("block"):]: v for k, v in r.items() if k.startswith("block")}
              for r in ranks]
    syncs = [{k[len("sync"):]: v for k, v in r.items() if k.startswith("sync")} for r in ranks]
    assert set(blocks[0]) == set(block)
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["losses"], losses, rtol=0, atol=1e-5)
        for k in block:  # worker r before the sync: the JAX worker r
            np.testing.assert_allclose(blocks[r][k], block[k][r], rtol=0, atol=1e-5, err_msg=k)
            np.testing.assert_allclose(syncs[r][k], synced[k][r], rtol=0, atol=1e-5, err_msg=k)
            np.testing.assert_array_equal(syncs[r][k], syncs[0][k], err_msg=k)
    assert any(not np.allclose(blocks[0][k], blocks[1][k]) for k in block)  # they diverged
