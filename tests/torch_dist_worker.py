"""One rank of a data-parallel test of the PyTorch port, run in its own process.

    python tests/torch_dist_worker.py <case> <rank> <world> <workdir>

Joins a ``gloo`` group through a FileStore in ``workdir`` (no TCP port, so
tests under pytest-xdist never collide), reads ``workdir/spec.json`` and
this rank's arrays from ``workdir/inputs.npz`` (keys ``"<rank>/<name>"``),
runs the case on the CPU and writes ``workdir/out<rank>.npz``. The tests
start the ranks with ``spawn_ranks`` below, and a one-rank group in their
own process with ``one_rank_group``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from pykaldi2_tpu_torch import config as C
from pykaldi2_tpu_torch.convert import keystr, params_to_jax, walk


def _inputs(workdir: str, key: str) -> dict:
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        return {k.split("/", 1)[1]: z[k] for k in z.files if k.split("/", 1)[0] == key}


def _setup(spec: dict):
    from pykaldi2_tpu_torch.models import build_model
    from pykaldi2_tpu_torch.pipeline import FeaturePipeline
    from pykaldi2_tpu_torch.utils import load_checkpoint

    feat = FeaturePipeline(C.FeatConfig(fbank=C.FbankOpts(
        frame_opts=C.FrameOpts(dither=0.0), mel_opts=C.MelOpts(num_bins=spec["bins"]))))
    model = build_model(C.ModelConfig(input_size=feat.dim, **spec["model"]))
    load_checkpoint(spec["init"], model)
    return feat, model


def _optimizer(spec: dict, model, **over):
    from pykaldi2_tpu_torch.utils import make_optimizer

    return make_optimizer(C.OptimizerConfig(**{**spec["opt"], **over}), model.parameters())


def _params(model, prefix: str) -> dict:
    """Copies: params_to_jax's arrays share the CPU parameters' memory."""
    return {prefix + keystr(p): v.copy() for p, v in walk(params_to_jax(model.state_dict()))}


def _metrics(m: dict, prefix: str) -> dict:
    return {f"{prefix}{k}": np.asarray(float(v)) for k, v in m.items()}


def _batch(workdir: str, key) -> dict:
    return {k: torch.from_numpy(v) for k, v in _inputs(workdir, str(key)).items()}


def case_ce(rank, world, workdir, spec):
    """make_ce_train_step over a data mesh of every rank, once per
    compression, each from the initial parameters."""
    from pykaldi2_tpu_torch.parallel.mesh import make_mesh
    from pykaldi2_tpu_torch.trainer import make_ce_train_step

    mesh = make_mesh()
    out = {}
    for comp in spec["compressions"]:
        feat, model = _setup(spec)
        step = make_ce_train_step(model, feat, _optimizer(spec, model), mesh,
                                  grad_compression=comp)
        out.update(_metrics(step(_batch(workdir, rank)), f"{comp}/m/"))
        out.update(_params(model, f"{comp}/p"))
    return out


def _bigram_den(spec):
    from pykaldi2_tpu_torch.data.dataset import SpeechDataset
    from pykaldi2_tpu_torch.graph import HmmTopology, TransitionModel, estimate_phone_bigram
    from pykaldi2_tpu_torch.graph.phone_lm import collapse_to_phones
    from pykaldi2_tpu_torch.ops.fb_bigram import make_bigram_den

    ds = SpeechDataset(wav_scp=spec["wav_scp"], ali=spec["ali"],
                       frame_opts=C.FrameOpts(dither=0.0))
    tm = TransitionModel(HmmTopology.one_state(range(1, spec["num_pdfs"] + 1)))
    p2p = np.array([p for (p, _j, _pdf) in tm.tuples], np.int32)
    lm = estimate_phone_bigram([collapse_to_phones(p2p[l]) for l in ds.labels.values()],
                               tm.topo.phones)
    return make_bigram_den(tm, lm)


def case_se(rank, world, workdir, spec):
    """make_se_train_step (fixed bigram denominator, MMI) over a data mesh;
    each rank steps on its own batch, whatever its T."""
    from pykaldi2_tpu_torch.parallel.mesh import make_mesh
    from pykaldi2_tpu_torch.trainer import make_se_train_step

    feat, model = _setup(spec)
    step = make_se_train_step(model, feat, _optimizer(spec, model), _bigram_den(spec), "mmi",
                              log_prior=_inputs(workdir, "all")["prior"], acoustic_scale=1.0,
                              ce_ratio=0.1, mesh=make_mesh())
    batch = _batch(workdir, rank)
    return {**_metrics(step(batch), "m/"), **_params(model, "p"),
            "t_len": np.asarray(batch["labels"].shape[1])}


def case_tp2d(rank, world, workdir, spec):
    """make_ce_train_step_2d on a {data: 2, model: world/2} mesh."""
    from pykaldi2_tpu_torch.parallel.mesh import make_mesh
    from pykaldi2_tpu_torch.parallel.tensor_parallel import make_ce_train_step_2d, shard_params

    mesh = make_mesh({"data": 2, "model": -1})
    feat, model = _setup(spec)
    shard_params(model, mesh)
    step = make_ce_train_step_2d(model, feat, _optimizer(spec, model, grad_clip=0.0), mesh,
                                 grad_clip=spec["opt"]["grad_clip"])
    m = step(_batch(workdir, mesh.coord("data")))
    return {**_metrics(m, "m/"), **_params(model, "p"),
            "coords": np.asarray([mesh.coord("data"), mesh.coord("model")])}


def case_bmuf(rank, world, workdir, spec):
    """One BMUF block of plain local steps on this rank's rows, then a sync."""
    from pykaldi2_tpu_torch.parallel.bmuf import bmuf_init, make_bmuf_local_step, make_bmuf_sync
    from pykaldi2_tpu_torch.parallel.mesh import make_mesh
    from pykaldi2_tpu_torch.trainer import make_ce_train_step

    mesh = make_mesh()
    feat, model = _setup(spec)
    state = bmuf_init(model, mesh, **spec["bmuf"])
    step = make_bmuf_local_step(make_ce_train_step(model, feat, _optimizer(spec, model)), mesh)
    losses = [float(step(_batch(workdir, f"{rank}.{i}"))["loss"])
              for i in range(spec["steps"])]
    out = _params(model, "block")
    make_bmuf_sync(mesh)(model, state)
    return {**out, **_params(model, "sync"), "losses": np.asarray(losses)}


def case_equalized(rank, world, workdir, spec):
    """A loop with an all-reduce per batch over loaders of unequal length."""
    from pykaldi2_tpu_torch.data.dataloader import ChunkDataloader
    from pykaldi2_tpu_torch.data.dataset import SpeechDataset
    from pykaldi2_tpu_torch.parallel.mesh import equalized_steps

    ds = SpeechDataset(wav_scp=spec["wav_scp"], ali=spec["ali"],
                       frame_opts=C.FrameOpts(dither=0.0))
    loader = ChunkDataloader(ds, spec["batch"], spec["chunk"], rank=rank, world_size=world,
                             shuffle=False)
    steps = 0
    for _ in equalized_steps(loader, iter(loader)):
        one = torch.ones(1)
        dist.all_reduce(one)  # hangs unless every rank takes this step
        steps += 1
    return {"local": np.asarray(sum(1 for _ in loader)), "steps": np.asarray(steps),
            "conservative": np.asarray(loader.num_batches(conservative=True))}


def case_cli(rank, world, workdir, spec):
    """A trainer CLI with -multihost in a group the launcher started; the
    sha256 of the last checkpoint's parameters."""
    import importlib

    os.environ["PK2_PLATFORM"] = "cpu"
    main = importlib.import_module(f"pykaldi2_tpu_torch.bin.{spec['cli']}").main
    exp = os.path.join(workdir, f"exp{rank}")
    assert main([*spec["argv"], "-exp_dir", exp, "-multihost"]) == 0
    h = hashlib.sha256()
    with np.load(os.path.join(exp, spec["ckpt"])) as z:
        for k in sorted(z.files):
            if k.startswith("['params']"):
                h.update(np.ascontiguousarray(z[k]).tobytes())
    return {"sha": np.asarray(h.hexdigest())}


def case_se_lattice(rank, world, workdir, spec):
    """make_se_lattice_steps on per-utterance graphs (BatchedGraphs) over a
    data mesh, once per criterion, each from the initial parameters; each
    rank steps on its own rows and graphs, packed to its own bucket."""
    from pykaldi2_tpu_torch.ops.fb_batched import BatchedGraphs
    from pykaldi2_tpu_torch.parallel.mesh import make_mesh
    from pykaldi2_tpu_torch.trainer import make_se_lattice_steps

    mesh = make_mesh()
    batch = _batch(workdir, rank)
    graphs = BatchedGraphs(*(batch.pop(f"g_{k}") for k in BatchedGraphs._fields))
    out = {"arcs": np.asarray(graphs.src.shape[1])}
    for crit in spec["criteria"]:
        feat, model = _setup(spec)
        _fwd, train = make_se_lattice_steps(model, feat, _optimizer(spec, model),
                                            criterion=crit, mesh=mesh,
                                            **spec["se"])
        out.update(_metrics(train(batch, graphs), f"{crit}/m/"))
        out.update(_params(model, f"{crit}/p"))
    return out


CASES = {"ce": case_ce, "se": case_se, "tp2d": case_tp2d, "bmuf": case_bmuf,
         "equalized": case_equalized, "cli": case_cli, "se_lattice": case_se_lattice}


# ---------------------------------------------------------------------------
# the test side: spawning the ranks, and a group in the test's own process
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 120


def spawn_ranks(case: str, world: int, workdir, spec: dict, inputs: dict = None) -> list:
    """Run ``tests/torch_dist_worker.py <case>`` as ``world`` processes in one
    gloo group (a FileStore in ``workdir``) and return each rank's outputs
    (a dict of numpy arrays). ``inputs`` maps "<rank>/<name>" to arrays. The
    group runs under a join timeout: on a hang every child is killed and the
    test fails, so a hang costs one test, not the suite."""
    import subprocess
    import time

    import pytest

    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "spec.json"), "w") as f:
        json.dump(spec, f)
    np.savez(os.path.join(workdir, "inputs.npz"), **(inputs or {}))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.dirname(here), here,
                                           os.environ.get("PYTHONPATH", "")]))
    logs = [open(os.path.join(workdir, f"log{r}.txt"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "torch_dist_worker.py"),
                               case, str(r), str(world), workdir], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{case}: {world} ranks did not finish in {RANK_TIMEOUT_S} s")
    finally:
        for p, f in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    bad = []
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"log{r}.txt")) as f:
                bad.append((r, p.returncode, f.read()[-3000:]))
    assert not bad, bad
    outs = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"out{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


@contextlib.contextmanager
def one_rank_group(tmp_path):
    """A one-rank gloo group in this process, as a launcher starts one
    before calling a trainer's ``main(..., "-multihost")``."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg1", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def main() -> None:
    case, rank, world, workdir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'pg')}",
                            rank=rank, world_size=world)
    try:
        with open(os.path.join(workdir, "spec.json")) as f:
            out = CASES[case](rank, world, workdir, json.load(f))
        np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
