"""Probe the device search on one card: the captured CUDA graph against the
eager loop on the card and on the CPU, and their times.

    python3 tools/device_search_probe.py

On random scaled log-likelihoods (0.1 · log_softmax of N(0, 9) logits over
8952 outputs) it searches chip_smoke's SE denominator graph (the phone loop
of a 41-phone 3-state model, folded: B=32, T=448, max_active 200, max_arcs
800, beams 10/4) and a 200-word loop (B=8, T=400, max_active 2000, max_arcs
1024, beams 16/8, word olabels), and prints for each: equality of the
captured search with the eager loop on the card and with the eager loop on
the CPU (first two rows), the eager and captured times a frame, the capture's
host time, the links a frame and the epilogue's time. It also prints the
kernel that ``ops.lstm_cuda.bmm_bf16`` launches and its error against exact
products of the bf16 operands.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pykaldi2_tpu_torch import device as D  # noqa: E402
from pykaldi2_tpu_torch.bin.train_se import phone_loop_den_fst  # noqa: E402
from pykaldi2_tpu_torch.decode import device_lattice as DL  # noqa: E402
from pykaldi2_tpu_torch.decode.decoder import build_native  # noqa: E402
from pykaldi2_tpu_torch.graph import (HmmTopology, TransitionModel,  # noqa: E402
                                      estimate_phone_bigram, make_decode_graph)
from pykaldi2_tpu_torch.ops.lstm_cuda import bmm_bf16  # noqa: E402
from pykaldi2_tpu_torch.utils import tracing  # noqa: E402


def bmm_check(dev) -> None:
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(512, 80, 128, device=dev)
    b = torch.randn(512, 128, 80, device=dev)
    exact = torch.bmm(a.bfloat16().double(), b.bfloat16().double()).float()
    print(f"bmm_bf16: {bmm_bf16(a, b).dtype}, max err vs exact "
          f"{float((bmm_bf16(a, b) - exact).abs().max()):.3g}", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bmm_bf16(a, b)
        torch.cuda.synchronize()
    print("bmm_bf16 launches:", [e.key for e in prof.key_averages()], flush=True)


def graphs():
    tm = TransitionModel(HmmTopology.three_state(range(1, 42)))
    rng = np.random.RandomState(0)
    seqs = [list(rng.randint(1, 42, 30)) for _ in range(50)]
    den = phone_loop_den_fst(tm, estimate_phone_bigram(seqs, tm.topo.phones))
    lexicon = {f"w{i:03d}": [[int(p) for p in rng.randint(1, 42, rng.randint(2, 6))]]
               for i in range(200)}
    word = make_decode_graph(tm, lexicon, {w: i + 1 for i, w in enumerate(lexicon)})
    return [("den", den, "fold", 32, 448,
             dict(max_active=200, max_arcs=800, beam=10.0, lattice_beam=4.0)),
            ("word", word, "auto", 8, 400,
             dict(max_active=2000, max_arcs=1024, beam=16.0, lattice_beam=8.0,
                  return_olabels=True))]


def probe(dev, name, fst, mode, b, t, kw) -> None:
    g = DL.pack_decode_graph(fst, eps_mode=mode)
    print(f"{name}: S={g.num_states} s_lo={g.s_lo} d_lo={g.d_lo} d_hi={g.d_hi} "
          f"L={g.eps_depth}", flush=True)
    gen = torch.Generator().manual_seed(5)
    obs = 0.1 * torch.log_softmax(torch.randn(b, t, 8952, generator=gen) * 3, dim=-1)
    nf = torch.full((b,), t, dtype=torch.int64)
    nf[-1] = t - 37
    search = DL.DeviceSearch(g.to(dev))
    oc, nc = obs.to(dev), nf.to(dev)
    t0 = time.perf_counter()
    cpu = DL.device_lattice_generate(obs[:2], g, nf[:2], **kw)
    t_cpu = time.perf_counter() - t0
    search(oc, nc, capture=False, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = search(oc, nc, capture=False, **kw)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    cap = search(oc, nc, **kw)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        cap = search(oc, nc, **kw)
    e1.record()
    torch.cuda.synchronize()
    t_rep = e0.elapsed_time(e1) / 3
    captures, capture_s = tracing.take()["counters"]["search.captures"]
    for field, x, y, z in zip(cap[0]._fields, eager[0], cap[0], cpu[0]):
        print(f"  {name} {field}: captured == eager {torch.equal(x, y)}, "
              f"== CPU {torch.equal(y[:2].cpu(), z)}", flush=True)
    print(f"  {name} scores equal {torch.equal(eager[1], cap[1])}, dropped "
          f"{cap[2].tolist()}", flush=True)
    print(f"  {name} B={b} T={t}: CPU eager (2 rows) {t_cpu:.2f} s; card eager "
          f"{t_eager / t * 1e3:.3f} ms a frame; {captures} capture, {capture_s:.2f} s; replay "
          f"{t_rep:.2f} ms = {t_rep / t * 1e3:.2f} us a frame", flush=True)
    valid = (cap[0].weight > -5e29).sum(2)
    t0 = time.perf_counter()
    fsas = DL.banded_to_fsas(cap[0], nf, cap[3] if len(cap) > 3 else None)
    print(f"  {name} links a frame max {int(valid.max())} mean "
          f"{float(valid.float().mean()):.1f}; banded_to_fsas {time.perf_counter() - t0:.3f} s, "
          f"states {[f.num_states for f, _ in fsas[:4]]}", flush=True)


def main() -> int:
    dev = D.resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build_native(True)
    bmm_check(dev)
    for case in graphs():
        probe(dev, *case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
