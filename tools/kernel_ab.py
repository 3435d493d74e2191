"""Time the port's K6 and K11 against an earlier version of their sources, in one process.

    git archive <commit> pykaldi2_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/kernel_ab.py --parent build/parent/pykaldi2_tpu_torch/csrc [--what k6,k11]

Builds the earlier ``lstm.cu`` and ``blockfb.cu`` with the port's nvcc flags
into ``build/ab/``, and times, on the same inputs and card, the earlier and
the current kernel in turns (earlier, current, current, earlier; CUDA-event
means) at the main path's shapes: K6 at B=64, T=80, H=1024, P=512 and K11 on
chip_smoke's 96k-state chain graph at R=16 and 32 in both orientations. The
earlier K6 takes the same C arguments as the current one; the earlier K11
takes the CSR row pointer where the current one takes segment descriptors
(the first K11, as in commit 7ff1e87, told apart by its source naming no
``segdesc``); both K11s are launched
through ctypes directly, into buffers allocated once, since the wrapper's
per-call host work takes about as long as the kernel. Each earlier result is
held against the current one (K6 within chip_smoke's ``TOL["lstmp_bwd"]``, K11
within ``BLOCK_TOL`` of the row max). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(src_dir: str, name: str, out_dir: str) -> ctypes.CDLL:
    from pykaldi2_tpu_torch import device as D

    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"lib{name}_parent.so")
    res = subprocess.run([D.nvcc_path(), *D.NVCC_FLAGS, "-o", lib,
                          os.path.join(src_dir, f"{name}.cu")], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {name}.cu:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(lib)


def turns(label: str, parent, current, n: int) -> None:
    import chip_smoke as C

    ms = [C.timed(f, n=n) for f in (parent, current, current, parent)]
    print(f"{label}: earlier {ms[0]:.4f} / {ms[3]:.4f} ms, current {ms[1]:.4f} / {ms[2]:.4f} ms "
          f"(means {(ms[0] + ms[3]) / 2:.4f} vs {(ms[1] + ms[2]) / 2:.4f})", flush=True)


def k6_ab(parent_lib) -> None:
    import numpy as np
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    vp, ci = ctypes.c_void_p, ctypes.c_int
    parent_lib.pk2_lstm_max_batch.restype = ci
    parent_lib.pk2_lstmp_bwd.argtypes = [vp] * 10 + [ci] * 5 + [vp]
    parent_lib.pk2_lstmp_bwd.restype = ci
    parent_lib._pk2_typed = True
    dev = torch.device("cuda", 0)
    t, b, h, p = C.T, C.B, C.H, C.PROJ
    rng = np.random.RandomState(2)
    dys = torch.tensor((rng.randn(t, b, p) * 0.1).astype(np.float32), device=dev)
    xp = torch.tensor((rng.randn(t, b, 4 * h) * 0.5).astype(np.float32), device=dev)
    wh = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (p, 4 * h)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    wp = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (h, p)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    mask = torch.ones(t, b, device=dev)
    mask[50:, 3] = 0.0
    _ys, cs, gates, _hf = L.lstm_proj_fwd_plain(xp, wh, wp, mask)
    current_lib = L._lib()

    def run(lib):
        D._LIBS["lstm"] = lib
        out = L.lstm_proj_bwd(dys, gates, cs, mask, wh, wp)
        D._LIBS["lstm"] = current_lib
        return out

    old, new = run(parent_lib), run(current_lib)
    torch.cuda.synchronize()
    err = max(float((a - c).abs().max()) for a, c in zip(old, new))
    print(f"K6 earlier vs current: max abs difference {err:.3e} (tolerance "
          f"{C.TOL['lstmp_bwd']:g})", flush=True)
    if err > C.TOL["lstmp_bwd"]:
        raise SystemExit("K6: the earlier and the current kernel disagree")
    turns(f"K6 B={b} T={t} H={h} P={p}", lambda: run(parent_lib), lambda: run(current_lib), 20)


def k11_ab(parent_lib, parent_takes_rowptr: bool) -> None:
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.ops import fb_block_cuda as F
    from pykaldi2_tpu_torch.ops.fb_block import pack_graph_blocks

    vp, ci = ctypes.c_void_p, ctypes.c_int
    parent_lib.pk2_blockfb_matvec.argtypes = [vp] * 8 + [ci] * 4 + [vp]
    parent_lib.pk2_blockfb_matvec.restype = ci
    parent_lib.pk2_blockfb_row_tile.argtypes = [ci]
    parent_lib.pk2_blockfb_row_tile.restype = ci
    dev = torch.device("cuda", 0)
    g = pack_graph_blocks(C.make_chain_graph()).to(dev)
    nblk = g.num_padded // g.block
    counters = torch.zeros(4 * nblk, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for rows in (C.FD_B, 2 * C.FD_B):
        for transpose in (False, True):
            x = torch.rand(rows, g.num_padded, generator=gen, device=dev)
            x[:, g.num_states:] = 0.0
            src_blk, _dst, tiles, rowptr = F._orientation(g, transpose)
            segptr = g.segptr_t if transpose else g.segptr
            nseg = g.num_seg_t if transpose else g.num_seg
            rt = parent_lib.pk2_blockfb_row_tile(rows)
            partial = torch.empty((nseg, -(-rows // rt), rt, g.block), device=dev)
            desc = g.segdesc_t if transpose else g.segdesc
            out = torch.empty_like(x)

            def call(lib, fourth):  # both versions launched alike, without the wrapper's work
                rc = lib.pk2_blockfb_matvec(
                    D.ptr(x), D.ptr(tiles), D.ptr(src_blk), D.ptr(fourth), D.ptr(segptr),
                    D.ptr(partial), D.ptr(counters), D.ptr(out), rows, nblk, nseg, F.SEG_TILES,
                    D.current_stream_ptr(dev))
                D.check_launch(rc, "K11")
                return out

            label = f"K11 R={rows} {'transposed' if transpose else 'forward'}"
            fourth = rowptr if parent_takes_rowptr else desc
            old = call(parent_lib, fourth).clone()
            new = F.block_matvec(x, g, transpose)
            torch.cuda.synchronize()
            scale = C.BLOCK_TOL * new.abs().max(1, True).values
            worst = float(((old - new).abs() / scale).max())
            print(f"{label} earlier vs current: worst difference / ({C.BLOCK_TOL:g}*row max) "
                  f"{worst:.3f}", flush=True)
            if worst > 1.0:
                raise SystemExit(f"{label}: the earlier and the current kernel disagree")
            current_lib = F._lib()
            turns(label, lambda: call(parent_lib, fourth), lambda: call(current_lib, desc), 50)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="csrc directory of the earlier version")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "ab"))
    ap.add_argument("--what", default="k6,k11")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    from pykaldi2_tpu_torch import device as D

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    D.resolve_device("cuda")
    D.build_all(("lstm", "blockfb"))
    if "k6" in args.what.split(","):
        k6_ab(build(args.parent, "lstm", args.out))
    if "k11" in args.what.split(","):
        with open(os.path.join(args.parent, "blockfb.cu")) as f:
            takes_rowptr = "segdesc" not in f.read()
        k11_ab(build(args.parent, "blockfb", args.out), takes_rowptr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
