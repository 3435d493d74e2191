"""Split a hand-written kernel's time into its parts with clock64() stamps.

    python3 tools/kernel_split.py [--src DIR] [--what k6,k11] [--out build/split]
    python3 tools/kernel_split.py --src <csrc of commit 7ff1e87> --what k6_first,k11_first

Copies ``lstm.cu`` and ``blockfb.cu`` from ``--src`` (default: the port's
``pykaldi2_tpu_torch/csrc``) into ``--out``, inserts stamps at fixed lines
of the kernel (thread 0 of every CTA adds the cycles since its previous
stamp to one of a few buckets in a ``__device__`` array, and counts the
stamp), builds the copy with the port's nvcc flags, swaps it in for the
port's library, runs the kernel through its wrapper and prints, per bucket,
the mean cycles per stamp and per CTA (and per step for K6), beside the
CUDA-event time of the uninstrumented kernel on the same inputs. The
repository's sources are never touched. Each insertion names the source line
it follows or precedes; a source whose lines differ makes the tool stop
with the line it could not find. The stamps cost a few hundred cycles a
step, so read the buckets as shares, and the event time as the kernel's.

Kernels and shapes:
  k6   ``lstmp_bwd_kernel`` at B=64, T=80, H=1024, P=512 (one BLSTMP layer
       direction), buckets: phase-1 staging, phase-1 mma, partial stores
       and dhp epilogue, barrier 1, phase-2 staging, phase-2 mma and gate
       math, barrier 2;
  k11  ``block_matvec_kernel`` on chip_smoke's 96k-state chain graph, R=16
       and 32, both orientations, buckets: prologue (segment lookup, first
       copies issued), first chunk's wait, later chunks' waits, FMA loop,
       single-segment epilogue, multi-segment publish, last CTA's sum.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PRELUDE = r"""
__device__ unsigned long long pk2_split[64];
#define PK2_T0 long long pk2_t0 = clock64()
#define PK2_STAMP(i)                                                        \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      const long long pk2_t = clock64();                                    \
      atomicAdd(&pk2_split[(i)], (unsigned long long)(pk2_t - pk2_t0));     \
      atomicAdd(&pk2_split[32 + (i)], 1ull);                                \
      pk2_t0 = pk2_t;                                                       \
    }                                                                       \
  } while (0)
"""

EPILOGUE = r"""
extern "C" int pk2_split_take(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaMemcpyFromSymbol(out, pk2_split, sizeof(unsigned long long) * 64)) != cudaSuccess)
    return (int)e;
  static const unsigned long long zero[64] = {0};
  return (int)cudaMemcpyToSymbol(pk2_split, zero, sizeof(zero));
}
"""

# (kernel's first line, [(line it is on, 'after[+n]' | 'before', text), ...]):
# each line is searched from the previous match on, and matched stripped.
# k6 and k11 are the current kernels; k6_first and k11_first their first
# versions (128 CTAs staging all of dgates; a 2-stage ring and a binary
# search), as in commit 7ff1e87's csrc: --src a copy of it
SPECS = {
    "k6": ("lstmp_bwd_kernel(const float* __restrict__ dys", [
        ("float dc_r[4] = {0.f, 0.f, 0.f, 0.f};", "after", "PK2_T0;"),
        ("m_t = mask[(size_t)t * ldb + b];", "after+1", "PK2_STAMP(0);"),
        ("ldw, (warp % ng) * 2, warp / ng, nkp, g, tg);", "after", "PK2_STAMP(1);"),
        ("sum_planes(Pl, ldp1, nkp, mtiles * 16, NP);", "after", "PK2_STAMP(2);"),
        ("cluster.sync();", "after", "PK2_STAMP(3);"),
        ("grid.sync();", "before", "PK2_STAMP(4);"),
        ("grid.sync();", "after", "PK2_STAMP(5);"),
        ("NWARPS, g, tg);", "after", "PK2_STAMP(6);"),
        ("sum_planes(Pl, ldp2, NWARPS, mtiles * 16, K3_UNITS);", "after+1", "PK2_STAMP(7);"),
        ("if (t > 0) grid.sync();", "before", "PK2_STAMP(8);"),
        ("if (t > 0) grid.sync();", "after", "PK2_STAMP(9);"),
    ]),
    "k11": ("__global__ void __launch_bounds__(kThreads, 2) block_matvec_kernel(", [
        ("__shared__ int last, src[kMaxSegTiles];", "after", "PK2_T0;"),
        ("cp_async_wait<kStages - 2>();  // chunk q has landed in this thread", "before",
         "PK2_STAMP(q == 0 ? 0 : 4);"),
        ("__syncthreads();               // ... in every thread; chunk q-1's stage is free",
         "after", "PK2_STAMP(q == 0 ? 1 : 2);"),
        ("cp_async_commit();", "after", "PK2_STAMP(3);"),
        ("cp_async_wait<0>();", "before", "PK2_STAMP(4);"),
        ("__syncthreads();  // every product is done: the ring's space holds the parts", "after",
         "PK2_STAMP(5);"),
        ("if (mine == nullptr) return;", "before", "PK2_STAMP(6);"),
        ("if (!last) return;", "before", "PK2_STAMP(7);"),
        ("if (tid == 0) *counter = 0;  // ready for the next call", "before", "PK2_STAMP(8);"),
    ]),
    "k6_first": ("lstmp_bwd_kernel(const float* __restrict__ dys", [
        ("for (int i = 0; i < MAX_PAIRS; ++i) dc_r[i] = 0.f;", "after", "PK2_T0;"),
        ("stage_owned(Xs, ldd, dgbuf + kc, H4, role, nb, kw);", "after+1", "PK2_STAMP(0);"),
        ("group_mma(acc, Xs, ldd, Wr + kc, ldw, kw, role, warp, g, tg);", "after+1",
         "PK2_STAMP(1);"),
        ("grid.sync();", "before", "PK2_STAMP(2);"),
        ("grid.sync();", "after", "PK2_STAMP(3);"),
        ("stage_rows(Xs, ldp, dpbuf, P, mtiles * 16, nb, P);", "after+1", "PK2_STAMP(4);"),
        ("grid.sync();", "before", "PK2_STAMP(5);"),
        ("grid.sync();", "after", "PK2_STAMP(6);"),
    ]),
    "k11_first": ("__global__ void __launch_bounds__(kThreads) block_matvec_kernel(", [
        ("__shared__ int last;", "after", "PK2_T0;"),
        ("cp_async_commit();", "after", "PK2_STAMP(0);"),
        ("__syncthreads();", "after", "PK2_STAMP(q == 0 ? 1 : 2);"),
        ("__syncthreads();  // the stage is refilled two chunks later", "after",
         "PK2_STAMP(3);"),
        ("return;", "before", "PK2_STAMP(4);"),
        ("if (!last) return;", "before", "PK2_STAMP(5);"),
        ("if (tid == 0) *counter = 0;  // ready for the next call", "before", "PK2_STAMP(6);"),
    ]),
}
BUCKETS = {
    "k6": ["per-frame loads issued", "phase-1 product (staging + mma)", "phase-1 plane sum",
           "cluster barrier", "DSMEM pull + dhp epilogue", "barrier 1",
           "phase-2 product (staging + mma)", "phase-2 plane sum", "gate math", "barrier 2"],
    "k11": ["prologue", "first chunk wait", "later chunk waits", "next chunk issued", "FMA",
            "drain", "planes + output", "multi-segment publish", "last CTA's sum"],
    "k6_first": ["phase-1 staging", "phase-1 mma", "partials + dhp epilogue", "barrier 1",
               "phase-2 staging", "phase-2 mma + gate math", "barrier 2"],
    "k11_first": ["prologue", "first chunk wait", "later chunk waits", "FMA loop",
                "single-segment epilogue", "multi-segment publish", "last CTA's sum"],
}


def instrument(text: str, what: str) -> str:
    start, inserts = SPECS[what]
    lines = text.split("\n")
    pos = next((i for i, ln in enumerate(lines) if start in ln), None)
    if pos is None:
        raise SystemExit(f"{what}: kernel line not found: {start!r}")
    out_at = []
    for anchor, where, stamp in inserts:
        hit = next((i for i in range(pos, len(lines)) if lines[i].strip() == anchor), None)
        if hit is None:
            raise SystemExit(f"{what}: line not found after {pos + 1}: {anchor!r}")
        m = re.fullmatch(r"after(?:\+(\d+))?", where)
        at = hit + 1 + int(m.group(1) or 0) if m else hit
        out_at.append((at, stamp))
        pos = hit if where == "before" else hit + 1
    for at, stamp in sorted(out_at, reverse=True):
        lines.insert(at, stamp)
    return PRELUDE + "\n".join(lines) + EPILOGUE


def build(src_dir: str, out_dir: str, what: str, stamped: bool = True) -> ctypes.CDLL:
    """The kernel's library built from ``src_dir``, with the stamps or without."""
    from pykaldi2_tpu_torch import device as D

    name = "lstm" if what.startswith("k6") else "blockfb"
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(src_dir, f"{name}.cu")) as f:
        text = f.read()
    tag = f"{name}_{what}_{'split' if stamped else 'plain'}"
    cu = os.path.join(out_dir, f"{tag}.cu")
    with open(cu, "w") as f:
        f.write(instrument(text, what) if stamped else text)
    lib = os.path.join(out_dir, f"lib{tag}.so")
    res = subprocess.run([D.nvcc_path(), *D.NVCC_FLAGS, "-o", lib, cu], capture_output=True,
                         text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {cu}:\n{res.stdout}{res.stderr}")
    out = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    if name == "lstm":  # the entry points the LSTMP backward's wrapper calls
        out.pk2_lstm_max_batch.restype = ci
        out.pk2_lstmp_bwd.argtypes = [vp] * 10 + [ci] * 5 + [vp]
        out.pk2_lstmp_bwd.restype = ci
        out._pk2_typed = True
    else:  # the first and the current K11 take the same arguments but the 4th
        out.pk2_blockfb_matvec.argtypes = [vp] * 8 + [ci] * 4 + [vp]
        out.pk2_blockfb_matvec.restype = ci
        out.pk2_blockfb_row_tile.argtypes = [ci]
        out.pk2_blockfb_row_tile.restype = ci
    if stamped:
        out.pk2_split_take.argtypes = [vp]
    return out


def take(lib) -> list:
    buf = (ctypes.c_ulonglong * 64)()
    rc = lib.pk2_split_take(buf)
    if rc:
        raise SystemExit(f"pk2_split_take: cudaError_t {rc}")
    return list(buf)


def report(what: str, label: str, raw: list, calls: int, per: str, n_per: float, ms: float):
    total = sum(raw[:32])
    print(f"{what} {label}: event time {ms:.4f} ms a call (uninstrumented)", flush=True)
    for i, name in enumerate(BUCKETS[what]):
        cyc, cnt = raw[i], raw[32 + i]
        if cnt == 0:
            continue
        print(f"  {name:26s} {cyc / calls / n_per:10.1f} cycles {per} "
              f"({100.0 * cyc / total:5.1f}%), {cnt / calls:.0f} stamps a call, "
              f"{cyc / cnt:.1f} cycles a stamp", flush=True)
    print(f"  {'total':26s} {total / calls / n_per:10.1f} cycles {per}", flush=True)
    return total


def run_k6(what: str, src: str, out: str, calls: int = 5):
    import numpy as np
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.ops import lstm_cuda as L

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
    _ys, cs, gates, _hf = L.lstm_proj_fwd_plain(xp, wh, wp, mask)
    fn = lambda: L.lstm_proj_bwd(dys, gates, cs, mask, wh, wp)  # noqa: E731
    base = D._LIBS.get("lstm")
    D._LIBS["lstm"] = build(src, out, what, stamped=False)
    ms = C.timed(fn)
    split = D._LIBS["lstm"] = build(src, out, what)
    fn()
    take(split)
    for _ in range(calls):
        fn()
    raw = take(split)
    D._LIBS["lstm"] = base
    ctas = h // 8 if what == "k6_first" else h // 16
    total = report(what, f"B={b} T={t} H={h} P={p}", raw, calls, "a step per CTA", ctas * t, ms)
    print(f"  implied SM clock {total / calls / ctas / (ms * 1e-3) / 1e9:.3f} GHz "
          f"(cycles per CTA over the event time)", flush=True)


def run_k11(what: str, src: str, out: str, calls: int = 20):
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.ops import fb_block_cuda as F
    from pykaldi2_tpu_torch.ops.fb_block import pack_graph_blocks

    dev = torch.device("cuda", 0)
    g = pack_graph_blocks(C.make_chain_graph()).to(dev)
    nblk = g.num_padded // g.block
    counters = torch.zeros(nblk, dtype=torch.int32, device=dev)
    plain, split = build(src, out, what, stamped=False), build(src, out, what)
    gen = torch.Generator(device=dev).manual_seed(11)
    for rows in (C.FD_B, 2 * C.FD_B):
        for transpose in (False, True):
            x = torch.rand(rows, g.num_padded, generator=gen, device=dev)
            x[:, g.num_states:] = 0.0
            src_blk, _dst, tiles, rowptr = F._orientation(g, transpose)
            segptr = g.segptr_t if transpose else g.segptr
            desc = rowptr if what == "k11_first" else (g.segdesc_t if transpose else g.segdesc)
            nseg = g.num_seg_t if transpose else g.num_seg
            rt = plain.pk2_blockfb_row_tile(rows)
            partial = torch.empty((nseg, -(-rows // rt), rt, g.block), device=dev)
            y = torch.empty_like(x)

            def call(lib):
                rc = lib.pk2_blockfb_matvec(
                    D.ptr(x), D.ptr(tiles), D.ptr(src_blk), D.ptr(desc), D.ptr(segptr),
                    D.ptr(partial), D.ptr(counters), D.ptr(y), rows, nblk, nseg, F.SEG_TILES,
                    D.current_stream_ptr(dev))
                D.check_launch(rc, what)

            ms = C.timed(lambda: call(plain), n=50)
            call(split)
            take(split)
            for _ in range(calls):
                call(split)
            raw = take(split)
            label = f"R={rows} {'transposed' if transpose else 'forward'} ({nseg} CTAs)"
            report(what, label, raw, calls, "a CTA", nseg, ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "pykaldi2_tpu_torch", "csrc"))
    ap.add_argument("--what", default="k6,k11")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "split"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_split needs a CUDA card")
    from pykaldi2_tpu_torch import device as D

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    D.build_all()
    for what in args.what.split(","):
        (run_k6 if what.startswith("k6") else run_k11)(what, args.src, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
