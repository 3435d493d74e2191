"""Time the port's K1, K4-K11 against an earlier version of their sources, in one process.

    git archive <commit> pykaldi2_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/kernel_ab.py --parent build/parent/pykaldi2_tpu_torch/csrc \
        [--what k1,k4,k5,k6,k7,k8,k9,k10,k11]

Builds the earlier ``fbank.cu``, ``lstm.cu``, ``latfb.cu`` and ``blockfb.cu``
with the port's nvcc flags into ``build/ab/``, and times, on the same inputs
and card, the earlier and the current kernel in turns (earlier, current,
current, earlier; CUDA-event means) at the main path's shapes: K1 (80-bin
fbank) and K4 (mfcc_hires) at chip_smoke's FRONT_SHAPES (B=64 x 80 frames
and one 1,230-frame utterance), K5 and K6 at B=64, T=80, H=1024, P=512,
K7-K10 on chip_smoke's ``padded_lattice`` (B=32, T=448, K=256, A=512) and
probe lattice (K=A=256), K8 and K10 fed the plain forwards' residuals, K11
on chip_smoke's 96k-state chain graph at R=16 and 32 in both orientations.
The first K1/K4 (commit 714a141's, told apart by its separate -sin table)
takes other C arguments and tables than the current one, and is launched
with them; both K1/K4 versions are timed twice: over eager calls through
their wrappers (as chip_smoke's ``ms``, the time a caller pays), then from
CUDA graphs of 20 calls (the device's time alone: at one utterance the
wrappers' host work is a fair share of the call). The earlier K5, K6 and K7-K10 take the same C arguments as the
current ones;
the earlier K11 takes the CSR row pointer where the current one takes
segment descriptors
(the first K11, as in commit 7ff1e87, told apart by its source naming no
``segdesc``); both K11s are launched
through ctypes directly, into buffers allocated once, since the wrapper's
per-call host work takes about as long as the kernel. Each earlier result is
held against the current one (K1, K4, K5 and K6 within chip_smoke's ``TOL``, K7-K10
within ``LAT_TOL``, K11 within ``BLOCK_TOL`` of the row max). Needs a CUDA
card and nvcc.
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


def is_first_fbank(src_dir: str) -> bool:
    """Whether ``src_dir``'s fbank.cu is the first K1/K4 (commit 714a141 and
    before: separate cos and -sin tables and a dense transposed mel matrix)."""
    with open(os.path.join(src_dir, "fbank.cu")) as f:
        return "const float* __restrict__ sinm" in f.read()


def first_fbank_call(lib, wave, opts):
    """Launch the first K1 (FbankOpts) or K4 (MfccOpts) from ``lib`` with its C
    arguments, on the constants of the plain versions; returns the output."""
    import numpy as np
    import torch

    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.config import MfccOpts
    from pykaldi2_tpu_torch.frontend import fused as F
    from pykaldi2_tpu_torch.frontend import window as W

    if not getattr(lib, "_pk2_first_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.pk2_fbank.argtypes = [vp] * 7 + [ci] * 7 + [cf, cf, vp]
        lib.pk2_fbank.restype = ci
        lib.pk2_mfcc.argtypes = [vp] * 8 + [ci] * 8 + [cf, cf, ci, cf, vp]
        lib.pk2_mfcc.restype = ci
        lib._pk2_first_typed = True
    fo = opts.frame_opts
    b, s = wave.shape
    t = W.num_frames(s, fo)
    stream = D.current_stream_ptr(wave.device)
    floor = float(W.FLT_EPSILON)
    if isinstance(opts, MfccOpts):
        idx, win, cos_w, sin_w, mel_t, dct_t = F._mfcc_constants(opts, s, wave.device)
        out = torch.empty((b, t, opts.num_ceps), device=wave.device)
        efloor = float(np.log(opts.energy_floor)) if opts.energy_floor > 0.0 else -np.inf
        rc = lib.pk2_mfcc(D.ptr(wave), D.ptr(idx), D.ptr(win), D.ptr(cos_w), D.ptr(sin_w),
                          D.ptr(mel_t), D.ptr(dct_t), D.ptr(out), b, s, t, fo.window_size,
                          cos_w.shape[1], opts.mel_opts.num_bins, opts.num_ceps,
                          int(fo.remove_dc_offset), float(fo.preemph_coeff), floor,
                          int(opts.use_energy), efloor, stream)
    else:
        idx, win, cos_w, sin_w, mel_t = F._constants(opts, s, wave.device)
        out = torch.empty((b, t, opts.mel_opts.num_bins), device=wave.device)
        rc = lib.pk2_fbank(D.ptr(wave), D.ptr(idx), D.ptr(win), D.ptr(cos_w), D.ptr(sin_w),
                           D.ptr(mel_t), D.ptr(out), b, s, t, fo.window_size, cos_w.shape[1],
                           opts.mel_opts.num_bins, int(fo.remove_dc_offset),
                           float(fo.preemph_coeff), floor, stream)
    D.check_launch(rc, "first K1/K4")
    return out


def turns(label: str, parent, current, n: int, graph: bool = False) -> None:
    """Mean ms a call of the earlier and the current version, in turns; with
    ``graph``, from CUDA graphs of n calls (device time without the
    wrappers' host work)."""
    import chip_smoke as C

    ms = [C.timed_graph(f, n=n) if graph else C.timed(f, n=n)
          for f in (parent, current, current, parent)]
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


def k5_ab(parent_lib) -> None:
    import numpy as np
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    vp, ci = ctypes.c_void_p, ctypes.c_int
    parent_lib.pk2_lstm_max_batch.restype = ci
    parent_lib.pk2_lstmp_fwd.argtypes = [vp] * 9 + [ci] * 5 + [vp]
    parent_lib.pk2_lstmp_fwd.restype = ci
    parent_lib._pk2_typed = True
    dev = torch.device("cuda", 0)
    t, b, h, p = C.T, C.B, C.H, C.PROJ
    rng = np.random.RandomState(2)
    xp = torch.tensor((rng.randn(t, b, 4 * h) * 0.5).astype(np.float32), device=dev)
    wh = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (p, 4 * h)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    wp = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (h, p)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    mask = torch.ones(t, b, device=dev)
    mask[50:, 3] = 0.0
    current_lib = L._lib()

    def run(lib):
        D._LIBS["lstm"] = lib
        out = L.lstm_proj_fwd(xp, wh, wp, mask)
        D._LIBS["lstm"] = current_lib
        return out

    old, new = run(parent_lib), run(current_lib)
    torch.cuda.synchronize()
    for name, i, tol in (("ys", 0, "lstmp_fwd"), ("cs", 1, "lstmp_fwd"),
                         ("gates", 2, "lstmp_fwd_bf16"), ("hfull", 3, "lstmp_fwd_bf16")):
        err = float((old[i].float() - new[i].float()).abs().max())
        print(f"K5 {name} earlier vs current: max abs difference {err:.3e} (tolerance "
              f"{C.TOL[tol]:g})", flush=True)
        if err > C.TOL[tol]:
            raise SystemExit("K5: the earlier and the current kernel disagree")
    turns(f"K5 B={b} T={t} H={h} P={p}", lambda: run(parent_lib), lambda: run(current_lib), 20)


def latfb_ab(parent_lib, kernels: list) -> None:
    """K7-K10 (those named in ``kernels``) on chip_smoke's
    ``padded_lattice`` and probe bands; K8 and K10 take the plain forwards'
    residuals."""
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.ops import fb_lattice as FL
    from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC

    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn, n_ptr in (("pk2_latfb_logz_fwd", 7), ("pk2_latfb_occupancies_bwd", 10),
                      ("pk2_latfb_smbr_fwd", 9), ("pk2_latfb_smbr_bwd", 13)):
        getattr(parent_lib, fn).argtypes = [vp] * n_ptr + [ci] * 4 + [vp]
        getattr(parent_lib, fn).restype = ci
    parent_lib.pk2_latfb_max_slots.argtypes = [ci]
    parent_lib.pk2_latfb_max_slots.restype = ci
    parent_lib._pk2_typed = True
    dev = torch.device("cuda", 0)
    current_lib = KC._lib()
    gen = torch.Generator(device=dev).manual_seed(0)
    b, t, k = C.SE_B, C.SE_T, C.SE_PROBE_KA

    def ints(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=dev, dtype=torch.int32)

    probe = FL.TimeSyncLattice(
        src=ints(k, (b, t, k)), dst=ints(k, (b, t, k)), pdf=ints(C.SENONES, (b, t, k)),
        weight=torch.randn(b, t, k, generator=gen, device=dev) * 0.1,
        final=torch.zeros(b, k, device=dev))
    bands = {"padded_lattice": C.padded_lattice(dev),
             "probe": (torch.randn(b, t, C.SENONES, generator=gen, device=dev) * 0.1, probe,
                       torch.full((b,), t, dtype=torch.int32, device=dev),
                       ints(C.SENONES, (b, t)))}
    for label, (obs, lat, nf, ref) in bands.items():
        band = FL._band(obs, lat)
        active = FL._active_ts(t, nf)
        arc_acc = FL._arc_acc_ts(lat, ref, "pdf", None, None)
        ks = lat.num_slots
        args8, args10 = C.latfb_bwd_args(band, active, arc_acc, lat,
                                         KC.logz_fwd_plain(*band, active, ks),
                                         KC.smbr_fwd_plain(*band, active, arc_acc, ks))
        shape = f"{label} B={b} T={t} K={ks} A={lat.src.shape[2]}"
        calls = {"k7": lambda: KC.logz_fwd(*band, active, ks),
                 "k8": lambda: KC.occupancies_bwd(*args8),
                 "k9": lambda: KC.smbr_fwd(*band, active, arc_acc, ks),
                 "k10": lambda: KC.smbr_contribs_bwd(*args10)}
        for what in (w for w in ("k7", "k8", "k9", "k10") if w in kernels):

            def run(lib, call=calls[what]):
                D._LIBS["latfb"] = lib
                out = call()
                D._LIBS["latfb"] = current_lib
                return out

            old, new = run(parent_lib), run(current_lib)
            torch.cuda.synchronize()
            name = f"{what.upper()} {label}"
            if what == "k7":
                C.close_log(f"{name} alphas earlier vs current", new[0], old[0])
                C.close(f"{name} norms earlier vs current", new[1], old[1], C.LAT_TOL["log"],
                        C.LAT_TOL["log"])
            elif what == "k9":
                C.close_log(f"{name} alphas earlier vs current", new[0], old[0])
                C.close(f"{name} aaccs earlier vs current", new[1], old[1], C.LAT_TOL["abs"],
                        C.LAT_TOL["rel"])
                C.close(f"{name} norms earlier vs current", new[2], old[2], C.LAT_TOL["log"],
                        C.LAT_TOL["log"])
            elif what == "k8":
                C.close(f"{name} gamma earlier vs current", new, old, C.LAT_TOL["abs"],
                        C.LAT_TOL["rel"])
            else:
                C.close(f"{name} contrib earlier vs current", new, old,
                        C.LAT_TOL["abs"] * torch.clamp(args10[-1].abs(), min=1.0)[None],
                        C.LAT_TOL["rel"])
            turns(f"{what.upper()} {shape}", lambda: run(parent_lib), lambda: run(current_lib),
                  10)


def fbank_ab(parent_lib, parent_first: bool, kernels: list) -> None:
    """K1 (80-bin fbank) and K4 (mfcc_hires), those named in ``kernels``, at
    chip_smoke's FRONT_SHAPES; a first-design parent is launched with its
    own C arguments."""
    import numpy as np
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.frontend import fused as F

    dev = torch.device("cuda", 0)
    current_lib = F._lib()
    if not parent_first:
        F._declare(parent_lib)
    rng = np.random.RandomState(0)
    for what in (w for w in ("k1", "k4") if w in kernels):
        mfcc = what == "k4"
        opts = C.mfcc_opts(C.MFCC_HIRES) if mfcc else C.fbank_opts()
        fn = F.fused_mfcc if mfcc else F.fused_fbank
        for b, t in C.FRONT_SHAPES:
            wave = C.front_wave(rng, b, t, opts.frame_opts, dev)

            def run(lib, wave=wave):
                if lib is parent_lib and parent_first:
                    return first_fbank_call(lib, wave, opts)
                D._LIBS["fbank"] = lib
                out = fn(wave, opts)
                D._LIBS["fbank"] = current_lib
                return out

            old, new = run(parent_lib), run(current_lib)
            torch.cuda.synchronize()
            tol = C.TOL["mfcc" if mfcc else "fbank"]
            err = float((old - new).abs().max())
            label = f"{what.upper()} B={b} x {t} frames"
            print(f"{label} earlier vs current: max abs difference {err:.3e} (tolerance {tol:g})",
                  flush=True)
            if err > tol:
                raise SystemExit(f"{label}: the earlier and the current kernel disagree")
            turns(f"{label}, eager calls", lambda: run(parent_lib), lambda: run(current_lib), 20)
            turns(f"{label}, CUDA graph", lambda: run(parent_lib), lambda: run(current_lib), 20,
                  graph=True)


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
    ap.add_argument("--what", default="k1,k4,k5,k6,k7,k8,k9,k10,k11")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    from pykaldi2_tpu_torch import device as D

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    D.resolve_device("cuda")
    D.build_all()
    what = args.what.split(",")
    if {"k1", "k4"} & set(what):
        fbank_ab(build(args.parent, "fbank", args.out), is_first_fbank(args.parent), what)
    if "k5" in what or "k6" in what:
        lstm_parent = build(args.parent, "lstm", args.out)
        if "k5" in what:
            k5_ab(lstm_parent)
        if "k6" in what:
            k6_ab(lstm_parent)
    if {"k7", "k8", "k9", "k10"} & set(what):
        latfb_ab(build(args.parent, "latfb", args.out), what)
    if "k11" in what:
        with open(os.path.join(args.parent, "blockfb.cu")) as f:
            takes_rowptr = "segdesc" not in f.read()
        k11_ab(build(args.parent, "blockfb", args.out), takes_rowptr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
