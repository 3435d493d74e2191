"""Split a hand-written kernel's time into its parts with clock64() stamps.

    python3 tools/kernel_split.py [--src DIR] [--what k1,k4,k5,k6,k7,k8,k9,k10,k11] \
        [--out build/split]
    python3 tools/kernel_split.py --src <csrc of commit 7ff1e87> --what k6_first,k11_first
    python3 tools/kernel_split.py --src <csrc of commit 7f9f2ed> --what k5_first,k9_first
    python3 tools/kernel_split.py --src <csrc of commit 3c9d343> \
        --what k8_first,k8_first_nopad,k10_first,k10_first_nopad
    python3 tools/kernel_split.py --src <csrc of commit 714a141> --what k7_first,k1_first,k4_first

Copies ``fbank.cu``, ``lstm.cu``, ``latfb.cu`` or ``blockfb.cu`` from ``--src`` (default: the port's
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
  k1, k4  ``fbank_kernel<R, false>`` (80-bin fbank) / ``<R, true>``
       (mfcc_hires) at chip_smoke's FRONT_SHAPES (64 x 80 frames, one
       1,230-frame utterance), cycles a CTA (thread 0 is a consumer),
       buckets: set-up, framing pass 1 (gathers of two rows) and pass 2,
       frames barrier, per 16-row chunk the ring wait, FMAs and stage
       release, drain, spectrum, banded mel (K4: and the DCT);
  k1_first, k4_first  ``fbank_kernel<kMfcc>`` as in commit 714a141 (32 rows
       a CTA, a bin a thread), launched with its own C arguments, buckets:
       framing, DFT and power, mel product (K4: and the DCT);
  k5   ``lstmp_fwd_kernel`` at B=64, T=80, H=1024, P=512 (one BLSTMP layer
       direction), cycles a step per CTA;
  k7, k9  ``band_fwd_kernel<false>`` / ``<true>`` on chip_smoke's
       ``padded_lattice`` (B=32, T=448, K=256, A=512, ~74% of the band live
       arcs, padding at slot 0), cycles a frame per CTA, buckets: ring wait
       + barrier 0, pass 1, barrier 1, block max, pass 2 (atomics), barrier
       2, slot pass, barrier 3, blend and stores, inactive frames;
  k7_first  ``logz_fwd_kernel`` as in commit 714a141, buckets: first pass
       (loads, scores), first ``block_max``, arc pass (reloads, gathers,
       atomics), slot_logs, blend and stores;
  k8, k10  ``band_bwd_kernel<false>`` / ``<true>`` on the same band, fed the
       plain forwards' residuals, cycles a frame per CTA, k9's buckets with
       the ring wait (and the loop's top) apart from barrier 0 (pass 1 also
       stores gamma or the contributions; inactive frames write 0s);
  k8_first, k10_first  ``occupancies_bwd_kernel`` / ``smbr_bwd_kernel`` as in
       commit 3c9d343, buckets: first pass (loads, scores), first
       ``block_max``, arc pass (reloads, alpha_prev/aacc_prev gathers, store,
       atomics), slot_logs (K10: with the ratios), blend; ``_nopad`` keeps
       padding arcs out of the atomics (an experiment: an active frame of
       padding only then differs);
  k9_first  ``smbr_fwd_kernel`` as in commit 7f9f2ed;
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
# K9 as PR 2 wrote it (one CTA of 512 threads per utterance, six barriers a frame)
K9_FIRST = [
    ("float norm = 0.f;", "after", "PK2_T0;"),
    ("lmax = fmaxf(lmax, alpha[src[off + a]] + w[off + a] + obs[off + a]);", "after",
     "PK2_STAMP(0);"),
    ("const float mx = fmaxf(block_max(lmax, red), kNegInf);", "after", "PK2_STAMP(1);"),
    ("atomicAdd(&num[d], lin * acc_in);", "after+2", "PK2_STAMP(2);"),
    ("const float m2 = slot_logs(sum, K, mx, red);", "after", "PK2_STAMP(3);"),
    ("if (tid == 0) norms[row] = norm;", "after+1", "PK2_STAMP(4);"),
]

# K7's first design, as in commit 714a141 (K9_FIRST's loop without the accuracy carry)
K7_FIRST = [
    ("float norm = 0.f;", "after", "PK2_T0;"),
    ("lmax = fmaxf(lmax, alpha[src[off + a]] + w[off + a] + obs[off + a]);", "after",
     "PK2_STAMP(0);"),
    ("const float mx = fmaxf(block_max(lmax, red), kNegInf);", "after", "PK2_STAMP(1);"),
    ("atomicAdd(&sum[dst[off + a]], expf(s - mx));", "after+2", "PK2_STAMP(2);"),
    ("const float m2 = slot_logs(sum, K, mx, red);", "after", "PK2_STAMP(3);"),
    ("if (tid == 0) norms[row] = norm;", "after+1", "PK2_STAMP(4);"),
]

# K1 and K4's first design, as in commit 714a141 (one template; K4 adds the DCT)
K1_FIRST = [
    ("const unsigned full = 0xffffffffu;", "after", "PK2_T0;"),
    ("__syncthreads();", "after", "PK2_STAMP(0);"),
    ("for (int r = 0; r < FB_ROWS; ++r) spec[r * K + k] = re[r] * re[r] + im[r] * im[r];",
     "after+2", "PK2_STAMP(1);"),
    ("if (!kMfcc) return;", "before", "PK2_STAMP(2);"),
]
K4_FIRST = K1_FIRST + [
    ("out[(size_t)row * C + c] = (use_energy && c == 0) ? elog[r] : acc;", "after+1",
     "PK2_STAMP(3);"),
]

# K8 and K10's first design, as in commit 3c9d343 (K9_FIRST's loop shape, in reverse)
K8_FIRST = [
    ("float bnorm = 0.f;", "after", "PK2_T0;"),
    ("lmax = fmaxf(lmax, (w[off + a] + obs[off + a]) + beta[dst[off + a]]);", "after",
     "PK2_STAMP(0);"),
    ("const float mx = fmaxf(block_max(lmax, red), kNegInf);", "after", "PK2_STAMP(1);"),
    ("gamma[off + a] = act * expf(fminf(lg, 0.f));", "after+2", "PK2_STAMP(2);"),
    ("const float m2 = slot_logs(sum, K, mx, red);", "after", "PK2_STAMP(3);"),
    ("bnorm = bnorm + act * m2;", "after+1", "PK2_STAMP(4);"),
]
K10_FIRST = K8_FIRST[:3] + [
    ("atomicAdd(&num[s], lin * (acc + bcd));", "after+2", "PK2_STAMP(2);"),
] + K8_FIRST[4:]

# the current K7 and K9, one template: the stamps run in the instantiation
# that the wrapper launches
BAND_FWD = [
    ("float act_next = active[b];", "after", "PK2_T0;"),
    ("__syncthreads();  // B0: ... in every thread, and the last frame's carries are final",
     "after", "PK2_STAMP(0);"),
    ("continue;", "before", "PK2_STAMP(9);"),
    ("post_warp_max(lmax, red);", "after", "PK2_STAMP(1);"),
    ("__syncthreads();  // B1: the posts are in; no thread reads this frame's stage again",
     "after", "PK2_STAMP(2);"),
    ("const float mx = fmaxf(read_block_max(red), kNegInf);", "after", "PK2_STAMP(3);"),
    ("__syncthreads();  // B2: every arc is in its slot", "before", "PK2_STAMP(4);"),
    ("__syncthreads();  // B2: every arc is in its slot", "after", "PK2_STAMP(5);"),
    ("post_warp_max(lm, red);", "after", "PK2_STAMP(6);"),
    ("__syncthreads();  // B3: the slots' maxima are in", "after", "PK2_STAMP(7);"),
    ("if (tid == 0) norms[row] = norm;", "after", "PK2_STAMP(8);"),
]

# the current K1 and K4, one template (K4 adds the DCT); thread 0 is a consumer
FBANK = [
    ("const int nchunks = p.Wp / kChunk;", "after", "PK2_T0;"),
    ("else __syncthreads();", "after", "PK2_STAMP(9);"),
    ("float s[2] = {0.f, 0.f};", "after", "PK2_STAMP(11);"),
    ("s[h] += v[h][u];", "after+3", "PK2_STAMP(10);"),
    ("asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(kConsumers) : \"memory\");  // the frames are in",
     "before", "PK2_STAMP(0);"),
    ("asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(kConsumers) : \"memory\");  // the frames are in",
     "after", "PK2_STAMP(2);"),
    ("mbar_wait(full_bar + stage, (q / kStages) & 1);  // chunk q has landed", "after",
     "PK2_STAMP(1);"),
    ("acc[i][7] = fmaf(xv[i], t1.w, acc[i][7]);", "after+2", "PK2_STAMP(4);"),
    ("for (int j = 0; j < CM; ++j) mbar_arrive_remote(empty_bar + stage, crank + CL * j);",
     "after+1", "PK2_STAMP(3);"),
    ("else __syncthreads();", "after", "PK2_STAMP(5);"),
    ("else __syncthreads();", "after", "PK2_STAMP(6);"),
    ("if (!kMfcc) return;", "before", "PK2_STAMP(7);"),
]

# the current K8 and K10, one template: the stamps run in the instantiation
# that the wrapper launches
BAND_BWD = [
    ("float an_next = anorm_prev[static_cast<size_t>(T - 1) * B + b];", "after", "PK2_T0;"),
    ("if (S > 0) ring.wait(pos.slot, pos.parity);  // position i's stage has landed", "after",
     "PK2_STAMP(10);"),
    ("__syncthreads();  // B0: ... in every thread, and the last frame's carries are final",
     "after", "PK2_STAMP(0);"),
    ("continue;", "before", "PK2_STAMP(9);"),
    ("post_warp_max(lmax, red);", "after", "PK2_STAMP(1);"),
    ("__syncthreads();  // B1: the posts are in; no thread reads this frame's stage again",
     "after", "PK2_STAMP(2);"),
    ("const float mx = fmaxf(read_block_max(red), kNegInf);", "after", "PK2_STAMP(3);"),
    ("__syncthreads();  // B2: every arc is in its slot", "before", "PK2_STAMP(4);"),
    ("__syncthreads();  // B2: every arc is in its slot", "after", "PK2_STAMP(5);"),
    ("post_warp_max(lm, red);", "after", "PK2_STAMP(6);"),
    ("__syncthreads();  // B3: the slots' maxima are in", "after", "PK2_STAMP(7);"),
    ("bnorm = bnorm + act * m2;", "after", "PK2_STAMP(8);"),
]

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
    "k5": ("lstmp_fwd_kernel(const float* __restrict__ xp", [
        ("float c_r[4] = {0.f, 0.f, 0.f, 0.f};", "after", "PK2_T0;"),
        ("for (int t = 0; t < T; ++t) {", "after", "PK2_STAMP(7);"),
        ("if (own[i]) m2[i] = mask[(size_t)t * ldb + pb[i]];", "after", "PK2_STAMP(0);"),
        ("// the gate plane, read back by the threads of the gate math", "before",
         "PK2_STAMP(1);"),
        ("grid.sync();", "before", "PK2_STAMP(2);"),
        ("grid.sync();", "after", "PK2_STAMP(3);"),
        ("cluster.sync();", "before", "PK2_STAMP(4);"),
        ("cluster.sync();", "after", "PK2_STAMP(5);"),
        ("if (t + 1 < T) grid.sync();", "before", "PK2_STAMP(6);"),
    ]),
    "k7": ("__global__ void __launch_bounds__(kThreads) band_fwd_kernel(", BAND_FWD),
    "k9": ("__global__ void __launch_bounds__(kThreads) band_fwd_kernel(", BAND_FWD),
    "k1": ("__global__ void __launch_bounds__(kThreads, 1) fbank_kernel(", FBANK),
    "k4": ("__global__ void __launch_bounds__(kThreads, 1) fbank_kernel(", FBANK + [
        ("p.out[static_cast<size_t>(row) * p.C + c] = (p.use_energy && c == 0) ? elog[r] : a;",
         "after+1", "PK2_STAMP(8);"),
    ]),
    "k8": ("__global__ void __launch_bounds__(kThreads, 1) band_bwd_kernel(", BAND_BWD),
    "k10": ("__global__ void __launch_bounds__(kThreads, 1) band_bwd_kernel(", BAND_BWD),
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
    "k5_first": ("lstmp_fwd_kernel(const float* __restrict__ xp", [
        ("for (int i = 0; i < MAX_HP; ++i) hp_r[i] = 0.f;", "after", "PK2_T0;"),
        ("stage_rows(Xs, ldp, hpbuf, P, mtiles * 16, nb, P);", "after+1", "PK2_STAMP(0);"),
        ("c0[8 * NCOL + 1] = acc[i][3];", "after+3", "PK2_STAMP(1);"),
        ("grid.sync();", "before", "PK2_STAMP(2);"),
        ("grid.sync();", "after", "PK2_STAMP(3);"),
        ("stage_owned(Xs, ldh, hfull + (size_t)t * ldb * H, H, role, nb, H);", "after+1",
         "PK2_STAMP(4);"),
        ("grid.sync();", "before", "PK2_STAMP(5);"),
        ("grid.sync();", "after", "PK2_STAMP(6);"),
    ]),
    "k9_first": ("__global__ void __launch_bounds__(kThreads) smbr_fwd_kernel(", K9_FIRST),
    # the same, with padding arcs (weight NEG_INF) kept out of the atomic
    # pass: an experiment only (an active frame of padding arcs then differs)
    "k9_first_nopad": ("__global__ void __launch_bounds__(kThreads) smbr_fwd_kernel(",
                       K9_FIRST[:3] + [
        ("atomicAdd(&sum[d], lin);", "before", "if (w[off + a] > 0.5f * kNegInf) {"),
        ("atomicAdd(&num[d], lin * acc_in);", "after", "}"),
        ("__syncthreads();", "after", "PK2_STAMP(2);"),
    ] + K9_FIRST[4:]),
    "k7_first": ("__global__ void __launch_bounds__(kThreads) logz_fwd_kernel(", K7_FIRST),
    "k1_first": ("fbank_kernel(const float* __restrict__ wave,", K1_FIRST),
    "k4_first": ("fbank_kernel(const float* __restrict__ wave,", K4_FIRST),
    "k8_first": ("__global__ void __launch_bounds__(kThreads) occupancies_bwd_kernel(", K8_FIRST),
    # padding arcs kept out of the atomic (an experiment, as k9_first_nopad)
    "k8_first_nopad": ("__global__ void __launch_bounds__(kThreads) occupancies_bwd_kernel(",
                       K8_FIRST[:3] + [
        ("atomicAdd(&sum[s], expf(ow + bd - mx));", "before",
         "if (w[off + a] > 0.5f * kNegInf)"),
    ] + K8_FIRST[3:]),
    "k10_first": ("__global__ void __launch_bounds__(kThreads) smbr_bwd_kernel(", K10_FIRST),
    "k10_first_nopad": ("__global__ void __launch_bounds__(kThreads) smbr_bwd_kernel(",
                        K10_FIRST[:3] + [
        ("atomicAdd(&sum[s], lin);", "before", "if (lin != 0.f) {"),
        ("atomicAdd(&num[s], lin * (acc + bcd));", "after", "}"),
        ("__syncthreads();", "after", "PK2_STAMP(2);"),
    ] + K10_FIRST[4:]),
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
    "k5": ["per-frame loads issued", "phase-1 product (staging + mma)",
           "gate plane + gate math + stores", "barrier 1",
           "phase-2 product + DSMEM push", "cluster barrier", "local sum + hp epilogue",
           "barrier 2"],
    "k9": ["ring wait + barrier 0", "pass 1 (scores, warp max)", "barrier 1",
           "block max", "pass 2 (atomics)", "barrier 2",
           "slot pass (ratio, log, warp max)", "barrier 3", "blend + stores",
           "inactive frame (carries out)"],
    "k7": ["ring wait + barrier 0", "pass 1 (scores, warp max)", "barrier 1",
           "block max", "pass 2 (atomics)", "barrier 2", "slot pass (log, warp max)",
           "barrier 3", "blend + stores", "inactive frame (carries out)"],
    "k1": ["framing: last pair's pass 2", "chunk wait", "frames barrier", "stage released",
           "FMA (16 table rows)", "drain + barrier", "power spectrum out + barrier",
           "banded mel + log + store", "-", "set-up (mbarriers, mel bands)",
           "framing pass 1 (gathers of two rows)", "framing pass 2 (the pair before)"],
    "k4": ["framing: last pair's pass 2", "chunk wait", "frames barrier", "stage released",
           "FMA (16 table rows)", "drain + barrier", "power spectrum out + barrier",
           "banded mel + log", "DCT + store", "set-up (mbarriers, mel bands)",
           "framing pass 1 (gathers of two rows)", "framing pass 2 (the pair before)"],
    "k8": ["barrier 0", "pass 1 (scores, gamma out, warp max)", "barrier 1",
           "block max", "pass 2 (atomics)", "barrier 2", "slot pass (log, warp max)",
           "barrier 3", "blend", "inactive frame (zeros out)", "loop top + ring wait"],
    "k10": ["barrier 0", "pass 1 (scores, contributions out, warp max)",
            "barrier 1", "block max", "pass 2 (atomics)", "barrier 2",
            "slot pass (ratio, log, warp max)", "barrier 3", "blend",
            "inactive frame (zeros out)", "loop top + ring wait"],
    "k5_first": ["staging hp", "gate product", "gate math (xp loaded)", "barrier 1",
                 "staging h_full", "projection + partial sums", "barrier 2"],
    "k7_first": ["first pass (loads, scores)", "first block_max",
                 "arc pass (reloads, gathers, atomics)", "slot_logs", "blend + stores"],
    "k1_first": ["framing (index table, two passes)", "DFT + power (a bin a thread)",
                 "mel product + log + store"],
    "k4_first": ["framing (index table, two passes)", "DFT + power (a bin a thread)",
                 "mel product + log", "DCT + store"],
    "k9_first": ["first pass (loads, scores)", "first block_max", "atomic pass",
                 "ratios + slot_logs", "blend + stores"],
    "k9_first_nopad": ["first pass (loads, scores)", "first block_max",
                       "atomic pass, padding left out", "ratios + slot_logs", "blend + stores"],
    "k8_first": ["first pass (loads, scores)", "first block_max",
                 "arc pass (reloads, gathers, stores, atomics)", "slot_logs", "blend"],
    "k8_first_nopad": ["first pass (loads, scores)", "first block_max",
                       "arc pass, padding left out", "slot_logs", "blend"],
    "k10_first": ["first pass (loads, scores)", "first block_max",
                  "arc pass (reloads, gathers, stores, atomics)", "ratios + slot_logs",
                  "blend"],
    "k10_first_nopad": ["first pass (loads, scores)", "first block_max",
                        "arc pass, padding left out", "ratios + slot_logs", "blend"],
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

    name = {"k1": "fbank", "k4": "fbank", "k5": "lstm", "k6": "lstm", "k7": "latfb",
            "k8": "latfb", "k9": "latfb", "k10": "latfb"}.get(what.split("_")[0], "blockfb")
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
    if name == "lstm":  # the entry points the LSTMP wrappers call
        out.pk2_lstm_max_batch.restype = ci
        out.pk2_lstmp_fwd.argtypes = [vp] * 9 + [ci] * 5 + [vp]
        out.pk2_lstmp_fwd.restype = ci
        out.pk2_lstmp_bwd.argtypes = [vp] * 10 + [ci] * 5 + [vp]
        out.pk2_lstmp_bwd.restype = ci
        out._pk2_typed = True
    elif name == "latfb":  # the entry points K7-K10's wrappers call, in every version
        for fn, n_ptr in (("pk2_latfb_logz_fwd", 7), ("pk2_latfb_occupancies_bwd", 10),
                          ("pk2_latfb_smbr_fwd", 9), ("pk2_latfb_smbr_bwd", 13)):
            getattr(out, fn).argtypes = [vp] * n_ptr + [ci] * 4 + [vp]
            getattr(out, fn).restype = ci
        out.pk2_latfb_max_slots.argtypes = [ci]
        out.pk2_latfb_max_slots.restype = ci
        out._pk2_typed = True
    elif name == "fbank":  # a first K1/K4 is typed where it is launched
        if not what.endswith("_first"):
            from pykaldi2_tpu_torch.frontend.fused import _declare

            _declare(out)
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


def k5_ctas(what: str, h: int) -> int:
    return h // 8 if what == "k5_first" else h // 16


def run_k5(what: str, src: str, out: str, calls: int = 5):
    import numpy as np
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.ops import lstm_cuda as L

    dev = torch.device("cuda", 0)
    t, b, h, p = C.T, C.B, C.H, C.PROJ
    rng = np.random.RandomState(2)
    xp = torch.tensor((rng.randn(t, b, 4 * h) * 0.5).astype(np.float32), device=dev)
    wh = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (p, 4 * h)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    wp = torch.tensor(rng.uniform(-1 / 32, 1 / 32, (h, p)).astype(np.float32),
                      device=dev).to(torch.bfloat16)
    mask = torch.ones(t, b, device=dev)
    fn = lambda: L.lstm_proj_fwd(xp, wh, wp, mask)  # noqa: E731
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
    ctas = k5_ctas(what, h)
    total = report(what, f"B={b} T={t} H={h} P={p}", raw, calls, "a step per CTA", ctas * t, ms)
    print(f"  implied SM clock {total / calls / ctas / (ms * 1e-3) / 1e9:.3f} GHz "
          f"(cycles per CTA over the event time)", flush=True)


def run_latfb(what: str, src: str, out: str, calls: int = 3):
    import torch

    import chip_smoke as C
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.ops import fb_lattice as FL
    from pykaldi2_tpu_torch.ops import fb_lattice_cuda as KC

    dev = torch.device("cuda", 0)
    obs, lat, nf, ref = C.padded_lattice(dev)
    b, t, _p = obs.shape
    k, a = lat.num_slots, lat.src.shape[2]
    band = FL._band(obs, lat)
    active = FL._active_ts(t, nf)
    arc_acc = FL._arc_acc_ts(lat, ref, "pdf", None, None)
    kernel = what.split("_")[0]
    if kernel == "k7":
        fn = lambda: KC.logz_fwd(*band, active, k)  # noqa: E731
    elif kernel == "k9":
        fn = lambda: KC.smbr_fwd(*band, active, arc_acc, k)  # noqa: E731
    else:  # the backward kernels take the plain forwards' residuals
        args8, args10 = C.latfb_bwd_args(band, active, arc_acc, lat,
                                         KC.logz_fwd_plain(*band, active, k),
                                         KC.smbr_fwd_plain(*band, active, arc_acc, k))
        fn = ((lambda: KC.occupancies_bwd(*args8)) if kernel == "k8"
              else (lambda: KC.smbr_contribs_bwd(*args10)))
    base = D._LIBS.get("latfb")
    D._LIBS["latfb"] = build(src, out, what, stamped=False)
    ms = C.timed(fn, n=10)
    split = D._LIBS["latfb"] = build(src, out, what)
    fn()
    take(split)
    for _ in range(calls):
        fn()
    raw = take(split)
    D._LIBS["latfb"] = base
    report(what, f"padded_lattice B={b} T={t} K={k} A={a}", raw, calls, "a frame per CTA",
           b * t, ms)


def run_fbank(what: str, src: str, out: str, calls: int = 5):
    """K1 (80-bin fbank) or K4 (mfcc_hires) at chip_smoke's FRONT_SHAPES,
    cycles a CTA; a ``_first`` version is launched with its own C arguments."""
    import numpy as np
    import torch

    import chip_smoke as C
    import kernel_ab as AB
    from pykaldi2_tpu_torch import device as D
    from pykaldi2_tpu_torch.frontend import fused as F

    dev = torch.device("cuda", 0)
    mfcc = what.startswith("k4")
    opts = C.mfcc_opts(C.MFCC_HIRES) if mfcc else C.fbank_opts()
    plain, split = build(src, out, what, stamped=False), build(src, out, what)
    base = D._LIBS.get("fbank")

    def call(lib):
        if what.endswith("_first"):
            return AB.first_fbank_call(lib, wave, opts)
        D._LIBS["fbank"] = lib
        got = (F.fused_mfcc if mfcc else F.fused_fbank)(wave, opts)
        D._LIBS["fbank"] = base
        return got

    rng = np.random.RandomState(0)
    for b, t in C.FRONT_SHAPES:
        wave = C.front_wave(rng, b, t, opts.frame_opts, dev)
        ms = C.timed(lambda: call(plain))
        call(split)
        take(split)
        for _ in range(calls):
            call(split)
        raw = take(split)
        ctas = raw[32] / calls  # thread 0 of every CTA passes stamp 0 once a call
        report(what, f"B={b} x {t} frames ({ctas:.0f} CTAs)", raw, calls, "a CTA", ctas, ms)


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
    ap.add_argument("--what", default="k1,k4,k5,k6,k7,k8,k9,k10,k11")
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
        run = {"k1": run_fbank, "k4": run_fbank, "k5": run_k5, "k6": run_k6, "k7": run_latfb,
               "k8": run_latfb, "k9": run_latfb, "k10": run_latfb}.get(what.split("_")[0],
                                                                      run_k11)
        run(what, args.src, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
