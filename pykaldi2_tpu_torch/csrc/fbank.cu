// Fused log-mel filterbank (kernel K1) and fused MFCC (kernel K4) for
// sm_90a, plain C interface for ctypes.
//
// Replaces: pykaldi2_tpu/frontend/fused.py:_kernel (the Pallas fused fbank,
// K1) and :_mfcc_kernel (the Pallas fused MFCC, K4).
// K1 computes, per frame row: framing (each frame's sample indices as
// frontend/window.py:_frame_indices gives them: shift, offset, reflection
// at the ends), DC removal over the real window, pre-emphasis, the analysis
// window, the real DFT as cos/sin products, the power spectrum, the mel
// product and a log with a FLT_EPSILON floor. Only the log-mel rows reach
// device memory.
// K4 is K1 plus two steps: the raw log-energy of each row (the sum of
// squares after DC removal and before pre-emphasis, floored at FLT_EPSILON
// before the log and at log(energy_floor) after it), and the product of the
// log-mel row with the DCT matrix (lifter folded in, [M, C]) while the row
// is still in shared memory; column 0 becomes the log-energy when
// use_energy. Only the C cepstra of a row reach device memory.
//
// Bound on the H100: fp32 operations. The front end is fp32-exact by
// contract, so there are no tensor cores, no TF32 and no fast math: every
// product is an fp32 FMA. The DFT is 2*rows*W*K*2 flops; the mel product,
// taken over each filter's nonzero bins only, is 2*rows*nnz (nnz ~ K + M);
// K4 adds 2*rows*M*C for the DCT, against ~67 TFLOP/s of fp32 FMA (the
// bound chip_smoke.py charges). The bytes moved (waveform in, features
// out, <1 MB of tables) are a few MB.
//
// Design. The DFT is a product [rows, W] x [W, 2Kp] of the framed rows with
// one table whose columns interleave cos and -sin of each bin (Kp: K
// rounded up to a power of two, W up to Wp, a multiple of kChunk; the
// padding is zeros and adds nothing), stored in blocks of 64 columns. A CTA
// is 8 consumer warps and one producer warp. It takes a tile of RT rows and
// a share of Cc = 2Kp/CL columns; CL CTAs share a row tile only where 2Kp
// exceeds the 512 columns of 8 warps (K > 256: above 16 kHz), and the
// spectrum of the tile then ends in every one of them over DSMEM, each
// taking a share of the tile's rows through the epilogue. CM CTAs of a cluster with the
// same columns take CM row tiles and share one stream of the table: each
// producer copies 1/CM of every chunk into all of them (cp.async.bulk
// multicast), so that the table is read from L2 once per group. The host
// picks (R, CL, CM) per call from the row count and the card's SM count
// (pick_tile): a CE batch of 64 x 80 frames and one 1,230-frame utterance
// take different tiles.
// - Framing: one warp per row, two rows at once so that their loads are in
//   flight together, stores the row's samples into the tile's shared-memory
//   columns ([n][row]), then centres, pre-emphasises (neighbour through a
//   warp shuffle) and windows them in place, 16 samples a lane at a time.
// - Product: the producer streams the table through a kStages-deep ring
//   (full/empty mbarriers; the empty ones count every consumer warp of the
//   multicast group). Each consumer thread holds an R x 8 register tile (R
//   rows, four bins as cos/sin pairs), so cos and sin of a bin meet in one
//   thread and the power forms in registers. A warp is 4 row groups x 8
//   column groups: its table reads are 128-byte rows shared by the row
//   groups, its frame reads 4 x R floats.
// - Mel: each filter's weights are nonzero on one run of bins [lo, hi)
//   (built on the host, staged in shared memory); the sum runs over that
//   run in ascending k, which gives the dense product's value bit for bit
//   (fmaf(x, 0, acc) == acc).
// Sums run in a fixed order and there are no atomics: two calls on the
// same input give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                 // warps that frame and multiply
constexpr int kConsumers = kWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and one warp that fills the ring
constexpr int kChunk = 16;     // table rows a ring stage holds
constexpr int kStages = 3;
constexpr int kBarWords = 4 * kStages;  // full and empty mbarriers, 8 bytes each
constexpr int kFrameBatch = 16;  // samples a lane holds at once in the framing
constexpr int kMaxSmemBytes = 232448;

struct FbankArgs {
  const float* wave;   // [B, S]
  const float* win;    // [W] analysis window
  const float* cs;     // [Wp, 2Kp] cos / -sin of bin k in columns 2k, 2k+1, as [2Kp/64][Wp][64]
  const float* melw;   // [nnz] each filter's weights over its bins [lo, hi), in filter order
  const int* mband;    // [M, 3] each filter's lo, hi and offset into melw
  const float* dctT;   // [M, C] lifted DCT, transposed (K4)
  float* out;          // [B*T, M] (K1) or [B*T, C] (K4)
  int B, S, T, W, Wp, K, Kp, M, C, nnz;
  int shift, first;  // frame t starts at sample t * shift + first (reflected at the ends)
  int remove_dc;
  float preemph, log_floor;
  int use_energy;
  float log_energy_floor;
  int cl;  // CTAs a row tile, each with a share of the columns
  int cm;  // row tiles of a cluster, which share one stream of the table
};

// The tile of a launch: R rows a thread, CL CTAs a row tile, Cc columns a
// CTA (WC warps across them, WR warps down the RT rows), CM row tiles a
// cluster (of CL * CM CTAs) sharing the table's stream, and the shared
// memory a CTA takes, in words after the ring's mbarriers: the
// frames [Wp][ldx], the log-energies [RT], the mel bands and the window,
// then the ring
// [kStages][Cc/64][kChunk][64], whose space the spectrum [RT][lds] (and K4's
// log-mel rows [RT][M]) takes after the product.
struct Tile {
  int R, CL, CM, Cc, WC, WR, RT, ldx, lds;
  size_t xs_words, elog_words, mel_words, ring_words, post_words;

  size_t smem() const {
    const size_t tail = ring_words > post_words ? ring_words : post_words;
    return (kBarWords + xs_words + elog_words + mel_words + tail) * sizeof(float);
  }
};

// false when (R, CL, CM) cannot tile a Kp-bin table in one CTA's shared memory
bool make_tile(int R, int CL, int CM, int Wp, int Kp, int M, int nnz, bool mfcc, Tile* t) {
  if ((2 * Kp) % CL != 0) return false;
  t->R = R;
  t->CL = CL;
  t->CM = CM;
  t->Cc = 2 * Kp / CL;
  if (t->Cc < 64 || t->Cc > 512) return false;
  t->WC = t->Cc / 64;
  t->WR = kWarps / t->WC;
  t->RT = 4 * R * t->WR;
  t->ldx = t->RT + 4;  // float2-aligned rows that spread banks
  t->lds = Kp + 1;
  t->xs_words = static_cast<size_t>(Wp) * t->ldx;
  t->elog_words = (t->RT + 3) / 4 * 4;
  t->mel_words = (static_cast<size_t>(nnz) + 3 * M + Wp + 3) / 4 * 4;
  t->ring_words = static_cast<size_t>(kStages) * kChunk * t->Cc;
  t->post_words =
      static_cast<size_t>(t->RT) * t->lds + (mfcc ? static_cast<size_t>(t->RT) * M : 0);
  return t->smem() <= static_cast<size_t>(kMaxSmemBytes);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// the mbarrier has completed the phase of the given parity
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned mb = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mb), "r"(parity) : "memory");
  } while (!done);
}

// the same, ordered after the arrivals of other CTAs of the cluster
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar, unsigned parity) {
  const unsigned mb = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mb), "r"(parity) : "memory");
  } while (!done);
}

// an arrival on the mbarrier at the same place in CTA `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_remote(unsigned long long* bar, int cta) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// The producer's fill of a ring stage: nblk column blocks of kChunk x 64
// words (4 KB, contiguous in the blocked table). The stage's `full`
// mbarrier of this CTA expects all of them; this CTA copies blocks first,
// first + CM, ..., each into the same stage of every CTA in `mask` (its
// CM-CTA multicast group: one read of the table from L2 feeds them all),
// completing on their `full` mbarriers.
__device__ __forceinline__ void fill_stage(float* st, unsigned long long* full, const float* g,
                                           size_t blk_stride, int nblk, int first, int CM,
                                           unsigned short mask) {
  const unsigned mb = smem_addr(full);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
               "r"(nblk * kChunk * 64 * 4) : "memory");
  for (int b = first; b < nblk; b += CM) {
    if (CM == 1)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(st + b * kChunk * 64)),
          "l"(g + b * blk_stride), "r"(kChunk * 64 * 4), "r"(mb) : "memory");
    else
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
          "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(st + b * kChunk * 64)),
          "l"(g + b * blk_stride), "r"(kChunk * 64 * 4), "r"(mb), "h"(mask) : "memory");
  }
}

template <int R, bool kMfcc>
__global__ void __launch_bounds__(kThreads, 1) fbank_kernel(const FbankArgs p, int Cc, int RT,
                                                           int ldx, int lds, int xs_words,
                                                           int elog_words, int mel_words) {
  extern __shared__ __align__(16) unsigned long long smem_bars[];
  unsigned long long* full_bar = smem_bars;           // [kStages]: a chunk has landed
  unsigned long long* empty_bar = smem_bars + kStages;  // [kStages]: every warp is done with it
  float* xs = reinterpret_cast<float*>(smem_bars) + kBarWords;  // [Wp][ldx] frames, transposed
  float* elog = xs + xs_words;                           // [RT] raw log-energy (K4)
  float* swt = elog + elog_words;                        // [nnz] mel weights
  int* sband = reinterpret_cast<int*>(swt + p.nnz);      // [M, 3] lo, hi, offset
  float* swin = reinterpret_cast<float*>(sband + 3 * p.M);  // [W] analysis window
  float* ring = elog + elog_words + mel_words;           // [kStages][Cc/64][kChunk][64] table
  float* spec = ring;                      // after the product: [RT][lds] power spectrum
  float* lmel = spec + RT * lds;           // [RT][M] log-mel rows (K4)
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = p.cl, CM = p.cm, CS = CL * CM;
  // rank = mrank * CL + crank: crank picks the columns, mrank the row tile
  const int rank = CS > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int crank = rank % CL, mrank = rank / CL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrows = p.B * p.T;
  const int row0 = (blockIdx.x / CS * CM + mrank) * RT;
  const int nchunks = p.Wp / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + s, 1);
      mbar_init(empty_bar + s, kWarps * CM);  // every consumer warp of the multicast group
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < p.nnz; i += kThreads) swt[i] = __ldg(p.melw + i);
  for (int i = tid; i < 3 * p.M; i += kThreads) sband[i] = __ldg(p.mband + i);
  for (int i = tid; i < p.W; i += kThreads) swin[i] = __ldg(p.win + i);
  // the mbarriers are initialised, in every CTA a multicast may reach
  if (CS > 1) cluster.sync();
  else __syncthreads();

  float acc[R][8];  // the consumers' register tile: [row][re, im of four bins]
  int rbase = 0, bin0 = 0;
  if (warp == kWarps) {  // the producer: chunk q into stage q % kStages once it is free
    if (lane == 0) {
      // the table is blocked [2Kp/64][Wp][64]: this CTA's Cc columns are Cc/64 blocks
      const size_t blk_stride = static_cast<size_t>(p.Wp) * 64;
      const float* table = p.cs + static_cast<size_t>(crank) * (Cc / 64) * blk_stride;
      unsigned short mask = 0;  // the CTAs of the cluster with this CTA's columns
      for (int j = 0; j < CM; ++j) mask |= static_cast<unsigned short>(1u << (crank + CL * j));
      for (int q = 0; q < nchunks; ++q) {
        const int stage = q % kStages, use = q / kStages;
        if (use > 0) mbar_wait_cluster(empty_bar + stage, (use - 1) & 1);  // free in the group
        fill_stage(ring + stage * kChunk * Cc, full_bar + stage, table + q * kChunk * 64,
                   blk_stride, Cc / 64, mrank, CM, mask);
      }
    }
  } else {
    // 1. framing, DC removal, pre-emphasis, window: one warp per frame row,
    // two rows at once, so that their gathers are in flight together
    const unsigned full = 0xffffffffu;
    for (int r0 = warp; r0 < RT; r0 += 2 * kWarps) {
      int rr[2] = {r0, r0 + kWarps};
      bool live[2];
      const float* wb[2];
      int start[2];
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + rr[h];
        live[h] = rr[h] < RT && row < nrows;
        wb[h] = p.wave + static_cast<size_t>(live[h] ? row / p.T : 0) * p.S;
        start[h] = (live[h] ? row % p.T : 0) * p.shift + p.first;
      }
      for (int j0 = lane; j0 < p.W; j0 += 32 * kFrameBatch) {  // lane j % 32 owns sample j
        int at[2][kFrameBatch];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < kFrameBatch; ++u) {  // Kaldi reflects out-of-range samples
            int i = start[h] + j0 + 32 * u;
            i = i < 0 ? -i - 1 : i;
            i = i >= p.S ? 2 * p.S - i - 1 : i;
            at[h][u] = min(max(i, 0), p.S - 1);
          }
        float v[2][kFrameBatch];  // every load in flight before the first store
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < kFrameBatch; ++u)
            v[h][u] = live[h] && j0 + 32 * u < p.W ? __ldg(wb[h] + at[h][u]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int u = 0; u < kFrameBatch; ++u) {
            const int j = j0 + 32 * u;
            if (live[h] && j < p.W) {
              xs[j * ldx + rr[h]] = v[h][u];
              s[h] += v[h][u];
            }
          }
      }
      for (int h = 0; h < 2; ++h) {
        const int r = rr[h];
        if (r >= RT) break;
        if (!live[h]) {
          for (int j = lane; j < p.Wp; j += 32) xs[j * ldx + r] = 0.f;
          if (kMfcc && lane == 0) elog[r] = 0.f;
          continue;
        }
        const float mean = p.remove_dc ? warp_sum(s[h]) / static_cast<float>(p.W) : 0.f;
        float carry = 0.f;  // centred sample before the batch (lane 31's last)
        float energy = 0.f;
        for (int j0 = 0; j0 < p.Wp; j0 += 32 * kFrameBatch) {
          float c[kFrameBatch], o[kFrameBatch];
#pragma unroll
          for (int u = 0; u < kFrameBatch; ++u) {
            const int j = j0 + 32 * u + lane;
            c[u] = j < p.W ? xs[j * ldx + r] - mean : 0.f;
            if (kMfcc) energy = fmaf(c[u], c[u], energy);  // raw energy: before pre-emphasis
          }
#pragma unroll
          for (int u = 0; u < kFrameBatch; ++u) {
            const int j = j0 + 32 * u + lane;
            float prev = __shfl_up_sync(full, c[u], 1);
            if (lane == 0) prev = (j == 0) ? c[u] : carry;  // Kaldi: w[0] -= c*w[0]
            carry = __shfl_sync(full, c[u], 31);
            o[u] = j < p.W ? (c[u] - p.preemph * prev) * swin[j] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kFrameBatch; ++u) {
            const int j = j0 + 32 * u + lane;
            if (j < p.Wp) xs[j * ldx + r] = o[u];
          }
        }
        if (kMfcc) {
          energy = warp_sum(energy);
          if (lane == 0)
            elog[r] = p.use_energy ? fmaxf(logf(fmaxf(energy, p.log_floor)), p.log_energy_floor)
                                   : 0.f;
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");  // the frames are in

    // 2. real DFT (fp32 FMA) over the table ring: an R x 8 register tile a thread
    const int WC = Cc / 64;
    const int wc = warp % WC, wr = warp / WC;
    const int rq = lane >> 3, cq = lane & 7;
    rbase = (wr * 4 + rq) * R;  // the thread's first row in the tile
    const int cq4 = 4 * cq;               // its columns in the warp's block: cq4..+3, +32..+35
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
    for (int q = 0; q < nchunks; ++q) {
      const int stage = q % kStages;
      mbar_wait(full_bar + stage, (q / kStages) & 1);  // chunk q has landed
      const float* st = ring + (stage * WC + wc) * kChunk * 64 + cq4;
      const float* xq = xs + q * kChunk * ldx + rbase;
#pragma unroll
      for (int n = 0; n < kChunk; ++n) {
        float xv[R];
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(xq + n * ldx + 2 * i);
          xv[2 * i] = v.x;
          xv[2 * i + 1] = v.y;
        }
        const float4 t0 = *reinterpret_cast<const float4*>(st + n * 64);
        const float4 t1 = *reinterpret_cast<const float4*>(st + n * 64 + 32);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][0] = fmaf(xv[i], t0.x, acc[i][0]);
          acc[i][1] = fmaf(xv[i], t0.y, acc[i][1]);
          acc[i][2] = fmaf(xv[i], t0.z, acc[i][2]);
          acc[i][3] = fmaf(xv[i], t0.w, acc[i][3]);
          acc[i][4] = fmaf(xv[i], t1.x, acc[i][4]);
          acc[i][5] = fmaf(xv[i], t1.y, acc[i][5]);
          acc[i][6] = fmaf(xv[i], t1.z, acc[i][6]);
          acc[i][7] = fmaf(xv[i], t1.w, acc[i][7]);
        }
      }
      __syncwarp();
      if (lane == 0) {  // this warp is done with the stage, in every CTA of its group
        if (CM == 1) mbar_arrive(empty_bar + stage);
        else
          for (int j = 0; j < CM; ++j) mbar_arrive_remote(empty_bar + stage, crank + CL * j);
      }
    }
    bin0 = crank * (Cc / 2) + 32 * wc + cq4 / 2;  // the thread's bins: bin0, +1, +16, +17
  }
  // every CTA of the cluster is done with its ring (and has sent its last
  // arrivals): the spectrum may land there
  if (CS > 1) cluster.sync();
  else __syncthreads();

  // 3. power spectrum of the thread's 4 bins into the spectrum of every CTA of the tile
  for (int d = 0; d < CL && tid < kConsumers; ++d) {
    float* sp = CL > 1 ? cluster.map_shared_rank(spec, mrank * CL + d) : spec;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float* o = sp + (rbase + i) * lds + bin0;
      o[0] = acc[i][0] * acc[i][0] + acc[i][1] * acc[i][1];
      o[1] = acc[i][2] * acc[i][2] + acc[i][3] * acc[i][3];
      o[16] = acc[i][4] * acc[i][4] + acc[i][5] * acc[i][5];
      o[17] = acc[i][6] * acc[i][6] + acc[i][7] * acc[i][7];
    }
  }
  if (CL > 1) cluster.sync();
  else __syncthreads();

  // 4. banded mel product and log floor: this CTA's rows crank, crank + CL, ...
  const int own = (RT - crank + CL - 1) / CL;
  for (int idx = tid; idx < own * p.M; idx += kThreads) {
    const int i = idx / p.M, m = idx - i * p.M;
    const int r = crank + i * CL, row = row0 + r;
    if (row >= nrows) continue;
    const float* sp = spec + r * lds;
    const int lo = sband[3 * m], hi = sband[3 * m + 1];
    const float* wm = swt + sband[3 * m + 2] - lo;
    float a = 0.f;
    for (int k = lo; k < hi; ++k) a = fmaf(sp[k], wm[k], a);
    const float lm = logf(fmaxf(a, p.log_floor));
    if (kMfcc) lmel[r * p.M + m] = lm;
    else p.out[static_cast<size_t>(row) * p.M + m] = lm;
  }
  if (!kMfcc) return;
  __syncthreads();

  // 5. (K4) DCT product with the lifter folded in; column 0 takes the energy
  for (int idx = tid; idx < own * p.C; idx += kThreads) {
    const int i = idx / p.C, c = idx - i * p.C;
    const int r = crank + i * CL, row = row0 + r;
    if (row >= nrows) continue;
    const float* lm = lmel + r * p.M;
    float a = 0.f;
    for (int m = 0; m < p.M; ++m)
      a = fmaf(lm[m], __ldg(p.dctT + static_cast<size_t>(m) * p.C + c), a);
    p.out[static_cast<size_t>(row) * p.C + c] = (p.use_energy && c == 0) ? elog[r] : a;
  }
}

template <bool kMfcc>
const void* kernel_for(int R) {
  return R == 10 ? reinterpret_cast<const void*>(fbank_kernel<10, kMfcc>)
                 : reinterpret_cast<const void*>(fbank_kernel<4, kMfcc>);
}

// The tile for nrows rows. CL: the fewest CTAs whose columns hold the 2Kp
// of the table (more than one only above 16 kHz: a split repeats the
// framing in each CTA and exchanges the spectrum). CM: two row tiles share
// the table's stream wherever the cluster stays within 8 CTAs. R: 10 rows a
// thread, or 4 where 10 do not fit in shared memory or would take longer,
// reckoned as the waves of CTAs over the card's SMs times the rows a CTA
// takes (the CE batch of 64 x 80 frames takes 10 rows a thread, 128 CTAs in
// one wave; one 1,230-frame utterance 4, 78 CTAs where 10 would give 32).
int pick_tile(int nrows, int Wp, int Kp, int M, int nnz, bool mfcc, Tile* best) {
  const int CL = 2 * Kp > 512 ? 2 * Kp / 512 : 1;
  const int CM = 2 * CL <= 8 ? 2 : 1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  static const int kR[] = {10, 4};
  long long best_cost = -1;
  for (const int R : kR) {
    Tile t;
    if (!make_tile(R, CL, CM, Wp, Kp, M, nnz, mfcc, &t)) continue;
    const long long tiles = (static_cast<long long>(nrows) + t.RT - 1) / t.RT;
    const long long ctas = (tiles + CM - 1) / CM * CM * CL;
    const long long cost = (ctas + sms - 1) / sms * t.RT;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      *best = t;
    }
  }
  return best_cost < 0 ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

template <bool kMfcc>
int launch(FbankArgs a, void* stream) {
  if (a.B <= 0 || a.T <= 0 || a.W <= 0 || a.K <= 0 || a.M <= 0 || (kMfcc && a.C <= 0) ||
      a.nnz < 0 || a.Wp < a.W || a.Wp % kChunk != 0 || a.Kp < a.K || a.Kp < 32 ||
      (a.Kp & (a.Kp - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nrows = a.B * a.T;
  Tile t;
  int e = pick_tile(nrows, a.Wp, a.Kp, a.M, a.nnz, kMfcc, &t);
  if (e != 0) return e;
  a.cl = t.CL;
  a.cm = t.CM;
  const void* fn = kernel_for<kMfcc>(t.R);
  const int tiles = ((nrows + t.RT - 1) / t.RT + t.CM - 1) / t.CM * t.CM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * t.CL);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = t.smem();
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = t.CL * t.CM;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int Cc = t.Cc, RT = t.RT, ldx = t.ldx, lds = t.lds;
  int xs_words = static_cast<int>(t.xs_words), elog_words = static_cast<int>(t.elog_words);
  int mel_words = static_cast<int>(t.mel_words);
  void* args[] = {&a, &Cc, &RT, &ldx, &lds, &xs_words, &elog_words, &mel_words};
  cudaError_t ce = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(t.smem()));
  if (ce == cudaSuccess) ce = cudaLaunchKernelExC(&cfg, fn, args);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tile K1 (mfcc = 0) or K4 (mfcc = 1) takes for nrows rows on this
// card: rows a thread, CTAs a row tile (column shares), row tiles a
// cluster (sharing the table's stream), rows a tile; 0 or a cudaError_t
// code.
int pk2_fbank_tile(int nrows, int Wp, int Kp, int M, int nnz, int mfcc, int* R, int* CL,
                   int* CM, int* RT) {
  Tile t;
  const int e = pick_tile(nrows, Wp, Kp, M, nnz, mfcc != 0, &t);
  if (e != 0) return e;
  *R = t.R;
  *CL = t.CL;
  *CM = t.CM;
  *RT = t.RT;
  return 0;
}

// K1. Frame t of an utterance takes samples t * shift + first + j, j < W,
// reflected into [0, S) as Kaldi does (first = 0 with snip_edges, else
// shift / 2 - W / 2). cs is the [Wp, 2Kp] interleaved table in blocks of 64
// columns ([2Kp/64][Wp][64]), melw the nnz mel weights of the filters'
// nonzero bins and mband each filter's (lo, hi, offset into melw). Returns
// a cudaError_t code: 0 on a clean launch.
int pk2_fbank(const void* wave, const void* win, const void* cs, const void* melw,
              const void* mband, void* out, int B, int S, int T, int W, int Wp, int K, int Kp,
              int M, int nnz, int shift, int first, int remove_dc, float preemph,
              float log_floor, void* stream) {
  FbankArgs a = {static_cast<const float*>(wave), static_cast<const float*>(win),
                 static_cast<const float*>(cs), static_cast<const float*>(melw),
                 static_cast<const int*>(mband), nullptr, static_cast<float*>(out), B, S, T, W,
                 Wp, K, Kp, M, 0, nnz, shift, first, remove_dc, preemph, log_floor, 0, 0.f, 1,
                 1};
  return launch<false>(a, stream);
}

// K4, on K1's tables plus the [M, C] lifted DCT. log_energy_floor is
// log(energy_floor), or -inf for no floor. Returns a cudaError_t code: 0 on
// a clean launch.
int pk2_mfcc(const void* wave, const void* win, const void* cs, const void* melw,
             const void* mband, const void* dctT, void* out, int B, int S, int T, int W, int Wp,
             int K, int Kp, int M, int C, int nnz, int shift, int first, int remove_dc,
             float preemph, float log_floor, int use_energy, float log_energy_floor,
             void* stream) {
  FbankArgs a = {static_cast<const float*>(wave), static_cast<const float*>(win),
                 static_cast<const float*>(cs), static_cast<const float*>(melw),
                 static_cast<const int*>(mband), static_cast<const float*>(dctT),
                 static_cast<float*>(out), B, S, T, W, Wp, K, Kp, M, C, nnz, shift, first,
                 remove_dc, preemph, log_floor, use_energy, log_energy_floor, 1, 1};
  return launch<true>(a, stream);
}

}  // extern "C"
