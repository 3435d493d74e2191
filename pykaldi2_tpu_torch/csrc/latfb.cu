// Banded time-synchronous lattice forward-backward: kernels K7-K10.
//
// Replaces the Pallas kernels of pykaldi2_tpu/ops/fb_lattice_pallas.py:
//   K7  pk2_latfb_logz_fwd        <- _fwd_kernel       (alpha recursion, logZ)
//   K8  pk2_latfb_occupancies_bwd <- _bwd_kernel       (beta recursion + arc posteriors)
//   K9  pk2_latfb_smbr_fwd        <- _smbr_fwd_kernel  (K7 + expected-accuracy carry)
//   K10 pk2_latfb_smbr_bwd        <- _smbr_bwd_kernel  (beta/accuracy-beta + contributions)
//
// Arrays are time-major as the Pallas kernels take them: per-arc tables
// obs_arc, w, arc_acc [T,B,A] f32 and src, dst [T,B,A] i32; active,
// anorm_prev [T,B] f32; per-slot alphas/aaccs/alpha_prev/aacc_prev [T,B,K];
// final [B,K]; logz, f [B]. Arc a of frame t joins slot src (frame t) to slot
// dst (frame t+1); padding arcs carry weight NEG_INF.
//
// Design. Utterances are independent, so each CTA owns one utterance and
// walks its T frames in a loop (in reverse for K8/K10): no grid barrier. The
// [K] carries (alpha or beta, and the accuracy carry for K9/K10) and the
// [K] segment-sum accumulators live in shared memory for all of T. All four
// kernels stream the band through a shared-memory ring (cp.async.bulk on
// mbarriers), keep each arc's score in registers from the max to the
// scatter, need four barriers a frame and skip exact no-ops (zero-weight
// arcs, inactive frames). K7 and K9 are one template, band_fwd_kernel<kAcc>;
// K8 and K10 are band_bwd_kernel<kAcc>. The Pallas kernels' one-hot matmul
// gather/scatter was a way around Mosaic and is not carried over.
//
// Bound. Each kernel reads its band once and writes its outputs once, so it
// is bound by bytes, but at B=32 only 32 of the 132 SMs hold a CTA and each
// frame is a chain of dependent block reductions: the kernels are latency
// bound per frame, and the design takes that latency apart. Splitting the
// band of one utterance over a cluster of CTAs (DSMEM) is the next lever;
// not done here.
//
// Numerics follow the reference exactly: NEG_INF = -1e30 with the
// max(., NEG_INF) clamp, exp(min(log_gamma, 0)), the `denom > 0` guards,
// IEEE expf/logf and division (no fast math). The fp32 atomics add in an
// order that changes from run to run, so sums match the plain PyTorch
// version to rounding, not bit for bit.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// the opt-in shared-memory limit of a Hopper CTA
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ float log_safe(float x) { return x > 0.f ? logf(x) : kNegInf; }

// expected-accuracy carry of the sMBR recursions: numer/denom, 0 where denom is 0
__device__ __forceinline__ float acc_ratio(float numer, float denom) {
  return denom > 0.f ? numer / denom : 0.f;
}

// ---------------------------------------------------------------------------
// K7-K10, redesigned for the H100. One CTA of kThreads per utterance; the
// frame's latency is taken apart:
// - the band streams into a shared-memory ring of S stages, frames ahead of
//   the one that runs: one thread issues a frame's rows as cp.async.bulk
//   copies that complete on the stage's mbarrier. A stage holds the frame's
//   first CH = min(A, kRegArcs * kThreads) arcs of obs, w, src, dst (and
//   arc_acc for K9/K10), and for K8/K10 the frame's whole [K] rows of
//   alpha_prev (and aacc_prev), so the per-arc gathers at src read shared
//   memory. The host picks 2 <= S <= 4 from the shared memory the [K]
//   carries leave. Arcs past CH are read from global memory, and so is
//   every arc when there is no ring: A (or, with [K] rows, K) not a
//   multiple of 4, a row not 16-byte aligned, or two stages do not fit;
// - each thread computes its arcs' scores (and accuracies) once, keeps them
//   in registers (kRegArcs a thread; arcs past that are recomputed from
//   the unchanged carries) from the max to the scatter. K8's gamma and
//   K10's contribution need no reduction of the frame (only the carries
//   entering it), so pass 1 computes and stores them too;
// - four barriers a frame, not six: warp-shuffle maxima, one exchange of
//   the kWarps warp values, which every warp reduces with four shuffles;
// - an arc whose exp is exactly 0 (padding in a frame with live arcs) stays
//   out of the shared atomics: adding +0 changes no sum. An active frame of
//   padding arcs only still adds exp(0) = 1 to slot 0, as the reference;
// - an inactive frame (active == 0) does no arc work: the blend would keep
//   the carries exactly (its new values are finite). K7 and K9 write the carries
//   out; K8/K10 write 0 for every arc (the reference writes act * x, which
//   is -0 where x < 0: equal by value).
// Measured on an H100 80GB HBM3 at 700 W (tools/kernel_ab.py on
// chip_smoke.padded_lattice, B=32, T=448, K=256, A=512): K8 2.05 → 0.74 ms
// and K10 2.97 → 0.96 ms a call against the first design (commit
// 3c9d343's), K9 0.98 → 0.89 ms against that commit's ring; clock stamps
// (tools/kernel_split.py) put most of a frame in pass 1 and pass 2 (~20%
// each) and the slot pass (~16%). K7's first design (commit 714a141's)
// spent 61% of its 8.0k cycles a frame in the atomic pass; PERF.md has the
// splits and K7's times.
// ---------------------------------------------------------------------------

constexpr int kRegArcs = 4;  // arcs a thread keeps in registers in a frame
constexpr int kMaxStages = 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A band's rows in global memory: the [T,B,A] arc tables and, for the
// backward kernels, the [T,B,K] forward residuals gathered at src.
struct BandRows {
  const float* obs;
  const float* w;
  const int* src;
  const int* dst;
  const float* acc;     // arc_acc (K9, K10)
  const float* aprev;   // alpha_prev (K8, K10)
  const float* aaprev;  // aacc_prev (K10)
};

// The band ring: S stages of `words` words each. Stream position i lives in
// stage i % S, and its mbarrier's parity is that of i / S: K9 streams frame
// i at position i, K8/K10 frame T-1-i. The kernels step a RingPos along
// the positions rather than divide by S (two integer divisions a frame
// cost ~300 cycles on the critical path). A stage is a frame's rows packed
// in order, each a multiple of 16 bytes (so each 16-byte aligned). The last
// thread (the one least likely to hold arcs or slots) fills a stage with
// one cp.async.bulk copy a row, all completing on the stage's mbarrier.
struct BandRing {
  float* base;
  unsigned long long* bar;  // [S] mbarriers
  int S, words;             // stages, words a stage

  static constexpr int kIssuer = kThreads - 1;

  __device__ float* stage(int s) const { return base + s * words; }

  // the issuer initialises the mbarriers; the caller's barrier publishes them
  __device__ void init() const {
    if (threadIdx.x != kIssuer) return;
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The issuer's fill of stage s with a frame whose arc rows start at word
  // off and [K] rows at koff: its first ch arcs of the kArcRows arc rows of
  // g (obs, w, src, dst, then arc_acc), then its kSlotRows [K] rows
  // (alpha_prev, then aacc_prev). The rows fill the stage, `words` words,
  // the bytes the mbarrier expects. Every thread may call it; the callers
  // compute the offsets, off the issuer's path.
  template <int kArcRows, int kSlotRows>
  __device__ __forceinline__ void fill(int s, const BandRows& g, size_t off, size_t koff, int ch,
                                       int K) const {
    if (threadIdx.x != kIssuer) return;
    const void* arc[5] = {g.obs + off, g.w + off, g.src + off, g.dst + off, g.acc + off};
    const void* slot[2] = {kSlotRows > 0 ? g.aprev + koff : nullptr,
                           kSlotRows > 1 ? g.aaprev + koff : nullptr};
    float* st = stage(s);
    const unsigned mb = smem_addr(bar + s);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
                 "r"(words * 4) : "memory");
#pragma unroll
    for (int r = 0; r < kArcRows + kSlotRows; ++r) {
      const int len = r < kArcRows ? ch : K;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(st)),
          "l"(r < kArcRows ? arc[r] : slot[r - kArcRows]), "r"(len * 4), "r"(mb) : "memory");
      st += len;
    }
  }

  // stage s has landed in the phase of the given parity
  __device__ void wait(int s, unsigned parity) const {
    const unsigned mb = smem_addr(bar + s);
    unsigned done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(mb), "r"(parity) : "memory");
    } while (!done);
  }
};

// A stream position's stage and its mbarrier's parity. Starting from
// (S-1, 1), next() gives position 0's (0, 0), then 1's, and so on.
struct RingPos {
  int slot;
  unsigned parity;

  __device__ void next(int S) {
    if (++slot == S) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// v's maximum over the warp
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block maximum in two halves around one __syncthreads: each warp posts
// its maximum, then every warp reduces the kWarps posts with four shuffles.
__device__ __forceinline__ void post_warp_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
}

__device__ __forceinline__ float read_block_max(const float* red) {
  static_assert(kWarps == 16, "four shuffles reduce the warps' posts");
  float v = red[threadIdx.x & (kWarps - 1)];
  for (int o = kWarps / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K7 (kAcc = false): the alpha recursion and the cumulative norms. K9
// (kAcc = true): alpha and the expected-accuracy carry aacc. The plain
// versions: logz_fwd_plain and smbr_fwd_plain (ops/fb_lattice_cuda.py).
template <bool kAcc>
__global__ void __launch_bounds__(kThreads) band_fwd_kernel(
    const float* __restrict__ obs, const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ active,
    const float* __restrict__ arc_acc, float* __restrict__ alphas,
    float* __restrict__ aaccs, float* __restrict__ norms, int T, int B, int A, int K,
    int S, int ch) {
  constexpr int kArcRows = kAcc ? 5 : 4;  // obs, w, src, dst (, arc_acc): ch words each
  extern __shared__ __align__(16) float ring_smem[];
  float* alpha = ring_smem;
  float* aacc = ring_smem + K;  // K9 only, as num
  float* sum = ring_smem + (kAcc ? 2 : 1) * K;
  float* num = ring_smem + 3 * K;
  float* red = ring_smem + (kAcc ? 4 : 2) * K;
  // S stages of the arc rows (ch words each, 16-byte aligned), S mbarriers
  float* ring_base = red + kWarps;
  const BandRing ring{ring_base,
                      reinterpret_cast<unsigned long long*>(ring_base + S * kArcRows * ch), S,
                      kArcRows * ch};
  const int b = blockIdx.x, tid = threadIdx.x;
  const int nring = S > 0 ? ch : 0;
  const BandRows g{obs, w, src, dst, arc_acc, nullptr, nullptr};
  const size_t frame = static_cast<size_t>(B) * A;  // words from one frame's band to the next
  for (int k = tid; k < K; k += kThreads) {
    alpha[k] = k == 0 ? 0.f : kNegInf;
    if (kAcc) aacc[k] = 0.f;
    sum[k] = 0.f;
    if (kAcc) num[k] = 0.f;
  }
  ring.init();
  __syncthreads();
  for (int t = 0; t < S && t < T; ++t)
    ring.fill<kArcRows, 0>(t, g, t * frame + static_cast<size_t>(b) * A, 0, ch, K);
  float norm = 0.f;
  float act_next = active[b];
  RingPos pos{S - 1, 1u};
  for (int t = 0; t < T; ++t) {
    pos.next(S);  // frame t's stage
    const size_t row = static_cast<size_t>(t) * B + b;
    const size_t off = row * A;
    const float act = act_next;
    if (t + 1 < T) act_next = active[row + B];  // in flight during the frame
    const float* stage = S > 0 ? ring.stage(pos.slot) : ring_base;
    const int* ssrc = reinterpret_cast<const int*>(stage + 2 * ch);
    const int* sdst = reinterpret_cast<const int*>(stage + 3 * ch);
    if (S > 0) ring.wait(pos.slot, pos.parity);  // frame t's stage has landed
    __syncthreads();  // B0: ... in every thread, and the last frame's carries are final
    if (act == 0.f) {  // the blend keeps the carries: write them out, skip the arcs
      for (int k = tid; k < K; k += kThreads) {
        alphas[row * K + k] = alpha[k];
        if (kAcc) aaccs[row * K + k] = aacc[k];
      }
      if (tid == 0) norms[row] = norm;
      if (S > 0 && t + S < T)  // no one reads frame t's stage
        ring.fill<kArcRows, 0>(pos.slot, g, off + S * frame, 0, ch, K);
      continue;
    }
    // pass 1: scores (and accuracies) of this thread's arcs, and their max
    float sc[kRegArcs], ai[kRegArcs];
    int dd[kRegArcs];
    float lmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kRegArcs; ++j) {
      const int a = tid + j * kThreads;
      if (a < A) {
        int s;
        float o, ww, ac = 0.f;
        if (a < nring) {
          o = stage[a];
          ww = stage[ch + a];
          s = ssrc[a];
          dd[j] = sdst[a];
          if (kAcc) ac = stage[4 * ch + a];
        } else {
          o = obs[off + a];
          ww = w[off + a];
          s = src[off + a];
          dd[j] = dst[off + a];
          if (kAcc) ac = arc_acc[off + a];
        }
        sc[j] = alpha[s] + ww + o;
        ai[j] = kAcc ? aacc[s] + ac : 0.f;
        lmax = fmaxf(lmax, sc[j]);
      }
    }
    for (int a = tid + kRegArcs * kThreads; a < A; a += kThreads)
      lmax = fmaxf(lmax, alpha[src[off + a]] + w[off + a] + obs[off + a]);
    post_warp_max(lmax, red);
    __syncthreads();  // B1: the posts are in; no thread reads this frame's stage again
    const float mx = fmaxf(read_block_max(red), kNegInf);
    // pass 2: the arcs' linear weights into their destination slots
#pragma unroll
    for (int j = 0; j < kRegArcs; ++j) {
      if (tid + j * kThreads < A) {
        const float lin = expf(sc[j] - mx);
        if (lin != 0.f) {
          atomicAdd(&sum[dd[j]], lin);
          if (kAcc) atomicAdd(&num[dd[j]], lin * ai[j]);
        }
      }
    }
    for (int a = tid + kRegArcs * kThreads; a < A; a += kThreads) {
      const int s = src[off + a], d = dst[off + a];
      const float lin = expf(alpha[s] + w[off + a] + obs[off + a] - mx);
      if (lin != 0.f) {
        atomicAdd(&sum[d], lin);
        if (kAcc) atomicAdd(&num[d], lin * (aacc[s] + arc_acc[off + a]));
      }
    }
    __syncthreads();  // B2: every arc is in its slot
    if (S > 0 && t + S < T)  // frame t's stage is free since B1
      ring.fill<kArcRows, 0>(pos.slot, g, off + S * frame, 0, ch, K);
    float lm = -INFINITY;
    for (int k = tid; k < K; k += kThreads) {
      const float r = kAcc ? acc_ratio(num[k], sum[k]) : 0.f;
      const float v = log_safe(sum[k]) + mx;
      if (kAcc) num[k] = r;
      sum[k] = v;
      lm = fmaxf(lm, v);
    }
    post_warp_max(lm, red);
    __syncthreads();  // B3: the slots' maxima are in
    const float m2 = read_block_max(red);
    for (int k = tid; k < K; k += kThreads) {
      const float v = act * (sum[k] - m2) + (1.f - act) * alpha[k];
      const float c = kAcc ? act * num[k] + (1.f - act) * aacc[k] : 0.f;
      alpha[k] = v;
      if (kAcc) aacc[k] = c;
      alphas[row * K + k] = v;
      if (kAcc) aaccs[row * K + k] = c;
      sum[k] = 0.f;
      if (kAcc) num[k] = 0.f;
    }
    norm = norm + act * m2;
    if (tid == 0) norms[row] = norm;
  }
}

// an arc's output from its log gamma lg (and, for K10, its accuracy c_arc):
// gamma (K8) or gamma * (c_arc - f) (K10), in the reference's order
template <bool kAcc>
__device__ __forceinline__ float arc_output(float act, float lg, float c, float fb) {
  const float g = expf(fminf(lg, 0.f));
  return kAcc ? act * (g * (c - fb)) : act * g;
}

// K8 (kAcc = false): the beta recursion and gamma = exp(min(log gamma, 0))
// per arc. K10 (kAcc = true): beta and the accuracy-beta bacc, and
// gamma * (c_arc - f) per arc. Frames in reverse: stream position i is
// frame T-1-i. The plain versions: occupancies_bwd_plain and
// smbr_contribs_bwd_plain (ops/fb_lattice_cuda.py).
// One CTA an SM is stated: without it ptxas holds the template to 64
// registers and spills.
template <bool kAcc>
__global__ void __launch_bounds__(kThreads, 1) band_bwd_kernel(
    const float* __restrict__ obs, const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ active,
    const float* __restrict__ arc_acc, const float* __restrict__ alpha_prev,
    const float* __restrict__ aacc_prev, const float* __restrict__ anorm_prev,
    const float* __restrict__ final_w, const float* __restrict__ logz,
    const float* __restrict__ f, float* __restrict__ out, int T, int B, int A, int K, int S,
    int ch) {
  constexpr int kArcRows = kAcc ? 5 : 4;  // obs, w, src, dst (, arc_acc): ch words each
  constexpr int kSlotRows = kAcc ? 2 : 1;  // alpha_prev (, aacc_prev): K words each
  extern __shared__ __align__(16) float ring_smem[];
  float* beta = ring_smem;
  float* sum = ring_smem + K;
  float* bacc = ring_smem + 2 * K;  // K10 only, as num
  float* num = ring_smem + 3 * K;
  float* red = ring_smem + (kAcc ? 4 : 2) * K;
  // S stages (16-byte aligned when the ring is on: K % 4 == 0), S mbarriers
  float* ring_base = red + kWarps;
  const int words = kArcRows * ch + kSlotRows * K;
  const BandRing ring{ring_base, reinterpret_cast<unsigned long long*>(ring_base + S * words), S,
                      words};
  const int b = blockIdx.x, tid = threadIdx.x;
  const int nring = S > 0 ? ch : 0;
  const BandRows g{obs, w, src, dst, arc_acc, alpha_prev, aacc_prev};
  // words from one frame's arc rows, and [K] rows, to the next
  const size_t frame = static_cast<size_t>(B) * A, kframe = static_cast<size_t>(B) * K;
  for (int k = tid; k < K; k += kThreads) {
    beta[k] = final_w[static_cast<size_t>(b) * K + k];
    sum[k] = 0.f;
    if (kAcc) {
      bacc[k] = 0.f;
      num[k] = 0.f;
    }
  }
  ring.init();
  __syncthreads();
  for (int i = 0; i < S && i < T; ++i) {
    const size_t row = static_cast<size_t>(T - 1 - i) * B + b;
    ring.fill<kArcRows, kSlotRows>(i, g, row * A, row * K, ch, K);
  }
  const float lz = logz[b], fb = kAcc ? f[b] : 0.f;
  float bnorm = 0.f;
  float act_next = active[static_cast<size_t>(T - 1) * B + b];
  float an_next = anorm_prev[static_cast<size_t>(T - 1) * B + b];
  RingPos pos{S - 1, 1u};
  for (int i = 0; i < T; ++i) {
    pos.next(S);  // position i's stage
    const int t = T - 1 - i;
    const size_t row = static_cast<size_t>(t) * B + b;
    const size_t off = row * A, koff = row * K;
    const float act = act_next, an = an_next;
    if (t > 0) {  // in flight during the frame
      act_next = active[row - B];
      an_next = anorm_prev[row - B];
    }
    const float* stage = S > 0 ? ring.stage(pos.slot) : ring_base;
    const int* ssrc = reinterpret_cast<const int*>(stage + 2 * ch);
    const int* sdst = reinterpret_cast<const int*>(stage + 3 * ch);
    const float* sap = stage + kArcRows * ch;  // the frame's alpha_prev row
    if (S > 0) ring.wait(pos.slot, pos.parity);  // position i's stage has landed
    __syncthreads();  // B0: ... in every thread, and the last frame's carries are final
    if (act == 0.f) {  // the blend keeps the carries: the arcs' outputs are 0
      for (int a = tid; a < A; a += kThreads) out[off + a] = 0.f;
      if (S > 0 && i + S < T)  // no one reads position i's stage
        ring.fill<kArcRows, kSlotRows>(pos.slot, g, off - S * frame, koff - S * kframe, ch, K);
      continue;
    }
    // pass 1: each arc's score (and accuracy) into registers, its output
    // out, and the scores' max
    float sc[kRegArcs], ai[kRegArcs];
    int ss[kRegArcs];
    float lmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kRegArcs; ++j) {
      const int a = tid + j * kThreads;
      if (a < A) {
        int s, d;
        float o, ww, ac = 0.f, ap, aap = 0.f;
        if (a < nring) {
          o = stage[a];
          ww = stage[ch + a];
          s = ssrc[a];
          d = sdst[a];
          ap = sap[s];
          if (kAcc) {
            ac = stage[4 * ch + a];
            aap = sap[K + s];
          }
        } else {
          o = obs[off + a];
          ww = w[off + a];
          s = src[off + a];
          d = dst[off + a];
          ap = alpha_prev[koff + s];
          if (kAcc) {
            ac = arc_acc[off + a];
            aap = aacc_prev[koff + s];
          }
        }
        const float ow = ww + o, bd = beta[d];
        const float bcd = kAcc ? bacc[d] : 0.f;
        ss[j] = s;
        sc[j] = ow + bd;
        ai[j] = ac + bcd;
        out[off + a] = arc_output<kAcc>(act, ap + an + ow + bd + bnorm - lz, aap + ac + bcd, fb);
        lmax = fmaxf(lmax, sc[j]);
      }
    }
    for (int a = tid + kRegArcs * kThreads; a < A; a += kThreads) {
      const int s = src[off + a], d = dst[off + a];
      const float ow = w[off + a] + obs[off + a], bd = beta[d];
      const float ac = kAcc ? arc_acc[off + a] : 0.f;
      const float c = kAcc ? aacc_prev[koff + s] + ac + bacc[d] : 0.f;
      out[off + a] = arc_output<kAcc>(act, alpha_prev[koff + s] + an + ow + bd + bnorm - lz, c,
                                      fb);
      lmax = fmaxf(lmax, ow + bd);
    }
    post_warp_max(lmax, red);
    __syncthreads();  // B1: the posts are in; no thread reads this frame's stage again
    const float mx = fmaxf(read_block_max(red), kNegInf);
    // pass 2: the arcs' linear weights into their source slots
#pragma unroll
    for (int j = 0; j < kRegArcs; ++j) {
      if (tid + j * kThreads < A) {
        const float lin = expf(sc[j] - mx);
        if (lin != 0.f) {
          atomicAdd(&sum[ss[j]], lin);
          if (kAcc) atomicAdd(&num[ss[j]], lin * ai[j]);
        }
      }
    }
    for (int a = tid + kRegArcs * kThreads; a < A; a += kThreads) {
      const int s = src[off + a], d = dst[off + a];
      const float lin = expf(w[off + a] + obs[off + a] + beta[d] - mx);
      if (lin != 0.f) {
        atomicAdd(&sum[s], lin);
        if (kAcc) atomicAdd(&num[s], lin * (arc_acc[off + a] + bacc[d]));
      }
    }
    __syncthreads();  // B2: every arc is in its slot
    if (S > 0 && i + S < T)  // position i's stage is free since B1
      ring.fill<kArcRows, kSlotRows>(pos.slot, g, off - S * frame, koff - S * kframe, ch, K);
    float lm = -INFINITY;
    for (int k = tid; k < K; k += kThreads) {
      if (kAcc) num[k] = acc_ratio(num[k], sum[k]);
      const float v = log_safe(sum[k]) + mx;
      sum[k] = v;
      lm = fmaxf(lm, v);
    }
    post_warp_max(lm, red);
    __syncthreads();  // B3: the slots' maxima are in
    const float m2 = read_block_max(red);
    for (int k = tid; k < K; k += kThreads) {
      beta[k] = act * (sum[k] - m2) + (1.f - act) * beta[k];
      sum[k] = 0.f;
      if (kAcc) {
        bacc[k] = act * num[k] + (1.f - act) * bacc[k];
        num[k] = 0.f;
      }
    }
    bnorm = bnorm + act * m2;
  }
}

size_t smem_bytes(int n_bufs, int K) {
  return (static_cast<size_t>(n_bufs) * K + kWarps) * sizeof(float);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  return cudaSuccess;
}

// The band ring of a kernel with n_bufs [K] carries and accumulators, whose
// stage holds arc_rows rows of a frame's first arcs and slot_rows [K] rows,
// at (A, K): *stages (0: no ring) stages of *chunk arcs each, and the
// launch's dynamic shared memory; -1 if the carries do not fit. The bulk
// copies move whole 16-byte words, so A % 4 != 0 (or K % 4 != 0 with [K]
// rows) takes no ring.
int band_ring(int A, int K, int n_bufs, int arc_rows, int slot_rows, int* stages, int* chunk,
              size_t* smem) {
  const size_t carries = smem_bytes(n_bufs, K), bars = kMaxStages * sizeof(unsigned long long);
  *stages = *chunk = 0;
  *smem = carries;
  if (carries > static_cast<size_t>(kMaxSmemBytes)) return -1;
  if (A % 4 != 0 || (slot_rows > 0 && K % 4 != 0) ||
      carries + bars >= static_cast<size_t>(kMaxSmemBytes))
    return 0;
  const size_t room = kMaxSmemBytes - carries - bars;
  const int ch = A < kRegArcs * kThreads ? A : kRegArcs * kThreads;
  const size_t stage =
      (static_cast<size_t>(arc_rows) * ch + static_cast<size_t>(slot_rows) * K) * sizeof(float);
  for (int s = kMaxStages; s >= 2; --s) {
    if (s * stage > room) continue;
    *stages = s;
    *chunk = ch;
    *smem = carries + s * stage + bars;
    return 0;
  }
  return 0;
}

// K7's ring: 2 [K] buffers, 4 arc rows; K9's: 4 buffers, 5 arc rows; K8's
// and K10's: 2 buffers, 4 arc rows and alpha_prev, or 4 buffers, 5 arc rows,
// alpha_prev and aacc_prev
int fwd_ring(int A, int K, bool acc, int* stages, int* chunk, size_t* smem) {
  return acc ? band_ring(A, K, 4, 5, 0, stages, chunk, smem)
             : band_ring(A, K, 2, 4, 0, stages, chunk, smem);
}

int bwd_ring(int A, int K, bool acc, int* stages, int* chunk, size_t* smem) {
  return acc ? band_ring(A, K, 4, 5, 2, stages, chunk, smem)
             : band_ring(A, K, 2, 4, 1, stages, chunk, smem);
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

template <bool kAcc>
int launch_fwd(const float* obs, const int* src, const int* dst, const float* w,
               const float* active, const float* arc_acc, float* alphas, float* aaccs,
               float* norms, int T, int B, int A, int K, void* stream) {
  int stages = 0, ch = 0;
  size_t smem = 0;
  if (fwd_ring(A, K, kAcc, &stages, &ch, &smem) < 0) return cudaErrorInvalidValue;
  if (!(aligned16(obs) && aligned16(src) && aligned16(dst) && aligned16(w) &&
        (!kAcc || aligned16(arc_acc)))) {  // the bulk copies need 16-byte aligned rows: no ring
    stages = ch = 0;
    smem = smem_bytes(kAcc ? 4 : 2, K);
  }
  cudaError_t e = prepare(band_fwd_kernel<kAcc>, smem);
  if (e != cudaSuccess) return e;
  band_fwd_kernel<kAcc><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, src, dst, w, active, arc_acc, alphas, aaccs, norms, T, B, A, K, stages, ch);
  return cudaGetLastError();
}

template <bool kAcc>
int launch_bwd(const float* obs, const int* src, const int* dst, const float* w,
               const float* active, const float* arc_acc, const float* alpha_prev,
               const float* aacc_prev, const float* anorm_prev, const float* final_w,
               const float* logz, const float* f, float* out, int T, int B, int A, int K,
               void* stream) {
  int stages = 0, ch = 0;
  size_t smem = 0;
  if (bwd_ring(A, K, kAcc, &stages, &ch, &smem) < 0) return cudaErrorInvalidValue;
  if (!(aligned16(obs) && aligned16(src) && aligned16(dst) && aligned16(w) &&
        aligned16(alpha_prev) && (!kAcc || (aligned16(arc_acc) && aligned16(aacc_prev))))) {
    stages = ch = 0;  // the bulk copies need 16-byte aligned rows: no ring
    smem = smem_bytes(kAcc ? 4 : 2, K);
  }
  cudaError_t e = prepare(band_bwd_kernel<kAcc>, smem);
  if (e != cudaSuccess) return e;
  band_bwd_kernel<kAcc><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, src, dst, w, active, arc_acc, alpha_prev, aacc_prev, anorm_prev, final_w, logz, f,
      out, T, B, A, K, stages, ch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// largest slot count K whose n_bufs shared [K] buffers fit one CTA
int pk2_latfb_max_slots(int n_bufs) {
  return (kMaxSmemBytes / static_cast<int>(sizeof(float)) - kWarps) / n_bufs;
}

int pk2_latfb_logz_fwd(const float* obs, const int* src, const int* dst, const float* w,
                       const float* active, float* alphas, float* norms, int T, int B,
                       int A, int K, void* stream) {
  return launch_fwd<false>(obs, src, dst, w, active, nullptr, alphas, nullptr, norms, T, B, A,
                           K, stream);
}

int pk2_latfb_occupancies_bwd(const float* obs, const int* src, const int* dst, const float* w,
                              const float* active, const float* alpha_prev,
                              const float* anorm_prev, const float* final_w,
                              const float* logz, float* gamma, int T, int B, int A, int K,
                              void* stream) {
  return launch_bwd<false>(obs, src, dst, w, active, nullptr, alpha_prev, nullptr, anorm_prev,
                           final_w, logz, nullptr, gamma, T, B, A, K, stream);
}

// K7's ring at (A, K): *stages (0: no ring) stages of *chunk arcs each
int pk2_latfb_logz_fwd_ring(int A, int K, int* stages, int* chunk) {
  size_t smem = 0;
  return fwd_ring(A, K, false, stages, chunk, &smem) < 0 ? cudaErrorInvalidValue : 0;
}

// K9's ring at (A, K), as K7's
int pk2_latfb_smbr_fwd_ring(int A, int K, int* stages, int* chunk) {
  size_t smem = 0;
  return fwd_ring(A, K, true, stages, chunk, &smem) < 0 ? cudaErrorInvalidValue : 0;
}

// K8's (acc = 0) or K10's (acc = 1) ring at (A, K), as K9's
int pk2_latfb_bwd_ring(int A, int K, int acc, int* stages, int* chunk) {
  size_t smem = 0;
  return bwd_ring(A, K, acc != 0, stages, chunk, &smem) < 0 ? cudaErrorInvalidValue : 0;
}

int pk2_latfb_smbr_fwd(const float* obs, const int* src, const int* dst, const float* w,
                       const float* active, const float* arc_acc, float* alphas,
                       float* aaccs, float* norms, int T, int B, int A, int K,
                       void* stream) {
  return launch_fwd<true>(obs, src, dst, w, active, arc_acc, alphas, aaccs, norms, T, B, A, K,
                          stream);
}

int pk2_latfb_smbr_bwd(const float* obs, const int* src, const int* dst, const float* w,
                       const float* active, const float* arc_acc, const float* alpha_prev,
                       const float* aacc_prev, const float* anorm_prev,
                       const float* final_w, const float* logz, const float* f,
                       float* contrib, int T, int B, int A, int K, void* stream) {
  return launch_bwd<true>(obs, src, dst, w, active, arc_acc, alpha_prev, aacc_prev, anorm_prev,
                          final_w, logz, f, contrib, T, B, A, K, stream);
}

}  // extern "C"
