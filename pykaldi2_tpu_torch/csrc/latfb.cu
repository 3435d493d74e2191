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
// [K] segment-sum accumulators live in shared memory for all of T. In K7,
// K8 and K10, per frame one pass over the A arcs computes the scores and their block
// max; a second pass recomputes them (the band is re-read from L1/L2, so A
// needs no shared memory), takes expf and adds each arc into its destination
// slot (K7/K9) or source slot (K8/K10) with a shared-memory atomicAdd; per
// arc outputs (gamma, contributions) go straight to global memory. Then one
// pass over the K slots takes the guarded log, the renormalising max m2 and
// the `active` blend. The Pallas kernels' one-hot matmul gather/scatter was a
// way around Mosaic and is not carried over.
//
// Bound. Each kernel reads its band once and writes its outputs once, so it
// is bound by bytes, but at B=32 only 32 of the 132 SMs hold a CTA and each
// frame is a chain of dependent block reductions: the kernels are latency
// bound per frame. K9 (below) takes that latency apart; K7, K8 and K10 are
// still the first design. Splitting the band of one utterance over a
// cluster of CTAs (DSMEM) is the next lever; not done here.
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

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();  // red is rewritten by the next call
  return r;
}

__device__ __forceinline__ float log_safe(float x) { return x > 0.f ? logf(x) : kNegInf; }

// new carry of the log recursion, stashed unnormalised in acc[k]; returns its max m2
__device__ __forceinline__ float slot_logs(float* acc, int K, float mx, float* red) {
  float lm = -INFINITY;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = log_safe(acc[k]) + mx;
    acc[k] = v;
    lm = fmaxf(lm, v);
  }
  return block_max(lm, red);
}

// K7
__global__ void __launch_bounds__(kThreads) logz_fwd_kernel(
    const float* __restrict__ obs, const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ active,
    float* __restrict__ alphas, float* __restrict__ norms, int T, int B, int A, int K) {
  extern __shared__ float smem[];
  float* alpha = smem;
  float* sum = smem + K;
  float* red = smem + 2 * K;
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int k = tid; k < K; k += kThreads) {
    alpha[k] = k == 0 ? 0.f : kNegInf;
    sum[k] = 0.f;
  }
  __syncthreads();
  float norm = 0.f;
  for (int t = 0; t < T; ++t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    const size_t off = row * A;
    float lmax = -INFINITY;
    for (int a = tid; a < A; a += kThreads)
      lmax = fmaxf(lmax, alpha[src[off + a]] + w[off + a] + obs[off + a]);
    const float mx = fmaxf(block_max(lmax, red), kNegInf);
    for (int a = tid; a < A; a += kThreads) {
      const float s = alpha[src[off + a]] + w[off + a] + obs[off + a];
      atomicAdd(&sum[dst[off + a]], expf(s - mx));
    }
    __syncthreads();
    const float m2 = slot_logs(sum, K, mx, red);
    const float act = active[row];
    for (int k = tid; k < K; k += kThreads) {
      const float v = act * (sum[k] - m2) + (1.f - act) * alpha[k];
      alpha[k] = v;
      alphas[row * K + k] = v;
      sum[k] = 0.f;
    }
    norm = norm + act * m2;
    if (tid == 0) norms[row] = norm;
    __syncthreads();
  }
}

// K8
__global__ void __launch_bounds__(kThreads) occupancies_bwd_kernel(
    const float* __restrict__ obs, const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ active,
    const float* __restrict__ alpha_prev, const float* __restrict__ anorm_prev,
    const float* __restrict__ final_w, const float* __restrict__ logz,
    float* __restrict__ gamma, int T, int B, int A, int K) {
  extern __shared__ float smem[];
  float* beta = smem;
  float* sum = smem + K;
  float* red = smem + 2 * K;
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int k = tid; k < K; k += kThreads) {
    beta[k] = final_w[static_cast<size_t>(b) * K + k];
    sum[k] = 0.f;
  }
  __syncthreads();
  const float lz = logz[b];
  float bnorm = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    const size_t off = row * A;
    float lmax = -INFINITY;
    for (int a = tid; a < A; a += kThreads)
      lmax = fmaxf(lmax, (w[off + a] + obs[off + a]) + beta[dst[off + a]]);
    const float mx = fmaxf(block_max(lmax, red), kNegInf);
    const float act = active[row];
    const float an = anorm_prev[row];
    for (int a = tid; a < A; a += kThreads) {
      const float ow = w[off + a] + obs[off + a];
      const float bd = beta[dst[off + a]];
      const int s = src[off + a];
      atomicAdd(&sum[s], expf(ow + bd - mx));
      const float lg = alpha_prev[row * K + s] + an + ow + bd + bnorm - lz;
      gamma[off + a] = act * expf(fminf(lg, 0.f));
    }
    __syncthreads();
    const float m2 = slot_logs(sum, K, mx, red);
    for (int k = tid; k < K; k += kThreads) {
      beta[k] = act * (sum[k] - m2) + (1.f - act) * beta[k];
      sum[k] = 0.f;
    }
    bnorm = bnorm + act * m2;
    __syncthreads();
  }
}

// expected-accuracy carry of the sMBR recursions: numer/denom, 0 where denom is 0
__device__ __forceinline__ float acc_ratio(float numer, float denom) {
  return denom > 0.f ? numer / denom : 0.f;
}

// ---------------------------------------------------------------------------
// K9, redesigned for the H100. Still one CTA of kThreads per utterance, but
// the frame's latency is taken apart:
// - the band (obs, w, arc_acc, src, dst: 20 bytes an arc) of frames t+1 ..
//   t+S-1 streams into a shared-memory ring of S stages while frame t runs:
//   one thread issues a frame's five rows as cp.async.bulk copies that
//   complete on the stage's mbarrier; a stage holds the frame's first
//   CH = min(A, kRegArcs * kThreads) arcs (the host picks 2 <= S <= 4 from
//   the shared memory the [K] carries leave). Arcs past CH are read from
//   global memory, and so is every arc when there is no ring: A not a
//   multiple of 4, a row not 16-byte aligned, or two stages do not fit;
// - each thread computes its arcs' scores and accuracies once, keeps them
//   in registers (kRegArcs a thread; arcs past that are recomputed from
//   the unchanged carries) from the max to the scatter;
// - four barriers a frame, not six: warp-shuffle maxima, one exchange of
//   the kWarps warp values, which every warp reduces with four shuffles;
// - an arc whose exp is exactly 0 (padding in a frame with live arcs) stays
//   out of the shared atomics: adding +0 changes no sum. An active frame of
//   padding arcs only still adds exp(0) = 1 to slot 0, as the reference;
// - an inactive frame (active == 0) does no arc work: the blend would keep
//   the carries exactly (its new values are finite), so it writes them out.
// The ring and the two reductions are written to be shared with K10.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, B=32, T=448, K=256,
// A=512, a decoded batch): 0.937 ms a call against 3.14 ms; clock stamps
// (tools/kernel_split.py) put a frame's pass 2 (the atomics) at ~24% and
// pass 1 and the slot pass at ~17% each.
// ---------------------------------------------------------------------------

constexpr int kRegArcs = 4;  // arcs a thread keeps in registers in a frame
constexpr int kMaxStages = 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// A frame's band in the ring: five rows of ch words, obs, w, arc_acc, src, dst.
struct BandRows {
  const float* obs;
  const float* w;
  const float* acc;
  const int* src;
  const int* dst;
};

// The band ring: S stages of five rows of ch words (ch a multiple of 4,
// rows 16-byte aligned); frame f lives in stage f % S. The last thread (the
// one least likely to hold arcs or slots) fills a stage with five
// cp.async.bulk copies that complete on the stage's mbarrier.
struct BandRing {
  float* base;
  unsigned long long* bar;  // [S] mbarriers
  int S, ch;                // stages, arcs a stage

  static constexpr int kIssuer = kThreads - 1;

  __device__ float* stage(int f) const { return base + (f % S) * 5 * ch; }

  // the issuer initialises the mbarriers; the caller's barrier publishes them
  __device__ void init() const {
    if (threadIdx.x != kIssuer) return;
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // frame f (of T), whose band rows start at off, into its stage; every
  // thread may call it
  __device__ void fill(int f, int T, const BandRows& g, size_t off) const {
    if (f >= T || threadIdx.x != kIssuer) return;
    float* st = stage(f);
    const unsigned mb = smem_addr(bar + f % S);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
                 "r"(5 * ch * 4) : "memory");
    const void* rows[5] = {g.obs + off, g.w + off, g.acc + off, g.src + off, g.dst + off};
#pragma unroll
    for (int r = 0; r < 5; ++r)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(st + r * ch)),
          "l"(rows[r]), "r"(ch * 4), "r"(mb) : "memory");
  }

  // frame f's stage has landed
  __device__ void wait(int f) const {
    const unsigned mb = smem_addr(bar + f % S), parity = (f / S) & 1;
    unsigned done = 0;
    do {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(mb), "r"(parity) : "memory");
    } while (!done);
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

// K9
__global__ void __launch_bounds__(kThreads) smbr_fwd_kernel(
    const float* __restrict__ obs, const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ active,
    const float* __restrict__ arc_acc, float* __restrict__ alphas,
    float* __restrict__ aaccs, float* __restrict__ norms, int T, int B, int A, int K,
    int S, int ch) {
  extern __shared__ __align__(16) float ring_smem[];
  float* alpha = ring_smem;
  float* aacc = ring_smem + K;
  float* sum = ring_smem + 2 * K;
  float* num = ring_smem + 3 * K;
  float* red = ring_smem + 4 * K;
  float* ring_base = red + kWarps;  // S stages of 5 * ch words (16-byte aligned), S mbarriers
  const BandRing ring{ring_base, reinterpret_cast<unsigned long long*>(ring_base + S * 5 * ch), S,
                      ch};
  const int b = blockIdx.x, tid = threadIdx.x;
  const BandRows g{obs, w, arc_acc, src, dst};
  const int nring = S > 0 ? ch : 0;
  const size_t frame = static_cast<size_t>(B) * A;  // words from one frame's band to the next
  for (int k = tid; k < K; k += kThreads) {
    alpha[k] = k == 0 ? 0.f : kNegInf;
    aacc[k] = 0.f;
    sum[k] = 0.f;
    num[k] = 0.f;
  }
  ring.init();
  __syncthreads();
  for (int f = 0; f < S; ++f) ring.fill(f, T, g, f * frame + static_cast<size_t>(b) * A);
  float norm = 0.f;
  float act_next = active[b];
  for (int t = 0; t < T; ++t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    const size_t off = row * A;
    const float act = act_next;
    if (t + 1 < T) act_next = active[row + B];  // in flight during the frame
    const float* stage = S > 0 ? ring.stage(t) : ring_base;
    const int* ssrc = reinterpret_cast<const int*>(stage + 3 * ch);
    const int* sdst = reinterpret_cast<const int*>(stage + 4 * ch);
    if (S > 0) ring.wait(t);  // frame t's stage has landed
    __syncthreads();  // B0: ... in every thread, and the last frame's carries are final
    if (act == 0.f) {  // the blend keeps the carries: write them out, skip the arcs
      for (int k = tid; k < K; k += kThreads) {
        alphas[row * K + k] = alpha[k];
        aaccs[row * K + k] = aacc[k];
      }
      if (tid == 0) norms[row] = norm;
      if (S > 0) ring.fill(t + S, T, g, off + S * frame);  // no one reads frame t's stage
      continue;
    }
    // pass 1: scores and accuracies of this thread's arcs, and their max
    float sc[kRegArcs], ai[kRegArcs];
    int dd[kRegArcs];
    float lmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kRegArcs; ++j) {
      const int a = tid + j * kThreads;
      if (a < A) {
        int s;
        float o, ww, ac;
        if (a < nring) {
          o = stage[a];
          ww = stage[ch + a];
          ac = stage[2 * ch + a];
          s = ssrc[a];
          dd[j] = sdst[a];
        } else {
          o = obs[off + a];
          ww = w[off + a];
          ac = arc_acc[off + a];
          s = src[off + a];
          dd[j] = dst[off + a];
        }
        sc[j] = alpha[s] + ww + o;
        ai[j] = aacc[s] + ac;
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
          atomicAdd(&num[dd[j]], lin * ai[j]);
        }
      }
    }
    for (int a = tid + kRegArcs * kThreads; a < A; a += kThreads) {
      const int s = src[off + a], d = dst[off + a];
      const float lin = expf(alpha[s] + w[off + a] + obs[off + a] - mx);
      if (lin != 0.f) {
        atomicAdd(&sum[d], lin);
        atomicAdd(&num[d], lin * (aacc[s] + arc_acc[off + a]));
      }
    }
    __syncthreads();  // B2: every arc is in its slot
    if (S > 0) ring.fill(t + S, T, g, off + S * frame);  // stage t is free since B1
    float lm = -INFINITY;
    for (int k = tid; k < K; k += kThreads) {
      const float r = acc_ratio(num[k], sum[k]);
      const float v = log_safe(sum[k]) + mx;
      num[k] = r;
      sum[k] = v;
      lm = fmaxf(lm, v);
    }
    post_warp_max(lm, red);
    __syncthreads();  // B3: the slots' maxima are in
    const float m2 = read_block_max(red);
    for (int k = tid; k < K; k += kThreads) {
      const float v = act * (sum[k] - m2) + (1.f - act) * alpha[k];
      const float c = act * num[k] + (1.f - act) * aacc[k];
      alpha[k] = v;
      aacc[k] = c;
      alphas[row * K + k] = v;
      aaccs[row * K + k] = c;
      sum[k] = 0.f;
      num[k] = 0.f;
    }
    norm = norm + act * m2;
    if (tid == 0) norms[row] = norm;
  }
}

// K10
__global__ void __launch_bounds__(kThreads) smbr_bwd_kernel(
    const float* __restrict__ obs, const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ active,
    const float* __restrict__ arc_acc, const float* __restrict__ alpha_prev,
    const float* __restrict__ aacc_prev, const float* __restrict__ anorm_prev,
    const float* __restrict__ final_w, const float* __restrict__ logz,
    const float* __restrict__ f, float* __restrict__ contrib, int T, int B, int A, int K) {
  extern __shared__ float smem[];
  float* beta = smem;
  float* bacc = smem + K;
  float* sum = smem + 2 * K;
  float* num = smem + 3 * K;
  float* red = smem + 4 * K;
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int k = tid; k < K; k += kThreads) {
    beta[k] = final_w[static_cast<size_t>(b) * K + k];
    bacc[k] = 0.f;
    sum[k] = 0.f;
    num[k] = 0.f;
  }
  __syncthreads();
  const float lz = logz[b], fb = f[b];
  float bnorm = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * B + b;
    const size_t off = row * A;
    float lmax = -INFINITY;
    for (int a = tid; a < A; a += kThreads)
      lmax = fmaxf(lmax, (w[off + a] + obs[off + a]) + beta[dst[off + a]]);
    const float mx = fmaxf(block_max(lmax, red), kNegInf);
    const float act = active[row];
    const float an = anorm_prev[row];
    for (int a = tid; a < A; a += kThreads) {
      const int s = src[off + a], d = dst[off + a];
      const float ow = w[off + a] + obs[off + a];
      const float bd = beta[d], bcd = bacc[d], acc = arc_acc[off + a];
      const float lg = alpha_prev[row * K + s] + an + ow + bd + bnorm - lz;
      const float g = expf(fminf(lg, 0.f));
      const float c = aacc_prev[row * K + s] + acc + bcd;
      contrib[off + a] = act * (g * (c - fb));
      const float lin = expf(ow + bd - mx);
      atomicAdd(&sum[s], lin);
      atomicAdd(&num[s], lin * (acc + bcd));
    }
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) num[k] = acc_ratio(num[k], sum[k]);
    const float m2 = slot_logs(sum, K, mx, red);
    for (int k = tid; k < K; k += kThreads) {
      beta[k] = act * (sum[k] - m2) + (1.f - act) * beta[k];
      bacc[k] = act * num[k] + (1.f - act) * bacc[k];
      sum[k] = 0.f;
      num[k] = 0.f;
    }
    bnorm = bnorm + act * m2;
    __syncthreads();
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

}  // namespace

extern "C" {

// largest slot count K whose n_bufs shared [K] buffers fit one CTA
int pk2_latfb_max_slots(int n_bufs) {
  return (kMaxSmemBytes / static_cast<int>(sizeof(float)) - kWarps) / n_bufs;
}

int pk2_latfb_logz_fwd(const float* obs, const int* src, const int* dst, const float* w,
                       const float* active, float* alphas, float* norms, int T, int B,
                       int A, int K, void* stream) {
  const size_t smem = smem_bytes(2, K);
  cudaError_t e = prepare(logz_fwd_kernel, smem);
  if (e != cudaSuccess) return e;
  logz_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, src, dst, w, active, alphas, norms, T, B, A, K);
  return cudaGetLastError();
}

int pk2_latfb_occupancies_bwd(const float* obs, const int* src, const int* dst, const float* w,
                              const float* active, const float* alpha_prev,
                              const float* anorm_prev, const float* final_w,
                              const float* logz, float* gamma, int T, int B, int A, int K,
                              void* stream) {
  const size_t smem = smem_bytes(2, K);
  cudaError_t e = prepare(occupancies_bwd_kernel, smem);
  if (e != cudaSuccess) return e;
  occupancies_bwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, src, dst, w, active, alpha_prev, anorm_prev, final_w, logz, gamma, T, B, A, K);
  return cudaGetLastError();
}

// K9's ring at (A, K): *stages (0: no ring) stages of *chunk arcs each, and
// the dynamic shared memory of the launch; -1 if K's carries do not fit.
// The bulk copies move whole 16-byte words, so A % 4 != 0 takes no ring.
static int smbr_fwd_ring(int A, int K, int* stages, int* chunk, size_t* smem) {
  const size_t carries = smem_bytes(4, K), bars = kMaxStages * sizeof(unsigned long long);
  *stages = *chunk = 0;
  *smem = carries;
  if (carries > static_cast<size_t>(kMaxSmemBytes)) return -1;
  if (A % 4 != 0 || carries + bars >= static_cast<size_t>(kMaxSmemBytes)) return 0;
  const size_t room = kMaxSmemBytes - carries - bars;
  const int ch = A < kRegArcs * kThreads ? A : kRegArcs * kThreads;
  for (int s = kMaxStages; s >= 2; --s) {
    if (static_cast<size_t>(s) * 5 * ch * sizeof(float) > room) continue;
    *stages = s;
    *chunk = ch;
    *smem = carries + static_cast<size_t>(s) * 5 * ch * sizeof(float) + bars;
    return 0;
  }
  return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

int pk2_latfb_smbr_fwd_ring(int A, int K, int* stages, int* chunk) {
  size_t smem = 0;
  return smbr_fwd_ring(A, K, stages, chunk, &smem) < 0 ? cudaErrorInvalidValue : 0;
}

int pk2_latfb_smbr_fwd(const float* obs, const int* src, const int* dst, const float* w,
                       const float* active, const float* arc_acc, float* alphas,
                       float* aaccs, float* norms, int T, int B, int A, int K,
                       void* stream) {
  int stages = 0, ch = 0;
  size_t smem = 0;
  if (smbr_fwd_ring(A, K, &stages, &ch, &smem) < 0) return cudaErrorInvalidValue;
  if (!(aligned16(obs) && aligned16(src) && aligned16(dst) && aligned16(w) &&
        aligned16(arc_acc))) {  // the bulk copies need 16-byte aligned rows: no ring
    stages = ch = 0;
    smem = smem_bytes(4, K);
  }
  cudaError_t e = prepare(smbr_fwd_kernel, smem);
  if (e != cudaSuccess) return e;
  smbr_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, src, dst, w, active, arc_acc, alphas, aaccs, norms, T, B, A, K, stages, ch);
  return cudaGetLastError();
}

int pk2_latfb_smbr_bwd(const float* obs, const int* src, const int* dst, const float* w,
                       const float* active, const float* arc_acc, const float* alpha_prev,
                       const float* aacc_prev, const float* anorm_prev,
                       const float* final_w, const float* logz, const float* f,
                       float* contrib, int T, int B, int A, int K, void* stream) {
  const size_t smem = smem_bytes(4, K);
  cudaError_t e = prepare(smbr_bwd_kernel, smem);
  if (e != cudaSuccess) return e;
  smbr_bwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, src, dst, w, active, arc_acc, alpha_prev, aacc_prev, anorm_prev, final_w, logz,
      f, contrib, T, B, A, K);
  return cudaGetLastError();
}

}  // extern "C"
