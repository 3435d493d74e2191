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
// [K] segment-sum accumulators live in shared memory for all of T. Per frame
// one pass over the A arcs of the band computes the scores and their block
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
// bound per frame. Splitting the band of one utterance over a cluster of
// CTAs (DSMEM) is the way to fill the card; not done here.
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

// K9
__global__ void __launch_bounds__(kThreads) smbr_fwd_kernel(
    const float* __restrict__ obs, const int* __restrict__ src, const int* __restrict__ dst,
    const float* __restrict__ w, const float* __restrict__ active,
    const float* __restrict__ arc_acc, float* __restrict__ alphas,
    float* __restrict__ aaccs, float* __restrict__ norms, int T, int B, int A, int K) {
  extern __shared__ float smem[];
  float* alpha = smem;
  float* aacc = smem + K;
  float* sum = smem + 2 * K;
  float* num = smem + 3 * K;
  float* red = smem + 4 * K;
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int k = tid; k < K; k += kThreads) {
    alpha[k] = k == 0 ? 0.f : kNegInf;
    aacc[k] = 0.f;
    sum[k] = 0.f;
    num[k] = 0.f;
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
      const int s = src[off + a], d = dst[off + a];
      const float lin = expf(alpha[s] + w[off + a] + obs[off + a] - mx);
      const float acc_in = aacc[s] + arc_acc[off + a];
      atomicAdd(&sum[d], lin);
      atomicAdd(&num[d], lin * acc_in);
    }
    __syncthreads();
    for (int k = tid; k < K; k += kThreads) num[k] = acc_ratio(num[k], sum[k]);
    const float m2 = slot_logs(sum, K, mx, red);
    const float act = active[row];
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
    __syncthreads();
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

int pk2_latfb_smbr_fwd(const float* obs, const int* src, const int* dst, const float* w,
                       const float* active, const float* arc_acc, float* alphas,
                       float* aaccs, float* norms, int T, int B, int A, int K,
                       void* stream) {
  const size_t smem = smem_bytes(4, K);
  cudaError_t e = prepare(smbr_fwd_kernel, smem);
  if (e != cudaSuccess) return e;
  smbr_fwd_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      obs, src, dst, w, active, arc_acc, alphas, aaccs, norms, T, B, A, K);
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
