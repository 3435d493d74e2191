// Fused log-mel filterbank (kernel K1) and fused MFCC (kernel K4) for
// sm_90a, plain C interface for ctypes.
//
// Replaces: pykaldi2_tpu/frontend/fused.py:_kernel (the Pallas fused fbank,
// K1) and :_mfcc_kernel (the Pallas fused MFCC, K4).
// K1 computes, per frame row: framing through a sample-index table, DC
// removal over the real window, pre-emphasis, the analysis window, the real
// DFT as cos/sin products, the power spectrum, the mel product and a log
// with a FLT_EPSILON floor. Only the log-mel rows reach device memory.
// K4 is K1 plus two steps: the raw log-energy of each row (the sum of
// squares after DC removal and before pre-emphasis, floored at FLT_EPSILON
// before the log and at log(energy_floor) after it), and the product of the
// log-mel row with the DCT matrix (lifter folded in, [M, C]) while the row
// is still in shared memory; column 0 becomes the log-energy when
// use_energy. Only the C cepstra of a row reach device memory.
//
// Bound on the H100: fp32 operations. The front end is fp32-exact by
// contract, so there are no tensor cores, no TF32 and no fast math: K1 does
// 2*rows*win*K*2 flops for the DFT plus 2*rows*K*M for the mel product; K4
// adds 2*rows*M*C for the DCT, against ~67 TFLOP/s of fp32 FMA. The bytes
// moved (waveform in, features out, ~1 MB of tables read through L2) are a
// few MB and far below that.
//
// Design: a block takes ROWS frame rows. One warp per row frames, centres,
// pre-emphasises (neighbour through a warp shuffle) and windows the samples,
// and stores them transposed in shared memory ([n][row], float4-aligned), so
// that in the DFT loop each thread (one frequency bin k) reads one table
// value per n and broadcasts ROWS frame values as float4 loads; the sum runs
// over the win real samples only (the zero padding up to n_fft adds nothing).
// The power spectrum stays in shared memory for the mel product. K4 is the
// same kernel instantiated with kMfcc: the row's energy is a warp reduction
// in the framing pass, and the log-mel rows stay in shared memory for the
// DCT product.

#include <cuda_runtime.h>
#include <stdint.h>

#define FB_ROWS 32
#define FB_THREADS 256
#define FB_LDX (FB_ROWS + 4)  // float4-aligned rows that spread banks

template <bool kMfcc>
__global__ void __launch_bounds__(FB_THREADS, 2)
fbank_kernel(const float* __restrict__ wave,   // [B, S]
             const int* __restrict__ fidx,      // [T, W] sample index of each frame element
             const float* __restrict__ win,     // [W] analysis window
             const float* __restrict__ cosm,    // [W, K] DFT cos table (rows n < W)
             const float* __restrict__ sinm,    // [W, K] DFT -sin table
             const float* __restrict__ melT,    // [K, M] mel weights, transposed
             const float* __restrict__ dctT,    // [M, C] lifted DCT, transposed (K4)
             float* __restrict__ out,           // [B*T, M] (K1) or [B*T, C] (K4)
             int B, int S, int T, int W, int K, int M, int C,
             int remove_dc, float preemph, float log_floor,
             int use_energy, float log_energy_floor) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // [W][FB_LDX] processed frames, transposed
  float* spec = xs + W * FB_LDX;      // [FB_ROWS][K] power spectrum
  float* lmel = spec + FB_ROWS * K;   // [FB_ROWS][M] log-mel rows (K4)
  float* elog = lmel + FB_ROWS * M;   // [FB_ROWS] raw log-energy (K4)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = FB_THREADS / 32;
  const int nrows = B * T;
  const int row0 = blockIdx.x * FB_ROWS;
  const unsigned full = 0xffffffffu;

  // 1. framing, DC removal, pre-emphasis, window: one warp per frame row
  for (int r = warp; r < FB_ROWS; r += nwarps) {
    const int row = row0 + r;
    if (row >= nrows) {
      for (int j = lane; j < W; j += 32) xs[j * FB_LDX + r] = 0.f;
      continue;
    }
    const float* wb = wave + (size_t)(row / T) * S;
    const int* ix = fidx + (size_t)(row % T) * W;
    float mean = 0.f;
    if (remove_dc) {
      float s = 0.f;
      for (int j = lane; j < W; j += 32) s += wb[ix[j]];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(full, s, o);
      mean = s / (float)W;
    }
    float carry = 0.f;  // last centred sample of the previous 32-sample chunk
    float energy = 0.f;
    for (int base = 0; base < W; base += 32) {
      const int j = base + lane;
      const float cur = (j < W) ? wb[ix[j]] - mean : 0.f;
      if (kMfcc) energy = fmaf(cur, cur, energy);  // raw energy: before pre-emphasis
      float prev = __shfl_up_sync(full, cur, 1);
      if (lane == 0) prev = (base == 0) ? cur : carry;  // Kaldi: w[0] -= c*w[0]
      carry = __shfl_sync(full, cur, 31);
      if (j < W) xs[j * FB_LDX + r] = (cur - preemph * prev) * win[j];
    }
    if (kMfcc && use_energy) {
      for (int o = 16; o > 0; o >>= 1) energy += __shfl_xor_sync(full, energy, o);
      if (lane == 0) elog[r] = fmaxf(logf(fmaxf(energy, log_floor)), log_energy_floor);
    }
  }
  __syncthreads();

  // 2. real DFT (fp32 FMA) and power spectrum: thread k owns one bin for all rows
  for (int k = tid; k < K; k += FB_THREADS) {
    float re[FB_ROWS], im[FB_ROWS];
#pragma unroll
    for (int r = 0; r < FB_ROWS; ++r) { re[r] = 0.f; im[r] = 0.f; }
    for (int n = 0; n < W; ++n) {
      const float c = __ldg(cosm + (size_t)n * K + k);
      const float s = __ldg(sinm + (size_t)n * K + k);
      const float4* xr = reinterpret_cast<const float4*>(xs + n * FB_LDX);
#pragma unroll
      for (int q = 0; q < FB_ROWS / 4; ++q) {
        const float4 v = xr[q];
        re[4 * q + 0] = fmaf(v.x, c, re[4 * q + 0]);
        re[4 * q + 1] = fmaf(v.y, c, re[4 * q + 1]);
        re[4 * q + 2] = fmaf(v.z, c, re[4 * q + 2]);
        re[4 * q + 3] = fmaf(v.w, c, re[4 * q + 3]);
        im[4 * q + 0] = fmaf(v.x, s, im[4 * q + 0]);
        im[4 * q + 1] = fmaf(v.y, s, im[4 * q + 1]);
        im[4 * q + 2] = fmaf(v.z, s, im[4 * q + 2]);
        im[4 * q + 3] = fmaf(v.w, s, im[4 * q + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < FB_ROWS; ++r) spec[r * K + k] = re[r] * re[r] + im[r] * im[r];
  }
  __syncthreads();

  // 3. mel product and log floor
  for (int idx = tid; idx < FB_ROWS * M; idx += FB_THREADS) {
    const int r = idx / M, m = idx % M;
    const int row = row0 + r;
    if (row >= nrows) continue;
    const float* sp = spec + r * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(sp[k], __ldg(melT + (size_t)k * M + m), acc);
    const float lm = logf(fmaxf(acc, log_floor));
    if (kMfcc) lmel[r * M + m] = lm;
    else out[(size_t)row * M + m] = lm;
  }
  if (!kMfcc) return;
  __syncthreads();

  // 4. (K4) DCT product with the lifter folded in; column 0 takes the energy
  for (int idx = tid; idx < FB_ROWS * C; idx += FB_THREADS) {
    const int r = idx / C, c = idx % C;
    const int row = row0 + r;
    if (row >= nrows) continue;
    const float* lm = lmel + r * M;
    float acc = 0.f;
    for (int m = 0; m < M; ++m) acc = fmaf(lm[m], __ldg(dctT + (size_t)m * C + c), acc);
    out[(size_t)row * C + c] = (use_energy && c == 0) ? elog[r] : acc;
  }
}

extern "C" size_t pk2_fbank_smem_bytes(int W, int K) {
  return (size_t)(W * FB_LDX + FB_ROWS * K) * sizeof(float);
}

static size_t mfcc_smem_bytes(int W, int K, int M) {
  return pk2_fbank_smem_bytes(W, K) + (size_t)(FB_ROWS * M + FB_ROWS) * sizeof(float);
}

// Returns a cudaError_t code: 0 on a clean launch.
extern "C" int pk2_fbank(const void* wave, const void* fidx, const void* win,
                         const void* cosm, const void* sinm, const void* melT,
                         void* out, int B, int S, int T, int W, int K, int M,
                         int remove_dc, float preemph, float log_floor,
                         void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || K <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = pk2_fbank_smem_bytes(W, K);
  cudaError_t e = cudaFuncSetAttribute(fbank_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B * T + FB_ROWS - 1) / FB_ROWS;
  fbank_kernel<false><<<grid, FB_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)wave, (const int*)fidx, (const float*)win, (const float*)cosm,
      (const float*)sinm, (const float*)melT, nullptr, (float*)out, B, S, T, W, K, M, 0,
      remove_dc, preemph, log_floor, 0, 0.f);
  return (int)cudaGetLastError();
}

// K4. log_energy_floor is log(energy_floor), or -inf for no floor. Returns a
// cudaError_t code: 0 on a clean launch.
extern "C" int pk2_mfcc(const void* wave, const void* fidx, const void* win,
                        const void* cosm, const void* sinm, const void* melT,
                        const void* dctT, void* out, int B, int S, int T, int W, int K,
                        int M, int C, int remove_dc, float preemph, float log_floor,
                        int use_energy, float log_energy_floor, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0 || K <= 0 || M <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mfcc_smem_bytes(W, K, M);
  cudaError_t e = cudaFuncSetAttribute(fbank_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (B * T + FB_ROWS - 1) / FB_ROWS;
  fbank_kernel<true><<<grid, FB_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)wave, (const int*)fidx, (const float*)win, (const float*)cosm,
      (const float*)sinm, (const float*)melT, (const float*)dctT, (float*)out, B, S, T, W,
      K, M, C, remove_dc, preemph, log_floor, use_energy, log_energy_floor);
  return (int)cudaGetLastError();
}
