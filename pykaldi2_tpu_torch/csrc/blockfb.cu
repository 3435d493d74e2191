// Block-sparse matvec of the fixed-denominator forward-backward: kernel K11.
//
// Replaces pykaldi2_tpu/ops/fb_block.py:_bmv_kernel (called through
// _block_matvec_pallas): out = x @ W for a transition matrix W stored as its
// nonzero 128x128 tiles,
//
//   out[:, j_n*128 + l] += sum_k x[:, i_n*128 + k] * W_n[k, l]   for every tile n,
//
// with output blocks that no tile reaches coming out as zeros. x [R, Sp] and
// out [R, Sp] are fp32 row-major (Sp = nblk*128); tiles [nc, 128, 128] fp32 are
// sorted by output block j, and rowptr [nblk+1] (CSR) gives each output
// block's run of tiles; src_blk [nc] the source block i of each. The
// transposed orientation of the beta recursion is a second tile list with its
// own sort and rowptr; nothing reads tiles strided.
//
// Design. The tile run of each output block is cut into segments of at most
// `seg_tiles` tiles (segptr [nblk+1], CSR over segments), and one CTA takes
// one (segment, tile of RT rows): a graph whose loop state gathers from every
// chain gives one output block tens of tiles, and a CTA per block would walk
// them alone while the rest of the card idles. A CTA walks its tiles in
// chunks of 32 k-rows; each chunk stages W[32, 128] (16 KB) and the matching
// x[RT, 32] slice with cp.async into one of two shared-memory stages, so the
// next chunk's copy overlaps this chunk's products. 256 threads: thread t
// owns column t % 128 and half of each chunk's k-rows (t / 128), keeps RT
// fp32 accumulators in registers, reads its W element once per k and the x
// values as broadcast float4s. The two k-halves are summed through shared
// memory. A block with one segment writes its output directly, coalesced; a
// block with several writes each segment's partial to scratch, and the CTA
// that finishes last (a per-block counter, reset to 0 by that CTA for the
// next call) sums the partials in segment order and writes the output. No
// atomics on data: the result is the same from run to run.
//
// Bound. At the fixed-denominator slice (96,128 padded states, 1,502 tiles,
// R = 16 or 32) the tiles are 98.4 MB against 6-12 MB of x and of out, and the
// fp32 work is 2·R·128²·nc ≈ 0.8-1.6 GFLOP: the kernel is bound by bytes
// (tile reads). Every tile is read once per row tile, so R ≤ 32 reads each
// tile exactly once. The reference's dot is Precision.HIGHEST, so the products
// are IEEE fp32 FMAs: no TF32, no tensor cores.
//
// Numerics. x is nonnegative (linear carries) and the tiles are
// probabilities, so every partial sum is nonnegative and a padded state (a
// zero column of every tile, a zero entry of x) stays exactly 0.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 128;    // tile edge (the packing's block size)
constexpr int kChunk = 32;     // k-rows of a tile staged per step
constexpr int kThreads = 256;  // 128 columns x 2 k-halves
constexpr int kHalf = kChunk / 2;

template <int RT>
struct Stage {
  float w[kChunk][kBlock];  // W_n[k0 + kk, :]
  float x[RT][kChunk];      // x[r0 + r, i_n*128 + k0 + kk]
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// stage chunk q (tile n0 + q/4, k-rows (q%4)*32 ...) of this CTA's run
template <int RT>
__device__ __forceinline__ void load_chunk(Stage<RT>& st, const float* __restrict__ x,
                                           const float* __restrict__ tiles,
                                           const int* __restrict__ src_blk, int n0, int q,
                                           int r0, int R, int Sp) {
  const int n = n0 + q / (kBlock / kChunk);
  const int k0 = (q % (kBlock / kChunk)) * kChunk;
  const float* wsrc = tiles + (static_cast<size_t>(n) * kBlock + k0) * kBlock;
  // W chunk: 32 x 128 floats = 1024 float4s, 4 per thread
  for (int v = threadIdx.x; v < kChunk * kBlock / 4; v += kThreads) {
    const int kk = v / (kBlock / 4), c4 = v % (kBlock / 4);
    cp_async16(&st.w[kk][c4 * 4], wsrc + static_cast<size_t>(kk) * kBlock + c4 * 4, 16);
  }
  // x slice: RT rows x 32 floats; rows past R are zero-filled
  const size_t col = static_cast<size_t>(src_blk[n]) * kBlock + k0;
  for (int v = threadIdx.x; v < RT * kChunk / 4; v += kThreads) {
    const int r = v / (kChunk / 4), c4 = v % (kChunk / 4);
    const int row = r0 + r;
    const bool live = row < R;
    const float* src = x + static_cast<size_t>(live ? row : 0) * Sp + col + c4 * 4;
    cp_async16(&st.x[r][c4 * 4], src, live ? 16 : 0);
  }
}

// the output block whose segment run holds segment s (segptr is sorted)
__device__ __forceinline__ int block_of_segment(const int* __restrict__ segptr, int nblk, int s) {
  int lo = 0, hi = nblk;  // segptr[lo] <= s < segptr[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (segptr[mid] <= s) lo = mid; else hi = mid;
  }
  return lo;
}

template <int RT>
__global__ void __launch_bounds__(kThreads) block_matvec_kernel(
    const float* __restrict__ x, const float* __restrict__ tiles,
    const int* __restrict__ src_blk, const int* __restrict__ rowptr,
    const int* __restrict__ segptr, int nblk, int seg_tiles, float* __restrict__ partial,
    int* __restrict__ counters, float* __restrict__ out, int R, int Sp) {
  __shared__ __align__(16) Stage<RT> stage[2];
  __shared__ int last;
  const int seg = blockIdx.x;
  const int j = block_of_segment(segptr, nblk, seg);
  const int first_seg = segptr[j], nsegs = segptr[j + 1] - first_seg;
  const int r0 = blockIdx.y * RT;
  const int tid = threadIdx.x;
  const int c = tid % kBlock;
  const int kh = tid / kBlock;  // which half of each chunk's k-rows
  const int n0 = rowptr[j] + (seg - first_seg) * seg_tiles;
  const int n1 = min(n0 + seg_tiles, rowptr[j + 1]);
  const int nchunks = max(n1 - n0, 0) * (kBlock / kChunk);

  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;

  if (nchunks > 0) load_chunk<RT>(stage[0], x, tiles, src_blk, n0, 0, r0, R, Sp);
  cp_async_commit();
  for (int q = 0; q < nchunks; ++q) {
    if (q + 1 < nchunks) {
      load_chunk<RT>(stage[(q + 1) & 1], x, tiles, src_blk, n0, q + 1, r0, R, Sp);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage<RT>& st = stage[q & 1];
#pragma unroll
    for (int k4 = 0; k4 < kHalf; k4 += 4) {
      const int kk = kh * kHalf + k4;
      const float w0 = st.w[kk][c], w1 = st.w[kk + 1][c];
      const float w2 = st.w[kk + 2][c], w3 = st.w[kk + 3][c];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(&st.x[r][kk]);
        float a = acc[r];
        a = fmaf(xv.x, w0, a);
        a = fmaf(xv.y, w1, a);
        a = fmaf(xv.z, w2, a);
        a = fmaf(xv.w, w3, a);
        acc[r] = a;
      }
    }
    __syncthreads();  // the stage is refilled two chunks later
  }

  // sum the two k-halves (stage 0's W area holds RT x 128 partials: RT <= 32)
  float* part = &stage[0].w[0][0];
  if (kh == 1) {
#pragma unroll
    for (int r = 0; r < RT; ++r) part[r * kBlock + c] = acc[r];
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(j) * kBlock + c;
  if (nsegs == 1) {
    if (kh == 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (r0 + r < R) o[static_cast<size_t>(r0 + r) * Sp] = acc[r] + part[r * kBlock + c];
    }
    return;
  }
  // several segments: publish this one's partial, the last CTA sums them
  const size_t ytile = static_cast<size_t>(gridDim.y);
  if (kh == 0) {
    float* mine = partial + ((seg * ytile + blockIdx.y) * RT) * kBlock + c;
#pragma unroll
    for (int r = 0; r < RT; ++r) mine[r * kBlock] = acc[r] + part[r * kBlock + c];
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + j * ytile + blockIdx.y;
  if (tid == 0) last = atomicAdd(counter, 1) == nsegs - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (kh == 0) {
    for (int r = 0; r < RT && r0 + r < R; ++r) {
      float v = 0.f;
      for (int q = first_seg; q < first_seg + nsegs; ++q)
        v += __ldcg(partial + ((q * ytile + blockIdx.y) * RT + r) * kBlock + c);
      o[static_cast<size_t>(r0 + r) * Sp] = v;
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

template <int RT>
int launch(const float* x, const float* tiles, const int* src_blk, const int* rowptr,
           const int* segptr, int nseg, int seg_tiles, float* partial, int* counters,
           float* out, int R, int nblk, cudaStream_t stream) {
  const dim3 grid(nseg, (R + RT - 1) / RT);
  block_matvec_kernel<RT><<<grid, kThreads, 0, stream>>>(
      x, tiles, src_blk, rowptr, segptr, nblk, seg_tiles, partial, counters, out, R,
      nblk * kBlock);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pk2_blockfb_block_size() { return kBlock; }

// rows of the tile a CTA takes for R rows (the partial buffer holds
// nseg x ceil(R / RT) x RT x 128 floats, the counters nblk x ceil(R / RT))
int pk2_blockfb_row_tile(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : 32; }

// out [R, nblk*128] = x [R, nblk*128] @ (block-sparse W); R >= 1, any count.
// counters start at 0 and are left at 0.
int pk2_blockfb_matvec(const float* x, const float* tiles, const int* src_blk,
                       const int* rowptr, const int* segptr, float* partial, int* counters,
                       float* out, int R, int nblk, int nseg, int seg_tiles, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pk2_blockfb_row_tile(R)) {
    case 8:
      return launch<8>(x, tiles, src_blk, rowptr, segptr, nseg, seg_tiles, partial, counters,
                       out, R, nblk, s);
    case 16:
      return launch<16>(x, tiles, src_blk, rowptr, segptr, nseg, seg_tiles, partial, counters,
                        out, R, nblk, s);
    default:
      return launch<32>(x, tiles, src_blk, rowptr, segptr, nseg, seg_tiles, partial, counters,
                        out, R, nblk, s);
  }
}

}  // extern "C"
