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
// sorted by output block j; src_blk [nc] gives the source block i of each. The
// transposed orientation of the beta recursion is a second tile list with its
// own sort; nothing reads tiles strided.
//
// Work split. The tile run of each output block is cut into segments of at
// most seg_tiles tiles, and one CTA takes one (segment, tile of RT rows): a
// graph whose loop state gathers from every chain gives one output block tens
// of tiles, and a CTA per block would walk them alone while the rest of the
// card idles. segdesc [nseg] holds each segment's (output block, first tile,
// end tile, the block's first segment), so a CTA finds its work with one
// load; segptr [nblk+1] (CSR over segments) gives a block's segment count. A
// block with one segment writes its output directly; a block with several
// writes each segment's partial to scratch, and the CTA that finishes last (a
// per-block counter, reset to 0 by that CTA for the next call) sums the
// partials in segment order. No atomics on data: the result is the same bits
// from run to run.
//
// Bound. At the fixed-denominator slice (96,128 padded states, 1,502 tiles,
// R = 16 or 32) the tiles are 98.4 MB against 6-12 MB of x and of out, and the
// fp32 work is 2·R·128²·nc = 0.8-1.6 GFLOP: 33-37 us of bytes at 3.35 TB/s
// against 12-24 us of FMAs at 67 TFLOP/s. Every tile is read once per row
// tile, so R <= 32 reads each tile exactly once. The reference's dot is
// Precision.HIGHEST, so the products are IEEE fp32 FMAs: no TF32, no tensor
// cores. At R = 32 the FMAs are 2/3 of the byte time, so the issue rate of
// the product matters as much as the bytes in flight.
//
// Design. Clock stamps of the first version (one 2-stage ring per CTA, each
// thread owning one column and reading its x values as broadcast float4s,
// one load per 4 FMAs; a binary search for the segment's block) put 44-62% of
// a CTA in the FMA loop, 21-29% waiting for copies and 13-17% in the
// prologue. So:
// - the ring has kStages = 4 stages of one 32-row chunk of W (16 KB, copied
//   with cp.async as 4 float4s a thread) and the matching x[RT, 32] slice,
//   one __syncthreads a chunk, and up to 3 chunks in flight while one is
//   multiplied;
// - each thread owns a register tile of 8 rows x 4 columns: per 4 k-rows it
//   reads 8 float4s of x and 4 float4s of W and does 128 FMAs. A warp holds
//   RG = RT/8 row groups x 32/RG column groups; x rows are padded to 36
//   floats so the RG rows a warp reads fall in distinct banks, and the W
//   reads of a warp are contiguous. The warps split each chunk's 32 k-rows
//   into KP = 8/RG parts, summed through shared memory in part order;
// - the segment descriptor replaces the search; the source blocks of the
//   segment's tiles are read once into shared memory, before the ring starts;
// - all 256 threads write the output (float4s), and all of them sum a
//   multi-segment block's partials.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, the chain graph,
// forward / transposed): 0.045 / 0.046 ms at R = 16 and 0.061 / 0.064 ms at
// R = 32, against 0.062 / 0.056 and 0.087 / 0.092 ms for the first version.
// Copying each W chunk with one bulk copy completing on an mbarrier, instead
// of cp.async, was no faster (tools/kernel_ab.py).
//
// Numerics. x is nonnegative (linear carries) and the tiles are
// probabilities, so every partial sum is nonnegative and a padded state (a
// zero column of every tile, a zero entry of x) stays exactly 0.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 128;    // tile edge (the packing's block size)
constexpr int kChunk = 32;     // k-rows of a tile staged per step
constexpr int kThreads = 256;
constexpr int kStages = 4;     // chunks in the copy ring
constexpr int kXld = kChunk + 4;  // x row stride in shared memory (floats)
constexpr int kMaxSegTiles = 4;   // largest segment (tiles) the kernel takes

template <int RT>
struct Stage {
  float w[kChunk][kBlock];  // W_n[k0 + kk, :]
  float x[RT][kXld];        // x[r0 + r, i_n*128 + k0 + kk], kk < 32
};

template <int RT>
constexpr size_t smem_bytes() {
  return sizeof(Stage<RT>) * kStages;
}

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

// stage chunk q of this CTA's run (tile n0 + q/4, k-rows (q%4)*32 ...)
template <int RT>
__device__ __forceinline__ void load_chunk(Stage<RT>& st, const float* __restrict__ x,
                                           const float* __restrict__ tiles, int n, int src,
                                           int k0, int r0, int R, int Sp) {
  const float* wsrc = tiles + (static_cast<size_t>(n) * kBlock + k0) * kBlock;
  // W chunk: 32 x 128 floats = 1024 float4s, 4 a thread, contiguous
#pragma unroll
  for (int i = 0; i < kChunk * kBlock / 4 / kThreads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int kk = v / (kBlock / 4), c4 = v % (kBlock / 4);
    cp_async16(&st.w[kk][c4 * 4], wsrc + static_cast<size_t>(kk) * kBlock + c4 * 4, 16);
  }
  // x slice: RT rows x 32 floats; rows past R are zero-filled
  const size_t col = static_cast<size_t>(src) * kBlock + k0;
  for (int v = threadIdx.x; v < RT * kChunk / 4; v += kThreads) {
    const int r = v / (kChunk / 4), c4 = v % (kChunk / 4);
    const int row = r0 + r;
    const bool live = row < R;
    const float* p = x + static_cast<size_t>(live ? row : 0) * Sp + col + c4 * 4;
    cp_async16(&st.x[r][c4 * 4], p, live ? 16 : 0);
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads, 2) block_matvec_kernel(
    const float* __restrict__ x, const float* __restrict__ tiles,
    const int* __restrict__ src_blk, const int4* __restrict__ segdesc,
    const int* __restrict__ segptr, float* __restrict__ partial, int* __restrict__ counters,
    float* __restrict__ out, int R, int Sp) {
  constexpr int RG = RT / 8;           // row groups of a warp
  constexpr int CG = 32 / RG;          // column groups (4 columns each) of a warp
  constexpr int KP = 8 / RG;           // k-parts: warps that share output columns
  constexpr int KLEN = kChunk / KP;    // k-rows of a chunk per part
  static_assert(RT % 8 == 0 && RT <= 32 && KLEN % 4 == 0, "row tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<RT>* stage = reinterpret_cast<Stage<RT>*>(smem_raw);
  __shared__ int last, src[kMaxSegTiles];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int4 d = segdesc[blockIdx.x];  // (output block, first tile, end tile, first segment)
  const int j = d.x, n0 = d.y, nt = d.z - d.y, first_seg = d.w;
  const int nsegs = segptr[j + 1] - first_seg;
  const int r0 = blockIdx.y * RT;
  if (tid < nt) src[tid] = src_blk[n0 + tid];
  __syncthreads();
  const int nchunks = nt * (kBlock / kChunk);

  // this thread's register tile: rows rg + RG*i (i < 8), columns c0 .. c0+3,
  // k-rows kp*KLEN .. of every chunk
  const int rg = lane % RG, kp = warp / RG;
  const int c0 = ((warp % RG) * CG + lane / RG) * 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < nchunks)
      load_chunk<RT>(stage[q], x, tiles, n0 + q / 4, src[q / 4], (q % 4) * kChunk, r0, R, Sp);
    cp_async_commit();
  }
  for (int q = 0; q < nchunks; ++q) {
    cp_async_wait<kStages - 2>();  // chunk q has landed in this thread
    __syncthreads();               // ... in every thread; chunk q-1's stage is free
    const int qn = q + kStages - 1;
    if (qn < nchunks)
      load_chunk<RT>(stage[qn % kStages], x, tiles, n0 + qn / 4, src[qn / 4], (qn % 4) * kChunk,
                     r0, R, Sp);
    cp_async_commit();
    const Stage<RT>& st = stage[q % kStages];
#pragma unroll
    for (int k4 = 0; k4 < KLEN; k4 += 4) {
      const int kk = kp * KLEN + k4;
      float4 xv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = *reinterpret_cast<const float4*>(&st.x[rg + RG * i][kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 w = *reinterpret_cast<const float4*>(&st.w[kk + e][c0]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xe = e == 0 ? xv[i].x : e == 1 ? xv[i].y : e == 2 ? xv[i].z : xv[i].w;
          acc[i][0] = fmaf(xe, w.x, acc[i][0]);
          acc[i][1] = fmaf(xe, w.y, acc[i][1]);
          acc[i][2] = fmaf(xe, w.z, acc[i][2]);
          acc[i][3] = fmaf(xe, w.w, acc[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every product is done: the ring's space holds the parts

  // part kp's sums to plane kp [RT][128]; then out = sum of the planes in order
  float* planes = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(&planes[(kp * RT + rg + RG * i) * kBlock + c0]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  constexpr int kVecs = RT * kBlock / 4;  // float4s of the CTA's output tile
  const size_t ytile = static_cast<size_t>(gridDim.y);
  float* mine = nsegs == 1 ? nullptr
                           : partial + ((blockIdx.x * ytile + blockIdx.y) * RT) * kBlock;
  for (int v = tid; v < kVecs; v += kThreads) {
    const int r = v / (kBlock / 4), c = (v % (kBlock / 4)) * 4;
    float4 s = *reinterpret_cast<const float4*>(&planes[r * kBlock + c]);
#pragma unroll
    for (int p = 1; p < KP; ++p) {
      const float4 u = *reinterpret_cast<const float4*>(&planes[(p * RT + r) * kBlock + c]);
      s.x += u.x;
      s.y += u.y;
      s.z += u.z;
      s.w += u.w;
    }
    if (mine != nullptr)
      *reinterpret_cast<float4*>(mine + r * kBlock + c) = s;
    else if (r0 + r < R)
      *reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + r) * Sp +
                                 static_cast<size_t>(j) * kBlock + c) = s;
  }
  if (mine == nullptr) return;

  // several segments: the CTA that finishes last sums the partials in order
  __threadfence();
  __syncthreads();
  int* counter = counters + j * ytile + blockIdx.y;
  if (tid == 0) last = atomicAdd(counter, 1) == nsegs - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int v = tid; v < kVecs; v += kThreads) {
    const int r = v / (kBlock / 4), c = (v % (kBlock / 4)) * 4;
    if (r0 + r >= R) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = first_seg; q < first_seg + nsegs; ++q) {
      const float4 u = __ldcg(reinterpret_cast<const float4*>(
          partial + ((q * ytile + blockIdx.y) * RT + r) * kBlock + c));
      s.x += u.x;
      s.y += u.y;
      s.z += u.z;
      s.w += u.w;
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(r0 + r) * Sp +
                               static_cast<size_t>(j) * kBlock + c) = s;
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

template <int RT>
int launch(const float* x, const float* tiles, const int* src_blk, const int* segdesc,
           const int* segptr, int nseg, float* partial, int* counters, float* out, int R,
           int nblk, cudaStream_t stream) {
  static bool ready = false;  // the dynamic shared memory limit, set once (one card)
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(block_matvec_kernel<RT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem_bytes<RT>()));
    if (e != cudaSuccess) return e;
    ready = true;
  }
  const dim3 grid(nseg, (R + RT - 1) / RT);
  block_matvec_kernel<RT><<<grid, kThreads, smem_bytes<RT>(), stream>>>(
      x, tiles, src_blk, reinterpret_cast<const int4*>(segdesc), segptr, partial, counters, out,
      R, nblk * kBlock);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pk2_blockfb_block_size() { return kBlock; }

// rows of the tile a CTA takes for R rows (the partial buffer holds
// nseg x ceil(R / RT) x RT x 128 floats, the counters nblk x ceil(R / RT))
int pk2_blockfb_row_tile(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : 32; }

// out [R, nblk*128] = x [R, nblk*128] @ (block-sparse W); R >= 1, any count.
// segdesc is [nseg][4] int32, 16-byte aligned; counters start at 0 and are
// left at 0.
int pk2_blockfb_matvec(const float* x, const float* tiles, const int* src_blk,
                       const int* segdesc, const int* segptr, float* partial, int* counters,
                       float* out, int R, int nblk, int nseg, int seg_tiles, void* stream) {
  if (seg_tiles < 1 || seg_tiles > kMaxSegTiles) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pk2_blockfb_row_tile(R)) {
    case 8:
      return launch<8>(x, tiles, src_blk, segdesc, segptr, nseg, partial, counters, out, R,
                       nblk, s);
    case 16:
      return launch<16>(x, tiles, src_blk, segdesc, segptr, nseg, partial, counters, out, R,
                        nblk, s);
    default:
      return launch<32>(x, tiles, src_blk, segdesc, segptr, nseg, partial, counters, out, R,
                        nblk, s);
  }
}

}  // extern "C"
