// LSTM recurrence kernels K2 (forward) and K3 (backward) for sm_90a, plain C
// interface for ctypes.
//
// Replace: pykaldi2_tpu/ops/lstm_pallas.py:_fwd_kernel and :_bwd_kernel.
// Gate order i, f, g, o; the recurrent product takes bf16 operands with an
// fp32 sum, the cell and the gate math are fp32, and a masked frame carries
// h and c through unchanged (which makes the reversed direction right for
// right-padded batches).
//
// Bound on the H100: per (layer, direction) the recurrent products are
// 2*(T-1)*B*H*4H flops (42 GFLOP at T=80, B=64, H=1024: ~43 us at the bf16
// tensor-core peak), and the streams each way (forward: xp, ys, cs, gates,
// Wh; backward: dys, gates, cs, Wh, dgates) 176 MB (~53 us at 3.35 TB/s).
// In practice neither is reached: each step depends on the whole previous
// h (or dgates), so the recurrence is bound by the per-step latency of a
// grid-wide exchange through L2. Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, B=64, T=80, H=1024): K3 0.80 ms and K2 0.67 ms a call,
// 9.9 and 8.3 us a step, 13-15x that bound; the first version, in which
// every CTA staged the whole state, took 2.07 and 0.96 ms. clock64() stamps
// split a K3 step into posting the slice's cp.async copies (~13%), the
// product (~40%), the DSMEM pull (~15%), the cluster and grid barriers
// (~23%) and the gate math and plane sums.
//
// Design: the TPU kept all of Wh (8 MiB bf16 at H=1024) in one core's VMEM.
// One H100 SM holds 227 KB, so the weights are spread over the grid: one
// persistent launch covers all T steps, keeps its Wh slices resident in
// shared memory, carries h/c (or dh/dc) in registers, and ends each step at
// a grid barrier (cg grid.sync under the cooperative launch attribute). Each
// step every CTA reads the bf16 state all CTAs wrote in the previous step (h
// for the forward, dgates for the backward) from L2. What that read costs
// set the first version's speed: K3 copied all of dgates ([64, 4096] bf16,
// 512 KB) into every CTA each step, 64 MB of L2 reads a step, and spent 65%
// of its step doing so.
//
// So both kernels split the reduction (K) of the step's product across a
// thread-block cluster and sum the partial products through distributed
// shared memory. A CTA stages only its K-slice of the state, in NSUB
// cp.async groups that are multiplied as they land (ldmatrix fragments,
// mma.sync m16n8k16, bf16 in, fp32 sums; every warp runs >= 4 independent
// accumulator chains at any batch); writes its fp32 partials to
// shared-memory planes (one per warp k-part, summed in order); after a
// cluster barrier each CTA sums its own units' columns over the cluster's
// CTAs in rank order (no atomics: the result is the same bits on every
// run), adds the step's per-frame inputs (fetched as the step began, so
// they arrive during the product), does the gate math and publishes its
// slice of the new state.
//
// K2: H/8 CTAs of UNITS = 8 units. A cluster of K2_CLUSTER = 2 owns 16
// units' 64 gate columns, and each CTA of the pair multiplies half of h,
// [B, H/2], with its [H/2, 64] block of Wh. L2 reads fall from 16 MB to 8 MB
// a step, and the fp32 partials a CTA reads from its peer are 8 KB. Larger
// clusters would cut the L2 bytes further but grow the partials (32C
// columns), and only 66 clusters of 2 (30 of 4) fit on the 132 SMs at one
// CTA an SM.
//
// K3: H/16 CTAs of K3_UNITS = 16 units, in clusters of C = 8 at H = 1024
// (the largest of 8, 4, 2, 1 that divides H/16 and whose clusters fit at
// once: the H100 holds 15 clusters of 8, so the 128 CTAs of 8 units that
// K2 uses could not form clusters of 8). A cluster owns 16C units, each CTA
// keeps the Wh rows of those units for its 4H/C exchanged columns (64 KB x
// 2 at C = 8) and stages only that [B, 4H/C] slice of dgates: 64 KB, 4 MB of
// L2 reads a step instead of 64 MB. The exchange buffer is unit-major
// (column 4u + gate), so each owner thread publishes its four units' gates
// as 32 contiguous bytes. The planes reuse the staging buffer's space.
//
// K5 and K6, the LSTMP forward and backward, take K3's layout; see their
// note below.
//
// Batches above MAX_B rows are split into several launches by the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define UNITS 8               // hidden units owned by one K2 CTA
#define MAX_B 64              // batch rows per launch
#define THREADS 256
#define NWARPS (THREADS / 32)
#define PAD 8                 // bf16 row padding: conflict-free fragment loads

__device__ __forceinline__ float sigmoid_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// K2/K3: split-K over a thread-block cluster (helpers shared by both)
// ---------------------------------------------------------------------------

#define NSUB 2                // cp.async groups one staged slice is cut into
#define K2_CLUSTER 2          // K2's cluster size
#define K3_UNITS 16           // hidden units owned by one K3 CTA
#define K3_KCHUNK 512         // exchanged columns of a K3 slice staged per pass

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until group q of NSUB (committed in order) has landed in this thread.
__device__ __forceinline__ void cp_async_wait_sub(int q) {
  switch (NSUB - 1 - q) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives its part of each in r[0..3].
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// cp.async copies of columns [c0, c1) (multiples of 8) of rows [0, nrows) of a
// bf16 matrix that other CTAs wrote before the last grid barrier (row stride
// lds) into shared memory (row stride ldd). cp.async.cg reads L2, not L1.
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, int ldd,
                                            const __nv_bfloat16* src, int lds, int nrows,
                                            int c0, int c1) {
  const int vpr = (c1 - c0) / 8;
  if (vpr <= 0) return;
  for (int idx = threadIdx.x; idx < nrows * vpr; idx += THREADS) {
    const int r = idx / vpr, c = c0 + (idx - r * vpr) * 8;
    cp_async16(dst + r * ldd + c, src + (size_t)r * lds + c);
  }
}

// acc[(i*NTW + n)*KS + j] += A[m-tile i] . B[n-tile nt0 + n] over this warp's
// k-steps in [klo, khi): those congruent to kp mod nkp, dealt round-robin to
// KS chains. A is [row][k] (lda), B is stored [n][k] (ldb_); the fragments
// come from ldmatrix (A: rows 0-15 at k and k+8; B: two n-tiles at a time).
// MT*NTW*KS independent accumulators keep the tensor cores' pipeline full.
template <int MT, int NTW, int KS>
__device__ __forceinline__ void mma_steps(float (&acc)[MT * NTW * KS][4],
                                          const __nv_bfloat16* As, int lda,
                                          const __nv_bfloat16* Bs, int ldb_, int nt0,
                                          int klo, int khi, int kp, int nkp, int lane) {
  static_assert(NTW % 2 == 0, "B fragments are loaded two n-tiles at a time");
  const __nv_bfloat16* a_lane = As + (lane & 15) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* b_lane =
      Bs + (nt0 * 8 + (lane >> 4) * 8 + (lane & 7)) * ldb_ + ((lane >> 3) & 1) * 8;
  for (int k = klo + ((kp - klo) % nkp + nkp) % nkp; k < khi; k += nkp * KS) {
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      if (k + j * nkp < khi) {
        const int k0 = (k + j * nkp) * 16;
        uint32_t b[NTW][2];
#pragma unroll
        for (int n = 0; n < NTW; n += 2) {
          uint32_t r[4];
          ldsm_x4(r, b_lane + n * 8 * ldb_ + k0);
          b[n][0] = r[0];
          b[n][1] = r[1];
          b[n + 1][0] = r[2];
          b[n + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t a[4];
          ldsm_x4(a, a_lane + i * 16 * lda + k0);
#pragma unroll
          for (int n = 0; n < NTW; ++n) mma_16816(acc[(i * NTW + n) * KS + j], a, b[n]);
        }
      }
    }
  }
}

// One staged pass: columns [0, kvalid) of src land in Ds in NSUB cp.async
// groups, and each group is multiplied with Ws[.][0, k16) as soon as it has
// arrived, while the later groups are still in flight. Columns kvalid..k16
// are zero in both operands. The product's rows start at m-tile m0.
template <int MT, int NTW, int KS>
__device__ __forceinline__ void staged_pass(float (&acc)[MT * NTW * KS][4], __nv_bfloat16* Ds,
                                            int ldd, const __nv_bfloat16* src, int lds, int nb,
                                            int kvalid, int k16, const __nv_bfloat16* Ws,
                                            int ldw, int nt0, int kp, int nkp, int g, int tg,
                                            int m0 = 0) {
  const int ks = k16 / 16;
#pragma unroll
  for (int q = 0; q < NSUB; ++q) {
    stage_async(Ds, ldd, src, lds, nb, (q * ks / NSUB) * 16,
                min(((q + 1) * ks / NSUB) * 16, kvalid));
    cp_async_commit();
  }
#pragma unroll
  for (int q = 0; q < NSUB; ++q) {
    cp_async_wait_sub(q);
    __syncthreads();
    mma_steps<MT, NTW, KS>(acc, Ds + m0 * 16 * ldd, ldd, Ws, ldw, nt0, q * ks / NSUB,
                           (q + 1) * ks / NSUB, kp, nkp, (g << 2) | tg);
  }
}

// The CTA's partial product over its slice of the reduction: Ds (rows = batch)
// times the resident Ws, staged in passes of kc columns; each warp's sums go
// to its k-part's plane Pl[kp] [MAX_B][ldp] (fp32), chains added in order.
template <int MT, int NTW>
__device__ __forceinline__ void product_to_planes(float* Pl, int ldp, __nv_bfloat16* Ds, int ldd,
                                                  const __nv_bfloat16* src, int lds, int nb,
                                                  int kvalid, int k16, int kc,
                                                  const __nv_bfloat16* Ws, int ldw, int nt0,
                                                  int kp, int nkp, int g, int tg) {
  constexpr int KS = MT * NTW >= 4 ? 1 : 4 / (MT * NTW);
  float acc[MT * NTW * KS][4];
#pragma unroll
  for (int i = 0; i < MT * NTW * KS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int c0 = 0; c0 < k16; c0 += kc) {
    const int w16 = min(kc, k16 - c0);
    staged_pass<MT, NTW, KS>(acc, Ds, ldd, src + c0, lds, nb, min(w16, kvalid - c0), w16,
                             Ws + c0, ldw, nt0, kp, nkp, g, tg);
    __syncthreads();  // Ds is rewritten by the next pass (and K3's planes alias it)
  }
  float* P = Pl + (size_t)kp * MAX_B * ldp;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] = acc[(i * NTW + n) * KS][e];
#pragma unroll
        for (int j = 1; j < KS; ++j) s[e] += acc[(i * NTW + n) * KS + j][e];
      }
      float* p0 = P + (i * 16 + g) * ldp + (nt0 + n) * 8 + tg * 2;
      *reinterpret_cast<float2*>(p0) = make_float2(s[0], s[1]);
      *reinterpret_cast<float2*>(p0 + 8 * ldp) = make_float2(s[2], s[3]);
    }
  }
}

template <int NTW>
__device__ __forceinline__ void product_dispatch(int mtiles, float* Pl, int ldp, __nv_bfloat16* Ds,
                                                 int ldd, const __nv_bfloat16* src, int lds,
                                                 int nb, int kvalid, int k16, int kc,
                                                 const __nv_bfloat16* Ws, int ldw, int nt0,
                                                 int kp, int nkp, int g, int tg) {
  switch (mtiles) {
    case 1:
      product_to_planes<1, NTW>(Pl, ldp, Ds, ldd, src, lds, nb, kvalid, k16, kc, Ws, ldw, nt0, kp,
                                nkp, g, tg);
      break;
    case 2:
      product_to_planes<2, NTW>(Pl, ldp, Ds, ldd, src, lds, nb, kvalid, k16, kc, Ws, ldw, nt0, kp,
                                nkp, g, tg);
      break;
    case 3:
      product_to_planes<3, NTW>(Pl, ldp, Ds, ldd, src, lds, nb, kvalid, k16, kc, Ws, ldw, nt0, kp,
                                nkp, g, tg);
      break;
    default:
      product_to_planes<4, NTW>(Pl, ldp, Ds, ldd, src, lds, nb, kvalid, k16, kc, Ws, ldw, nt0, kp,
                                nkp, g, tg);
  }
}

// Pl[0] = ((Pl[0] + Pl[1]) + Pl[2]) + ... over rows [0, rows), ncols columns.
__device__ __forceinline__ void sum_planes(float* Pl, int ldp, int nplanes, int rows, int ncols) {
  if (nplanes == 1) return;
  const int vpr = ncols / 4;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += THREADS) {
    const int r = idx / vpr, c = (idx - r * vpr) * 4;
    float4* p0 = reinterpret_cast<float4*>(Pl + r * ldp + c);
    float4 s = *p0;
    for (int k = 1; k < nplanes; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(Pl + ((size_t)k * MAX_B + r) * ldp + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *p0 = s;
  }
}

// Warp layout of the product: NT n-tiles of 8 columns, dealt NTW to a warp;
// the NWARPS / (NT / NTW) warps that share n-tiles split the k-steps.
__host__ __device__ constexpr int warp_ntw(int nt) { return nt < 4 ? nt : 4; }
__host__ __device__ constexpr int warp_nkp(int nt) { return NWARPS / (nt / warp_ntw(nt)); }

// Shared memory (bytes); host and device agree.
__host__ __device__ constexpr int k2_k16(int H) { return (H / K2_CLUSTER + 15) / 16 * 16; }
__host__ __device__ constexpr int k2_ncols() { return 4 * UNITS * K2_CLUSTER; }
__host__ __device__ constexpr size_t k2_smem(int H) {
  return (size_t)(k2_ncols() + MAX_B) * (k2_k16(H) + PAD) * 2 +
         (size_t)warp_nkp(k2_ncols() / 8) * MAX_B * (k2_ncols() + PAD) * 4;
}
__host__ __device__ constexpr int k3_kc(int H, int C) {
  return 4 * H / C < K3_KCHUNK ? 4 * H / C : K3_KCHUNK;
}
__host__ __device__ constexpr size_t k3_stage_bytes(int H, int C) {
  return (size_t)MAX_B * (k3_kc(H, C) + PAD) * 2 >
                 (size_t)warp_nkp(2 * C) * MAX_B * (K3_UNITS * C + PAD) * 4
             ? (size_t)MAX_B * (k3_kc(H, C) + PAD) * 2
             : (size_t)warp_nkp(2 * C) * MAX_B * (K3_UNITS * C + PAD) * 4;
}
__host__ __device__ constexpr size_t k3_smem(int H, int C) {
  return (size_t)K3_UNITS * C * (4 * H / C + PAD) * 2 + k3_stage_bytes(H, C);
}

// ---------------------------------------------------------------------------
// K2: forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const float* __restrict__ xp,            // [T, ldb, 4H] (rows offset)
                const __nv_bfloat16* __restrict__ wh,    // [H, 4H]
                const float* __restrict__ mask,          // [T, ldb]
                float* __restrict__ ys,                  // [T, ldb, H]
                float* __restrict__ cs,                  // [T, ldb, H]
                __nv_bfloat16* __restrict__ gates,       // [T, ldb, 4H] activated i,f,g,o
                __nv_bfloat16* hbuf,                     // [2, nb, H] exchange buffer
                int T, int nb, int ldb, int H) {
  constexpr int C = K2_CLUSTER;
  constexpr int CU = UNITS * C;         // units of a cluster
  constexpr int NCOLS = 4 * CU;         // their gate columns, n = gate * CU + unit
  constexpr int NT = NCOLS / 8, NTW = warp_ntw(NT), NG = NT / NTW, NKP = warp_nkp(NT);
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H4 = 4 * H;
  const int K = H / C, K16 = k2_k16(H), ldk = K16 + PAD, ldp = NCOLS + PAD;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NCOLS][ldk]
  __nv_bfloat16* Ds = Ws + NCOLS * ldk;                              // [MAX_B][ldk]
  float* Pl = reinterpret_cast<float*>(Ds + MAX_B * ldk);            // [NKP][MAX_B][ldp]
  const int r = (int)cluster.block_rank();
  const int cu0 = (blockIdx.x / C) * CU, u0 = blockIdx.x * UNITS, k0 = r * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mtiles = (nb + 15) / 16;

  // resident: Ws[n][k] = Wh[k0 + k][gate(n) * H + cu0 + unit(n)], zero for k >= K;
  // Ds starts zero, so the padded columns and the rows >= nb stay zero
  for (int idx = tid; idx < K16 * NCOLS; idx += THREADS) {
    const int k = idx / NCOLS, n = idx % NCOLS;
    Ws[n * ldk + k] = k < K ? wh[(size_t)(k0 + k) * H4 + (n / CU) * H + cu0 + n % CU]
                            : __float2bfloat16(0.f);
  }
  for (int idx = tid; idx < MAX_B * ldk; idx += THREADS) Ds[idx] = __float2bfloat16(0.f);
  __syncthreads();

  // this thread's outputs: row b, units col and col + 1
  const int b = tid >> 2, col = u0 + 2 * (tid & 3);
  const int pcol = r * UNITS + 2 * (tid & 3);  // their column in the cluster's planes (gate 0)
  const bool live = b < nb;
  float h_r[2] = {0.f, 0.f}, c_r[2] = {0.f, 0.f};
  float2 x_t[4];  // this step's xp
  float m_t = 0.f;

  for (int t = 0; t < T; ++t) {
    float rec[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    if (live) {  // in flight while the product runs
      const float* xpt = xp + ((size_t)t * ldb + b) * H4 + col;
#pragma unroll
      for (int q = 0; q < 4; ++q) x_t[q] = *reinterpret_cast<const float2*>(xpt + q * H);
      m_t = mask[(size_t)t * ldb + b];
    }
    if (t > 0) {
      // partial gates over this CTA's K rows of Wh; sum over the cluster
      product_dispatch<NTW>(mtiles, Pl, ldp, Ds, ldk, hbuf + (size_t)((t - 1) & 1) * nb * H + k0,
                            H, nb, K, K16, K16, Ws, ldk, (warp % NG) * NTW, warp / NG, NKP, g, tg);
      __syncthreads();
      sum_planes(Pl, ldp, NKP, mtiles * 16, NCOLS);
      cluster.sync();
      if (live) {
        float2 v[C][4];  // all loads in flight before the sums, added in rank order
#pragma unroll
        for (int p = 0; p < C; ++p) {
          const float* Pp = cluster.map_shared_rank(Pl, p) + b * ldp + pcol;
#pragma unroll
          for (int q = 0; q < 4; ++q) v[p][q] = *reinterpret_cast<const float2*>(Pp + q * CU);
        }
#pragma unroll
        for (int p = 0; p < C; ++p) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            rec[q][0] += v[p][q].x;
            rec[q][1] += v[p][q].y;
          }
        }
      }
    }
    if (live) {
      const float m = m_t;
      const size_t o = ((size_t)t * ldb + b) * H + col;
      __nv_bfloat16* gt = gates + ((size_t)t * ldb + b) * H4 + col;
      float act[4][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pre_i = (e ? x_t[0].y : x_t[0].x) + rec[0][e];
        const float pre_f = (e ? x_t[1].y : x_t[1].x) + rec[1][e];
        const float pre_g = (e ? x_t[2].y : x_t[2].x) + rec[2][e];
        const float pre_o = (e ? x_t[3].y : x_t[3].x) + rec[3][e];
        const float ig = sigmoid_(pre_i), fg = sigmoid_(pre_f);
        const float gg = tanhf(pre_g), og = sigmoid_(pre_o);
        const float cn = fg * c_r[e] + ig * gg;
        const float hn = og * tanhf(cn);
        h_r[e] = m * hn + (1.f - m) * h_r[e];
        c_r[e] = m * cn + (1.f - m) * c_r[e];
        act[0][e] = ig;
        act[1][e] = fg;
        act[2][e] = gg;
        act[3][e] = og;
      }
      *reinterpret_cast<float2*>(ys + o) = make_float2(h_r[0], h_r[1]);
      *reinterpret_cast<float2*>(cs + o) = make_float2(c_r[0], c_r[1]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<__nv_bfloat162*>(gt + q * H) = __floats2bfloat162_rn(act[q][0], act[q][1]);
      *reinterpret_cast<__nv_bfloat162*>(hbuf + (size_t)(t & 1) * nb * H + (size_t)b * H + col) =
          __floats2bfloat162_rn(h_r[0], h_r[1]);
    }
    if (t + 1 < T) grid.sync();
  }
  cluster.sync();  // peers may still be reading this CTA's planes
}

// ---------------------------------------------------------------------------
// K3: backward (reverse time)
// ---------------------------------------------------------------------------

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const float* __restrict__ dys,           // [T, ldb, H]
                const __nv_bfloat16* __restrict__ gates, // [T, ldb, 4H]
                const float* __restrict__ cs,            // [T, ldb, H]
                const float* __restrict__ mask,          // [T, ldb]
                const __nv_bfloat16* __restrict__ wh,    // [H, 4H]
                float* __restrict__ dgates,              // [T, ldb, 4H]
                __nv_bfloat16* dgbuf,                    // [2, nb, 4H] exchange, unit-major
                int T, int nb, int ldb, int H) {
  constexpr int NCOLS = K3_UNITS * C;   // units of a cluster
  constexpr int NT = NCOLS / 8, NTW = warp_ntw(NT), NG = NT / NTW, NKP = warp_nkp(NT);
  static_assert(MAX_B * K3_UNITS / 4 == THREADS, "one (row, four units) per thread");
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H4 = 4 * H;
  const int K = H4 / C, KC = k3_kc(H, C);
  const int ldw = K + PAD, ldd = KC + PAD, ldp = NCOLS + PAD;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NCOLS][ldw]
  __nv_bfloat16* Ds = Ws + NCOLS * ldw;                              // [MAX_B][ldd]
  float* Pl = reinterpret_cast<float*>(Ds);  // [NKP][MAX_B][ldp], in Ds's space after the product
  const int r = (int)cluster.block_rank();
  const int cu0 = (blockIdx.x / C) * NCOLS, u0 = blockIdx.x * K3_UNITS, j0 = r * K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mtiles = (nb + 15) / 16;

  // resident: Ws[n][k] = Wh[cu0 + n][c(j0 + k)] for dh = dgates . Wh^T, where
  // exchange column j = 4 * unit + gate holds Wh column c(j) = gate * H + unit
  for (int idx = tid; idx < NCOLS * K; idx += THREADS) {
    const int n = idx / K, rem = idx % K, q = rem / (K / 4), uu = rem % (K / 4);
    Ws[n * ldw + 4 * uu + q] = wh[(size_t)(cu0 + n) * H4 + q * H + j0 / 4 + uu];
  }
  __syncthreads();

  // this thread's outputs: row b, units col .. col + 3
  const int b = tid >> 2, col = u0 + 4 * (tid & 3);
  const int pcol = r * K3_UNITS + 4 * (tid & 3);  // their column in the cluster's planes
  const bool live = b < nb;
  float dh_carry[4] = {0.f, 0.f, 0.f, 0.f}, dc_r[4] = {0.f, 0.f, 0.f, 0.f};
  // this step's per-frame inputs
  float4 dy_t, c_t, cp_t;
  uint2 g_t[4];  // bf16 gates i, f, g, o of the four units
  float m_t = 0.f;

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    float rec[4] = {0.f, 0.f, 0.f, 0.f};
    if (live) {  // in flight while the product runs
      const size_t o = ((size_t)t * ldb + b) * H + col;
      dy_t = *reinterpret_cast<const float4*>(dys + o);
      c_t = *reinterpret_cast<const float4*>(cs + o);
      cp_t = t > 0 ? *reinterpret_cast<const float4*>(cs + o - (size_t)ldb * H)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      const __nv_bfloat16* gt = gates + ((size_t)t * ldb + b) * H4 + col;
#pragma unroll
      for (int q = 0; q < 4; ++q) g_t[q] = *reinterpret_cast<const uint2*>(gt + q * H);
      m_t = mask[(size_t)t * ldb + b];
    }
    if (s > 0) {
      // partial dh of the cluster's units over this CTA's slice of dgates
      product_dispatch<NTW>(mtiles, Pl, ldp, Ds, ldd,
                            dgbuf + (size_t)((t + 1) & 1) * nb * H4 + j0, H4, nb, K, K, KC, Ws,
                            ldw, (warp % NG) * NTW, warp / NG, NKP, g, tg);
      __syncthreads();
      sum_planes(Pl, ldp, NKP, mtiles * 16, NCOLS);
      cluster.sync();
      if (live) {
        float4 v[C];  // all loads in flight before the sums, added in rank order
#pragma unroll
        for (int p = 0; p < C; ++p)
          v[p] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(Pl, p) + b * ldp + pcol);
#pragma unroll
        for (int p = 0; p < C; ++p) {
          rec[0] += v[p].x;
          rec[1] += v[p].y;
          rec[2] += v[p].z;
          rec[3] += v[p].w;
        }
      }
    }
    if (live) {
      const float m = m_t;
      const float dy[4] = {dy_t.x, dy_t.y, dy_t.z, dy_t.w};
      const float cv[4] = {c_t.x, c_t.y, c_t.z, c_t.w};
      const float cpv[4] = {cp_t.x, cp_t.y, cp_t.z, cp_t.w};
      float dg[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w0 = (e & 2) ? g_t[0].y : g_t[0].x, w1 = (e & 2) ? g_t[1].y : g_t[1].x;
        const uint32_t w2 = (e & 2) ? g_t[2].y : g_t[2].x, w3 = (e & 2) ? g_t[3].y : g_t[3].x;
        const float ig = (e & 1) ? bf16_hi(w0) : bf16_lo(w0);
        const float fg = (e & 1) ? bf16_hi(w1) : bf16_lo(w1);
        const float gg = (e & 1) ? bf16_hi(w2) : bf16_lo(w2);
        const float og = (e & 1) ? bf16_hi(w3) : bf16_lo(w3);
        const float dh_s = s > 0 ? rec[e] + dh_carry[e] : 0.f;
        const float dh_total = dh_s + dy[e];
        const float dc_in = dc_r[e];
        const float tc = tanhf(cv[e]);
        const float dh_m = m * dh_total;
        const float d_o = dh_m * tc;
        const float dc = dh_m * og * (1.f - tc * tc) + m * dc_in;
        const float d_i = dc * gg, d_f = dc * cpv[e], d_g = dc * ig;
        dg[0][e] = d_i * ig * (1.f - ig);
        dg[1][e] = d_f * fg * (1.f - fg);
        dg[2][e] = d_g * (1.f - gg * gg);
        dg[3][e] = d_o * og * (1.f - og);
        dh_carry[e] = (1.f - m) * dh_total;
        dc_r[e] = dc * fg + (1.f - m) * dc_in;
      }
      float* dgt = dgates + ((size_t)t * ldb + b) * H4 + col;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(dgt + q * H) = make_float4(dg[q][0], dg[q][1], dg[q][2], dg[q][3]);
      // exchange columns 4*col .. 4*col + 15: each unit's four gates in turn
      uint4* xb = reinterpret_cast<uint4*>(dgbuf + (size_t)(t & 1) * nb * H4 + (size_t)b * H4 +
                                           4 * col);
      xb[0] = make_uint4(pack_bf16x2(dg[0][0], dg[1][0]), pack_bf16x2(dg[2][0], dg[3][0]),
                         pack_bf16x2(dg[0][1], dg[1][1]), pack_bf16x2(dg[2][1], dg[3][1]));
      xb[1] = make_uint4(pack_bf16x2(dg[0][2], dg[1][2]), pack_bf16x2(dg[2][2], dg[3][2]),
                         pack_bf16x2(dg[0][3], dg[1][3]), pack_bf16x2(dg[2][3], dg[3][3]));
    }
    if (t > 0) grid.sync();
  }
  cluster.sync();  // peers may still be reading this CTA's planes
}

// ---------------------------------------------------------------------------
// K5/K6: projected LSTM (LSTMP)
//
// Replace: pykaldi2_tpu/ops/lstm_pallas.py:_fwd_proj_kernel (K5) and
// :_bwd_proj_kernel (K6). The recurrence reads the projected state hp [B, P]:
// gates = xp_t + bf16(hp).Wh with Wh [P, 4H]; the cell is fp32; h_full =
// o.tanh(c) is projected, hp = bf16(h_full).Wp with Wp [H, P]; a masked frame
// keeps hp and c. The backward runs in reverse time: dhp_m = m.(dhp + dys_t),
// dh_full = bf16(dhp_m).Wp^T, the gate gradients, and dhp <- bf16(dgates).
// Wh^T + (1-m).(dhp + dys_t). The reference's rounding points are kept.
//
// Bound on the H100, per (layer, direction) at T=80, B=64, H=1024, P=512:
// the streams (forward: xp, ys, cs, gates, hfull, weights) are ~173 MB,
// ~52 us at 3.35 TB/s, against 2*T*B*(P*4H + H*P) = 27 GFLOP, ~27 us at
// the bf16 peak. As for K2/K3, each step depends on the whole previous
// state, so the recurrence is bound by the latency of grid-wide exchanges:
// every step needs two, since each unit's gates need all of hp and each hp
// column needs all of h_full (and in the backward each dhp column needs the
// dgates of all units, each unit's dh_full all of dhp_m).
//
// Both kernels take K3's layout: H/16 CTAs of K3_UNITS = 16 units in
// clusters of C, picked per (H, P) as the largest of 8, 4, 2, 1 that divides
// H/16, whose shared memory fits and whose clusters are co-resident. The
// product with the larger K (K6: dgates . Wh^T, K = 4H; K5: the projection
// bf16(h_full) . Wp, K = H) is split over the cluster: cluster q owns NP
// columns from p0 = q.NP (k6_np: the P columns over the clusters, a power of
// 2 of at least 16; columns at or past P are zero rows of the resident
// block), CTA r keeps the weight rows of its K-slice resident and stages only
// that slice of the exchanged state, multiplied as its cp.async groups land;
// the fp32 partials are summed over the cluster through DSMEM in rank order
// (K6 pulls them from its peers' planes, K5's warps push them into the
// owner's shared memory), each CTA taking NP/C columns of all rows (the same
// bits on every run). The other product (K = P) stages the whole bf16 exchange [B, P] in
// every CTA against the CTA's resident weight rows. Each thread does the
// gate math of one row and four units, with the step's inputs fetched as the
// step begins, and writes its outputs as whole vectors. The exchanges need
// no double buffers: each is rewritten only after the grid barrier that
// follows its last read; K6's partial planes, read by the peers, alias the
// staging buffer, which is next written after a barrier that every peer
// reaches only once its pulls are done.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// K6: LSTMP backward, split-K over a thread-block cluster. Two grid
// exchanges a step:
// - phase 1, dhp = bf16(dgates) . Wh^T (K = 4H, N = P): cluster q owns NP
//   dhp columns from p0 = q.NP (k6_np: the P columns over the clusters, a
//   power of 2 of at least 16; columns at or past P are zero rows of the
//   resident block); CTA r keeps Wh rows p0.. for its exchange columns
//   [r.4H/C, (r+1).4H/C) resident and stages only that slice of the
//   unit-major dgates exchange, multiplied as its cp.async groups land; the
//   partial planes are summed over the cluster through DSMEM in rank order,
//   each CTA taking NP/C columns of all rows (masked carry, dys, the mask,
//   then dhpm and the bf16 dhp_m exchange);
// - phase 2, dh_full = bf16(dhp_m) . Wp^T (K = P, N = the CTA's 16 units):
//   every CTA stages all of dhp_m against its resident Wp rows; then each
//   thread does the gate math of one row and four units (inputs fetched as
//   the step began) and publishes their dgates as 32 contiguous bytes of the
//   exchange.
// The exchanges need no double buffers: each is rewritten only after the
// grid barrier that follows its last read. The phase-1 planes, read by the
// peers, alias the staging buffer, which is next written after the grid
// barrier that every peer reaches only once its pulls are done.
//
// Why: clock stamps of the first K6 (128 CTAs, each staging 256 KB of dgates
// a step in eight unoverlapped passes) put 64% of a 24 us step in phase 1.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, B=64, T=80,
// H=1024, P=512): 0.94 ms a call, 11.7 us a step, against 1.92 ms before;
// the two grid barriers now take a fifth of a step (tools/kernel_split.py).
// ---------------------------------------------------------------------------

#define K6_KC 512  // staged columns per pass (256 where 512 does not fit)

// dhp columns a K6 cluster owns (host and device agree)
__host__ __device__ constexpr int k6_np(int H, int P, int C) {
  int np = 16;
  while (np * (H / (K3_UNITS * C)) < P) np *= 2;
  return np;
}
__host__ __device__ constexpr int k6_ntw(int np) { return np == 32 || np == 64 ? 4 : 2; }
__host__ __device__ constexpr int k6_nkp(int np) { return NWARPS / (np / 8 / k6_ntw(np)); }
__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
__host__ __device__ constexpr size_t k6_smem(int H, int P, int C, int kc) {
  return (size_t)k6_np(H, P, C) * (4 * H / C + PAD) * 2 + (size_t)K3_UNITS * (P + PAD) * 2 +
         cmax(cmax((size_t)MAX_B * ((4 * H / C < kc ? 4 * H / C : kc) + PAD) * 2,
                   (size_t)MAX_B * ((P < kc ? P : kc) + PAD) * 2),
              cmax((size_t)k6_nkp(k6_np(H, P, C)) * MAX_B * (k6_np(H, P, C) + PAD) * 4,
                   (size_t)NWARPS * MAX_B * (K3_UNITS + PAD) * 4));
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
lstmp_bwd_kernel(const float* __restrict__ dys,           // [T, ldb, P]
                 const __nv_bfloat16* __restrict__ gates, // [T, ldb, 4H]
                 const float* __restrict__ cs,            // [T, ldb, H]
                 const float* __restrict__ mask,          // [T, ldb]
                 const __nv_bfloat16* __restrict__ wh,    // [P, 4H]
                 const __nv_bfloat16* __restrict__ wp,    // [H, P]
                 float* __restrict__ dgates,              // [T, ldb, 4H]
                 float* __restrict__ dhpm,                // [T, ldb, P] masked dhp
                 __nv_bfloat16* dgbuf,                    // [nb, 4H] exchange, unit-major
                 __nv_bfloat16* dpbuf,                    // [nb, P] exchange of bf16(dhp_m)
                 int T, int nb, int ldb, int H, int P, int kc) {
  static_assert(MAX_B * K3_UNITS / 4 == THREADS, "one (row, four units) per thread");
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H4 = 4 * H, KS = H4 / C, NP = k6_np(H, P, C), NPC = NP / C;
  const int ntw = k6_ntw(NP), ng = NP / 8 / ntw, nkp = NWARPS / ng;
  const int kc1 = min(KS, kc), kc2 = min(P, kc);
  const int ldw = KS + PAD, ldu = P + PAD, ldp1 = NP + PAD, ldp2 = K3_UNITS + PAD;
  __nv_bfloat16* Wr = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NP][ldw]
  __nv_bfloat16* Wu = Wr + NP * ldw;                                 // [16][ldu]
  __nv_bfloat16* Ds = Wu + K3_UNITS * ldu;                           // staged operand
  float* Pl = reinterpret_cast<float*>(Ds);  // partial planes, after each product
  const int r = (int)cluster.block_rank();
  const int p0 = (blockIdx.x / C) * NP, j0 = r * KS, u0 = blockIdx.x * K3_UNITS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mtiles = (nb + 15) / 16;
  const bool phase1 = p0 < P;  // the same for the whole cluster

  // resident: Wr[n][k] = Wh[p0 + n][c(j0 + k)] (dhp = dgates . Wh^T), where
  // exchange column j = 4 * unit + gate holds Wh column c(j) = gate * H + unit;
  // Wu[u][k] = Wp[u0 + u][k] (dh_full = dhp_m . Wp^T)
  for (int idx = tid; idx < NP * KS; idx += THREADS) {
    const int n = idx / KS, rem = idx % KS, q = rem / (KS / 4), uu = rem % (KS / 4);
    Wr[n * ldw + 4 * uu + q] = p0 + n < P ? wh[(size_t)(p0 + n) * H4 + q * H + j0 / 4 + uu]
                                          : __float2bfloat16(0.f);
  }
  for (int idx = tid; idx < K3_UNITS * P; idx += THREADS) {
    const int u = idx / P, k = idx % P;
    Wu[u * ldu + k] = wp[(size_t)(u0 + u) * P + k];
  }
  __syncthreads();

  // phase-1 outputs of this thread: pairs of columns (row pb[i], columns
  // p0 + pc[i], + 1) of the CTA's NPC columns of the cluster's NP
  int pb[2], pc[2];
  bool own[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = tid + i * THREADS;
    pb[i] = p / (NPC / 2);
    pc[i] = r * NPC + 2 * (p % (NPC / 2));
    own[i] = phase1 && p < MAX_B * NPC / 2 && pb[i] < nb && p0 + pc[i] < P;
  }
  float2 keep_r[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};  // (1-m).dhp_total
  // phase-2 outputs: row b, units col .. col + 3
  const int b = tid >> 2, col = u0 + 4 * (tid & 3);
  const bool live = b < nb;
  float dc_r[4] = {0.f, 0.f, 0.f, 0.f};

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    // this step's per-frame inputs, in flight during the product
    float2 dy_t[2];
    float m1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (own[i]) {
        dy_t[i] = *reinterpret_cast<const float2*>(dys + ((size_t)t * ldb + pb[i]) * P + p0 +
                                                   pc[i]);
        m1[i] = mask[(size_t)t * ldb + pb[i]];
      }
    }
    float4 c_t, cp_t;
    uint2 g_t[4];
    float m_t = 0.f;
    if (live) {
      const size_t o = ((size_t)t * ldb + b) * H + col;
      c_t = *reinterpret_cast<const float4*>(cs + o);
      cp_t = t > 0 ? *reinterpret_cast<const float4*>(cs + o - (size_t)ldb * H)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      const __nv_bfloat16* gt = gates + ((size_t)t * ldb + b) * H4 + col;
#pragma unroll
      for (int q = 0; q < 4; ++q) g_t[q] = *reinterpret_cast<const uint2*>(gt + q * H);
      m_t = mask[(size_t)t * ldb + b];
    }

    // 1. the cluster's dhp columns: bf16(dgates_{t+1}) . Wh^T + (1-m_{t+1}).
    //    dhp_total_{t+1} + dys_t, then the mask of step t
    float2 rec[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
    if (s > 0 && phase1) {
      if (ntw == 4)
        product_dispatch<4>(mtiles, Pl, ldp1, Ds, kc1 + PAD, dgbuf + j0, H4, nb, KS, KS, kc1, Wr,
                            ldw, (warp % ng) * 4, warp / ng, nkp, g, tg);
      else
        product_dispatch<2>(mtiles, Pl, ldp1, Ds, kc1 + PAD, dgbuf + j0, H4, nb, KS, KS, kc1, Wr,
                            ldw, (warp % ng) * 2, warp / ng, nkp, g, tg);
      __syncthreads();
      sum_planes(Pl, ldp1, nkp, mtiles * 16, NP);
      cluster.sync();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (own[i]) {
          float2 v[C];  // all loads in flight before the sums, added in rank order
#pragma unroll
          for (int p = 0; p < C; ++p)
            v[p] = *reinterpret_cast<const float2*>(cluster.map_shared_rank(Pl, p) +
                                                    pb[i] * ldp1 + pc[i]);
#pragma unroll
          for (int p = 0; p < C; ++p) {
            rec[i].x += v[p].x;
            rec[i].y += v[p].y;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (own[i]) {
        const size_t o = ((size_t)t * ldb + pb[i]) * P + p0 + pc[i];
        const float m = m1[i];
        const float tx = (rec[i].x + keep_r[i].x) + dy_t[i].x;
        const float ty = (rec[i].y + keep_r[i].y) + dy_t[i].y;
        *reinterpret_cast<float2*>(dhpm + o) = make_float2(m * tx, m * ty);
        *reinterpret_cast<__nv_bfloat162*>(dpbuf + (size_t)pb[i] * P + p0 + pc[i]) =
            __floats2bfloat162_rn(m * tx, m * ty);
        keep_r[i] = make_float2((1.f - m) * tx, (1.f - m) * ty);
      }
    }
    grid.sync();

    // 2. the CTA's units: dh_full = bf16(dhp_m) . Wp^T, then the gate gradients
    product_dispatch<2>(mtiles, Pl, ldp2, Ds, kc2 + PAD, dpbuf, P, nb, P, P, kc2, Wu, ldu, 0, warp,
                        NWARPS, g, tg);
    __syncthreads();
    sum_planes(Pl, ldp2, NWARPS, mtiles * 16, K3_UNITS);
    __syncthreads();
    if (live) {
      const float m = m_t;
      const float4 dh4 = *reinterpret_cast<const float4*>(Pl + b * ldp2 + 4 * (tid & 3));
      const float dh[4] = {dh4.x, dh4.y, dh4.z, dh4.w};
      const float cv[4] = {c_t.x, c_t.y, c_t.z, c_t.w};
      const float cpv[4] = {cp_t.x, cp_t.y, cp_t.z, cp_t.w};
      float dg[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t w0 = (e & 2) ? g_t[0].y : g_t[0].x, w1 = (e & 2) ? g_t[1].y : g_t[1].x;
        const uint32_t w2 = (e & 2) ? g_t[2].y : g_t[2].x, w3 = (e & 2) ? g_t[3].y : g_t[3].x;
        const float ig = (e & 1) ? bf16_hi(w0) : bf16_lo(w0);
        const float fg = (e & 1) ? bf16_hi(w1) : bf16_lo(w1);
        const float gg = (e & 1) ? bf16_hi(w2) : bf16_lo(w2);
        const float og = (e & 1) ? bf16_hi(w3) : bf16_lo(w3);
        const float dc_in = dc_r[e];
        const float tc = tanhf(cv[e]);
        const float d_o = dh[e] * tc;
        const float dc = dh[e] * og * (1.f - tc * tc) + m * dc_in;
        const float d_i = dc * gg, d_f = dc * cpv[e], d_g = dc * ig;
        dg[0][e] = d_i * ig * (1.f - ig);
        dg[1][e] = d_f * fg * (1.f - fg);
        dg[2][e] = d_g * (1.f - gg * gg);
        dg[3][e] = d_o * og * (1.f - og);
        dc_r[e] = dc * fg + (1.f - m) * dc_in;
      }
      float* dgt = dgates + ((size_t)t * ldb + b) * H4 + col;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<float4*>(dgt + q * H) = make_float4(dg[q][0], dg[q][1], dg[q][2], dg[q][3]);
      // exchange columns 4*col .. 4*col + 15: each unit's four gates in turn
      uint4* xb = reinterpret_cast<uint4*>(dgbuf + (size_t)b * H4 + 4 * col);
      xb[0] = make_uint4(pack_bf16x2(dg[0][0], dg[1][0]), pack_bf16x2(dg[2][0], dg[3][0]),
                         pack_bf16x2(dg[0][1], dg[1][1]), pack_bf16x2(dg[2][1], dg[3][1]));
      xb[1] = make_uint4(pack_bf16x2(dg[0][2], dg[1][2]), pack_bf16x2(dg[2][2], dg[3][2]),
                         pack_bf16x2(dg[0][3], dg[1][3]), pack_bf16x2(dg[2][3], dg[3][3]));
    }
    if (t > 0) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// K5: LSTMP forward, redesigned for the H100 (see the LSTMP note above):
// - phase 1, gates = xp_t + bf16(hp_{t-1}) . Wh (K = P, N = the CTA's 64
//   gate columns, n = 16 * gate + unit): every CTA stages all of the bf16
//   hp exchange in cp.async groups against its resident Wh columns; each
//   warp owns four whole tiles over all of K (four independent chains, no
//   k-part planes to add); each thread adds its row's xp_t (loaded as the
//   step began), does the gate math of four units and writes cs, the bf16
//   gates and the bf16 h_full, which doubles as the exchange;
// - phase 2, hp = bf16(h_full_t) . Wp (K = H), split over the cluster: CTA
//   r stages its H/C columns of h_full against its resident Wp rows, each
//   warp pushes its whole tiles' columns into the shared memory of the CTA
//   that owns them (DSMEM stores, no round trip), and after one cluster
//   barrier each CTA adds its NP/C columns' C slices in rank order: the
//   masked carry, ys and the bf16 hp exchange.
// Why: clock stamps of the first K5 (128 CTAs of 8 units, each staging all
// of hp and 32 rows of h_full with synchronous loads, one mma chain a tile)
// are in PERF.md; this layout stages 80 KB a CTA in 64 CTAs, overlapped
// with the products, where the first staged 128 KB in 128. Measured on an
// H100 80GB HBM3 at 700 W (tools/kernel_ab.py, B=64, T=80, H=1024, P=512):
// 0.82 ms a call against 1.06 ms; phase 1 (30% of a step) and the two grid
// barriers (25%) are what remains (tools/kernel_split.py). No faster, so
// not kept: hp multicast over the cluster with cp.async.bulk on mbarriers
// (0.88 ms), and step counters in place of the first grid barrier (the wait
// moves to the second).
// ---------------------------------------------------------------------------

#define K5_NCOLS (4 * K3_UNITS)  // gate columns of one K5 CTA

// K5's products give each warp whole output tiles over all of K (no k-part
// planes): nt n-tiles in groups of 2, and the four m-tiles of the rows in
// min(8 / groups, 4) groups of k5_mt(nt); warps past that repeat a group's
// tiles and keep none of them.
__host__ __device__ constexpr int k5_mgroups(int nt) { return 8 / (nt / 2) < 4 ? 8 / (nt / 2) : 4; }
__host__ __device__ constexpr int k5_mt(int nt) { return 4 / k5_mgroups(nt); }

// Shared memory: resident Wh columns [64][P], Wp rows [NP][H/C], the
// cluster's partial hp columns pushed to this CTA [C][MAX_B][NP/C] (fp32),
// and the staged operand, whose space the gate plane [MAX_B][64] reuses.
__host__ __device__ constexpr size_t k5_smem(int H, int P, int C, int kc) {
  return (size_t)K5_NCOLS * (P + PAD) * 2 + (size_t)k6_np(H, P, C) * (H / C + PAD) * 2 +
         (size_t)MAX_B * k6_np(H, P, C) * 4 +
         cmax(cmax((size_t)MAX_B * ((P < kc ? P : kc) + PAD) * 2,
                   (size_t)MAX_B * ((H / C < kc ? H / C : kc) + PAD) * 2),
              (size_t)MAX_B * (K5_NCOLS + PAD) * 4);
}

// This warp's MT x 2 tiles (m-tiles m0.., n-tiles nt0, nt0 + 1) of the
// staged rows times Ws^T over all k16 columns of src, staged in passes of kc
// columns by the whole CTA; s[2i + n] holds tile (i, n), its chains added in
// order. Ends with a barrier: Ds is free again.
template <int MT>
__device__ __forceinline__ void k5_tiles(float (&s)[MT * 2][4], __nv_bfloat16* Ds, int ldd,
                                         const __nv_bfloat16* src, int lds, int nb, int k16,
                                         int kc, const __nv_bfloat16* Ws, int ldw, int nt0,
                                         int m0, int g, int tg) {
  constexpr int KS = MT * 2 >= 4 ? 1 : 4 / (MT * 2);
  float acc[MT * 2 * KS][4];
#pragma unroll
  for (int i = 0; i < MT * 2 * KS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int c0 = 0; c0 < k16; c0 += kc) {
    const int w16 = min(kc, k16 - c0);
    staged_pass<MT, 2, KS>(acc, Ds, ldd, src + c0, lds, nb, w16, w16, Ws + c0, ldw, nt0, 0, 1,
                           g, tg, m0);
    __syncthreads();  // Ds is rewritten by the next pass (or its space by a plane)
  }
#pragma unroll
  for (int t = 0; t < MT * 2; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = acc[t * KS][e];
#pragma unroll
      for (int j = 1; j < KS; ++j) s[t][e] += acc[t * KS + j][e];
    }
  }
}

// Phase 2's product over this CTA's K-slice, each tile's columns pushed into
// the shared memory of the CTA that owns them (recv[rank][row][column]).
template <int MT>
__device__ __forceinline__ void k5_proj_push(float* recv, __nv_bfloat16* Ds, int ldd,
                                             const __nv_bfloat16* src, int lds, int nb, int k16,
                                             int kc, const __nv_bfloat16* Wr, int ldr, int NP,
                                             int NPC, int r, int warp, int g, int tg,
                                             cg::cluster_group& cluster) {
  const int ng = NP / 16, mg = 4 / MT;
  const int nt0 = (warp % ng) * 2, m0 = ((warp / ng) % mg) * MT;
  float s[MT * 2][4];
  k5_tiles<MT>(s, Ds, ldd, src, lds, nb, k16, kc, Wr, ldr, nt0, m0, g, tg);
  if (warp >= ng * mg) return;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int col = (nt0 + n) * 8 + tg * 2, q = col / NPC;
      float* d = cluster.map_shared_rank(recv, q) +
                 ((size_t)r * MAX_B + (m0 + i) * 16 + g) * NPC + col - q * NPC;
      *reinterpret_cast<float2*>(d) = make_float2(s[i * 2 + n][0], s[i * 2 + n][1]);
      *reinterpret_cast<float2*>(d + 8 * NPC) = make_float2(s[i * 2 + n][2], s[i * 2 + n][3]);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
lstmp_fwd_kernel(const float* __restrict__ xp,            // [T, ldb, 4H] (rows offset)
                 const __nv_bfloat16* __restrict__ wh,    // [P, 4H]
                 const __nv_bfloat16* __restrict__ wp,    // [H, P]
                 const float* __restrict__ mask,          // [T, ldb]
                 float* __restrict__ ys,                  // [T, ldb, P] hp
                 float* __restrict__ cs,                  // [T, ldb, H]
                 __nv_bfloat16* __restrict__ gates,       // [T, ldb, 4H] activated i,f,g,o
                 __nv_bfloat16* hfull,                    // [T, ldb, H]: saved and exchanged
                 __nv_bfloat16* hpbuf,                    // [nb, P] exchange of bf16(hp)
                 int T, int nb, int ldb, int H, int P, int kc) {
  static_assert(MAX_B * K3_UNITS / 4 == THREADS, "one (row, four units) per thread");
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H4 = 4 * H, KS = H / C, NP = k6_np(H, P, C), NPC = NP / C;
  const int kc1 = min(P, kc), kc2 = min(KS, kc);
  const int ldw = P + PAD, ldr = KS + PAD, ldp = K5_NCOLS + PAD;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][ldw]
  __nv_bfloat16* Wr = Ws + K5_NCOLS * ldw;                            // [NP][ldr]
  float* recv = reinterpret_cast<float*>(Wr + NP * ldr);              // [C][MAX_B][NPC]
  __nv_bfloat16* Ds = reinterpret_cast<__nv_bfloat16*>(recv + MAX_B * NP);  // staged operand
  float* Pl = reinterpret_cast<float*>(Ds);  // the gate plane [MAX_B][ldp], after phase 1
  const int r = (int)cluster.block_rank();
  const int p0 = (blockIdx.x / C) * NP, j0 = r * KS, u0 = blockIdx.x * K3_UNITS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const bool proj = p0 < P;  // the same for the whole cluster

  // resident: Ws[n][k] = Wh[k][gate(n) * H + u0 + unit(n)] (gates = hp . Wh);
  // Wr[n][k] = Wp[j0 + k][p0 + n] (hp = h_full . Wp over this CTA's K-slice)
  for (int idx = tid; idx < K5_NCOLS * P; idx += THREADS) {
    const int k = idx / K5_NCOLS, n = idx % K5_NCOLS;
    Ws[n * ldw + k] = wh[(size_t)k * H4 + (n / K3_UNITS) * H + u0 + n % K3_UNITS];
  }
  for (int idx = tid; idx < NP * KS; idx += THREADS) {
    const int k = idx / NP, n = idx % NP;
    Wr[n * ldr + k] = p0 + n < P ? wp[(size_t)(j0 + k) * P + p0 + n] : __float2bfloat16(0.f);
  }
  __syncthreads();

  // phase-2 outputs of this thread: pairs of columns (row pb[i], columns
  // p0 + pc[i], + 1) of the CTA's NPC columns of the cluster's NP
  int pb[2], pc[2];
  bool own[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = tid + i * THREADS;
    pb[i] = p / (NPC / 2);
    pc[i] = r * NPC + 2 * (p % (NPC / 2));
    own[i] = proj && p < MAX_B * NPC / 2 && pb[i] < nb && p0 + pc[i] < P;
  }
  float2 hp_r[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};  // the masked carry
  // phase-1 outputs: row b, units col .. col + 3
  const int b = tid >> 2, col = u0 + 4 * (tid & 3);
  const bool live = b < nb;
  float c_r[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t = 0; t < T; ++t) {
    // this step's per-frame inputs, in flight during the product
    float4 x_t[4];
    float m_t = 0.f, m2[2] = {0.f, 0.f};
    if (live) {
      const float* xpt = xp + ((size_t)t * ldb + b) * H4 + col;
#pragma unroll
      for (int q = 0; q < 4; ++q) x_t[q] = *reinterpret_cast<const float4*>(xpt + q * H);
      m_t = mask[(size_t)t * ldb + b];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (own[i]) m2[i] = mask[(size_t)t * ldb + pb[i]];

    // 1. the CTA's gates: xp_t + bf16(hp_{t-1}) . Wh (hp = 0 at t = 0); warp w
    //    takes n-tiles 2(w % 4), + 1 of m-tiles 2(w / 4), + 1
    float4 rec[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) rec[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t > 0) {
      const int nt0 = (warp % 4) * 2, m0 = (warp / 4) * 2;
      float sg[4][4];
      k5_tiles<2>(sg, Ds, kc1 + PAD, hpbuf, P, nb, P, kc1, Ws, ldw, nt0, m0, g, tg);
      // the gate plane, read back by the threads of the gate math
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          float* p0p = Pl + ((m0 + i) * 16 + g) * ldp + (nt0 + n) * 8 + tg * 2;
          *reinterpret_cast<float2*>(p0p) = make_float2(sg[i * 2 + n][0], sg[i * 2 + n][1]);
          *reinterpret_cast<float2*>(p0p + 8 * ldp) =
              make_float2(sg[i * 2 + n][2], sg[i * 2 + n][3]);
        }
      }
      __syncthreads();
      if (live) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rec[q] = *reinterpret_cast<const float4*>(Pl + b * ldp + q * K3_UNITS + 4 * (tid & 3));
      }
    }
    if (live) {
      const float m = m_t;
      const float xs[4][4] = {{x_t[0].x, x_t[0].y, x_t[0].z, x_t[0].w},
                              {x_t[1].x, x_t[1].y, x_t[1].z, x_t[1].w},
                              {x_t[2].x, x_t[2].y, x_t[2].z, x_t[2].w},
                              {x_t[3].x, x_t[3].y, x_t[3].z, x_t[3].w}};
      const float rs[4][4] = {{rec[0].x, rec[0].y, rec[0].z, rec[0].w},
                              {rec[1].x, rec[1].y, rec[1].z, rec[1].w},
                              {rec[2].x, rec[2].y, rec[2].z, rec[2].w},
                              {rec[3].x, rec[3].y, rec[3].z, rec[3].w}};
      float act[4][4], hf[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ig = sigmoid_(xs[0][e] + rs[0][e]), fg = sigmoid_(xs[1][e] + rs[1][e]);
        const float gg = tanhf(xs[2][e] + rs[2][e]), og = sigmoid_(xs[3][e] + rs[3][e]);
        const float cn = fg * c_r[e] + ig * gg;
        hf[e] = og * tanhf(cn);
        c_r[e] = m * cn + (1.f - m) * c_r[e];
        act[0][e] = ig;
        act[1][e] = fg;
        act[2][e] = gg;
        act[3][e] = og;
      }
      const size_t o = ((size_t)t * ldb + b) * H + col;
      *reinterpret_cast<float4*>(cs + o) = make_float4(c_r[0], c_r[1], c_r[2], c_r[3]);
      *reinterpret_cast<uint2*>(hfull + o) =
          make_uint2(pack_bf16x2(hf[0], hf[1]), pack_bf16x2(hf[2], hf[3]));
      __nv_bfloat16* gt = gates + ((size_t)t * ldb + b) * H4 + col;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint2*>(gt + q * H) =
            make_uint2(pack_bf16x2(act[q][0], act[q][1]), pack_bf16x2(act[q][2], act[q][3]));
    }
    grid.sync();

    // 2. the cluster's hp columns: bf16(h_full_t) . Wp over this CTA's K-slice,
    //    pushed to their owners and summed there in rank order; then the
    //    masked carry of step t
    if (proj) {
      const __nv_bfloat16* hsrc = hfull + (size_t)t * ldb * H + j0;
      switch (k5_mt(NP / 8)) {
        case 1:
          k5_proj_push<1>(recv, Ds, kc2 + PAD, hsrc, H, nb, KS, kc2, Wr, ldr, NP, NPC, r, warp, g,
                          tg, cluster);
          break;
        case 2:
          k5_proj_push<2>(recv, Ds, kc2 + PAD, hsrc, H, nb, KS, kc2, Wr, ldr, NP, NPC, r, warp, g,
                          tg, cluster);
          break;
        default:
          k5_proj_push<4>(recv, Ds, kc2 + PAD, hsrc, H, nb, KS, kc2, Wr, ldr, NP, NPC, r, warp, g,
                          tg, cluster);
      }
      cluster.sync();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (own[i]) {
          const float* rv = recv + (size_t)pb[i] * NPC + pc[i] - r * NPC;
          float2 sp = make_float2(0.f, 0.f);
#pragma unroll
          for (int q = 0; q < C; ++q) {
            const float2 v = *reinterpret_cast<const float2*>(rv + (size_t)q * MAX_B * NPC);
            sp.x += v.x;
            sp.y += v.y;
          }
          const float m = m2[i];
          hp_r[i] = make_float2(m * sp.x + (1.f - m) * hp_r[i].x, m * sp.y + (1.f - m) * hp_r[i].y);
          const size_t o = ((size_t)t * ldb + pb[i]) * P + p0 + pc[i];
          *reinterpret_cast<float2*>(ys + o) = hp_r[i];
          *reinterpret_cast<__nv_bfloat162*>(hpbuf + (size_t)pb[i] * P + p0 + pc[i]) =
              __floats2bfloat162_rn(hp_r[i].x, hp_r[i].y);
        }
      }
    }
    if (t + 1 < T) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// C interface. Each returns a cudaError_t code: 0 on a clean launch.
// ---------------------------------------------------------------------------

// Cluster launches (K2, K3). The cooperative attribute makes grid.sync()
// legal and makes the launch fail, rather than hang, for a grid whose
// clusters cannot all be resident at once; the occupancy query picks the
// cluster size before that.
static cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int grid, int csize,
                                         size_t smem, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// 0 and *fits = whether grid / csize clusters of fn can be resident at once.
static int clusters_fit(const void* fn, int grid, int csize, size_t smem, bool* fits) {
  *fits = false;
  if (grid % csize != 0 || smem > 232448) return 0;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = cluster_config(attr, grid, csize, smem, nullptr);
  int n = 0;
  if ((e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg)) != cudaSuccess) return (int)e;
  *fits = n >= grid / csize;
  return 0;
}

static int launch_cluster(const void* fn, int grid, int csize, size_t smem, void** args,
                          void* stream) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = cluster_config(attr, grid, csize, smem, stream);
  cfg.numAttrs = 2;
  e = cudaLaunchKernelExC(&cfg, fn, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

static const void* k3_fn(int c) {
  switch (c) {
    case 8: return (const void*)lstm_bwd_kernel<8>;
    case 4: return (const void*)lstm_bwd_kernel<4>;
    case 2: return (const void*)lstm_bwd_kernel<2>;
    default: return (const void*)lstm_bwd_kernel<1>;
  }
}

static size_t k3_smem_of(int H, int c) {
  switch (c) {
    case 8: return k3_smem(H, 8);
    case 4: return k3_smem(H, 4);
    case 2: return k3_smem(H, 2);
    default: return k3_smem(H, 1);
  }
}

// K2's cluster size at H: K2_CLUSTER if the H/8 CTAs' clusters fit at once,
// else 0. K3's: the largest of 8, 4, 2, 1 that divides the H/16 CTAs and
// whose clusters fit at once, else 0. Both cached per H.
static int k2_cluster(int H, int* err) {
  static int cache[1024 / 16 + 1];  // 0: not asked yet, -1: does not fit
  *err = 0;
  if (!cache[H / 16]) {
    bool fits = false;
    if ((*err = clusters_fit((const void*)lstm_fwd_kernel, H / UNITS, K2_CLUSTER, k2_smem(H),
                             &fits)) != 0)
      return 0;
    cache[H / 16] = fits ? K2_CLUSTER : -1;
  }
  return cache[H / 16] > 0 ? cache[H / 16] : 0;
}

static int k3_cluster(int H, int* err) {
  static int cache[1024 / 16 + 1];
  *err = 0;
  if (!cache[H / 16]) {
    int pick = -1;
    for (int c = 8; c >= 1 && pick < 0; c /= 2) {
      bool fits = false;
      if ((*err = clusters_fit(k3_fn(c), H / K3_UNITS, c, k3_smem_of(H, c), &fits)) != 0)
        return 0;
      if (fits) pick = c;
    }
    cache[H / 16] = pick;
  }
  return cache[H / 16] > 0 ? cache[H / 16] : 0;
}

static const void* k6_fn(int c) {
  switch (c) {
    case 8: return (const void*)lstmp_bwd_kernel<8>;
    case 4: return (const void*)lstmp_bwd_kernel<4>;
    case 2: return (const void*)lstmp_bwd_kernel<2>;
    default: return (const void*)lstmp_bwd_kernel<1>;
  }
}

static const void* k5_fn(int c) {
  switch (c) {
    case 8: return (const void*)lstmp_fwd_kernel<8>;
    case 4: return (const void*)lstmp_fwd_kernel<4>;
    case 2: return (const void*)lstmp_fwd_kernel<2>;
    default: return (const void*)lstmp_fwd_kernel<1>;
  }
}

// K5's (which = 5) or K6's (which = 6) cluster size and pass width at
// (H, P): the largest of 8, 4, 2, 1 that divides the H/16 CTAs, whose
// shared memory fits with passes of K6_KC columns (or else K6_KC/2) and
// whose clusters fit at once; cluster size 0 if none does. Cached per
// (kernel, H, P).
static int lstmp_config(int which, int H, int P, int* csize, int* kc) {
  static int cache[2][1024 / 16 + 1][1024 / 16 + 1][2];  // {0, 0}: not asked yet
  int* c = cache[which == 5][H / 16][P / 16];
  if (!c[1]) {
    int pick = -1, pick_kc = K6_KC;
    for (int cs = 8; cs >= 1 && pick < 0; cs /= 2) {
      for (int w = K6_KC; w >= K6_KC / 2 && pick < 0; w /= 2) {
        bool fits = false;
        const int e = which == 5
                          ? clusters_fit(k5_fn(cs), H / K3_UNITS, cs, k5_smem(H, P, cs, w), &fits)
                          : clusters_fit(k6_fn(cs), H / K3_UNITS, cs, k6_smem(H, P, cs, w), &fits);
        if (e != 0) return e;
        if (fits) {
          pick = cs;
          pick_kc = w;
        }
      }
    }
    c[0] = pick;
    c[1] = pick_kc;
  }
  *csize = c[0] > 0 ? c[0] : 0;
  *kc = c[1];
  return 0;
}

static int hidden_ok(int H) { return H >= 16 && H % 16 == 0 && H <= 1024; }

extern "C" int pk2_lstm_max_batch() { return MAX_B; }

// Cluster sizes K2 and K3 launch with at H (0: cannot launch).
extern "C" int pk2_lstm_clusters(int H, int* k2, int* k3) {
  *k2 = *k3 = 0;
  if (!hidden_ok(H)) return (int)cudaErrorInvalidValue;
  int e = 0;
  *k2 = k2_cluster(H, &e);
  if (e != 0) return e;
  *k3 = k3_cluster(H, &e);
  return e;
}

extern "C" int pk2_lstm_fwd(const void* xp, const void* wh, const void* mask, void* ys,
                            void* cs, void* gates, void* hbuf, int T, int nb, int ldb,
                            int H, void* stream) {
  if (nb < 1 || nb > MAX_B || T < 1 || !hidden_ok(H)) return (int)cudaErrorInvalidValue;
  int e = 0;
  const int c = k2_cluster(H, &e);
  if (e != 0) return e;
  if (c == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* a_xp = (const float*)xp;
  const __nv_bfloat16* a_wh = (const __nv_bfloat16*)wh;
  const float* a_mask = (const float*)mask;
  float* a_ys = (float*)ys;
  float* a_cs = (float*)cs;
  __nv_bfloat16* a_gates = (__nv_bfloat16*)gates;
  __nv_bfloat16* a_hbuf = (__nv_bfloat16*)hbuf;
  void* args[] = {&a_xp, &a_wh, &a_mask, &a_ys, &a_cs, &a_gates, &a_hbuf,
                  &T, &nb, &ldb, &H};
  return launch_cluster((const void*)lstm_fwd_kernel, H / UNITS, c, k2_smem(H), args, stream);
}

extern "C" int pk2_lstm_bwd(const void* dys, const void* gates, const void* cs,
                            const void* mask, const void* wh, void* dgates, void* dgbuf,
                            int T, int nb, int ldb, int H, void* stream) {
  if (nb < 1 || nb > MAX_B || T < 1 || !hidden_ok(H)) return (int)cudaErrorInvalidValue;
  int e = 0;
  const int c = k3_cluster(H, &e);
  if (e != 0) return e;
  if (c == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* a_dys = (const float*)dys;
  const __nv_bfloat16* a_gates = (const __nv_bfloat16*)gates;
  const float* a_cs = (const float*)cs;
  const float* a_mask = (const float*)mask;
  const __nv_bfloat16* a_wh = (const __nv_bfloat16*)wh;
  float* a_dg = (float*)dgates;
  __nv_bfloat16* a_buf = (__nv_bfloat16*)dgbuf;
  void* args[] = {&a_dys, &a_gates, &a_cs, &a_mask, &a_wh, &a_dg, &a_buf,
                  &T, &nb, &ldb, &H};
  return launch_cluster(k3_fn(c), H / K3_UNITS, c, k3_smem_of(H, c), args, stream);
}

static bool proj_shape_ok(int nb, int T, int H, int P) {
  return nb >= 1 && nb <= MAX_B && T >= 1 && P >= 16 && P % 16 == 0 && P <= H;
}

extern "C" int pk2_lstmp_fwd(const void* xp, const void* wh, const void* wp, const void* mask,
                             void* ys, void* cs, void* gates, void* hfull, void* hpbuf,
                             int T, int nb, int ldb, int H, int P, void* stream) {
  if (!hidden_ok(H) || !proj_shape_ok(nb, T, H, P)) return (int)cudaErrorInvalidValue;
  int c = 0, kc = 0;
  const int e = lstmp_config(5, H, P, &c, &kc);
  if (e != 0) return e;
  if (c == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* a_xp = (const float*)xp;
  const __nv_bfloat16* a_wh = (const __nv_bfloat16*)wh;
  const __nv_bfloat16* a_wp = (const __nv_bfloat16*)wp;
  const float* a_mask = (const float*)mask;
  float* a_ys = (float*)ys;
  float* a_cs = (float*)cs;
  __nv_bfloat16* a_gates = (__nv_bfloat16*)gates;
  __nv_bfloat16* a_hfull = (__nv_bfloat16*)hfull;
  __nv_bfloat16* a_hpbuf = (__nv_bfloat16*)hpbuf;
  void* args[] = {&a_xp, &a_wh, &a_wp, &a_mask, &a_ys, &a_cs, &a_gates, &a_hfull, &a_hpbuf,
                  &T, &nb, &ldb, &H, &P, &kc};
  return launch_cluster(k5_fn(c), H / K3_UNITS, c, k5_smem(H, P, c, kc), args, stream);
}

// K5's cluster size at (H, P) (0: cannot launch).
extern "C" int pk2_lstmp_fwd_cluster(int H, int P, int* csize) {
  *csize = 0;
  if (!hidden_ok(H) || !proj_shape_ok(1, 1, H, P)) return (int)cudaErrorInvalidValue;
  int kc = 0;
  return lstmp_config(5, H, P, csize, &kc);
}

// K6's cluster size at (H, P) (0: cannot launch).
extern "C" int pk2_lstmp_bwd_cluster(int H, int P, int* csize) {
  *csize = 0;
  if (!hidden_ok(H) || !proj_shape_ok(1, 1, H, P)) return (int)cudaErrorInvalidValue;
  int kc = 0;
  return lstmp_config(6, H, P, csize, &kc);
}

extern "C" int pk2_lstmp_bwd(const void* dys, const void* gates, const void* cs,
                             const void* mask, const void* wh, const void* wp, void* dgates,
                             void* dhpm, void* dgbuf, void* dpbuf, int T, int nb, int ldb,
                             int H, int P, void* stream) {
  if (!hidden_ok(H) || !proj_shape_ok(nb, T, H, P)) return (int)cudaErrorInvalidValue;
  int c = 0, kc = 0;
  const int e = lstmp_config(6, H, P, &c, &kc);
  if (e != 0) return e;
  if (c == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const float* a_dys = (const float*)dys;
  const __nv_bfloat16* a_gates = (const __nv_bfloat16*)gates;
  const float* a_cs = (const float*)cs;
  const float* a_mask = (const float*)mask;
  const __nv_bfloat16* a_wh = (const __nv_bfloat16*)wh;
  const __nv_bfloat16* a_wp = (const __nv_bfloat16*)wp;
  float* a_dg = (float*)dgates;
  float* a_dhpm = (float*)dhpm;
  __nv_bfloat16* a_dgbuf = (__nv_bfloat16*)dgbuf;
  __nv_bfloat16* a_dpbuf = (__nv_bfloat16*)dpbuf;
  void* args[] = {&a_dys, &a_gates, &a_cs, &a_mask, &a_wh, &a_wp, &a_dg, &a_dhpm, &a_dgbuf,
                  &a_dpbuf, &T, &nb, &ldb, &H, &P, &kc};
  return launch_cluster(k6_fn(c), H / K3_UNITS, c, k6_smem(H, P, c, kc), args, stream);
}
