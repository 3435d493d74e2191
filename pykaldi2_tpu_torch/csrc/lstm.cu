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
// grid-wide exchange through L2.
//
// Design: the TPU kept all of Wh (8 MiB bf16 at H=1024) in one core's VMEM.
// One H100 SM holds 227 KB, so the weights are spread over the grid
// instead: one persistent cooperative launch covers all T steps, each CTA
// owns UNITS hidden units and keeps the Wh columns of their four gates
// (forward) or the Wh rows of those units (backward, for dh = dgates.Wh^T)
// resident in shared memory for the whole sequence. Each step a CTA stages
// the bf16 state every CTA wrote in the previous step (h for the forward,
// dgates for the backward) from L2 into shared memory, multiplies it with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), does the gate math for its
// units with h/c (or dh/dc) carried in registers, publishes its slice of
// the new state, and waits at a grid barrier. Batches above MAX_B rows are
// split into several launches by the caller.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define UNITS 8               // hidden units owned by one CTA
#define NCOL (4 * UNITS)      // gate columns owned by one CTA
#define MAX_B 64              // batch rows per launch
#define THREADS 256
#define NWARPS (THREADS / 32)
#define PAD 8                 // bf16 row padding: conflict-free fragment loads
#define KCHUNK 512            // gate columns of dgates staged per pass (backward)
#define MAX_PAIRS ((MAX_B * UNITS + THREADS - 1) / THREADS)

__device__ __forceinline__ float sigmoid_(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copies rows [0, rows16) x cols [0, ncols) of a bf16 matrix written by other
// CTAs (row stride ld_src) into shared memory (row stride ld_dst), zero rows
// at and beyond nvalid. L2-only loads: L1 is not coherent across SMs.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld_dst,
                                           const __nv_bfloat16* src, int ld_src,
                                           int rows16, int nvalid, int ncols) {
  const int vpr = ncols / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < rows16 * vpr; idx += THREADS) {
    const int r = idx / vpr, v = idx % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) val = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)r * ld_src) + v);
    *reinterpret_cast<uint4*>(dst + r * ld_dst + v * 8) = val;
  }
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
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = H + PAD;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NCOL][ldk]
  __nv_bfloat16* Hs = Ws + NCOL * ldk;                               // [MAX_B][ldk]
  float* Cs = reinterpret_cast<float*>(Hs + MAX_B * ldk);            // [MAX_B][NCOL]
  const int H4 = 4 * H;
  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mtiles = (nb + 15) / 16;
  const int ntiles = NCOL / 8;

  // resident weights: Ws[n][k] = Wh[k][gate(n)*H + u0 + unit(n)], k contiguous
  for (int idx = tid; idx < NCOL * H; idx += THREADS) {
    const int k = idx / NCOL, n = idx % NCOL;
    Ws[n * ldk + k] = wh[(size_t)k * H4 + (n / UNITS) * H + u0 + (n % UNITS)];
  }
  __syncthreads();

  float h_r[MAX_PAIRS], c_r[MAX_PAIRS];
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) { h_r[i] = 0.f; c_r[i] = 0.f; }

  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      stage_rows(Hs, ldk, hbuf + (size_t)((t - 1) & 1) * nb * H, H, mtiles * 16, nb, H);
      __syncthreads();
      for (int tile = warp; tile < mtiles * ntiles; tile += NWARPS) {
        const int mt = tile / ntiles, nt = tile % ntiles;
        const __nv_bfloat16* a0 = Hs + (mt * 16 + g) * ldk + tg * 2;
        const __nv_bfloat16* a1 = a0 + 8 * ldk;
        const __nv_bfloat16* bp = Ws + (nt * 8 + g) * ldk + tg * 2;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k0 = 0; k0 < H; k0 += 16) {
          uint32_t a[4], b[2];
          a[0] = ld_u32(a0 + k0);
          a[1] = ld_u32(a1 + k0);
          a[2] = ld_u32(a0 + k0 + 8);
          a[3] = ld_u32(a1 + k0 + 8);
          b[0] = ld_u32(bp + k0);
          b[1] = ld_u32(bp + k0 + 8);
          mma_16816(acc, a, b);
        }
        float* c0 = Cs + (mt * 16 + g) * NCOL + nt * 8 + tg * 2;
        c0[0] = acc[0];
        c0[1] = acc[1];
        c0[8 * NCOL] = acc[2];
        c0[8 * NCOL + 1] = acc[3];
      }
      __syncthreads();
    }
    const float* xpt = xp + (size_t)t * ldb * H4;
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = tid + i * THREADS;
      if (p < nb * UNITS) {
        const int b = p / UNITS, u = p % UNITS, col = u0 + u;
        float pre[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pre[q] = xpt[(size_t)b * H4 + q * H + col];
          if (t > 0) pre[q] += Cs[b * NCOL + q * UNITS + u];
        }
        const float ig = sigmoid_(pre[0]), fg = sigmoid_(pre[1]);
        const float gg = tanhf(pre[2]), og = sigmoid_(pre[3]);
        const float cn = fg * c_r[i] + ig * gg;
        const float hn = og * tanhf(cn);
        const float m = mask[(size_t)t * ldb + b];
        h_r[i] = m * hn + (1.f - m) * h_r[i];
        c_r[i] = m * cn + (1.f - m) * c_r[i];
        const size_t o = ((size_t)t * ldb + b) * H + col;
        ys[o] = h_r[i];
        cs[o] = c_r[i];
        __nv_bfloat16* gt = gates + ((size_t)t * ldb + b) * H4 + col;
        gt[0] = __float2bfloat16(ig);
        gt[H] = __float2bfloat16(fg);
        gt[2 * H] = __float2bfloat16(gg);
        gt[3 * H] = __float2bfloat16(og);
        hbuf[(size_t)(t & 1) * nb * H + (size_t)b * H + col] = __float2bfloat16(h_r[i]);
      }
    }
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// K3: backward (reverse time)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const float* __restrict__ dys,           // [T, ldb, H]
                const __nv_bfloat16* __restrict__ gates, // [T, ldb, 4H]
                const float* __restrict__ cs,            // [T, ldb, H]
                const float* __restrict__ mask,          // [T, ldb]
                const __nv_bfloat16* __restrict__ wh,    // [H, 4H]
                float* __restrict__ dgates,              // [T, ldb, 4H]
                __nv_bfloat16* dgbuf,                    // [2, nb, 4H] exchange buffer
                int T, int nb, int ldb, int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H4 = 4 * H;
  const int ldw = H4 + PAD;
  const int ldd = KCHUNK + PAD;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [UNITS][ldw]
  __nv_bfloat16* Ds = Ws + UNITS * ldw;                              // [MAX_B][ldd]
  float* Ps = reinterpret_cast<float*>(Ds + MAX_B * ldd);            // [2][MAX_B][UNITS]
  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mtiles = (nb + 15) / 16;
  const int mt = warp & 3, kh = warp >> 2;  // 4 row tiles x 2 halves of each chunk

  // resident weights: the Wh rows of the owned units (dh = dgates . Wh^T)
  for (int idx = tid; idx < UNITS * H4; idx += THREADS) {
    const int u = idx / H4, j = idx % H4;
    Ws[u * ldw + j] = wh[(size_t)(u0 + u) * H4 + j];
  }
  __syncthreads();

  float dh_carry[MAX_PAIRS], dc_r[MAX_PAIRS];
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) { dh_carry[i] = 0.f; dc_r[i] = 0.f; }

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    if (s > 0) {
      const __nv_bfloat16* src = dgbuf + (size_t)((t + 1) & 1) * nb * H4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kc = 0; kc < H4; kc += KCHUNK) {
        const int kw = min(KCHUNK, H4 - kc);
        stage_rows(Ds, ldd, src + kc, H4, mtiles * 16, nb, kw);
        __syncthreads();
        if (mt < mtiles) {
          const int half = kw / 2;
          const __nv_bfloat16* a0 = Ds + (mt * 16 + g) * ldd + tg * 2;
          const __nv_bfloat16* a1 = a0 + 8 * ldd;
          const __nv_bfloat16* bp = Ws + g * ldw + kc + tg * 2;
          for (int k0 = kh * half; k0 < (kh + 1) * half; k0 += 16) {
            uint32_t a[4], b[2];
            a[0] = ld_u32(a0 + k0);
            a[1] = ld_u32(a1 + k0);
            a[2] = ld_u32(a0 + k0 + 8);
            a[3] = ld_u32(a1 + k0 + 8);
            b[0] = ld_u32(bp + k0);
            b[1] = ld_u32(bp + k0 + 8);
            mma_16816(acc, a, b);
          }
        }
        __syncthreads();
      }
      if (mt < mtiles) {
        float* p0 = Ps + (kh * MAX_B + mt * 16 + g) * UNITS + tg * 2;
        p0[0] = acc[0];
        p0[1] = acc[1];
        p0[8 * UNITS] = acc[2];
        p0[8 * UNITS + 1] = acc[3];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = tid + i * THREADS;
      if (p < nb * UNITS) {
        const int b = p / UNITS, u = p % UNITS, col = u0 + u;
        float dh_s = 0.f;
        if (s > 0) dh_s = Ps[b * UNITS + u] + Ps[(MAX_B + b) * UNITS + u] + dh_carry[i];
        const size_t o = ((size_t)t * ldb + b) * H + col;
        const float m = mask[(size_t)t * ldb + b];
        const float dh_total = dh_s + dys[o];
        const float dc_in = dc_r[i];
        const __nv_bfloat16* gt = gates + ((size_t)t * ldb + b) * H4 + col;
        const float ig = __bfloat162float(gt[0]), fg = __bfloat162float(gt[H]);
        const float gg = __bfloat162float(gt[2 * H]), og = __bfloat162float(gt[3 * H]);
        const float c = cs[o];
        const float c_prev = (t > 0) ? cs[o - (size_t)ldb * H] : 0.f;
        const float tc = tanhf(c);
        const float dh_m = m * dh_total;
        const float d_o = dh_m * tc;
        const float dc = dh_m * og * (1.f - tc * tc) + m * dc_in;
        const float d_i = dc * gg, d_f = dc * c_prev, d_g = dc * ig;
        const float dgi = d_i * ig * (1.f - ig);
        const float dgf = d_f * fg * (1.f - fg);
        const float dgg = d_g * (1.f - gg * gg);
        const float dgo = d_o * og * (1.f - og);
        float* dgt = dgates + ((size_t)t * ldb + b) * H4 + col;
        dgt[0] = dgi;
        dgt[H] = dgf;
        dgt[2 * H] = dgg;
        dgt[3 * H] = dgo;
        __nv_bfloat16* xb = dgbuf + (size_t)(t & 1) * nb * H4 + (size_t)b * H4 + col;
        xb[0] = __float2bfloat16(dgi);
        xb[H] = __float2bfloat16(dgf);
        xb[2 * H] = __float2bfloat16(dgg);
        xb[3 * H] = __float2bfloat16(dgo);
        dh_carry[i] = (1.f - m) * dh_total;
        dc_r[i] = dc * fg + (1.f - m) * dc_in;
      }
    }
    grid.sync();
  }
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
// state, so the recurrence is bound by the latency of grid-wide exchanges.
//
// Design, K2/K3's (one persistent cooperative launch, weight slices
// resident in shared memory, mma.sync bf16 with fp32 sums, state carried in
// registers), with one change the projection forces: every step needs two
// grid-wide exchanges, not one. Forward: each CTA computes the gates of its
// UNITS hidden units from all of hp (exchange 2 of the previous step), then
// every hp column needs all of h_full (exchange 1). Backward: each hp
// column's dhp needs the dgates of all units, then each unit's dh_full needs
// all of dhp_m. Computing all of hp in every CTA instead would cost
// 64*1024*512 MACs per CTA per step.
//
// Ownership of the projection: the H/8 CTAs that own hidden units also own
// the P columns, in groups of PCOLS = 8 (mma's n). With P/8 groups and H/8
// CTAs, the groups are replicated rsplit = min(H/P, 4) times and each copy
// takes every rsplit-th 16-row m-tile of the batch, so all CTAs work and
// each stages only its own rows of h_full (forward) or dgates (backward) from
// L2: at H=1024, P=512 each CTA owns 8 columns of 32 rows. Within a CTA the
// eight warps split the k-steps of the product (warp w takes k-steps w,
// w+8, ...) over all owned m-tiles, and the partial sums meet in shared
// memory. Resident: forward, the Wh columns of the owned units' gates
// [32 x P] and the Wp columns of the owned hp columns [8 x H]; backward,
// the Wh rows of the owned hp columns [8 x 4H] (for dhp = dgates.Wh^T) and
// the Wp rows of the owned units [8 x P] (for dh_full = dhp_m.Wp^T). The
// staged state (hp, then h_full; dgates in chunks, then dhp_m) takes turns
// in one buffer, which also holds the partial sums once a product is done.
// At H=P=1024 that is 222,848 bytes (forward) and 214,272 (backward) of the
// 232,448 a block may use; the wrapper takes H a multiple of 16 up to 1024
// and P a multiple of 16 up to H. The exchanges need no double buffers: a
// buffer is rewritten only after the barrier that follows its last read.
// h_full is saved in bf16 for dWp and doubles as the forward's exchange.
// ---------------------------------------------------------------------------

#define PCOLS 8                    // projection columns per column group (mma n)
#define MAX_MT (MAX_B / 16)        // 16-row m-tiles of one launch's rows
#define MAX_HP ((MAX_B * PCOLS + THREADS - 1) / THREADS)
#define TILES_PER_WARP ((MAX_MT * (NCOL / 8) + NWARPS - 1) / NWARPS)
#define PARTIAL_FLOATS (NWARPS * MAX_B * PCOLS)

// This CTA's share of a projection-column phase: columns [j0, j0+8) of P
// for the m-tiles rpart, rpart + rsplit, ... (cnt of them); j0 < 0: none.
struct ProjRole {
  int j0, rpart, rsplit, cnt;
};

__device__ __forceinline__ ProjRole proj_role(int P, int mtiles) {
  ProjRole r;
  const int ngroups = P / PCOLS;
  r.rsplit = min((int)gridDim.x / ngroups, MAX_MT);
  r.rpart = blockIdx.x / ngroups;
  r.j0 = (blockIdx.x % ngroups) * PCOLS;
  r.cnt = 0;
  if (r.rpart < r.rsplit)
    for (int mt = r.rpart; mt < mtiles; mt += r.rsplit) ++r.cnt;
  if (r.cnt == 0) r.j0 = -1;
  return r;
}

// Batch row of owned row index lr (0 .. cnt*16).
__device__ __forceinline__ int role_row(const ProjRole& r, int lr) {
  return (r.rpart + (lr >> 4) * r.rsplit) * 16 + (lr & 15);
}

// stage_rows for the rows of the owned m-tiles only (row b lands at row b).
__device__ __forceinline__ void stage_owned(__nv_bfloat16* dst, int ld_dst,
                                            const __nv_bfloat16* src, int ld_src,
                                            const ProjRole& r, int nvalid, int ncols) {
  const int vpr = ncols / 8;
  for (int idx = threadIdx.x; idx < r.cnt * 16 * vpr; idx += THREADS) {
    const int row = role_row(r, idx / vpr), v = idx % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nvalid) val = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)row * ld_src) + v);
    *reinterpret_cast<uint4*>(dst + row * ld_dst + v * 8) = val;
  }
}

// acc[i] += A[rows of owned m-tile i, 0:klen] . B[0:klen, 0:8] for this
// warp's k-steps (warp, warp + NWARPS, ...). A is [row][k] (lda), B is
// stored [n][k] (ldb_).
__device__ __forceinline__ void group_mma(float (*acc)[4], const __nv_bfloat16* As, int lda,
                                          const __nv_bfloat16* Bs, int ldb_, int klen,
                                          const ProjRole& r, int warp, int g, int tg) {
  for (int k0 = warp * 16; k0 < klen; k0 += NWARPS * 16) {
    uint32_t b[2];
    const __nv_bfloat16* bp = Bs + g * ldb_ + k0 + tg * 2;
    b[0] = ld_u32(bp);
    b[1] = ld_u32(bp + 8);
#pragma unroll
    for (int i = 0; i < MAX_MT; ++i) {
      if (i < r.cnt) {
        const __nv_bfloat16* a0 = As + (size_t)role_row(r, i * 16 + g) * lda + k0 + tg * 2;
        const __nv_bfloat16* a1 = a0 + 8 * lda;
        uint32_t a[4];
        a[0] = ld_u32(a0);
        a[1] = ld_u32(a1);
        a[2] = ld_u32(a0 + 8);
        a[3] = ld_u32(a1 + 8);
        mma_16816(acc[i], a, b);
      }
    }
  }
}

// Each warp's partial sums to Pp [NWARPS][MAX_B][PCOLS] (call after a
// __syncthreads when Pp aliases the staged operand).
__device__ __forceinline__ void store_partials(float* Pp, float (*acc)[4], const ProjRole& r,
                                               int warp, int g, int tg) {
#pragma unroll
  for (int i = 0; i < MAX_MT; ++i) {
    if (i < r.cnt) {
      float* p0 = Pp + ((size_t)warp * MAX_B + role_row(r, i * 16 + g)) * PCOLS + tg * 2;
      p0[0] = acc[i][0];
      p0[1] = acc[i][1];
      p0[8 * PCOLS] = acc[i][2];
      p0[8 * PCOLS + 1] = acc[i][3];
    }
  }
}

__device__ __forceinline__ float sum_partials(const float* Pp, int b, int jl) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) s += Pp[((size_t)w * MAX_B + b) * PCOLS + jl];
  return s;
}

// Shared-memory layouts (bf16 elements unless noted); host and device agree.
__host__ __device__ __forceinline__ int lstmp_stage_elems(int rows_ld) {
  const int a = MAX_B * rows_ld, b = PARTIAL_FLOATS * 2;
  return a > b ? a : b;
}

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
                 int T, int nb, int ldb, int H, int P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H4 = 4 * H;
  const int ldp = P + PAD, ldh = H + PAD;
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NCOL][ldp]
  __nv_bfloat16* Wq = Ws + NCOL * ldp;                               // [PCOLS][ldh]
  __nv_bfloat16* Xs = Wq + PCOLS * ldh;                              // staged hp / h_full; partials
  float* Cs = reinterpret_cast<float*>(Xs + lstmp_stage_elems(ldh)); // [MAX_B][NCOL]
  float* Pp = reinterpret_cast<float*>(Xs);
  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mtiles = (nb + 15) / 16;
  const int ntiles = NCOL / 8;
  const ProjRole role = proj_role(P, mtiles);

  // resident weights: Ws[n][k] = Wh[k][gate(n)*H + u0 + unit(n)];
  // Wq[n][k] = Wp[k][j0 + n]
  for (int idx = tid; idx < NCOL * P; idx += THREADS) {
    const int k = idx / NCOL, n = idx % NCOL;
    Ws[n * ldp + k] = wh[(size_t)k * H4 + (n / UNITS) * H + u0 + (n % UNITS)];
  }
  if (role.j0 >= 0) {
    for (int idx = tid; idx < PCOLS * H; idx += THREADS) {
      const int k = idx / PCOLS, n = idx % PCOLS;
      Wq[n * ldh + k] = wp[(size_t)k * P + role.j0 + n];
    }
  }
  __syncthreads();

  float c_r[MAX_PAIRS], hp_r[MAX_HP];
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) c_r[i] = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_HP; ++i) hp_r[i] = 0.f;

  for (int t = 0; t < T; ++t) {
    // 1. gates of the owned units: xp_t + bf16(hp_{t-1}) . Wh
    if (t > 0) {
      stage_rows(Xs, ldp, hpbuf, P, mtiles * 16, nb, P);
      __syncthreads();
      float acc[TILES_PER_WARP][4];
#pragma unroll
      for (int i = 0; i < TILES_PER_WARP; ++i) {
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        const int tile = warp + i * NWARPS;
        if (tile < mtiles * ntiles) {
          const int mt = tile / ntiles, nt = tile % ntiles;
          const __nv_bfloat16* a0 = Xs + (mt * 16 + g) * ldp + tg * 2;
          const __nv_bfloat16* a1 = a0 + 8 * ldp;
          const __nv_bfloat16* bp = Ws + (nt * 8 + g) * ldp + tg * 2;
          for (int k0 = 0; k0 < P; k0 += 16) {
            uint32_t a[4], b[2];
            a[0] = ld_u32(a0 + k0);
            a[1] = ld_u32(a1 + k0);
            a[2] = ld_u32(a0 + k0 + 8);
            a[3] = ld_u32(a1 + k0 + 8);
            b[0] = ld_u32(bp + k0);
            b[1] = ld_u32(bp + k0 + 8);
            mma_16816(acc[i], a, b);
          }
          float* c0 = Cs + (mt * 16 + g) * NCOL + nt * 8 + tg * 2;
          c0[0] = acc[i][0];
          c0[1] = acc[i][1];
          c0[8 * NCOL] = acc[i][2];
          c0[8 * NCOL + 1] = acc[i][3];
        }
      }
      __syncthreads();
    }
    // 2. gate math and the cell of the owned units; publish bf16(h_full)
    const float* xpt = xp + (size_t)t * ldb * H4;
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = tid + i * THREADS;
      if (p < nb * UNITS) {
        const int b = p / UNITS, u = p % UNITS, col = u0 + u;
        float pre[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pre[q] = xpt[(size_t)b * H4 + q * H + col];
          if (t > 0) pre[q] += Cs[b * NCOL + q * UNITS + u];
        }
        const float ig = sigmoid_(pre[0]), fg = sigmoid_(pre[1]);
        const float gg = tanhf(pre[2]), og = sigmoid_(pre[3]);
        const float cn = fg * c_r[i] + ig * gg;
        const float hf = og * tanhf(cn);
        const float m = mask[(size_t)t * ldb + b];
        c_r[i] = m * cn + (1.f - m) * c_r[i];
        const size_t o = ((size_t)t * ldb + b) * H + col;
        cs[o] = c_r[i];
        hfull[o] = __float2bfloat16(hf);
        __nv_bfloat16* gt = gates + ((size_t)t * ldb + b) * H4 + col;
        gt[0] = __float2bfloat16(ig);
        gt[H] = __float2bfloat16(fg);
        gt[2 * H] = __float2bfloat16(gg);
        gt[3 * H] = __float2bfloat16(og);
      }
    }
    grid.sync();
    // 3. the owned hp columns of the owned rows: bf16(h_full) . Wp, masked carry
    if (role.j0 >= 0) {
      stage_owned(Xs, ldh, hfull + (size_t)t * ldb * H, H, role, nb, H);
      __syncthreads();
      float acc[MAX_MT][4];
#pragma unroll
      for (int i = 0; i < MAX_MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      group_mma(acc, Xs, ldh, Wq, ldh, H, role, warp, g, tg);
      __syncthreads();
      store_partials(Pp, acc, role, warp, g, tg);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MAX_HP; ++i) {
        const int p = tid + i * THREADS, lr = p / PCOLS, jl = p % PCOLS;
        if (lr < role.cnt * 16) {
          const int b = role_row(role, lr);
          if (b < nb) {
            const float proj = sum_partials(Pp, b, jl);
            const float m = mask[(size_t)t * ldb + b];
            hp_r[i] = m * proj + (1.f - m) * hp_r[i];
            ys[((size_t)t * ldb + b) * P + role.j0 + jl] = hp_r[i];
            hpbuf[(size_t)b * P + role.j0 + jl] = __float2bfloat16(hp_r[i]);
          }
        }
      }
    }
    grid.sync();
  }
}

__global__ void __launch_bounds__(THREADS, 1)
lstmp_bwd_kernel(const float* __restrict__ dys,           // [T, ldb, P]
                 const __nv_bfloat16* __restrict__ gates, // [T, ldb, 4H]
                 const float* __restrict__ cs,            // [T, ldb, H]
                 const float* __restrict__ mask,          // [T, ldb]
                 const __nv_bfloat16* __restrict__ wh,    // [P, 4H]
                 const __nv_bfloat16* __restrict__ wp,    // [H, P]
                 float* __restrict__ dgates,              // [T, ldb, 4H]
                 float* __restrict__ dhpm,                // [T, ldb, P] masked dhp
                 __nv_bfloat16* dgbuf,                    // [nb, 4H] exchange of bf16(dgates)
                 __nv_bfloat16* dpbuf,                    // [nb, P] exchange of bf16(dhp_m)
                 int T, int nb, int ldb, int H, int P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H4 = 4 * H;
  const int ldw = H4 + PAD, ldp = P + PAD, ldd = KCHUNK + PAD;
  __nv_bfloat16* Wr = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [PCOLS][ldw]
  __nv_bfloat16* Wu = Wr + PCOLS * ldw;                              // [UNITS][ldp]
  __nv_bfloat16* Xs = Wu + UNITS * ldp;                              // staged operand; partials
  float* Pp = reinterpret_cast<float*>(Xs);
  const int u0 = blockIdx.x * UNITS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int mtiles = (nb + 15) / 16;
  const int mt = warp & 3, kh = warp >> 2;  // step 2: 4 row tiles x 2 k-parities
  const ProjRole role = proj_role(P, mtiles);

  // resident weights: Wr[n][k] = Wh[j0 + n][k] (dhp = dgates . Wh^T);
  // Wu[u][j] = Wp[u0 + u][j] (dh_full = dhp_m . Wp^T)
  if (role.j0 >= 0) {
    for (int idx = tid; idx < PCOLS * H4; idx += THREADS) {
      const int n = idx / H4, k = idx % H4;
      Wr[n * ldw + k] = wh[(size_t)(role.j0 + n) * H4 + k];
    }
  }
  for (int idx = tid; idx < UNITS * P; idx += THREADS) {
    const int u = idx / P, j = idx % P;
    Wu[u * ldp + j] = wp[(size_t)(u0 + u) * P + j];
  }
  __syncthreads();

  float keep_r[MAX_HP], dc_r[MAX_PAIRS];  // (1-m).dhp_total and dc of step t+1
#pragma unroll
  for (int i = 0; i < MAX_HP; ++i) keep_r[i] = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PAIRS; ++i) dc_r[i] = 0.f;

  for (int s = 0; s < T; ++s) {
    const int t = T - 1 - s;
    // 1. the owned dhp columns of the owned rows: bf16(dgates_{t+1}) . Wh^T
    //    + (1-m_{t+1}).dhp_total_{t+1} + dys_t, then the mask of step t
    if (role.j0 >= 0) {
      float acc[MAX_MT][4];
#pragma unroll
      for (int i = 0; i < MAX_MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
      if (s > 0) {
        for (int kc = 0; kc < H4; kc += KCHUNK) {
          const int kw = min(KCHUNK, H4 - kc);
          stage_owned(Xs, ldd, dgbuf + kc, H4, role, nb, kw);
          __syncthreads();
          group_mma(acc, Xs, ldd, Wr + kc, ldw, kw, role, warp, g, tg);
          __syncthreads();
        }
        store_partials(Pp, acc, role, warp, g, tg);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < MAX_HP; ++i) {
        const int p = tid + i * THREADS, lr = p / PCOLS, jl = p % PCOLS;
        if (lr < role.cnt * 16) {
          const int b = role_row(role, lr);
          if (b < nb) {
            const float rec = (s > 0) ? sum_partials(Pp, b, jl) : 0.f;
            const size_t o = ((size_t)t * ldb + b) * P + role.j0 + jl;
            const float total = (rec + keep_r[i]) + dys[o];
            const float m = mask[(size_t)t * ldb + b];
            const float dm = m * total;
            dhpm[o] = dm;
            dpbuf[(size_t)b * P + role.j0 + jl] = __float2bfloat16(dm);
            keep_r[i] = (1.f - m) * total;
          }
        }
      }
    }
    grid.sync();
    // 2. the owned units: dh_full = bf16(dhp_m) . Wp^T, then the gate gradients
    stage_rows(Xs, ldp, dpbuf, P, mtiles * 16, nb, P);
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (mt < mtiles) {
      const __nv_bfloat16* a0 = Xs + (mt * 16 + g) * ldp + tg * 2;
      const __nv_bfloat16* a1 = a0 + 8 * ldp;
      const __nv_bfloat16* bp = Wu + g * ldp + tg * 2;
      for (int k0 = kh * 16; k0 < P; k0 += 32) {
        uint32_t a[4], b[2];
        a[0] = ld_u32(a0 + k0);
        a[1] = ld_u32(a1 + k0);
        a[2] = ld_u32(a0 + k0 + 8);
        a[3] = ld_u32(a1 + k0 + 8);
        b[0] = ld_u32(bp + k0);
        b[1] = ld_u32(bp + k0 + 8);
        mma_16816(acc, a, b);
      }
    }
    __syncthreads();
    if (mt < mtiles) {
      float* p0 = Pp + (kh * MAX_B + mt * 16 + g) * UNITS + tg * 2;
      p0[0] = acc[0];
      p0[1] = acc[1];
      p0[8 * UNITS] = acc[2];
      p0[8 * UNITS + 1] = acc[3];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_PAIRS; ++i) {
      const int p = tid + i * THREADS;
      if (p < nb * UNITS) {
        const int b = p / UNITS, u = p % UNITS, col = u0 + u;
        const float dh = Pp[b * UNITS + u] + Pp[(MAX_B + b) * UNITS + u];
        const size_t o = ((size_t)t * ldb + b) * H + col;
        const float m = mask[(size_t)t * ldb + b];
        const float dc_in = dc_r[i];
        const __nv_bfloat16* gt = gates + ((size_t)t * ldb + b) * H4 + col;
        const float ig = __bfloat162float(gt[0]), fg = __bfloat162float(gt[H]);
        const float gg = __bfloat162float(gt[2 * H]), og = __bfloat162float(gt[3 * H]);
        const float c = cs[o];
        const float c_prev = (t > 0) ? cs[o - (size_t)ldb * H] : 0.f;
        const float tc = tanhf(c);
        const float d_o = dh * tc;
        const float dc = dh * og * (1.f - tc * tc) + m * dc_in;
        const float d_i = dc * gg, d_f = dc * c_prev, d_g = dc * ig;
        const float dgi = d_i * ig * (1.f - ig);
        const float dgf = d_f * fg * (1.f - fg);
        const float dgg = d_g * (1.f - gg * gg);
        const float dgo = d_o * og * (1.f - og);
        float* dgt = dgates + ((size_t)t * ldb + b) * H4 + col;
        dgt[0] = dgi;
        dgt[H] = dgf;
        dgt[2 * H] = dgg;
        dgt[3 * H] = dgo;
        __nv_bfloat16* xb = dgbuf + (size_t)b * H4 + col;
        xb[0] = __float2bfloat16(dgi);
        xb[H] = __float2bfloat16(dgf);
        xb[2 * H] = __float2bfloat16(dgg);
        xb[3 * H] = __float2bfloat16(dgo);
        dc_r[i] = dc * fg + (1.f - m) * dc_in;
      }
    }
    grid.sync();
  }
}

// ---------------------------------------------------------------------------
// C interface. Each returns a cudaError_t code: 0 on a clean launch.
// ---------------------------------------------------------------------------

static size_t fwd_smem(int H) {
  return (size_t)(NCOL + MAX_B) * (H + PAD) * sizeof(__nv_bfloat16) +
         (size_t)MAX_B * NCOL * sizeof(float);
}

static size_t bwd_smem(int H) {
  return (size_t)UNITS * (4 * H + PAD) * sizeof(__nv_bfloat16) +
         (size_t)MAX_B * (KCHUNK + PAD) * sizeof(__nv_bfloat16) +
         (size_t)2 * MAX_B * UNITS * sizeof(float);
}

static size_t lstmp_fwd_smem(int H, int P) {
  return (size_t)(NCOL * (P + PAD) + PCOLS * (H + PAD) + lstmp_stage_elems(H + PAD)) *
             sizeof(__nv_bfloat16) +
         (size_t)MAX_B * NCOL * sizeof(float);
}

static size_t lstmp_bwd_smem(int H, int P) {
  const int stage = lstmp_stage_elems(KCHUNK > P ? KCHUNK + PAD : P + PAD);
  return (size_t)(PCOLS * (4 * H + PAD) + UNITS * (P + PAD) + stage) * sizeof(__nv_bfloat16);
}

static int launch_coop(const void* fn, int H, size_t smem, void** args, void* stream) {
  if (H < 16 || H % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem)) !=
      cudaSuccess)
    return (int)e;
  const int grid = H / UNITS;
  if (per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int pk2_lstm_max_batch() { return MAX_B; }

extern "C" int pk2_lstm_fwd(const void* xp, const void* wh, const void* mask, void* ys,
                            void* cs, void* gates, void* hbuf, int T, int nb, int ldb,
                            int H, void* stream) {
  if (nb < 1 || nb > MAX_B || T < 1) return (int)cudaErrorInvalidValue;
  const float* a_xp = (const float*)xp;
  const __nv_bfloat16* a_wh = (const __nv_bfloat16*)wh;
  const float* a_mask = (const float*)mask;
  float* a_ys = (float*)ys;
  float* a_cs = (float*)cs;
  __nv_bfloat16* a_gates = (__nv_bfloat16*)gates;
  __nv_bfloat16* a_hbuf = (__nv_bfloat16*)hbuf;
  void* args[] = {&a_xp, &a_wh, &a_mask, &a_ys, &a_cs, &a_gates, &a_hbuf,
                  &T, &nb, &ldb, &H};
  return launch_coop((const void*)lstm_fwd_kernel, H, fwd_smem(H), args, stream);
}

extern "C" int pk2_lstm_bwd(const void* dys, const void* gates, const void* cs,
                            const void* mask, const void* wh, void* dgates, void* dgbuf,
                            int T, int nb, int ldb, int H, void* stream) {
  if (nb < 1 || nb > MAX_B || T < 1) return (int)cudaErrorInvalidValue;
  const float* a_dys = (const float*)dys;
  const __nv_bfloat16* a_gates = (const __nv_bfloat16*)gates;
  const float* a_cs = (const float*)cs;
  const float* a_mask = (const float*)mask;
  const __nv_bfloat16* a_wh = (const __nv_bfloat16*)wh;
  float* a_dg = (float*)dgates;
  __nv_bfloat16* a_buf = (__nv_bfloat16*)dgbuf;
  void* args[] = {&a_dys, &a_gates, &a_cs, &a_mask, &a_wh, &a_dg, &a_buf,
                  &T, &nb, &ldb, &H};
  return launch_coop((const void*)lstm_bwd_kernel, H, bwd_smem(H), args, stream);
}

static bool proj_shape_ok(int nb, int T, int H, int P) {
  return nb >= 1 && nb <= MAX_B && T >= 1 && P >= 16 && P % 16 == 0 && P <= H;
}

extern "C" int pk2_lstmp_fwd(const void* xp, const void* wh, const void* wp, const void* mask,
                             void* ys, void* cs, void* gates, void* hfull, void* hpbuf,
                             int T, int nb, int ldb, int H, int P, void* stream) {
  if (!proj_shape_ok(nb, T, H, P)) return (int)cudaErrorInvalidValue;
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
                  &T, &nb, &ldb, &H, &P};
  return launch_coop((const void*)lstmp_fwd_kernel, H, lstmp_fwd_smem(H, P), args, stream);
}

extern "C" int pk2_lstmp_bwd(const void* dys, const void* gates, const void* cs,
                             const void* mask, const void* wh, const void* wp, void* dgates,
                             void* dhpm, void* dgbuf, void* dpbuf, int T, int nb, int ldb,
                             int H, int P, void* stream) {
  if (!proj_shape_ok(nb, T, H, P)) return (int)cudaErrorInvalidValue;
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
                  &a_dpbuf, &T, &nb, &ldb, &H, &P};
  return launch_coop((const void*)lstmp_bwd_kernel, H, lstmp_bwd_smem(H, P), args, stream);
}
