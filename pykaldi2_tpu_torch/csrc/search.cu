// The device search's frontier, one frame of it: kernel K12.
//
// K12 replaces no Pallas kernel: the JAX package's search
// (pykaldi2_tpu/decode/device_lattice.py, device_lattice_generate) is XLA
// operations, and so was the port's frame until this kernel. It computes the
// first half of decode/device_lattice.py:_Search.frame, exactly as
// decode/frontier.py:frontier_plain does, for one utterance per CTA:
//
//   m[s]         = max_d clamp(alpha[src[s,d]] + w[s,d], NEG_INF)   (two degree buckets)
//   new_alpha[s] = m[s] > NEG_INF/2 ? m[s] + obs_t[pdf[s]] : NEG_INF
//   new_alpha    = the in-frame eps layers, in topological order (L of them)
//   vals, idx    = the exact top K of new_alpha: lax.top_k's values and
//                  indices (float total order, -0.0 below +0.0, ties to the
//                  lowest index), in that order
//   keep_k, emit_k, alpha_next (pruned at the frontier's cutoff), slot_cur
//   (each emitted state's frontier position, -1 elsewhere); rows past their
//   utterance's last frame keep alpha and slot_prev.
//
// Every score is the same fp32 operation in the same order as the plain
// form (gather, + w, clamp, max over d, + obs), so the outputs are bit-equal
// to it; the maxima propagate NaN as torch.amax does.
//
// Bound. One frame of the benchmark's graph (5,167 states, 79,255 in-arc
// slots, B = 16, K = 200) needs about 0.6 MB of tables and 1.7 MB of rows:
// under a microsecond of bytes at 3.35 TB/s, and a few MFLOP. What bounds the
// frame on this card is latency: the launch, and a chain of dependent steps
// (the rows' S x Dc gathers, then the selection's passes over the row, each
// a block-wide barrier), run by B CTAs on B of the 132 SMs. The PyTorch form
// paid both as ~45 launches a frame (~4 us each inside the CUDA graph).
//
// Design.
// - One launch a frame, one CTA of 1,024 threads per utterance: every step
//   is independent across rows, so there is no grid barrier.
// - The row being gathered (alpha) and the row being built (new_alpha) sit
//   in shared memory (2 x 4 x S bytes), so the S x Dc gathers read shared
//   memory; the graph's tables are int32/fp32, transposed to [d, S] so that
//   a thread walks its state's in-arcs with warp-coalesced loads (L2-resident
//   across the B CTAs). A row too large for shared memory is gathered from
//   global memory (alpha from its input, new_alpha in alpha_next's buffer):
//   the same code, a template flag.
// - Top-K is a block radix select over the 32-bit order key: up to four
//   8-bit passes of a shared-memory histogram (warp-aggregated atomics), each
//   followed by a one-warp scan of the 256 bins; it stops as soon as the bin
//   holding the K-th key is taken whole. The winners are collected in one
//   more pass (keys above the threshold by an atomic slot, keys equal to it in
//   index order by a block scan, so ties go to the lowest index), then a
//   bitonic sort of the K (state index below the complemented key) in shared
//   memory orders them as lax.top_k does; its stages of stride below 32 run
//   in registers with warp shuffles, so a barrier serves only the wider
//   strides. A K whose sort buffer does not fit beside the rows sorts in a
//   global scratch buffer: same code.
// - Nothing is allocated: the wrapper passes outputs and scratch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the opt-in shared-memory limit of a Hopper CTA
constexpr int kMaxSmemBytes = 232448;
// shared words after the sort buffer and the rows: 256 histogram bins, two
// sets of warp counts, 16 words of broadcast values
constexpr int kFixedWords = 256 + 2 * kWarps + 16;

}  // namespace

// One frame's arguments; decode/frontier.py's _Args mirrors this layout.
struct FrontierArgs {
  const float* alpha;             // [B, S]
  const long long* slot_prev;     // [B, S]
  const float* obs;               // row b at obs + b * obs_stride, P floats
  const long long* num_frames;    // [B]
  const int* lo_src;              // [d_lo, s_lo]
  const float* lo_w;
  const int* hi_src;              // [d_hi, S - s_lo]
  const float* hi_w;
  const int* pdf;                 // [S]
  const int* ez[3];               // eps buckets: destinations [Z]
  const int* esrc[3];             // [e, Z]
  const float* ew[3];             // [e, Z]
  const int* elayers;             // [3, L + 1] row offsets of each layer
  float* obs_s;                   // [B, S]
  float* vals;                    // [B, K]
  long long* idx;                 // [B, K]
  unsigned char* keep;            // [B, K]
  unsigned char* emit;            // [B, K]
  float* alpha_next;              // [B, S]
  long long* slot_cur;            // [B, S]
  unsigned long long* scratch;    // [B, N] when the sort buffer is not in shared memory
  long long obs_stride;
  int B, S, s_lo, d_lo, d_hi, K, N, L, t;
  int ez_n[3], ee[3];
  int row_smem, sort_smem;
  float beam, lattice_beam, neg_inf, half_neg;
};

namespace {

// torch.amax's maximum: NaN wins
__device__ __forceinline__ float max_nan(float a, float b) { return (isnan(a) || a > b) ? a : b; }

// ascending 32-bit key of the float total order (-0.0 below +0.0)
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return u ^ ((u >> 31) ? kFull : 0x80000000u);
}

// the sort key: ascending = descending score, then ascending state index
__device__ __forceinline__ unsigned long long sort_key(unsigned key, int s) {
  return (static_cast<unsigned long long>(~key) << 32) | static_cast<unsigned>(s);
}

// max over a state's in-arcs d of clamp(row[src] + w, NEG_INF), tables [d][n]
template <typename Row>
__device__ __forceinline__ float relax_state(Row row, const int* __restrict__ src,
                                             const float* __restrict__ w, int n, int r, int d,
                                             float neg_inf) {
  float m = 0.f;
#pragma unroll 8
  for (int e = 0; e < d; ++e) {
    const size_t o = static_cast<size_t>(e) * n + r;
    const float x = row[__ldg(src + o)] + __ldg(w + o);
    const float v = x < neg_inf ? neg_inf : x;  // clamp_min: NaN passes
    m = e ? max_nan(m, v) : v;
  }
  return m;
}

// hist[digit] += 1 for each thread with pred, one atomic per distinct digit of a warp
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned digit, bool pred) {
  const unsigned active = __ballot_sync(kFull, pred);
  if (pred) {
    const unsigned peers = __match_any_sync(active, digit);
    if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1))
      atomicAdd(&hist[digit], __popc(peers));
  }
}

// the bitonic stages of sizes size_lo..size_hi with strides below 32, on
// each 32-element segment of buf that this warp owns: element e in lane
// e % 32, its partner e ^ j one shuffle away
__device__ __forceinline__ void warp_stages(unsigned long long* buf, int N, int size_lo,
                                            int size_hi, int lane, int warp) {
  for (int seg = warp * 32; seg < N; seg += kThreads) {
    const int e = seg + lane;
    unsigned long long x = buf[e];
    for (int size = size_lo; size <= size_hi; size <<= 1) {
      for (int j = (size >> 1) < 16 ? (size >> 1) : 16; j > 0; j >>= 1) {
        const unsigned long long y = __shfl_xor_sync(kFull, x, j);
        const bool keep_min = ((e & j) == 0) == ((e & size) == 0);
        x = keep_min ? (x < y ? x : y) : (x < y ? y : x);
      }
    }
    buf[e] = x;
  }
}

template <bool kRowSmem>
__global__ void __launch_bounds__(kThreads, 1) frontier_kernel(const FrontierArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = a.S, K = a.K, N = a.N;
  const size_t rs = static_cast<size_t>(b) * S;

  size_t off = a.sort_smem ? static_cast<size_t>(N) * 8 : 0;
  unsigned long long* buf = a.sort_smem ? reinterpret_cast<unsigned long long*>(smem)
                                        : a.scratch + static_cast<size_t>(b) * N;
  float* prev_s = reinterpret_cast<float*>(smem + off);
  float* row_s = prev_s + S;
  if (kRowSmem) off += static_cast<size_t>(2) * S * 4;
  unsigned* hist = reinterpret_cast<unsigned*>(smem + off);
  unsigned* wcnt = hist + 256;
  unsigned* misc = wcnt + 2 * kWarps;
  float* miscf = reinterpret_cast<float*>(misc);

  const float* prev = kRowSmem ? prev_s : a.alpha + rs;
  float* row = kRowSmem ? row_s : a.alpha_next + rs;
  const float* obs = a.obs + static_cast<size_t>(b) * a.obs_stride;
  const float neg_inf = a.neg_inf, half_neg = a.half_neg;

  if (kRowSmem) {
    for (int s = tid; s < S; s += kThreads) prev_s[s] = a.alpha[rs + s];
    __syncthreads();
  }

  // relaxation over both buckets, then the observation add
  const int s2 = S - a.s_lo;
  for (int s = tid; s < S; s += kThreads) {
    const float m = s < a.s_lo ? relax_state(prev, a.lo_src, a.lo_w, a.s_lo, s, a.d_lo, neg_inf)
                               : relax_state(prev, a.hi_src, a.hi_w, s2, s - a.s_lo, a.d_hi,
                                             neg_inf);
    const float o = obs[__ldg(a.pdf + s)];
    a.obs_s[rs + s] = o;
    row[s] = m > half_neg ? m + o : neg_inf;
  }

  // the in-frame eps layers: layer r updates the eps destinations of depth
  // r + 1 from sources of smaller depth, so a layer reads nothing it writes
  for (int r = 0; r < a.L; ++r) {
    __syncthreads();
    for (int k = 0; k < 3; ++k) {
      const int lo = a.elayers[k * (a.L + 1) + r], hi = a.elayers[k * (a.L + 1) + r + 1];
      const int n = a.ez_n[k], e = a.ee[k];
      for (int i = lo + tid; i < hi; i += kThreads) {
        float rz = 0.f;
        for (int j = 0; j < e; ++j) {
          const size_t o = static_cast<size_t>(j) * n + i;
          const float x = row[__ldg(a.esrc[k] + o)] + __ldg(a.ew[k] + o);
          rz = j ? max_nan(rz, x) : x;
        }
        const int z = __ldg(a.ez[k] + i);
        const float cur = row[z];
        row[z] = (isnan(rz) || cur < rz) ? rz : cur;  // scatter_reduce "amax"
      }
    }
  }
  __syncthreads();

  // the row's best (torch.amax)
  {
    float m = -INFINITY;
    for (int s = tid; s < S; s += kThreads) m = max_nan(m, row[s]);
#pragma unroll
    for (int o = 16; o; o >>= 1) m = max_nan(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) reinterpret_cast<float*>(wcnt)[warp] = m;
    __syncthreads();
    if (warp == 0) {
      float v = reinterpret_cast<float*>(wcnt)[lane];
#pragma unroll
      for (int o = 16; o; o >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, o));
      if (lane == 0) miscf[8] = v;
    }
  }

  // radix select of the K-th largest key: after the passes, the winners
  // are the keys whose masked bits exceed prefix, and the k lowest-index
  // keys whose masked bits equal it
  unsigned prefix = 0, mask = 0;
  int k = K;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < S; base += kThreads) {
      const int s = base + tid;
      const unsigned key = s < S ? order_key(row[s]) : 0u;
      hist_add(hist, (key >> shift) & 255u, s < S && (key & mask) == prefix);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l down to 248 - 8l
      unsigned c[8], tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - 8 * lane - j];
        tot += c[j];
      }
      unsigned incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      unsigned run = incl - tot;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (run < static_cast<unsigned>(k) && static_cast<unsigned>(k) <= run + c[j]) {
          misc[0] = 255 - 8 * lane - j;
          misc[1] = run;
          misc[2] = c[j];
        }
        run += c[j];
      }
    }
    __syncthreads();
    const unsigned digit = misc[0], above = misc[1], count = misc[2];
    k -= static_cast<int>(above);
    prefix |= digit << shift;
    mask |= 255u << shift;
    if (count == static_cast<unsigned>(k)) break;  // the bin is taken whole
  }

  // collect the K winners: [0, K - k) above the threshold, [K - k, K) equal
  if (tid == 0) misc[3] = 0;
  __syncthreads();
  {
    int eq_base = 0, par = 0;
    for (int base = 0; base < S; base += kThreads) {
      const int s = base + tid;
      const unsigned key = s < S ? order_key(row[s]) : 0u;
      const bool gt = s < S && (key & mask) > prefix;
      const bool eq = s < S && (key & mask) == prefix;
      if (gt) buf[atomicAdd(&misc[3], 1u)] = sort_key(key, s);
      const unsigned bal = __ballot_sync(kFull, eq);
      if (lane == 0) wcnt[par * kWarps + warp] = __popc(bal);
      __syncthreads();
      // every warp scans the kWarps (= 32) counts, one a lane
      const unsigned c = wcnt[par * kWarps + lane];
      unsigned incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int before = static_cast<int>(__shfl_sync(kFull, incl - c, warp));
      const int total = static_cast<int>(__shfl_sync(kFull, incl, 31));
      const int rank = eq_base + before + __popc(bal & ((1u << lane) - 1u));
      if (eq && rank < k) buf[K - k + rank] = sort_key(key, s);
      eq_base += total;
      par ^= 1;
    }
  }
  for (int i = K + tid; i < N; i += kThreads) buf[i] = ~0ull;
  __syncthreads();

  // bitonic sort of buf[0, N), ascending (N a power of two, at least 32):
  // the stages of stride 32 and more exchange through buf, a barrier each;
  // a size's strides below 32 run in registers, one element a lane
  warp_stages(buf, N, 2, 32, lane, warp);
  __syncthreads();
  for (int size = 64; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
      for (int i = tid; i < N / 2; i += kThreads) {
        const int p = 2 * i - (i & (stride - 1));
        const unsigned long long x = buf[p], y = buf[p + stride];
        if ((x > y) == ((p & size) == 0)) {
          buf[p] = y;
          buf[p + stride] = x;
        }
      }
      __syncthreads();
    }
    warp_stages(buf, N, size, size, lane, warp);
    __syncthreads();
  }

  // the frontier's outputs
  const float best = miscf[8];
  const float thr = best - a.beam, lthr = best - a.lattice_beam;
  const size_t ks = static_cast<size_t>(b) * K;
  for (int i = tid; i < K; i += kThreads) {
    const int s = static_cast<int>(buf[i] & 0xffffffffu);
    const float v = row[s];
    const bool kp = v >= thr && v > half_neg;
    a.vals[ks + i] = v;
    a.idx[ks + i] = s;
    a.keep[ks + i] = kp;
    a.emit[ks + i] = kp && v >= lthr;
  }
  const float vl = row[buf[K - 1] & 0xffffffffu];
  const float cutoff = (vl >= thr && vl > half_neg) ? ((isnan(thr) || thr > vl) ? thr : vl) : thr;
  __syncthreads();  // row (alpha_next's buffer in the global route) read

  const bool active = a.t < a.num_frames[b];
  for (int s = tid; s < S; s += kThreads) {
    if (active) {
      const float v = row[s];
      a.alpha_next[rs + s] = v >= cutoff ? v : neg_inf;
      a.slot_cur[rs + s] = -1;
    } else {
      a.alpha_next[rs + s] = a.alpha[rs + s];
      a.slot_cur[rs + s] = a.slot_prev[rs + s];
    }
  }
  if (active) {
    __syncthreads();
    for (int i = tid; i < K; i += kThreads)
      if (a.emit[ks + i]) a.slot_cur[rs + a.idx[ks + i]] = i;
  }
}

template <bool kRowSmem>
cudaError_t launch(const FrontierArgs& a, int smem, cudaStream_t stream) {
  static bool ready = false;  // the dynamic shared memory limit, set once (one card)
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        frontier_kernel<kRowSmem>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  frontier_kernel<kRowSmem><<<a.B, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pk2_search_threads() { return kThreads; }

int pk2_search_max_smem() { return kMaxSmemBytes; }

int pk2_search_fixed_smem() { return kFixedWords * 4; }

int pk2_search_args_size() { return static_cast<int>(sizeof(FrontierArgs)); }

// One frame's frontier for a->B utterances on the stream; N is the power of
// two at or above max(K, 32). The shared memory must be what the layout
// flags ask for: the sort buffer (8 N bytes) if
// sort_smem, both rows (8 S bytes) if row_smem, and the fixed words.
int pk2_search_frontier(const FrontierArgs* a, int smem, void* stream) {
  const long long need = (a->sort_smem ? 8LL * a->N : 0) + (a->row_smem ? 8LL * a->S : 0) +
                         kFixedWords * 4;
  if (smem != need || smem > kMaxSmemBytes || a->K < 1 || a->K > a->S || a->N < a->K ||
      a->N < 32 || (a->N & (a->N - 1)) != 0 || (!a->sort_smem && a->scratch == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->row_smem ? launch<true>(*a, smem, s) : launch<false>(*a, smem, s);
}

}  // extern "C"
