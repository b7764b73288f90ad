// Flash-decode attention for Hopper (sm_90a): one query token per row
// against a heads-major KV cache, in one launch split over the live prefix.
//
// Replaces the Pallas TPU kernel `flash_decode_attention`
// (src/repro/kernels/flash_decode.py, `_decode_kernel`).  It computes the
// same function: for every (batch row b, KV head kh) the G = H / KH query
// heads of the GQA group attend to keys [0, min(pos, S)) with an online
// softmax in f32 and scale 1/sqrt(D); rows with pos <= 0 return exact zeros.
//
// What bounds it on this card: it reads 2 * B * KH * min(pos, S) * D cache
// elements once and does ~4 flops per element, far below the card's ~295
// flops per byte, so it is bound by device-memory bytes; at the served
// shapes (1 MB of cache a call for qwen2.5-3b, 15 MB for zamba2-7b) it is
// bound in practice by the latency of one trip to device memory and of the
// cross-block merge.  The design follows from that:
//
//   * one grid (B * KH * RG, n_split), fixed by the host from shapes alone
//     (RG row groups of GT query heads, GT 1, 2 or 4: fewer heads a
//     block shorten its work after the last tile lands, more row groups
//     read K and V again from L2).  Every block reads its
//     row's valid = min(pos, S) on the device and takes an equal share of
//     [0, valid) in units of kAlign keys (`slice_of`), so every block has
//     keys whatever max_seq is, and pos never goes to the host (the call
//     can be captured in a CUDA graph and replayed with pos changed);
//   * a block's K and V slice streams into shared memory, kept in the
//     cache's dtype, through a ring of kStages tiles: a tile's K rows and
//     its V rows are each one contiguous run, so one thread asks the copy
//     engine for each run (`cp.async.bulk`) and the tile lands on its
//     stage's mbarrier.  The first kStages tiles are all in flight before
//     the block waits on the first, and a stage is refilled as soon as its
//     tile is consumed.  bf16 widens to f32 in registers;
//   * inside a tile, L lanes share a key (16 bytes of its row each: L = 16
//     at D 128 or 112 in bf16), so a warp works on 32 / L keys at a time
//     and the group's GT query rows sit in registers: G = 1 keeps every
//     lane busy.  Each key group keeps its own online softmax (m, l, acc);
//     the groups merge by shuffles, the warps through shared memory, in a
//     fixed order;
//   * the merge across blocks is folded into the same launch through a
//     thread-block cluster: the n_split blocks of one (b, kh, row group)
//     form a cluster (at most 16 blocks).  Each output float4 belongs to
//     one block of the cluster; every block stores its f32 partial of it
//     (and its m and l) straight into the owner's shared memory, and after
//     one cluster barrier each block merges its own outputs from its own
//     shared memory, a half-warp an output, in a fixed order of shuffles.
//     No partial goes to device memory, and no counter or fence orders the
//     blocks.  The slices and every sum's order depend only on valid and
//     the shapes, so the result is deterministic (repeat calls bit-equal,
//     a size-1 pos vector equal to the scalar).  An empty slice sends
//     m = -inf, l = 0, acc = 0: weight 0 in the merge.  (A merge by the
//     block that takes the last ticket of a counter, with the partials
//     in device memory, measured slower: a fence, an atomic and two more
//     trips to memory on the critical path.)
//
// The kernel launches on the stream it is given and allocates nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 5;        // tiles of the ring
constexpr int kAlign = 16;        // a slice starts at a multiple of this
constexpr int kMaxSplit = 16;     // blocks a cluster (non-portable above 8)

// VEC values of T in 16 bytes; TK keys a tile (16 KB of K and V at D 128)
template <typename T> struct Cfg;
template <> struct Cfg<float> {
  static constexpr int VEC = 4;
  static constexpr int TK = 16;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static constexpr int TK = 32;
};

// 16 bytes of T (global or shared memory) -> f32 registers
__device__ __forceinline__ void widen(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void widen(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// four outputs at once (16-byte aligned for f32, 8-byte for bf16)
__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits until the barrier's phase of parity `parity` has completed; a
// wait of ~2^35 cycles (over 10 s) traps, so a lost copy fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_test(bar, parity)) {
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// `bytes` (a multiple of 16) of contiguous global memory -> shared memory
// by the copy engine, completing them on the barrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(bar) : "memory");
}

// The cluster's barrier in two halves: arrive early, wait when needed.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Bytes of the ring of K and V tiles, reused after them for the warps'
// accumulators [kWarps][GT][D] (f32); the inbox follows them.
template <typename T>
__host__ __device__ __forceinline__ size_t main_bytes(int D, int GT) {
  const size_t ring = (size_t)2 * kStages * Cfg<T>::TK * D * sizeof(T);
  const size_t xacc = sizeof(float) * (size_t)kWarps * GT * D;
  return ring > xacc ? ring : xacc;
}

// 2^x on the special-function unit (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// weight of a partial with max m against the merged max mx (0 for an
// empty partial, whose m is -inf)
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -CUDART_INF_F ? 0.f : fast_exp2(m - mx);
}

// Keys [k0, k1) of split `split`: the valid prefix in units of kAlign keys,
// split i taking units [i * n / n_split, (i + 1) * n / n_split).
// kernels/flash_decode.py:slice_bounds mirrors it.
__device__ __forceinline__ void slice_of(int valid, int split, int n_split,
                                         int* k0, int* k1) {
  const int units = (valid + kAlign - 1) / kAlign;
  const int u0 = (int)((long long)split * units / n_split);
  const int u1 = (int)((long long)(split + 1) * units / n_split);
  *k0 = u0 * kAlign;
  *k1 = min(u1 * kAlign, valid);
}

// grid (B * KH * RG, n_split) in clusters of (1, n_split): the n_split
// blocks of one (row, KV head, row group) form one cluster, blockIdx.y its
// rank.  Dynamic shared memory: the ring (kStages tiles of K and V),
// reused after the tiles for the warps' accumulators [kWarps][GT][D]
// (`main_bytes`), then the inbox of the outputs this block merges.
template <typename T, int GT>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos, int per_row,
    T* __restrict__ out, int KH, int G, int RG, int S, int D, int n_split,
    float scale_log2) {
  constexpr int VEC = Cfg<T>::VEC;
  constexpr int TK = Cfg<T>::TK;
  // keys a key group scores together: independent dot products and
  // shuffles in flight, one rescale of the accumulator for them all
  constexpr int BATCH = 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float s_m[kWarps][GT], s_l[kWarps][GT];
  __shared__ float bm[GT], bl[GT];         // the block's partial: m, l
  __shared__ float all_m[kMaxSplit][GT], all_l[kMaxSplit][GT];  // inbox
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive();                        // waited on before any push

  const int bhr = blockIdx.x;              // (b * KH + kh) * RG + rg
  const int split = blockIdx.y;            // == the block's cluster rank
  const int bh = bhr / RG;
  const int g0 = (bhr % RG) * GT;          // first query head of the tile
  const int nvec = D / VEC;                // 16-byte columns of a row
  int lg = 0;                              // lanes a key: L = 2^lg >= nvec
  while ((1 << lg) < nvec) ++lg;
  const int L = 1 << lg;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = lane & (L - 1);            // this lane's column
  const int kl = lane >> lg;               // this lane's key of the warp's
  const bool col = c < nvec;
  const int per_warp = 32 >> lg;           // keys a warp takes at once
  const int n_slots = kWarps * per_warp;
  float* xacc = reinterpret_cast<float*>(smem_raw);   // after the tiles
  // [n_split][per_block] float4: every split's partial of this block's
  // outputs; written by the peers while this block may still be at work
  float4* inbox = reinterpret_cast<float4*>(
      smem_raw + main_bytes<T>(D, GT));

  // pos first: every block's copies wait on it, the q rows do not
  int valid = pos[per_row ? bh / KH : 0];
  valid = valid < 0 ? 0 : (valid < S ? valid : S);
  int k0, k1;
  slice_of(valid, split, n_split, &k0, &k1);
  const int len = k1 - k0;
  const int n_tiles = len > 0 ? (len + TK - 1) / TK : 0;
  T* ks = reinterpret_cast<T*>(smem_raw);             // [kStages][TK][D]
  T* vs = ks + (size_t)kStages * TK * D;              // [kStages][TK][D]
  const T* kb = k + ((size_t)bh * S + k0) * D;
  const T* vb = v + ((size_t)bh * S + k0) * D;
  __shared__ __align__(8) uint64_t bars[kStages];     // a tile's landing
  // tile t into stage t % kStages: its K rows and its V rows are each one
  // contiguous run in the cache and in the ring, one bulk copy each
  auto fetch = [&](int t) {
    const int st = t % kStages;
    const uint32_t bytes = min(TK, len - t * TK) * D * (int)sizeof(T);
    mbar_expect_tx(smem_addr(bars + st), 2 * bytes);
    bulk_load(ks + (size_t)st * TK * D, kb + (size_t)t * TK * D, bytes,
              smem_addr(bars + st));
    bulk_load(vs + (size_t)st * TK * D, vb + (size_t)t * TK * D, bytes,
              smem_addr(bars + st));
  };
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(smem_addr(bars + st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < kStages && t < n_tiles; ++t) fetch(t);
  }

  // the group's q rows while the tiles land
  float qr[GT][VEC];
  const T* qb = q + (size_t)bh * G * D;    // q (B, 1, H, D): head kh * G + g
#pragma unroll                             // of row b at (bh * G + g) * D
  for (int i = 0; i < GT; ++i) {
    if (col && g0 + i < G) {
      widen(qb + (size_t)(g0 + i) * D + c * VEC, qr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[i][e] = 0.f;
    }
  }
  __syncthreads();                         // the barriers are initialised

  if (k0 < k1) {
    float m[GT], l[GT], acc[GT][VEC];
#pragma unroll
    for (int i = 0; i < GT; ++i) {
      m[i] = -CUDART_INF_F;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] = 0.f;
    }
    for (int t = 0; t < n_tiles; ++t) {
      mbar_wait(smem_addr(bars + t % kStages), (t / kStages) & 1);
      const int n = min(TK, len - t * TK);
      const T* kt = ks + (size_t)(t % kStages) * TK * D;
      const T* vt = vs + (size_t)(t % kStages) * TK * D;
      // j0 is uniform across the warp, so every lane takes the shuffles;
      // key r of the batch is j0 + r * n_slots + kl
      for (int j0 = warp * per_warp; j0 < n; j0 += BATCH * n_slots) {
        float s[BATCH][GT];
#pragma unroll
        for (int r = 0; r < BATCH; ++r) {
          const int j = j0 + r * n_slots + kl;
          float kx[VEC];
          if (j < n && col) {
            widen(kt + (size_t)j * D + c * VEC, kx);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kx[e] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < GT; ++i) {
            float a = 0.f;
#pragma unroll
            for (int e = 0; e < VEC; ++e) a = fmaf(qr[i][e], kx[e], a);
            s[r][i] = a;
          }
        }
        for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
          for (int r = 0; r < BATCH; ++r) {
#pragma unroll
            for (int i = 0; i < GT; ++i)
              s[r][i] += __shfl_xor_sync(0xffffffffu, s[r][i], o);
          }
        }
#pragma unroll
        for (int r = 0; r < BATCH; ++r) {
          const bool live = j0 + r * n_slots + kl < n;
#pragma unroll
          for (int i = 0; i < GT; ++i)
            s[r][i] = live ? s[r][i] * scale_log2 : -CUDART_INF_F;
        }
#pragma unroll
        for (int i = 0; i < GT; ++i) {
          float mn = m[i];
#pragma unroll
          for (int r = 0; r < BATCH; ++r) mn = fmaxf(mn, s[r][i]);
          // no live key yet: m and mn stay -inf, acc and l stay 0
          const float cr = weight(m[i], mn);
          l[i] *= cr;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] *= cr;
          m[i] = mn;
#pragma unroll
          for (int r = 0; r < BATCH; ++r) s[r][i] = weight(s[r][i], mn);
        }
#pragma unroll
        for (int r = 0; r < BATCH; ++r) {
          if (j0 + r * n_slots + kl >= n) continue;
#pragma unroll
          for (int i = 0; i < GT; ++i) l[i] += s[r][i];
          if (col) {
            float vx[VEC];
            widen(vt + (size_t)(j0 + r * n_slots + kl) * D + c * VEC,
                  vx);
#pragma unroll
            for (int i = 0; i < GT; ++i) {
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[i][e] = fmaf(s[r][i], vx[e], acc[i][e]);
            }
          }
        }
      }
      __syncthreads();                    // the stage may be refilled
      if (threadIdx.x == 0 && t + kStages < n_tiles) fetch(t + kStages);
    }

    // the warp's key groups, merged by shuffles (lanes o apart share a
    // column of different keys)
    for (int o = L; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
        const float mn = fmaxf(m[i], mo);
        const float wa = weight(m[i], mn);
        const float wb = weight(mo, mn);
        l[i] = l[i] * wa + lo * wb;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[i][e], o);
          acc[i][e] = acc[i][e] * wa + ao * wb;
        }
        m[i] = mn;
      }
    }
    // the warps, merged through shared memory in warp order
    if (lane < L && col) {
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        float4* dst = reinterpret_cast<float4*>(
            xacc + ((size_t)warp * GT + i) * D + c * VEC);
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          dst[e / 4] = make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2],
                                   acc[i][e + 3]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < GT; ++i) {
        s_m[warp][i] = m[i];
        s_l[warp][i] = l[i];
      }
    }
    __syncthreads();
    if (threadIdx.x < GT) {                // the warps' weights, m and l
      const int i = threadIdx.x;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][i]);
      float ls = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float ww = weight(s_m[w][i], mx);
        ls += ww * s_l[w][i];
        s_m[w][i] = ww;
      }
      bm[i] = mx;
      bl[i] = ls;
    }
  } else if (threadIdx.x < GT) {           // an empty slice: weight 0
    bm[threadIdx.x] = -CUDART_INF_F;
    bl[threadIdx.x] = 0.f;
  }
  __syncthreads();

  // The block's partial goes to the blocks that merge it: output float4 it
  // belongs to block it % n_split, which keeps every split's copy of it in
  // its inbox, and every block keeps every split's m and l.  The stores go
  // straight into the owners' shared memory; one cluster barrier later
  // each block merges its own outputs from its own shared memory.
  cluster_wait();                          // every block of it has started
  const int d4n = D / 4;
  const int per_block = (GT * d4n + n_split - 1) / n_split;
  for (int it = threadIdx.x; it < GT * d4n; it += kThreads) {
    const int i = it / d4n;
    const int d = (it % d4n) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 < k1) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float ww = s_m[w][i];
        const float4 x = *reinterpret_cast<const float4*>(
            xacc + ((size_t)w * GT + i) * D + d);
        a.x += ww * x.x;
        a.y += ww * x.y;
        a.z += ww * x.z;
        a.w += ww * x.w;
      }
    }
    *cluster.map_shared_rank(inbox + (size_t)split * per_block
                             + it / n_split, it % n_split) = a;
  }
  for (int t = threadIdx.x; t < n_split * GT; t += kThreads) {
    *cluster.map_shared_rank(&all_m[split][t % GT], t / GT) = bm[t % GT];
    *cluster.map_shared_rank(&all_l[split][t % GT], t / GT) = bl[t % GT];
  }
  cluster.sync();                          // every partial has landed

  // a half-warp an output float4, lane r taking split r's partial; the
  // max and the sums go over the 16 lanes by shuffles in a fixed order
  T* ob = out + ((size_t)bh * G + g0) * D;           // out (B, 1, H, D)
  const int r = threadIdx.x & 15;
  for (int base = split + 2 * warp * n_split; base < GT * d4n;
       base += (kThreads / 16) * n_split) {  // uniform across the warp
    const int it = base + ((threadIdx.x >> 4) & 1) * n_split;
    const bool has = r < n_split && it < GT * d4n;
    const int i = has ? it / d4n : 0;
    const float mr = has ? all_m[r][i] : -CUDART_INF_F;
    float mx = mr;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float w = weight(mr, mx);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
    if (has) {
      const float4 x = inbox[(size_t)r * per_block + it / n_split];
      ls = w * all_l[r][i];
      a = make_float4(w * x.x, w * x.y, w * x.z, w * x.w);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      ls += __shfl_xor_sync(0xffffffffu, ls, o);
      a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
      a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
      a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
      a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
    }
    if (r == 0 && it < GT * d4n && g0 + it / d4n < G) {
      const float den = fmaxf(ls, 1e-30f);
      store4(ob + (size_t)(it / d4n) * D + (it % d4n) * 4,
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
  }
}

template <typename T, int GT>
int launch_gt(const void* q, const void* k, const void* v, const int* pos,
              int per_row, void* out, int B, int KH, int G, int RG, int S,
              int D, int n_split, float scale_log2, cudaStream_t st) {
  const int per_block = (GT * (D / 4) + n_split - 1) / n_split;
  const size_t smem = main_bytes<T>(D, GT) +
                      sizeof(float4) * (size_t)n_split * per_block;
  auto kernel = flash_decode_kernel<T, GT>;
  // the opt-ins, set once an instantiation by whichever host thread comes
  // first: the largest shared memory the wrapper admits (D of 32 16-byte
  // loads, kMaxSplit splits) and clusters above 8 blocks
  static const cudaError_t opted = [kernel] {
    constexpr int kMaxD = 32 * Cfg<T>::VEC;
    const size_t most = main_bytes<T>(kMaxD, GT) +
                        sizeof(float4) * ((size_t)GT * (kMaxD / 4) +
                                          kMaxSplit - 1);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (opted != cudaSuccess) return (int)opted;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * KH * RG, n_split);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n_split;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, per_row, static_cast<T*>(out), KH, G,
      RG, S, D, n_split, scale_log2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           int per_row, void* out, int B, int H, int KH, int GT, int S,
           int D, int n_split, float scale_log2, void* stream) {
  const int G = H / KH;
  const int RG = (G + GT - 1) / GT;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (n_split < 1 || n_split > kMaxSplit) return (int)cudaErrorInvalidValue;
#define FD_LAUNCH(N)                                                         \
  return launch_gt<T, N>(q, k, v, pos, per_row, out, B, KH, G, RG, S, D,    \
                         n_split, scale_log2, st)
  switch (GT) {
    case 1: FD_LAUNCH(1);
    case 2: FD_LAUNCH(2);
    case 4: FD_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_LAUNCH
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Pointers are device pointers,
// `stream` a cudaStream_t; shapes, the row tile GT (1, 2 or 4) and
// n_split (1..16, the cluster's size) were checked and chosen by the
// Python wrapper; scale_log2 is log2(e) / sqrt(D).
int flash_decode_f32(const void* q, const void* k, const void* v,
                     const int* pos, int per_row, void* out, int B, int H,
                     int KH, int GT, int S, int D, int n_split,
                     float scale_log2, void* stream) {
  return launch<float>(q, k, v, pos, per_row, out, B, H, KH, GT, S, D,
                       n_split, scale_log2, stream);
}

int flash_decode_bf16(const void* q, const void* k, const void* v,
                      const int* pos, int per_row, void* out, int B, int H,
                      int KH, int GT, int S, int D, int n_split,
                      float scale_log2, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, pos, per_row, out, B, H, KH, GT, S,
                               D, n_split, scale_log2, stream);
}

}  // extern "C"
