// Flash attention (prefill) for Hopper (sm_90a): blockwise online softmax
// over a sequence-major KV, with causal mask, q_offset, sliding window and
// GQA.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, `_flash_kernel`).  It computes the
// same function: for every batch row b and query head h, the queries at
// absolute positions qpos = q_offset + i attend to the keys kpos of KV head
// h / G (G = H / KH) with an online softmax in f32 and scale 1/sqrt(D).  A
// key is live when kpos < Sk, kpos <= qpos (causal) and kpos > qpos - window
// (sliding window); dead scores are the finite -1e30, not -inf, as in the
// Pallas kernel, so every row with at least one live key gives the
// reference's result.  The output is divided by max(l, 1e-30).
//
// What bounds it on this card: at the served shapes (qwen2.5-3b H 16, KH 2,
// D 128; zamba2-7b H 32, KH 32, D 112; Sq = Sk = 1024 or 2048, causal) it
// does 4 * D flops for each live (query, key) pair against 2 bytes per
// element moved once, hundreds of flops per byte: it is bound by the bf16
// tensor-core rate (`bound_flops` in the wrapper).
//
// Where it differs from the Pallas kernel, and why: the Pallas grid walks
// the kv blocks in order on one core and keeps (m, l, acc) in VMEM scratch
// across grid steps; here a block's loop walks the live key tiles of its
// query tile itself, from the window's first live tile to the causal limit
// (the Pallas kernel's @pl.when tile skip becomes the loop's bounds).  The
// Pallas wrapper pads and transposes q, k and v to heads-major; both kernels
// here read the (B, S, heads, D) layout through its strides.  The softmax
// runs in base 2 (scores pre-scaled by log2(e)), the same function with a
// cheaper exponential.
//
// bf16: warp-specialised, TMA-fed, on wgmma (`flash_attention_hopper`).
//
//   * Block: three warpgroups, 384 threads.  Warpgroup 0 loads (one thread
//     of warp c serves consumer c) and gives its registers away
//     (setmaxnreg 24); warpgroups 1 and 2 compute (setmaxnreg 240), each on
//     its own 64-row query tile.  Per consumer, shared memory holds its Q
//     tile and a ring of kStages {K, V} stages of 64 keys, fed by TMA and
//     guarded by full/empty mbarriers: the loads of tile j + 1 overlap the
//     products of tile j, and the two consumers of an SM overlap each
//     other's softmax with their tensor-core work.
//   * Loads: TMA with 4-d tensor maps over (D, S, heads, B), built on the
//     host for every call from the tensors' own strides (no copies), with
//     the 128-byte swizzle; a row is read as boxes of 64 columns (128
//     bytes).  Columns past D and rows past S are zero-filled by TMA: a
//     D 112 row is two boxes whose last 16 columns are zeros (in QK^T's
//     reduction, where they add nothing), D 8 to 64 is one box.
//   * S = Q K^T by wgmma m64n64k16 (A = Q and B = K from shared memory,
//     both K-major, ceil(D / 16) k-steps); the online softmax runs on the
//     f32 accumulator's layout (rows g and g + 8 of each warp's 16, two
//     adjacent columns of each 8-wide tile), so a row's max and sum take
//     two shuffles.
//   * O += P V by wgmma m64nDk16 with A = P, rounded to bf16, in registers
//     (the accumulator layout of two 8-key tiles is the A layout of one
//     16-key step) and B = the V tile from shared memory read MN-major
//     through the descriptor (V is stored key-major, D contiguous).  l is
//     summed from the unrounded f32 P.  n = D, so no padding column is
//     computed or stored.
//   * Within a consumer the two products and the softmax run in turn;
//     the SM's two consumers overlap each other freely.  Four variants
//     measured slower on the card, against SDPA in the same run, and are
//     not used: issuing tile j's scores with tile j - 1's P V so the
//     softmax runs under the product; one K/V ring shared by two
//     consumers on adjacent q tiles of one head (half the L2 traffic);
//     the two consumers taking turns on the tensor cores by named
//     barriers; and both, FA3's schedule.  It runs at about a third of
//     the bf16 peak; what holds it there is not measured (PERF.md).
//   * Masks only where needed: a key tile that is live for all 64 rows
//     (interior of the causal triangle, inside the window, below Sk) skips
//     the mask; the diagonal, window-edge and ragged tiles evaluate it.
//   * Schedule: work items are (b, h, 64-row q tile), ordered longest
//     causal tile first (item i takes q tile n - 1 - i / (B H)); block x
//     runs items 2x and 2x + 1, one a consumer, which walk the same number
//     of key tiles (adjacent heads of one q tile).  The grid has
//     ceil(B H n / 2) blocks, one resident a SM (registers), and the
//     hardware hands the next block to the SM that frees first, a greedy
//     longest-first schedule.  64-row items rather than 128-row tiles
//     because the grid is small: at qwen's 1024 tokens 128-row tiles give
//     128 items for 132 SMs and a chain of 8 key tiles of 128 against a
//     mean of 4.4; 64-row items give 256 items in 128 blocks, a chain of
//     16 key tiles of 64 against a mean of 8.2 a consumer, and at 2048
//     tokens 512 items with a chain within a few tiles of the mean
//     (`schedule_chain` in the wrapper).  A split of the long rows' key
//     range with a merge pass would halve the 1024-token chain; it is not
//     done.
//   * GQA: the G heads of a KV head each load its K/V tiles (from L2: one
//     KV head's K and V are 1 MB at 2048 tokens); TMA multicast across a
//     cluster is not used.
//   * Registers and shared memory (ptxas, sm_90a, CUDA 12.9): 168
//     registers a thread (65,536 / 384, which setmaxnreg splits 24 / 240),
//     no spills; 164,944 bytes of dynamic shared memory at D 112 and 128,
//     83,024 at D <= 64; one block a SM.
//
// f32 must meet the reference's 1e-4, which TF32 cannot: it runs on the
// CUDA cores (`flash_attention_f32_kernel`): four warps of 16 query rows a
// block, grid (B H, n_q_tiles), cp.async double-buffered K/V tiles, scores
// as dot products from shared memory in the same accumulator layout, P V
// with each P value broadcast across its row's four lanes by a shuffle
// (118-198 registers by D, no spills).
//
// Both kernels launch on the stream they are given and allocate nothing.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;               // query rows a tile (both kernels)
constexpr int kBK = 64;               // keys a tile
constexpr int kNT = kBK / 8;          // 8-wide key tiles of the scores
constexpr float kNegInf = -1e30f;     // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Masks score s (row qp, key kp) and scales it to base 2.
__device__ __forceinline__ float masked(float s, int kp, int qp, int Sk,
                                        int causal, int window,
                                        float scale2) {
  bool ok = kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok ? s * scale2 : kNegInf;
}

// One online-softmax step on a tile of scores in the m16n8 accumulator
// layout (this thread's rows 0 and 1, columns 2t, 2t + 1 of each 8-wide
// tile): s becomes P, (m, l) are updated, and the factors that rescale
// the output accumulator are returned in c.
template <int NT>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float* m,
                                             float* l, float* c) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
    mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
  }
  // a row's scores are spread over the four lanes of its group
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    s[n][0] = exp2f(s[n][0] - mn0);
    s[n][1] = exp2f(s[n][1] - mn0);
    s[n][2] = exp2f(s[n][2] - mn1);
    s[n][3] = exp2f(s[n][3] - mn1);
    sum0 += s[n][0] + s[n][1];
    sum1 += s[n][2] + s[n][3];
  }
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, o_);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, o_);
  }
  c[0] = exp2f(m[0] - mn0);
  c[1] = exp2f(m[1] - mn1);
  l[0] = l[0] * c[0] + sum0;
  l[1] = l[1] * c[1] + sum1;
  m[0] = mn0;
  m[1] = mn1;
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// Writes this thread's two rows (r0 and r0 + 8 of the output, rows past
// Sq skipped) of a 16-row accumulator o[D / 8][4], divided by max(l,
// 1e-30); `ob` points at (b, row 0, h, column 2t) of out (B, Sq, H, D).
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* ob, int64_t row_stride,
                                           int r0, int Sq,
                                           const float (&o)[D / 8][4],
                                           const float* l) {
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
  if (r0 < Sq) {
    T* row = ob + (int64_t)r0 * row_stride;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2(row + dn * 8, o[dn][0] * inv0, o[dn][1] * inv0);
  }
  if (r0 + 8 < Sq) {
    T* row = ob + (int64_t)(r0 + 8) * row_stride;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2(row + dn * 8, o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

// The live key range of a q tile as key tiles [lo, hi) (`key_tiles` in the
// wrapper).
__device__ __forceinline__ void key_range(int q0, int q_rows, int Sk,
                                          int causal, int window,
                                          int q_offset, int* kt_lo,
                                          int* kt_hi) {
  int k_hi = Sk;
  if (causal) k_hi = min(k_hi, q_offset + q0 + q_rows);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  *kt_lo = k_lo / kBK;
  *kt_hi = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;                          // (B, Sq, H, D), contiguous
  int B, Sq, Sk, H, KH;
  int64_t qs_b, qs_s, qs_h;           // element strides of q, k, v
  int64_t ks_b, ks_s, ks_h;
  int64_t vs_b, vs_s, vs_h;
  int causal, window, q_offset;       // window <= 0: none
  int n_q_tiles;
  float scale;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores, four warps of 16 query rows
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 4;               // row padding: conflict-free reads
static_assert(kBQ == 16 * kWarps, "a warp owns 16 query rows");
static_assert(kBQ == kBK, "load_tile copies kBQ rows for every tile");

// 16 bytes global -> shared without a register round trip; `bytes` 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Starts copying kBQ rows of D floats (row r at src + r * stride) into
// shared memory rows of D + kPad floats, 16 bytes a thread; rows past
// `valid` (>= 1) are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(const float* src, int64_t stride,
                                          int valid, float* dst) {
  constexpr int PER_ROW = D / 4;
  for (int i = threadIdx.x; i < kBQ * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * (D + kPad) + c, src + (ok ? r : 0) * stride + c,
               ok ? 16 : 0);
  }
}

// S (this warp's 16 rows x kBK keys) = Q K^T, in accumulator layout.
template <int D>
__device__ __forceinline__ void scores_f32(const float* qw, const float* ks,
                                           float (&s)[kNT][4], int g,
                                           int t) {
  constexpr int P = D + kPad;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  }
  const float* q0 = qw + g * P;
  const float* q1 = qw + (g + 8) * P;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float a0 = q0[d], a1 = q1[d];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float kv = ks[(n * 8 + 2 * t + j) * P + d];
        s[n][j] = fmaf(a0, kv, s[n][j]);
        s[n][2 + j] = fmaf(a1, kv, s[n][2 + j]);
      }
    }
  }
}

// o (this warp's 16 rows x D, accumulator layout) += P V.
template <int D>
__device__ __forceinline__ void accumulate_pv_f32(const float (&p)[kNT][4],
                                                  const float* vs,
                                                  float (&o)[D / 8][4],
                                                  int lane, int t) {
  constexpr int P = D + kPad;
  const int base = lane & ~3;
#pragma unroll
  for (int j = 0; j < kBK; ++j) {
    // key j's P values live in lane (g, (j % 8) / 2) of each row group
    const int src = base | ((j % 8) / 2);
    const float p0 = __shfl_sync(0xffffffffu, p[j / 8][j % 2], src);
    const float p1 = __shfl_sync(0xffffffffu, p[j / 8][2 + j % 2], src);
    const float* v = vs + j * P + 2 * t;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float x = v[dn * 8 + i];
        o[dn][i] = fmaf(p0, x, o[dn][i]);
        o[dn][2 + i] = fmaf(p1, x, o[dn][2 + i]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(Params p) {
  constexpr int P = D + kPad;
  constexpr int TILE = kBK * P;                 // floats of one K/V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [kBQ][P]
  float* kv = qs + kBQ * P;                     // 2 stages x {K, V} tiles

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int qt = p.n_q_tiles - 1 - (int)blockIdx.y;   // longest first
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, p.Sq - q0);
  int kt_lo, kt_hi;
  key_range(q0, q_rows, p.Sk, p.causal, p.window, p.q_offset, &kt_lo,
            &kt_hi);

  const float* qb = static_cast<const float*>(p.q) + b * p.qs_b
                    + h * p.qs_h;
  const float* kb = static_cast<const float*>(p.k) + b * p.ks_b
                    + kh * p.ks_h;
  const float* vb = static_cast<const float*>(p.v) + b * p.vs_b
                    + kh * p.vs_h;
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    float* ks = kv + stage * 2 * TILE;
    load_tile<D>(kb + (int64_t)k0 * p.ks_s, p.ks_s, p.Sk - k0, ks);
    load_tile<D>(vb + (int64_t)k0 * p.vs_s, p.vs_s, p.Sk - k0, ks + TILE);
  };

  // two groups in flight: Q, then the first K/V tile (possibly empty)
  load_tile<D>(qb + (int64_t)q0 * p.qs_s, p.qs_s, q_rows, qs);
  cp_async_commit();
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float* qw = qs + warp * 16 * P;
  // absolute positions of this thread's two rows
  const int qp0 = p.q_offset + q0 + warp * 16 + g;
  const int qp1 = qp0 + 8;
  const float scale2 = p.scale * kLog2e;        // base-2 softmax

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dn][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    // prefetch the next tile into the other stage, which every warp left
    // at the end of the previous iteration
    if (kt + 1 < kt_hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                         // this tile has landed
    __syncthreads();
    const float* ks = kv + stage * 2 * TILE;
    const int k0 = kt * kBK;

    float s[kNT][4];
    scores_f32<D>(qw, ks, s, g, t);
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[n][i] = masked(s[n][i], k0 + n * 8 + 2 * t + (i & 1),
                         i < 2 ? qp0 : qp1, p.Sk, p.causal, p.window,
                         scale2);
    }
    float c[2];
    softmax_step<kNT>(s, m, l, c);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= c[0];
      o[dn][1] *= c[0];
      o[dn][2] *= c[1];
      o[dn][3] *= c[1];
    }
    accumulate_pv_f32<D>(s, ks + TILE, o, lane, t);
    __syncthreads();                  // this stage is consumed
  }

  float* ob = static_cast<float*>(p.out) +
              (((int64_t)b * p.Sq) * p.H + h) * D + 2 * t;
  store_rows<float, D>(ob, (int64_t)p.H * D, q0 + warp * 16 + g, p.Sq, o,
                       l);
}

template <int D>
int launch_f32(const Params& p, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(kBQ + 4 * kBK) * (D + kPad);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(flash_attention_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(p.B * p.H, p.n_q_tiles);
  flash_attention_f32_kernel<D><<<grid, kThreads, smem,
                                  reinterpret_cast<cudaStream_t>(stream)>>>(
      p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed, warp-specialised, on wgmma
// ---------------------------------------------------------------------------

constexpr int kConsumers = 2;         // consumer warpgroups a block
constexpr int kStages = 2;            // {K, V} stages a consumer's ring holds
constexpr int kHopThreads = 128 * (1 + kConsumers);
constexpr int kBoxCols = 64;          // bf16 columns of a TMA box: 128 bytes
constexpr int kBoxBytes = kBK * 128;  // one box of 64 rows
constexpr int kErrNoEncode = 999;     // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 1000;      // + the CUresult of a failed encode
static_assert(kBQ == kBK, "Q, K and V tiles share one box shape");

// Shared memory of a block: per consumer its Q tile, then kStages {K, V}
// tile pairs, each tile ceil(D / 64) boxes; then the mbarriers.
template <int D> struct Hop {
  static constexpr int NB = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int TILE = NB * kBoxBytes;
  static constexpr int KSTEPS = (D + 15) / 16;        // QK^T's k-steps
  static constexpr int CONSUMER = TILE * (1 + 2 * kStages);
  static constexpr int BARRIERS = 8 * kConsumers * (1 + 2 * kStages);
  // + 1024: the tiles start on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM = 1024 + kConsumers * CONSUMER + BARRIERS;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
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

// Waits until the barrier's phase of parity `parity` has completed.  A
// wait that lasts ~2^35 cycles (over 10 s) traps, so a lost arrival fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_test(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_test(bar, parity)) {
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// One TMA box (64 columns x 64 rows of one head of one batch row) global
// -> shared, completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
         "r"(head), "r"(b), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and the stride byte offsets (all >> 4).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

// k-step kk (columns 16 kk ... 16 kk + 15) of a Q or K tile, K-major: the
// box of the columns, 32 bytes a step inside its 128-byte rows; 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024);
}

// k-step kk (keys 16 kk ... 16 kk + 15) of a V tile read MN-major: 16 key
// rows of 128 bytes a step, 8-key groups 1024 bytes apart, the next 64
// columns a box (8192 bytes) further.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, kBoxBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup's wgmmas are
// in flight (they complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps registers in place across a wgmma's wait: their values are read
// (or written) by the asynchronous product until it completes.
template <int N>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// d (64 x 64, f32, accumulator layout) = A B (+ d if `accumulate`): A
// and B from shared memory by descriptor, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 8) += A B: A (64 x 16 bf16) in registers, B from shared
// memory by descriptor, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3 "
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16) += A B: A (64 x 16 bf16) in registers, B from shared
// memory by descriptor, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32) += A B: A (64 x 16 bf16) in registers, B from shared
// memory by descriptor, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64) += A B: A (64 x 16 bf16) in registers, B from shared
// memory by descriptor, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 112) += A B: A (64 x 16 bf16) in registers, B from shared
// memory by descriptor, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n112(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55 "
      "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A B: A (64 x 16 bf16) in registers, B from shared
// memory by descriptor, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// o (64 x D) += P V for one 16-key step: n = D.
template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 8) wgmma_rs_n8(o, a, db);
  else if constexpr (D == 16) wgmma_rs_n16(o, a, db);
  else if constexpr (D == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (D == 112) wgmma_rs_n112(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

// Work item i: q tile n_q_tiles - 1 - i / (B H) of head row i % (B H),
// longest causal tile first (`work_items` in the wrapper).
struct Item {
  int b, h, kh, q0, q_rows, kt_lo, kt_hi;
  __device__ __forceinline__ Item(const Params& p, int i) {
    const int bh = i % (p.B * p.H);
    b = bh / p.H;
    h = bh % p.H;
    kh = h / (p.H / p.KH);
    q0 = (p.n_q_tiles - 1 - i / (p.B * p.H)) * kBQ;
    q_rows = min(kBQ, p.Sq - q0);
    key_range(q0, q_rows, p.Sk, p.causal, p.window, p.q_offset, &kt_lo,
              &kt_hi);
  }
};

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_attention_hopper_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const Params p) {
  using S = Hop<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + kConsumers * S::CONSUMER;
  // consumer c's barriers: Q, kStages full, kStages empty
  auto q_bar = [&](int c) { return bars + 8 * c * (1 + 2 * kStages); };
  auto full_bar = [&](int c, int s) { return q_bar(c) + 8 * (1 + s); };
  auto empty_bar = [&](int c, int s) {
    return q_bar(c) + 8 * (1 + kStages + s);
  };
  // consumer c's tiles: Q, then stage s's K and V
  auto q_tile = [&](int c) { return base + c * S::CONSUMER; };
  auto k_tile = [&](int c, int s) {
    return q_tile(c) + S::TILE * (1 + 2 * s);
  };

  if (threadIdx.x == 0) {
    for (int c = 0; c < kConsumers; ++c) {
      mbar_init(q_bar(c), 1);
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full_bar(c, s), 1);        // the producer's expect_tx
        mbar_init(empty_bar(c, s), 128);     // every consumer thread
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: lane 0 of warp c feeds consumer c ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int c = threadIdx.x / 32;
    const int i = blockIdx.x * kConsumers + c;
    if (c < kConsumers && threadIdx.x % 32 == 0
        && i < p.B * p.H * p.n_q_tiles) {
      const Item it(p, i);
      mbar_expect_tx(q_bar(c), S::TILE);
#pragma unroll
      for (int nb = 0; nb < S::NB; ++nb)
        tma_load(q_tile(c) + nb * kBoxBytes, &tq, q_bar(c), nb * kBoxCols,
                 it.q0, it.h, it.b);
      for (int j = 0; j < it.kt_hi - it.kt_lo; ++j) {
        const int s = j % kStages;
        // the first round finds every stage empty
        mbar_wait(empty_bar(c, s), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full_bar(c, s), 2 * S::TILE);
        const int k0 = (it.kt_lo + j) * kBK;
        const uint32_t kt = k_tile(c, s);
#pragma unroll
        for (int nb = 0; nb < S::NB; ++nb) {
          tma_load(kt + nb * kBoxBytes, &tk, full_bar(c, s), nb * kBoxCols,
                   k0, it.kh, it.b);
          tma_load(kt + S::TILE + nb * kBoxBytes, &tv, full_bar(c, s),
                   nb * kBoxCols, k0, it.kh, it.b);
        }
      }
    }
  } else {
    // ---- consumer c: 64 query rows, 16 a warp -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int i = blockIdx.x * kConsumers + c;
    if (i >= p.B * p.H * p.n_q_tiles) return;
    const Item it(p, i);
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int qpos0 = p.q_offset + it.q0;          // the tile's first row
    const int qp0 = qpos0 + warp * 16 + g;         // this thread's rows
    const int qp1 = qp0 + 8;
    const float scale2 = p.scale * kLog2e;        // base-2 softmax

    float o[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(q_bar(c), 0);

    for (int j = 0; j < it.kt_hi - it.kt_lo; ++j) {
      const int s = j % kStages;
      mbar_wait(full_bar(c, s), (j / kStages) & 1);
      const uint32_t kt = k_tile(c, s);

      // S = Q K^T
      float sc[kNT][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < S::KSTEPS; ++kk)
        wgmma_ss_n64(&sc[0][0], kmajor_desc(q_tile(c), kk),
                     kmajor_desc(kt, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin<4 * kNT>(&sc[0][0]);

      // masks only on tiles that are not live for all 64 rows
      const int k0 = (it.kt_lo + j) * kBK;
      const bool interior =
          k0 + kBK <= p.Sk && (!p.causal || k0 + kBK - 1 <= qpos0)
          && (p.window <= 0 || k0 > qpos0 + kBQ - 1 - p.window);
      if (interior) {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n][e] *= scale2;
        }
      } else {
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[n][e] = masked(sc[n][e], k0 + n * 8 + 2 * t + (e & 1),
                              e < 2 ? qp0 : qp1, p.Sk, p.causal, p.window,
                              scale2);
        }
      }
      float cf[2];
      softmax_step<kNT>(sc, m, l, cf);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        o[dn][0] *= cf[0];
        o[dn][1] *= cf[0];
        o[dn][2] *= cf[1];
        o[dn][3] *= cf[1];
      }

      // O += P V: P to bf16 A fragments, one set a 16-key step
      uint32_t a[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        a[kk][0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
        a[kk][1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
        a[kk][2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        a[kk][3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<D>(&o[0][0], a[kk], mnmajor_desc(kt + S::TILE, kk));
      wgmma_commit();
      wgmma_wait<0>();
      pin<D / 2>(&o[0][0]);
      pin<kBK / 4>(&a[0][0]);
      mbar_arrive(empty_bar(c, s));            // this stage is consumed
    }

    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.out) +
                        (((int64_t)it.b * p.Sq) * p.H + it.h) * D + 2 * t;
    store_rows<__nv_bfloat16, D>(ob, (int64_t)p.H * D,
                                 it.q0 + warp * 16 + g, p.Sq, o, l);
  }
}

// cuTensorMapEncodeTiled, a driver function, found through the runtime's
// cudaGetDriverEntryPoint: the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Looked up once; a function-local static is initialised once even when
// several host threads launch (a standby pipeline warms up on its own).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a bf16 (B, S, heads, D) tensor with element strides
// (sb, ss, sh) and a contiguous last dimension, as dimensions (D, S,
// heads, B): boxes of 64 columns x 64 rows of one head of one batch row,
// 128-byte swizzle, zeros out of bounds.  A dimension of extent 1 takes
// the widest stride (its own may be anything).
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
             int D, int64_t sb, int64_t ss, int64_t sh) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const int64_t st[3] = {ss, sh, sb};
  const int ext[3] = {S, heads, B};
  int64_t widest = 8;                          // 16 bytes
  for (int i = 0; i < 3; ++i) widest = st[i] > widest ? st[i] : widest;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads,
                        (cuuint64_t)B};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)((ext[i] == 1 ? widest : st[i]) * 2);
  cuuint32_t box[4] = {kBoxCols, kBQ, 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

template <int D>
int launch_hopper(const Params& p, void* stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, p.B, p.Sq, p.H, D, p.qs_b, p.qs_s, p.qs_h);
  if (err == 0)
    err = make_map(&tk, p.k, p.B, p.Sk, p.KH, D, p.ks_b, p.ks_s, p.ks_h);
  if (err == 0)
    err = make_map(&tv, p.v, p.B, p.Sk, p.KH, D, p.vs_b, p.vs_s, p.vs_h);
  if (err != 0) return err;
  // set once per D, by whichever host thread comes first
  static const cudaError_t sized = cudaFuncSetAttribute(
      flash_attention_hopper_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Hop<D>::SMEM);
  if (sized != cudaSuccess) return (int)sized;
  const int blocks =
      (p.B * p.H * p.n_q_tiles + kConsumers - 1) / kConsumers;
  flash_attention_hopper_kernel<D><<<blocks, kHopThreads, Hop<D>::SMEM,
                                     reinterpret_cast<cudaStream_t>(
                                         stream)>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <bool BF16>
int dispatch(const Params& p, int D, void* stream) {
  switch (D) {
    case 8: return BF16 ? launch_hopper<8>(p, stream)
                        : launch_f32<8>(p, stream);
    case 16: return BF16 ? launch_hopper<16>(p, stream)
                         : launch_f32<16>(p, stream);
    case 32: return BF16 ? launch_hopper<32>(p, stream)
                         : launch_f32<32>(p, stream);
    case 64: return BF16 ? launch_hopper<64>(p, stream)
                         : launch_f32<64>(p, stream);
    case 112: return BF16 ? launch_hopper<112>(p, stream)    // zamba2
                          : launch_f32<112>(p, stream);
    case 128: return BF16 ? launch_hopper<128>(p, stream)
                          : launch_f32<128>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int KH,
                   const int64_t* strides, int causal, int window,
                   int q_offset, int n_q_tiles, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH;
  p.qs_b = strides[0]; p.qs_s = strides[1]; p.qs_h = strides[2];
  p.ks_b = strides[3]; p.ks_s = strides[4]; p.ks_h = strides[5];
  p.vs_b = strides[6]; p.vs_s = strides[7]; p.vs_h = strides[8];
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.n_q_tiles = n_q_tiles;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or for bf16 kErrNoEncode (999) /
// kErrEncode + CUresult (1000 + r) when a tensor map could not be built.
// Pointers are device pointers, `strides` a host array of nine element
// strides (batch, sequence, head of q, k and v; the last dimension is
// contiguous), `n_q_tiles` ceil(Sq / 64) (`grid_plan` in the wrapper),
// `stream` a cudaStream_t.  Shapes, strides and alignment were checked by
// the Python wrapper.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int KH,
                        int D, const int64_t* strides, int causal,
                        int window, int q_offset, int n_q_tiles, float scale,
                        void* stream) {
  return dispatch<false>(make_params(q, k, v, out, B, Sq, Sk, H, KH,
                                     strides, causal, window, q_offset,
                                     n_q_tiles, scale),
                         D, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int KH,
                         int D, const int64_t* strides, int causal,
                         int window, int q_offset, int n_q_tiles,
                         float scale, void* stream) {
  return dispatch<true>(make_params(q, k, v, out, B, Sq, Sk, H, KH, strides,
                                    causal, window, q_offset, n_q_tiles,
                                    scale),
                        D, stream);
}

}  // extern "C"
