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
// What bounds it on this card: at the served shapes (H 16, KH 2, D 128,
// Sq = Sk = 1024 or 2048, causal) it does 4 * D flops for each live
// (query, key) pair against 2 bytes per element moved once, hundreds of
// flops per byte: it is bound by operations (`bound_flops` in the wrapper).
//
// Where it differs from the Pallas kernel, and why:
//
//   * No carried grid state.  The Pallas grid walks the kv blocks in order
//     on one core and keeps (m, l, acc) in VMEM scratch across grid steps.
//     Here one block owns a tile of kBQ = 64 query rows of one (b, h) and
//     loops over the kv tiles itself, from the window's first live tile to
//     the causal limit: the Pallas kernel's @pl.when tile skip becomes the
//     loop's bounds.  The grid is (B * H, n_q_tiles), and the q tile is
//     counted from the end, so the longest causal tiles are dispatched
//     first.
//   * Strides, not copies.  The Pallas wrapper pads and transposes q, k and
//     v to heads-major; this kernel reads the (B, S, heads, D) layout through
//     the strides it is given, zero-fills the ragged tile edges in shared
//     memory, masks kpos >= Sk and stores no row past Sq.
//   * Overlapped loads.  The Pallas pipeline prefetches the next kv block
//     while the core works on this one; here cp.async copies kv tile j + 1
//     into a second shared-memory stage while the block computes on tile j.
//   * Four warps, 16 query rows each.  A thread holds its rows' scores and
//     output accumulator in registers in the layout of the tensor cores'
//     m16n8 accumulator (rows g and g + 8, columns 2t and 2t + 1 of each
//     8-wide tile, g = lane / 4, t = lane % 4), so the softmax bookkeeping
//     is one code path for both types:
//       - bf16 runs both products on the tensor cores with mma.sync
//         m16n8k16 (bf16 in, f32 accumulate).  Q's fragments are loaded
//         into registers once; K's and V's come from shared memory by
//         ldmatrix (.trans for V, stored row-major by key).  P is rounded
//         to bf16 for the P @ V product, and l is summed from the
//         unrounded f32 P.
//       - f32 must meet the reference's 1e-4, so it is computed in f32 on
//         the CUDA cores (not TF32): scores as dot products from shared
//         memory, P @ V with each P value broadcast across its row's four
//         lanes by a warp shuffle.
//     The softmax runs in base 2 (scores pre-scaled by log2(e)), the same
//     function with a cheaper exponential.
//
// A simple kernel that is right: TMA and wgmma are left for later work.
// The kernel launches on the stream it is given and allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;      // query rows a block
constexpr int kBK = 64;               // keys a tile
constexpr int kNT = kBK / 8;          // 8-wide key tiles of the scores
constexpr float kNegInf = -1e30f;     // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBQ == kBK, "load_tile copies kBQ rows for every tile");

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int VN = 4;        // elements in 16 bytes
  static constexpr int PAD = 4;       // row padding: conflict-free reads
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int VN = 8;
  static constexpr int PAD = 8;
};

// Columns a shared-memory row holds: the tensor cores' k step is 16, so a
// bf16 row of D = 8 is zero-padded to 16.
template <typename T, int D> struct Shape {
  static constexpr int COLS =
      (sizeof(T) == 2 && D < 16) ? 16 : D;
  static constexpr int PITCH = COLS + Traits<T>::PAD;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a @ b for one m16n8k16 tile (bf16 inputs, f32 accumulator).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8.  .trans delivers each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// Two matrices: lanes 0-15 give the addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row))
      : "memory");
}

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

// Starts copying kBQ rows of D elements (row r at src + r * stride) into
// shared memory rows of Shape::PITCH elements, 16 bytes a thread; rows past
// `valid` (>= 1) are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* src, int64_t stride,
                                          int valid, T* dst) {
  constexpr int VN = Traits<T>::VN;
  constexpr int PER_ROW = D / VN;
  for (int i = threadIdx.x; i < kBQ * PER_ROW; i += kThreads) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VN;
    const bool ok = r < valid;
    cp_async16(dst + r * Shape<T, D>::PITCH + c,
               src + (ok ? r : 0) * stride + c, ok ? 16 : 0);
  }
}

// This warp's Q rows as mma A fragments, one set per 16-wide k step (bf16);
// f32 reads Q from shared memory in `scores`.
template <typename T, int D> struct QFrags {
  __device__ __forceinline__ void load(const T*, int) {}
};
template <int D> struct QFrags<__nv_bfloat16, D> {
  static constexpr int KSTEPS = Shape<__nv_bfloat16, D>::COLS / 16;
  uint32_t a[KSTEPS][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* qw, int lane) {
    constexpr int P = Shape<__nv_bfloat16, D>::PITCH;
    const int m = lane >> 3;
    // matrices: rows 0-7 / 8-15 x columns 0-7 / 8-15 of the k step
    const __nv_bfloat16* row = qw + ((m & 1) * 8 + (lane & 7)) * P
                               + (m >> 1) * 8;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(a[kk], row + kk * 16);
  }
};

// S (this warp's 16 rows x kBK keys) = Q K^T, in accumulator layout.
template <int D>
__device__ __forceinline__ void scores(const QFrags<__nv_bfloat16, D>& q,
                                       const __nv_bfloat16*,
                                       const __nv_bfloat16* ks,
                                       float (&s)[kNT][4], int lane, int,
                                       int) {
  constexpr int P = Shape<__nv_bfloat16, D>::PITCH;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
  }
  const int m = lane >> 3;
  // matrices: keys of n-tiles n / n + 1 x columns 0-7 / 8-15 of the k step
  const __nv_bfloat16* row = ks + ((m >> 1) * 8 + (lane & 7)) * P
                             + (m & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < QFrags<__nv_bfloat16, D>::KSTEPS; ++kk) {
#pragma unroll
    for (int n = 0; n < kNT; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, row + n * 8 * P + kk * 16);
      mma_bf16(s[n], q.a[kk], b[0], b[1]);
      mma_bf16(s[n + 1], q.a[kk], b[2], b[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void scores(const QFrags<float, D>&,
                                       const float* qw, const float* ks,
                                       float (&s)[kNT][4], int, int g,
                                       int t) {
  constexpr int P = Shape<float, D>::PITCH;
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
__device__ __forceinline__ void accumulate_pv(const float (&p)[kNT][4],
                                              const __nv_bfloat16* vs,
                                              float (&o)[D / 8][4], int lane,
                                              int) {
  constexpr int P = Shape<__nv_bfloat16, D>::PITCH;
  const int m = lane >> 3;
  // matrices (transposed): keys 0-7 / 8-15 of the k step x the d columns
  // of n-tiles dn / dn + 1
  const __nv_bfloat16* row = vs + ((m & 1) * 8 + (lane & 7)) * P
                             + (m >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    // the accumulator layout of two 8-key tiles is the A layout of one
    // 16-key step
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* r = row + kk * 16 * P;
#pragma unroll
    for (int dn = 0; dn + 1 < D / 8; dn += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, r + dn * 8);
      mma_bf16(o[dn], a, b[0], b[1]);
      mma_bf16(o[dn + 1], a, b[2], b[3]);
    }
    if constexpr ((D / 8) % 2 == 1) {          // D = 8: one n-tile
      uint32_t b[2];
      ldmatrix_x2_trans(b, r + (D / 8 - 1) * 8);
      mma_bf16(o[D / 8 - 1], a, b[0], b[1]);
    }
  }
}

template <int D>
__device__ __forceinline__ void accumulate_pv(const float (&p)[kNT][4],
                                              const float* vs,
                                              float (&o)[D / 8][4], int lane,
                                              int t) {
  constexpr int P = Shape<float, D>::PITCH;
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

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
  constexpr int P = Shape<T, D>::PITCH;
  constexpr int COLS = Shape<T, D>::COLS;
  constexpr int TILE = kBK * P;                 // elements of one K/V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);       // [kBQ][P]
  T* kv = qs + kBQ * P;                         // 2 stages x {K, V} tiles

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int kh = h / (p.H / p.KH);
  const int qt = p.n_q_tiles - 1 - (int)blockIdx.y;   // longest first
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, p.Sq - q0);

  // live key range of this q tile: [k_lo, k_hi)
  const int qpos_first = p.q_offset + q0;
  const int qpos_last = p.q_offset + q0 + q_rows - 1;
  int k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, qpos_last + 1);
  int k_lo = 0;
  if (p.window > 0) k_lo = max(0, qpos_first - p.window + 1);
  const int kt_lo = k_lo / kBK;
  const int kt_hi = k_hi > 0 ? (k_hi + kBK - 1) / kBK : 0;

  const T* qb = static_cast<const T*>(p.q) + b * p.qs_b + h * p.qs_h;
  const T* kb = static_cast<const T*>(p.k) + b * p.ks_b + kh * p.ks_h;
  const T* vb = static_cast<const T*>(p.v) + b * p.vs_b + kh * p.vs_h;
  auto load_kv = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    T* ks = kv + stage * 2 * TILE;
    load_tile<T, D>(kb + (int64_t)k0 * p.ks_s, p.ks_s, p.Sk - k0, ks);
    load_tile<T, D>(vb + (int64_t)k0 * p.vs_s, p.vs_s, p.Sk - k0, ks + TILE);
  };

  if constexpr (COLS > D) {           // zero the k-step padding once
    for (int i = threadIdx.x; i < (kBQ + 4 * kBK) * (COLS - D);
         i += kThreads) {
      const int r = i / (COLS - D);
      const int c = D + i % (COLS - D);
      qs[r * P + c] = T(0.f);         // all tiles' rows are contiguous
    }
  }
  // two groups in flight: Q, then the first K/V tile (possibly empty)
  load_tile<T, D>(qb + (int64_t)q0 * p.qs_s, p.qs_s, q_rows, qs);
  cp_async_commit();
  if (kt_lo < kt_hi) load_kv(kt_lo, 0);
  cp_async_commit();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const T* qw = qs + warp * 16 * P;
  // absolute positions of this thread's two rows
  const int qp0 = p.q_offset + q0 + warp * 16 + g;
  const int qp1 = qp0 + 8;
  const float scale2 = p.scale * kLog2e;        // base-2 softmax

  cp_async_wait<1>();                           // Q has landed
  __syncthreads();
  QFrags<T, D> qf;
  qf.load(qw, lane);

  float o[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[dn][i] = 0.f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    // prefetch the next tile into the other stage, which every warp left
    // at the end of the previous iteration
    if (kt + 1 < kt_hi) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                         // this tile has landed
    __syncthreads();
    const T* ks = kv + stage * 2 * TILE;
    const T* vs = ks + TILE;
    const int k0 = kt * kBK;

    float s[kNT][4];
    scores<D>(qf, qw, ks, s, lane, g, t);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + n * 8 + 2 * t + (i & 1);
        const int qp = i < 2 ? qp0 : qp1;
        bool ok = kp < p.Sk;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window > 0) ok = ok && kp > qp - p.window;
        s[n][i] = ok ? s[n][i] * scale2 : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    // a row's scores are spread over the four lanes of its group
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
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
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= c0;
      o[dn][1] *= c0;
      o[dn][2] *= c1;
      o[dn][3] *= c1;
    }
    accumulate_pv<D>(s, vs, o, lane, t);
    __syncthreads();                  // this stage is consumed
  }

  // out (B, Sq, H, D) contiguous; rows past Sq are not stored
  T* ob = static_cast<T*>(p.out) +
          (((int64_t)b * p.Sq) * p.H + h) * D + 2 * t;
  const int r0 = q0 + warp * 16 + g;
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (r0 < p.Sq) {
    T* row = ob + (int64_t)r0 * p.H * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2(row + dn * 8, o[dn][0] * inv0, o[dn][1] * inv0);
  }
  if (r0 + 8 < p.Sq) {
    T* row = ob + (int64_t)(r0 + 8) * p.H * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2(row + dn * 8, o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

template <typename T, int D>
int launch(const Params& p, void* stream) {
  constexpr int P = Shape<T, D>::PITCH;
  const size_t smem = sizeof(T) * (size_t)(kBQ + 4 * kBK) * P;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(p.B * p.H, p.n_q_tiles);
  flash_attention_kernel<T, D><<<grid, kThreads, smem,
                                 reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int D, void* stream) {
  switch (D) {
    case 8: return launch<T, 8>(p, stream);
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 112: return launch<T, 112>(p, stream);     // zamba2's shared attn
    case 128: return launch<T, 128>(p, stream);
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

// Returns a cudaError_t (0 on success).  Pointers are device pointers,
// `strides` a host array of nine element strides (batch, sequence, head of
// q, k and v; the last dimension is contiguous), `n_q_tiles` the grid's
// second dimension (ceil(Sq / 64), `grid_plan` in the wrapper), `stream` a
// cudaStream_t.  Shapes, strides and alignment were checked by the Python
// wrapper.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int KH,
                        int D, const int64_t* strides, int causal,
                        int window, int q_offset, int n_q_tiles, float scale,
                        void* stream) {
  return dispatch<float>(make_params(q, k, v, out, B, Sq, Sk, H, KH, strides,
                                     causal, window, q_offset, n_q_tiles,
                                     scale),
                         D, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int KH,
                         int D, const int64_t* strides, int causal,
                         int window, int q_offset, int n_q_tiles,
                         float scale, void* stream) {
  return dispatch<__nv_bfloat16>(
      make_params(q, k, v, out, B, Sq, Sk, H, KH, strides, causal, window,
                  q_offset, n_q_tiles, scale),
      D, stream);
}

}  // extern "C"
