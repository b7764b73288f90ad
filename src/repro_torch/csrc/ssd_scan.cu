// Mamba-2 SSD scan for Hopper (sm_90a): chunked matmul form, scalar A per
// head, state in f32.
//
// Replaces the Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py,
// `_ssd_kernel`).  It computes the same function: for every batch row b and
// head h, from the state h0 (P, N), chunk by chunk of L steps with
// a_t = dt_t * A_h and cum = cumsum(a) inside the chunk,
//
//     M[t, s] = (C_t . B_s) * exp(cum_t - cum_s) * dt_s      (s <= t)
//     y_t     = sum_s M[t, s] x_s + exp(cum_t) * (h C_t)
//     h'      = exp(cum_L) h + sum_s x_s (B_s * exp(cum_L - cum_s) * dt_s)
//
// every input cast to f32, y written in x's dtype, the final h in f32.  All
// decay ratios are <= 1 (A < 0, dt >= 0), as in the Pallas kernel.
//
// What bounds it on this card: at the served shapes (H 112, P 64, N 64,
// bf16) a 1024-token prefill must move ~32 MB (x in, y out, B, C, the
// state out) and do ~3.8 GFLOP in the chunked form: it is bound by
// device-memory bytes (`bound_bytes`, `bound_flops` in the wrapper); a
// decode step (S = 1) moves the state in and out, ~3.7 MB.
//
// Three paths; the wrapper picks one (`path` and `plan` in ssd_scan.py)
// and passes it in, so the choice is made in one place:
//
//   * the decode step, S = 1 (`ssd_step_kernel`): pure bandwidth, h <-
//     exp(dt A) h + (dt x) B^T and y = h C.  One warp a row p of one
//     (b, h), a lane two adjacent n (float2, coalesced), y by five
//     shuffles; 8 rows a block, so zamba2's 1.8 MB state streams through
//     448 blocks.
//   * chunked, S > 1 at the one instantiated (P, N), zamba2's 64 x 64:
//     chunk-parallel, three launches over chunks of 64 (one chunk when
//     S <= 64).
//       1. `ssd_chunk_state_kernel`, grid (B H, n_chunks): the chunk's
//          cum, its own state contribution S_c = x^T (B * w), w_s =
//          exp(cum_L - cum_s) dt_s (P x N, f32) and its decay
//          exp(cum_L), into scratch.
//       2. `ssd_state_pass_kernel`, grid (B H, P N / 1024): per element,
//          h_c = exp(cum_L,c-1) h_c-1 + S_c-1 walked over the chunks; each
//          slot of S_c is overwritten with the chunk's starting state, and
//          the final h is written.  Only this pass is sequential, and it
//          is elementwise.
//       3. `ssd_chunk_scan_kernel`, grid (B H, n_chunks): y = (C B^T *
//          exp(cum_t - cum_s) dt_s, s <= t) x + exp(cum_t) C h_start^T.
//     The scratch (n_chunks slots of P x N f32 and one decay a (b, h,
//     chunk)) is allocated by the wrapper.  bf16 inputs run the products
//     (x^T (B w), C B^T, M x, C h^T) on the tensor cores with mma.sync
//     m16n8k16, bf16 in and f32 accumulate, fragments by ldmatrix; the
//     operands that are f32 by nature (B w, M after the decay, h_start)
//     are rounded to bf16 once for the product (no hi/lo split: the 1%
//     limit holds, see PERF.md).  f32 inputs keep f32 products on the
//     CUDA cores, in the same accumulator layout, summed in f64 to meet
//     1e-4 at zamba2's width.  The state in memory stays f32.
//   * sequential, S > 1 at any other width (the general path; no served
//     model takes it): `ssd_scan_kernel`, one block per (b, h) walking
//     the chunks in order with h (P x N f32) in shared memory, the
//     products in f32 on 4 x 4 register tiles.  A ragged chunk walks its
//     rows rounded up to 4.
//
// Where it differs from the Pallas kernel, and why: the Pallas grid walks
// the chunks in order on one core with h in VMEM scratch; Hopper blocks run
// in no order, so the chunks' own work runs in parallel and only the
// state is passed in order (pass 2).  Chunk 64, not 128: it is wgmma's and
// four mma.sync warps' M, and it changes only the order of f32 sums.  B, C
// and x are column slices of one projection and reach the kernels as
// strided views (x's heads and features as reshaped columns); the Pallas
// wrapper's head-major transposes are replaced by strides.  h0 may be null
// (zeros).
//
// dt = 0 freezes the state bit for bit on every path (the masked
// recompute feeds dt = 0 past the live length): a zero step contributes
// exact zeros (w = 0, so B w rounds to 0) and a decay of exp(0) = 1, and a
// chunk's rows past its live length are zero-filled, so a scan padded with
// zero steps to a chunk boundary runs the live chunks' arithmetic
// unchanged.
//
// Registers and shared memory (ptxas, sm_90a, CUDA 12.9; no kernel
// spills): step 32 registers; chunk state 46 (bf16) / 96 (f32) and chunk
// scan 78 / 168 at 64 x 64, with 19,456 / 37,888 and 47,104 / 93,184
// bytes of dynamic shared memory; state pass 60; sequential 79-80 (83,200
// bytes at 64 x 64).  Every kernel launches on the stream it is given and
// allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;                 // chunk length

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

struct Params {
  const float* dt;                     // (B, S, H) f32
  const void* Bc;                      // (B, S, N) of T
  const void* Cc;                      // (B, S, N) of T
  const void* x;                       // (B, S, H, P) of T
  const float* A;                      // (H,)
  const float* h0;                     // (B, H, P, N), contiguous, or null
  void* y;                             // (B, S, H, P) of T, contiguous
  float* h;                            // (B, H, P, N), contiguous
  int B, S, H, P, N;
  int64_t dt_b, dt_s, dt_h;            // element strides
  int64_t b_b, b_s, c_b, c_s;
  int64_t x_b, x_s, x_h;
};

// Floats of dynamic shared memory a block uses (`shared_bytes` in the
// wrapper says the same): B [L][N], C^T [N][L], x [L][P], M^T [L][L],
// h^T [N][P], three f32 vectors of L and the f64 cumsum (the decays take
// differences of sums over up to 64 steps, which f32 would leave ~1e-5
// off in relative terms).
__host__ __device__ inline int smem_floats(int P, int N) {
  return kL * N + N * kL + kL * P + kL * kL + N * P + 5 * kL;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above 48 KB it
// must be asked for).
template <typename K>
cudaError_t shared_limit(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int P = p.P, N = p.N;
  float* bs = smem;                    // [kL][N]   B_s, s-major
  float* ct = bs + kL * N;             // [N][kL]   C_t, n-major
  float* xs = ct + N * kL;             // [kL][P]   x_s
  float* mt = xs + kL * P;             // [kL][kL]  M[t, s] at mt[s][t]
  float* ht = mt + kL * kL;            // [N][P]    the state, n-major
  double* cum = reinterpret_cast<double*>(ht + N * P);   // [kL], f64
  float* alpha = reinterpret_cast<float*>(cum + kL);   // [kL] exp(cum_t)
  float* wt = alpha + kL;              // [kL]      exp(cum_L - cum_s) dt_s
  float* dts = wt + kL;                // [kL]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.H;
  const int hh = blockIdx.x % p.H;
  const float a = p.A[hh];
  const int64_t hbase = ((int64_t)b * p.H + hh) * P * N;

  for (int i = tid; i < P * N; i += kThreads) {
    const int pp = i / N, n = i % N;
    ht[n * P + pp] = p.h0 != nullptr ? p.h0[hbase + i] : 0.f;
  }

  const float* dtb = p.dt + b * p.dt_b + hh * p.dt_h;
  const T* bb = static_cast<const T*>(p.Bc) + b * p.b_b;
  const T* cb = static_cast<const T*>(p.Cc) + b * p.c_b;
  const T* xb = static_cast<const T*>(p.x) + b * p.x_b + hh * p.x_h;
  T* yb = static_cast<T*>(p.y) + ((int64_t)b * p.S * p.H + hh) * P;
  const int64_t y_s = (int64_t)p.H * P;
  const int nP = P / 4;

  for (int c0 = 0; c0 < p.S; c0 += kL) {
    const int Lc = min(kL, p.S - c0);
    const int Lr = (Lc + 3) & ~3;      // rows walked: Lc rounded up to 4
    const int nT = Lr / 4;
    // ---- stage the chunk as f32; rows in [Lc, Lr) are zeros ----------
    for (int i = tid; i < Lr; i += kThreads)
      dts[i] = i < Lc ? dtb[(c0 + i) * p.dt_s] : 0.f;
    for (int i = tid; i < Lr * N; i += kThreads) {
      const int s = i / N, n = i % N;
      const bool ok = s < Lc;
      bs[s * N + n] = ok ? to_f32(bb[(c0 + s) * p.b_s + n]) : 0.f;
      ct[n * kL + s] = ok ? to_f32(cb[(c0 + s) * p.c_s + n]) : 0.f;
    }
    for (int i = tid; i < Lr * P; i += kThreads) {
      const int s = i / P, pp = i % P;
      xs[s * P + pp] = s < Lc ? to_f32(xb[(c0 + s) * p.x_s + pp]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                    // the in-chunk cumsum, in order
      double acc = 0.0;
      for (int i = 0; i < Lr; ++i) {
        acc += (double)(dts[i] * a);
        cum[i] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < Lr; i += kThreads) {
      alpha[i] = expf((float)cum[i]);
      wt[i] = expf((float)(cum[Lc - 1] - cum[i])) * dts[i];
    }
    // ---- M^T[s][t] = (C_t . B_s) exp(cum_t - cum_s) dt_s, s <= t -------
    for (int tile = tid; tile < nT * nT; tile += kThreads) {
      const int s0 = (tile / nT) * 4, t0 = (tile % nT) * 4;
      float acc[4][4] = {};
      if (s0 <= t0 + 3) {
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(ct + n * kL + t0);
          const float cvv[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float bv = bs[(s0 + i) * N + n];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv, cvv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + j;
          mt[s * kL + t] = (s <= t && t < Lc)
                               ? acc[i][j] * expf((float)(cum[t] - cum[s]))
                                     * dts[s]
                               : 0.f;
        }
      }
    }
    __syncthreads();
    // ---- y_t = sum_s M[t, s] x_s + exp(cum_t) (h C_t) ------------------
    for (int tile = tid; tile < nT * nP; tile += kThreads) {
      const int t0 = (tile / nP) * 4, p0 = (tile % nP) * 4;
      float acc[4][4] = {}, inter[4][4] = {};
      const int s_end = min(Lc, t0 + 4);   // M[t, s] = 0 for s > t
      for (int s = 0; s < s_end; ++s) {
        const float4 mv = *reinterpret_cast<const float4*>(mt + s * kL + t0);
        const float4 xv = *reinterpret_cast<const float4*>(xs + s * P + p0);
        const float m4[4] = {mv.x, mv.y, mv.z, mv.w};
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = fmaf(m4[j], x4[k], acc[j][k]);
        }
      }
      for (int n = 0; n < N; ++n) {
        const float4 cv = *reinterpret_cast<const float4*>(ct + n * kL + t0);
        const float4 hv = *reinterpret_cast<const float4*>(ht + n * P + p0);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            inter[j][k] = fmaf(c4[j], h4[k], inter[j][k]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + j;
        if (t < Lc) {
          T* row = yb + (int64_t)(c0 + t) * y_s + p0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            store(row + k, acc[j][k] + alpha[t] * inter[j][k]);
        }
      }
    }
    __syncthreads();                   // every read of this chunk's h done
    // ---- h' = exp(cum_L) h + sum_s x_s (B_s w_s) -----------------------
    const float aL = alpha[Lc - 1];
    for (int tile = tid; tile < (N / 4) * nP; tile += kThreads) {
      const int n0 = (tile / nP) * 4, p0 = (tile % nP) * 4;
      float acc[4][4] = {};
      for (int s = 0; s < Lc; ++s) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + s * P + p0);
        const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
        const float w = wt[s];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bw = bs[s * N + n0 + i] * w;
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(bw, x4[k], acc[i][k]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = ht + (n0 + i) * P + p0;
#pragma unroll
        for (int k = 0; k < 4; ++k) row[k] = aL * row[k] + acc[i][k];
      }
    }
    __syncthreads();                   // the chunk's buffers are free again
  }
  for (int i = tid; i < P * N; i += kThreads) {
    const int pp = i / N, n = i % N;
    p.h[hbase + i] = ht[n * P + pp];
  }
}

// ---------------------------------------------------------------------------
// S = 1: the decode step
// ---------------------------------------------------------------------------

constexpr int kStepRows = 8;          // rows of P a block, one a warp

// h[p, :] <- exp(dt A) h0[p, :] + (dt x_p) B, y_p = h[p, :] . C, for row
// p = blockIdx.y * kStepRows + warp of (b, h) = blockIdx.x.
template <typename T>
__global__ void __launch_bounds__(32 * kStepRows)
ssd_step_kernel(Params p) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pp = blockIdx.y * kStepRows + warp;
  if (pp >= p.P) return;
  const int b = blockIdx.x / p.H;
  const int hh = blockIdx.x % p.H;
  const float dt = p.dt[b * p.dt_b + hh * p.dt_h];
  const float decay = expf(dt * p.A[hh]);
  const T* bb = static_cast<const T*>(p.Bc) + b * p.b_b;
  const T* cb = static_cast<const T*>(p.Cc) + b * p.c_b;
  const float u = dt * to_f32(static_cast<const T*>(p.x)[b * p.x_b
                                                         + hh * p.x_h + pp]);
  const int64_t row = (((int64_t)b * p.H + hh) * p.P + pp) * p.N;
  float acc = 0.f;
  for (int n = 2 * lane; n < p.N; n += 64) {
    float2 h = p.h0 != nullptr
                   ? *reinterpret_cast<const float2*>(p.h0 + row + n)
                   : make_float2(0.f, 0.f);
    h.x = fmaf(decay, h.x, u * to_f32(bb[n]));
    h.y = fmaf(decay, h.y, u * to_f32(bb[n + 1]));
    *reinterpret_cast<float2*>(p.h + row + n) = h;
    acc = fmaf(h.x, to_f32(cb[n]), fmaf(h.y, to_f32(cb[n + 1]), acc));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0)
    store(static_cast<T*>(p.y) + ((int64_t)b * p.H + hh) * p.P + pp, acc);
}

// ---------------------------------------------------------------------------
// S > 64: chunk-parallel
// ---------------------------------------------------------------------------

constexpr int kCThreads = 128;        // four warps, 16 rows each
constexpr int kPassThreads = 256;     // state pass: four floats a thread
constexpr int kPadE = 8;              // row padding (elements)

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// Four 8x8 b16 matrices, each delivered transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// acc (16 rows x NT * 8 columns, in the m16n8 accumulator layout: rows g
// and g + 8, columns 2t and 2t + 1 of each 8-wide tile) += A B over K, with
// A and B in shared memory: A(m, k) at A[m * lda + k], or at A[k * lda +
// m] when AT; B(k, n) at Bm[n * ldb + k], or at Bm[k * ldb + n] when BT.
// bf16 on the tensor cores (fragments by ldmatrix, .trans where the
// stored layout is the other way round).
template <int K, int NT, bool AT, bool BT>
__device__ __forceinline__ void mm(const __nv_bfloat16* A, int lda,
                                   const __nv_bfloat16* Bm, int ldb,
                                   float (&acc)[NT][4], int lane) {
  static_assert(K % 16 == 0 && NT % 2 == 0, "k steps of 16, n tile pairs");
  const int m = lane >> 3, r = lane & 7;
  // A's matrices: rows (m) 0-7 / 8-15 x k 0-7 / 8-15 of the k step
  const __nv_bfloat16* arow = AT ? A + ((m >> 1) * 8 + r) * lda + (m & 1) * 8
                                 : A + ((m & 1) * 8 + r) * lda + (m >> 1) * 8;
  // B's: k 0-7 / 8-15 of the k step x the n tiles n / n + 1
  const __nv_bfloat16* brow = BT ? Bm + ((m & 1) * 8 + r) * ldb + (m >> 1) * 8
                                 : Bm + ((m >> 1) * 8 + r) * ldb + (m & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    if constexpr (AT) ldmatrix_x4_trans(a, arow + kk * 16 * lda);
    else ldmatrix_x4(a, arow + kk * 16);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      if constexpr (BT) ldmatrix_x4_trans(bf, brow + kk * 16 * ldb + n * 8);
      else ldmatrix_x4(bf, brow + n * 8 * ldb + kk * 16);
      mma_bf16(acc[n], a, bf[0], bf[1]);
      mma_bf16(acc[n + 1], a, bf[2], bf[3]);
    }
  }
}

// The same for f32 inputs on the CUDA cores, summed in f64 (each f32
// product is exact there) and rounded once into acc.  An f32 running sum
// over K = 64 terms of |y| up to ~250 (zamba2's width) drifts past the
// absolute 1e-4 that f32 is held to against the plain version.
template <int K, int NT, bool AT, bool BT>
__device__ __forceinline__ void mm(const float* A, int lda, const float* Bm,
                                   int ldb, float (&acc)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  double sum[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] = acc[n][e];
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const double x0 = AT ? A[k * lda + g] : A[g * lda + k];
    const double x1 = AT ? A[k * lda + g + 8] : A[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = n * 8 + 2 * t + j;
        const double bv = BT ? Bm[k * ldb + col] : Bm[col * ldb + k];
        sum[n][j] = fma(x0, bv, sum[n][j]);
        sum[n][2 + j] = fma(x1, bv, sum[n][2 + j]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = (float)sum[n][e];
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T, each value times s (rounded back to T).
__device__ __forceinline__ uint4 scale16(uint4 v, float s, float) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] *= s;
  return v;
}
__device__ __forceinline__ uint4 scale16(uint4 v, float s, __nv_bfloat16) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  return v;
}

// Stages rows [0, Lc) of a chunk's (kL x W) slice of T (row r at src +
// r * stride, W contiguous) into shared rows `pitch` apart, each scaled by
// row_scale[r] when given; rows past Lc become zeros.  16 bytes a thread
// where src and stride are 16-byte aligned (the model's column views
// are), else one element.
template <typename T, int W>
__device__ __forceinline__ void stage(T* dst, int pitch, const T* src,
                                      int64_t stride, int Lc,
                                      const float* row_scale) {
  constexpr int VN = 16 / sizeof(T);
  static_assert(W % VN == 0, "rows of whole 16-byte vectors");
  const bool vec = ((reinterpret_cast<uintptr_t>(src)
                     | (uintptr_t)(stride * (int64_t)sizeof(T))) & 15) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < kL * (W / VN); i += kCThreads) {
      const int r = i / (W / VN), c = (i % (W / VN)) * VN;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < Lc) {
        v = *reinterpret_cast<const uint4*>(src + r * stride + c);
        if (row_scale != nullptr) v = scale16(v, row_scale[r], T());
      }
      *reinterpret_cast<uint4*>(dst + r * pitch + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < kL * W; i += kCThreads) {
      const int r = i / W, c = i % W;
      const float s = row_scale != nullptr && r < Lc ? row_scale[r] : 1.f;
      dst[r * pitch + c] =
          from_f32<T>(r < Lc ? to_f32(src[r * stride + c]) * s : 0.f);
    }
  }
}

// Shared memory of the chunk kernels, in elements of T (`_chunk_shared` in
// the wrapper says the same in bytes, with the floats of the vectors).
template <int P, int N> struct Chunk {
  static constexpr int XP = P + kPadE;        // pitch of an x row
  static constexpr int NP = N + kPadE;        // pitch of a B, C or h row
  static constexpr int LP = kL + kPadE;       // pitch of an M row
  // chunk state: x [kL][XP], B * w [kL][NP]
  static constexpr int STATE = kL * XP + kL * NP;
  // chunk scan: C [kL][NP], B [kL][NP], x [kL][XP], h [P][NP], M [kL][LP]
  static constexpr int SCAN = 2 * kL * NP + kL * XP + P * NP + kL * LP;
  // floats of the vectors: dt and a third in f32, cum in f64
  static constexpr int VECS = 4 * kL;
};

// dt of a chunk into dts (zeros past Lc), then the in-chunk inclusive
// cumsum of dt A into cum by warp 0 (two steps a lane, a shuffle scan), in
// f64: the decays exp(cum_t - cum_s) take differences of sums over up to
// 64 steps, which f32 would leave ~1e-5 off in relative terms.  The same
// sums in passes 1 and 3.
__device__ __forceinline__ void chunk_cum(const float* dtb, int64_t dt_s,
                                          int c0, int Lc, float a,
                                          float* dts, double* cum) {
  static_assert(kL == 64, "two steps a lane of one warp");
  for (int i = threadIdx.x; i < kL; i += kCThreads)
    dts[i] = i < Lc ? dtb[(int64_t)(c0 + i) * dt_s] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const double a0 = (double)(dts[2 * l] * a);
    const double a1 = (double)(dts[2 * l + 1] * a);
    double v = a0 + a1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, o);
      if (l >= o) v += u;
    }
    double before = __shfl_up_sync(0xffffffffu, v, 1);
    if (l == 0) before = 0.0;
    cum[2 * l] = before + a0;
    cum[2 * l + 1] = (before + a0) + a1;
  }
  __syncthreads();
}

// Pass 1: S_c = x^T (B * w) (P x N) and exp(cum_L) of chunk blockIdx.y
// of (b, h) = blockIdx.x, into the scratch slot (bh, c).
template <typename T, int P, int N>
__global__ void __launch_bounds__(kCThreads)
ssd_chunk_state_kernel(Params p, float* states, float* decays) {
  using C = Chunk<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);        // [kL][XP]  x_s
  T* bw = xs + kL * C::XP;                        // [kL][NP]  B_s w_s
  float* dts = reinterpret_cast<float*>(bw + kL * C::NP);
  double* cum = reinterpret_cast<double*>(dts + kL);
  float* w = reinterpret_cast<float*>(cum + kL);

  const int bh = blockIdx.x;
  const int b = bh / p.H, hh = bh % p.H;
  const int c = blockIdx.y;
  const int c0 = c * kL;
  const int Lc = min(kL, p.S - c0);
  chunk_cum(p.dt + b * p.dt_b + hh * p.dt_h, p.dt_s, c0, Lc, p.A[hh], dts,
            cum);
  for (int i = threadIdx.x; i < kL; i += kCThreads)
    w[i] = i < Lc ? expf((float)(cum[Lc - 1] - cum[i])) * dts[i] : 0.f;
  __syncthreads();
  stage<T, P>(xs, C::XP, static_cast<const T*>(p.x) + b * p.x_b
                             + (int64_t)c0 * p.x_s + hh * p.x_h,
              p.x_s, Lc, nullptr);
  stage<T, N>(bw, C::NP, static_cast<const T*>(p.Bc) + b * p.b_b
                             + (int64_t)c0 * p.b_s,
              p.b_s, Lc, w);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  float* out = states + ((int64_t)bh * gridDim.y + c) * P * N;
  for (int rt = warp; rt < P / 16; rt += kCThreads / 32) {
    float acc[N / 8][4];
    zero(acc);
    // rows p of x^T are x's columns: A stored [s][p]; B w stored [s][n]
    mm<kL, N / 8, true, true>(xs + rt * 16, C::XP, bw, C::NP, acc, lane);
    float* r0 = out + (rt * 16 + g) * N + 2 * t;
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      store2(r0 + n * 8, acc[n][0], acc[n][1]);
      store2(r0 + 8 * N + n * 8, acc[n][2], acc[n][3]);
    }
  }
  if (threadIdx.x == 0)
    decays[(int64_t)bh * gridDim.y + c] = expf((float)cum[Lc - 1]);
}

constexpr int kPassBatch = 8;         // chunks whose loads are in flight

// Pass 2: per (b, h) = blockIdx.x and four state elements a thread, walk
// the chunks: slot c gets the chunk's starting state h_c, and h_c+1 =
// exp(cum_L,c) h_c + S_c; the last is the final h.  The loads of
// kPassBatch chunks are issued before their sums.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* h0, float* states, const float* decays,
                      float* h, int n_chunks, int PN) {
  const int e = (blockIdx.y * kPassThreads + threadIdx.x) * 4;
  if (e >= PN) return;
  const int64_t bh = blockIdx.x;
  float4 cur = h0 != nullptr
                   ? *reinterpret_cast<const float4*>(h0 + bh * PN + e)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  float* slot = states + bh * n_chunks * PN + e;
  const float* dec = decays + bh * n_chunks;
  for (int c0 = 0; c0 < n_chunks; c0 += kPassBatch) {
    float4 sc[kPassBatch];
    float d[kPassBatch];
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k < n_chunks) {
        sc[k] = *reinterpret_cast<const float4*>(slot + (int64_t)k * PN);
        d[k] = dec[c0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < kPassBatch; ++k) {
      if (c0 + k < n_chunks) {
        *reinterpret_cast<float4*>(slot + (int64_t)k * PN) = cur;
        cur.x = fmaf(d[k], cur.x, sc[k].x);
        cur.y = fmaf(d[k], cur.y, sc[k].y);
        cur.z = fmaf(d[k], cur.z, sc[k].z);
        cur.w = fmaf(d[k], cur.w, sc[k].w);
      }
    }
    slot += (int64_t)kPassBatch * PN;
  }
  *reinterpret_cast<float4*>(h + bh * PN + e) = cur;
}

// Pass 3: y of chunk blockIdx.y of (b, h) = blockIdx.x from its starting
// state (scratch slot (bh, c)): warp w owns rows t = 16 w ... 16 w + 15.
template <typename T, int P, int N>
__global__ void __launch_bounds__(kCThreads)
ssd_chunk_scan_kernel(Params p, const float* states) {
  using C = Chunk<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);        // [kL][NP]  C_t
  T* bs = cs + kL * C::NP;                        // [kL][NP]  B_s
  T* xs = bs + kL * C::NP;                        // [kL][XP]  x_s
  T* hs = xs + kL * C::XP;                        // [P][NP]   h_start
  T* ms = hs + P * C::NP;                         // [kL][LP]  M[t, s]
  float* dts = reinterpret_cast<float*>(ms + kL * C::LP);
  double* cum = reinterpret_cast<double*>(dts + kL);
  float* alpha = reinterpret_cast<float*>(cum + kL);   // exp(cum_t)

  const int bh = blockIdx.x;
  const int b = bh / p.H, hh = bh % p.H;
  const int c = blockIdx.y;
  const int c0 = c * kL;
  const int Lc = min(kL, p.S - c0);
  chunk_cum(p.dt + b * p.dt_b + hh * p.dt_h, p.dt_s, c0, Lc, p.A[hh], dts,
            cum);
  for (int i = threadIdx.x; i < kL; i += kCThreads)
    alpha[i] = expf((float)cum[i]);
  stage<T, N>(cs, C::NP, static_cast<const T*>(p.Cc) + b * p.c_b
                             + (int64_t)c0 * p.c_s,
              p.c_s, Lc, nullptr);
  stage<T, N>(bs, C::NP, static_cast<const T*>(p.Bc) + b * p.b_b
                             + (int64_t)c0 * p.b_s,
              p.b_s, Lc, nullptr);
  stage<T, P>(xs, C::XP, static_cast<const T*>(p.x) + b * p.x_b
                             + (int64_t)c0 * p.x_s + hh * p.x_h,
              p.x_s, Lc, nullptr);
  const float* hst = states + ((int64_t)bh * gridDim.y + c) * P * N;
  for (int i = threadIdx.x * 4; i < P * N; i += kCThreads * 4) {
    const float4 v = *reinterpret_cast<const float4*>(hst + i);
    T* d = hs + (i / N) * C::NP + i % N;
    d[0] = from_f32<T>(v.x);
    d[1] = from_f32<T>(v.y);
    d[2] = from_f32<T>(v.z);
    d[3] = from_f32<T>(v.w);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g, r1 = r0 + 8;     // this thread's rows t
  // M[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t (< Lc)
  {
    float gm[kL / 8][4];
    zero(gm);
    mm<N, kL / 8, false, false>(cs + warp * 16 * C::NP, C::NP, bs, C::NP,
                                gm, lane);
#pragma unroll
    for (int n = 0; n < kL / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = e < 2 ? r0 : r1;
        const int s = n * 8 + 2 * t + (e & 1);
        const float v = (s <= tt && tt < Lc)
                            ? gm[n][e] * expf((float)(cum[tt] - cum[s]))
                                  * dts[s]
                            : 0.f;
        ms[tt * C::LP + s] = from_f32<T>(v);
      }
    }
  }
  __syncwarp();                        // a warp reads only its own M rows
  float yv[P / 8][4], inter[P / 8][4];
  zero(yv);
  zero(inter);
  mm<kL, P / 8, false, true>(ms + warp * 16 * C::LP, C::LP, xs, C::XP, yv,
                             lane);
  mm<N, P / 8, false, false>(cs + warp * 16 * C::NP, C::NP, hs, C::NP,
                             inter, lane);
  T* yb = static_cast<T*>(p.y) + (((int64_t)b * p.S + c0) * p.H + hh) * P
          + 2 * t;
  const int64_t y_s = (int64_t)p.H * P;
  if (r0 < Lc) {
    const float a0 = alpha[r0];
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
      store2(yb + r0 * y_s + n * 8, fmaf(a0, inter[n][0], yv[n][0]),
             fmaf(a0, inter[n][1], yv[n][1]));
  }
  if (r1 < Lc) {
    const float a1 = alpha[r1];
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
      store2(yb + r1 * y_s + n * 8, fmaf(a1, inter[n][2], yv[n][2]),
             fmaf(a1, inter[n][3], yv[n][3]));
  }
}

template <typename T>
int launch_seq(const Params& p, void* stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(p.P, p.N);
  const cudaError_t err = shared_limit(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<p.B * p.H, kThreads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}


template <typename T>
int launch_step(const Params& p, void* stream) {
  const dim3 grid(p.B * p.H, (p.P + kStepRows - 1) / kStepRows);
  ssd_step_kernel<T><<<grid, 32 * kStepRows, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// The three passes; `scratch` holds n_chunks P x N states and n_chunks
// decays a (b, h) (`scratch_floats` in the wrapper).
template <typename T, int P, int N>
int launch_chunked(const Params& p, float* scratch, void* stream) {
  using C = Chunk<P, N>;
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int BH = p.B * p.H;
  const int nc = (p.S + kL - 1) / kL;
  float* states = scratch;
  float* decays = scratch + (int64_t)BH * nc * P * N;
  const size_t smem1 = sizeof(T) * C::STATE + sizeof(float) * C::VECS;
  const size_t smem3 = sizeof(T) * C::SCAN + sizeof(float) * C::VECS;
  cudaError_t err = shared_limit(ssd_chunk_state_kernel<T, P, N>, smem1);
  if (err == cudaSuccess)
    err = shared_limit(ssd_chunk_scan_kernel<T, P, N>, smem3);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<T, P, N><<<dim3(BH, nc), kCThreads, smem1, st>>>(
      p, states, decays);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PN = P * N;
  ssd_state_pass_kernel<<<dim3(BH, (PN + 4 * kPassThreads - 1)
                                        / (4 * kPassThreads)),
                          kPassThreads, 0, st>>>(p.h0, states, decays, p.h,
                                                 nc, PN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<T, P, N><<<dim3(BH, nc), kCThreads, smem3, st>>>(
      p, states);
  return (int)cudaGetLastError();
}

// The paths, numbered as `PATHS` in the wrapper.
enum Path { kStep = 0, kChunked = 1, kSequential = 2 };

template <typename T>
int run(const Params& p, int path, float* scratch, void* stream) {
  switch (path) {
    case kStep: return launch_step<T>(p, stream);
    case kChunked:
      if (p.P != 64 || p.N != 64 || scratch == nullptr)
        return (int)cudaErrorInvalidValue;
      return launch_chunked<T, 64, 64>(p, scratch, stream);   // zamba2-7b
    case kSequential: return launch_seq<T>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const float* dt, const void* Bc, const void* Cc,
                   const void* x, const float* A, const float* h0, void* y,
                   float* h, int B, int S, int H, int P, int N,
                   const int64_t* strides) {
  Params p;
  p.dt = dt; p.Bc = Bc; p.Cc = Cc; p.x = x; p.A = A; p.h0 = h0;
  p.y = y; p.h = h;
  p.B = B; p.S = S; p.H = H; p.P = P; p.N = N;
  p.dt_b = strides[0]; p.dt_s = strides[1]; p.dt_h = strides[2];
  p.b_b = strides[3]; p.b_s = strides[4];
  p.c_b = strides[5]; p.c_s = strides[6];
  p.x_b = strides[7]; p.x_s = strides[8]; p.x_h = strides[9];
  return p;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `path` is the wrapper's choice
// (0 step, 1 chunked, 2 sequential).  Pointers are device pointers (h0
// may be null: a zero state; `scratch` is null unless the call takes the
// chunk-parallel path, and then holds `scratch_floats` floats), `strides`
// a host array of ten element strides (batch, sequence and head of dt;
// batch and sequence of B and C; batch, sequence and head of x; the last
// dimensions are contiguous), P and N multiples of 4, `stream` a
// cudaStream_t.  Shapes, types, strides and the shared-memory size were
// checked by the Python wrapper.
int ssd_scan_f32(const float* dt, const void* Bc, const void* Cc,
                 const void* x, const float* A, const float* h0, void* y,
                 float* h, float* scratch, int path, int B, int S, int H,
                 int P, int N, const int64_t* strides, void* stream) {
  return run<float>(make_params(dt, Bc, Cc, x, A, h0, y, h, B, S, H, P, N,
                                strides),
                    path, scratch, stream);
}

int ssd_scan_bf16(const float* dt, const void* Bc, const void* Cc,
                  const void* x, const float* A, const float* h0, void* y,
                  float* h, float* scratch, int path, int B, int S, int H,
                  int P, int N, const int64_t* strides, void* stream) {
  return run<__nv_bfloat16>(make_params(dt, Bc, Cc, x, A, h0, y, h, B, S, H,
                                        P, N, strides),
                            path, scratch, stream);
}

}  // extern "C"
