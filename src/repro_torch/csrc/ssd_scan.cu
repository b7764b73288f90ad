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
// bf16) a 1024-token prefill moves ~34 MB (x in, y out, the state in and
// out) and does ~3.8 GFLOP in the chunked form, so it is bound by
// device-memory bytes at the bf16 tensor-core rate (`bound_bytes`,
// `bound_flops` in the wrapper); a decode step (S = 1) moves the state,
// ~3.7 MB.
//
// Where it differs from the Pallas kernel, and why:
//
//   * No carried grid state.  The Pallas grid walks the chunks in order on
//     one core with h in VMEM scratch; here one block owns one (b, h), keeps
//     h in shared memory and walks the chunks itself.  At batch 1 that is
//     112 blocks, one an SM.
//   * f32 on the CUDA cores.  The products (C B^T, M x, C h^T, x^T B) run in
//     f32 FMAs, each thread on a 4 x 4 register tile read from shared memory
//     as float4 rows, not on the tensor cores: that is what meets the
//     reference's 1e-4 in f32.  Tensor cores and wgmma are later work.
//   * Chunk 64, not 128.  B, C, x and M of a chunk in f32 plus the state
//     take 83 KB of shared memory at P = N = 64 (chunk 128 would take
//     176 KB), so two blocks fit an SM, and the quadratic in-chunk work is
//     half as large.  The chunk changes only the order of f32 sums.
//   * Ragged chunks, not padding.  The last chunk of Lc < 64 steps walks
//     only its rows rounded up to 4 (zero-filled), so a decode step (S = 1)
//     is one 4-row chunk of the same code: the single-step update.
//   * Strides, not copies.  B, C and x are column slices of one projection
//     and reach the kernel as strided views (x's heads and features as
//     reshaped columns); the Pallas wrapper's head-major transposes are
//     replaced by strides, and the last dimension is contiguous.
//   * h0 may be null (zeros).  The masked recompute feeds dt = 0 past the
//     live length, which leaves h unchanged (exp(0) = 1, weight 0).
//
// A simple kernel that is right: it launches on the stream it is given and
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
// h^T [N][P], and four vectors of L.
__host__ __device__ inline int smem_floats(int P, int N) {
  return kL * N + N * kL + kL * P + kL * kL + N * P + 4 * kL;
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
  float* cum = ht + N * P;             // [kL]
  float* alpha = cum + kL;             // [kL]      exp(cum_t)
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
      float acc = 0.f;
      for (int i = 0; i < Lr; ++i) {
        acc += dts[i] * a;
        cum[i] = acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < Lr; i += kThreads) {
      alpha[i] = expf(cum[i]);
      wt[i] = expf(cum[Lc - 1] - cum[i]) * dts[i];
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
                               ? acc[i][j] * expf(cum[t] - cum[s]) * dts[s]
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

template <typename T>
int launch(const Params& p, void* stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats(p.P, p.N);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_scan_kernel<T><<<p.B * p.H, kThreads, smem,
                       reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
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

// Returns a cudaError_t (0 on success).  Pointers are device pointers (h0
// may be null: a zero state), `strides` a host array of ten element
// strides (batch, sequence and head of dt; batch and sequence of B and C;
// batch, sequence and head of x; the last dimensions are contiguous), P
// and N multiples of 4, `stream` a cudaStream_t.  Shapes, types, strides
// and the shared-memory size were checked by the Python wrapper.
int ssd_scan_f32(const float* dt, const void* Bc, const void* Cc,
                 const void* x, const float* A, const float* h0, void* y,
                 float* h, int B, int S, int H, int P, int N,
                 const int64_t* strides, void* stream) {
  return launch<float>(make_params(dt, Bc, Cc, x, A, h0, y, h, B, S, H, P,
                                   N, strides),
                       stream);
}

int ssd_scan_bf16(const float* dt, const void* Bc, const void* Cc,
                  const void* x, const float* A, const float* h0, void* y,
                  float* h, int B, int S, int H, int P, int N,
                  const int64_t* strides, void* stream) {
  return launch<__nv_bfloat16>(make_params(dt, Bc, Cc, x, A, h0, y, h, B, S,
                                           H, P, N, strides),
                               stream);
}

}  // extern "C"
