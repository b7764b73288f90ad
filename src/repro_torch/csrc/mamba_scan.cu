// Mamba-1 selective scan for Hopper (sm_90a): diagonal A, state in f32.
//
// Replaces the Pallas TPU kernel `mamba1_scan`
// (src/repro/kernels/mamba_scan.py, `_scan_kernel`).  It computes the same
// function: for every batch row b, channel d and state n, from h = h0,
//
//     h_t = exp(dt_t * A[d, n]) * h + (dt_t * x_t) * B_t[n]
//     y_t = sum_n h_t[n] * C_t[n]
//
// with every input cast to f32 first, y written in x's dtype and the final
// h in f32.
//
// What bounds it on this card: each (b, d, n) does ~7 f32 operations a
// step (an exp among them) on inputs it reads once, and dt, x and y move
// 2 bytes an element in bf16: at the served shapes (Di 8192, N 16) a
// 1024-token prefill moves ~50 MB and a decode step (S = 1) moves the
// state, ~1.6 MB, so it is bound by device-memory bytes, with the f32
// operations close behind at long sequences (`bound_bytes`, `bound_flops`
// in the wrapper).
//
// Where it differs from the Pallas kernel, and why:
//
//   * No carried grid state.  The Pallas grid walks the sequence chunks in
//     order on one core and keeps h (block_d, N) in VMEM scratch across
//     them.  Hopper blocks run in no order, so the chunk axis becomes a
//     loop inside the block and h stays in a register of the thread that
//     owns it for the whole sequence: one thread per (b, d, n), the N
//     states of one channel in N adjacent lanes of a warp.
//   * Enough threads.  One thread per channel would give 8,192 threads at
//     batch 1, too few for 132 SMs; one per state gives 131,072 (512
//     blocks of 256).  y_t is the sum over a channel's N lanes, taken by
//     log2(N) __shfl_xor steps.
//   * Staged inputs.  The block stages a tile of kTS steps of B_t and C_t
//     (shared by all its channels) and of its channels' dt and x in shared
//     memory as f32, walks the tile, collects y_t there, and stores the
//     tile's y coalesced.
//   * Strides, not copies.  B and C are column slices of one projection
//     and reach the kernel as strided views; dt, x, B and C take batch and
//     sequence strides, the last dimension contiguous.  No padding: the
//     ragged channel block and time tile are masked.
//   * h0 may be null (zeros).  The masked recompute feeds dt = 0 past the
//     live length, which leaves h unchanged (exp(0) = 1, update 0).
//
// A simple kernel that is right: it launches on the stream it is given and
// allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTS = 32;                // time steps a tile
constexpr int kMinN = 4;               // N in [kMinN, 32], a power of two
constexpr int kMaxCPB = kThreads / kMinN;   // channels a block at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

struct Params {
  const void* dt;                      // (B, S, Di) of T
  const void* Bc;                      // (B, S, N) of T
  const void* Cc;                      // (B, S, N) of T
  const void* x;                       // (B, S, Di) of T
  const float* A;                      // (Di, N), contiguous
  const float* h0;                     // (B, Di, N), contiguous, or null
  void* y;                             // (B, S, Di) of T, contiguous
  float* h;                            // (B, Di, N), contiguous
  int B, S, Di, N;
  int64_t dt_b, dt_s, x_b, x_s;        // element strides
  int64_t b_b, b_s, c_b, c_s;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) mamba1_scan_kernel(Params p) {
  __shared__ float bs[kTS][32];        // B_t, C_t of the tile
  __shared__ float cs[kTS][32];
  __shared__ float dts[kTS][kMaxCPB];  // this block's channels
  __shared__ float xs[kTS][kMaxCPB];
  __shared__ float ys[kTS][kMaxCPB];

  const int N = p.N;
  const int cpb = kThreads / N;        // channels a block
  const int c = threadIdx.x / N;       // this thread's channel in the block
  const int n = threadIdx.x % N;       // and state
  const int d0 = blockIdx.x * cpb;
  const int d = d0 + c;
  const int b = blockIdx.y;
  const bool live = d < p.Di;

  const float a = live ? p.A[(int64_t)d * N + n] : 0.f;
  float h = 0.f;
  if (live && p.h0 != nullptr) h = p.h0[((int64_t)b * p.Di + d) * N + n];

  const T* dtb = static_cast<const T*>(p.dt) + b * p.dt_b;
  const T* xb = static_cast<const T*>(p.x) + b * p.x_b;
  const T* bb = static_cast<const T*>(p.Bc) + b * p.b_b;
  const T* cb = static_cast<const T*>(p.Cc) + b * p.c_b;
  T* yb = static_cast<T*>(p.y) + (int64_t)b * p.S * p.Di;

  for (int t0 = 0; t0 < p.S; t0 += kTS) {
    const int steps = min(kTS, p.S - t0);
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      const int t = i / N, k = i % N;
      bs[t][k] = to_f32(bb[(t0 + t) * p.b_s + k]);
      cs[t][k] = to_f32(cb[(t0 + t) * p.c_s + k]);
    }
    for (int i = threadIdx.x; i < steps * cpb; i += kThreads) {
      const int t = i / cpb, k = i % cpb;
      const bool ok = d0 + k < p.Di;
      dts[t][k] = ok ? to_f32(dtb[(t0 + t) * p.dt_s + d0 + k]) : 0.f;
      xs[t][k] = ok ? to_f32(xb[(t0 + t) * p.x_s + d0 + k]) : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float dtv = dts[t][c];
      h = expf(dtv * a) * h + (dtv * xs[t][c]) * bs[t][n];
      float part = h * cs[t][n];
      // a channel's N states sit in N adjacent lanes of one warp (N
      // divides 32), so xor offsets below N stay inside the channel
      for (int off = N / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (n == 0) ys[t][c] = part;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * cpb; i += kThreads) {
      const int t = i / cpb, k = i % cpb;
      if (d0 + k < p.Di)
        store(yb + (int64_t)(t0 + t) * p.Di + d0 + k, ys[t][k]);
    }
    __syncthreads();                   // the tile's buffers are free again
  }
  if (live) p.h[((int64_t)b * p.Di + d) * N + n] = h;
}

template <typename T>
int launch(const Params& p, void* stream) {
  const int cpb = kThreads / p.N;
  const dim3 grid((p.Di + cpb - 1) / cpb, p.B);
  mamba1_scan_kernel<T><<<grid, kThreads, 0,
                          reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* dt, const void* Bc, const void* Cc,
                   const void* x, const float* A, const float* h0, void* y,
                   float* h, int B, int S, int Di, int N,
                   const int64_t* strides) {
  Params p;
  p.dt = dt; p.Bc = Bc; p.Cc = Cc; p.x = x; p.A = A; p.h0 = h0;
  p.y = y; p.h = h;
  p.B = B; p.S = S; p.Di = Di; p.N = N;
  p.dt_b = strides[0]; p.dt_s = strides[1];
  p.x_b = strides[2]; p.x_s = strides[3];
  p.b_b = strides[4]; p.b_s = strides[5];
  p.c_b = strides[6]; p.c_s = strides[7];
  return p;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Pointers are device pointers (h0
// may be null: a zero state), `strides` a host array of eight element
// strides (batch and sequence of dt, x, B and C; the last dimension is
// contiguous), N a power of two in [4, 32], `stream` a cudaStream_t.
// Shapes, types and strides were checked by the Python wrapper.
int mamba1_scan_f32(const void* dt, const void* Bc, const void* Cc,
                    const void* x, const float* A, const float* h0, void* y,
                    float* h, int B, int S, int Di, int N,
                    const int64_t* strides, void* stream) {
  return launch<float>(make_params(dt, Bc, Cc, x, A, h0, y, h, B, S, Di, N,
                                   strides),
                       stream);
}

int mamba1_scan_bf16(const void* dt, const void* Bc, const void* Cc,
                     const void* x, const float* A, const float* h0, void* y,
                     float* h, int B, int S, int Di, int N,
                     const int64_t* strides, void* stream) {
  return launch<__nv_bfloat16>(make_params(dt, Bc, Cc, x, A, h0, y, h, B, S,
                                           Di, N, strides),
                               stream);
}

}  // extern "C"
