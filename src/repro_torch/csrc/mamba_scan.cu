// Mamba-1 selective scan for Hopper (sm_90a): diagonal A, state in f32,
// chunk-parallel in time.
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
// What bounds it on this card: every (b, t, d, n) needs one exponential,
// which runs on the special-function unit (16 a clock an SM), beside ~6
// f32 operations and 2 bytes of dt, x and y a (b, t, d) in bf16.  At the
// served shapes (Di 8192, N 16) a 1024-token prefill needs 134M exps,
// 32 us at the SFU rate, against 15 us of bytes (~50 MB) and 12 us of f32
// operations: the exps bound it (`bound_exps`, `bound_bytes`,
// `bound_flops` in the wrapper).  A decode step (S = 1) moves the ~1.6 MB
// of state and is bound by bytes.
//
// The design: a fixed chunk of kL steps, boundaries at multiples of kL
// from t = 0 whatever S is, and three launches (the plan is chosen by the
// wrapper and passed in as `chunked`):
//
//   1. chunk states, grid (channel blocks, chunks but the last, B): each
//      thread scans kG states of one channel over its chunk from h = 0
//      and writes the chunk's local end state and its sum of dt to the
//      scratch the wrapper allocates;
//   2. carry, one thread per (b, d, n): from h0 (or zeros), for each chunk
//      c, writes h_start[c] = h over the local state it read, then
//      h = exp(A * sum dt_c) * h + local_c;
//   3. outputs, grid (channel blocks, chunks, B): each chunk rescans from
//      h_start[c] and writes y; the last chunk also scans its local state
//      and writes the final h with the carry's own formula.
//
// Where S <= kL only launch 3 runs, from h0 (the decode step is one launch
// of it).  At S 1024 that is 16 chunks x 8,192 channels x N / kG lanes a
// pass, each chain at most kL steps long, where a sequential scan walks
// all S steps with one thread a (d, n).  A chunk's exps are paid twice
// (passes 1 and 3), so the SFU floor of the design is twice the
// function's.  In bf16, log2(e) is folded into A and the exp is one
// `ex2.approx`; f32, the accuracy path, keeps the library `expf`.
//
// Threads: a channel's N states are spread over N / kG adjacent lanes of
// a warp, kG each in registers, so a lane's states are kG adjacent floats
// of every (Di, N) slice and a warp's state loads and stores are
// contiguous; y_t's sum over the states takes log2(N / kG) shuffles.
// Many states a lane amortise a step's loads, its conversions and the
// shuffles (passes 1 and 3 over several chunks: kG 8, two steps unrolled);
// few states a lane shorten the one launch of a decode step (kG 2).
//
// dt = 0 (the masked recompute's steps past the live length) is exact: a
// decay of exactly 1 and an update of exactly 0 in every pass, and a
// chunk's sum of dt unchanged.  Because the final state is always the
// carry formula applied to the last chunk that holds a live step, and the
// boundaries do not move with S, a masked scan's final state is bit-equal
// to the live scan's at any live length.  Every product and sum of the
// recurrence is an explicit intrinsic (`__fmul_rn`, `__fadd_rn`, `fmaf`)
// so that passes 1 and 3 run the same arithmetic whatever the compiler
// contracts, and a state's arithmetic does not depend on kG.
//
// Loads: the block stages tiles of kTS steps of dt and x (16-byte vectors
// along the contiguous channel axis when pointers, strides and Di allow,
// element by element otherwise) and of B_t and C_t (strided column views
// of one projection, taken as they are) in shared memory; y goes back
// through a tile as 16-byte vectors.  No padding: the ragged channel
// block is masked.  Nothing is allocated here; every launch runs on the
// stream it is given.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kL = 64;                 // steps a chunk
constexpr int kTS = 32;                // steps a staged tile
constexpr int kC = 64;                 // channels a chunk block
// states a thread (N / states lanes a channel) and steps unrolled, of
// pass 1, of pass 3 over several chunks, and of pass 3 alone (S <= kL:
// more lanes a channel, for the decode step's latency)
constexpr int kGState = 8, kUState = 2;
constexpr int kGScan = 8, kUScan = 2;
constexpr int kGStep = 2;
constexpr int kCarryThreads = 256;     // pass 2
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A as the decay's exponent wants it: bf16 folds log2(e) in once
template <typename T> __device__ __forceinline__ float exponent_of(float a) {
  return std::is_same<T, float>::value ? a : __fmul_rn(a, kLog2e);
}

// exp(dt * A) from `exponent_of(A)`: exactly 1 at dt = 0 on both routes
template <typename T>
__device__ __forceinline__ float decay(float dt, float a) {
  const float z = __fmul_rn(dt, a);
  if (std::is_same<T, float>::value) return expf(z);
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(z));
  return r;
}

// the state after a chunk, from the state before it: passes 2 and 3 share
// this one expression, so a chunk's end state has the same bits whichever
// pass computes it
template <typename T>
__device__ __forceinline__ float carry(float a, float sdt, float h,
                                       float local) {
  return fmaf(decay<T>(sdt, a), h, local);
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
  float* states;                       // (B, nc, Di, N) scratch, or null
  float* sdts;                         // (B, nc, Di) scratch, or null
  int B, S, Di, N, nc;
  bool vec;                            // dt, x, y take 16-byte vectors
  int64_t dt_b, dt_s, x_b, x_s;        // element strides
  int64_t b_b, b_s, c_b, c_s;
};

// The state chunk c of row b starts from: h_start in the scratch when
// there are several chunks, else h0 (null: zeros).
__device__ __forceinline__ const float* start_of(const Params& p, int b,
                                                 int c) {
  if (p.states != nullptr)
    return p.states + ((int64_t)b * p.nc + c) * p.Di * p.N;
  return p.h0 == nullptr ? nullptr : p.h0 + (int64_t)b * p.Di * p.N;
}

// Stage steps [t0, t0 + steps) of dt and x for channels [d0, d0 + kC) and
// of B and C (as f32) in shared memory; zeros past Di.
template <typename T, int N, int kThreads>
__device__ __forceinline__ void stage(const Params& p, int b, int d0,
                                      int t0, int steps, T (*dts)[kC],
                                      T (*xs)[kC], float (*bs)[N],
                                      float (*cs)[N]) {
  const T* dtb = static_cast<const T*>(p.dt) + b * p.dt_b + t0 * p.dt_s;
  const T* xb = static_cast<const T*>(p.x) + b * p.x_b + t0 * p.x_s;
  if (p.vec) {
    constexpr int kV = 16 / sizeof(T);           // elements a vector
    constexpr int kVR = kC / kV;                 // vectors a row
    for (int i = threadIdx.x; i < steps * kVR; i += kThreads) {
      const int t = i / kVR, k = (i % kVR) * kV;
      uint4 dv = make_uint4(0, 0, 0, 0), xv = dv;
      if (d0 + k < p.Di) {                       // Di % kV == 0: whole
        dv = *reinterpret_cast<const uint4*>(dtb + t * p.dt_s + d0 + k);
        xv = *reinterpret_cast<const uint4*>(xb + t * p.x_s + d0 + k);
      }
      *reinterpret_cast<uint4*>(&dts[t][k]) = dv;
      *reinterpret_cast<uint4*>(&xs[t][k]) = xv;
    }
  } else {
    for (int i = threadIdx.x; i < steps * kC; i += kThreads) {
      const int t = i / kC, k = i % kC;
      const bool ok = d0 + k < p.Di;
      dts[t][k] = ok ? dtb[t * p.dt_s + d0 + k] : from_f32<T>(0.f);
      xs[t][k] = ok ? xb[t * p.x_s + d0 + k] : from_f32<T>(0.f);
    }
  }
  const T* bb = static_cast<const T*>(p.Bc) + b * p.b_b + t0 * p.b_s;
  const T* cb = static_cast<const T*>(p.Cc) + b * p.c_b + t0 * p.c_s;
  for (int i = threadIdx.x; i < steps * N; i += kThreads) {
    const int t = i / N, k = i % N;
    bs[t][k] = to_f32(bb[t * p.b_s + k]);
    cs[t][k] = to_f32(cb[t * p.c_s + k]);
  }
}

// Store y for steps [t0, t0 + steps), channels [d0, d0 + kC), from the
// tile `ys`.
template <typename T, int kThreads>
__device__ __forceinline__ void store_y(const Params& p, int b, int d0,
                                        int t0, int steps, T (*ys)[kC]) {
  T* yb = static_cast<T*>(p.y) + ((int64_t)b * p.S + t0) * p.Di;
  if (p.vec) {
    constexpr int kV = 16 / sizeof(T);
    constexpr int kVR = kC / kV;
    for (int i = threadIdx.x; i < steps * kVR; i += kThreads) {
      const int t = i / kVR, k = (i % kVR) * kV;
      if (d0 + k < p.Di)
        *reinterpret_cast<uint4*>(yb + (int64_t)t * p.Di + d0 + k) =
            *reinterpret_cast<const uint4*>(&ys[t][k]);
    }
  } else {
    for (int i = threadIdx.x; i < steps * kC; i += kThreads) {
      const int t = i / kC, k = i % kC;
      if (d0 + k < p.Di) yb[(int64_t)t * p.Di + d0 + k] = ys[t][k];
    }
  }
}

// Passes 1 (kOut false) and 3 (kOut true): block (channel block, chunk c,
// batch row b) of kC channels, N / kG adjacent lanes of a warp a channel,
// kG of its states in registers a lane, kU steps unrolled.
template <typename T, int N, bool kOut, int kG, int kU>
__global__ void __launch_bounds__(kC * N / kG)
mamba1_chunk_kernel(Params p) {
  constexpr int kLanes = N / kG;                // lanes a channel
  constexpr int kThreads = kC * kLanes;
  __shared__ __align__(16) T dts[kTS][kC];
  __shared__ __align__(16) T xs[kTS][kC];
  __shared__ __align__(16) T ys[kOut ? kTS : 1][kC];
  __shared__ __align__(16) float bs[kTS][N];
  __shared__ __align__(16) float cs[kTS][N];

  const int c = blockIdx.y, b = blockIdx.z;
  const int ch = threadIdx.x / kLanes, n0 = (threadIdx.x % kLanes) * kG;
  const int d0 = blockIdx.x * kC, d = d0 + ch;
  const bool live = d < p.Di;
  const int t_begin = c * kL, t_end = min(p.S, t_begin + kL);
  // pass 3's last chunk also scans its local state for the final h
  const bool last = kOut && c == p.nc - 1;
  const int64_t DN = (int64_t)p.Di * N;
  const int64_t at = (int64_t)d * N + n0;       // in a (Di, N) slice

  const float* start = kOut ? start_of(p, b, c) : nullptr;
  float a[kG], h[kG], loc[kG];
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    a[k] = live ? exponent_of<T>(p.A[at + k]) : 0.f;
    h[k] = (live && start != nullptr) ? start[at + k] : 0.f;
    loc[k] = 0.f;
  }
  float sdt = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += kTS) {
    const int steps = min(kTS, t_end - t0);
    stage<T, N, kThreads>(p, b, d0, t0, steps, dts, xs, bs, cs);
    __syncthreads();
#pragma unroll (kU)
    for (int t = 0; t < steps; ++t) {
      const float dtv = to_f32(dts[t][ch]);
      const float u = __fmul_rn(dtv, to_f32(xs[t][ch]));
      sdt = __fadd_rn(sdt, dtv);
      float yv = 0.f;
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        const float e = decay<T>(dtv, a[k]);
        const float bu = __fmul_rn(u, bs[t][n0 + k]);
        h[k] = fmaf(e, h[k], bu);
        if (kOut) {
          yv = fmaf(h[k], cs[t][n0 + k], yv);
          if (last) loc[k] = fmaf(e, loc[k], bu);
        }
      }
      if (kOut) {
        // a channel's lanes are adjacent in one warp (kLanes divides 32)
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1)
          yv += __shfl_xor_sync(0xffffffffu, yv, off);
        if (n0 == 0) ys[t][ch] = from_f32<T>(yv);
      }
    }
    __syncthreads();
    if (kOut) {
      store_y<T, kThreads>(p, b, d0, t0, steps, ys);
      __syncthreads();                 // the tile's buffers are free again
    }
  }
  if (!live) return;
  if (!kOut) {                         // pass 1: h is the local state
    float* st = p.states + ((int64_t)b * p.nc + c) * DN + at;
#pragma unroll
    for (int k = 0; k < kG; ++k) st[k] = h[k];
    if (n0 == 0) p.sdts[((int64_t)b * p.nc + c) * p.Di + d] = sdt;
  } else if (last) {
#pragma unroll
    for (int k = 0; k < kG; ++k)
      p.h[(int64_t)b * DN + at + k] = carry<T>(
          a[k], sdt, start == nullptr ? 0.f : start[at + k], loc[k]);
  }
}

// Pass 2: one thread a (b, d, n), in order over the chunks.  Chunk c's
// slot holds its local state on entry and its start state on exit.  The
// loads of kBatch chunks are issued before their carries.
template <typename T>
__global__ void __launch_bounds__(kCarryThreads)
mamba1_carry_kernel(Params p) {
  constexpr int kBatch = 8;
  const int64_t DN = (int64_t)p.Di * p.N;
  const int64_t i = (int64_t)blockIdx.x * kCarryThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= DN) return;
  const float a = exponent_of<T>(p.A[i]);
  float h = p.h0 == nullptr ? 0.f : p.h0[b * DN + i];
  float* st = p.states + (int64_t)b * p.nc * DN + i;
  const float* sd = p.sdts + (int64_t)b * p.nc * p.Di + i / p.N;
  for (int c0 = 0; c0 + 1 < p.nc; c0 += kBatch) {
    float local[kBatch], s[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const bool ok = c0 + k + 1 < p.nc;
      local[k] = ok ? st[(c0 + k) * DN] : 0.f;
      s[k] = ok ? sd[(int64_t)(c0 + k) * p.Di] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k + 1 < p.nc) {
        st[(c0 + k) * DN] = h;
        h = carry<T>(a, s[k], h, local[k]);
      }
    }
  }
  st[(int64_t)(p.nc - 1) * DN] = h;
}

// One launch of a chunk kernel with kG states a thread (at most N).
template <typename T, int N, bool kOut, int kG, int kU>
cudaError_t launch_chunks(const Params& p, int chunks, cudaStream_t stream) {
  constexpr int G = kG < N ? kG : N;
  mamba1_chunk_kernel<T, N, kOut, G, kU>
      <<<dim3((p.Di + kC - 1) / kC, chunks, p.B), kC * N / G, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int N>
int launch_n(const Params& p, cudaStream_t stream) {
  if (p.states == nullptr)             // one chunk: pass 3 alone, from h0
    return (int)launch_chunks<T, N, true, kGStep, 1>(p, 1, stream);
  cudaError_t err = launch_chunks<T, N, false, kGState, kUState>(
      p, p.nc - 1, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t DN = (int64_t)p.Di * N;
  mamba1_carry_kernel<T><<<dim3((DN + kCarryThreads - 1) / kCarryThreads,
                                p.B), kCarryThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_chunks<T, N, true, kGScan, kUScan>(p, p.nc, stream);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
int launch(const void* dt, const void* Bc, const void* Cc, const void* x,
           const float* A, const float* h0, void* y, float* h,
           float* scratch, int chunked, int B, int S, int Di, int N,
           const int64_t* strides, void* stream) {
  Params p;
  p.dt = dt; p.Bc = Bc; p.Cc = Cc; p.x = x; p.A = A; p.h0 = h0;
  p.y = y; p.h = h;
  p.B = B; p.S = S; p.Di = Di; p.N = N;
  p.nc = S > kL ? (S + kL - 1) / kL : 1;
  // the wrapper's plan: three launches exactly when there are several
  // chunks, with scratch for their states and sums of dt
  if ((chunked != 0) != (p.nc > 1) || (chunked != 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  p.states = scratch;
  p.sdts = scratch == nullptr ? nullptr
                              : scratch + (int64_t)B * p.nc * Di * N;
  p.dt_b = strides[0]; p.dt_s = strides[1];
  p.x_b = strides[2]; p.x_s = strides[3];
  p.b_b = strides[4]; p.b_s = strides[5];
  p.c_b = strides[6]; p.c_s = strides[7];
  constexpr int kV = 16 / sizeof(T);
  p.vec = aligned16(dt) && aligned16(x) && aligned16(y) && Di % kV == 0
          && p.dt_b % kV == 0 && p.dt_s % kV == 0 && p.x_b % kV == 0
          && p.x_s % kV == 0;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return launch_n<T, 4>(p, s);
    case 8: return launch_n<T, 8>(p, s);
    case 16: return launch_n<T, 16>(p, s);
    case 32: return launch_n<T, 32>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Pointers are device pointers (h0
// may be null: a zero state), `scratch` f32 of B * nc * Di * (N + 1)
// floats when `chunked` (S > 64: nc = ceil(S / 64) chunks), else null;
// `strides` a host array of eight element strides (batch and sequence of
// dt, x, B and C; the last dimension is contiguous), N in {4, 8, 16, 32},
// `stream` a cudaStream_t.  Shapes, types and strides were checked by the
// Python wrapper, which also chose `chunked` (its `plan`).
int mamba1_scan_f32(const void* dt, const void* Bc, const void* Cc,
                    const void* x, const float* A, const float* h0, void* y,
                    float* h, float* scratch, int chunked, int B, int S,
                    int Di, int N, const int64_t* strides, void* stream) {
  return launch<float>(dt, Bc, Cc, x, A, h0, y, h, scratch, chunked, B, S,
                       Di, N, strides, stream);
}

int mamba1_scan_bf16(const void* dt, const void* Bc, const void* Cc,
                     const void* x, const float* A, const float* h0, void* y,
                     float* h, float* scratch, int chunked, int B, int S,
                     int Di, int N, const int64_t* strides, void* stream) {
  return launch<__nv_bfloat16>(dt, Bc, Cc, x, A, h0, y, h, scratch, chunked,
                               B, S, Di, N, strides, stream);
}

}  // extern "C"
