// Flash-decode attention for Hopper (sm_90a): one query token per row
// against a heads-major KV cache, split-K over the cache length.
//
// Replaces the Pallas TPU kernel `flash_decode_attention`
// (src/repro/kernels/flash_decode.py, `_decode_kernel`).  It computes the
// same function: for every (batch row b, KV head kh) the G = H / KH query
// heads of the GQA group attend to keys [0, min(pos, S)) with an online
// softmax in f32 and scale 1/sqrt(D); rows with pos <= 0 return exact zeros.
//
// What bounds it on this card: it reads 2 * B * KH * min(pos, S) * D cache
// elements once and does ~4 flops per element, far below the card's ~295
// flops per byte, so it is bound by device-memory bytes.  The Pallas grid
// walks the cache blocks in order on one core; here B * KH is 2 for the
// served model, so the cache length is split across blocks instead:
//
//   pass 1 (decode_split_kernel), grid (B * KH, n_split): each block keeps
//     the group's G query rows in shared memory, walks its slice of the
//     valid prefix in tiles of kTileK keys (16-byte loads along D), and
//     writes f32 partials (m, l, acc[G][D]).  A block whose slice lies
//     wholly past pos writes m = -inf and nothing else.  Dot products run
//     one per thread over bank-padded rows with four partial sums, the
//     softmax bookkeeping a warp per row, the PV update four keys at once.
//   pass 2 (decode_combine_kernel), grid (B * KH, G): one block per output
//     row computes the split weights once, then merges the partials in a
//     fixed order (deterministic), divides by max(l, 1e-30) and writes the
//     output in the input dtype.
//
// pos stays on the device: a length-1 (shared) or length-B (per-row) int32
// buffer read by both passes, so the host never waits on it.  The kernel
// launches on the stream it is given and allocates nothing; the caller
// passes the partial buffers.  A simple kernel that is right: wgmma and
// TMA are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileK = 32;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int N = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int N = 8; };

// 16 bytes of T from global memory -> f32 values in dst.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// Copies `n` rows of D values (T) into f32 shared memory rows of
// `stride` floats, 16 bytes a thread.
template <typename T>
__device__ __forceinline__ void load_rows(const T* src, float* dst, int n,
                                          int D, int stride) {
  constexpr int VN = VecWidth<T>::N;
  const int per_row = D / VN;
  float tmp[VN];
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c = (i % per_row) * VN;
    load16(src + (size_t)r * D + c, tmp);
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[r * stride + c + e] = tmp[e];
  }
}

__device__ __forceinline__ int valid_len(const int* pos, int per_row, int b,
                                         int S) {
  const int p = pos[per_row ? b : 0];
  return p < S ? p : S;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ pos, int per_row,
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int KH, int G, int S, int D, int chunk,
    int n_split, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;               // b * KH + kh
  const int split = blockIdx.y;
  const int valid = valid_len(pos, per_row, bh / KH, S);
  const int k0 = split * chunk;
  const int k1 = min(k0 + chunk, valid);
  const size_t prow = ((size_t)bh * n_split + split) * G;
  if (k0 >= k1) {                          // slice wholly past pos
    for (int g = threadIdx.x; g < G; g += kThreads) {
      part_m[prow + g] = -CUDART_INF_F;
      part_l[prow + g] = 0.f;
    }
    return;
  }
  // rows of q and K are padded to D + 1 floats, so the threads of a warp,
  // each on its own key, read distinct banks in the dot products
  const int DP = D + 1;
  float* qs = smem;                        // [G][DP]
  float* ks = qs + G * DP;                 // [kTileK][DP]
  float* vs = ks + kTileK * DP;            // [kTileK][D]
  float* acc = vs + kTileK * D;            // [G][D]
  float* sc = acc + G * D;                 // [G][kTileK] scores, then p
  float* ms = sc + G * kTileK;             // [G] running max
  float* ls = ms + G;                      // [G] running sum
  float* cs = ls + G;                      // [G] this tile's correction

  // q (B, 1, H, D): the group's G heads are contiguous at bh * G * D
  load_rows(q + (size_t)bh * G * D, qs, G, D, DP);
  for (int i = threadIdx.x; i < G * D; i += kThreads) acc[i] = 0.f;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    ms[g] = -CUDART_INF_F;
    ls[g] = 0.f;
  }
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int t0 = k0; t0 < k1; t0 += kTileK) {
    const int n = min(kTileK, k1 - t0);
    __syncthreads();                       // previous tile fully consumed
    load_rows(kb + (size_t)t0 * D, ks, n, D, DP);
    load_rows(vb + (size_t)t0 * D, vs, n, D, D);
    __syncthreads();
    // scores: one (row, key) dot product per thread, four partial sums
    for (int idx = threadIdx.x; idx < G * n; idx += kThreads) {
      const float* qr = qs + (idx / n) * DP;
      const float* kr = ks + (idx % n) * DP;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      for (int d = 0; d < D; d += 4) {     // D is a multiple of 4
        s0 += qr[d] * kr[d];
        s1 += qr[d + 1] * kr[d + 1];
        s2 += qr[d + 2] * kr[d + 2];
        s3 += qr[d + 3] * kr[d + 3];
      }
      sc[(idx / n) * kTileK + idx % n] = ((s0 + s1) + (s2 + s3)) * scale;
    }
    __syncthreads();
    // online-softmax bookkeeping: one warp per row, one lane per key
    for (int g = warp; g < G; g += kWarps) {
      const float m_old = ms[g];
      const float s = lane < n ? sc[g * kTileK + lane] : -CUDART_INF_F;
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      if (lane < n) sc[g * kTileK + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
        cs[g] = corr;
      }
    }
    __syncthreads();
    // acc = acc * corr + p @ V, four keys in flight per element
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i % D;
      const float* pr = sc + g * kTileK;
      float a0 = acc[i] * cs[g], a1 = 0.f, a2 = 0.f, a3 = 0.f;
      int j = 0;
      for (; j + 3 < n; j += 4) {
        a0 += pr[j] * vs[j * D + d];
        a1 += pr[j + 1] * vs[(j + 1) * D + d];
        a2 += pr[j + 2] * vs[(j + 2) * D + d];
        a3 += pr[j + 3] * vs[(j + 3) * D + d];
      }
      for (; j < n; ++j) a0 += pr[j] * vs[j * D + d];
      acc[i] = (a0 + a1) + (a2 + a3);
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    part_m[prow + g] = ms[g];
    part_l[prow + g] = ls[g];
  }
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    part_acc[prow * D + i] = acc[i];
  }
}

// grid (B * KH, G): one block per output row.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const int* __restrict__ pos,
    int per_row, T* __restrict__ out, int KH, int G, int S, int D,
    int n_split) {
  extern __shared__ float w[];             // [n_split] merge weights
  __shared__ float total;
  const int bh = blockIdx.x;
  const int g = blockIdx.y;
  const int valid = valid_len(pos, per_row, bh / KH, S);
  T* ob = out + ((size_t)bh * G + g) * D;  // out (B, 1, H, D), like q
  if (valid <= 0) {                        // nothing to attend to
    for (int d = threadIdx.x; d < D; d += kThreads) store(ob + d, 0.f);
    return;
  }
  const size_t r0 = (size_t)bh * n_split * G + g;   // split s: r0 + s * G
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = -CUDART_INF_F;
    for (int s = lane; s < n_split; s += 32) m = fmaxf(m, part_m[r0 + s * G]);
    m = warp_max(m);
    float l = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float ms = part_m[r0 + s * G];
      // an empty slice wrote no partials: weight 0, skipped below
      const float ws = ms == -CUDART_INF_F ? 0.f : expf(ms - m);
      w[s] = ws;
      if (ws != 0.f) l += part_l[r0 + s * G] * ws;
    }
    l = warp_sum(l);
    if (lane == 0) total = l;
  }
  __syncthreads();
  const float denom = fmaxf(total, 1e-30f);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float ws = w[s];
      if (ws != 0.f) a += part_acc[(r0 + (size_t)s * G) * D + d] * ws;
    }
    store(ob + d, a / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos,
           int per_row, void* out, float* part_m, float* part_l,
           float* part_acc, int B, int H, int KH, int S, int D, int chunk,
           int n_split, float scale, void* stream) {
  const int G = H / KH;
  const size_t smem =
      sizeof(float) * ((size_t)G * (D + 1) + kTileK * (D + 1) + kTileK * D +
                       (size_t)G * D + G * kTileK + 3 * G);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_split_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid1(B * KH, n_split);
  decode_split_kernel<T><<<grid1, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, per_row, part_m, part_l, part_acc, KH, G,
      S, D, chunk, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(B * KH, G);
  decode_combine_kernel<T><<<grid2, kThreads, sizeof(float) * n_split, st>>>(
      part_m, part_l, part_acc, pos, per_row, static_cast<T*>(out), KH, G, S,
      D, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  Pointers are device pointers,
// `stream` a cudaStream_t; shapes were checked by the Python wrapper.
int flash_decode_f32(const void* q, const void* k, const void* v,
                     const int* pos, int per_row, void* out, float* part_m,
                     float* part_l, float* part_acc, int B, int H, int KH,
                     int S, int D, int chunk, int n_split, float scale,
                     void* stream) {
  return launch<float>(q, k, v, pos, per_row, out, part_m, part_l, part_acc,
                       B, H, KH, S, D, chunk, n_split, scale, stream);
}

int flash_decode_bf16(const void* q, const void* k, const void* v,
                      const int* pos, int per_row, void* out, float* part_m,
                      float* part_l, float* part_acc, int B, int H, int KH,
                      int S, int D, int chunk, int n_split, float scale,
                      void* stream) {
  return launch<__nv_bfloat16>(q, k, v, pos, per_row, out, part_m, part_l,
                               part_acc, B, H, KH, S, D, chunk, n_split, scale,
                               stream);
}

}  // extern "C"
