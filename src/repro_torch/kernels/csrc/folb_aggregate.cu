// Fused FOLB aggregation on Hopper (sm_90a): the three streaming passes of
// repro/kernels/folb_aggregate.py, written by hand in CUDA C++.
//
//   folb_scores  (replaces the Pallas kernel folb_scores / _scores_kernel)
//       inner[k] = sum_d grads[k, d] * g1[d], fp32 accumulation.
//   folb_apply   (replaces the Pallas kernel folb_apply / _apply_kernel)
//       out[d] = w[d] + sum_k weights[k] * deltas[k, d], fp32 arithmetic.
//   guard_stats  (replaces the Pallas kernel guard_stats /
//                 _guard_stats_kernel)
//       norms_sq[k] = sum_d (isfinite(deltas[k, d]) ? deltas[k, d] : 0)^2,
//       finite[k]   = 1.0 iff every deltas[k, :] and grads[k, :] lane is
//                     finite, else 0.0.
//
// What bounds them: all three are streaming passes with about one
// multiply-add per element read (K*D elements of bf16 or fp32), far below
// the card's ratio of operations to bytes, so device-memory bandwidth
// bounds them; at the paper's shapes (K = 10, D_pad <= 114,688) a pass is
// a few microseconds and launch latency dominates.
//
// Design:
//   * Every thread loads 8 consecutive elements of a row with one 16-byte
//     load (bf16) or two (fp32); 128 threads cover one 1024-element tile,
//     the reference's TILE_D, so every row access is fully coalesced.
//   * The TPU kernel carries the (K,) sum across a sequential grid.  Hopper
//     runs blocks in no order, so folb_scores splits D over blocks (each a
//     grid-stride loop over tiles, g1 held in registers and reused for 8
//     rows at a time), writes one fp32 partial per (row, block), and a
//     second small kernel reduces the (K, n_blocks) partials in a fixed
//     order.  No float atomics: two launches on the same inputs give the
//     same bits.
//   * folb_apply keeps the K weights in shared memory and walks D in a
//     grid-stride loop; the K-term sum runs in fp32 in a fixed k order,
//     then adds w.
//   * guard_stats is laid out as folb_scores: per (row, block) it writes an
//     fp32 partial sum of squares and an integer count of non-finite
//     lanes, and a second kernel reduces them in a fixed order.  A lane is
//     non-finite when its exponent bits are all ones, tested on the fp32
//     value (bf16 upcasts exactly, so its NaN and Inf stay NaN and Inf);
//     the bit test cannot be folded away by any math flag.  A non-finite
//     delta lane is zeroed before it is squared, so NaN never reaches the
//     accumulator; a non-finite grad lane only clears the flag.
// The C functions launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;               // elements per tile
constexpr int kVec = 8;                   // elements per thread per tile
constexpr int kThreads = kTile / kVec;    // 128 threads: one tile per pass
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroup = 8;              // rows accumulated in registers
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// partial[k, b] = sum over block b's tiles of grads[k, tile] . g1[tile]
template <typename T>
__global__ void __launch_bounds__(kThreads)
scores_partial_kernel(const T* __restrict__ grads,
                      const float* __restrict__ g1,
                      float* __restrict__ partial, int K, int64_t D) {
  extern __shared__ float warp_sums[];    // [kWarps][K]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_tiles = D / kTile;
  const int64_t col = static_cast<int64_t>(threadIdx.x) * kVec;
  for (int k0 = 0; k0 < K; k0 += kRowGroup) {
    float acc[kRowGroup];
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) acc[j] = 0.f;
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t d = t * kTile + col;
      float g[kVec];
      load8(g1 + d, g);
#pragma unroll
      for (int j = 0; j < kRowGroup; ++j) {
        if (k0 + j < K) {
          float x[kVec];
          load8(grads + static_cast<int64_t>(k0 + j) * D + d, x);
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[j] = fmaf(x[i], g[i], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) {
      float s = acc[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0 && k0 + j < K) warp_sums[warp * K + k0 + j] = s;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w * K + k];
    partial[static_cast<int64_t>(k) * gridDim.x + blockIdx.x] = s;
  }
}

// out[k] = sum_b partial[k, b], one block per row, fixed summation order
__global__ void __launch_bounds__(kReduceThreads)
scores_reduce_kernel(const float* __restrict__ partial,
                     float* __restrict__ out, int n_parts) {
  __shared__ float buf[kReduceThreads];
  const int k = blockIdx.x;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_parts; i += kReduceThreads)
    s += partial[static_cast<int64_t>(k) * n_parts + i];
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = buf[0];
}

// out = w + sum_k weights[k] * deltas[k], fp32, k in fixed order
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ w, const T* __restrict__ deltas,
             const float* __restrict__ weights, float* __restrict__ out,
             int K, int64_t D) {
  extern __shared__ float wk[];           // [K]
  for (int k = threadIdx.x; k < K; k += kThreads) wk[k] = weights[k];
  __syncthreads();
  const int64_t n_vec = D / kVec;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       v < n_vec; v += step) {
    const int64_t d = v * kVec;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      float x[kVec];
      load8(deltas + static_cast<int64_t>(k) * D + d, x);
      const float c = wk[k];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(c, x[i], acc[i]);
    }
    float base[kVec];
    load8(w + d, base);
    float4* o = reinterpret_cast<float4*>(out + d);
    o[0] = make_float4(base[0] + acc[0], base[1] + acc[1],
                       base[2] + acc[2], base[3] + acc[3]);
    o[1] = make_float4(base[4] + acc[4], base[5] + acc[5],
                       base[6] + acc[6], base[7] + acc[7]);
  }
}

__device__ __forceinline__ bool finite_bits(float x) {
  return (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
}

// norm_part[k, b] = sum over block b's tiles of where(finite(d), d, 0)^2,
// bad_part[k, b]  = count of non-finite lanes of d and g in those tiles
template <typename T>
__global__ void __launch_bounds__(kThreads)
guard_partial_kernel(const T* __restrict__ deltas, const T* __restrict__ grads,
                     float* __restrict__ norm_part,
                     int* __restrict__ bad_part, int K, int64_t D) {
  __shared__ float warp_norm[kWarps][kRowGroup];
  __shared__ int warp_bad[kWarps][kRowGroup];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_tiles = D / kTile;
  const int64_t col = static_cast<int64_t>(threadIdx.x) * kVec;
  for (int k0 = 0; k0 < K; k0 += kRowGroup) {
    float acc[kRowGroup];
    int bad[kRowGroup];
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) { acc[j] = 0.f; bad[j] = 0; }
    for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int64_t d = t * kTile + col;
#pragma unroll
      for (int j = 0; j < kRowGroup; ++j) {
        if (k0 + j < K) {
          const int64_t off = static_cast<int64_t>(k0 + j) * D + d;
          float x[kVec], g[kVec];
          load8(deltas + off, x);
          load8(grads + off, g);
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const bool fx = finite_bits(x[i]);
            bad[j] += (fx ? 0 : 1) + (finite_bits(g[i]) ? 0 : 1);
            const float v = fx ? x[i] : 0.f;
            acc[j] = fmaf(v, v, acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRowGroup; ++j) {
      float s = acc[j];
      int b = bad[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, off);
        b += __shfl_down_sync(0xffffffffu, b, off);
      }
      if (lane == 0) { warp_norm[warp][j] = s; warp_bad[warp][j] = b; }
    }
    __syncthreads();
    const int j = threadIdx.x;
    if (j < kRowGroup && k0 + j < K) {
      float s = 0.f;
      int b = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s += warp_norm[w][j];
        b += warp_bad[w][j];
      }
      const int64_t idx =
          static_cast<int64_t>(k0 + j) * gridDim.x + blockIdx.x;
      norm_part[idx] = s;
      bad_part[idx] = b;
    }
    __syncthreads();
  }
}

// norms_sq[k] = sum_b norm_part[k, b] (fixed order), finite[k] = 1.0 iff
// no block saw a non-finite lane of row k; one block per row
__global__ void __launch_bounds__(kReduceThreads)
guard_reduce_kernel(const float* __restrict__ norm_part,
                    const int* __restrict__ bad_part,
                    float* __restrict__ norms_sq, float* __restrict__ finite,
                    int n_parts) {
  __shared__ float buf[kReduceThreads];
  __shared__ int any_bad;
  const int k = blockIdx.x;
  if (threadIdx.x == 0) any_bad = 0;
  __syncthreads();
  float s = 0.f;
  int b = 0;
  for (int i = threadIdx.x; i < n_parts; i += kReduceThreads) {
    const int64_t idx = static_cast<int64_t>(k) * n_parts + i;
    s += norm_part[idx];
    b |= bad_part[idx];
  }
  buf[threadIdx.x] = s;
  if (b) any_bad = 1;       // benign race: every writer stores 1
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    norms_sq[k] = buf[0];
    finite[k] = any_bad ? 0.f : 1.f;
  }
}

}  // namespace

extern "C" {

// grads (K, D) bf16 if grads_bf16 else fp32; g1 (D,) fp32; partial
// (K, n_blocks) fp32 scratch; out (K,) fp32.  D % 1024 == 0.
int folb_scores_launch(const void* grads, int grads_bf16, const float* g1,
                       float* partial, float* out, int K, long long D,
                       int n_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * kWarps * K;
  if (grads_bf16) {
    scores_partial_kernel<__nv_bfloat16><<<n_blocks, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(grads), g1, partial, K, D);
  } else {
    scores_partial_kernel<float><<<n_blocks, kThreads, smem, s>>>(
        static_cast<const float*>(grads), g1, partial, K, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scores_reduce_kernel<<<K, kReduceThreads, 0, s>>>(partial, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// w (D,) fp32; deltas (K, D) bf16 if deltas_bf16 else fp32; weights (K,)
// fp32; out (D,) fp32.  D % 1024 == 0.
int folb_apply_launch(const float* w, const void* deltas, int deltas_bf16,
                      const float* weights, float* out, int K, long long D,
                      int n_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * K;
  if (deltas_bf16) {
    apply_kernel<__nv_bfloat16><<<n_blocks, kThreads, smem, s>>>(
        w, static_cast<const __nv_bfloat16*>(deltas), weights, out, K, D);
  } else {
    apply_kernel<float><<<n_blocks, kThreads, smem, s>>>(
        w, static_cast<const float*>(deltas), weights, out, K, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// deltas, grads (K, D), both bf16 if bf16 else fp32; norm_part (K,
// n_blocks) fp32 and bad_part (K, n_blocks) int32 scratch; norms_sq,
// finite (K,) fp32.  D % 1024 == 0.
int guard_stats_launch(const void* deltas, const void* grads, int bf16,
                       float* norm_part, int* bad_part, float* norms_sq,
                       float* finite, int K, long long D, int n_blocks,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    guard_partial_kernel<__nv_bfloat16><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(deltas),
        static_cast<const __nv_bfloat16*>(grads), norm_part, bad_part, K, D);
  } else {
    guard_partial_kernel<float><<<n_blocks, kThreads, 0, s>>>(
        static_cast<const float*>(deltas), static_cast<const float*>(grads),
        norm_part, bad_part, K, D);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  guard_reduce_kernel<<<K, kReduceThreads, 0, s>>>(norm_part, bad_part,
                                                   norms_sq, finite, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
