// Fused FOLB aggregation on Hopper (sm_90a): the two streaming passes of
// repro/kernels/folb_aggregate.py, written by hand in CUDA C++.
//
//   folb_scores  (replaces the Pallas kernel folb_scores / _scores_kernel)
//       inner[k] = sum_d grads[k, d] * g1[d], fp32 accumulation.
//   folb_apply   (replaces the Pallas kernel folb_apply / _apply_kernel)
//       out[d] = w[d] + sum_k weights[k] * deltas[k, d], fp32 arithmetic.
//
// What bounds them: both are streaming passes with about one multiply-add
// per element read (K*D elements of bf16 or fp32), far below the card's
// ratio of operations to bytes, so device-memory bandwidth bounds them; at
// the paper's shapes (K = 10, D_pad <= 114,688) the whole pass is a few
// microseconds and launch latency dominates.
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

}  // extern "C"
