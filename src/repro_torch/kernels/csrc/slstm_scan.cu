// sLSTM recurrence (the xLSTM scalar memory) on Hopper (sm_90a), written by
// hand in CUDA C++.
//
// Replaces the Pallas kernel slstm_scan / _slstm_kernel of
// repro/kernels/slstm_scan.py.  Per (batch, head), from h = c = n = 0:
//
//   g_t = xg_t + h_{t-1} @ r_h          (4dh gate columns, [z, i, f, o])
//   z = tanh(g_z); i, f, o = sigmoid(g_i), sigmoid(g_f), sigmoid(g_o)
//   c_t = f c + i z;  n_t = f n + i;  h_t = o c_t / max(n_t, 1e-6)
//
// out_t = h_t in xg's type; state and products in fp32, r read in its own
// type and widened.  Unlike the Pallas kernel it also writes the final
// (h, c, n), which the model's prefill hands to decode, and it takes any S
// (the Pallas kernel needs S to be a multiple of its 256-step chunk).
//
// What bounds it: per step a (batch, head) does a dh x 4dh matrix-vector
// product, 2 dh 4dh operations, on a vector that the previous step just
// produced, so the S steps are a dependent chain and the operations (not
// the bytes: xg and out are read and written once) bound it in principle.
// The Pallas kernel keeps r_h resident in VMEM.  Here r_h does not fit an
// SM: at xLSTM-1.3B (dh = 512) it is 512 x 2048, 2 MiB in bf16 and 4 MiB in
// fp32, against 227 KB of shared memory.  So every step streams r_h from
// the L2 cache (all heads together are 8 MiB in bf16, which the 50 MB L2
// keeps), and one SM's L2 bandwidth, not its arithmetic, is what this
// simple design runs at.
//
// Design:
//   * One block per (batch, head) of 1024 threads.  h lives in shared
//     memory; c and n live in the registers of the thread that owns the
//     lane (dh <= 1024 lanes, one a thread).
//   * Phase 1 of a step: each thread owns V neighbouring gate columns
//     (V = 16 bytes of r: 8 in bf16, 4 in fp32) and a contiguous slice of
//     the dh rows of r_h, so its loads are 16 bytes and a warp's are
//     neighbouring; the KG row slices' partial sums go to shared memory.
//     The lane's four xg values for the step are loaded before the product
//     so their latency hides under it.
//   * __syncthreads(); phase 2: each lane sums its gates' KG partials in a
//     fixed order, adds xg, updates (c, n, h), writes out_t;
//     __syncthreads().  Each step needs all of h before any column of the
//     next step can start, hence the two barriers.
// Splitting r_h over a thread-block cluster (distributed shared memory) or
// running the product on the tensor cores is later work.
//
// The C function launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDh = kThreads;     // one lane per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}
// One 16-byte load of r widened to fp32: V columns.
template <typename TR> struct Wide;
template <> struct Wide<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& q, float* w) {
    w[0] = __uint_as_float(q.x);
    w[1] = __uint_as_float(q.y);
    w[2] = __uint_as_float(q.z);
    w[3] = __uint_as_float(q.w);
  }
};
template <> struct Wide<__nv_bfloat16> {
  static constexpr int V = 8;
  // a bf16 is the high half of the fp32 of the same value
  __device__ static void unpack(const uint4& q, float* w) {
    const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[2 * j] = __uint_as_float(u[j] << 16);
      w[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// Number of row slices KG for ncv column vectors: as many as keep every
// thread busy, at most 8.
__host__ __device__ inline int row_slices(int ncv) {
  int kg = kThreads / ncv;
  return kg < 1 ? 1 : (kg > 8 ? 8 : kg);
}

// xg: (B, S, 4d) with the 4d axis [z, i, f, o] x (H, dh); r: (H, dh, 4dh);
// out: (B, S, d) in TX; h_out, c_out, n_out: (B, d) fp32.  All contiguous.
template <typename TX, typename TR>
__global__ void __launch_bounds__(kThreads)
slstm_scan_kernel(const TX* __restrict__ xg, const TR* __restrict__ r,
                  TX* __restrict__ out, float* __restrict__ h_out,
                  float* __restrict__ c_out, float* __restrict__ n_out,
                  int S, int H, int dh) {
  constexpr int V = Wide<TR>::V;           // columns per 16-byte load
  extern __shared__ float smem[];
  const int G4 = 4 * dh;                   // gate columns of a head
  const int ncv = G4 / V;                  // column vectors
  const int KG = row_slices(ncv);
  const int rows = (dh + KG - 1) / KG;     // rows of r_h per slice
  float* sh = smem;                        // [dh]       h_{t-1}
  float* part = smem + dh;                 // [KG][4dh]  partial products

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int d = H * dh;
  const int tid = threadIdx.x;
  const TR* rh = r + static_cast<long long>(hd) * dh * G4;

  // phase-1 role: column vector cv over rows [k0, k1), if tid < ncv * KG
  const int cv = tid % ncv;
  const int kg = tid / ncv;
  const int k0 = kg * rows;
  const int k1 = min(dh, k0 + rows);
  const bool dots = kg < KG;
  // phase-2 role: lane tid, if tid < dh
  const bool lane = tid < dh;
  float c = 0.f, n = 0.f;
  if (lane) sh[tid] = 0.f;
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    const long long row = static_cast<long long>(b) * S + t;
    float xz = 0.f, xi = 0.f, xf = 0.f, xo = 0.f;
    if (lane) {
      const TX* x = xg + row * 4 * d + hd * dh + tid;
      xz = to_f(x[0]);
      xi = to_f(x[d]);
      xf = to_f(x[2 * d]);
      xo = to_f(x[3 * d]);
    }
    if (dots) {
      float acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      const TR* col = rh + cv * V;
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        float w[V];
        Wide<TR>::unpack(__ldg(reinterpret_cast<const uint4*>(
                             col + static_cast<long long>(k) * G4)), w);
        const float hk = sh[k];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(hk, w[v], acc[v]);
      }
      float* p = part + kg * G4 + cv * V;
#pragma unroll
      for (int v = 0; v < V; ++v) p[v] = acc[v];
    }
    __syncthreads();
    if (lane) {
      float gz = 0.f, gi = 0.f, gf = 0.f, go = 0.f;
      for (int s = 0; s < KG; ++s) {
        const float* p = part + s * G4 + tid;
        gz += p[0];
        gi += p[dh];
        gf += p[2 * dh];
        go += p[3 * dh];
      }
      const float z = tanhf(xz + gz);
      const float i = sigmoidf(xi + gi);
      const float f = sigmoidf(xf + gf);
      const float o = sigmoidf(xo + go);
      c = f * c + i * z;
      n = f * n + i;
      const float h = o * c / fmaxf(n, 1e-6f);
      sh[tid] = h;
      from_f(h, out + row * d + hd * dh + tid);
    }
    __syncthreads();
  }
  if (lane) {
    const long long at = static_cast<long long>(b) * d + hd * dh + tid;
    h_out[at] = sh[tid];
    c_out[at] = c;
    n_out[at] = n;
  }
}

template <typename TX, typename TR>
cudaError_t launch(const void* xg, const void* r, void* out, float* h_out,
                   float* c_out, float* n_out, int B, int S, int H, int dh,
                   cudaStream_t stream) {
  constexpr int V = Wide<TR>::V;
  if ((4 * dh) % V) return cudaErrorInvalidValue;
  const int KG = row_slices(4 * dh / V);
  const size_t smem = sizeof(float) * (dh + static_cast<size_t>(KG) * 4 * dh);
  cudaError_t err = cudaFuncSetAttribute(
      slstm_scan_kernel<TX, TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  slstm_scan_kernel<TX, TR><<<B * H, kThreads, smem, stream>>>(
      static_cast<const TX*>(xg), static_cast<const TR*>(r),
      static_cast<TX*>(out), h_out, c_out, n_out, S, H, dh);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// See slstm_scan_kernel for the layouts.  x_bf16 / r_bf16: 1 for bf16, 0
// for fp32.  1 <= dh <= 1024, 4 dh a multiple of 16 bytes of r's type.
int slstm_scan_launch(const void* xg, const void* r, void* out, void* h_out,
                      void* c_out, void* n_out, int x_bf16, int r_bf16, int B,
                      int S, int H, int dh, void* stream) {
  if (dh < 1 || dh > kMaxDh || H < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hf = static_cast<float*>(h_out);
  float* cf = static_cast<float*>(c_out);
  float* nf = static_cast<float*>(n_out);
  cudaError_t err;
  if (x_bf16 && r_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(xg, r, out, hf, cf, nf, B, S,
                                               H, dh, s);
  else if (x_bf16)
    err = launch<__nv_bfloat16, float>(xg, r, out, hf, cf, nf, B, S, H, dh,
                                       s);
  else if (r_bf16)
    err = launch<float, __nv_bfloat16>(xg, r, out, hf, cf, nf, B, S, H, dh,
                                       s);
  else
    err = launch<float, float>(xg, r, out, hf, cf, nf, B, S, H, dh, s);
  return static_cast<int>(err);
}

}  // extern "C"
