// SSD linear recurrence (the Mamba2 scan) on Hopper (sm_90a), written by
// hand in CUDA C++.
//
// Replaces the Pallas kernel ssd_scan / _ssd_kernel of
// repro/kernels/ssm_scan.py:
//
//   h_t = exp(loga_t) * h_{t-1} + w_t * x_t B_t^T      (h: (P, N), fp32)
//   y_t = h_t C_t
//
// per (batch, head), with h_0 = 0, and also writes the final state h_S,
// which the Pallas kernel keeps in VMEM and drops (decode needs it).
//
// Why not the Pallas kernel's shape: it holds a (T, T) fp32 decay matrix
// per chunk, 256 KB at the model's chunk T = 256, more than an SM's shared
// memory.  This kernel runs the recurrence step by step instead.  Row p of
// the state, h[p, :], depends only on x[:, p], so one thread owns one row:
// its N state values stay in registers for the whole sequence and y_t[p]
// is a dot product inside the thread, with no reduction across threads.
// The result is the function the chunked form computes, rounded in
// another order: the sequential oracle's order (kernels/ref.ssm_scan_ref).
//
// What bounds it: each step of a row does about 3N operations on P + 2N + 2
// inputs read once per (batch, head), so at P = N = 64 the work is a few
// operations per byte, and the bytes of x and y (fp32) bound it in
// principle; in practice the sequential dependence along S bounds it, since
// the card runs only B*H*P threads (20,480 at the Zamba2 serving shape).
//
// Design:
//   * One thread per row p.  The rows of a (batch, head) are split over
//     blocks of at most kMaxRows threads (blockIdx.y picks the slice), so
//     that a thread's N state registers fit at any P up to 1024: at N = 128
//     ptxas gives a thread up to about 170 registers, and 65,536 registers
//     hold 384 such threads, not 1024.  Rows never interact, so nothing
//     crosses blocks.  Steps are walked in tiles of kSteps: the tile's
//     x[., p] for the block's rows, B, C, exp(loga) and w are staged in
//     shared memory with coalesced loads, then every thread runs the tile's
//     steps from shared memory (B and C reads are broadcasts).
//   * B and C are read at group g = h / (H / G), so the model's B and C,
//     shared by all heads (G = 1), are read once per head and never
//     broadcast into a per-head copy.
//   * y is stored per step, a warp writing 32 neighbouring floats.
// The C function launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSteps = 32;          // steps staged per tile
constexpr int kMaxRows = 256;       // state rows (threads) per block

inline size_t smem_floats(int rows, int N) {
  return (size_t)kSteps * (rows + 2 * N + 2);
}

// x: (Bt, S, H, P); loga, w: (Bt, S, H); Bm, Cm: (Bt, S, G, N);
// y: (Bt, S, H, P); h_out: (Bt, H, P, N); all fp32, contiguous.
// Grid (Bt * H, ceil(P / blockDim.x)); block y owns rows
// [blockIdx.y * blockDim.x, ...) of head blockIdx.x.
template <int N>
__global__ void __launch_bounds__(kMaxRows)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ loga,
                const float* __restrict__ w, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                float* __restrict__ h_out, int S, int H, int P, int G) {
  extern __shared__ float smem[];
  const int rows = blockDim.x;
  float* sX = smem;                     // [kSteps][rows]
  float* sB = sX + kSteps * rows;       // [kSteps][N]
  float* sC = sB + kSteps * N;          // [kSteps][N]
  float* sDecay = sC + kSteps * N;      // [kSteps]  exp(loga)
  float* sW = sDecay + kSteps;          // [kSteps]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int hd = bh - b * H;
  const int g = hd / (H / G);
  const int p0 = blockIdx.y * rows;
  const int np = min(rows, P - p0);     // rows of this block that exist
  const int p = p0 + threadIdx.x;

  float h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) h[n] = 0.f;

  for (int t0 = 0; t0 < S; t0 += kSteps) {
    const int nt = min(kSteps, S - t0);
    __syncthreads();   // the previous tile's reads are done
    for (int i = threadIdx.x; i < nt * np; i += rows) {
      const int r = i / np, c = i - r * np;
      sX[r * rows + c] =
          x[((static_cast<long long>(b) * S + t0 + r) * H + hd) * P + p0 + c];
    }
    for (int i = threadIdx.x; i < nt * N; i += rows) {
      const int r = i / N, c = i - r * N;
      const long long at = ((static_cast<long long>(b) * S + t0 + r) * G + g)
                           * N + c;
      sB[i] = Bm[at];
      sC[i] = Cm[at];
    }
    for (int r = threadIdx.x; r < nt; r += rows) {
      const long long at = (static_cast<long long>(b) * S + t0 + r) * H + hd;
      sDecay[r] = expf(loga[at]);
      sW[r] = w[at];
    }
    __syncthreads();
    if (p < P) {
      for (int r = 0; r < nt; ++r) {
        const float decay = sDecay[r];
        const float wx = sW[r] * sX[r * rows + threadIdx.x];
        const float* Br = sB + r * N;
        const float* Cr = sC + r * N;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = fmaf(decay, h[n], wx * Br[n]);
          acc[n & 3] = fmaf(Cr[n], h[n], acc[n & 3]);
        }
        y[((static_cast<long long>(b) * S + t0 + r) * H + hd) * P + p] =
            (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
    }
  }
  if (p < P) {
    float* out = h_out + ((static_cast<long long>(b) * H + hd) * P + p) * N;
#pragma unroll
    for (int n = 0; n < N; ++n) out[n] = h[n];
  }
}

template <int N>
cudaError_t launch(const float* x, const float* loga, const float* w,
                   const float* Bm, const float* Cm, float* y, float* h_out,
                   int Bt, int S, int H, int P, int G, cudaStream_t stream) {
  const int p_warps = (P + 31) / 32 * 32;    // P rounded up to a warp
  const int rows = p_warps < kMaxRows ? p_warps : kMaxRows;
  const size_t smem = sizeof(float) * smem_floats(rows, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(Bt * H, (P + rows - 1) / rows);
  ssd_scan_kernel<N><<<grid, rows, smem, stream>>>(
      x, loga, w, Bm, Cm, y, h_out, S, H, P, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// See ssd_scan_kernel for the layouts.  N in {8, 16, 32, 64, 128},
// 1 <= P <= 1024, G divides H.
int ssd_scan_launch(const void* x, const void* loga, const void* w,
                    const void* Bm, const void* Cm, void* y, void* h_out,
                    int Bt, int S, int H, int P, int G, int N,
                    void* stream) {
  if (P < 1 || P > 1024 || G < 1 || H % G) return cudaErrorInvalidValue;
  if (Bt == 0 || H == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(loga);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_out);
  cudaError_t err;
  switch (N) {
    case 8: err = launch<8>(xf, af, wf, bf, cf, yf, hf, Bt, S, H, P, G, s);
      break;
    case 16: err = launch<16>(xf, af, wf, bf, cf, yf, hf, Bt, S, H, P, G, s);
      break;
    case 32: err = launch<32>(xf, af, wf, bf, cf, yf, hf, Bt, S, H, P, G, s);
      break;
    case 64: err = launch<64>(xf, af, wf, bf, cf, yf, hf, Bt, S, H, P, G, s);
      break;
    case 128:
      err = launch<128>(xf, af, wf, bf, cf, yf, hf, Bt, S, H, P, G, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
