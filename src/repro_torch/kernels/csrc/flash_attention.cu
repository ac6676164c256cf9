// Blockwise flash attention on Hopper (sm_90a), written by hand in CUDA C++.
//
// Replaces the Pallas kernel flash_attention / _flash_kernel of
// repro/kernels/flash_attention.py: online-softmax attention with a causal
// and/or sliding-window mask and GQA (q head h reads kv head h / (H / KV)).
//
//   o[b, i, h, :] = sum_j softmax_j(q_i . k_j * d^-1/2 over live j) v_j
//
// Numerics follow the Pallas kernel: q is scaled by d^-1/2 as it is loaded,
// the running max m, normaliser l and accumulator acc are fp32, a masked
// score is -1e30 (not -inf, so a row whose every key in a live tile is
// masked gives exp(0) terms that the first real key's alpha = exp(-1e30 - m)
// wipes out, where -inf would give NaN), and the output is
// acc / max(l, 1e-30) in q's dtype.  Key tiles that the mask leaves empty
// for the whole query tile are skipped, as the Pallas kernel's pl.when does.
// Unlike it, any Sq and Sk are taken: keys past Sk contribute nothing and
// rows past Sq are not stored.
//
// What bounds it: at the serving shapes (S = 512, d = 64..256) each query
// tile does 4*BK*d operations per key read, well above the card's ratio of
// operations to bytes, so arithmetic bounds it.  This first version runs
// those operations on the fp32 CUDA cores (67 TFLOP/s), not the tensor
// cores; wgmma tiles are later work.
//
// Design:
//   * One block of 256 threads per (64-row query tile, head, batch).  The
//     q tile, one 64-row k tile, one v tile (all fp32) and the 64x64 tile of
//     probabilities sit in dynamic shared memory: 214 KB at d = 256, the
//     widest head in the zoo (Gemma), 77 KB at d = 80 (Zamba2).
//   * Thread (ty, tx), ty, tx in 0..15, owns query rows 4*ty..4*ty+3: for
//     scores the keys tx + 16*j (j < 4), for the output the head dims
//     tx + 16*j (j < DJ, DJ = ceil(d / 16) rounded to 4, 8 or 16).  The 16
//     threads of a row are 16 neighbouring lanes of one warp, so row max
//     and row sum are 4-step xor shuffles.  Row strides in shared memory are
//     odd, so the 16 key rows a warp reads fall in distinct banks.
//   * q, k and v are read in the model's (B, S, heads, d) layout through
//     their strides (the head dim contiguous); no transposed copy is made.
// The C function launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kLdP = kBK + 1;      // padded row of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;                       // (B, Sq, H, d), contiguous
  long long q_sb, q_ss, q_sh;    // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int Sq, Sk, H, KV, d;
  int causal, window;
  float scale;
};

__host__ __device__ inline int padded_ld(int d) { return (d % 2) ? d : d + 1; }

inline size_t smem_bytes(int d) {
  const int ld = padded_ld(d);
  return sizeof(float) * (size_t)(2 * kBQ * ld + kBK * d + kBQ * kLdP);
}

template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d;
  const int ld = padded_ld(d);
  float* sQ = smem;                 // [kBQ][ld]
  float* sK = sQ + kBQ * ld;        // [kBK][ld]
  float* sV = sK + kBK * ld;        // [kBK][d]
  float* sP = sV + kBK * d;         // [kBQ][kLdP]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, e = i - r * d;
    const int s = q0 + r;
    sQ[r * ld + e] = s < a.Sq ? to_f(q[s * a.q_ss + e]) * a.scale : 0.f;
  }

  // key range that some row of this query tile may attend to
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  int k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(k_end, q_last + 1);
  if (a.window) k_begin = max(0, q0 - a.window + 1);
  const int kt_begin = k_begin / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile's sK, sV and sP reads are done
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, e = i - r * d;
      const int s = k0 + r;
      const bool ok = s < a.Sk;
      sK[r * ld + e] = ok ? to_f(k[s * a.k_ss + e]) : 0.f;
      sV[r * d + e] = ok ? to_f(v[s * a.v_ss + e]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int e = 0; e < d; ++e) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(4 * ty + i) * ld + e];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = sK[(tx + 16 * j) * ld + e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], kb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool keep = kj < a.Sk;
        if (a.causal) keep = keep && kj <= qi;
        if (a.window) keep = keep && kj > qi - a.window;
        sc[i][j] = keep ? sc[i][j] : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // keys past Sk weigh nothing; masked keys weigh exp(-1e30 - m_new),
        // as in the Pallas kernel
        const float p = (k0 + tx + 16 * j < a.Sk) ? expf(sc[i][j] - m_new)
                                                  : 0.f;
        sP[(4 * ty + i) * kLdP + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(4 * ty + i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int e = tx + 16 * j;
        if (e < d) {
          const float vv = sV[c * d + e];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = o + ((static_cast<long long>(b) * a.Sq + qi) * a.H + h) * d;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int e = tx + 16 * j;
      if (e < d) store(row + e, acc[i][j] / denom);
    }
  }
}

template <typename T, int DJ>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_kernel<T, DJ><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 4>(a, B, stream);
  if (a.d <= 128) return launch<T, 8>(a, B, stream);
  return launch<T, 16>(a, B, stream);
}

}  // namespace

extern "C" {

// q: (B, Sq, H, d), k/v: (B, Sk, KV, d), bf16 (is_bf16 = 1) or fp32, each
// with the given batch/sequence/head strides in elements and the head dim
// contiguous; o: (B, Sq, H, d) contiguous, q's dtype.  d <= 256, H % KV == 0.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int is_bf16,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           int B, int Sq, int Sk, int H, int KV, int d,
                           int causal, int window, float scale,
                           void* stream) {
  if (d < 1 || d > 256 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return cudaSuccess;
  const Args a{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, Sq, Sk, H, KV, d, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? dispatch<__nv_bfloat16>(a, B, s)
                                  : dispatch<float>(a, B, s));
}

}  // extern "C"
