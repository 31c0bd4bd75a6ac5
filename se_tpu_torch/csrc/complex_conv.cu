// The DCCRN encoder's causal complex convolution, forward, for Hopper
// (sm_90a): K4.
//
// Replaces the Pallas kernel of `fused_complex_conv2d` in
// se_tpu/ops/pallas_conv.py (_kernel and _pallas_conv, :46-149).  One
// launch runs a stage's four real products at once over the doubled batch
// (rows 0..B-1 the real part, B..2B-1 the imaginary part; the wrapper in
// ops/fused_conv.py stacks the real and imaginary filters along Co):
//
//   x [B2, C, F, T] f32 (F even)   w [Co, C, 5, 2] f32   b [Co] f32
//   y[n, o, f, t] = b[o] + sum over (c, kf, kt) of
//                   w[o, c, kf, kt] * x[n, c, 2 f + kf - 2, t + kt - 1]
//   -> y [B2, Co, F / 2, T] f32
//
// with x read as 0 at frequencies outside [0, F) (padding 2 on both sides)
// and at frame -1 (the causal time padding).  The padding is a masked
// load: no padded copy of x is made, and Co is not padded.
//
// What bounds it.  An implicit GEMM of M = B2 * F/2 * T output positions
// by N = Co channels over K = 10 C.  At the six encoder stages of the
// default DCCRN at B = 8 x 3 s (B2 = 16, T = 483), 132.3 GFLOP, 1.98 ms at
// 67 TFLOP/s f32, against about 0.6 GB read and written (0.2 ms at 3.35
// TB/s): bound by operations, except the first stage (C = 1, K = 10),
// which is bound by its writes.
//
// Design.  A first, simple kernel (no tensor cores, no TMA): each block
// owns kTM consecutive output positions of one batch row (position m =
// f * T + t, so a tile may span two bins) by kTN output channels, with
// 256 threads each holding a 4 x 4 register tile.  K runs through shared
// memory in chunks of kBK rows; row k is (c, kf, kt) = (k / 10, k % 10 / 2,
// k % 2), the layout of w, so the weight chunk is a plain slice of w's
// rows.  Each thread gathers four im2col values of a chunk straight from x
// (coalesced along t) and four weight values, into registers while the
// block computes on the previous chunk.  Sums run over k in order and then
// add the bias, with no atomics: two calls give the same bits.
//
// The bf16 form (pallas_conv.py:74-81, :122-123): x, w, b and y bf16 (the
// wrapper casts the f32 master weights to bf16, as _pallas_conv does).
// The prefetched values stay bf16 in registers and are converted to f32
// as they are stored to shared memory (converted at the load, the thread
// waited for its loads before computing on the previous chunk: 18% slower,
// PERF.md); the products are summed in f32, the bias is added in f32 and y
// is rounded to bf16 once, at the store, as the Pallas kernel's `(acc +
// b).astype(...)`.  The element type is a template argument: ldg, to_f32
// and zero_of are __ldg, the identity and 0 for float, so the f32 form
// compiles as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "error_string.cuh"

namespace {

constexpr int kTaps = 10;       // the (5, 2) kernel
constexpr int kTM = 64;         // output positions a block
constexpr int kTN = 64;         // output channels a block
constexpr int kBK = 16;         // rows of K a shared-memory chunk
constexpr int kThreads = 256;   // 16 x 16, each 4 positions x 4 channels
constexpr int kLdw = kTN + 4;   // padded row of the weight chunk: 2-way store conflicts, aligned float4 reads

// An element read through the read-only cache (bf16: its 16 bits loaded as
// an unsigned short), an element as f32, an element's zero, and an f32 value
// stored as an element (bf16: rounded to nearest even).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ __nv_bfloat16 ldg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T zero_of() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX = float>
__global__ void __launch_bounds__(kThreads)
complex_conv_fwd_kernel(const TX* __restrict__ x, const TX* __restrict__ w,
                        const TX* __restrict__ b, TX* __restrict__ y,
                        int C, int F, int T, int Co) {
  __shared__ __align__(16) float a_s[kBK][kTM];   // [k][position]
  __shared__ __align__(16) float w_s[kBK][kLdw];  // [k][channel]
  const int M = F / 2 * T;  // output positions of one batch row
  const int K = kTaps * C;
  const int n = blockIdx.z;
  const int m0 = blockIdx.x * kTM, o0 = blockIdx.y * kTN;
  const int tid = threadIdx.x;
  const TX* xn = x + static_cast<size_t>(n) * C * F * T;

  // this thread's loads of a chunk: the im2col values of position m0 + am
  // at rows ak + 4 q, and the weights of channel o0 + wo + 16 q at row wk
  const int am = tid % kTM, ak = tid / kTM;
  const int wk = tid % kBK, wo = tid / kBK;
  const int m = m0 + am;
  const bool m_ok = m < M;
  const int fo = m_ok ? m / T : 0, t = m_ok ? m % T : 0;
  TX a_r[4], w_r[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + ak + 4 * q;
      TX v = zero_of<TX>();
      if (m_ok && k < K) {
        const int c = k / kTaps, tap = k - c * kTaps;
        const int f = 2 * fo + (tap >> 1) - 2;
        const int tt = t + (tap & 1) - 1;
        if (f >= 0 && f < F && tt >= 0) v = ldg(xn + (static_cast<size_t>(c) * F + f) * T + tt);
      }
      a_r[q] = v;
      const int o = o0 + wo + 16 * q, kw = k0 + wk;
      w_r[q] = (o < Co && kw < K) ? ldg(w + static_cast<size_t>(o) * K + kw) : zero_of<TX>();
    }
  };

  const int tm = tid % 16, tn = tid / 16;  // positions 4 tm.., channels 4 tn..
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  load(0);
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a_s[ak + 4 * q][am] = to_f32(a_r[q]);
      w_s[wk][wo + 16 * q] = to_f32(w_r[q]);
    }
    __syncthreads();
    if (k0 + kBK < K) load(k0 + kBK);  // in flight while the block computes
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][4 * tm]);
      const float4 wv = *reinterpret_cast<const float4*>(&w_s[kk][4 * tn]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: + bias; a channel's positions are contiguous in y
  const int mb = m0 + 4 * tm;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + 4 * tn + j;
    if (o >= Co || mb >= M) continue;
    const float bv = to_f32(ldg(b + o));
    TX* yo = y + (static_cast<size_t>(n) * Co + o) * M;
    if ((M & 3) == 0) {  // mb is a multiple of 4 below M: four aligned positions
      if constexpr (std::is_same<TX, float>::value) {
        *reinterpret_cast<float4*>(yo + mb) =
            make_float4(acc[0][j] + bv, acc[1][j] + bv, acc[2][j] + bv, acc[3][j] + bv);
      } else {
        __nv_bfloat162* y2 = reinterpret_cast<__nv_bfloat162*>(yo + mb);
        y2[0] = __floats2bfloat162_rn(acc[0][j] + bv, acc[1][j] + bv);
        y2[1] = __floats2bfloat162_rn(acc[2][j] + bv, acc[3][j] + bv);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (mb + i < M) store_as(yo + mb + i, acc[i][j] + bv);
      }
    }
  }
}

template <typename TX>
int conv_fwd(const TX* x, const TX* w, const TX* b, TX* y, int B2, int C, int F, int T,
             int Co, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = F / 2 * T;
  const dim3 grid((M + kTM - 1) / kTM, (Co + kTN - 1) / kTN, B2);
  complex_conv_fwd_kernel<TX><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, y, C, F, T, Co);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the conv on `stream` (a cudaStream_t) of `device`.  Every
// pointer is a device pointer to a contiguous f32 array of the shapes above
// (y [B2, Co, F / 2, T]); F must be even.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int se_complex_conv_fwd_f32(const float* x, const float* w, const float* b,
                                       float* y, int B2, int C, int F, int T, int Co,
                                       int device, void* stream) {
  return conv_fwd(x, w, b, y, B2, C, F, T, Co, device, stream);
}

// The bf16 form: x, w, b and y bf16 (the products summed in f32, y rounded
// once), shapes as se_complex_conv_fwd_f32.
extern "C" int se_complex_conv_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                        const __nv_bfloat16* b, __nv_bfloat16* y,
                                        int B2, int C, int F, int T, int Co,
                                        int device, void* stream) {
  return conv_fwd(x, w, b, y, B2, C, F, T, Co, device, stream);
}
