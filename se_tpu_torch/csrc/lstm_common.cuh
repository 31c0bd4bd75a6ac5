// Device code shared by the recurrent kernels of lstm_scan.cu, lstm_inproj.cu
// and gru_inproj.cu: the row tile, the staging of a chunk's inputs, the gate
// products (h . W_hh per column, a chunk's x . W_ih), the gate math of one
// LSTM unit forward and backward, the dh pass of a reverse step, the
// deterministic dx, dW and dbias reductions over a gate-gradient scratch
// buffer; error_string.cuh adds the error-string export that each
// library's Python wrapper calls.  The products and the dh pass take the
// block's row count R as a template argument (K1 and K2 use kRows; K3
// also 8).
//
// The bf16-stream forms of K1 and K2 (pallas_lstm.py:13-14) read their
// input stream, ys and dys as bf16 and write ys and the input gradient as
// bf16; everything else stays f32.  The helpers that touch a stream take
// its element type as a template argument (float or __nv_bfloat16): to_f32
// and store_as convert at the load and the store, and are the identity for
// float, so an f32 instance compiles to the code it had before the type
// became a parameter.
//
// Transcendentals use expf/tanhf (no fast-math) to stay within 1e-5 of the
// plain PyTorch recurrence per step.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "error_string.cuh"

namespace {

constexpr int kRows = 4;   // batch rows per scan block; a row operand is read as one float4
constexpr int kTile = 32;  // dW tile edge and rows per reduction chunk

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A stream element as f32, and an f32 value stored into a stream (bf16:
// rounded to nearest even, as JAX's astype).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
constexpr bool kIsF32 = std::is_same<T, float>::value;

// xc_s[c][k][r] = x[t0 + c, l, b0 + r, k] for c < n and r < rows, else 0:
// the C steps of a chunk of the in-projection scans, R rows a block, staged
// as [C][In][R] so that a step's R rows at one k are adjacent; x is f32 or
// bf16, the staged copy f32.
template <int R, int C, typename TX = float>
__device__ __forceinline__ void stage_chunk(float* xc_s, const TX* __restrict__ x,
                                            int t0, int n, int L, int Bb, int l,
                                            int b0, int rows, int In) {
  for (int idx = threadIdx.x; idx < C * R * In; idx += blockDim.x) {
    const int c = idx / (R * In), r = (idx / In) % R, k = idx % In;
    float v = 0.f;
    if (c < n && r < rows) {
      v = to_f32(x[((static_cast<size_t>(t0 + c) * L + l) * Bb + b0 + r) * In + k]);
    }
    xc_s[(c * In + k) * R + r] = v;
  }
}

// dst[k][r] = src[r][k] for r < rows, 0 for the rows past the batch edge;
// src is `rows` consecutive rows of K values (f32 or bf16), dst f32.
template <int R, typename TS = float>
__device__ __forceinline__ void stage_rows(float* dst, const TS* __restrict__ src,
                                           int rows, int K) {
  for (int idx = threadIdx.x; idx < R * K; idx += blockDim.x) {
    const int r = idx / K, k = idx % K;
    dst[k * R + r] = r < rows ? to_f32(src[static_cast<size_t>(r) * K + k]) : 0.f;
  }
}

// acc[r] = fmaf(a[r], wv, acc[r]) for the R values of a (16-byte aligned,
// read as float4s).
template <int R>
__device__ __forceinline__ void fma_rows(const float* a, float wv, float* acc) {
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 av = *reinterpret_cast<const float4*>(a + 4 * q);
    acc[4 * q + 0] = fmaf(av.x, wv, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(av.y, wv, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(av.z, wv, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(av.w, wv, acc[4 * q + 3]);
  }
}

// acc[r] += sum_k a_s[k][r] * w[k][col] over k < K; a_s is [K][R].  w is
// read from global memory, coalesced across a warp whose threads hold
// consecutive columns; a_s gives the R rows at one k as R / 4 float4s.
template <int R = kRows>
__device__ __forceinline__ void dot_column(const float* __restrict__ w,
                                           const float* a_s, int K, int G,
                                           int col, float* acc) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    fma_rows<R>(a_s + k * R, __ldg(w + static_cast<size_t>(k) * G + col), acc);
  }
}

// g_s[r][col] = (g_s[r][col] + h_s[r] . whh[:, col]) + b[col] for the
// tile's kRows rows, g_s holding the step's x . W_ih; h_s is [H][kRows].
// The LSTM gate columns of K2 and of the wavefront probe (P2).
__device__ __forceinline__ void recurrent_columns(const float* __restrict__ whh,
                                                  const float* __restrict__ b,
                                                  const float* h_s, float* g_s,
                                                  int rows, int H, int G) {
  for (int col = threadIdx.x; col < G; col += blockDim.x) {
    float ah[kRows] = {0.f, 0.f, 0.f, 0.f};
    dot_column(whh, h_s, H, G, col, ah);
    const float bv = __ldg(b + col);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) g_s[r * G + col] = (g_s[r * G + col] + ah[r]) + bv;
    }
  }
}

// p_s[c][r][col] = xc_s[c][:][r] . wih[:, col] (+ bias[col] with kBias)
// for the C steps of a chunk of the in-projection scans: one pass over
// W_ih[l] forms them all.  xc_s is [C][In][R] (stage_chunk), p_s [C][R][G].
// kBias is a template argument, not a null test on `bias`: with the test,
// K3's forward ran 6% slower on an H100 (PERF.md).
template <int R, int C, bool kBias>
__device__ __forceinline__ void project_chunk(const float* __restrict__ wih,
                                              const float* __restrict__ bias,
                                              const float* xc_s, float* p_s,
                                              int In, int G) {
  for (int col = threadIdx.x; col < G; col += blockDim.x) {
    float acc[C][R];
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[c][r] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < In; ++k) {
      const float wv = __ldg(wih + static_cast<size_t>(k) * G + col);
#pragma unroll
      for (int c = 0; c < C; ++c) fma_rows<R>(xc_s + (c * In + k) * R, wv, acc[c]);
    }
    const float bv = kBias ? __ldg(bias + col) : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int r = 0; r < R; ++r) p_s[(c * R + r) * G + col] = kBias ? acc[c][r] + bv : acc[c][r];
    }
  }
}

// The cell update of unit j from a row of gate pre-activations g (4H, gate
// order i, f, g, o): returns c = f * c_prev + i * g and sets *h = o * tanh(c).
__device__ __forceinline__ float cell_forward(const float* g, int H, int j,
                                              float c_prev, float* h) {
  const float ig = sigmoid_f32(g[j]);
  const float fg = sigmoid_f32(g[H + j]);
  const float gg = tanhf(g[2 * H + j]);
  const float og = sigmoid_f32(g[3 * H + j]);
  const float c = fg * c_prev + ig * gg;
  *h = og * tanhf(c);
  return c;
}

// Its backward (pallas_lstm.py:118-131 and :373-386): from the row's gate
// pre-activations g, c_prev, the step's c, dh = dys[t] + the dh carry and
// the dc carry, writes the four dgates of unit j over g and into the row
// dg_out (both 4H); returns the dc carry of the step before, dc * f.
__device__ __forceinline__ float cell_backward(float* g, float* dg_out, int H,
                                               int j, float c_prev, float c,
                                               float dh, float dc_carry) {
  const float ig = sigmoid_f32(g[j]);
  const float fg = sigmoid_f32(g[H + j]);
  const float gg = tanhf(g[2 * H + j]);
  const float og = sigmoid_f32(g[3 * H + j]);
  const float tanh_c = tanhf(c);
  const float d_o = dh * tanh_c * og * (1.0f - og);
  const float dc = dc_carry + dh * og * (1.0f - tanh_c * tanh_c);
  const float d_i = dc * gg * ig * (1.0f - ig);
  const float d_f = dc * c_prev * fg * (1.0f - fg);
  const float d_g = dc * ig * (1.0f - gg * gg);
  g[j] = d_i;
  g[H + j] = d_f;
  g[2 * H + j] = d_g;
  g[3 * H + j] = d_o;
  dg_out[j] = d_i;
  dg_out[H + j] = d_f;
  dg_out[2 * H + j] = d_g;
  dg_out[3 * H + j] = d_o;
  return dc * fg;
}

// The dh carry of a reverse step: dh_s[r][k] = sum_g g_s[r][g] * w[k][g]
// (kAdd: dh_s[r][k] += that sum) for the tile's rows (g_s [R][G] holds the
// step's gate gradients, w is w_hh_t[l]), one warp per unit k: the lanes
// read row k of w along g, coalesced, and a shuffle reduction ends each sum.
template <int R = kRows, bool kAdd = false>
__device__ __forceinline__ void dh_rows(const float* __restrict__ w,
                                        const float* g_s, float* dh_s,
                                        int rows, int H, int G) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < H; k += nwarps) {
    const float* wk = w + static_cast<size_t>(k) * G;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int col = lane; col < G; col += 32) {
      const float wv = __ldg(wk + col);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(g_s[r * G + col], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane < rows) {
      float v = acc[0];
#pragma unroll
      for (int r = 1; r < R; ++r) v = lane == r ? acc[r] : v;
      dh_s[lane * H + k] = kAdd ? dh_s[lane * H + k] + v : v;
    }
  }
}

// dw[l][k][g] = sum over n = t * Bb + b of a_n[k] * dg[t, l, b, g], for a
// kTile x kTile tile (k0, g0) of stack l per block; 16 x 16 threads, each
// owning a 2 x 2 block of outputs.  The row operand a_n is a[t, l, b, :]
// (shift = 0: dW_ih from a = x, K = In) or the previous step's row,
// a[t-1, l, b, :] and a0[l, b, :] at t = 0 (shift = 1: dW_hh from a = ys,
// a0 = h0, K = H).  dg's rows are ldg floats apart and dw's ldw, so G
// columns of a wider gate row can be summed (the GRU's r, z and n slices
// come from two buffers).  Rows are summed in one fixed order and no
// atomics, so two calls give the same bits.  The row operand a is f32 or
// bf16 (the bf16-stream forms' x and ys), a0 and the dgates dg f32: the
// bf16 forms sum dW from the f32 gate gradients, as pallas_lstm.py:144-153
// and :400-420 do, never from a rounded copy.
template <typename TA>
__global__ void lstm_dw_kernel(const TA* __restrict__ a,
                               const float* __restrict__ a0,
                               const float* __restrict__ dg, int ldg,
                               float* __restrict__ dw, int ldw,
                               int T, int L, int Bb, int K, int G, int shift) {
  __shared__ float a_s[kTile][kTile + 1];  // [row][k]
  __shared__ float b_s[kTile][kTile];      // [row][g]
  const int l = blockIdx.z;
  const int k0 = blockIdx.y * kTile;
  const int g0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int N = T * Bb;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int n0 = 0; n0 < N; n0 += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += 256) {
      const int i = idx / kTile, c = idx % kTile;
      const int n = n0 + i;
      float av = 0.f, bv = 0.f;
      if (n < N) {
        const int t = n / Bb, bb = n % Bb;
        const size_t row = (static_cast<size_t>(t) * L + l) * Bb + bb;
        if (k0 + c < K) {
          if (!shift) {
            av = to_f32(a[row * K + k0 + c]);
          } else {
            av = t > 0 ? to_f32(a[(row - static_cast<size_t>(L) * Bb) * K + k0 + c])
                       : a0[(static_cast<size_t>(l) * Bb + bb) * K + k0 + c];
          }
        }
        if (g0 + c < G) bv = dg[row * ldg + g0 + c];
      }
      a_s[i][c] = av;
      b_s[i][c] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < kTile; ++i) {
      const float a0v = a_s[i][ty], a1v = a_s[i][ty + 16];
      const float v0 = b_s[i][tx], v1 = b_s[i][tx + 16];
      acc[0][0] = fmaf(a0v, v0, acc[0][0]);
      acc[0][1] = fmaf(a0v, v1, acc[0][1]);
      acc[1][0] = fmaf(a1v, v0, acc[1][0]);
      acc[1][1] = fmaf(a1v, v1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + ty + 16 * i, g = g0 + tx + 16 * j;
      if (k < K && g < G) dw[(static_cast<size_t>(l) * K + k) * ldw + g] = acc[i][j];
    }
  }
}

// Launches lstm_dw_kernel for G columns of stacks [L, K, ldw] on stream s.
template <typename TA>
cudaError_t launch_dw(const TA* a, const float* a0, const float* dg, int ldg, float* dw,
                      int ldw, int T, int L, int Bb, int K, int G, int shift,
                      cudaStream_t s) {
  const dim3 grid((G + kTile - 1) / kTile, (K + kTile - 1) / kTile, L);
  lstm_dw_kernel<TA><<<grid, dim3(16, 16), 0, s>>>(a, a0, dg, ldg, dw, ldw, T, L, Bb, K, G,
                                               shift);
  return cudaGetLastError();
}

// dx[t, l, b, k] = sum_g dg[t, l, b, g] * w_ih_t[l][k][g], for a kTile x
// kTile tile (rows n0 = t * Bb + b .., units k0 ..) of stack l per block;
// 16 x 16 threads, each owning a 2 x 2 block of outputs.  The sum over g
// runs in one fixed order.  dx is f32, or bf16 in the bf16-stream forms
// (the sum in f32, rounded once at the store, as pallas_lstm.py:397).
template <typename TO>
__global__ void lstm_inproj_dx_kernel(const float* __restrict__ dg,
                                      const float* __restrict__ wih_t,
                                      TO* __restrict__ dx,
                                      int T, int L, int Bb, int In, int G) {
  __shared__ float a_s[kTile][kTile + 1];  // [row][g]
  __shared__ float w_s[kTile][kTile + 1];  // [k][g]
  const int l = blockIdx.z;
  const int k0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int N = T * Bb;
  const float* w = wih_t + static_cast<size_t>(l) * In * G;
  auto row_of = [&](int n) {  // row n = t * Bb + b of stack l in [T, L, Bb, *]
    return (static_cast<size_t>(n / Bb) * L + l) * Bb + n % Bb;
  };
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};

  for (int g0 = 0; g0 < G; g0 += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += 256) {
      const int i = idx / kTile, c = idx % kTile;
      float av = 0.f, wv = 0.f;
      if (g0 + c < G) {
        if (n0 + i < N) av = dg[row_of(n0 + i) * G + g0 + c];
        if (k0 + i < In) wv = w[static_cast<size_t>(k0 + i) * G + g0 + c];
      }
      a_s[i][c] = av;
      w_s[i][c] = wv;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      const float a0v = a_s[ty][c], a1v = a_s[ty + 16][c];
      const float w0 = w_s[tx][c], w1 = w_s[tx + 16][c];
      acc[0][0] = fmaf(a0v, w0, acc[0][0]);
      acc[0][1] = fmaf(a0v, w1, acc[0][1]);
      acc[1][0] = fmaf(a1v, w0, acc[1][0]);
      acc[1][1] = fmaf(a1v, w1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + ty + 16 * i, k = k0 + tx + 16 * j;
      if (n < N && k < In) store_as(dx + row_of(n) * In + k, acc[i][j]);
    }
  }
}

// Launches lstm_inproj_dx_kernel: dx [T, L, Bb, In] = dg [T, L, Bb, G] @ w_ih_t[l]^T.
template <typename TO>
cudaError_t launch_dx(const float* dg, const float* wih_t, TO* dx, int T, int L, int Bb,
                      int In, int G, cudaStream_t s) {
  const dim3 grid((T * Bb + kTile - 1) / kTile, (In + kTile - 1) / kTile, L);
  lstm_inproj_dx_kernel<TO><<<grid, dim3(16, 16), 0, s>>>(dg, wih_t, dx, T, L, Bb, In, G);
  return cudaGetLastError();
}

constexpr int kSumGroups = 8;  // row groups of the dbias column sum

// db[l][g] = sum over n = t * Bb + b of dg[t, l, b, g] (dg's rows ldg floats
// apart, db's stacks ldb): kTile columns x kSumGroups row groups per block;
// group y sums rows y, y + kSumGroups, ... in order, and one thread adds the
// groups' partial sums in order.
__global__ void lstm_inproj_dbias_kernel(const float* __restrict__ dg, int ldg,
                                         float* __restrict__ db, int ldb,
                                         int T, int L, int Bb, int G) {
  __shared__ float part[kSumGroups][kTile];
  const int l = blockIdx.y;
  const int g = blockIdx.x * kTile + threadIdx.x;
  const int N = T * Bb;
  float acc = 0.f;
  if (g < G) {
    for (int n = threadIdx.y; n < N; n += kSumGroups) {
      const int t = n / Bb, bb = n % Bb;
      acc += dg[((static_cast<size_t>(t) * L + l) * Bb + bb) * ldg + g];
    }
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && g < G) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kSumGroups; ++i) s += part[i][threadIdx.x];
    db[static_cast<size_t>(l) * ldb + g] = s;
  }
}

// Launches lstm_inproj_dbias_kernel for G columns.
cudaError_t launch_dbias(const float* dg, int ldg, float* db, int ldb, int T, int L, int Bb,
                         int G, cudaStream_t s) {
  lstm_inproj_dbias_kernel<<<dim3((G + kTile - 1) / kTile, L), dim3(kTile, kSumGroups), 0, s>>>(
      dg, ldg, db, ldb, T, L, Bb, G);
  return cudaGetLastError();
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB it
// must ask).
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace
