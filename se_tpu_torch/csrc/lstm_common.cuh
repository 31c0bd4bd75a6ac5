// Device code shared by the recurrent kernels of lstm_scan.cu, lstm_inproj.cu
// and gru_inproj.cu: the row tile, the staging of a chunk's inputs, the gate
// products (h . W_hh per column, a chunk's x . W_ih), the gate math of one
// LSTM unit forward and backward, the dh pass of a reverse step, the
// deterministic dx, dW and dbias reductions over a gate-gradient scratch
// buffer; error_string.cuh adds the error-string export that each
// library's Python wrapper calls.  The per-block products and the dh pass
// take the block's row count R as a template argument (K3's per-block
// kernel: 4 or 8).
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

#include <algorithm>
#include <cstddef>
#include <type_traits>

#include "error_string.cuh"

namespace {

constexpr int kTile = 32;  // dx tile edge, dbias columns per block

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
template <int R>
__device__ __forceinline__ void dot_column(const float* __restrict__ w,
                                           const float* a_s, int K, int G,
                                           int col, float* acc) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    fma_rows<R>(a_s + k * R, __ldg(w + static_cast<size_t>(k) * G + col), acc);
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
template <int R, bool kAdd = false>
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

// The second passes below sum over the T * Bb rows n = t * Bb + b of a
// gate-gradient scratch buffer.  A call splits those rows into S segments of
// consecutive rows, enough to fill the card: each block sums its segment's
// rows in order into a partial, and sum_partials adds the S partials in
// order 0..S-1.  Fixed segments, fixed orders and no atomics: two calls
// give the same bits.  The partials live in the caller's workspace `ws`
// (ws_floats floats); S is cut so that they fit it, and with S = 1 a block
// writes its sum straight to the output.
constexpr int kDwTile = 64;        // dW output tile edge
constexpr int kDwRows = 32;        // rows staged per pass of a dW block
constexpr int kBlocksPerSm = 4;    // the blocks a split aims at, per SM
constexpr int kMinSegmentRows = 256;  // fewest rows worth a segment of their own

// The segment count for a reduction of `rows` rows whose L * K * G outputs
// fall into `tiles` blocks per segment.
inline int split_rows(int rows, int tiles, size_t outputs, size_t ws_floats) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int S = (kBlocksPerSm * sms + tiles - 1) / tiles;
  S = std::min(S, std::max(1, rows / kMinSegmentRows));
  S = static_cast<int>(std::min(static_cast<size_t>(S), ws_floats / outputs));
  S = std::max(S, 1);
  const int per = (rows + S - 1) / S;  // no empty segment
  return (rows + per - 1) / per;
}

// out[l][k][g] (rows ldo apart) = sum over s = 0..S-1 of ws[s][l][k][g]
// (packed, G wide).
__global__ void sum_partials_kernel(const float* __restrict__ ws, int S, int L, int K, int G,
                                    float* __restrict__ out, int ldo) {
  const size_t count = static_cast<size_t>(L) * K * G;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float v = ws[i];
    for (int s = 1; s < S; ++s) v += ws[s * count + i];
    const size_t lk = i / G;
    out[lk * ldo + i % G] = v;
  }
}

cudaError_t launch_sum_partials(const float* ws, int S, int L, int K, int G, float* out,
                                int ldo, cudaStream_t s) {
  const size_t count = static_cast<size_t>(L) * K * G;
  const int blocks = static_cast<int>(std::min<size_t>((count + 255) / 256, 4096));
  sum_partials_kernel<<<blocks, 256, 0, s>>>(ws, S, L, K, G, out, ldo);
  return cudaGetLastError();
}

// dw[l][k][g] = sum over n = t * Bb + b of a_n[k] * dg[t, l, b, g], for a
// kDwTile x kDwTile tile (k0, g0) of stack l and one segment of rows per
// block (blockIdx.z = segment * L + l); 16 x 16 threads, each owning a
// 4 x 4 block of outputs (k0 + 4 ty + i, g0 + 4 tx + j), read from shared
// memory as float4s.  The row operand a_n is a[t, l, b, :] (shift = 0:
// dW_ih from a = x, K = In) or the previous step's row, a[t-1, l, b, :] and
// a0[l, b, :] at t = 0 (shift = 1: dW_hh from a = ys, a0 = h0, K = H).
// dg's rows are ldg floats apart and dw's ldw, so G columns of a wider gate
// row can be summed (the GRU's r, z and n slices come from two buffers).
// With S > 1 segments the block writes its partial to ws[segment][l][k][g]
// (G wide) for sum_partials.  The row operand a is f32 or bf16 (the
// bf16-stream forms' x and ys), a0 and the dgates dg f32: the bf16 forms sum
// dW from the f32 gate gradients, as pallas_lstm.py:144-153 and :400-420
// do, never from a rounded copy.
template <typename TA>
__global__ void __launch_bounds__(256)
lstm_dw_kernel(const TA* __restrict__ a, const float* __restrict__ a0,
               const float* __restrict__ dg, int ldg, float* __restrict__ dw, int ldw,
               float* __restrict__ ws, int T, int L, int Bb, int K, int G, int shift,
               int S, int seg_rows) {
  __shared__ __align__(16) float a_s[kDwRows][kDwTile];  // [row][k]
  __shared__ __align__(16) float b_s[kDwRows][kDwTile];  // [row][g]
  const int l = blockIdx.z % L;
  const int seg = blockIdx.z / L;
  const int k0 = blockIdx.y * kDwTile;
  const int g0 = blockIdx.x * kDwTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int N = T * Bb;
  const int n_begin = seg * seg_rows;
  const int n_end = min(N, n_begin + seg_rows);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int n0 = n_begin; n0 < n_end; n0 += kDwRows) {
    for (int idx = tid; idx < kDwRows * kDwTile; idx += 256) {
      const int i = idx / kDwTile, c = idx % kDwTile;
      const int n = n0 + i;
      float av = 0.f, bv = 0.f;
      if (n < n_end) {
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
    for (int i = 0; i < kDwRows; ++i) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[i][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[i][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(ar[p], br[q], acc[p][q]);
      }
    }
    __syncthreads();
  }
  float* out = S > 1 ? ws + (static_cast<size_t>(seg) * L + l) * K * G : dw + static_cast<size_t>(l) * K * ldw;
  const int ld = S > 1 ? G : ldw;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 4 * ty + p, g = g0 + 4 * tx + q;
      if (k < K && g < G) out[static_cast<size_t>(k) * ld + g] = acc[p][q];
    }
  }
}

// Launches lstm_dw_kernel for G columns of stacks [L, K, ldw] on stream s,
// its rows split over the workspace ws (ws_floats floats), then the sum of
// the partials.
template <typename TA>
cudaError_t launch_dw(const TA* a, const float* a0, const float* dg, int ldg, float* dw,
                      int ldw, float* ws, size_t ws_floats, int T, int L, int Bb, int K,
                      int G, int shift, cudaStream_t s) {
  const int gx = (G + kDwTile - 1) / kDwTile, ky = (K + kDwTile - 1) / kDwTile;
  const int N = T * Bb;
  const int S = split_rows(N, gx * ky * L, static_cast<size_t>(L) * K * G, ws_floats);
  const int seg_rows = (N + S - 1) / S;
  lstm_dw_kernel<TA><<<dim3(gx, ky, L * S), dim3(16, 16), 0, s>>>(
      a, a0, dg, ldg, dw, ldw, ws, T, L, Bb, K, G, shift, S, seg_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return launch_sum_partials(ws, S, L, K, G, dw, ldw, s);
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
// apart, db's stacks ldb): kTile columns x kSumGroups row groups per block
// and one segment of rows per block (blockIdx.y = segment * L + l); group y
// sums the segment's rows y, y + kSumGroups, ... in order, and one thread
// adds the groups' sums in order, into db (S = 1) or the partial
// ws[segment][l][g] (G wide).
__global__ void lstm_inproj_dbias_kernel(const float* __restrict__ dg, int ldg,
                                         float* __restrict__ db, int ldb,
                                         float* __restrict__ ws,
                                         int T, int L, int Bb, int G, int S, int seg_rows) {
  __shared__ float part[kSumGroups][kTile];
  const int l = blockIdx.y % L;
  const int seg = blockIdx.y / L;
  const int g = blockIdx.x * kTile + threadIdx.x;
  const int n_end = min(T * Bb, (seg + 1) * seg_rows);
  float acc = 0.f;
  if (g < G) {
    for (int n = seg * seg_rows + threadIdx.y; n < n_end; n += kSumGroups) {
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
    if (S > 1) {
      ws[(static_cast<size_t>(seg) * L + l) * G + g] = s;
    } else {
      db[static_cast<size_t>(l) * ldb + g] = s;
    }
  }
}

// Launches lstm_inproj_dbias_kernel for G columns, its rows split over the
// workspace ws as launch_dw's.
cudaError_t launch_dbias(const float* dg, int ldg, float* db, int ldb, float* ws,
                         size_t ws_floats, int T, int L, int Bb, int G, cudaStream_t s) {
  const int gx = (G + kTile - 1) / kTile;
  const int N = T * Bb;
  const int S = split_rows(N, gx * L, static_cast<size_t>(L) * G, ws_floats);
  const int seg_rows = (N + S - 1) / S;
  lstm_inproj_dbias_kernel<<<dim3(gx, L * S), dim3(kTile, kSumGroups), 0, s>>>(
      dg, ldg, db, ldb, ws, T, L, Bb, G, S, seg_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return launch_sum_partials(ws, S, L, 1, G, db, ldb, s);
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
