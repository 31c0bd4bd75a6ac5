// Device code shared by the LSTM kernels of lstm_scan.cu and lstm_inproj.cu:
// the row tile, the gate math of one unit forward and backward, the dh pass
// of a reverse step, the deterministic dW reduction, and the error-string
// export that each library's Python wrapper calls.
//
// Transcendentals use expf/tanhf (no fast-math) to stay within 1e-5 of the
// plain PyTorch recurrence per step.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 4;   // batch rows per scan block; a row operand is read as one float4
constexpr int kTile = 32;  // dW tile edge and rows per reduction chunk

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[r] += sum_k a_s[k][r] * w[k][col] over k < K; a_s is [K][kRows].  w
// is read from global memory, coalesced across a warp whose threads hold
// consecutive columns; a_s gives all kRows rows at one k as one float4.
__device__ __forceinline__ void dot_column(const float* __restrict__ w,
                                           const float* a_s, int K, int G,
                                           int col, float* acc) {
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float wv = __ldg(w + static_cast<size_t>(k) * G + col);
    const float4 av = *reinterpret_cast<const float4*>(a_s + k * kRows);
    acc[0] = fmaf(av.x, wv, acc[0]);
    acc[1] = fmaf(av.y, wv, acc[1]);
    acc[2] = fmaf(av.z, wv, acc[2]);
    acc[3] = fmaf(av.w, wv, acc[3]);
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
// for the tile's rows (g_s [kRows][G] holds the step's dgates, w is
// w_hh_t[l]), one warp per unit k: the lanes read row k of w along g,
// coalesced, and a shuffle reduction ends each sum.
__device__ __forceinline__ void dh_rows(const float* __restrict__ w,
                                        const float* g_s, float* dh_s,
                                        int rows, int H, int G) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < H; k += nwarps) {
    const float* wk = w + static_cast<size_t>(k) * G;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int col = lane; col < G; col += 32) {
      const float wv = __ldg(wk + col);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(g_s[r * G + col], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    }
    if (lane < rows) {
      float v = acc[0];
#pragma unroll
      for (int r = 1; r < kRows; ++r) v = lane == r ? acc[r] : v;
      dh_s[lane * H + k] = v;
    }
  }
}

// dw[l][k][g] = sum over n = t * Bb + b of a_n[k] * dg[t, l, b, g], for a
// kTile x kTile tile (k0, g0) of stack l per block; 16 x 16 threads, each
// owning a 2 x 2 block of outputs.  The row operand a_n is a[t, l, b, :]
// (shift = 0: dW_ih from a = x, K = In) or the previous step's row,
// a[t-1, l, b, :] and a0[l, b, :] at t = 0 (shift = 1: dW_hh from a = ys,
// a0 = h0, K = H).  Rows are summed in one fixed order and no atomics, so
// two calls give the same bits.
__global__ void lstm_dw_kernel(const float* __restrict__ a,
                               const float* __restrict__ a0,
                               const float* __restrict__ dg,
                               float* __restrict__ dw,
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
            av = a[row * K + k0 + c];
          } else {
            av = t > 0 ? a[(row - static_cast<size_t>(L) * Bb) * K + k0 + c]
                       : a0[(static_cast<size_t>(l) * Bb + bb) * K + k0 + c];
          }
        }
        if (g0 + c < G) bv = dg[row * G + g0 + c];
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
      if (k < K && g < G) dw[(static_cast<size_t>(l) * K + k) * G + g] = acc[i][j];
    }
  }
}

// Launches lstm_dw_kernel for stacks [L, K, G] on stream s.
cudaError_t launch_dw(const float* a, const float* a0, const float* dg, float* dw,
                      int T, int L, int Bb, int K, int G, int shift, cudaStream_t s) {
  const dim3 grid((G + kTile - 1) / kTile, (K + kTile - 1) / kTile, L);
  lstm_dw_kernel<<<grid, dim3(16, 16), 0, s>>>(a, a0, dg, dw, T, L, Bb, K, G, shift);
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

extern "C" const char* se_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
