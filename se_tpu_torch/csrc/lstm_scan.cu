// Fused LSTM-stack scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `fused_lstm_scan` of se_tpu/ops/pallas_lstm.py
// (forward: _fwd_kernel and _fwd_call, :56-87 and :158-209).  It runs L
// independent LSTMs over T steps in one launch:
//
//   x_proj [T, L, Bb, 4H] f32 (input projection with both biases folded in)
//   w_hh_t [L, H, 4H]     f32 (recurrent weights, transposed)
//   h0, c0 [L, Bb, H]     f32
//   gates = x_proj[t] + h @ w_hh_t[l]   (gate order i, f, g, o)
//   c = f * c + i * g ;  h = o * tanh(c)
//   -> ys [T, L, Bb, H], hT, cT [L, Bb, H], all f32.  No cell-state stash.
//
// What bounds it.  On DCCRN's main path (L=2, H=128, Bb=16, T=483) the
// whole call moves ~40 MB (12 us at 3.35 TB/s) and does ~2.0 GFLOP
// (30 us at the 67 TFLOP/s f32 rate outside the tensor cores), so the
// roofline floor is tens of microseconds.  The real limit is the chain of
// T dependent steps: each step needs the whole previous h, so a step costs
// at least one pass over W_hh[l] (128 x 512 f32 = 256 KiB) plus a barrier.
//
// Design (the simple one).  One block per (stack l, tile of kRows batch
// rows); the T loop runs inside the block.  h, c and the step's gates live
// in shared memory.  Each step has two phases separated by __syncthreads():
//   1. thread `col` forms gate column `col` for the tile's rows, reading
//      W_hh[l][:, col] from global memory (coalesced across the warp; the
//      256 KiB stay resident in the 50 MB L2) and h from shared memory
//      (one float4 broadcast gives all kRows rows at one k);
//   2. thread (r, j) applies the gate math to unit j of row r and writes
//      h, c and ys.
// W_hh[l] does not fit in one block's 227 KB of shared memory, so every
// step streams it from L2 through one SM: that read, not the arithmetic,
// sets the step time.  The faster design splits the 4H columns over a
// cluster of 2-4 blocks, each holding its W_hh slice in shared memory and
// exchanging h through distributed shared memory every step.
//
// Transcendentals use expf/tanhf (no fast-math) to stay within 1e-5 of the
// plain PyTorch recurrence per step.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 4;  // batch rows per block; h is read as one float4

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void lstm_scan_fwd_kernel(const float* __restrict__ xp,
                                     const float* __restrict__ whh_t,
                                     const float* __restrict__ h0,
                                     const float* __restrict__ c0,
                                     float* __restrict__ ys,
                                     float* __restrict__ hT,
                                     float* __restrict__ cT,
                                     int T, int L, int Bb, int H) {
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  float* h_s = reinterpret_cast<float*>(smem4);  // [H][kRows]
  float* c_s = h_s + H * kRows;                   // [kRows][H]
  float* g_s = c_s + kRows * H;                   // [kRows][G]

  const int l = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, Bb - b0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const float* w = whh_t + static_cast<size_t>(l) * H * G;

  // carries in; rows past the batch edge stay zero and are never written
  for (int idx = tid; idx < kRows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    float hv = 0.f, cv = 0.f;
    if (r < rows) {
      const size_t o = (static_cast<size_t>(l) * Bb + b0 + r) * H + j;
      hv = h0[o];
      cv = c0[o];
    }
    h_s[j * kRows + r] = hv;
    c_s[r * H + j] = cv;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t row0 = (static_cast<size_t>(t) * L + l) * Bb + b0;
    const float* xp_t = xp + row0 * G;

    // phase 1: gates[r][col] = x_proj[t, l, b0 + r, col] + sum_k h[r][k] w[k][col]
    for (int col = tid; col < G; col += nthr) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float wv = __ldg(w + static_cast<size_t>(k) * G + col);
        const float4 hv = *reinterpret_cast<const float4*>(h_s + k * kRows);
        acc[0] = fmaf(hv.x, wv, acc[0]);
        acc[1] = fmaf(hv.y, wv, acc[1]);
        acc[2] = fmaf(hv.z, wv, acc[2]);
        acc[3] = fmaf(hv.w, wv, acc[3]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) g_s[r * G + col] = xp_t[static_cast<size_t>(r) * G + col] + acc[r];
      }
    }
    __syncthreads();

    // phase 2: cell update for (row r, unit j)
    for (int idx = tid; idx < rows * H; idx += nthr) {
      const int r = idx / H, j = idx % H;
      const float* g = g_s + r * G;
      const float ig = sigmoid_f32(g[j]);
      const float fg = sigmoid_f32(g[H + j]);
      const float gg = tanhf(g[2 * H + j]);
      const float og = sigmoid_f32(g[3 * H + j]);
      const float c = fg * c_s[r * H + j] + ig * gg;
      const float h = og * tanhf(c);
      c_s[r * H + j] = c;
      h_s[j * kRows + r] = h;
      ys[(row0 + r) * H + j] = h;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < rows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    const size_t o = (static_cast<size_t>(l) * Bb + b0 + r) * H + j;
    hT[o] = h_s[j * kRows + r];
    cT[o] = c_s[r * H + j];
  }
}

}  // namespace

// Launches the forward scan on `stream` (a cudaStream_t) of `device`.
// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers to contiguous f32 arrays of the shapes above.
extern "C" int se_lstm_scan_fwd_f32(const float* xp, const float* whh_t,
                                    const float* h0, const float* c0,
                                    float* ys, float* hT, float* cT,
                                    int T, int L, int Bb, int H,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  int threads = G < 1024 ? G : 1024;
  threads = (threads + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (static_cast<size_t>(2) * kRows * H +
                                       static_cast<size_t>(kRows) * G);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lstm_scan_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Bb + kRows - 1) / kRows, L);
  lstm_scan_fwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      xp, whh_t, h0, c0, ys, hT, cT, T, L, Bb, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* se_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
