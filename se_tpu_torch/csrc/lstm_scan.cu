// Fused LSTM-stack scan, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of `fused_lstm_scan` in
// se_tpu/ops/pallas_lstm.py: the forward (_fwd_kernel and _fwd_call,
// :56-87 and :158-196) and the backward (_bwd_kernel and _fused_bwd,
// :90-155 and :217-262).  One launch runs L independent LSTMs over T steps:
//
//   x_proj [T, L, Bb, 4H] f32 (input projection with both biases folded in)
//   w_hh_t [L, H, 4H]     f32 (recurrent weights, transposed)
//   h0, c0 [L, Bb, H]     f32
//   gates = x_proj[t] + h @ w_hh_t[l]   (gate order i, f, g, o)
//   c = f * c + i * g ;  h = o * tanh(c)
//   -> ys [T, L, Bb, H], hT, cT [L, Bb, H], all f32, and, when the caller
//      passes a buffer for it (training), the cell-state stash cs [T, L, Bb, H].
//
// The backward takes (x_proj, w_hh_t, h0, c0, ys, cs) and the cotangents
// (dys, dhT, dcT) and gives dx_proj [T, L, Bb, 4H] (= dgates), dw_hh_t
// [L, H, 4H], dh0 and dc0.  It recomputes the gates from (x_proj, h_prev)
// instead of stashing them, as the Pallas kernel does.
//
// What bounds them.  On DCCRN's main path (L=2, H=128, Bb=2B, T=483) the
// forward moves ~40 MB and does ~2 GFLOP at B=8; the backward at B=10
// moves ~110 MB and does ~7.6 GFLOP (three [Bb,H]x[H,4H] products a step:
// the recompute, dh and dW).  Both floors are a fraction of a millisecond
// at 67 TFLOP/s f32 and 3.35 TB/s.  The real limit is the chain of T
// dependent steps: each step needs the whole previous h (or dh), so a step
// costs at least one pass over W_hh[l] (128 x 512 f32 = 256 KiB) plus a
// barrier; the backward makes two passes.
//
// Design (the simple one).  One block per (stack l, tile of kRows batch
// rows); the T loop runs inside the block, h, c and the step's gates in
// shared memory.  Forward step, two phases separated by __syncthreads():
//   1. thread `col` forms gate column `col` for the tile's rows, reading
//      W_hh[l][:, col] from global memory (coalesced across the warp; the
//      256 KiB stay resident in the 50 MB L2) and h from shared memory
//      (one float4 broadcast gives all kRows rows at one k);
//   2. thread (r, j) applies the gate math to unit j of row r and writes
//      h, c, ys and the stash.
// Backward step (t = T-1 ... 0), four phases:
//   0. load h_prev = ys[t-1] (h0 at t = 0) into shared memory;
//   1. recompute the gates as forward phase 1;
//   2. thread (r, j) forms dgates for unit j of row r from the gates,
//      c_prev = cs[t-1] (c0 at t = 0), cs[t], dh = dys[t] + dh carry and
//      the dc carry; writes them to dx_proj and over the gates in shared
//      memory; sets the dc carry to dc * f;
//   3. dh carry [r][k] = sum_g dgates[r][g] * W_hh[l][k][g]: one warp per
//      unit k reads row k of w_hh_t[l] along g (coalesced), each lane sums
//      16 columns for all kRows rows, and a shuffle reduction ends it.
// dW_hh is summed over all T * Bb rows by a second kernel,
// lstm_dwhh_kernel: dw_hh_t[l][k][g] = sum_{t,b} h_prev[t,l,b,k] *
// dx_proj[t,l,b,g], a 32 x 32 output tile per block with the rows in a
// fixed order, so two calls give the same bits (no atomics).
// W_hh[l] does not fit in one block's 227 KB of shared memory, so every
// step streams it from L2 through one SM: that read, not the arithmetic,
// sets the step time.  The faster design splits the 4H columns over a
// cluster of 2-4 blocks, each holding its W_hh slice in shared memory and
// exchanging h (or dh) through distributed shared memory every step.
//
// Transcendentals use expf/tanhf (no fast-math) to stay within 1e-5 of the
// plain PyTorch recurrence per step.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 4;  // batch rows per block; h is read as one float4
constexpr int kTile = 32;  // dW tile edge and rows per reduction chunk

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// gates[r][col] = xp_t[r][col] + sum_k h_s[k][r] * w[k][col] for the
// tile's rows; h_s is [H][kRows].
__device__ __forceinline__ void gate_columns(const float* __restrict__ w,
                                             const float* __restrict__ xp_t,
                                             const float* h_s, float* g_s,
                                             int rows, int H, int G) {
  for (int col = threadIdx.x; col < G; col += blockDim.x) {
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
}

__global__ void lstm_scan_fwd_kernel(const float* __restrict__ xp,
                                     const float* __restrict__ whh_t,
                                     const float* __restrict__ h0,
                                     const float* __restrict__ c0,
                                     float* __restrict__ ys,
                                     float* __restrict__ cs,
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

    // phase 1: gates[r][col] = x_proj[t, l, b0 + r, col] + sum_k h[r][k] w[k][col]
    gate_columns(w, xp + row0 * G, h_s, g_s, rows, H, G);
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
      if (cs != nullptr) cs[(row0 + r) * H + j] = c;
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

__global__ void lstm_scan_bwd_kernel(const float* __restrict__ xp,
                                     const float* __restrict__ whh_t,
                                     const float* __restrict__ h0,
                                     const float* __restrict__ c0,
                                     const float* __restrict__ ys,
                                     const float* __restrict__ cs,
                                     const float* __restrict__ dys,
                                     const float* __restrict__ dhT,
                                     const float* __restrict__ dcT,
                                     float* __restrict__ dxp,
                                     float* __restrict__ dh0,
                                     float* __restrict__ dc0,
                                     int T, int L, int Bb, int H) {
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  float* h_s = reinterpret_cast<float*>(smem4);  // [H][kRows]  h_prev
  float* dh_s = h_s + H * kRows;                  // [kRows][H]  dh carry
  float* dc_s = dh_s + kRows * H;                 // [kRows][H]  dc carry
  float* g_s = dc_s + kRows * H;                  // [kRows][G]  gates, then dgates

  const int l = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, Bb - b0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const float* w = whh_t + static_cast<size_t>(l) * H * G;

  // carries in; g_s rows past the batch edge stay zero, so their dgates
  // add nothing to the dh sums below
  for (int idx = tid; idx < kRows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    float dh = 0.f, dc = 0.f;
    if (r < rows) {
      const size_t o = (static_cast<size_t>(l) * Bb + b0 + r) * H + j;
      dh = dhT[o];
      dc = dcT[o];
    }
    dh_s[r * H + j] = dh;
    dc_s[r * H + j] = dc;
  }
  for (int idx = tid; idx < kRows * G; idx += nthr) g_s[idx] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t row0 = (static_cast<size_t>(t) * L + l) * Bb + b0;
    // [L, Bb, H] rows of the previous step: ys/cs[t-1], or h0/c0 at t = 0
    const float* h_prev = t > 0 ? ys + (row0 - static_cast<size_t>(L) * Bb) * H
                                : h0 + (static_cast<size_t>(l) * Bb + b0) * H;
    const float* c_prev = t > 0 ? cs + (row0 - static_cast<size_t>(L) * Bb) * H
                                : c0 + (static_cast<size_t>(l) * Bb + b0) * H;

    // phase 0: h_prev into shared memory
    for (int idx = tid; idx < kRows * H; idx += nthr) {
      const int r = idx / H, j = idx % H;
      h_s[j * kRows + r] = r < rows ? h_prev[r * H + j] : 0.f;
    }
    __syncthreads();

    // phase 1: recompute the gates
    gate_columns(w, xp + row0 * G, h_s, g_s, rows, H, G);
    __syncthreads();

    // phase 2: dgates for (row r, unit j); pallas_lstm.py:118-131, :155
    for (int idx = tid; idx < rows * H; idx += nthr) {
      const int r = idx / H, j = idx % H;
      float* g = g_s + r * G;
      const float ig = sigmoid_f32(g[j]);
      const float fg = sigmoid_f32(g[H + j]);
      const float gg = tanhf(g[2 * H + j]);
      const float og = sigmoid_f32(g[3 * H + j]);
      const size_t o = (row0 + r) * H + j;
      const float tanh_c = tanhf(cs[o]);
      const float dh = dys[o] + dh_s[r * H + j];
      const float d_o = dh * tanh_c * og * (1.0f - og);
      const float dc = dc_s[r * H + j] + dh * og * (1.0f - tanh_c * tanh_c);
      const float d_i = dc * gg * ig * (1.0f - ig);
      const float d_f = dc * c_prev[r * H + j] * fg * (1.0f - fg);
      const float d_g = dc * ig * (1.0f - gg * gg);
      g[j] = d_i;
      g[H + j] = d_f;
      g[2 * H + j] = d_g;
      g[3 * H + j] = d_o;
      float* dxp_t = dxp + (row0 + r) * G;
      dxp_t[j] = d_i;
      dxp_t[H + j] = d_f;
      dxp_t[2 * H + j] = d_g;
      dxp_t[3 * H + j] = d_o;
      dc_s[r * H + j] = dc * fg;
    }
    __syncthreads();

    // phase 3: dh carry = dgates @ W_hh[l]^T, one warp per unit k
    for (int k = warp; k < H; k += nwarps) {
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
      if (lane < kRows && lane < rows) {
        float v = acc[0];
#pragma unroll
        for (int r = 1; r < kRows; ++r) v = lane == r ? acc[r] : v;
        dh_s[lane * H + k] = v;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < rows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    const size_t o = (static_cast<size_t>(l) * Bb + b0 + r) * H + j;
    dh0[o] = dh_s[r * H + j];
    dc0[o] = dc_s[r * H + j];
  }
}

// dw[l][k][g] = sum over n = t * Bb + b of h_prev[n][k] * dxp[n][g], for a
// kTile x kTile tile (k0, g0) of stack l per block; 16 x 16 threads, each
// owning a 2 x 2 block of outputs.  Rows are summed in one fixed order.
__global__ void lstm_dwhh_kernel(const float* __restrict__ h0,
                                 const float* __restrict__ ys,
                                 const float* __restrict__ dxp,
                                 float* __restrict__ dw,
                                 int T, int L, int Bb, int H) {
  __shared__ float a_s[kTile][kTile + 1];  // [row][k]
  __shared__ float b_s[kTile][kTile];      // [row][g]
  const int G = 4 * H;
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
        const int t = n / Bb, b = n % Bb;
        const size_t row = (static_cast<size_t>(t) * L + l) * Bb + b;
        if (k0 + c < H) {
          av = t > 0 ? ys[(row - static_cast<size_t>(L) * Bb) * H + k0 + c]
                     : h0[(static_cast<size_t>(l) * Bb + b) * H + k0 + c];
        }
        if (g0 + c < G) bv = dxp[row * G + g0 + c];
      }
      a_s[i][c] = av;
      b_s[i][c] = bv;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < kTile; ++i) {
      const float a0 = a_s[i][ty], a1 = a_s[i][ty + 16];
      const float v0 = b_s[i][tx], v1 = b_s[i][tx + 16];
      acc[0][0] = fmaf(a0, v0, acc[0][0]);
      acc[0][1] = fmaf(a0, v1, acc[0][1]);
      acc[1][0] = fmaf(a1, v0, acc[1][0]);
      acc[1][1] = fmaf(a1, v1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int k = k0 + ty + 16 * a, g = g0 + tx + 16 * b;
      if (k < H && g < G) dw[(static_cast<size_t>(l) * H + k) * G + g] = acc[a][b];
    }
  }
}

int scan_threads(int H) {
  const int G = 4 * H;
  const int threads = G < 1024 ? G : 1024;
  return (threads + 31) / 32 * 32;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// Launches the forward scan on `stream` (a cudaStream_t) of `device`.
// Returns the cudaError_t of the launch (0 on success).  All pointers are
// device pointers to contiguous f32 arrays of the shapes above; `cs` may be
// null, and then no stash is written.
extern "C" int se_lstm_scan_fwd_f32(const float* xp, const float* whh_t,
                                    const float* h0, const float* c0,
                                    float* ys, float* cs, float* hT, float* cT,
                                    int T, int L, int Bb, int H,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  const size_t smem = sizeof(float) * (static_cast<size_t>(2) * kRows * H +
                                       static_cast<size_t>(kRows) * G);
  err = allow_smem(reinterpret_cast<const void*>(lstm_scan_fwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Bb + kRows - 1) / kRows, L);
  lstm_scan_fwd_kernel<<<grid, scan_threads(H), smem, static_cast<cudaStream_t>(stream)>>>(
      xp, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, H);
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward: the reverse scan (dx_proj, dh0, dc0), then the
// dW_hh reduction that reads its dx_proj, both on `stream`.  Returns the
// first cudaError_t (0 on success).  Shapes as above; every pointer is a
// device pointer to a contiguous f32 array, none may be null.
extern "C" int se_lstm_scan_bwd_f32(const float* xp, const float* whh_t,
                                    const float* h0, const float* c0,
                                    const float* ys, const float* cs,
                                    const float* dys, const float* dhT,
                                    const float* dcT, float* dxp, float* dwhh_t,
                                    float* dh0, float* dc0,
                                    int T, int L, int Bb, int H,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  const size_t smem = sizeof(float) * (static_cast<size_t>(3) * kRows * H +
                                       static_cast<size_t>(kRows) * G);
  err = allow_smem(reinterpret_cast<const void*>(lstm_scan_bwd_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Bb + kRows - 1) / kRows, L);
  lstm_scan_bwd_kernel<<<grid, scan_threads(H), smem, s>>>(
      xp, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dxp, dh0, dc0, T, L, Bb, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dw_grid((G + kTile - 1) / kTile, (H + kTile - 1) / kTile, L);
  lstm_dwhh_kernel<<<dw_grid, dim3(16, 16), 0, s>>>(h0, ys, dxp, dwhh_t, T, L, Bb, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* se_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
