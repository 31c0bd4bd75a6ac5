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
// dW_hh is summed over all T * Bb rows by a second kernel, lstm_dw_kernel
// (lstm_common.cuh): dw_hh_t[l][k][g] = sum_{t,b} h_prev[t,l,b,k] *
// dx_proj[t,l,b,g], a 64 x 64 output tile and a segment of the rows per
// block, the rows and then the segments' partials summed in fixed orders,
// so two calls give the same bits (no atomics).
// W_hh[l] does not fit in one block's 227 KB of shared memory, so every
// step streams it from L2 through one SM: that read, not the arithmetic,
// sets the step time.  The faster design splits the 4H columns over a
// cluster of 2-4 blocks, each holding its W_hh slice in shared memory and
// exchanging h (or dh) through distributed shared memory every step.
//
// The backward's gate math, the gate product, the dh pass and the dW
// reduction are shared with lstm_inproj.cu through lstm_common.cuh.
//
// The bf16-stream form (pallas_lstm.py:13-14; the kernels' :69, :86, :133)
// takes x_proj, and gives ys, as bf16, and in the backward takes ys and
// dys as bf16 and gives dx_proj as bf16: each value is converted at its
// load or store (to_f32, store_as), so the carry, the gates, the stash cs
// and every sum stay f32, and the f32 form compiles as before.  The carry h
// stays f32 from step to step; only its copy in ys is rounded.  The
// backward recomputes the gates from the rounded ys[t-1], as the Pallas
// backward does (:105).  Its dW_hh sums the f32 dgates (:144-153), so the
// bf16 form writes them to an f32 scratch buffer [T, L, Bb, 4H] that
// lstm_dw_kernel reads, and writes dx_proj rounded beside it; the f32 form
// reads dx_proj itself.  What bounds the kernels does not change: the
// bf16 stream halves bytes that were never the limit.

#include "lstm_common.cuh"

namespace {

// gates[r][col] = xp_t[r][col] + sum_k h_s[k][r] * w[k][col] for the
// tile's rows; h_s is [H][kRows], xp_t f32 or bf16.
template <typename TS>
__device__ __forceinline__ void gate_columns(const float* __restrict__ w,
                                             const TS* __restrict__ xp_t,
                                             const float* h_s, float* g_s,
                                             int rows, int H, int G) {
  for (int col = threadIdx.x; col < G; col += blockDim.x) {
    float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
    dot_column(w, h_s, H, G, col, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) g_s[r * G + col] = to_f32(xp_t[static_cast<size_t>(r) * G + col]) + acc[r];
    }
  }
}

template <typename TS>
__global__ void lstm_scan_fwd_kernel(const TS* __restrict__ xp,
                                     const float* __restrict__ whh_t,
                                     const float* __restrict__ h0,
                                     const float* __restrict__ c0,
                                     TS* __restrict__ ys,
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

    // phase 2: cell update for (row r, unit j).  Written out here, not
    // through cell_forward of lstm_common.cuh: with that helper (or one
    // returning a float2, or one updating c in place) nvcc's code for this
    // kernel took 7.7-8.8 ms a call instead of 3.4-3.5 ms at DCCRN's
    // enhance shapes (T=483, L=2, Bb=16, H=128) on an NVIDIA H100 80GB
    // HBM3 at 700 W, although phase 1's loop is the same source in all of
    // them.  K2's forward is not sensitive to it.
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
      store_as(ys + (row0 + r) * H + j, h);
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

// dg receives the f32 dgates: dx_proj itself in the f32 form, the scratch
// buffer in the bf16 form, which also writes them rounded to dxp.
template <typename TS>
__global__ void lstm_scan_bwd_kernel(const TS* __restrict__ xp,
                                     const float* __restrict__ whh_t,
                                     const float* __restrict__ h0,
                                     const float* __restrict__ c0,
                                     const TS* __restrict__ ys,
                                     const float* __restrict__ cs,
                                     const TS* __restrict__ dys,
                                     const float* __restrict__ dhT,
                                     const float* __restrict__ dcT,
                                     float* __restrict__ dg,
                                     TS* __restrict__ dxp,
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
    const float* c_prev = t > 0 ? cs + (row0 - static_cast<size_t>(L) * Bb) * H
                                : c0 + (static_cast<size_t>(l) * Bb + b0) * H;

    // phase 0: h_prev into shared memory (ys and h0 differ in type in the
    // bf16 form)
    if constexpr (kIsF32<TS>) {
      const float* h_prev = t > 0 ? ys + (row0 - static_cast<size_t>(L) * Bb) * H
                                  : h0 + (static_cast<size_t>(l) * Bb + b0) * H;
      for (int idx = tid; idx < kRows * H; idx += nthr) {
        const int r = idx / H, j = idx % H;
        h_s[j * kRows + r] = r < rows ? h_prev[r * H + j] : 0.f;
      }
    } else if (t > 0) {
      stage_rows<kRows>(h_s, ys + (row0 - static_cast<size_t>(L) * Bb) * H, rows, H);
    } else {
      stage_rows<kRows>(h_s, h0 + (static_cast<size_t>(l) * Bb + b0) * H, rows, H);
    }
    __syncthreads();

    // phase 1: recompute the gates
    gate_columns(w, xp + row0 * G, h_s, g_s, rows, H, G);
    __syncthreads();

    // phase 2: dgates for (row r, unit j); pallas_lstm.py:118-131, :155
    for (int idx = tid; idx < rows * H; idx += nthr) {
      const int r = idx / H, j = idx % H;
      const size_t o = (row0 + r) * H + j;
      dc_s[r * H + j] = cell_backward(g_s + r * G, dg + (row0 + r) * G, H, j,
                                      c_prev[r * H + j], cs[o],
                                      to_f32(dys[o]) + dh_s[r * H + j], dc_s[r * H + j]);
      if constexpr (!kIsF32<TS>) {  // the four dgates this thread just wrote
        const float* gr = g_s + r * G;
        TS* out = dxp + (row0 + r) * G;
#pragma unroll
        for (int q = 0; q < 4; ++q) store_as(out + q * H + j, gr[q * H + j]);
      }
    }
    __syncthreads();

    // phase 3: dh carry = dgates @ W_hh[l]^T, one warp per unit k
    dh_rows(w, g_s, dh_s, rows, H, G);
    __syncthreads();
  }

  for (int idx = tid; idx < rows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    const size_t o = (static_cast<size_t>(l) * Bb + b0 + r) * H + j;
    dh0[o] = dh_s[r * H + j];
    dc0[o] = dc_s[r * H + j];
  }
}

int scan_threads(int H) {
  const int G = 4 * H;
  const int threads = G < 1024 ? G : 1024;
  return (threads + 31) / 32 * 32;
}

template <typename TS>
int launch_scan_fwd(const TS* xp, const float* whh_t, const float* h0, const float* c0,
                    TS* ys, float* cs, float* hT, float* cT, int T, int L, int Bb, int H,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  const size_t smem = sizeof(float) * (static_cast<size_t>(2) * kRows * H +
                                       static_cast<size_t>(kRows) * G);
  err = allow_smem(lstm_scan_fwd_kernel<TS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Bb + kRows - 1) / kRows, L);
  lstm_scan_fwd_kernel<TS><<<grid, scan_threads(H), smem, static_cast<cudaStream_t>(stream)>>>(
      xp, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename TS>
int launch_scan_bwd(const TS* xp, const float* whh_t, const float* h0, const float* c0,
                    const TS* ys, const float* cs, const TS* dys, const float* dhT,
                    const float* dcT, float* dg, TS* dxp, float* dwhh_t, float* dh0,
                    float* dc0, float* ws, int T, int L, int Bb, int H, int ws_floats,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  const size_t smem = sizeof(float) * (static_cast<size_t>(3) * kRows * H +
                                       static_cast<size_t>(kRows) * G);
  err = allow_smem(lstm_scan_bwd_kernel<TS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((Bb + kRows - 1) / kRows, L);
  lstm_scan_bwd_kernel<TS><<<grid, scan_threads(H), smem, s>>>(
      xp, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dg, dxp, dh0, dc0, T, L, Bb, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dw(ys, h0, dg, G, dwhh_t, G, ws, ws_floats, T, L, Bb, H, G,
                                    1, s));
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
  return launch_scan_fwd(xp, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, H, device, stream);
}

// The bf16-stream forward: xp and ys bf16, the rest as se_lstm_scan_fwd_f32.
extern "C" int se_lstm_scan_fwd_bf16(const __nv_bfloat16* xp, const float* whh_t,
                                     const float* h0, const float* c0,
                                     __nv_bfloat16* ys, float* cs, float* hT, float* cT,
                                     int T, int L, int Bb, int H,
                                     int device, void* stream) {
  return launch_scan_fwd(xp, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, H, device, stream);
}

// Launches the backward: the reverse scan (dx_proj, dh0, dc0), then the
// dW_hh reduction that reads its dx_proj, its rows split over the
// workspace `ws` (ws_floats floats; lstm_common.cuh), all on `stream`.
// Returns the first cudaError_t (0 on success).  Shapes as above; every
// pointer is a device pointer to a contiguous f32 array, none may be null.
extern "C" int se_lstm_scan_bwd_f32(const float* xp, const float* whh_t,
                                    const float* h0, const float* c0,
                                    const float* ys, const float* cs,
                                    const float* dys, const float* dhT,
                                    const float* dcT, float* dxp, float* dwhh_t,
                                    float* dh0, float* dc0, float* ws,
                                    int T, int L, int Bb, int H, int ws_floats,
                                    int device, void* stream) {
  return launch_scan_bwd(xp, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dxp,
                         static_cast<float*>(nullptr), dwhh_t, dh0, dc0, ws, T, L, Bb, H,
                         ws_floats, device, stream);
}

// The bf16-stream backward: xp, ys, dys and dxp bf16, the rest f32 as in
// se_lstm_scan_bwd_f32, and `dg` an f32 scratch buffer [T, L, Bb, 4H] for
// the dgates that the dW_hh reduction sums.
extern "C" int se_lstm_scan_bwd_bf16(const __nv_bfloat16* xp, const float* whh_t,
                                     const float* h0, const float* c0,
                                     const __nv_bfloat16* ys, const float* cs,
                                     const __nv_bfloat16* dys, const float* dhT,
                                     const float* dcT, __nv_bfloat16* dxp, float* dwhh_t,
                                     float* dh0, float* dc0, float* dg, float* ws,
                                     int T, int L, int Bb, int H, int ws_floats,
                                     int device, void* stream) {
  return launch_scan_bwd(xp, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dg, dxp, dwhh_t, dh0,
                         dc0, ws, T, L, Bb, H, ws_floats, device, stream);
}
