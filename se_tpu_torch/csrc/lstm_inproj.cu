// LSTM scan with the input projection inside the kernel, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of `fused_lstm_scan_inproj` in
// se_tpu/ops/pallas_lstm.py: the forward (_fwd_inproj_kernel and
// _inproj_call, :306-335 and :432-479) and the backward
// (_bwd_inproj_kernel and _inproj_bwd, :338-429 and :503-563).  One launch
// runs L independent LSTMs over T steps:
//
//   x      [T, L, Bb, In] f32    w_ih_t [L, In, 4H] f32   bias [L, 4H] f32
//   w_hh_t [L, H, 4H]     f32    h0, c0 [L, Bb, H]  f32
//   gates = (x[t] @ w_ih_t[l] + h @ w_hh_t[l]) + bias[l]   (gate order i, f, g, o)
//   c = f * c + i * g ;  h = o * tanh(c)
//   -> ys [T, L, Bb, H], hT, cT [L, Bb, H], all f32, and, when the caller
//      passes a buffer for it (training), the cell-state stash cs [T, L, Bb, H].
//
// The backward takes the forward's inputs, (ys, cs) and the cotangents
// (dys, dhT, dcT) and gives dx [T, L, Bb, In], dw_ih_t [L, In, 4H],
// dbias [L, 4H], dw_hh_t [L, H, 4H], dh0 and dc0.  It recomputes the
// gates from (x, h_prev), as the Pallas kernel does.
//
// What bounds them.  The work is 2 * T * Bb * (In + H) * 4H FLOP a
// forward (CRN at B=8: T=483, In=512, H=128, 2.53 GFLOP, 0.038 ms at
// 67 TFLOP/s f32) and three times that a backward; the bytes are a few
// tens of MB.  The real limit is the chain of T dependent steps: each step
// needs the whole previous h (or dh), so a step costs at least one pass
// over W_hh[l] (CRN: 256 KiB) from L2 through one SM, plus its barriers.
// W_ih[l] (CRN: 1 MiB; DCCRN's real LSTM, layer 0: 4 MiB) does not wait on
// the recurrence, and a pass over it every step cost three quarters of the
// step at CRN's shapes (PERF.md), so it is read once per chunk of kChunk
// steps.
//
// Design.  One block per (stack l, tile of kRows batch rows); the T loop
// runs inside the block, in chunks of C steps (C = 8, or 4 where eight
// steps' buffers would not fit the block's shared memory: DCCRN's real
// LSTM layer 0, In = 1024 and H = 256, and FullSubNet's full band).  Threads
// loop over gate columns, so 4H may exceed the block's thread count
// (4H = 2048 at H = 512); In need not be a multiple of 4 or 32 (x is
// staged in shared memory row by row).  Forward chunk:
//   0. stage x of the chunk's C steps in shared memory, then thread `col`
//      forms x[t] . W_ih[l][:, col] for all C steps and kRows rows in one
//      pass over W_ih (read from global memory, coalesced across the warp,
//      resident in the 50 MB L2; x from shared memory, one float4
//      broadcast giving all kRows rows at one k) into the gate buffer
//      [C][kRows][4H];
// then per step, two phases separated by __syncthreads():
//   1. thread `col` adds h . W_hh[l][:, col], then bias[col], to its gate
//      column of the step;
//   2. thread (r, j) applies the gate math to unit j of row r and writes
//      h, c, ys and the stash.
// Backward chunk (chunks and steps in reverse order), after phase 0 as in
// the forward:
//   1. recompute the step's gates as forward phase 1 from h_prev (ys[t-1],
//      or h0 at t = 0), staged by the previous phase 3;
//   2. thread (r, j) forms dgates for unit j of row r from the gates,
//      c_prev, cs[t], dh = dys[t] + dh carry and the dc carry; writes them
//      over the step's gates in shared memory and to the dgates scratch
//      buffer [T, L, Bb, 4H]; sets the dc carry to dc * f;
//   3. one warp per unit k: the dh carry [r][k] = sum_g dgates[r][g] *
//      W_hh[l][k][g]; the lanes read row k of w_hh_t along g, coalesced,
//      and a shuffle reduction ends each sum.  The block also stages h_prev
//      of step t-1.
// Nothing in the recurrence waits on dx = dgates @ W_ih^T, dW_ih, dW_hh or
// dbias, and a warp per input unit inside the scan spent most of its time
// reading the chunk's dgates from shared memory once per unit.  So
// second-pass kernels read the dgates scratch buffer, each with its sums
// in one fixed order and no atomics, so two calls give the same bits:
// lstm_inproj_dx_kernel (a 32 x 32 tile of dx per block, over all T x Bb
// rows at once), lstm_dw_kernel (a 32 x 32 tile of dW per block; the row
// operand is x, or h_prev read from ys shifted by one step) and
// lstm_inproj_dbias_kernel (column sums), all three in lstm_common.cuh.
// The scratch costs T * Bb * 4H * 4 bytes a stack (9.9 MB at CRN's train
// batch of 10; 2.57 GB at FullSubNet's sub band, B=10 x 3 s: Bb=2570,
// T=163, 4H=1536); the Pallas kernel kept these sums in VMEM, and folding
// them into the scan is part of the redesign (ROADMAP, Queue 2).
//
// The chunk staging and projection, the gate products, the gate math, the
// dh pass and the dx, dW and dbias reductions come from lstm_common.cuh,
// shared with lstm_scan.cu, gru_inproj.cu and wavefront_lstm.cu.
//
// The bf16-stream form (pallas_lstm.py:13-14; the kernels' :318-321, :334,
// :397 and :553) takes x, and gives ys, as bf16, and in the backward takes
// ys and dys as bf16 and gives dx as bf16.  x is upcast as it is staged
// and projected in f32 with the f32 W_ih, as the Pallas kernel does; the
// carry, the gates, the stash cs, the dgates scratch and the weight and
// bias gradients stay f32 (dW_ih sums the upcast x, dW_hh the rounded ys
// the backward recomputes from, :361).  Each stream value is converted at
// its load or store (to_f32, store_as in lstm_common.cuh), so the f32 form
// compiles as before.
//
// The bound probe (P1; se_tpu_torch/probes/bound_probe.py, replacing the
// Pallas kernel of tools/bound_probe.py:43-138) is this forward kernel
// with its phase 2 swapped at compile time (the template argument M): the
// LSTM cell (kReal, the kernel K2 launches), the cell with its gate
// pre-activations and transcendentals rounded to bf16 (kBf16Gates), the
// transcendentals replaced by multiplies (kPolySwap), or no gate math at
// all (kNoGates).  Its entry, se_lstm_inproj_probe_f32, runs one stack
// (L = 1) and writes no stash.

#include <cuda_bf16.h>

#include "lstm_common.cuh"

namespace {

constexpr int kMaxThreads = 512;  // scan block size cap; threads loop over columns
constexpr int kChunk = 8;         // steps whose projections one pass over W_ih forms
constexpr size_t kMaxSmem = 232448;  // shared memory a block can use (227 KB)

// The forward's phase 2: the LSTM's gate math, or one of the bound probe's
// three ablations of it (tools/bound_probe.py:65-92).
enum GateMode : int { kReal = 0, kBf16Gates = 1, kPolySwap = 2, kNoGates = 3 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 1 / (1 + exp(-v)) with v, exp's result, the sum and the quotient each
// rounded to bf16, as the probe's jnp expression on a bf16 array.
__device__ __forceinline__ float sigmoid_bf16(float v) {
  const float e = bf16_round(expf(-bf16_round(v)));
  return bf16_round(1.0f / bf16_round(1.0f + e));
}

__device__ __forceinline__ float tanh_bf16(float v) { return bf16_round(tanhf(bf16_round(v))); }

// The cell update of unit j under gate mode M, from a row of gate
// pre-activations g (4H, gate order i, f, g, o): returns c and sets *h.
template <int M>
__device__ __forceinline__ float cell_mode(const float* g, int H, int j, float c_prev,
                                           float* h) {
  if constexpr (M == kReal) {
    return cell_forward(g, H, j, c_prev, h);
  } else if constexpr (M == kBf16Gates) {
    const float ig = sigmoid_bf16(g[j]);
    const float fg = sigmoid_bf16(g[H + j]);
    const float gg = tanh_bf16(g[2 * H + j]);
    const float og = sigmoid_bf16(g[3 * H + j]);
    const float c = fg * c_prev + ig * gg;
    *h = og * tanh_bf16(c);
    return c;
  } else if constexpr (M == kPolySwap) {
    const float ig = g[j] * 0.25f, fg = g[H + j] * 0.25f;
    const float gg = g[2 * H + j] * 0.5f, og = g[3 * H + j] * 0.25f;
    const float c = fg * c_prev + ig * gg;
    *h = og * (c * 0.5f);
    return c;
  } else {
    *h = g[3 * H + j];
    return g[H + j] * c_prev + g[j];
  }
}

template <int C, int M, typename TS = float>
__global__ void __launch_bounds__(kMaxThreads)
lstm_inproj_fwd_kernel(const TS* __restrict__ x,
                       const float* __restrict__ wih_t,
                       const float* __restrict__ bias,
                       const float* __restrict__ whh_t,
                       const float* __restrict__ h0,
                       const float* __restrict__ c0,
                       TS* __restrict__ ys,
                       float* __restrict__ cs,
                       float* __restrict__ hT,
                       float* __restrict__ cT,
                       int T, int L, int Bb, int In, int H) {
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  float* xc_s = reinterpret_cast<float*>(smem4);  // [C][In][kRows]
  float* p_s = xc_s + C * In * kRows;             // [C][kRows][G]  the chunk's gates
  float* h_s = p_s + C * kRows * G;               // [H][kRows]
  float* c_s = h_s + H * kRows;                   // [kRows][H]

  const int l = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, Bb - b0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const float* wih = wih_t + static_cast<size_t>(l) * In * G;
  const float* whh = whh_t + static_cast<size_t>(l) * H * G;
  const float* b = bias + static_cast<size_t>(l) * G;

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

  for (int t0 = 0; t0 < T; t0 += C) {
    const int n = min(C, T - t0);
    // phase 0: the chunk's input projections
    stage_chunk<kRows, C>(xc_s, x, t0, n, L, Bb, l, b0, rows, In);
    __syncthreads();
    project_chunk<kRows, C, false>(wih, nullptr, xc_s, p_s, In, G);
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      const size_t row0 = (static_cast<size_t>(t0 + c) * L + l) * Bb + b0;
      float* g_s = p_s + c * kRows * G;

      // phase 1: the gates of step t0 + c
      recurrent_columns(whh, b, h_s, g_s, rows, H, G);
      __syncthreads();

      // phase 2: cell update for (row r, unit j)
      for (int idx = tid; idx < rows * H; idx += nthr) {
        const int r = idx / H, j = idx % H;
        float h;
        const float cn = cell_mode<M>(g_s + r * G, H, j, c_s[r * H + j], &h);
        c_s[r * H + j] = cn;
        h_s[j * kRows + r] = h;
        store_as(ys + (row0 + r) * H + j, h);
        if (cs != nullptr) cs[(row0 + r) * H + j] = cn;
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < rows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    const size_t o = (static_cast<size_t>(l) * Bb + b0 + r) * H + j;
    hT[o] = h_s[j * kRows + r];
    cT[o] = c_s[r * H + j];
  }
}

template <int C, typename TS = float>
__global__ void __launch_bounds__(kMaxThreads)
lstm_inproj_bwd_kernel(const TS* __restrict__ x,
                       const float* __restrict__ wih_t,
                       const float* __restrict__ bias,
                       const float* __restrict__ whh_t,
                       const float* __restrict__ h0,
                       const float* __restrict__ c0,
                       const TS* __restrict__ ys,
                       const float* __restrict__ cs,
                       const TS* __restrict__ dys,
                       const float* __restrict__ dhT,
                       const float* __restrict__ dcT,
                       float* __restrict__ dh0,
                       float* __restrict__ dc0,
                       float* __restrict__ dg,
                       int T, int L, int Bb, int In, int H) {
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  float* xc_s = reinterpret_cast<float*>(smem4);  // [C][In][kRows]
  float* p_s = xc_s + C * In * kRows;             // [C][kRows][G]  gates, then dgates
  float* h_s = p_s + C * kRows * G;               // [H][kRows]   h_prev
  float* dh_s = h_s + H * kRows;                  // [kRows][H]   dh carry
  float* dc_s = dh_s + kRows * H;                 // [kRows][H]   dc carry

  const int l = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, Bb - b0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t LBb = static_cast<size_t>(L) * Bb;
  const float* wih = wih_t + static_cast<size_t>(l) * In * G;
  const float* whh = whh_t + static_cast<size_t>(l) * H * G;
  const float* b = bias + static_cast<size_t>(l) * G;
  const size_t state0 = static_cast<size_t>(l) * Bb + b0;  // row of h0/c0/dh0/dc0

  // stages step t's h_prev, rows [L, Bb, *] of ys[t-1] or h0 at t = 0
  // (in the bf16 form ys and h0 differ in type)
  auto stage_h_prev = [&](int t) {
    if constexpr (kIsF32<TS>) {
      stage_rows<kRows>(h_s, t > 0 ? ys + ((static_cast<size_t>(t - 1) * L + l) * Bb + b0) * H
                                   : h0 + state0 * H, rows, H);
    } else if (t > 0) {
      stage_rows<kRows>(h_s, ys + ((static_cast<size_t>(t - 1) * L + l) * Bb + b0) * H, rows, H);
    } else {
      stage_rows<kRows>(h_s, h0 + state0 * H, rows, H);
    }
  };

  // carries in; gate rows past the batch edge hold the projection of zero
  // rows, 0, and are never written, so their dgates add nothing to the dh
  // sums below
  for (int idx = tid; idx < kRows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    float dh = 0.f, dc = 0.f;
    if (r < rows) {
      dh = dhT[state0 * H + static_cast<size_t>(r) * H + j];
      dc = dcT[state0 * H + static_cast<size_t>(r) * H + j];
    }
    dh_s[r * H + j] = dh;
    dc_s[r * H + j] = dc;
  }
  stage_h_prev(T - 1);

  for (int t0 = (T - 1) / C * C; t0 >= 0; t0 -= C) {
    const int n = min(C, T - t0);
    // phase 0: the chunk's input projections
    stage_chunk<kRows, C>(xc_s, x, t0, n, L, Bb, l, b0, rows, In);
    __syncthreads();
    project_chunk<kRows, C, false>(wih, nullptr, xc_s, p_s, In, G);
    __syncthreads();

    for (int c = n - 1; c >= 0; --c) {
      const int t = t0 + c;
      const size_t row0 = (static_cast<size_t>(t) * L + l) * Bb + b0;
      const float* c_prev = t > 0 ? cs + (row0 - LBb) * H : c0 + state0 * H;
      float* g_s = p_s + c * kRows * G;

      // phase 1: recompute the gates
      recurrent_columns(whh, b, h_s, g_s, rows, H, G);
      __syncthreads();

      // phase 2: dgates for (row r, unit j); pallas_lstm.py:373-386, :429
      for (int idx = tid; idx < rows * H; idx += nthr) {
        const int r = idx / H, j = idx % H;
        const size_t o = (row0 + r) * H + j;
        dc_s[r * H + j] = cell_backward(g_s + r * G, dg + (row0 + r) * G, H, j,
                                        c_prev[r * H + j], cs[o],
                                        to_f32(dys[o]) + dh_s[r * H + j], dc_s[r * H + j]);
      }
      __syncthreads();

      // phase 3: dh carry = dgates @ W_hh[l]^T, one warp per unit k; then
      // stage step t-1's h_prev (phase 3 does not read h_s)
      dh_rows(whh, g_s, dh_s, rows, H, G);
      if (t > 0) stage_h_prev(t - 1);
      __syncthreads();
    }

  }

  for (int idx = tid; idx < rows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    const size_t o = (state0 + r) * H + j;
    dh0[o] = dh_s[r * H + j];
    dc0[o] = dc_s[r * H + j];
  }
}

int scan_threads(int H) {
  const int G = 4 * H;
  const int threads = G < kMaxThreads ? G : kMaxThreads;
  return (threads + 31) / 32 * 32;
}

// The chunk length C for a scan kernel whose shared memory is
// C * per_step + fixed floats: kChunk, or half of it where that does not
// fit a block; 0 if neither fits.
int chunk_steps(size_t per_step, size_t fixed) {
  for (int c = kChunk; c >= kChunk / 2; c /= 2) {
    if (sizeof(float) * (c * per_step + fixed) <= kMaxSmem) return c;
  }
  return 0;
}

template <int C, int M = kReal, typename TS = float>
cudaError_t launch_fwd(const TS* x, const float* wih_t, const float* bias,
                       const float* whh_t, const float* h0, const float* c0,
                       TS* ys, float* cs, float* hT, float* cT,
                       int T, int L, int Bb, int In, int H, cudaStream_t s) {
  const int G = 4 * H;
  const size_t smem = sizeof(float) * (static_cast<size_t>(C) * kRows * (In + G) +
                                       static_cast<size_t>(2) * H * kRows);
  cudaError_t err = allow_smem(lstm_inproj_fwd_kernel<C, M, TS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Bb + kRows - 1) / kRows, L);
  lstm_inproj_fwd_kernel<C, M, TS><<<grid, scan_threads(H), smem, s>>>(
      x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H);
  return cudaGetLastError();
}

// The bound probe's launch for chunk length C: one stack, no stash.
template <int C>
cudaError_t launch_probe(int mode, const float* x, const float* wih_t, const float* bias,
                         const float* whh_t, const float* h0, const float* c0, float* ys,
                         float* hT, float* cT, int T, int Bb, int In, int H, cudaStream_t s) {
  switch (mode) {
    case kReal: return launch_fwd<C, kReal>(x, wih_t, bias, whh_t, h0, c0, ys, nullptr, hT, cT, T, 1, Bb, In, H, s);
    case kBf16Gates: return launch_fwd<C, kBf16Gates>(x, wih_t, bias, whh_t, h0, c0, ys, nullptr, hT, cT, T, 1, Bb, In, H, s);
    case kPolySwap: return launch_fwd<C, kPolySwap>(x, wih_t, bias, whh_t, h0, c0, ys, nullptr, hT, cT, T, 1, Bb, In, H, s);
    case kNoGates: return launch_fwd<C, kNoGates>(x, wih_t, bias, whh_t, h0, c0, ys, nullptr, hT, cT, T, 1, Bb, In, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int C, typename TS>
cudaError_t launch_bwd(const TS* x, const float* wih_t, const float* bias,
                       const float* whh_t, const float* h0, const float* c0,
                       const TS* ys, const float* cs, const TS* dys,
                       const float* dhT, const float* dcT, float* dh0,
                       float* dc0, float* dg, int T, int L, int Bb, int In, int H,
                       cudaStream_t s) {
  const int G = 4 * H;
  const size_t smem = sizeof(float) * (static_cast<size_t>(C) * kRows * (In + G) +
                                       static_cast<size_t>(3) * H * kRows);
  cudaError_t err = allow_smem(lstm_inproj_bwd_kernel<C, TS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Bb + kRows - 1) / kRows, L);
  lstm_inproj_bwd_kernel<C, TS><<<grid, scan_threads(H), smem, s>>>(
      x, wih_t, bias, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dh0, dc0, dg,
      T, L, Bb, In, H);
  return cudaGetLastError();
}

template <typename TS>
int inproj_fwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
               const float* h0, const float* c0, TS* ys, float* cs, float* hT, float* cT,
               int T, int L, int Bb, int In, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk_steps(static_cast<size_t>(kRows) * (In + 4 * H),
                      static_cast<size_t>(2) * H * kRows)) {
    case 8: err = launch_fwd<8, kReal, TS>(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, s); break;
    case 4: err = launch_fwd<4, kReal, TS>(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename TS>
int inproj_bwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
               const float* h0, const float* c0, const TS* ys, const float* cs,
               const TS* dys, const float* dhT, const float* dcT, TS* dx, float* dwih_t,
               float* dbias, float* dwhh_t, float* dh0, float* dc0, float* dg,
               int T, int L, int Bb, int In, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk_steps(static_cast<size_t>(kRows) * (In + G),
                      static_cast<size_t>(3) * H * kRows)) {
    case 8: err = launch_bwd<8, TS>(x, wih_t, bias, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dh0, dc0, dg, T, L, Bb, In, H, s); break;
    case 4: err = launch_bwd<4, TS>(x, wih_t, bias, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dh0, dc0, dg, T, L, Bb, In, H, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dx(dg, wih_t, dx, T, L, Bb, In, G, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dw(x, nullptr, dg, G, dwih_t, G, T, L, Bb, In, G, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dw(ys, h0, dg, G, dwhh_t, G, T, L, Bb, H, G, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dbias(dg, G, dbias, G, T, L, Bb, G, s));
}

}  // namespace

// Launches the forward scan on `stream` (a cudaStream_t) of `device`.
// Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue when four steps' buffers do not fit a block's
// shared memory).  All pointers are device pointers to contiguous f32
// arrays of the shapes above; `cs` may be null, and then no stash is
// written.
extern "C" int se_lstm_inproj_fwd_f32(const float* x, const float* wih_t,
                                      const float* bias, const float* whh_t,
                                      const float* h0, const float* c0,
                                      float* ys, float* cs, float* hT, float* cT,
                                      int T, int L, int Bb, int In, int H,
                                      int device, void* stream) {
  return inproj_fwd(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H,
                    device, stream);
}

// The bf16-stream forward: x and ys bf16, the rest as se_lstm_inproj_fwd_f32.
extern "C" int se_lstm_inproj_fwd_bf16(const __nv_bfloat16* x, const float* wih_t,
                                       const float* bias, const float* whh_t,
                                       const float* h0, const float* c0,
                                       __nv_bfloat16* ys, float* cs, float* hT, float* cT,
                                       int T, int L, int Bb, int In, int H,
                                       int device, void* stream) {
  return inproj_fwd(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H,
                    device, stream);
}

// Launches the bound probe's forward (one stack: x [T, Bb, In], w_ih_t
// [In, 4H], bias [4H], w_hh_t [H, 4H], h0, c0 [Bb, H] -> ys [T, Bb, H], hT,
// cT [Bb, H]) with the gate math of `mode` (GateMode: 0 real, 1 bf16
// gates, 2 polyswap, 3 no gates) on `stream` of `device`.  Mode 0 is the
// very kernel of se_lstm_inproj_fwd_f32.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for an unknown mode or when four steps'
// buffers do not fit a block).
extern "C" int se_lstm_inproj_probe_f32(const float* x, const float* wih_t,
                                        const float* bias, const float* whh_t,
                                        const float* h0, const float* c0,
                                        float* ys, float* hT, float* cT,
                                        int T, int Bb, int In, int H, int mode,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk_steps(static_cast<size_t>(kRows) * (In + 4 * H),
                      static_cast<size_t>(2) * H * kRows)) {
    case 8: err = launch_probe<8>(mode, x, wih_t, bias, whh_t, h0, c0, ys, hT, cT, T, Bb, In, H, s); break;
    case 4: err = launch_probe<4>(mode, x, wih_t, bias, whh_t, h0, c0, ys, hT, cT, T, Bb, In, H, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Launches the backward: the reverse scan (dh0, dc0 and the dgates
// scratch `dg` [T, L, Bb, 4H]), then the dx product and the dW_ih, dW_hh
// and dbias reductions that read it, all on `stream`.  Returns the first
// cudaError_t (0 on success; cudaErrorInvalidValue as for the forward).
// Shapes as above; every pointer is a device pointer to a contiguous f32
// array, none may be null.
extern "C" int se_lstm_inproj_bwd_f32(const float* x, const float* wih_t,
                                      const float* bias, const float* whh_t,
                                      const float* h0, const float* c0,
                                      const float* ys, const float* cs,
                                      const float* dys, const float* dhT,
                                      const float* dcT, float* dx, float* dwih_t,
                                      float* dbias, float* dwhh_t, float* dh0,
                                      float* dc0, float* dg,
                                      int T, int L, int Bb, int In, int H,
                                      int device, void* stream) {
  return inproj_bwd(x, wih_t, bias, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dx, dwih_t, dbias,
                    dwhh_t, dh0, dc0, dg, T, L, Bb, In, H, device, stream);
}

// The bf16-stream backward: x, ys, dys and dx bf16, the rest (the dgates
// scratch too) f32 as in se_lstm_inproj_bwd_f32.
extern "C" int se_lstm_inproj_bwd_bf16(const __nv_bfloat16* x, const float* wih_t,
                                       const float* bias, const float* whh_t,
                                       const float* h0, const float* c0,
                                       const __nv_bfloat16* ys, const float* cs,
                                       const __nv_bfloat16* dys, const float* dhT,
                                       const float* dcT, __nv_bfloat16* dx, float* dwih_t,
                                       float* dbias, float* dwhh_t, float* dh0,
                                       float* dc0, float* dg,
                                       int T, int L, int Bb, int In, int H,
                                       int device, void* stream) {
  return inproj_bwd(x, wih_t, bias, whh_t, h0, c0, ys, cs, dys, dhT, dcT, dx, dwih_t, dbias,
                    dwhh_t, dh0, dc0, dg, T, L, Bb, In, H, device, stream);
}
