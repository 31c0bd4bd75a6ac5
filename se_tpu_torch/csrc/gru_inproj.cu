// GRU scan with the input projection inside the kernel, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of `fused_gru_scan_inproj` in
// se_tpu/ops/pallas_lstm.py: the forward (_fwd_gru_kernel and _gru_call,
// :604-619 and :702-739, gate math _gru_gates :582-601) and the backward
// (_bwd_gru_kernel and _gru_bwd, :621-699 and :762-816).  One launch runs
// L independent torch-semantics GRUs over T steps:
//
//   x      [T, L, Bb, In] f32   w_ih_t [L, In, 3H] f32   b_ih, b_hh [L, 3H] f32
//   w_hh_t [L, H, 3H]     f32   h0     [L, Bb, H]  f32   (gate order r, z, n)
//   xp = x[t] @ w_ih_t[l] + b_ih[l] ;  hp = h @ w_hh_t[l] + b_hh[l]
//   r = sigmoid(xp_r + hp_r) ;  z = sigmoid(xp_z + hp_z)
//   n = tanh(xp_n + r * hp_n) ;  h = (1 - z) * n + z * h
//   -> ys [T, L, Bb, H], hT [L, Bb, H].
//
// b_hh's n slice sits inside the product with r, so the two biases cannot be
// folded into one as K2 (lstm_inproj.cu) folds the LSTM's: the step keeps
// hp_n apart from xp_n.  The backward takes the forward's inputs, ys (the
// only stash: h is the GRU's whole state) and the cotangents (dys, dhT) and
// gives dx [T, L, Bb, In], dw_ih_t [L, In, 3H], db_ih [L, 3H],
// dw_hh_t [L, H, 3H], db_hh [L, 3H] and dh0.  It recomputes r, z, n and
// hp_n from (x[t], h_prev), h_prev = ys[t-1] or h0, as the Pallas kernel.
//
// What bounds them.  The work is 2 * T * Bb * (In + H) * 3H FLOP a forward
// and three times that a backward.  FullSubNet at B=8 x 3 s (T = 163):
// the full band (Bb = 8, In = 257 and 512, H = 512) 3.1 and 4.1 GFLOP, on
// 2 blocks: a chain of 163 dependent steps, each a pass over W_hh[l]
// (3 MB) from L2 through one SM, as K2 at CRN.  The sub band (Bb = 2056,
// In = 32 and 384, H = 384) 321 and 593 GFLOP, 0.92 TFLOP in all, 14 ms at
// the card's 67 TFLOP/s f32: hundreds of blocks, each re-reading W_hh[l]
// (1.77 MB) from L2 every step, so the L2 traffic, not the FLOP, bounds
// the simple design.  Each block's pass over W_hh serves R rows, so R sets
// that traffic: R = 8 rows a block where the batch gives more blocks of 4
// rows than the card has SMs (the sub band at enhance and train batches),
// R = 4 elsewhere (the full band, the small train-comparison batch).
//
// Design, as K2 (lstm_inproj.cu).  One block per (stack l, tile of R batch
// rows); the T loop runs inside the block, in chunks of C steps (the
// largest of 8, 4, 2 whose buffers fit the block's 227 KB of shared memory
// for this R: 8 at R = 4 on the sub band, 4 on the full band and at R = 8,
// 2 for the backward at R = 8 and In = 384).  Threads loop over the 3H gate
// columns (1536 on the full band, 1152 on the sub band; at most 512
// threads).  Forward chunk:
//   0. stage x of the chunk's C steps in shared memory as [C][In][R]; thread
//      `col` forms x[t] . W_ih[l][:, col] + b_ih[col] for all C steps and R
//      rows in one pass over W_ih (global memory, coalesced across the
//      warp, resident in L2; x read as float4 broadcasts) into the chunk's
//      gate buffer [C][R][3H];
// then per step, two phases separated by __syncthreads():
//   1. thread `col` forms hp = h . W_hh[l][:, col] + b_hh[col]; for r and z
//      it adds hp to the gate buffer, for n it keeps hp_n in its own buffer
//      [R][H];
//   2. thread (row, j) applies the gate math to unit j and writes h and ys.
// Backward chunk (chunks and steps in reverse order), after phase 0:
//   1. recompute as forward phase 1 from h_prev (ys[t-1], or h0 at t = 0),
//      staged by the previous step's phase 3;
//   2. thread (row, j): dh = dys[t] + the dh carry; da_z = dh (h_prev - n)
//      z (1 - z), da_n = dh (1 - z) (1 - n^2), da_r = da_n hp_n r (1 - r);
//      writes dxp = [da_r, da_z, da_n] to the scratch buffer dg [T, L, Bb, 3H]
//      and dhp's n slice da_n r to dgn [T, L, Bb, H]; puts dhp = [da_r, da_z,
//      da_n r] over the step's gate row and dh z in the dh carry;
//   3. one warp per unit k: the dh carry [row][k] += sum_g dhp[row][g] *
//      W_hh[l][k][g] (lanes along g, coalesced; a shuffle reduction ends each
//      sum); the block also stages h_prev of step t-1.
// Then second-pass kernels of lstm_common.cuh read the scratch, each in one
// fixed order and without atomics, so two calls give the same bits: dx =
// dg @ W_ih^T (lstm_inproj_dx_kernel), dW_ih = sum x^T dg and dW_hh = sum
// h_prev^T [dg's r, z columns | dgn] (lstm_dw_kernel, three launches), db_ih
// = sum dg and db_hh's n slice = sum dgn (lstm_inproj_dbias_kernel); db_hh's
// r and z slices equal db_ih's and are copied.  The scratch costs
// T * Bb * 4H * 4 bytes a stack: dg 3H and dgn H a row.  At FullSubNet's sub
// band, B = 10 x 3 s (Bb = 2570, T = 163, H = 384): dg 1.93 GB and dgn
// 0.64 GB, 2.57 GB in all; the Pallas kernel kept these sums in VMEM.
//
// The chunk staging and projection, the h . W_hh product and the dh pass
// are K2's, from lstm_common.cuh, at R rows.
//
// The bf16-stream form (pallas_lstm.py:614, :618, :643, :667, :734, :807)
// takes x, and gives ys, as bf16, and in the backward takes ys and dys as
// bf16 and gives dx as bf16.  x is upcast as it is staged and projected in
// f32 with the f32 W_ih; the h carry, the gates, hp_n, the dxp and dhp
// scratch, hT, dh0 and the weight and bias gradients stay f32.  The
// backward recomputes from h_prev = the bf16 ys[t-1] upcast (h0, f32, at
// t = 0), as the Pallas kernel does, so dW_hh sums the rounded ys.  Each
// stream value is converted at its load or store (to_f32, store_as in
// lstm_common.cuh), so the f32 form compiles as before.
//
// Transcendentals use expf/tanhf (no fast-math) to stay within 1e-5 of the
// plain PyTorch recurrence per step.

#include <cuda_bf16.h>

#include "lstm_common.cuh"

namespace {

constexpr int kMaxThreads = 512;     // scan block size cap; threads loop over columns
constexpr size_t kMaxSmem = 232448;  // shared memory a block can use (227 KB)

// hp = h_s . whh[:, col] + bhh[col] for the tile's rows (h_s is [H][R]):
// added to g_s[r][col] (which holds xp) for the r and z columns, kept in
// hn_s[r][col - 2H] for the n columns.
template <int R>
__device__ __forceinline__ void gru_recurrent_columns(const float* __restrict__ whh,
                                                      const float* __restrict__ bhh,
                                                      const float* h_s, float* g_s,
                                                      float* hn_s, int rows, int H, int G) {
  for (int col = threadIdx.x; col < G; col += blockDim.x) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    dot_column<R>(whh, h_s, H, G, col, acc);
    const float bv = __ldg(bhh + col);
    if (col < 2 * H) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) g_s[r * G + col] = g_s[r * G + col] + (acc[r] + bv);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < rows) hn_s[r * H + col - 2 * H] = acc[r] + bv;
      }
    }
  }
}

template <int R, int C, typename TS = float>
__global__ void __launch_bounds__(kMaxThreads)
gru_inproj_fwd_kernel(const TS* __restrict__ x,
                      const float* __restrict__ wih_t,
                      const float* __restrict__ b_ih,
                      const float* __restrict__ whh_t,
                      const float* __restrict__ b_hh,
                      const float* __restrict__ h0,
                      TS* __restrict__ ys,
                      float* __restrict__ hT,
                      int T, int L, int Bb, int In, int H) {
  extern __shared__ float4 smem4[];
  const int G = 3 * H;
  float* xc_s = reinterpret_cast<float*>(smem4);  // [C][In][R]
  float* p_s = xc_s + C * In * R;                 // [C][R][G]  the chunk's gates
  float* h_s = p_s + C * R * G;                   // [H][R]
  float* hn_s = h_s + H * R;                      // [R][H]     hp_n of the step

  const int l = blockIdx.y;
  const int b0 = blockIdx.x * R;
  const int rows = min(R, Bb - b0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const float* wih = wih_t + static_cast<size_t>(l) * In * G;
  const float* whh = whh_t + static_cast<size_t>(l) * H * G;
  const float* bih = b_ih + static_cast<size_t>(l) * G;
  const float* bhh = b_hh + static_cast<size_t>(l) * G;

  // the carry in; rows past the batch edge stay zero and are never written
  stage_rows<R>(h_s, h0 + (static_cast<size_t>(l) * Bb + b0) * H, rows, H);

  for (int t0 = 0; t0 < T; t0 += C) {
    const int n = min(C, T - t0);
    // phase 0: the chunk's input projections
    stage_chunk<R, C>(xc_s, x, t0, n, L, Bb, l, b0, rows, In);
    __syncthreads();
    project_chunk<R, C, true>(wih, bih, xc_s, p_s, In, G);
    __syncthreads();

    for (int c = 0; c < n; ++c) {
      const size_t row0 = (static_cast<size_t>(t0 + c) * L + l) * Bb + b0;
      float* g_s = p_s + c * R * G;

      // phase 1: hp of step t0 + c
      gru_recurrent_columns<R>(whh, bhh, h_s, g_s, hn_s, rows, H, G);
      __syncthreads();

      // phase 2: the gate math for (row r, unit j); pallas_lstm.py:597-600, :616
      for (int idx = tid; idx < rows * H; idx += nthr) {
        const int r = idx / H, j = idx % H;
        const float* g = g_s + r * G;
        const float rg = sigmoid_f32(g[j]);
        const float zg = sigmoid_f32(g[H + j]);
        const float ng = tanhf(g[2 * H + j] + rg * hn_s[r * H + j]);
        const float h = (1.0f - zg) * ng + zg * h_s[j * R + r];
        h_s[j * R + r] = h;
        store_as(ys + (row0 + r) * H + j, h);
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < rows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    hT[(static_cast<size_t>(l) * Bb + b0 + r) * H + j] = h_s[j * R + r];
  }
}

template <int R, int C, typename TS = float>
__global__ void __launch_bounds__(kMaxThreads)
gru_inproj_bwd_kernel(const TS* __restrict__ x,
                      const float* __restrict__ wih_t,
                      const float* __restrict__ b_ih,
                      const float* __restrict__ whh_t,
                      const float* __restrict__ b_hh,
                      const float* __restrict__ h0,
                      const TS* __restrict__ ys,
                      const TS* __restrict__ dys,
                      const float* __restrict__ dhT,
                      float* __restrict__ dh0,
                      float* __restrict__ dg,
                      float* __restrict__ dgn,
                      int T, int L, int Bb, int In, int H) {
  extern __shared__ float4 smem4[];
  const int G = 3 * H;
  float* xc_s = reinterpret_cast<float*>(smem4);  // [C][In][R]
  float* p_s = xc_s + C * In * R;                 // [C][R][G]  gates, then dhp
  float* h_s = p_s + C * R * G;                   // [H][R]     h_prev
  float* hn_s = h_s + H * R;                      // [R][H]     hp_n
  float* dh_s = hn_s + R * H;                     // [R][H]     dh carry

  const int l = blockIdx.y;
  const int b0 = blockIdx.x * R;
  const int rows = min(R, Bb - b0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const float* wih = wih_t + static_cast<size_t>(l) * In * G;
  const float* whh = whh_t + static_cast<size_t>(l) * H * G;
  const float* bih = b_ih + static_cast<size_t>(l) * G;
  const float* bhh = b_hh + static_cast<size_t>(l) * G;
  const size_t state0 = static_cast<size_t>(l) * Bb + b0;  // row of h0/dhT/dh0

  // stages step t's h_prev, rows [L, Bb, *] of ys[t-1] or h0 at t = 0
  // (in the bf16 form ys and h0 differ in type)
  auto stage_h_prev = [&](int t) {
    if constexpr (kIsF32<TS>) {
      stage_rows<R>(h_s, t > 0 ? ys + ((static_cast<size_t>(t - 1) * L + l) * Bb + b0) * H
                               : h0 + state0 * H, rows, H);
    } else if (t > 0) {
      stage_rows<R>(h_s, ys + ((static_cast<size_t>(t - 1) * L + l) * Bb + b0) * H, rows, H);
    } else {
      stage_rows<R>(h_s, h0 + state0 * H, rows, H);
    }
  };

  // the dh carry in; gate rows past the batch edge are never read into a
  // written sum (each row's dh sum uses only that row's dhp)
  for (int idx = tid; idx < R * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    dh_s[r * H + j] = r < rows ? dhT[(state0 + r) * H + j] : 0.f;
  }
  stage_h_prev(T - 1);

  for (int t0 = (T - 1) / C * C; t0 >= 0; t0 -= C) {
    const int n = min(C, T - t0);
    // phase 0: the chunk's input projections
    stage_chunk<R, C>(xc_s, x, t0, n, L, Bb, l, b0, rows, In);
    __syncthreads();
    project_chunk<R, C, true>(wih, bih, xc_s, p_s, In, G);
    __syncthreads();

    for (int c = n - 1; c >= 0; --c) {
      const int t = t0 + c;
      const size_t row0 = (static_cast<size_t>(t) * L + l) * Bb + b0;
      float* g_s = p_s + c * R * G;

      // phase 1: recompute the step's gates
      gru_recurrent_columns<R>(whh, bhh, h_s, g_s, hn_s, rows, H, G);
      __syncthreads();

      // phase 2: dxp, dhp for (row r, unit j); pallas_lstm.py:649-656
      for (int idx = tid; idx < rows * H; idx += nthr) {
        const int r = idx / H, j = idx % H;
        float* g = g_s + r * G;
        const float rg = sigmoid_f32(g[j]);
        const float zg = sigmoid_f32(g[H + j]);
        const float hpn = hn_s[r * H + j];
        const float ng = tanhf(g[2 * H + j] + rg * hpn);
        const float h_prev = h_s[j * R + r];
        const float dh = to_f32(dys[(row0 + r) * H + j]) + dh_s[r * H + j];
        const float da_z = dh * (h_prev - ng) * zg * (1.0f - zg);
        const float da_n = dh * (1.0f - zg) * (1.0f - ng * ng);
        const float da_r = da_n * hpn * rg * (1.0f - rg);
        float* d = dg + (row0 + r) * G;
        d[j] = da_r;
        d[H + j] = da_z;
        d[2 * H + j] = da_n;
        dgn[(row0 + r) * H + j] = da_n * rg;
        g[j] = da_r;
        g[H + j] = da_z;
        g[2 * H + j] = da_n * rg;
        dh_s[r * H + j] = dh * zg;
      }
      __syncthreads();

      // phase 3: dh carry += dhp @ W_hh[l]^T, one warp per unit k; then
      // stage step t-1's h_prev (phase 3 does not read h_s)
      dh_rows<R, true>(whh, g_s, dh_s, rows, H, G);
      if (t > 0) stage_h_prev(t - 1);
      __syncthreads();
    }
  }

  for (int idx = tid; idx < rows * H; idx += nthr) {
    const int r = idx / H, j = idx % H;
    dh0[(state0 + r) * H + j] = dh_s[r * H + j];
  }
}

int scan_threads(int G) {
  const int threads = G < kMaxThreads ? G : kMaxThreads;
  return (threads + 31) / 32 * 32;
}

// Rows a block: 8 where blocks of 4 rows would outnumber the SMs, else 4.
int row_tile(int Bb, int L, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
    sms = 0;
  }
  return static_cast<long long>((Bb + 3) / 4) * L > sms ? 8 : 4;
}

// Shared memory of a scan kernel with R rows, C steps a chunk and `carries`
// [R][H] buffers besides the chunk's (2 forward, 3 backward).
size_t smem_bytes(int R, int C, int In, int H, int carries) {
  return sizeof(float) * (static_cast<size_t>(C) * R * (In + 3 * H) +
                          static_cast<size_t>(carries) * H * R);
}

// The chunk length: the largest of 8, 4 (R = 4) or 4, 2 (R = 8) that fits a
// block; 0 if none does.
int chunk_steps(int R, int In, int H, int carries) {
  const int first = R == 4 ? 8 : 4;
  for (int c = first; c >= first / 2; c /= 2) {
    if (smem_bytes(R, c, In, H, carries) <= kMaxSmem) return c;
  }
  return 0;
}

template <int R, int C, typename TS>
cudaError_t launch_fwd(const TS* x, const float* wih_t, const float* b_ih,
                       const float* whh_t, const float* b_hh, const float* h0,
                       TS* ys, float* hT, int T, int L, int Bb, int In, int H,
                       cudaStream_t s) {
  const size_t smem = smem_bytes(R, C, In, H, 2);
  cudaError_t err = allow_smem(gru_inproj_fwd_kernel<R, C, TS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Bb + R - 1) / R, L);
  gru_inproj_fwd_kernel<R, C, TS><<<grid, scan_threads(3 * H), smem, s>>>(
      x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H);
  return cudaGetLastError();
}

template <int R, int C, typename TS>
cudaError_t launch_bwd(const TS* x, const float* wih_t, const float* b_ih,
                       const float* whh_t, const float* b_hh, const float* h0,
                       const TS* ys, const TS* dys, const float* dhT, float* dh0,
                       float* dg, float* dgn, int T, int L, int Bb, int In, int H,
                       cudaStream_t s) {
  const size_t smem = smem_bytes(R, C, In, H, 3);
  cudaError_t err = allow_smem(gru_inproj_bwd_kernel<R, C, TS>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Bb + R - 1) / R, L);
  gru_inproj_bwd_kernel<R, C, TS><<<grid, scan_threads(3 * H), smem, s>>>(
      x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H);
  return cudaGetLastError();
}

template <typename TS>
int gru_fwd(const TS* x, const float* wih_t, const float* b_ih, const float* whh_t,
            const float* b_hh, const float* h0, TS* ys, float* hT,
            int T, int L, int Bb, int In, int H, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = row_tile(Bb, L, device);
  switch (R * 100 + chunk_steps(R, In, H, 2)) {
    case 408: err = launch_fwd<4, 8>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, s); break;
    case 404: err = launch_fwd<4, 4>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, s); break;
    case 804: err = launch_fwd<8, 4>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, s); break;
    case 802: err = launch_fwd<8, 2>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

template <typename TS>
int gru_bwd(const TS* x, const float* wih_t, const float* b_ih, const float* whh_t,
            const float* b_hh, const float* h0, const TS* ys, const TS* dys,
            const float* dhT, TS* dx, float* dwih_t, float* db_ih, float* dwhh_t,
            float* db_hh, float* dh0, float* dg, float* dgn, float* ws,
            int T, int L, int Bb, int In, int H, int ws_floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 3 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = row_tile(Bb, L, device);
  switch (R * 100 + chunk_steps(R, In, H, 3)) {
    case 408: err = launch_bwd<4, 8>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, s); break;
    case 404: err = launch_bwd<4, 4>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, s); break;
    case 804: err = launch_bwd<8, 4>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, s); break;
    case 802: err = launch_bwd<8, 2>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dx(dg, wih_t, dx, T, L, Bb, In, G, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t wsf = static_cast<size_t>(ws_floats);
  err = launch_dw(x, nullptr, dg, G, dwih_t, G, ws, wsf, T, L, Bb, In, G, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dw(ys, h0, dg, G, dwhh_t, G, ws, wsf, T, L, Bb, H, 2 * H, 1, s);  // r, z columns
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dw(ys, h0, dgn, H, dwhh_t + 2 * H, G, ws, wsf, T, L, Bb, H, H, 1, s);  // n columns
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dbias(dg, G, db_ih, G, ws, wsf, T, L, Bb, G, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dbias(dgn, H, db_hh + 2 * H, G, ws, wsf, T, L, Bb, H, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // db_hh's r and z slices: the same sums as db_ih's
  err = cudaMemcpy2DAsync(db_hh, sizeof(float) * G, db_ih, sizeof(float) * G,
                          sizeof(float) * 2 * H, L, cudaMemcpyDeviceToDevice, s);
  return static_cast<int>(err);
}

}  // namespace

// Launches the forward scan on `stream` (a cudaStream_t) of `device`.
// Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue when the smallest chunk's buffers do not fit a
// block's shared memory).  All pointers are device pointers to contiguous
// f32 arrays of the shapes above.
extern "C" int se_gru_inproj_fwd_f32(const float* x, const float* wih_t,
                                     const float* b_ih, const float* whh_t,
                                     const float* b_hh, const float* h0,
                                     float* ys, float* hT,
                                     int T, int L, int Bb, int In, int H,
                                     int device, void* stream) {
  return gru_fwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, device, stream);
}

// The bf16-stream forward: x and ys bf16, the rest as se_gru_inproj_fwd_f32.
extern "C" int se_gru_inproj_fwd_bf16(const __nv_bfloat16* x, const float* wih_t,
                                      const float* b_ih, const float* whh_t,
                                      const float* b_hh, const float* h0,
                                      __nv_bfloat16* ys, float* hT,
                                      int T, int L, int Bb, int In, int H,
                                      int device, void* stream) {
  return gru_fwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, device, stream);
}

// Launches the backward: the reverse scan (dh0 and the scratch buffers
// dg [T, L, Bb, 3H] and dgn [T, L, Bb, H]), then the dx product and the
// dW_ih, db_ih, dW_hh and db_hh reductions that read them, their rows split
// over the workspace `ws` (ws_floats floats; lstm_common.cuh), all on
// `stream`.  Returns the first cudaError_t (0 on success;
// cudaErrorInvalidValue as for the forward).  Shapes as above; every
// pointer is a device pointer to a contiguous f32 array, none may be null.
extern "C" int se_gru_inproj_bwd_f32(const float* x, const float* wih_t,
                                     const float* b_ih, const float* whh_t,
                                     const float* b_hh, const float* h0,
                                     const float* ys, const float* dys,
                                     const float* dhT, float* dx, float* dwih_t,
                                     float* db_ih, float* dwhh_t, float* db_hh,
                                     float* dh0, float* dg, float* dgn, float* ws,
                                     int T, int L, int Bb, int In, int H, int ws_floats,
                                     int device, void* stream) {
  return gru_bwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dx, dwih_t, db_ih, dwhh_t,
                 db_hh, dh0, dg, dgn, ws, T, L, Bb, In, H, ws_floats, device, stream);
}

// The bf16-stream backward: x, ys, dys and dx bf16, the rest (the dg and
// dgn scratch too) f32 as in se_gru_inproj_bwd_f32.
extern "C" int se_gru_inproj_bwd_bf16(const __nv_bfloat16* x, const float* wih_t,
                                      const float* b_ih, const float* whh_t,
                                      const float* b_hh, const float* h0,
                                      const __nv_bfloat16* ys, const __nv_bfloat16* dys,
                                      const float* dhT, __nv_bfloat16* dx, float* dwih_t,
                                      float* db_ih, float* dwhh_t, float* db_hh,
                                      float* dh0, float* dg, float* dgn, float* ws,
                                      int T, int L, int Bb, int In, int H, int ws_floats,
                                      int device, void* stream) {
  return gru_bwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dx, dwih_t, db_ih, dwhh_t,
                 db_hh, dh0, dg, dgn, ws, T, L, Bb, In, H, ws_floats, device, stream);
}
