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
// the full band (Bb = 8, In = 257 and 512, H = 512) 3.1 and 4.1 GFLOP; the
// sub band (Bb = 2056, In = 32 and 384, H = 384) 321 and 593 GFLOP, 0.92
// TFLOP in all, 14 ms at the card's 67 TFLOP/s f32.  The limit is the chain
// of T dependent steps, each a pass over W_hh[l] (3 MB at the full band,
// 1.77 MB at the sub band) and, at the sub band, over W_ih[l].
//
// Three designs; the planner in Python (se_tpu_torch/ops/fused_gru_inproj.py
// ::plan) picks one per shape, the one measured faster there, and passes
// it to the entries below (one set per design), which never switch at run
// time.
//
// The wave design (gru_wave_{fwd,bwd}_kernel), at the sub band from B = 5
// (Bb = 257 B rows, In = 32 and 384, H = 384), on the gate product of
// gate_product.cuh (P2's): a CTA owns 16 rows of one stack and all H (at
// most 384) units, so B = 8 runs in one wave of 129 CTAs, in clusters of 2
// that share each W slab by multicast from a cp.async.bulk ring; f32 FFMA
// on 8 x 8 register tiles.  A GRU unit with its n gate split into an x part
// and an h part has four accumulator columns, r, z, n_x and n_h, as the
// LSTM's four gates: the wrapper lays out (W_ih; W_hh) as [k][u][4]
// (W_ih's n in n_x, W_hh's in n_h; fused_gru_inproj.wave_layout), so
// n = tanh(n_x + r n_h) comes straight from the accumulators.  Each gate's
// sum runs over k in one chain, x then h (within rounding of the other
// designs, not their bits).  The padding costs a third more FMAs (1.22
// against 0.92 TFLOP a FullSubNet-GRU forward at B = 8).  The backward
// recomputes the product per step and adds dhp . W_hh^T from a second
// stretch of the ring (DhSlabs).
//
// The cluster design (gru_cluster_{fwd,bwd}_kernel), K2's (lstm_inproj.cu)
// on the machinery of cluster_scan.cuh.  A cluster of N CTAs owns a tile
// of R batch rows of one stack; CTA q owns U = ceil(H / N) units and their
// three gate columns (3U local columns c = gate * U + u), so the cell
// update h = (1 - z) n + z h never leaves the CTA.  The CTA keeps its W_hh
// slice [H][U][3] in shared memory for all T steps (the design is taken
// only where the slice fits beside the step's buffers and the launch's
// clusters run at once: FullSubNet's full band, two clusters of 4 rows,
// 194 KiB of slice a CTA), and runs kThreads threads.  Forward,
// per chunk of C steps: the chunk's x staged and its x . W_ih formed (a
// thread per step, column and 4 rows, the sum over k in order); per step:
//   1. a thread per (column, 4 rows): hp = h . W_hh[:, col] + b_hh[col],
//      the sum over k in order from the slice; r and z: (xp + b_ih) + hp
//      into the chunk's buffer, n: xp + b_ih there and hp_n apart (b_hh's n
//      slice sits inside r * hp_n), so each value is the per-block
//      design's to the bit;
//   2. a thread per (unit, 4 rows): the gate math, as the per-block kernel;
//   3. the exchange, as K2f: one h buffer [H][R]; the CTA arrives once it
//      has read h, writes ys, waits for every CTA to have read its h,
//      writes its units' h into every CTA's buffer (store_peer), and a
//      cluster barrier ends the step.
// Backward, chunks and steps in reverse, after the chunk's projection:
//   1. the gates and hp_n recomputed from h_prev (ys[t-1] or h0, staged
//      from memory, all H units), as the forward forms them;
//   2. a thread per (unit, 4 rows): dh = dys[t] + the dh carry; da_z, da_n,
//      da_r as the per-block kernel; dxp = [da_r, da_z, da_n] into the
//      scratch dg and da_n r into dgn; dhp = [da_r, da_z, da_n r] over the
//      step's gate columns; the carry becomes dh z; then step t-1's h_prev
//      is staged;
//   3. a thread per (unit k, 4 rows): the CTA's partial dh over its 3U
//      columns, sum_c dhp[c] W_hh[k][col(c)] in local column order, from the
//      slice read along k (lanes on consecutive k, rows an odd number of
//      floats apart: no bank conflict), stored into the receive buffer
//      [N][U][R] of unit k's owner through distributed shared memory;
//   4. a cluster barrier; each CTA sums its units' N partials in rank order
//      0..N-1 (no atomics: two calls give the same bits) and adds the sum
//      to its dh carry, which the next step's cell update reads after the
//      barrier of step 1.  One receive buffer: a split barrier (arrive
//      after the sum, wait before the next step's stores) keeps a peer's
//      next partials from landing before the sum has read this step's.
//
// The per-block design (gru_inproj_{fwd,bwd}_kernel<R, C>, K3's first), for the
// shapes where it is faster: the sub band at B = 1 to 4 and a stream's
// chunk (Bb = 257), where its blocks of 4 or 8 rows all run at once and the
// wave design's 16-row CTAs leave most SMs idle (B = 1: 7.5 against 10.8
// ms a forward at sb l0; PERF.md §6).  One block per (stack l, tile of R batch
// rows); the T loop runs inside the block, in chunks of C steps (the
// largest of 8, 4, 2 whose buffers fit the block's 227 KB of shared memory
// for this R).  Each block re-reads W_hh[l] from L2 every step, so R sets
// that traffic: R = 8 rows a block where the batch gives more blocks of 4
// rows than the card has SMs, R = 4 elsewhere.  Threads loop over the 3H
// gate columns (at most 512 threads).  Forward chunk:
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
//
// Both designs' backwards then run the second-pass kernels of
// lstm_common.cuh over the scratch, each in one fixed order and without
// atomics, so two calls give the same bits: dx = dg @ W_ih^T
// (lstm_inproj_dx_kernel), dW_ih = sum x^T dg and dW_hh = sum h_prev^T
// [dg's r, z columns | dgn] (lstm_dw_kernel, three launches), db_ih = sum
// dg and db_hh's n slice = sum dgn (lstm_inproj_dbias_kernel); db_hh's r
// and z slices equal db_ih's and are copied.  The scratch costs
// T * Bb * 4H * 4 bytes a stack: dg 3H and dgn H a row.  At FullSubNet's sub
// band, B = 10 x 3 s (Bb = 2570, T = 163, H = 384): dg 1.93 GB and dgn
// 0.64 GB, 2.57 GB in all; the Pallas kernel kept these sums in VMEM.
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

#include "cluster_scan.cuh"
#include "gate_product.cuh"

namespace {

// ---- The per-block design --------------------------------------------------

constexpr int kMaxThreads = 512;  // its block size cap; threads loop over columns

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

// ---- The cluster design ----------------------------------------------------

// For each (column c, 4-row group) of the CTA, c =
// gate * U + u: hp = h_s[:][r0 ..] . W_hh[:, col(c)] + b_hh[col], the sum
// over k in order from the resident slice w_s [H][ldw] ([k][u][gate]);
// g_s holds the step's x . W_ih (no bias): the r and z columns become
// (xp + b_ih) + hp, the n column xp + b_ih, and hp_n goes to hn_s [U][R].
// Each sum and bias is added as the per-block kernel adds it
// (project_chunk<R, C, true>, gru_recurrent_columns), so the gates keep
// its bits.
__device__ __forceinline__ void gru_gate_cols(const float* w_s, int ldw,
                                              const float* __restrict__ bih,
                                              const float* __restrict__ bhh, const float* h_s,
                                              float* g_s, float* hn_s, const Cta<3>& k, int H) {
  const int R = k.R;
  for (int it = threadIdx.x; it < k.GU * (R / kQuad); it += blockDim.x) {
    const int c = it % k.GU, r0 = kQuad * (it / k.GU);
    const int gate = c / k.U, u = c % k.U;
    if (u >= k.nu) continue;
    const int col = k.col(c, H);
    const float* wc = w_s + 3 * u + gate;
    float acc[kQuad] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int kk = 0; kk < H; ++kk) fma_rows<kQuad>(h_s + kk * R + r0, wc[kk * ldw], acc);
    const float bi = __ldg(bih + col), bh = __ldg(bhh + col);
    float4* p = reinterpret_cast<float4*>(g_s + c * R + r0);
    float4 v = *p;
    if (gate < 2) {
      v.x = (v.x + bi) + (acc[0] + bh);
      v.y = (v.y + bi) + (acc[1] + bh);
      v.z = (v.z + bi) + (acc[2] + bh);
      v.w = (v.w + bi) + (acc[3] + bh);
    } else {
      v.x = v.x + bi;
      v.y = v.y + bi;
      v.z = v.z + bi;
      v.w = v.w + bi;
      *reinterpret_cast<float4*>(hn_s + u * R + r0) =
          make_float4(acc[0] + bh, acc[1] + bh, acc[2] + bh, acc[3] + bh);
    }
    *p = v;
  }
}

// The r, z and n pre-activations (n: xp_n + b_ih only), hp_n and h_prev of
// unit u for rows r0 .. r0+3.
struct UnitGates {
  float r[kQuad], z[kQuad], xn[kQuad], hn[kQuad], h[kQuad];
};

__device__ __forceinline__ UnitGates unit_gates(const float* g_s, const float* hn_s,
                                                const float* h_s, int u, int r0,
                                                const Cta<3>& k) {
  const int R = k.R, U = k.U;
  UnitGates v;
  unpack(*reinterpret_cast<const float4*>(g_s + u * R + r0), v.r);
  unpack(*reinterpret_cast<const float4*>(g_s + (U + u) * R + r0), v.z);
  unpack(*reinterpret_cast<const float4*>(g_s + (2 * U + u) * R + r0), v.xn);
  unpack(*reinterpret_cast<const float4*>(hn_s + u * R + r0), v.hn);
  unpack(*reinterpret_cast<const float4*>(h_s + (k.u0 + u) * R + r0), v.h);
  return v;
}

template <typename TS>
__global__ void __launch_bounds__(kThreads)
gru_cluster_fwd_kernel(const TS* __restrict__ x, const float* __restrict__ wih_t,
                       const float* __restrict__ b_ih, const float* __restrict__ whh_t,
                       const float* __restrict__ b_hh, const float* __restrict__ h0,
                       TS* __restrict__ ys, float* __restrict__ hT, int T, int L, int Bb, int In,
                       int H, int R, int N, int C) {
  extern __shared__ float4 smem4[];
  const Cta<3> k(Bb, H, R, N);
  const int G = 3 * H, U = k.U, GU = k.GU, ldw = slice_ld(3, U);
  float* h_s = reinterpret_cast<float*>(smem4);  // [H][R]      h of the step
  float* xc_s = h_s + H * R;                     // [C][In][R]  the chunk's x
  float* p_s = xc_s + C * In * R;                // [C][GU][R]  the chunk's projections, gates
  float* hn_s = p_s + C * GU * R;                // [U][R]      hp_n of the step
  float* w_s = hn_s + U * R;                     // [H][ldw]    the W_hh slice [k][u][gate]
  const float* wih = wih_t + static_cast<size_t>(k.l) * In * G;
  const float* whh = whh_t + static_cast<size_t>(k.l) * H * G;
  const float* bih = b_ih + static_cast<size_t>(k.l) * G;
  const float* bhh = b_hh + static_cast<size_t>(k.l) * G;
  const size_t state0 = static_cast<size_t>(k.l) * Bb + k.b0;  // row of h0/hT
  int u, r0;  // this thread's (unit, 4 rows) in the cell update, if any
  const bool mine = cell_item(k, &u, &r0);

  stage_slice(w_s, ldw, whh, k, H);
  // the carry in: the whole h0 of the tile's rows; rows past the batch edge
  // hold zeros and are never written out
  stage_h(h_s, h0 + state0 * H, k, H);
  cluster_sync();  // every CTA of the cluster runs before any peer's store

  for (int t0 = 0; t0 < T; t0 += C) {
    const int n = min(C, T - t0);
    project_chunk(x, wih, xc_s, p_s, t0, n, L, Bb, k, In, H);

    for (int s = 0; s < n; ++s) {
      float* g_s = p_s + s * GU * R;
      const size_t row0 = (static_cast<size_t>(t0 + s) * L + k.l) * Bb + k.b0;

      // 1. the gates, a thread per (column, 4 rows)
      gru_gate_cols(w_s, ldw, bih, bhh, h_s, g_s, hn_s, k, H);
      __syncthreads();
      // 2. the gate math of (unit u, 4 rows); pallas_lstm.py:597-600, :616
      float hv[kQuad];
      if (mine) {
        const UnitGates v = unit_gates(g_s, hn_s, h_s, u, r0, k);
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          const float rg = sigmoid_f32(v.r[i]);
          const float zg = sigmoid_f32(v.z[i]);
          const float ng = tanhf(v.xn[i] + rg * v.hn[i]);
          hv[i] = (1.0f - zg) * ng + zg * v.h[i];
        }
      }
      // 3. this CTA is done reading h; ys to memory meanwhile; once every
      // CTA is, h of the next step into every CTA's h_s, and a barrier
      cluster_arrive();
      if (mine) {
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          if (r0 + i < k.rows) store_as(ys + (row0 + r0 + i) * H + k.u0 + u, hv[i]);
        }
      }
      cluster_wait();
      if (mine) {
        const float4 h4 = make_float4(hv[0], hv[1], hv[2], hv[3]);
        const int off = (k.u0 + u) * R + r0;
        for (int p = 0; p < N; ++p) store_peer(h_s + off, p, h4);
      }
      cluster_sync();
    }
  }

  for (int idx = threadIdx.x; idx < k.nu * k.rows; idx += blockDim.x) {
    const int uu = idx % k.nu, r = idx / k.nu;
    hT[(state0 + r) * H + k.u0 + uu] = h_s[(k.u0 + uu) * R + r];
  }
}

template <typename TS>
__global__ void __launch_bounds__(kThreads)
gru_cluster_bwd_kernel(const TS* __restrict__ x, const float* __restrict__ wih_t,
                       const float* __restrict__ b_ih, const float* __restrict__ whh_t,
                       const float* __restrict__ b_hh, const float* __restrict__ h0,
                       const TS* __restrict__ ys, const TS* __restrict__ dys,
                       const float* __restrict__ dhT, float* __restrict__ dh0,
                       float* __restrict__ dg, float* __restrict__ dgn, int T, int L, int Bb,
                       int In, int H, int R, int N, int C) {
  extern __shared__ float4 smem4[];
  const Cta<3> k(Bb, H, R, N);
  const int G = 3 * H, U = k.U, GU = k.GU, ldw = slice_ld(3, U);
  float* h_s = reinterpret_cast<float*>(smem4);  // [H][R]      h_prev of the step
  float* recv_s = h_s + H * R;                   // [N][U][R]   peers' partial dh
  float* xc_s = recv_s + N * U * R;              // [C][In][R]  the chunk's x
  float* p_s = xc_s + C * In * R;                // [C][GU][R]  gates, then dhp
  float* dh_s = p_s + C * GU * R;                // [U][R]      dh carry of the CTA's units
  float* hn_s = dh_s + U * R;                    // [U][R]      hp_n of the step
  float* w_s = hn_s + U * R;                     // [H][ldw]    the W_hh slice [k][u][gate]
  const float* wih = wih_t + static_cast<size_t>(k.l) * In * G;
  const float* whh = whh_t + static_cast<size_t>(k.l) * H * G;
  const float* bih = b_ih + static_cast<size_t>(k.l) * G;
  const float* bhh = b_hh + static_cast<size_t>(k.l) * G;
  const size_t state0 = static_cast<size_t>(k.l) * Bb + k.b0;  // row of h0/dhT/dh0

  // stages step t's h_prev, rows of ys[t-1] or h0 at t = 0 (in the bf16
  // form ys and h0 differ in type)
  auto stage_h_prev = [&](int t) {
    if (t > 0) {
      stage_h(h_s, ys + ((static_cast<size_t>(t - 1) * L + k.l) * Bb + k.b0) * H, k, H);
    } else {
      stage_h(h_s, h0 + state0 * H, k, H);
    }
  };

  stage_slice(w_s, ldw, whh, k, H);
  for (int idx = threadIdx.x; idx < U * R; idx += blockDim.x) {
    const int uu = idx / R, r = idx % R;
    dh_s[idx] = uu < k.nu && r < k.rows ? dhT[(state0 + r) * H + k.u0 + uu] : 0.f;
  }
  stage_h_prev(T - 1);
  cluster_sync();    // every CTA of the cluster runs before any peer's store
  cluster_arrive();  // the receive buffer is free

  for (int t0 = (T - 1) / C * C; t0 >= 0; t0 -= C) {
    const int n = min(C, T - t0);
    project_chunk(x, wih, xc_s, p_s, t0, n, L, Bb, k, In, H);

    for (int s = n - 1; s >= 0; --s) {
      const int t = t0 + s;
      float* g_s = p_s + s * GU * R;
      const size_t row0 = (static_cast<size_t>(t) * L + k.l) * Bb + k.b0;

      // 1. the gates recomputed, a thread per (column, 4 rows); its barrier
      // also orders the last step's dh carry before the reads below
      gru_gate_cols(w_s, ldw, bih, bhh, h_s, g_s, hn_s, k, H);
      __syncthreads();
      // 2. a thread per (unit u, 4 rows): dxp and dhp (pallas_lstm.py:649-656)
      // into the scratch and g_s, the carry dh z.  Rows past the batch edge
      // see zero cotangents and carries, so their dhp are 0 and add nothing
      // to the dh sums below
      int u, r0;
      if (cell_item(k, &u, &r0)) {
        const int j = k.u0 + u;
        const UnitGates v = unit_gates(g_s, hn_s, h_s, u, r0, k);
        float dh[kQuad], dr[kQuad], dz[kQuad], dn[kQuad];
        unpack(*reinterpret_cast<const float4*>(dh_s + u * R + r0), dh);
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          const int r = r0 + i;
          const float dy = r < k.rows ? to_f32(dys[(row0 + r) * H + j]) : 0.f;
          const float rg = sigmoid_f32(v.r[i]);
          const float zg = sigmoid_f32(v.z[i]);
          const float ng = tanhf(v.xn[i] + rg * v.hn[i]);
          const float d = dy + dh[i];
          const float da_z = d * (v.h[i] - ng) * zg * (1.0f - zg);
          const float da_n = d * (1.0f - zg) * (1.0f - ng * ng);
          const float da_r = da_n * v.hn[i] * rg * (1.0f - rg);
          if (r < k.rows) {
            float* o = dg + (row0 + r) * G + j;
            o[0] = da_r;
            o[H] = da_z;
            o[2 * H] = da_n;
            dgn[(row0 + r) * H + j] = da_n * rg;
          }
          dr[i] = da_r;
          dz[i] = da_z;
          dn[i] = da_n * rg;
          dh[i] = d * zg;
        }
        *reinterpret_cast<float4*>(g_s + u * R + r0) = make_float4(dr[0], dr[1], dr[2], dr[3]);
        *reinterpret_cast<float4*>(g_s + (U + u) * R + r0) =
            make_float4(dz[0], dz[1], dz[2], dz[3]);
        *reinterpret_cast<float4*>(g_s + (2 * U + u) * R + r0) =
            make_float4(dn[0], dn[1], dn[2], dn[3]);
        *reinterpret_cast<float4*>(dh_s + u * R + r0) = make_float4(dh[0], dh[1], dh[2], dh[3]);
      }
      __syncthreads();  // dhp is in g_s; h_s was last read above
      if (t > 0) stage_h_prev(t - 1);

      // 3. the CTA's partial dh over its 3U columns, a thread per (unit kk,
      // 4 rows), into the receive buffer of kk's owner, once every peer has
      // summed the last step's
      cluster_wait();
      for (int it = threadIdx.x; it < H * (R / kQuad); it += blockDim.x) {
        const int kk = it % H, rq = kQuad * (it / H);
        const float* wk = w_s + kk * ldw;
        float acc[kQuad] = {0.f, 0.f, 0.f, 0.f};
        for (int gate = 0; gate < 3; ++gate) {
#pragma unroll 4
          for (int uu = 0; uu < k.nu; ++uu) {
            fma_rows<kQuad>(g_s + (gate * U + uu) * R + rq, wk[3 * uu + gate], acc);
          }
        }
        const int owner = kk / U;
        store_peer(recv_s + (k.q * U + kk - owner * U) * R + rq, owner,
                   make_float4(acc[0], acc[1], acc[2], acc[3]));
      }
      cluster_sync();

      // 4. the dh carry of the CTA's units += the N partials in rank order
      for (int it = threadIdx.x; it < k.nu * (R / kQuad); it += blockDim.x) {
        const int uu = it % k.nu, rq = kQuad * (it / k.nu);
        float4 v = *reinterpret_cast<const float4*>(recv_s + uu * R + rq);
        for (int p = 1; p < N; ++p) {
          const float4 w = *reinterpret_cast<const float4*>(recv_s + (p * U + uu) * R + rq);
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        float4* c = reinterpret_cast<float4*>(dh_s + uu * R + rq);
        const float4 d = *c;
        *c = make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w);
      }
      cluster_arrive();  // this CTA's receive buffer is free again
    }
  }
  cluster_wait();

  for (int idx = threadIdx.x; idx < k.nu * k.rows; idx += blockDim.x) {
    const int uu = idx % k.nu, r = idx / k.nu;
    dh0[(state0 + r) * H + k.u0 + uu] = dh_s[uu * R + r];
  }
}

// ---- The wave design --------------------------------------------------------

// The forward's cell for the thread's 8 rows and 2 units, from the
// accumulated (r, z, n_x, n_h) plus the folded bias (pallas_lstm.py:597-600,
// :616): h in place, into the next buffer's h rows (h_s [Hp][16]) and into
// ys (rows past `rows` and units past H unwritten).
template <typename TS>
__device__ __forceinline__ void gru_wave_cell(const float (&acc)[kThreadRows][8],
                                              const float* __restrict__ bias,
                                              float (&h)[kThreadRows][2], float* h_s,
                                              TS* __restrict__ ys, const GateLane& me, int rows,
                                              int H) {
  const int units[2] = {me.ua, me.ub};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + units[j]);
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
      const float rg = sigmoid_f32(acc[r][4 * j + 0] + b.x);
      const float zg = sigmoid_f32(acc[r][4 * j + 1] + b.y);
      const float ng = tanhf((acc[r][4 * j + 2] + b.z) + rg * (acc[r][4 * j + 3] + b.w));
      h[r][j] = (1.0f - zg) * ng + zg * h[r][j];
    }
    float* hs = h_s + units[j] * kTileRows + me.r0;
    *reinterpret_cast<float4*>(hs) = make_float4(h[0][j], h[1][j], h[2][j], h[3][j]);
    *reinterpret_cast<float4*>(hs + 4) = make_float4(h[4][j], h[5][j], h[6][j], h[7][j]);
    if (units[j] < H) {
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        if (me.r0 + r < rows) store_as(ys + static_cast<size_t>(me.r0 + r) * H + units[j], h[r][j]);
      }
    }
  }
}

// The forward (K3f) in the wave design:
//   x [T, L, Bb, In]; w [L][In_p + Hp][4 Hp] = (W_ih; W_hh) unit-major,
//   columns (r, z, n_x, n_h) of each unit (W_ih's n in n_x, W_hh's in n_h,
//   zero elsewhere and past In and H); bias [L][4 Hp] = (b_ih + b_hh on r
//   and z, b_ih's n, b_hh's n); h0 [L, Bb, H] -> ys [T, L, Bb, H], hT.
// A CTA owns 16 rows of one stack (blockIdx.y) and all its units; step t's
// product reads the buffer [x[t]; h] and the cell writes h into the other
// buffer, where x[t + 1] is copied meanwhile; one barrier of the consumer
// warps ends the step.  h stays in registers for the cell.
template <typename TS>
__global__ void __launch_bounds__(kGateThreads, 1)
gru_wave_fwd_kernel(const TS* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ h0,
                    TS* __restrict__ ys, float* __restrict__ hT, int T, int L, int Bb, int In,
                    int H, int In_p, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = padded_units(H), ld = 4 * Hp, KB = In_p + Hp;
  const int warps = Hp / kUnitsPerWarp, consumers = 32 * warps;
  const int slab = kSlabRows * ld;
  Ring ring = make_ring(smem, stages, slab, 2 * KB * kTileRows, warps);
  float* buf = smem + static_cast<size_t>(stages) * slab;  // [2][KB][16]
  const int l = blockIdx.y;
  const int b0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, Bb - b0);  // <= 0: a CTA past the last tile
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t state0 = static_cast<size_t>(l) * Bb + b0;  // row of h0/hT
  const float* wl = w + static_cast<size_t>(l) * KB * ld;
  const float* bl = bias + static_cast<size_t>(l) * ld;
  auto x_rows = [&](int t) { return x + ((static_cast<size_t>(t) * L + l) * Bb + b0) * In; };

  // buffer 0: x[0] and h0; zeros elsewhere (padding, rows past the batch)
  for (int i = tid; i < 2 * KB * kTileRows; i += blockDim.x) buf[i] = 0.f;
  __syncthreads();
  stage_kmajor(buf, x_rows(0), rows, In, In, 0, blockDim.x);
  stage_kmajor(buf + In_p * kTileRows, h0 + state0 * H, rows, H, H, 0, blockDim.x);
  wait_copies();
  gate_cluster_sync();  // the ring's barriers and the buffers, cluster-wide

  const int n1 = KB / kSlabRows;
  if (warp >= kMaxWarps) {  // the producer's warpgroup: one thread streams W
    producer_regs();
    if (tid == 32 * kMaxWarps) {
      for (int t = 0; t < T; ++t) produce(ring, wl, n1);
    }
    __syncwarp();
    gate_cluster_sync();
    return;
  }
  consumer_regs();
  if (warp < warps) {
    const GateLane me;
    const bool active = rows > 0;
    const int units[2] = {me.ua, me.ub};
    float h[kThreadRows][2];
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) h[r][j] = buf[(In_p + units[j]) * kTileRows + me.r0 + r];
    }
    float acc[kThreadRows][8];
    for (int t = 0; t < T; ++t) {
      const float* cur = buf + static_cast<size_t>(t & 1) * KB * kTileRows;
      float* nxt = buf + static_cast<size_t>((t + 1) & 1) * KB * kTileRows;
      if (t + 1 < T) stage_kmajor(nxt, x_rows(t + 1), rows, In, In, 0, consumers);
      zero_acc(acc);
      gate_product(ring, cur, n1, ld, me, active, acc);
      gru_wave_cell(acc, bl, h, nxt + In_p * kTileRows,
                    ys + ((static_cast<size_t>(t) * L + l) * Bb + b0) * H, me, rows, H);
      wait_copies();
      consumers_sync(consumers);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (units[j] >= H) continue;
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        if (me.r0 + r < rows) hT[(state0 + me.r0 + r) * H + units[j]] = h[r][j];
      }
    }
  }
  __syncwarp();
  gate_cluster_sync();  // no CTA leaves while a peer may still copy into it or arrive on it
}

// The backward's reverse scan (K3b's first pass) in the wave design: the
// forward's w and bias, wt [L][3 Hp / 4][4 Hp] (DhSlabs), h0, ys, dys and
// dhT -> dh0, dg [T, L, Bb, 3H] = (da_r, da_z, da_n) and dgn [T, L, Bb, H]
// = da_n r, as the other designs write them.  Per step, in reverse: the
// product of [x[t]; h_prev] (h_prev = ys[t-1], or h0) recomputes the
// gates (the forward's product, the same slabs); the cell backward
// (pallas_lstm.py:649-656) writes dg and dgn, dhp = (da_r, da_z, da_n r)
// into dhp_s and keeps dh z in the thread's dh carry; a barrier; step
// t-1's x, h_prev and dys are copied into the one buffer while the dh
// product over the ring of W_hh^T adds dhp . W_hh^T to the carry; a barrier
// ends the step.  The ring carries, each step, the forward's slabs then
// W_hh^T's.
template <typename TS>
__global__ void __launch_bounds__(kGateThreads, 1)
gru_wave_bwd_kernel(const TS* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, const float* __restrict__ wt,
                    const float* __restrict__ h0, const TS* __restrict__ ys,
                    const TS* __restrict__ dys, const float* __restrict__ dhT,
                    float* __restrict__ dh0, float* __restrict__ dg, float* __restrict__ dgn,
                    int T, int L, int Bb, int In, int H, int In_p, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = padded_units(H), ld = 4 * Hp, KB = In_p + Hp, Q = 3 * Hp / 4;
  const int warps = Hp / kUnitsPerWarp, consumers = 32 * warps;
  const int slab = kSlabRows * ld;
  const int G = 3 * H;
  Ring ring = make_ring(smem, stages, slab, (In_p + 5 * Hp) * kTileRows, warps);
  float* buf = smem + static_cast<size_t>(stages) * slab;  // [In_p + 2 Hp][16]: x, h_prev, dys
  float* dhp_s = buf + static_cast<size_t>(In_p + 2 * Hp) * kTileRows;  // [3 Hp][16]
  const int l = blockIdx.y;
  const int b0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, Bb - b0);
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t state0 = static_cast<size_t>(l) * Bb + b0;  // row of h0/dhT/dh0
  const float* wl = w + static_cast<size_t>(l) * KB * ld;
  const float* bl = bias + static_cast<size_t>(l) * ld;
  const float* wtl = wt + static_cast<size_t>(l) * Q * ld;
  auto at = [&](int t) { return (static_cast<size_t>(t) * L + l) * Bb + b0; };  // row of [T, L, Bb]
  // step t's x, h_prev and dys into the buffer (h_prev: ys[t-1], or h0)
  auto stage_step = [&](int t, int first, int count) {
    stage_kmajor(buf, x + at(t) * In, rows, In, In, first, count);
    if (t > 0) {
      stage_kmajor(buf + In_p * kTileRows, ys + at(t - 1) * H, rows, H, H, first, count);
    } else {
      stage_kmajor(buf + In_p * kTileRows, h0 + state0 * H, rows, H, H, first, count);
    }
    stage_kmajor(buf + (In_p + Hp) * kTileRows, dys + at(t) * H, rows, H, H, first, count);
  };

  for (int i = tid; i < (In_p + 5 * Hp) * kTileRows; i += blockDim.x) buf[i] = 0.f;
  __syncthreads();
  stage_step(T - 1, 0, blockDim.x);
  wait_copies();
  gate_cluster_sync();

  const int n1 = KB / kSlabRows, n2 = Q / kSlabRows;
  if (warp >= kMaxWarps) {  // the producer's warpgroup
    producer_regs();
    if (tid == 32 * kMaxWarps) {
      for (int t = T - 1; t >= 0; --t) {
        produce(ring, wl, n1);
        produce(ring, wtl, n2);
      }
    }
    __syncwarp();
    gate_cluster_sync();
    return;
  }
  consumer_regs();
  if (warp < warps) {
    const GateLane me;
    const bool active = rows > 0;
    const int units[2] = {me.ua, me.ub};
    float dh[kThreadRows][2];
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        dh[r][j] = me.r0 + r < rows && units[j] < H
                       ? dhT[(state0 + me.r0 + r) * H + units[j]] : 0.f;
      }
    }
    float acc[kThreadRows][8];
    for (int t = T - 1; t >= 0; --t) {
      zero_acc(acc);
      gate_product(ring, buf, n1, ld, me, active, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int u = units[j];
        const float4 b = __ldg(reinterpret_cast<const float4*>(bl) + u);
#pragma unroll
        for (int q = 0; q < kThreadRows; q += 4) {  // four rows at a time: fewer live values
          float dr[4], dz[4], dn[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = q + i, row = me.r0 + r;
            const float rg = sigmoid_f32(acc[r][4 * j + 0] + b.x);
            const float zg = sigmoid_f32(acc[r][4 * j + 1] + b.y);
            const float hpn = acc[r][4 * j + 3] + b.w;
            const float ng = tanhf((acc[r][4 * j + 2] + b.z) + rg * hpn);
            const float h_prev = buf[(In_p + u) * kTileRows + row];
            const float d = buf[(In_p + Hp + u) * kTileRows + row] + dh[r][j];
            const float da_z = d * (h_prev - ng) * zg * (1.0f - zg);
            const float da_n = d * (1.0f - zg) * (1.0f - ng * ng);
            const float da_r = da_n * hpn * rg * (1.0f - rg);
            if (row < rows && u < H) {
              float* o = dg + (at(t) + row) * G + u;
              o[0] = da_r;
              o[H] = da_z;
              o[2 * H] = da_n;
              dgn[(at(t) + row) * H + u] = da_n * rg;
            }
            dr[i] = da_r;
            dz[i] = da_z;
            dn[i] = da_n * rg;
            dh[r][j] = d * zg;
          }
          float* o = dhp_s + u * kTileRows + me.r0 + q;
          *reinterpret_cast<float4*>(o) = make_float4(dr[0], dr[1], dr[2], dr[3]);
          *reinterpret_cast<float4*>(o + Hp * kTileRows) = make_float4(dz[0], dz[1], dz[2], dz[3]);
          *reinterpret_cast<float4*>(o + 2 * Hp * kTileRows) =
              make_float4(dn[0], dn[1], dn[2], dn[3]);
        }
      }
      consumers_sync(consumers);  // dhp complete; the buffer read by every warp
      if (t > 0) stage_step(t - 1, 0, consumers);
      zero_acc(acc);
      gate_product(ring, dhp_s, n2, ld, me, active, acc, DhSlabs{Q * kTileRows});
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dh[r][j] += (acc[r][4 * j] + acc[r][4 * j + 1]) + (acc[r][4 * j + 2] + acc[r][4 * j + 3]);
        }
      }
      wait_copies();
      consumers_sync(consumers);  // step t-1's buffer in; dhp free
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (units[j] >= H) continue;
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        if (me.r0 + r < rows) dh0[(state0 + me.r0 + r) * H + units[j]] = dh[r][j];
      }
    }
  }
  __syncwarp();
  gate_cluster_sync();
}

// ---- The per-block design's launch ----------------------------------------

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

// The per-block design's launches: R and C from row_tile and chunk_steps.
template <int R, int C, typename TS>
cudaError_t launch_block_fwd(const TS* x, const float* wih_t, const float* b_ih,
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
cudaError_t launch_block_bwd(const TS* x, const float* wih_t, const float* b_ih,
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
cudaError_t block_fwd(const TS* x, const float* wih_t, const float* b_ih, const float* whh_t,
                      const float* b_hh, const float* h0, TS* ys, float* hT, int T, int L,
                      int Bb, int In, int H, int device, cudaStream_t s) {
  const int R = row_tile(Bb, L, device);
  switch (R * 100 + chunk_steps(R, In, H, 2)) {
    case 408: return launch_block_fwd<4, 8>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, s);
    case 404: return launch_block_fwd<4, 4>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, s);
    case 804: return launch_block_fwd<8, 4>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, s);
    case 802: return launch_block_fwd<8, 2>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TS>
cudaError_t block_bwd(const TS* x, const float* wih_t, const float* b_ih, const float* whh_t,
                      const float* b_hh, const float* h0, const TS* ys, const TS* dys,
                      const float* dhT, float* dh0, float* dg, float* dgn, int T, int L, int Bb,
                      int In, int H, int device, cudaStream_t s) {
  const int R = row_tile(Bb, L, device);
  switch (R * 100 + chunk_steps(R, In, H, 3)) {
    case 408: return launch_block_bwd<4, 8>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, s);
    case 404: return launch_block_bwd<4, 4>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, s);
    case 804: return launch_block_bwd<8, 4>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, s);
    case 802: return launch_block_bwd<8, 2>(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TS>
int gru_fwd(const TS* x, const float* wih_t, const float* b_ih, const float* whh_t,
            const float* b_hh, const float* h0, TS* ys, float* hT, int T, int L, int Bb,
            int In, int H, int cluster, int R, int N, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cluster) {
    return static_cast<int>(block_fwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H,
                                      device, s));
  }
  const size_t smem = tiling_smem(false, 3, R, N, C, 1, In, H);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_cluster(gru_cluster_fwd_kernel<TS>, N, (Bb + R - 1) / R, L,
                                         smem, s, x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L,
                                         Bb, In, H, R, N, C));
}

// The backward's second pass over the scratch dg and dgn (the reverse
// scan's output in every design): dx, dW_ih, dW_hh, db_ih and db_hh.
template <typename TS>
cudaError_t second_pass(const TS* x, const float* wih_t, const float* h0, const TS* ys, TS* dx,
                        float* dwih_t, float* db_ih, float* dwhh_t, float* db_hh,
                        const float* dg, const float* dgn, float* ws, int T, int L, int Bb,
                        int In, int H, int ws_floats, cudaStream_t s) {
  const int G = 3 * H;
  cudaError_t err = launch_dx(dg, wih_t, dx, T, L, Bb, In, G, s);
  if (err != cudaSuccess) return err;
  const size_t wsf = static_cast<size_t>(ws_floats);
  err = launch_dw(x, nullptr, dg, G, dwih_t, G, ws, wsf, T, L, Bb, In, G, 0, s);
  if (err != cudaSuccess) return err;
  err = launch_dw(ys, h0, dg, G, dwhh_t, G, ws, wsf, T, L, Bb, H, 2 * H, 1, s);  // r, z columns
  if (err != cudaSuccess) return err;
  err = launch_dw(ys, h0, dgn, H, dwhh_t + 2 * H, G, ws, wsf, T, L, Bb, H, H, 1, s);  // n columns
  if (err != cudaSuccess) return err;
  err = launch_dbias(dg, G, db_ih, G, ws, wsf, T, L, Bb, G, s);
  if (err != cudaSuccess) return err;
  err = launch_dbias(dgn, H, db_hh + 2 * H, G, ws, wsf, T, L, Bb, H, s);
  if (err != cudaSuccess) return err;
  // db_hh's r and z slices: the same sums as db_ih's
  return cudaMemcpy2DAsync(db_hh, sizeof(float) * G, db_ih, sizeof(float) * G,
                           sizeof(float) * 2 * H, L, cudaMemcpyDeviceToDevice, s);
}

template <typename TS>
int gru_bwd(const TS* x, const float* wih_t, const float* b_ih, const float* whh_t,
            const float* b_hh, const float* h0, const TS* ys, const TS* dys,
            const float* dhT, TS* dx, float* dwih_t, float* db_ih, float* dwhh_t,
            float* db_hh, float* dh0, float* dg, float* dgn, float* ws, int T, int L, int Bb,
            int In, int H, int cluster, int R, int N, int C, int ws_floats, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!cluster) {
    err = block_bwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In,
                    H, device, s);
  } else {
    const size_t smem = tiling_smem(true, 3, R, N, C, 1, In, H);
    if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
    err = launch_cluster(gru_cluster_bwd_kernel<TS>, N, (Bb + R - 1) / R, L, smem, s, x, wih_t,
                         b_ih, whh_t, b_hh, h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, R,
                         N, C);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(second_pass(x, wih_t, h0, ys, dx, dwih_t, db_ih, dwhh_t, db_hh, dg,
                                      dgn, ws, T, L, Bb, In, H, ws_floats, s));
}

template <typename TS>
int wave_fwd(const TS* x, const float* w, const float* bias, const float* h0, TS* ys, float* hT,
             int T, int L, int Bb, int In, int H, int In_p, int N, int stages, int device,
             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = wave_smem(false, In, H, In_p, N, stages);
  if (smem == 0 || T < 1 || Bb < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wave(gru_wave_fwd_kernel<TS>, N, wave_ctas(Bb, N), L, smem,
                                      static_cast<cudaStream_t>(stream), x, w, bias, h0, ys,
                                      hT, T, L, Bb, In, H, In_p, stages));
}

template <typename TS>
int wave_bwd(const TS* x, const float* w, const float* bias, const float* wt, const float* h0,
             const TS* ys, const TS* dys, const float* dhT, const float* wih_t, TS* dx,
             float* dwih_t, float* db_ih, float* dwhh_t, float* db_hh, float* dh0, float* dg,
             float* dgn, float* ws, int T, int L, int Bb, int In, int H, int In_p, int N,
             int stages, int ws_floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = wave_smem(true, In, H, In_p, N, stages);
  if (smem == 0 || T < 1 || Bb < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_wave(gru_wave_bwd_kernel<TS>, N, wave_ctas(Bb, N), L, smem, s, x, w, bias, wt,
                    h0, ys, dys, dhT, dh0, dg, dgn, T, L, Bb, In, H, In_p, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(second_pass(x, wih_t, h0, ys, dx, dwih_t, db_ih, dwhh_t, db_hh, dg,
                                      dgn, ws, T, L, Bb, In, H, ws_floats, s));
}

}  // namespace

// Launches the forward scan on `stream` (a cudaStream_t) of `device`, in
// the planner's design: cluster = 1 on clusters of N CTAs (1 to 16), R rows
// a cluster, chunks of C steps (1 to 8), the W_hh slice resident; cluster
// = 0 the per-block kernel, which picks its own tile and chunk (R, N and C
// unread).  Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for a tiling these kernels do not take or whose
// buffers do not fit a block's shared memory, cudaErrorLaunchOutOfResources
// when no such cluster fits the card).  All pointers are device pointers
// to contiguous f32 arrays of the shapes above.
extern "C" int se_gru_inproj_fwd_f32(const float* x, const float* wih_t,
                                     const float* b_ih, const float* whh_t,
                                     const float* b_hh, const float* h0,
                                     float* ys, float* hT,
                                     int T, int L, int Bb, int In, int H,
                                     int cluster, int R, int N, int C,
                                     int device, void* stream) {
  return gru_fwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, cluster, R, N, C,
                 device, stream);
}

// The bf16-stream forward: x and ys bf16, the rest as se_gru_inproj_fwd_f32.
extern "C" int se_gru_inproj_fwd_bf16(const __nv_bfloat16* x, const float* wih_t,
                                      const float* b_ih, const float* whh_t,
                                      const float* b_hh, const float* h0,
                                      __nv_bfloat16* ys, float* hT,
                                      int T, int L, int Bb, int In, int H,
                                      int cluster, int R, int N, int C,
                                      int device, void* stream) {
  return gru_fwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, hT, T, L, Bb, In, H, cluster, R, N, C,
                 device, stream);
}

// How many clusters of the f32 cluster kernel (forward, or with backward =
// 1 the reverse scan) on the planner's tiling fit on `device` at once; 0 if
// none does, minus a cudaError_t on an error (cudaErrorInvalidValue: a
// tiling these kernels do not take).
extern "C" int se_gru_inproj_active_clusters(int backward, int In, int H, int R, int N, int C,
                                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = tiling_smem(backward != 0, 3, R, N, C, 1, In, H);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return backward ? active_clusters(gru_cluster_bwd_kernel<float>, N, smem)
                  : active_clusters(gru_cluster_fwd_kernel<float>, N, smem);
}

// Launches the backward: the reverse scan in the planner's design (as the
// forward's entry; dh0 and the scratch buffers dg [T, L, Bb, 3H] and dgn
// [T, L, Bb, H]), then the dx product and the dW_ih, db_ih, dW_hh and db_hh
// reductions that read them, their rows split over the workspace `ws`
// (ws_floats floats; lstm_common.cuh), all on `stream`.  Returns the first
// cudaError_t (0 on success; otherwise as for the forward).  Shapes as
// above; every pointer is a device pointer to a contiguous f32 array, none
// may be null.
extern "C" int se_gru_inproj_bwd_f32(const float* x, const float* wih_t,
                                     const float* b_ih, const float* whh_t,
                                     const float* b_hh, const float* h0,
                                     const float* ys, const float* dys,
                                     const float* dhT, float* dx, float* dwih_t,
                                     float* db_ih, float* dwhh_t, float* db_hh,
                                     float* dh0, float* dg, float* dgn, float* ws,
                                     int T, int L, int Bb, int In, int H,
                                     int cluster, int R, int N, int C, int ws_floats,
                                     int device, void* stream) {
  return gru_bwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dx, dwih_t, db_ih, dwhh_t,
                 db_hh, dh0, dg, dgn, ws, T, L, Bb, In, H, cluster, R, N, C, ws_floats, device,
                 stream);
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
                                      int T, int L, int Bb, int In, int H,
                                      int cluster, int R, int N, int C, int ws_floats,
                                      int device, void* stream) {
  return gru_bwd(x, wih_t, b_ih, whh_t, b_hh, h0, ys, dys, dhT, dx, dwih_t, db_ih, dwhh_t,
                 db_hh, dh0, dg, dgn, ws, T, L, Bb, In, H, cluster, R, N, C, ws_floats, device,
                 stream);
}

// Launches the forward scan in the wave design on `stream` of `device`:
// clusters of N (2 or 4) CTAs of 16 rows each, L stacks, a ring of
// `stages` slabs; w [L][In_p + Hp][4 Hp] and bias [L][4 Hp] laid out by
// the wrapper (gru_wave_fwd_kernel).  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a tiling the kernel does not take).
extern "C" int se_gru_wave_fwd_f32(const float* x, const float* w, const float* bias,
                                   const float* h0, float* ys, float* hT, int T, int L, int Bb,
                                   int In, int H, int In_p, int N, int stages, int device,
                                   void* stream) {
  return wave_fwd(x, w, bias, h0, ys, hT, T, L, Bb, In, H, In_p, N, stages, device, stream);
}

// The bf16-stream forward in the wave design: x and ys bf16.
extern "C" int se_gru_wave_fwd_bf16(const __nv_bfloat16* x, const float* w, const float* bias,
                                    const float* h0, __nv_bfloat16* ys, float* hT, int T, int L,
                                    int Bb, int In, int H, int In_p, int N, int stages,
                                    int device, void* stream) {
  return wave_fwd(x, w, bias, h0, ys, hT, T, L, Bb, In, H, In_p, N, stages, device, stream);
}

// Launches the backward in the wave design: the reverse scan
// (gru_wave_bwd_kernel; wt [L][3 Hp / 4][4 Hp] laid out by the wrapper),
// then the second pass as se_gru_inproj_bwd_f32's (wih_t [L, In, 3H] for
// dx), all on `stream`.  Returns the first cudaError_t.
extern "C" int se_gru_wave_bwd_f32(const float* x, const float* w, const float* bias,
                                   const float* wt, const float* h0, const float* ys,
                                   const float* dys, const float* dhT, const float* wih_t,
                                   float* dx, float* dwih_t, float* db_ih, float* dwhh_t,
                                   float* db_hh, float* dh0, float* dg, float* dgn, float* ws,
                                   int T, int L, int Bb, int In, int H, int In_p, int N,
                                   int stages, int ws_floats, int device, void* stream) {
  return wave_bwd(x, w, bias, wt, h0, ys, dys, dhT, wih_t, dx, dwih_t, db_ih, dwhh_t, db_hh,
                  dh0, dg, dgn, ws, T, L, Bb, In, H, In_p, N, stages, ws_floats, device, stream);
}

// The bf16-stream backward in the wave design: x, ys, dys and dx bf16.
extern "C" int se_gru_wave_bwd_bf16(const __nv_bfloat16* x, const float* w, const float* bias,
                                    const float* wt, const float* h0, const __nv_bfloat16* ys,
                                    const __nv_bfloat16* dys, const float* dhT,
                                    const float* wih_t, __nv_bfloat16* dx, float* dwih_t,
                                    float* db_ih, float* dwhh_t, float* db_hh, float* dh0,
                                    float* dg, float* dgn, float* ws, int T, int L, int Bb,
                                    int In, int H, int In_p, int N, int stages, int ws_floats,
                                    int device, void* stream) {
  return wave_bwd(x, w, bias, wt, h0, ys, dys, dhT, wih_t, dx, dwih_t, db_ih, dwhh_t, db_hh,
                  dh0, dg, dgn, ws, T, L, Bb, In, H, In_p, N, stages, ws_floats, device, stream);
}

// How many clusters of N CTAs of the f32 wave kernel (forward, or with
// backward = 1 the reverse scan) with a ring of `stages` slabs fit on
// `device` at once; minus a cudaError_t on an error (cudaErrorInvalidValue:
// a tiling the kernels do not take).
extern "C" int se_gru_wave_active_clusters(int backward, int In, int H, int In_p, int N,
                                           int stages, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = wave_smem(backward != 0, In, H, In_p, N, stages);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return backward ? gate_active_clusters(gru_wave_bwd_kernel<float>, N, smem)
                  : gate_active_clusters(gru_wave_fwd_kernel<float>, N, smem);
}
