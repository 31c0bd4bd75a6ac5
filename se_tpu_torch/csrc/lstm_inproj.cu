// LSTM scan with the input projection inside the kernel, forward and
// backward, for Hopper (sm_90a), on thread-block clusters.
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
// The backward takes the forward's inputs, w_hh [L, 4H, H] (w_hh_t's
// transpose), (ys, cs) and the cotangents (dys, dhT, dcT) and gives dx
// [T, L, Bb, In], dw_ih_t [L, In, 4H], dbias [L, 4H], dw_hh_t [L, H, 4H],
// dh0 and dc0.  It recomputes the gates from (x, h_prev), as the Pallas
// kernel does.
//
// What bounds them.  The work is 2 * T * Bb * (In + H) * 4H FLOP a forward
// (CRN at B=8: 2.53 GFLOP, 0.038 ms at 67 TFLOP/s f32) and three times that
// a backward; the bytes are tens of MB.  The limit is the chain of T
// dependent steps: each step needs the whole previous h (or dh).  With one
// block per row tile reading W_hh[l] from L2 every step (this kernel's
// first design, PRs 3-7), a step cost a pass over all of W_hh through one
// SM (CRN: 256 KiB, 17.3 us), and at the sub band's 2056 rows 514 blocks
// re-read the 2.25 MiB W_hh every step (~190 GB of L2 traffic a call).
//
// Design.  A cluster of N blocks (CTAs) owns a tile of R batch rows of one
// stack; CTA q owns U = ceil(H / N) hidden units u0 = q U .. and all four
// gate columns of each (i, f, g, o: 4U local columns c = gate * U + u), so
// a unit's cell update never leaves its CTA.  The CTA loads its W_hh slice
// [H][4U] into shared memory once per call and keeps it for all T steps
// (resident), or, where the slice does not fit beside the step's buffers
// (FullSubNet's full band, H = 512: 256 KiB), streams it from L2 every step:
// 1/N of the old per-SM traffic, N SMs' loads in flight.  R, N, the chunk
// length C and residency come from the planner in Python
// (se_tpu_torch/ops/cluster_plan.py::plan, shared with K3), which this file
// checks.  The cluster machinery (Cta, the staging, the projection, the
// DSMEM store, the barriers, the launch) is cluster_scan.cuh's, shared with
// K3 (gru_inproj.cu).
// Few rows (CRN, DCCRN's real LSTM, the full band): one cluster holds the
// batch.  Many rows (the sub band): clusters of up to 32 rows, so that each
// resident slice serves that many rows a step.
//
// A CTA runs kThreads threads, whatever its share of the work: its passes
// over memory (x, h_prev, W_ih and a streamed W_hh, from L2) are bound by
// latency, so the threads stage rows into shared memory together, each
// with a batch of loads in flight.  Forward, per chunk of C steps (up to
// kMaxChunk): the chunk's x staged, then a thread per (step, column, 4
// rows) forms x[t] . W_ih[l][:, col], the sum over k in order, its column
// read kDotBatch loads at a time.  Per step:
//   1. the gates, (proj + h . W_hh[:, col]) + bias[col], the sum over k in
//      order from the resident slice (or L2): each column's sum in the
//      order of the first design, so K2f's f32 outputs keep their bits.
//      A thread per (unit, 4 rows) forms all four gates of its unit from
//      the resident slice, stored [k][unit][gate] so that a k costs it one
//      float4 of h and one of W for 16 sums (where the CTA has kFusedItems
//      such items or more); else a thread per (column, 4 rows) forms one;
//   2. thread (u, 4 rows): the cell update of its unit;
//   3. the exchange: one h buffer [H][R], and a split cluster barrier.  The
//      CTA arrives once it has read h, writes ys and cs to memory, waits for
//      every CTA to have read its h, writes its units' h into every CTA's
//      buffer through distributed shared memory (store_peer), and a
//      cluster barrier ends the step.
// Backward, chunks and steps in reverse, after the chunk's projection:
//   1. the CTA's gates recomputed from h_prev (ys[t-1] or h0, staged from
//      memory, all H units), as the forward forms them;
//   2. thread (u, 4 rows): dgates of its unit from the gates, c_prev, cs[t],
//      dh = dys[t] + the dh carry and the dc carry; into shared memory and
//      the dgates scratch [T, L, Bb, 4H]; then step t-1's h_prev is staged;
//   3. the CTA's partial dh over its 4U columns for every unit k: a thread
//      per (4 units k, k + H/4, ...; 4 rows) from the same slice read along
//      k (a unit's four gates one float4; rows 4U + 4 floats apart, so for
//      even U a warp's loads along k miss no bank), or, streamed, a thread
//      per (unit, 4 rows) from w_hh [4H, H], coalesced along k; stored into
//      the receive buffer [N][U][R] of each unit's owner through
//      distributed shared memory;
//   4. a cluster barrier; each CTA sums its units' N partials in rank order
//      0..N-1 (no atomics: two calls give the same bits) into its dh
//      carry, which the next step's cell update reads after a CTA barrier
//      (gate_cols's, or where the gates are formed in the cell update's
//      threads, one of its own).  The dh and dc carries stay local.  One
//      receive buffer: a split barrier (arrive after the sum, wait before
//      the next step's stores) keeps a peer's next partials from landing
//      before the sum has read this step's.
// Nothing in the recurrence waits on dx = dgates @ W_ih^T, dW_ih, dW_hh or
// dbias, so second-pass kernels read the dgates scratch (lstm_common.cuh):
// lstm_inproj_dx_kernel, lstm_dw_kernel (64 x 64 tiles, its rows split over
// enough blocks to fill the card into fixed-order partials) and
// lstm_inproj_dbias_kernel (split the same way), into the caller's
// workspace.  The scratch costs T * Bb * 4H * 4 bytes a stack (2.57 GB at
// the sub band, B=10); folding dW into the scan would need a per-CTA
// accumulator as large as the resident slice, and the two do not fit
// together there.
//
// The bf16-stream form (pallas_lstm.py:13-14; the kernels' :318-321, :334,
// :397 and :553) takes x, and gives ys, as bf16, and in the backward takes
// ys and dys as bf16 and gives dx as bf16.  x is upcast as it is staged and
// projected in f32 with the f32 W_ih, as the Pallas kernel does; the
// carry, the gates, the stash cs, the dgates scratch and the weight and
// bias gradients stay f32 (dW_ih sums the upcast x, dW_hh the rounded ys
// the backward recomputes from, :361).  Each stream value is converted at
// its shared-memory or global store (to_f32, store_as in lstm_common.cuh),
// so the f32 form compiles as if the type were fixed.
//
// The bound probe (P1; se_tpu_torch/probes/bound_probe.py, replacing the
// Pallas kernel of tools/bound_probe.py:43-138) is this forward kernel with
// its cell update swapped at compile time (the template argument M): the
// LSTM cell (kReal, the kernel K2 launches), the cell with its gate
// pre-activations and transcendentals rounded to bf16 (kBf16Gates), the
// transcendentals replaced by multiplies (kPolySwap), or no gate math at
// all (kNoGates).  Its entry, se_lstm_inproj_probe_f32, runs one stack
// (L = 1) and writes no stash.

#include <cuda_bf16.h>

#include "cluster_scan.cuh"

namespace {

// A CTA with this many (unit, 4 rows) items has a thread form all four
// gates of its unit from the resident slice (each h and W load shared four
// ways); with fewer, a thread per (column, 4 rows) keeps more threads busy.
constexpr int kFusedItems = 96;

// The forward's cell update: the LSTM's gate math, or one of the bound
// probe's three ablations of it (tools/bound_probe.py:65-92).
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

// g_s[c][r0 .. r0+3] = (g_s[c][r0 ..] + h_s[:][r0 ..] . W_hh[:, col(c)]) +
// b[col(c)] for each (column, 4-row group) of the CTA, g_s holding the
// step's x . W_ih; the sum over k in order, W_hh[:, col] from the resident
// slice w_s [H][ldw] or from whh [H][4H] in L2.
__device__ __forceinline__ void gate_cols(bool resident, const float* __restrict__ whh,
                                          const float* w_s, int ldw,
                                          const float* __restrict__ b, const float* h_s,
                                          float* g_s, const Cta<4>& k, int H) {
  const int G = 4 * H, R = k.R;
  for (int it = threadIdx.x; it < k.GU * (R / kQuad); it += blockDim.x) {
    const int c = it % k.GU, r0 = kQuad * (it / k.GU);
    if (c % k.U >= k.nu) continue;
    const int col = k.col(c, H);
    float acc[kQuad] = {0.f, 0.f, 0.f, 0.f};
    if (resident) {
#pragma unroll 8
      const float* wc = w_s + 4 * (c % k.U) + c / k.U;
      for (int kk = 0; kk < H; ++kk) fma_rows<kQuad>(h_s + kk * R + r0, wc[kk * ldw], acc);
    } else {
      dot_batched(whh + col, G, h_s + r0, R, H, acc);
    }
    const float bv = __ldg(b + col);
    float4* p = reinterpret_cast<float4*>(g_s + c * R + r0);
    float4 v = *p;
    v.x = (v.x + acc[0]) + bv;
    v.y = (v.y + acc[1]) + bv;
    v.z = (v.z + acc[2]) + bv;
    v.w = (v.w + acc[3]) + bv;
    *p = v;
  }
}

// The four gate pre-activations of unit u for rows r0 .. r0+3 from the
// resident slice: gate[g][i] = (g_s[g U + u][r0 + i] + h_s[:][r0 + i] .
// w_s[:][u][g]) + b[col], each sum over k in order.  A k costs a thread one
// float4 of h and one of W for 16 sums; a warp's 8 units x 4 row groups
// (cell_item) read 8 W and 4 h float4s, two shared-memory wavefronts.
__device__ __forceinline__ void unit_gates_resident(const float* w_s, int ldw,
                                                    const float* __restrict__ b,
                                                    const float* h_s, const float* g_s, int u,
                                                    int r0, const Cta<4>& k, int H,
                                                    float (&gate)[4][kQuad]) {
  const int R = k.R, U = k.U;
  float acc[4][kQuad];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) acc[g][i] = 0.f;
  }
  const float* wp = w_s + 4 * u;
#pragma unroll 4
  for (int kk = 0; kk < H; ++kk) {
    const float4 hv = *reinterpret_cast<const float4*>(h_s + kk * R + r0);
    const float4 wv = *reinterpret_cast<const float4*>(wp + kk * ldw);
    const float hr[kQuad] = {hv.x, hv.y, hv.z, hv.w};
    const float wg[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int g = 0; g < 4; ++g) {
#pragma unroll
      for (int i = 0; i < kQuad; ++i) acc[g][i] = fmaf(hr[i], wg[g], acc[g][i]);
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float bv = __ldg(b + g * H + k.u0 + u);
    float p[kQuad];
    unpack(*reinterpret_cast<const float4*>(g_s + (g * U + u) * R + r0), p);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) gate[g][i] = (p[i] + acc[g][i]) + bv;
  }
}

// The gate pre-activations of unit u, rows r0 .. r0+3, already in g_s.
__device__ __forceinline__ void unit_gates_stored(const float* g_s, int u, int r0, const Cta<4>& k,
                                                  float (&gate)[4][kQuad]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    unpack(*reinterpret_cast<const float4*>(g_s + (g * k.U + u) * k.R + r0), gate[g]);
  }
}

template <int M, typename TS>
__global__ void __launch_bounds__(kThreads)
lstm_cluster_fwd_kernel(const TS* __restrict__ x, const float* __restrict__ wih_t,
                        const float* __restrict__ bias, const float* __restrict__ whh_t,
                        const float* __restrict__ h0, const float* __restrict__ c0,
                        TS* __restrict__ ys, float* __restrict__ cs, float* __restrict__ hT,
                        float* __restrict__ cT, int T, int L, int Bb, int In, int H, int R,
                        int N, int C, int resident) {
  extern __shared__ float4 smem4[];
  const Cta<4> k(Bb, H, R, N);
  const int G = 4 * H, U = k.U, GU = k.GU, ldw = slice_ld(4, U);
  float* h_s = reinterpret_cast<float*>(smem4);  // [H][R]      h of the step
  float* xc_s = h_s + H * R;                     // [C][In][R]  the chunk's x
  float* p_s = xc_s + C * In * R;                // [C][GU][R]  the chunk's projections
  float* c_s = p_s + C * GU * R;                 // [U][R]      the CTA's units' c
  float* w_s = c_s + U * R;                      // [H][ldw]    the resident W_hh slice [k][u][g]
  const float* wih = wih_t + static_cast<size_t>(k.l) * In * G;
  const float* whh = whh_t + static_cast<size_t>(k.l) * H * G;
  const float* b = bias + static_cast<size_t>(k.l) * G;
  const size_t state0 = static_cast<size_t>(k.l) * Bb + k.b0;  // row of h0/c0/hT/cT
  const bool fused = resident && k.nu * (R / kQuad) >= kFusedItems;
  int u, r0;  // this thread's (unit, 4 rows) in the cell update, if any
  const bool mine = cell_item(k, &u, &r0);

  if (resident) stage_slice(w_s, ldw, whh, k, H);
  // carries in: the whole h0 of the tile's rows, c0 of the CTA's units;
  // rows past the batch edge hold zeros and are never written out
  stage_h(h_s, h0 + state0 * H, k, H);
  for (int idx = threadIdx.x; idx < U * R; idx += blockDim.x) {
    const int uu = idx / R, r = idx % R;
    c_s[idx] = uu < k.nu && r < k.rows ? c0[(state0 + r) * H + k.u0 + uu] : 0.f;
  }
  cluster_sync();  // every CTA of the cluster runs before any peer's store

  for (int t0 = 0; t0 < T; t0 += C) {
    const int n = min(C, T - t0);
    project_chunk(x, wih, xc_s, p_s, t0, n, L, Bb, k, In, H);

    for (int s = 0; s < n; ++s) {
      const int t = t0 + s;
      float* g_s = p_s + s * GU * R;
      const size_t row0 = (static_cast<size_t>(t) * L + k.l) * Bb + k.b0;

      // 1. the gates, a thread per column, unless a thread per (unit, 4
      // rows) forms all four below
      if (!fused) {
        gate_cols(resident, whh, w_s, ldw, b, h_s, g_s, k, H);
        __syncthreads();
      }
      // 2. the cell update of (unit u, 4 rows)
      float cv[kQuad], hv[kQuad];
      if (mine) {
        float gate[4][kQuad];
        if (fused) {
          unit_gates_resident(w_s, ldw, b, h_s, g_s, u, r0, k, H, gate);
        } else {
          unit_gates_stored(g_s, u, r0, k, gate);
        }
        unpack(*reinterpret_cast<const float4*>(c_s + u * R + r0), cv);
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          const float g4[4] = {gate[0][i], gate[1][i], gate[2][i], gate[3][i]};
          cv[i] = cell_mode<M>(g4, 1, 0, cv[i], &hv[i]);
        }
        *reinterpret_cast<float4*>(c_s + u * R + r0) = make_float4(cv[0], cv[1], cv[2], cv[3]);
      }
      // 3. this CTA is done reading h; ys and cs to memory meanwhile; once
      // every CTA is, h of step t + 1 into every CTA's h_s, and a barrier
      cluster_arrive();
      if (mine) {
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          if (r0 + i < k.rows) {
            const size_t o = (row0 + r0 + i) * H + k.u0 + u;
            store_as(ys + o, hv[i]);
            if (cs != nullptr) cs[o] = cv[i];
          }
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
    const size_t o = (state0 + r) * H + k.u0 + uu;
    hT[o] = h_s[(k.u0 + uu) * R + r];
    cT[o] = c_s[uu * R + r];
  }
}

template <typename TS>
__global__ void __launch_bounds__(kThreads)
lstm_cluster_bwd_kernel(const TS* __restrict__ x, const float* __restrict__ wih_t,
                        const float* __restrict__ bias, const float* __restrict__ whh_t,
                        const float* __restrict__ whh_tt, const float* __restrict__ h0,
                        const float* __restrict__ c0, const TS* __restrict__ ys,
                        const float* __restrict__ cs, const TS* __restrict__ dys,
                        const float* __restrict__ dhT, const float* __restrict__ dcT,
                        float* __restrict__ dh0, float* __restrict__ dc0,
                        float* __restrict__ dg, int T, int L, int Bb, int In, int H, int R,
                        int N, int C, int resident) {
  extern __shared__ float4 smem4[];
  const Cta<4> k(Bb, H, R, N);
  const int G = 4 * H, U = k.U, GU = k.GU, ldw = slice_ld(4, U);
  // the dh pass's units a thread: four (kk, kk + HQ, ...) from the resident
  // slice, one where it is streamed (more threads, more loads in flight)
  const int KQ = resident ? 4 : 1, HQ = (H + KQ - 1) / KQ;
  float* h_s = reinterpret_cast<float*>(smem4);  // [H][R]      h_prev of the step
  float* recv_s = h_s + H * R;                   // [N][U][R]   peers' partial dh
  float* xc_s = recv_s + N * U * R;              // [C][In][R]  the chunk's x
  float* p_s = xc_s + C * In * R;                // [C][GU][R]  gates, then dgates
  float* dh_s = p_s + C * GU * R;                // [U][R]      dh carry of the CTA's units
  float* dc_s = dh_s + U * R;                    // [U][R]      dc carry
  float* w_s = dc_s + U * R;                     // [H][ldw]    the resident W_hh slice [k][u][g]
  const size_t LBb = static_cast<size_t>(L) * Bb;
  const float* wih = wih_t + static_cast<size_t>(k.l) * In * G;
  const float* whh = whh_t + static_cast<size_t>(k.l) * H * G;
  const float* wt = whh_tt + static_cast<size_t>(k.l) * G * H;  // [4H][H]
  const float* b = bias + static_cast<size_t>(k.l) * G;
  const size_t state0 = static_cast<size_t>(k.l) * Bb + k.b0;
  const bool fused = resident && k.nu * (R / kQuad) >= kFusedItems;

  // stages step t's h_prev, rows of ys[t-1] or h0 at t = 0 (in the bf16
  // form ys and h0 differ in type)
  auto stage_h_prev = [&](int t) {
    if (t > 0) {
      stage_h(h_s, ys + ((static_cast<size_t>(t - 1) * L + k.l) * Bb + k.b0) * H, k, H);
    } else {
      stage_h(h_s, h0 + state0 * H, k, H);
    }
  };

  if (resident) stage_slice(w_s, ldw, whh, k, H);
  for (int idx = threadIdx.x; idx < U * R; idx += blockDim.x) {
    const int u = idx / R, r = idx % R;
    const bool in = u < k.nu && r < k.rows;
    dh_s[idx] = in ? dhT[(state0 + r) * H + k.u0 + u] : 0.f;
    dc_s[idx] = in ? dcT[(state0 + r) * H + k.u0 + u] : 0.f;
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

      // 1. the gates recomputed, a thread per column, unless a thread per
      // (unit, 4 rows) forms all four below
      if (!fused) {
        gate_cols(resident, whh, w_s, ldw, b, h_s, g_s, k, H);
        __syncthreads();
      }
      // 2. a thread per (unit u, 4 rows): its four gates and their
      // gradients (pallas_lstm.py:373-386, :429) into g_s and the dgates
      // scratch.  Rows past the batch edge see zero cotangents and carries,
      // so their dgates are 0 and add nothing to the dh sums below
      int u, r0;
      if (cell_item(k, &u, &r0)) {
        const int j = k.u0 + u;
        float gate[4][kQuad], dh[kQuad], dc[kQuad];
        if (fused) {
          unit_gates_resident(w_s, ldw, b, h_s, g_s, u, r0, k, H, gate);
        } else {
          unit_gates_stored(g_s, u, r0, k, gate);
        }
        unpack(*reinterpret_cast<const float4*>(dh_s + u * R + r0), dh);
        unpack(*reinterpret_cast<const float4*>(dc_s + u * R + r0), dc);
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          const int r = r0 + i;
          float c_prev = 0.f, c = 0.f, dy = 0.f;
          if (r < k.rows) {
            const size_t o = (row0 + r) * H + j;
            c_prev = t > 0 ? cs[o - LBb * H] : c0[(state0 + r) * H + j];
            c = cs[o];
            dy = to_f32(dys[o]);
          }
          float g4[4] = {gate[0][i], gate[1][i], gate[2][i], gate[3][i]};
          dc[i] = cell_backward(g4, g4, 1, 0, c_prev, c, dy + dh[i], dc[i]);
#pragma unroll
          for (int g = 0; g < 4; ++g) gate[g][i] = g4[g];
          if (r < k.rows) {
            float* d = dg + (row0 + r) * G + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) d[g * H] = g4[g];
          }
        }
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          *reinterpret_cast<float4*>(g_s + (g * U + u) * R + r0) =
              make_float4(gate[g][0], gate[g][1], gate[g][2], gate[g][3]);
        }
        *reinterpret_cast<float4*>(dc_s + u * R + r0) = make_float4(dc[0], dc[1], dc[2], dc[3]);
      }
      __syncthreads();  // the dgates are in g_s; h_s was last read above
      if (t > 0) stage_h_prev(t - 1);

      // 3. the CTA's partial dh over its columns, a thread per (units kq,
      // kq + HQ, ... (KQ of them); 4 rows), into the receive buffer of each
      // unit's owner, once every peer has summed the last step's
      cluster_wait();
      for (int it = threadIdx.x; it < HQ * (R / kQuad); it += blockDim.x) {
        const int kq = it % HQ, r0 = kQuad * (it / HQ);
        float acc[4][kQuad];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
#pragma unroll
          for (int i = 0; i < kQuad; ++i) acc[m][i] = 0.f;
        }
        if (resident) {
          int kks[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) kks[m] = min(kq + m * HQ, H - 1);
#pragma unroll 2
          for (int uu = 0; uu < k.nu; ++uu) {
            float gr[4][kQuad], wg[4][4];
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              unpack(*reinterpret_cast<const float4*>(g_s + (g * U + uu) * R + r0), gr[g]);
            }
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              unpack(*reinterpret_cast<const float4*>(w_s + kks[m] * ldw + 4 * uu), wg[m]);
            }
#pragma unroll
            for (int m = 0; m < 4; ++m) {
#pragma unroll
              for (int g = 0; g < 4; ++g) {
#pragma unroll
                for (int i = 0; i < kQuad; ++i) acc[m][i] = fmaf(gr[g][i], wg[m][g], acc[m][i]);
              }
            }
          }
        } else {
          for (int gate = 0; gate < 4; ++gate) {
            dot_batched(wt + static_cast<size_t>(gate * H + k.u0) * H + kq, H,
                        g_s + gate * U * R + r0, R, k.nu, acc[0]);
          }
        }
        for (int m = 0; m < KQ; ++m) {
          const int kk = kq + m * HQ;
          if (kk >= H) continue;
          const int owner = kk / U;
          store_peer(recv_s + (k.q * U + kk - owner * U) * R + r0, owner,
                     make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]));
        }
      }
      cluster_sync();

      // 4. the dh carry of the CTA's units: the N partials in rank order
      for (int it = threadIdx.x; it < k.nu * (R / kQuad); it += blockDim.x) {
        const int u = it % k.nu, r0 = kQuad * (it / k.nu);
        float4 v = *reinterpret_cast<const float4*>(recv_s + u * R + r0);
        for (int p = 1; p < N; ++p) {
          const float4 w = *reinterpret_cast<const float4*>(recv_s + (p * U + u) * R + r0);
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        *reinterpret_cast<float4*>(dh_s + u * R + r0) = v;
      }
      // the next step's cell update reads the carry from other threads;
      // unfused, gate_cols's barrier comes first, fused nothing else does
      if (fused) __syncthreads();
      cluster_arrive();  // this CTA's receive buffer is free again
    }
  }
  cluster_wait();

  for (int idx = threadIdx.x; idx < k.nu * k.rows; idx += blockDim.x) {
    const int u = idx % k.nu, r = idx / k.nu;
    const size_t o = (state0 + r) * H + k.u0 + u;
    dh0[o] = dh_s[u * R + r];
    dc0[o] = dc_s[u * R + r];
  }
}

template <int M, typename TS>
cudaError_t launch_fwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
                       const float* h0, const float* c0, TS* ys, float* cs, float* hT,
                       float* cT, int T, int L, int Bb, int In, int H, int R, int N, int C,
                       int resident, cudaStream_t s) {
  const size_t smem = tiling_smem(false, 4, R, N, C, resident, In, H);
  if (smem == 0) return cudaErrorInvalidValue;
  return launch_cluster(lstm_cluster_fwd_kernel<M, TS>, N, (Bb + R - 1) / R, L, smem, s, x,
                        wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, R, N, C,
                        resident);
}

template <typename TS>
int inproj_fwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
               const float* h0, const float* c0, TS* ys, float* cs, float* hT, float* cT,
               int T, int L, int Bb, int In, int H, int R, int N, int C, int resident,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_fwd<kReal>(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L,
                                            Bb, In, H, R, N, C, resident,
                                            static_cast<cudaStream_t>(stream)));
}

template <typename TS>
int inproj_bwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
               const float* whh, const float* h0, const float* c0, const TS* ys,
               const float* cs, const TS* dys, const float* dhT, const float* dcT, TS* dx,
               float* dwih_t, float* dbias, float* dwhh_t, float* dh0, float* dc0, float* dg,
               float* ws, int T, int L, int Bb, int In, int H, int R, int N, int C,
               int resident, int ws_floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = tiling_smem(true, 4, R, N, C, resident, In, H);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  err = launch_cluster(lstm_cluster_bwd_kernel<TS>, N, (Bb + R - 1) / R, L, smem, s, x, wih_t,
                       bias, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dh0, dc0, dg, T, L, Bb,
                       In, H, R, N, C, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t wsf = static_cast<size_t>(ws_floats);
  err = launch_dx(dg, wih_t, dx, T, L, Bb, In, G, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dw(x, nullptr, dg, G, dwih_t, G, ws, wsf, T, L, Bb, In, G, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dw(ys, h0, dg, G, dwhh_t, G, ws, wsf, T, L, Bb, H, G, 1, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dbias(dg, G, dbias, G, ws, wsf, T, L, Bb, G, s));
}

}  // namespace

// Launches the forward scan on `stream` (a cudaStream_t) of `device`, on
// the planner's tiling: R rows a cluster, N CTAs a cluster, chunks of C
// steps (1 to 8), the W_hh slice resident in shared memory (resident
// = 1) or read from L2.  Returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for a tiling these kernels do not take or
// whose buffers do not fit a block's shared memory,
// cudaErrorLaunchOutOfResources when no such cluster fits the card).  All
// pointers are device pointers to contiguous f32 arrays of the shapes
// above; `cs` may be null, and then no stash is written.
extern "C" int se_lstm_inproj_fwd_f32(const float* x, const float* wih_t,
                                      const float* bias, const float* whh_t,
                                      const float* h0, const float* c0,
                                      float* ys, float* cs, float* hT, float* cT,
                                      int T, int L, int Bb, int In, int H,
                                      int R, int N, int C, int resident,
                                      int device, void* stream) {
  return inproj_fwd(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, R, N, C,
                    resident, device, stream);
}

// The bf16-stream forward: x and ys bf16, the rest as se_lstm_inproj_fwd_f32.
extern "C" int se_lstm_inproj_fwd_bf16(const __nv_bfloat16* x, const float* wih_t,
                                       const float* bias, const float* whh_t,
                                       const float* h0, const float* c0,
                                       __nv_bfloat16* ys, float* cs, float* hT, float* cT,
                                       int T, int L, int Bb, int In, int H,
                                       int R, int N, int C, int resident,
                                       int device, void* stream) {
  return inproj_fwd(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, R, N, C,
                    resident, device, stream);
}

// Launches the bound probe's forward (one stack: x [T, Bb, In], w_ih_t
// [In, 4H], bias [4H], w_hh_t [H, 4H], h0, c0 [Bb, H] -> ys [T, Bb, H], hT,
// cT [Bb, H]) with the cell update of `mode` (GateMode: 0 real, 1 bf16
// gates, 2 polyswap, 3 no gates) on the planner's tiling, on `stream` of
// `device`.  Mode 0 is the very kernel of se_lstm_inproj_fwd_f32.  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue also for an unknown
// mode).
extern "C" int se_lstm_inproj_probe_f32(const float* x, const float* wih_t,
                                        const float* bias, const float* whh_t,
                                        const float* h0, const float* c0,
                                        float* ys, float* hT, float* cT,
                                        int T, int Bb, int In, int H, int mode,
                                        int R, int N, int C, int resident,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kReal: return launch_fwd<kReal>(x, wih_t, bias, whh_t, h0, c0, ys, nullptr, hT, cT, T, 1, Bb, In, H, R, N, C, resident, s);
    case kBf16Gates: return launch_fwd<kBf16Gates>(x, wih_t, bias, whh_t, h0, c0, ys, nullptr, hT, cT, T, 1, Bb, In, H, R, N, C, resident, s);
    case kPolySwap: return launch_fwd<kPolySwap>(x, wih_t, bias, whh_t, h0, c0, ys, nullptr, hT, cT, T, 1, Bb, In, H, R, N, C, resident, s);
    case kNoGates: return launch_fwd<kNoGates>(x, wih_t, bias, whh_t, h0, c0, ys, nullptr, hT, cT, T, 1, Bb, In, H, R, N, C, resident, s);
    default: return cudaErrorInvalidValue;
  }
}

// How many clusters of the f32 kernel (forward, or with backward = 1 the
// reverse scan) on the planner's tiling fit on `device` at once; 0 if none
// does, minus a cudaError_t on an error (cudaErrorInvalidValue: a tiling
// these kernels do not take).
extern "C" int se_lstm_inproj_active_clusters(int backward, int In, int H, int R, int N, int C,
                                              int resident, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = tiling_smem(backward != 0, 4, R, N, C, resident, In, H);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return backward ? active_clusters(lstm_cluster_bwd_kernel<float>, N, smem)
                  : active_clusters(lstm_cluster_fwd_kernel<kReal, float>, N, smem);
}

// Launches the backward: the reverse scan (dh0, dc0 and the dgates scratch
// `dg` [T, L, Bb, 4H]) on the planner's tiling (as the forward's entry;
// w_hh [L, 4H, H] is w_hh_t's transpose, read only where the slice is not
// resident: a resident tiling takes any pointer there), then the dx product
// and the dW_ih, dW_hh and dbias reductions that read the scratch, their
// rows split over the workspace `ws` (ws_floats floats), all on `stream`.  Returns the first cudaError_t (0
// on success; otherwise as for the forward).  Shapes as above; every
// pointer is a device pointer to a contiguous f32 array, none may be null.
extern "C" int se_lstm_inproj_bwd_f32(const float* x, const float* wih_t,
                                      const float* bias, const float* whh_t,
                                      const float* whh, const float* h0, const float* c0,
                                      const float* ys, const float* cs,
                                      const float* dys, const float* dhT,
                                      const float* dcT, float* dx, float* dwih_t,
                                      float* dbias, float* dwhh_t, float* dh0,
                                      float* dc0, float* dg, float* ws,
                                      int T, int L, int Bb, int In, int H,
                                      int R, int N, int C, int resident, int ws_floats,
                                      int device, void* stream) {
  return inproj_bwd(x, wih_t, bias, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dx, dwih_t,
                    dbias, dwhh_t, dh0, dc0, dg, ws, T, L, Bb, In, H, R, N, C, resident,
                    ws_floats, device, stream);
}

// The bf16-stream backward: x, ys, dys and dx bf16, the rest (the dgates
// scratch too) f32 as in se_lstm_inproj_bwd_f32.
extern "C" int se_lstm_inproj_bwd_bf16(const __nv_bfloat16* x, const float* wih_t,
                                       const float* bias, const float* whh_t,
                                       const float* whh, const float* h0, const float* c0,
                                       const __nv_bfloat16* ys, const float* cs,
                                       const __nv_bfloat16* dys, const float* dhT,
                                       const float* dcT, __nv_bfloat16* dx, float* dwih_t,
                                       float* dbias, float* dwhh_t, float* dh0,
                                       float* dc0, float* dg, float* ws,
                                       int T, int L, int Bb, int In, int H,
                                       int R, int N, int C, int resident, int ws_floats,
                                       int device, void* stream) {
  return inproj_bwd(x, wih_t, bias, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dx, dwih_t,
                    dbias, dwhh_t, dh0, dc0, dg, ws, T, L, Bb, In, H, R, N, C, resident,
                    ws_floats, device, stream);
}
