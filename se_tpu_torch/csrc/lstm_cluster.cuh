// The LSTM scan on thread-block clusters, forward and backward: the kernels
// of K2 (lstm_inproj.cu, with the input projection inside the kernel; its
// design is described at the top of that file) and of K1 (lstm_scan.cu,
// the scan of a precomputed x_proj with both biases folded in).  K1 is K2
// without the projection (kProj = false): its CTAs stage their own gate
// columns of x_proj[t] into the chunk's projection buffer (load_chunk)
// where K2 forms x . W_ih (project_chunk), add no bias, and update the
// cell as K1's first design did (cell_k1).  Everything else, the resident
// or streamed W_hh slice, the gate products in the order of K1's and K2's
// first designs, the exchange of h and of the partial dh through
// distributed shared memory, is one code.  K1's reverse scan also loads a
// step's cell operands (c_prev, c, dy) before it forms the gates, and the
// next step's h_prev into registers before the dh pass (stored after it),
// so that those loads from memory are in flight while the step computes;
// in its bf16-stream form it writes dx_proj (its dgates, rounded) beside
// the f32 dgates scratch that its dW_hh pass reads.

#pragma once

#include <cuda_bf16.h>

#include "cluster_scan.cuh"

namespace {

// Elements of the next step's h_prev a thread of K1's reverse scan holds
// in registers through the dh pass.
constexpr int kPrefetch = 4;

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

// K1's cell update: cell_forward's with c = f c_prev + i g contracted as
// fmaf(i, g, f * c_prev), the contraction nvcc chose in K1's first design
// (one block per 4 rows), so that K1's forward keeps that design's bits;
// K2's cell update stays cell_forward's.
__device__ __forceinline__ float cell_k1(const float* g, float c_prev, float* h) {
  const float ig = sigmoid_f32(g[0]);
  const float fg = sigmoid_f32(g[1]);
  const float gg = tanhf(g[2]);
  const float og = sigmoid_f32(g[3]);
  const float c = fmaf(ig, gg, fg * c_prev);
  *h = og * tanhf(c);
  return c;
}

// g_s[c][r0 .. r0+3] = (g_s[c][r0 ..] + h_s[:][r0 ..] . W_hh[:, col(c)]) +
// b[col(c)] for each (column, 4-row group) of the CTA, g_s holding the
// step's x . W_ih (kBias false: g_s holding x_proj, biases folded in, and
// no + b); the sum over k in order, W_hh[:, col] from the resident slice
// w_s [H][ldw] or from whh [H][4H] in L2.
template <bool kBias>
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
    const float bv = kBias ? __ldg(b + col) : 0.f;
    float4* p = reinterpret_cast<float4*>(g_s + c * R + r0);
    float4 v = *p;
    v.x = kBias ? (v.x + acc[0]) + bv : v.x + acc[0];
    v.y = kBias ? (v.y + acc[1]) + bv : v.y + acc[1];
    v.z = kBias ? (v.z + acc[2]) + bv : v.z + acc[2];
    v.w = kBias ? (v.w + acc[3]) + bv : v.w + acc[3];
    *p = v;
  }
}

// The four gate pre-activations of unit u for rows r0 .. r0+3 from the
// resident slice: gate[g][i] = (g_s[g U + u][r0 + i] + h_s[:][r0 + i] .
// w_s[:][u][g]) + b[col], each sum over k in order.  A k costs a thread one
// float4 of h and one of W for 16 sums; a warp's 8 units x 4 row groups
// (cell_item) read 8 W and 4 h float4s, two shared-memory wavefronts.
// kBias false: no + b, as gate_cols.
template <bool kBias>
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
    const float bv = kBias ? __ldg(b + g * H + k.u0 + u) : 0.f;
    float p[kQuad];
    unpack(*reinterpret_cast<const float4*>(g_s + (g * U + u) * R + r0), p);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) gate[g][i] = kBias ? (p[i] + acc[g][i]) + bv : p[i] + acc[g][i];
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

// TC: the storage type of the cell-state stash cs (float, or __nv_bfloat16
// for K2's bf16 stash: each c rounded to nearest even as it is stored,
// pallas_lstm.py:335); the carry c itself stays f32 in shared memory.
template <int M, typename TS, bool kProj = true, typename TC = float>
__global__ void __launch_bounds__(kThreads)
lstm_cluster_fwd_kernel(const TS* __restrict__ x, const float* __restrict__ wih_t,
                        const float* __restrict__ bias, const float* __restrict__ whh_t,
                        const float* __restrict__ h0, const float* __restrict__ c0,
                        TS* __restrict__ ys, TC* __restrict__ cs, float* __restrict__ hT,
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
  const float* wih = kProj ? wih_t + static_cast<size_t>(k.l) * In * G : nullptr;
  const float* whh = whh_t + static_cast<size_t>(k.l) * H * G;
  const float* b = kProj ? bias + static_cast<size_t>(k.l) * G : nullptr;
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
    if constexpr (kProj) {
      project_chunk(x, wih, xc_s, p_s, t0, n, L, Bb, k, In, H);
    } else {
      load_chunk(x, p_s, t0, n, L, Bb, k, H);
    }

    for (int s = 0; s < n; ++s) {
      const int t = t0 + s;
      float* g_s = p_s + s * GU * R;
      const size_t row0 = (static_cast<size_t>(t) * L + k.l) * Bb + k.b0;

      // 1. the gates, a thread per column, unless a thread per (unit, 4
      // rows) forms all four below
      if (!fused) {
        gate_cols<kProj>(resident, whh, w_s, ldw, b, h_s, g_s, k, H);
        __syncthreads();
      }
      // 2. the cell update of (unit u, 4 rows)
      float cv[kQuad], hv[kQuad];
      if (mine) {
        float gate[4][kQuad];
        if (fused) {
          unit_gates_resident<kProj>(w_s, ldw, b, h_s, g_s, u, r0, k, H, gate);
        } else {
          unit_gates_stored(g_s, u, r0, k, gate);
        }
        unpack(*reinterpret_cast<const float4*>(c_s + u * R + r0), cv);
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          const float g4[4] = {gate[0][i], gate[1][i], gate[2][i], gate[3][i]};
          cv[i] = kProj ? cell_mode<M>(g4, 1, 0, cv[i], &hv[i]) : cell_k1(g4, cv[i], &hv[i]);
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
            if (cs != nullptr) store_as(cs + o, cv[i]);
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

// TC: the stash's storage type, as the forward's; c_t and c_prev at t > 0
// are read back from it and widened to f32 (pallas_lstm.py:362, :377).
template <typename TS, bool kProj = true, typename TC = float>
__global__ void __launch_bounds__(kThreads)
lstm_cluster_bwd_kernel(const TS* __restrict__ x, const float* __restrict__ wih_t,
                        const float* __restrict__ bias, const float* __restrict__ whh_t,
                        const float* __restrict__ whh_tt, const float* __restrict__ h0,
                        const float* __restrict__ c0, const TS* __restrict__ ys,
                        const TC* __restrict__ cs, const TS* __restrict__ dys,
                        const float* __restrict__ dhT, const float* __restrict__ dcT,
                        float* __restrict__ dh0, float* __restrict__ dc0,
                        float* __restrict__ dg, TS* __restrict__ dxs, int T, int L, int Bb,
                        int In, int H, int R, int N, int C, int resident) {
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
  const float* wih = kProj ? wih_t + static_cast<size_t>(k.l) * In * G : nullptr;
  const float* whh = whh_t + static_cast<size_t>(k.l) * H * G;
  const float* wt = whh_tt + static_cast<size_t>(k.l) * G * H;  // [4H][H]
  const float* b = kProj ? bias + static_cast<size_t>(k.l) * G : nullptr;
  const size_t state0 = static_cast<size_t>(k.l) * Bb + k.b0;
  const bool fused = resident && k.nu * (R / kQuad) >= kFusedItems;

  // K1 takes the next step's h_prev (ys[t-2]) into registers before the
  // dh pass and stores it after, so that the loads are in flight through
  // the pass (at most kPrefetch elements a thread); K2 stages it before.
  const bool prefetch = !kProj && H * R <= kPrefetch * kThreads;
  TS h_next[kPrefetch];

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
    if constexpr (kProj) {
      project_chunk(x, wih, xc_s, p_s, t0, n, L, Bb, k, In, H);
    } else {
      load_chunk(x, p_s, t0, n, L, Bb, k, H);
    }

    for (int s = n - 1; s >= 0; --s) {
      const int t = t0 + s;
      float* g_s = p_s + s * GU * R;
      const size_t row0 = (static_cast<size_t>(t) * L + k.l) * Bb + k.b0;

      // K1 loads the cell update's operands from memory (c_prev, c, and dy
      // as stored) first, in flight while the gates are formed; K2 loads
      // them in the cell update
      int u, r0;
      bool mine = false;
      float k1_c_prev[kQuad], k1_c[kQuad];
      TS k1_dy[kQuad];
      if constexpr (!kProj) {
        mine = cell_item(k, &u, &r0);
        if (mine) {
#pragma unroll
          for (int i = 0; i < kQuad; ++i) {
            const int r = r0 + i;
            const size_t o = (row0 + r) * H + k.u0 + u;
            const bool in = r < k.rows;
            k1_c_prev[i] = !in ? 0.f
                           : t > 0 ? to_f32(cs[o - LBb * H]) : c0[(state0 + r) * H + k.u0 + u];
            k1_c[i] = in ? to_f32(cs[o]) : 0.f;
            k1_dy[i] = in ? dys[o] : TS{};
          }
        }
      }

      // 1. the gates recomputed, a thread per column, unless a thread per
      // (unit, 4 rows) forms all four below
      if (!fused) {
        gate_cols<kProj>(resident, whh, w_s, ldw, b, h_s, g_s, k, H);
        __syncthreads();
      }
      // 2. a thread per (unit u, 4 rows): its four gates and their
      // gradients (pallas_lstm.py:373-386, :429) into g_s and the dgates
      // scratch.  Rows past the batch edge see zero cotangents and carries,
      // so their dgates are 0 and add nothing to the dh sums below
      if constexpr (kProj) mine = cell_item(k, &u, &r0);
      if (mine) {
        const int j = k.u0 + u;
        float gate[4][kQuad], dh[kQuad], dc[kQuad];
        if (fused) {
          unit_gates_resident<kProj>(w_s, ldw, b, h_s, g_s, u, r0, k, H, gate);
        } else {
          unit_gates_stored(g_s, u, r0, k, gate);
        }
        unpack(*reinterpret_cast<const float4*>(dh_s + u * R + r0), dh);
        unpack(*reinterpret_cast<const float4*>(dc_s + u * R + r0), dc);
#pragma unroll
        for (int i = 0; i < kQuad; ++i) {
          const int r = r0 + i;
          float c_prev = 0.f, c = 0.f, dy = 0.f;
          if constexpr (kProj) {
            if (r < k.rows) {
              const size_t o = (row0 + r) * H + j;
              c_prev = t > 0 ? to_f32(cs[o - LBb * H]) : c0[(state0 + r) * H + j];
              c = to_f32(cs[o]);
              dy = to_f32(dys[o]);
            }
          } else {
            c_prev = k1_c_prev[i];
            c = k1_c[i];
            dy = to_f32(k1_dy[i]);
          }
          float g4[4] = {gate[0][i], gate[1][i], gate[2][i], gate[3][i]};
          dc[i] = cell_backward(g4, g4, 1, 0, c_prev, c, dy + dh[i], dc[i]);
#pragma unroll
          for (int g = 0; g < 4; ++g) gate[g][i] = g4[g];
          if (r < k.rows) {
            float* d = dg + (row0 + r) * G + j;
#pragma unroll
            for (int g = 0; g < 4; ++g) d[g * H] = g4[g];
            if constexpr (!kProj && !kIsF32<TS>) {  // K1's bf16 dx_proj beside the f32 dgates
              TS* dx = dxs + (row0 + r) * G + j;
#pragma unroll
              for (int g = 0; g < 4; ++g) store_as(dx + g * H, g4[g]);
            }
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
      if (prefetch && t > 1) {  // rows of ys[t-2], stored after the dh pass
        const TS* src = ys + ((static_cast<size_t>(t - 2) * L + k.l) * Bb + k.b0) * H;
#pragma unroll
        for (int i = 0; i < kPrefetch; ++i) {
          const int e = threadIdx.x + i * kThreads, r = e / H;
          h_next[i] = e < H * R && r < k.rows ? src[static_cast<size_t>(r) * H + e % H] : TS{};
        }
      } else if (t > 0) {
        stage_h_prev(t - 1);
      }

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
      if (prefetch && t > 1) {  // h_s [H][R], zeros past the batch edge
#pragma unroll
        for (int i = 0; i < kPrefetch; ++i) {
          const int e = threadIdx.x + i * kThreads;
          if (e < H * R) h_s[(e % H) * R + e / H] = to_f32(h_next[i]);
        }
      }
      // the next step's gates read h_s and its cell update the carry from
      // other threads; unfused and without the prefetch, gate_cols's
      // barrier comes first, otherwise nothing else does
      if (fused || prefetch) __syncthreads();
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


}  // namespace
