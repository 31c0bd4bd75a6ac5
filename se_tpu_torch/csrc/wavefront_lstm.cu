// Two stacked LSTM layers in one kernel, run as a wavefront, for Hopper
// (sm_90a): the wavefront probe (P2).
//
// Replaces the Pallas kernel of tools/wavefront_probe.py
// (_wavefront_fwd_kernel and wavefront_lstm2, :34-145).  It asks whether
// the sub band's two stacked LSTM layers can run at the card's FMA rate in
// one kernel, layer 2 one step behind layer 1:
//
//   x [T, Bb, In]  layer l's weights, laid out by the wrapper
//   (probes/wavefront_probe.py::layout): w1 [In_p + Hp][4 Hp] = (W_ih1;
//   W_hh1), w2 [2 Hp][4 Hp] = (W_ih2; W_hh2), bias [2][4 Hp], each row's
//   columns unit-major (4 u + gate, gate order i, f, g, o), zero past In and
//   H; h0, c0 [2, Bb, H] (layer 1, then layer 2), all f32
//   iteration t = 0 .. T: layer 1's gates of step t, (x[t]; h1) . w1 + b1,
//   and layer 2's of step t - 1, (y1[t-1]; h2) . w2 + b2, then both cells
//   -> ys2, ys1 [T, Bb, H], hT, cT [2, Bb, H]
//
// What bounds it at the sub band (B = 8: T = 163, Bb = 2056, In = 32,
// H = 384): 1.22 TFLOP of f32 FMAs, 18.2 ms at 67 TFLOP/s; the weights are
// 7.27 MB an iteration.  The first design read every weight from L2
// for 4 rows, 514 blocks in 3.9 waves: ~593 GB through L2, 84.2 ms.
//
// Design (csrc/gate_product.cuh): a CTA owns 16 rows, so B = 8 runs in one
// wave of 129 CTAs, in clusters of N = 2 or 4 that share each W slab by
// multicast (the planner, probes/wavefront_probe.py::plan, picks N, 2 at B
// = 8, and the ring's depth; this file refuses any other tiling).  L2 then
// serves 129 / N x 163 x 7.27 MB (77 GB at N = 2, against ~593 GB).  Each
// iteration runs layer 1's product and cell, then layer 2's, from one of
// two buffers [x; h1; h2] ([In_p + 2 Hp][16], k-major) and writes the next
// iteration's x (by cp.async), h1 and h2 into the other: both layers read
// only the old buffer (layer 2's input y1[t-1] is h1 of the iteration
// before), so one barrier of the consumer warps ends a step.  c stays in
// registers.  Each gate's sum runs over k in order (x, then h), not in K2's
// order: the result is within rounding of two K2 calls, no longer equal to
// them bit for bit.  What bounds it now is the product's FFMA issue
// (gate_product.cuh, PERF.md §6).

#include "gate_product.cuh"

namespace {

// A layer's cell for the thread's 8 rows and 2 units from the accumulated
// gates plus the layer's bias: c in place, h into the next buffer's rows of
// the layer (h_s [Hp][16]) and into ys (rows past `rows` and units past H
// unwritten).
__device__ __forceinline__ void cell(const float (&acc)[kThreadRows][8], const float* __restrict__ bias,
                                     float (&c)[kThreadRows][2], float* h_s,
                                     float* __restrict__ ys, const GateLane& me, int rows, int H) {
  const int units[2] = {me.ua, me.ub};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + units[j]);
    float h[kThreadRows];
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
      const float ig = sigmoid_f32(acc[r][4 * j + 0] + b.x);
      const float fg = sigmoid_f32(acc[r][4 * j + 1] + b.y);
      const float gg = tanhf(acc[r][4 * j + 2] + b.z);
      const float og = sigmoid_f32(acc[r][4 * j + 3] + b.w);
      c[r][j] = fg * c[r][j] + ig * gg;
      h[r] = og * tanhf(c[r][j]);
    }
    float* hs = h_s + units[j] * kTileRows + me.r0;
    *reinterpret_cast<float4*>(hs) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(hs + 4) = make_float4(h[4], h[5], h[6], h[7]);
    if (units[j] < H) {
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        if (me.r0 + r < rows) ys[static_cast<size_t>(me.r0 + r) * H + units[j]] = h[r];
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kThreadRows][8]) {
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }
}

__global__ void __launch_bounds__(kGateThreads, 1)
wavefront_lstm2_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                       const float* __restrict__ w2, const float* __restrict__ bias,
                       const float* __restrict__ h0, const float* __restrict__ c0,
                       float* __restrict__ ys2, float* __restrict__ ys1,
                       float* __restrict__ hT, float* __restrict__ cT,
                       int T, int Bb, int In, int H, int In_p, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = padded_units(H), ld = 4 * Hp;
  const int KB = In_p + 2 * Hp;  // a buffer's rows: x, h1, h2
  const int warps = Hp / kUnitsPerWarp, consumers = 32 * warps;
  const int slab = kSlabRows * ld;
  Ring ring = make_ring(smem, stages, slab, 2 * KB * kTileRows, warps);
  float* buf = smem + static_cast<size_t>(stages) * slab;  // [2][KB][16]
  const int b0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, Bb - b0);  // <= 0: a CTA past the last tile
  const int tid = threadIdx.x, warp = tid / 32;

  // buffer 0: x[0], h1 = h0[0]; buffer 1: h2 = h0[1] (read first at t = 1);
  // zeros elsewhere (padding, rows past the batch)
  for (int i = tid; i < 2 * KB * kTileRows; i += blockDim.x) {
    const int p = i / (KB * kTileRows), k = (i / kTileRows) % KB, r = i % kTileRows;
    float v = 0.f;
    if (r < rows) {
      if (p == 0 && k < In && T > 0) {
        v = x[static_cast<size_t>(b0 + r) * In + k];
      } else if (p == 0 && k >= In_p && k < In_p + H) {
        v = h0[static_cast<size_t>(b0 + r) * H + k - In_p];
      } else if (p == 1 && k >= In_p + Hp && k < In_p + Hp + H) {
        v = h0[(static_cast<size_t>(Bb) + b0 + r) * H + k - In_p - Hp];
      }
    }
    buf[i] = v;
  }
  gate_cluster_sync();  // the ring's barriers and the buffers, cluster-wide

  const int n1 = (In_p + Hp) / kSlabRows, n2 = 2 * Hp / kSlabRows;
  if (warp >= kMaxWarps) {  // the producer's warpgroup: one thread streams W
    producer_regs();
    if (tid == 32 * kMaxWarps) {
      for (int t = 0; t <= T; ++t) {
        if (t < T) produce(ring, w1, n1);
        if (t > 0) produce(ring, w2, n2);
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
    float c[2][kThreadRows][2];
#pragma unroll
    for (int l = 0; l < 2; ++l) {
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        const int units[2] = {me.ua, me.ub};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          c[l][r][j] = me.r0 + r < rows && units[j] < H
                           ? c0[(static_cast<size_t>(l) * Bb + b0 + me.r0 + r) * H + units[j]]
                           : 0.f;
        }
      }
    }
    float acc[kThreadRows][8];
    for (int t = 0; t <= T; ++t) {
      const float* cur = buf + static_cast<size_t>(t & 1) * KB * kTileRows;
      float* nxt = buf + static_cast<size_t>((t + 1) & 1) * KB * kTileRows;
      if (t + 1 < T) {  // x[t + 1] into the next buffer, waited for at the step's end
        for (int i = tid; i < rows * In; i += consumers) {
          const int r = i / In, k = i % In;
          copy_async(nxt + k * kTileRows + r, x + (static_cast<size_t>(t + 1) * Bb + b0 + r) * In + k);
        }
      }
      if (t < T) {  // layer 1, step t
        zero(acc);
        gate_product(ring, cur, n1, ld, me, active, acc);
        cell(acc, bias, c[0], nxt + In_p * kTileRows, ys1 + (static_cast<size_t>(t) * Bb + b0) * H,
             me, rows, H);
      }
      if (t > 0) {  // layer 2, step t - 1
        zero(acc);
        gate_product(ring, cur + In_p * kTileRows, n2, ld, me, active, acc);
        cell(acc, bias + ld, c[1], nxt + (In_p + Hp) * kTileRows,
             ys2 + (static_cast<size_t>(t - 1) * Bb + b0) * H, me, rows, H);
      }
      wait_copies();
      consumers_sync(consumers);
    }
    // h1 of step T - 1 is in buffer T & 1, h2 of step T - 1 in buffer (T + 1) & 1
    // (this thread's own stores, or h0 when T = 0)
    const float* last[2] = {buf + (static_cast<size_t>(T & 1) * KB + In_p) * kTileRows,
                            buf + (static_cast<size_t>((T + 1) & 1) * KB + In_p + Hp) * kTileRows};
    const int units[2] = {me.ua, me.ub};
#pragma unroll
    for (int l = 0; l < 2; ++l) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (units[j] >= H) continue;
#pragma unroll
        for (int r = 0; r < kThreadRows; ++r) {
          if (me.r0 + r >= rows) continue;
          const size_t o = (static_cast<size_t>(l) * Bb + b0 + me.r0 + r) * H + units[j];
          hT[o] = last[l][units[j] * kTileRows + me.r0 + r];
          cT[o] = c[l][r][j];
        }
      }
    }
  }
  __syncwarp();
  gate_cluster_sync();  // no CTA leaves while a peer may still copy into it or arrive on it
}

}  // namespace

// Launches the wavefront scan on `stream` of `device` on the planner's
// tiling: clusters of N CTAs of 16 rows, a ring of `stages` W slabs.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for a tiling
// this kernel does not take).  Every pointer is a device pointer to a
// contiguous f32 array of the shapes above.
extern "C" int se_wavefront_lstm2_f32(const float* x, const float* w1, const float* w2,
                                      const float* bias, const float* h0, const float* c0,
                                      float* ys2, float* ys1, float* hT, float* cT,
                                      int T, int Bb, int In, int H, int In_p, int N, int stages,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = gate_tiling_smem(In, H, In_p, N, stages, 2);
  if (smem == 0 || T < 0 || Bb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (Bb + kTileRows - 1) / kTileRows;
  const int ctas = (tiles + N - 1) / N * N;
  return static_cast<int>(launch_gate_clusters(wavefront_lstm2_kernel, N, ctas, smem,
                                               static_cast<cudaStream_t>(stream), x, w1, w2,
                                               bias, h0, c0, ys2, ys1, hT, cT, T, Bb, In, H,
                                               In_p, stages));
}

// How many clusters of N CTAs of the kernel with a ring of `stages` slabs fit
// on `device` at once; minus a cudaError_t on an error (cudaErrorInvalidValue:
// a tiling the kernel does not take).
extern "C" int se_wavefront_active_clusters(int In, int H, int In_p, int N, int stages,
                                            int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = gate_tiling_smem(In, H, In_p, N, stages, 2);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return gate_active_clusters(wavefront_lstm2_kernel, N, smem);
}
