// Throughput micro-kernels over one sub-band row tile, for Hopper (sm_90a):
// the elementwise-throughput probe (P3).
//
// Replaces the Pallas kernels of tools/vpu_probe.py (_run, :28-41, and the
// kernels of main, :65-102).  It asks what the recurrence's per-step work
// costs on this card when nothing waits on anything: the transcendentals
// one by one, the LSTM cell's elementwise work (gates-only) and the two
// gate products (dots-only), each over the JAX probe's volume, `steps`
// repetitions of a tile of BB rows:
//
//   g [BB, 4H], c [BB, H], x [BB, In], h [BB, H], w_ih [In, 4H],
//   w_hh [H, 4H], all f32
//   sigmoid, tanh, 0.5 tanh(v / 2) + 0.5, exp: of g[:, :H] -> [BB, H]
//   gates-only: the LSTM cell of (g, c), h = o * tanh(f c + i g) -> [BB, H]
//   dots-only:  x . w_ih + h . w_hh -> [BB, 4H], w_ih and w_hh laid out by
//               the wrapper as one [In_p + Hp][4 Hp] unit-major array, as
//               P2's layer 1 reads them (probes/gate_product.py::layout)
//
// The result equals the op applied once to the tile.  Each op is the code
// the recurrent kernels run: sigmoid_f32, tanhf and expf without fast-math
// and cell_forward of lstm_common.cuh; dots-only is gate_product of
// gate_product.cuh, the routine a step of P2 runs for each layer, so P3
// reads what that product reaches alone and P2 what the recurrence and the
// cell add to it.
//
// What bounds them at the sub band's volume (B = 8, T = 163: 1956 steps of
// 176 x 384): the elementwise ops, their own MUFU instructions at the
// SFU's rate (16 a clock an SM) or their FP32 ones at 128, as counted once
// in this library's SASS (probes/vpu_probe.py::PIPE_COUNTS: sigmoid 2 MUFU
// an element, exp 1, gates-only 10; every op MUFU-bound); dots-only, 440
// GFLOP of f32 FMAs, 6.57 ms at 67 TFLOP/s, and W's 2.56 MB a step: its
// first design read W from L2 for 4 rows a block, ~220 GB in 22.7 ms.
//
// Design.  The work of every step is really done:
//   - elementwise ops: one thread per element of the tile (sigmoid and
//     exp: per four elements of a row, in four independent chains, see
//     kChains), blocks over the elements and over `groups` groups of
//     steps; step s reads its input at an offset of s * stride floats, and
//     keeps its value as fmaf(kept, stride, value).  The caller passes
//     stride = 0, so every step reads the tile (from L1) and the kept value
//     is the last one; as stride is not known when compiling, no step's
//     loads or math can be hoisted out of the loop or dropped;
//   - dots-only: CTAs of 16 rows of the tile in clusters that share each W
//     slab by multicast, the tile's 11 row tiles times `groups` groups of
//     steps in one wave (the wrapper's plan); a CTA stages its rows of x
//     and h at an offset of s * stride floats for each of its steps (by
//     cp.async, a step ahead) and scales its accumulators by stride before
//     the step's product, so each step's product feeds the result and none
//     can be dropped; the W stream is new shared memory every step.

#include "gate_product.cuh"

namespace {

enum Op : int { kSigmoid = 0, kTanh = 1, kSigmoidTanh = 2, kExp = 3, kGates = 4 };

constexpr int kThreads = 256;  // elementwise ops

// Independent chains a thread: sigmoid and exp, which one chain a thread
// left under half of their bound on an H100 (the SFU's rate of their MUFU
// instructions; PERF.md §6), take elements e .. e + 3 of one row, read as
// one float4 and kept in four chains, so that a step's load, addressing
// and loop control serve four elements; the other ops keep one chain.
template <int O>
constexpr int kChains = (O == kSigmoid || O == kExp) ? 4 : 1;

template <int O>
__global__ void __launch_bounds__(kThreads)
vpu_probe_kernel(const float* __restrict__ g, const float* __restrict__ c,
                 const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ wih, const float* __restrict__ whh,
                 float* __restrict__ out, int BB, int H, int In, int steps, int stride) {
  constexpr int C = kChains<O>;
  const int G = 4 * H;
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) * C;  // the thread's first element
  if (e >= BB * H) return;
  const int r = e / H, j = e % H;  // its C elements are j .. j + C - 1 of row r
  const int per = (steps + gridDim.y - 1) / gridDim.y;
  const int s0 = blockIdx.y * per, s1 = min(steps, s0 + per);
  const float keep_scale = static_cast<float>(stride);
  float kept[C];
#pragma unroll
  for (int i = 0; i < C; ++i) kept[i] = 0.f;
  if constexpr (C == 4) {
    // the elements' address stepped by stride, not formed anew each step
    const float* p = g + static_cast<size_t>(r) * G + j + static_cast<size_t>(s0) * stride;
#pragma unroll 4
    for (int s = s0; s < s1; ++s, p += stride) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      float v[4] = {q.x, q.y, q.z, q.w};
      if constexpr (O == kSigmoid) {
        // sigmoid_f32, 1 / (1 + expf(-v)), a half at a time across the
        // chains: the same operations, but each division's slow-path
        // branch no longer keeps the next element's expf from overlapping
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = 1.0f + expf(-v[i]);
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = 1.0f / v[i];
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = expf(v[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) kept[i] = fmaf(kept[i], keep_scale, v[i]);
    }
  } else {
    for (int s = s0; s < s1; ++s) {
      const size_t off = static_cast<size_t>(s) * stride;
      const float* gr = g + off + static_cast<size_t>(r) * G;
      float v;
      if constexpr (O == kTanh) {
        v = tanhf(gr[j]);
      } else if constexpr (O == kSigmoidTanh) {
        v = 0.5f * tanhf(gr[j] * 0.5f) + 0.5f;
      } else {
        cell_forward(gr, H, j, c[off + static_cast<size_t>(r) * H + j], &v);
      }
      kept[0] = fmaf(kept[0], keep_scale, v);
    }
  }
  if (s0 < s1) {
#pragma unroll
    for (int i = 0; i < C; ++i) out[e + i] = kept[i];
  }
}

template <int O>
cudaError_t launch(const float* g, const float* c, const float* x, const float* h,
                   const float* wih, const float* whh, float* out, int BB, int H, int In,
                   int steps, int groups, int stride, cudaStream_t s) {
  constexpr int C = kChains<O>;
  // C elements of one row read as one aligned vector, on every step
  if (C > 1 && (H % C || stride % C || reinterpret_cast<uintptr_t>(g) % (4 * C))) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((BB * H / C + kThreads - 1) / kThreads, groups);
  vpu_probe_kernel<O><<<grid, kThreads, 0, s>>>(g, c, x, h, wih, whh, out, BB, H, In, steps,
                                                stride);
  return cudaGetLastError();
}

// dots-only: CTA i of the launch holds row tile i % tiles of step group i /
// tiles (none past tiles x groups); every CTA walks the same `per` step
// slots, so a cluster's CTAs consume the same slabs, and computes in those
// of its own group's steps.
__global__ void __launch_bounds__(kGateThreads, 1)
vpu_dots_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ w, float* __restrict__ out, int BB, int H, int In,
                int In_p, int steps, int groups, int stride, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = padded_units(H), ld = 4 * Hp, K = In_p + Hp, slab = kSlabRows * ld;
  const int warps = Hp / kUnitsPerWarp, consumers = 32 * warps;
  Ring ring = make_ring(smem, stages, slab, 2 * K * kTileRows, warps);
  float* buf = smem + static_cast<size_t>(stages) * slab;  // [2][K][16]: x, h
  const int tiles = (BB + kTileRows - 1) / kTileRows;
  const int tile = blockIdx.x % tiles, group = blockIdx.x / tiles;
  const int b0 = tile * kTileRows;
  const int rows = group < groups ? min(kTileRows, BB - b0) : 0;
  const int per = (steps + groups - 1) / groups;
  const int mine = rows > 0 ? max(0, min(per, steps - group * per)) : 0;  // steps it computes
  const int tid = threadIdx.x, warp = tid / 32;
  for (int i = tid; i < 2 * K * kTileRows; i += blockDim.x) buf[i] = 0.f;
  gate_cluster_sync();

  const int n = K / kSlabRows;
  if (warp >= kMaxWarps) {  // the producer's warpgroup: one thread streams W
    producer_regs();
    if (tid == 32 * kMaxWarps) {
      for (int j = 0; j < per; ++j) produce(ring, w, n);
    }
    __syncwarp();
    gate_cluster_sync();
    return;
  }
  consumer_regs();
  if (warp < warps) {
    const GateLane me;
    const float keep_scale = static_cast<float>(stride);
    float acc[kThreadRows][8];
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    }
    // step j's rows of x and h, k-major, into buffer j & 1 (cp.async, issued
    // a step ahead and waited for before the step's barrier)
    auto stage = [&](int j) {
      float* a = buf + static_cast<size_t>(j & 1) * K * kTileRows;
      const size_t off = static_cast<size_t>(group * per + j) * stride;
      for (int i = tid; i < rows * (In + H); i += consumers) {
        const int r = i / (In + H), k = i % (In + H);
        copy_async(a + (k < In ? k : In_p + k - In) * kTileRows + r,
                   k < In ? x + off + static_cast<size_t>(b0 + r) * In + k
                          : h + off + static_cast<size_t>(b0 + r) * H + k - In);
      }
    };
    if (mine > 0) stage(0);
    for (int j = 0; j < per; ++j) {
      const bool active = j < mine;
      wait_copies();
      consumers_sync(consumers);
      if (j + 1 < mine) stage(j + 1);
      if (active) {
#pragma unroll
        for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] *= keep_scale;
        }
      }
      gate_product(ring, buf + static_cast<size_t>(j & 1) * K * kTileRows, n, ld, me, active,
                   acc);
    }
    if (mine > 0) {
      const int units[2] = {me.ua, me.ub};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (units[jj] >= H) continue;
#pragma unroll
        for (int r = 0; r < kThreadRows; ++r) {
          if (me.r0 + r >= rows) continue;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            out[static_cast<size_t>(b0 + me.r0 + r) * 4 * H + g * H + units[jj]] =
                acc[r][4 * jj + g];
          }
        }
      }
    }
  }
  __syncwarp();
  gate_cluster_sync();
}

}  // namespace

// Launches elementwise op `op` (0 sigmoid, 1 tanh, 2 0.5 tanh(v / 2) + 0.5,
// 3 exp, 4 gates-only) over `steps` repetitions of the tile in `groups`
// groups of steps, on `stream` of `device`.  `stride` must be 0 (see
// above).  Every pointer is a device pointer to a contiguous f32 array of
// the shapes above; out is [BB, H].  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for an unknown op, or for sigmoid and exp where H
// is not a multiple of 4 or g is not 16-byte aligned).
extern "C" int se_vpu_probe_f32(const float* g, const float* c, const float* x,
                                const float* h, const float* wih, const float* whh,
                                float* out, int BB, int H, int In, int steps, int groups,
                                int op, int stride, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSigmoid: err = launch<kSigmoid>(g, c, x, h, wih, whh, out, BB, H, In, steps, groups, stride, s); break;
    case kTanh: err = launch<kTanh>(g, c, x, h, wih, whh, out, BB, H, In, steps, groups, stride, s); break;
    case kSigmoidTanh: err = launch<kSigmoidTanh>(g, c, x, h, wih, whh, out, BB, H, In, steps, groups, stride, s); break;
    case kExp: err = launch<kExp>(g, c, x, h, wih, whh, out, BB, H, In, steps, groups, stride, s); break;
    case kGates: err = launch<kGates>(g, c, x, h, wih, whh, out, BB, H, In, steps, groups, stride, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Launches dots-only over `steps` repetitions of the tile (x [BB, In], h
// [BB, H], w laid out [In_p + Hp][4 Hp], out [BB, 4H]) in `groups` groups
// of steps on the planner's tiling (clusters of N CTAs, a ring of `stages`
// slabs), on `stream` of `device`.  `stride` must be 0.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a tiling the kernel
// does not take).
extern "C" int se_vpu_dots_f32(const float* x, const float* h, const float* w, float* out,
                               int BB, int H, int In, int In_p, int steps, int groups,
                               int stride, int N, int stages, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = gate_tiling_smem(In, H, In_p, N, stages, 1);
  if (smem == 0 || steps < 1 || groups < 1 || BB < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (BB + kTileRows - 1) / kTileRows;
  const int ctas = (tiles * groups + N - 1) / N * N;
  return static_cast<int>(launch_gate_clusters(vpu_dots_kernel, N, ctas, smem,
                                               static_cast<cudaStream_t>(stream), x, h, w, out,
                                               BB, H, In, In_p, steps, groups, stride, stages));
}

// How many clusters of N CTAs of the dots-only kernel with a ring of
// `stages` slabs fit on `device` at once (minus a cudaError_t on an error).
extern "C" int se_vpu_dots_active_clusters(int In, int H, int In_p, int N, int stages,
                                           int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = gate_tiling_smem(In, H, In_p, N, stages, 1);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return gate_active_clusters(vpu_dots_kernel, N, smem);
}
