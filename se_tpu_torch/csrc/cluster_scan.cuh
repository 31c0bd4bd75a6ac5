// The thread-block-cluster machinery of the recurrent scans, shared by K2
// (lstm_inproj.cu, the LSTM: four gates i, f, g, o), K1 (lstm_scan.cu, the
// same LSTM kernels of lstm_cluster.cuh without the input projection) and
// K3 (gru_inproj.cu, the GRU: three gates r, z, n).  A cluster of N CTAs owns
// a tile of R batch rows of one stack; CTA q owns U = ceil(H / N) hidden
// units u0 = q U .. and every gate column of each (kGates U local columns
// c = gate * U + u), so a unit's cell update never leaves its CTA.  The
// CTA keeps its W_hh slice in shared memory (stage_slice), stages the
// chunk's x and forms its columns' x . W_ih (project_chunk; K1 stages its
// columns of x_proj instead, load_chunk), and trades h (forward) or
// partial dh sums (backward) with its peers through distributed shared
// memory (store_peer) between cluster barriers.  The
// tiling (R, N, C, residency) comes from the planner in Python
// (se_tpu_torch/ops/cluster_plan.py::plan); tiling_smem is its shared-memory
// formula, and launch_cluster checks with the runtime that a cluster of
// the tiling fits the card before it launches.

#pragma once

#include <cooperative_groups.h>

#include <map>
#include <tuple>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;        // a CTA's threads; each loops over its phase's items
constexpr size_t kMaxSmem = 232448;  // shared memory a block can use (227 KB)
constexpr int kMaxCluster = 16;      // above 8: the non-portable cluster size
constexpr int kMaxChunk = 8;         // steps a chunk projects at once
constexpr int kQuad = 4;             // rows a thread's float4 of a row operand covers
// Loads a thread issues before it uses the first: a step's passes over
// memory (x, h_prev, W_ih, a streamed W_hh) are bound by L2's latency, not
// its bandwidth, unless many loads are in flight.
constexpr int kStageBatch = 16;  // staging x or h_prev into shared memory
constexpr int kDotBatch = 32;    // a column of W_ih or of a streamed W_hh

// The floats between two rows k of a resident W_hh slice [H][ldw], whose
// row holds the kGates U columns unit by unit ([u][gate]).  K2 (4 gates)
// reads a unit's four gates as one float4, rows 4U + 4 apart; K3 (3
// gates) reads one float a thread, and its backward's lanes step along k,
// so an odd row length keeps them on 32 banks.
__host__ __device__ constexpr int slice_ld(int gates, int U) {
  return gates == 4 ? 4 * U + 4 : (gates * U) | 1;
}

// The cluster barrier, whole or split into its arrive and its wait (every
// thread of every CTA of the cluster takes part; the arrive releases the
// thread's stores, to peers' shared memory too, and the wait acquires
// theirs).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// acc[i] += sum over k < K of a[k * R + i] * w[k * ldk] for i < 4, k in
// order: a column of w (global memory, ldk floats a step in k) against a
// [K][R] operand, kDotBatch loads of w in flight at a time.
__device__ __forceinline__ void dot_batched(const float* __restrict__ w, size_t ldk,
                                            const float* a, int R, int K, float* acc) {
  int kk = 0;
  for (; kk + kDotBatch <= K; kk += kDotBatch) {
    float wv[kDotBatch];
#pragma unroll
    for (int b = 0; b < kDotBatch; ++b) wv[b] = __ldg(w + (kk + b) * ldk);
#pragma unroll
    for (int b = 0; b < kDotBatch; ++b) fma_rows<kQuad>(a + (kk + b) * R, wv[b], acc);
  }
  for (; kk < K; ++kk) fma_rows<kQuad>(a + kk * R, __ldg(w + kk * ldk), acc);
}

// A float4's four values.
__device__ __forceinline__ void unpack(const float4& v, float* a) {
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// What one CTA owns: stack l, rows b0 .. b0 + rows - 1 of a tile of R, and
// units u0 .. u0 + nu - 1 of its cluster's N (U each, the last CTA fewer
// where N does not divide H); its kGates U local columns c = gate * U + u.
template <int kGates>
struct Cta {
  int q, N, U, u0, nu, GU, l, b0, rows, R;

  __device__ Cta(int Bb, int H, int R_, int N_) {
    N = N_;
    R = R_;
    q = static_cast<int>(cg::this_cluster().block_rank());
    U = (H + N - 1) / N;
    u0 = q * U;
    nu = min(U, H - u0);
    GU = kGates * U;
    l = blockIdx.y;
    b0 = (blockIdx.x / N) * R;
    rows = min(R, Bb - b0);
  }
  // the global gate column of local column c (its unit must be < nu)
  __device__ int col(int c, int H) const { return (c / U) * H + u0 + c % U; }
};

// dst[at(t, r, j)] = to_f32(get(t, r, j)) for every element (t, r, j) of
// a [count][R][K] index space, each thread taking every blockDim.x-th
// element with kStageBatch gets in flight before its stores; the element's
// indices are stepped, not divided out.  Stages rows of memory (x, h_prev,
// W) into shared memory in the layout `at` gives.  `get` returns the
// element as stored (f32 or bf16) and the store converts it: a conversion
// inside the get put each bf16 load's first use in the load's own branch,
// so each load waited for the one before.
template <typename Get, typename At>
__device__ __forceinline__ void stage(float* dst, int count, int R, int K, Get get, At at) {
  using V = decltype(get(0, 0, 0));
  const int total = count * R * K, step = blockDim.x;
  const int dj = step % K, dq = step / K, dr = dq % R, dt = dq / R;
  int e = threadIdx.x;
  int j = e % K, r = (e / K) % R, t = e / (R * K);
  while (e < total) {
    V v[kStageBatch];
    int to[kStageBatch];
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      to[b] = e < total ? at(t, r, j) : -1;
      v[b] = e < total ? get(t, r, j) : V{};
      e += step;
      j += dj;
      r += dr;
      t += dt;
      if (j >= K) {
        j -= K;
        ++r;
      }
      if (r >= R) {
        r -= R;
        ++t;
      }
    }
#pragma unroll
    for (int b = 0; b < kStageBatch; ++b) {
      if (to[b] >= 0) dst[to[b]] = to_f32(v[b]);
    }
  }
}

// w_s[kk][u][g] = W_hh[l][kk][col(g U + u)] for kk < H, u < U (0 past the
// CTA's units): the CTA's slice with a unit's gates adjacent, rows ldw
// floats apart (slice_ld).
template <int kGates>
__device__ __forceinline__ void stage_slice(float* w_s, int ldw, const float* __restrict__ whh,
                                            const Cta<kGates>& k, int H) {
  const int G = kGates * H;
  stage(w_s, H, kGates, k.U,
        [=](int kk, int g, int u) {
          return u < k.nu ? whh[static_cast<size_t>(kk) * G + g * H + k.u0 + u] : 0.f;
        },
        [=](int kk, int g, int u) { return kk * ldw + kGates * u + g; });
}

// value v into the shared memory of CTA `rank` of the cluster, at the
// address `local` has in this CTA's (distributed shared memory).
__device__ __forceinline__ void store_peer(float* local, int rank, float4 v) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// The rows of the tile (rows `rows` of [rows][H] at src, f32 or bf16) into
// dst [H][R] as f32, zeros past `rows`.
template <int kGates, typename TS>
__device__ __forceinline__ void stage_h(float* dst, const TS* __restrict__ src,
                                        const Cta<kGates>& k, int H) {
  stage(dst, 1, k.R, H,
        [=](int, int r, int j) { return r < k.rows ? src[static_cast<size_t>(r) * H + j] : TS{}; },
        [=](int, int r, int j) { return j * k.R + r; });
}

// p_s[s][c][r0 .. r0+3] = xc_s[s][:][r0 .. r0+3] . wih[:, col(c)], the sum
// over k in order, for the n steps of a chunk and each (column c, 4-row
// group) of the CTA: a thread per (step, column, 4 rows), its W_ih column
// read kDotBatch loads at a time.  xc_s is [C][In][R].
template <int kGates>
__device__ __forceinline__ void project_cols(const float* __restrict__ wih, const float* xc_s,
                                             float* p_s, int n, const Cta<kGates>& k, int In,
                                             int H) {
  const int G = kGates * H, R = k.R, per_step = k.GU * (R / kQuad);
  for (int it = threadIdx.x; it < n * per_step; it += blockDim.x) {
    const int s = it / per_step, c = it % k.GU, r0 = kQuad * ((it % per_step) / k.GU);
    if (c % k.U >= k.nu) continue;
    float acc[kQuad] = {0.f, 0.f, 0.f, 0.f};
    dot_batched(wih + k.col(c, H), G, xc_s + s * In * R + r0, R, In, acc);
    *reinterpret_cast<float4*>(p_s + (s * k.GU + c) * R + r0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// The chunk's n steps of input projections into p_s: its x rows staged
// (xc_s [C][In][R], zeros past the batch edge), then project_cols.
template <int kGates, typename TX>
__device__ __forceinline__ void project_chunk(const TX* __restrict__ x,
                                              const float* __restrict__ wih, float* xc_s,
                                              float* p_s, int t0, int n, int L, int Bb,
                                              const Cta<kGates>& k, int In, int H) {
  const int R = k.R;
  stage(xc_s, n, R, In,
        [=](int s, int r, int j) {
          return r < k.rows ? x[((static_cast<size_t>(t0 + s) * L + k.l) * Bb + k.b0 + r) * In + j]
                            : TX{};
        },
        [=](int s, int r, int j) { return (s * In + j) * R + r; });
  __syncthreads();
  project_cols(wih, xc_s, p_s, n, k, In, H);
  __syncthreads();
}

// The chunk's n steps of a projection computed outside the kernel (K1's
// x_proj [T, L, Bb, kGates H], f32 or bf16, biases folded in) into p_s
// [C][kGates U][R]: the CTA's own gate columns, zeros past the batch edge
// and past its units.  A thread's loads run along a gate's U columns.
template <int kGates, typename TX>
__device__ __forceinline__ void load_chunk(const TX* __restrict__ xp, float* p_s, int t0, int n,
                                           int L, int Bb, const Cta<kGates>& k, int H) {
  const size_t G = static_cast<size_t>(kGates) * H;
  stage(p_s, n, k.R, k.GU,
        [=](int s, int r, int c) {
          return r < k.rows && c % k.U < k.nu
                     ? xp[((static_cast<size_t>(t0 + s) * L + k.l) * Bb + k.b0 + r) * G +
                          k.col(c, H)]
                     : TX{};
        },
        [=](int s, int r, int c) { return (s * k.GU + c) * k.R + r; });
  __syncthreads();
}

// A thread's (unit u, rows r0 ..) in the cell update, if it has one: a warp
// takes 8 units x 4 row groups.  The threads this needs: cell_threads.
template <int kGates>
__device__ __forceinline__ bool cell_item(const Cta<kGates>& k, int* u, int* r0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int unit_blocks = (k.nu + 7) / 8;
  *u = (warp % unit_blocks) * 8 + lane % 8;
  const int rg = (warp / unit_blocks) * 4 + lane / 8;
  *r0 = kQuad * rg;
  return *u < k.nu && rg < k.R / kQuad;
}

__host__ __device__ __forceinline__ int cell_threads(int U, int R) {
  return 32 * ((U + 7) / 8) * ((R / kQuad + 3) / 4);
}

// A tiling from the planner: R rows a cluster, N CTAs, C steps a chunk,
// the W_hh slice resident or not, for a scan of kGates gates.  Its shared
// memory per CTA, in bytes (the planner's formula), or 0 if the tiling is
// not one these kernels take.  Forward: h [H][R], the chunk's x [C][In][R]
// and projections [C][kGates U][R], and one [U][R] buffer (K2: c; K3:
// hp_n); backward: h_prev [H][R], the partial dh received [N][U][R], the
// chunk's buffers and two [U][R] (K2: the dh and dc carries; K3: the dh
// carry and hp_n); the resident slice [H][slice_ld].
size_t tiling_smem(bool backward, int gates, int R, int N, int C, int resident, int In, int H) {
  if (R < kQuad || R % kQuad || N < 1 || N > kMaxCluster || N > H) return 0;
  if (C < 1 || C > kMaxChunk) return 0;
  const size_t U = (H + N - 1) / N;
  if ((N - 1) * U >= static_cast<size_t>(H)) return 0;  // a CTA without units
  if (cell_threads(static_cast<int>(U), R) > kThreads) return 0;  // a cell item a thread
  const size_t GU = gates * U;
  size_t floats = static_cast<size_t>(C) * R * (In + GU);
  floats += backward ? (H + N * U + 2 * U) * R : (H + U) * R;
  if (resident) floats += static_cast<size_t>(H) * slice_ld(gates, static_cast<int>(U));
  const size_t bytes = sizeof(float) * floats;
  return bytes <= kMaxSmem ? bytes : 0;
}

// The clusters of N CTAs of `kernel` with `smem` bytes each that fit on the
// current device at once, asked of the runtime once per kernel and size; a
// negative value is minus a cudaError_t.  It first gives the kernel the
// attributes every tiling's launch needs (the most shared memory a block
// may use, clusters above 8 CTAs): set once for the largest size, they
// hold for every launch of the kernel.
template <typename... Params>
int active_clusters(void (*kernel)(Params...), int N, size_t smem) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMaxSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  static thread_local std::map<std::tuple<const void*, int, size_t>, int> known;
  const auto key = std::make_tuple(fn, N, smem);
  auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  known.emplace(key, clusters);
  return clusters;
}

// Launches `kernel` on clusters of N CTAs, `tiles` clusters a stack and L
// stacks, after checking that such a cluster fits the card; never on
// another tiling.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), int N, int tiles, int L, size_t smem,
                           cudaStream_t s, Args... args) {
  const int fits = active_clusters(kernel, N, smem);
  if (fits < 0) return static_cast<cudaError_t>(-fits);
  if (fits < 1) return cudaErrorLaunchOutOfResources;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(N * tiles, L);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
