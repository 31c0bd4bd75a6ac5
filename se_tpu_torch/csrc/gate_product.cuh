// The gate product of the probes P2 (wavefront_lstm.cu) and P3's dots-only
// mode (vpu_probe.cu), and of K2's and K3's wave design at the sub band
// (lstm_inproj.cu, gru_inproj.cu), for Hopper (sm_90a): acc = a . W over a tile of
// kTileRows batch rows, with W streamed through a shared-memory ring by
// cp.async.bulk and multicast across a thread-block cluster.  It is the
// product of the Pallas kernels of tools/wavefront_probe.py (:34-145, each
// step's x . W_ih + h . W_hh of both layers) and of tools/vpu_probe.py's
// dots-only kernel (main, :65-102), one routine for both, so that P3 reads
// what P2's product reaches alone.
//
// What bounds a gate product at the sub band's shape (Bb = 2056 rows, In =
// 32, H = 384, 4H = 1536 gate columns): a step's operations are 2 Bb (In +
// H) 4H = 2.6 GFLOP for layer 1 (P3's dots-only) and 2 Bb (2 H) 4H = 4.8
// GFLOP more for layer 2, 7.3 GFLOP for P2's iteration: 0.11 ms at the
// card's 67 TFLOP/s f32.  The weights are 2.56 MB (layer 1, with In padded
// to 32) and 4.72 MB (layer 2).  The first design read each weight
// from L2 for 4 rows, 2 FLOP a byte: ~593 GB through L2 in P2's 84 ms, ~220
// GB in P3's 22.7; L2, not the FMA pipes, bound them.
//
// Design.
//   - A CTA owns kTileRows = 16 rows, so each weight a CTA receives serves
//     16 rows (8 FLOP a byte), and the sub band's 2056 rows run in one wave
//     of 129 CTAs, one an SM.
//   - W is laid out by the caller in column slabs of kSlabRows rows k,
//     columns unit-major ([k][u][gate]: a unit's i, f, g and o adjacent),
//     so a slab is one contiguous run of bytes.  One thread of the
//     producer's warpgroup streams the slabs through a ring of `stages`
//     slabs by 1-D cp.async.bulk, completed on an mbarrier a stage
//     ("full"); no tensor map is needed.
//   - The N CTAs of a cluster (2 or 4) own N row tiles and need the same
//     slabs at the same time: CTA q copies the q-th N-th of each slab and
//     multicasts it to every CTA of the cluster, so L2 serves each slab
//     once a cluster: 129 / N x 163 x 7.27 MB for P2 (77 GB at N = 2).  A
//     stage is refilled only when every consumer warp of every CTA of the
//     cluster has released it: each warp arrives on the "empty" mbarrier of
//     each CTA (lanes 0 .. N-1, one CTA each).
//   - The products are f32 FFMA on register tiles (no TF32): a consumer
//     thread holds 8 rows x 2 units x 4 gates = 64 accumulators.  Per k it
//     loads its 8 rows of a (two float4s, the same for the 16 threads of its
//     row group: a broadcast) and its two units' gates (two float4s,
//     conflict-free: the 8 threads of a quarter warp read 32 consecutive
//     floats) for 64 FMAs.  The three consumer warpgroups take 160 registers
//     a thread by setmaxnreg from the producer's, which keeps 24.
//   - A thread's accumulators hold all four gates of its units, so the
//     LSTM cell runs straight from them and c stays in registers (P2).
// The sum of each gate runs over k in order in one FMA chain.  What bounds
// the design on the card (PERF.md §6): the issue of this loop's FFMAs and
// the ring's waits, not L2 (clusters of 1 CTA, tried once, ran like
// clusters of 2; they are not taken, as they never run in fewer waves).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lstm_common.cuh"

namespace {

constexpr int kTileRows = 16;      // rows a CTA
constexpr int kThreadRows = 8;     // rows a thread: two row groups a tile
constexpr int kUnitsPerWarp = 32;  // 16 lanes of a row group, two units each
constexpr int kSlabRows = 4;       // rows k of W a ring slab; a product takes slabs in pairs
constexpr int kMaxWarps = 12;      // consumer warps (three warpgroups): H at most 384
constexpr int kGateThreads = 32 * (kMaxWarps + 4);  // and the producer's warpgroup
// Registers a thread after setmaxnreg: the producer's warpgroup gives back
// all but 24, the consumers' take 160 (of the 128 each thread of 512 starts
// with; 3 x 160 + 24 warps' worth fit an SM quarter's 16384).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
constexpr int kMaxGateCluster = 4;
constexpr size_t kGateMaxSmem = 232448;  // shared memory a block can use (227 KB)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// This thread's arrival on `bar`, expecting `bytes` more of asynchronous copies.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// An arrival on the mbarrier at `bar`'s offset in CTA `cta` of the cluster,
// at the default (CTA) scope, as CUTLASS's consumer release: with
// .release.cluster ptxas puts a MEMBAR.ALL.GPU before each arrival, and
// every slab then waited on it (PERF.md).  The arrival only hands back a
// slab whose values the thread has already read.
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, unsigned cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" :: "r"(remote) : "memory");
}

// The register budgets of the two roles (every warp of a warpgroup together).
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
}

__device__ __forceinline__ void gate_cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The consumer warps' barrier (named barrier 1; the producer warp is not in it).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// `bytes` from global `src` to shared `dst` (16-byte aligned, a multiple of
// 16), completing on `bar`, multicast to the same offsets in each of the
// cluster's first n CTAs, each completing on its own mbarrier at bar's offset.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar, int n) {
  const uint16_t mask = static_cast<uint16_t>((1u << n) - 1);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// One float from global `src` to shared `dst`, asynchronously (cp.async);
// wait_copies() waits for all of this thread's.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The ring of W slabs: `stages` slabs of `slab` floats, a full and an empty
// mbarrier each; every CTA of the cluster walks the same sequence of slabs.
struct Ring {
  float* slabs;
  uint64_t* full;
  uint64_t* empty;
  int stages, slab, n, rank;
  int stage = 0;
  unsigned phase = 0;

  __device__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The shared memory of a CTA: the ring's slabs, `buf_floats` of the
// caller's, then the ring's 2 `stages` mbarriers.
__host__ __device__ constexpr size_t gate_smem_bytes(int stages, int slab, int buf_floats) {
  return sizeof(float) * (static_cast<size_t>(stages) * slab + buf_floats) +
         2 * sizeof(uint64_t) * stages;
}

// The ring over the start of dynamic shared memory; its barriers are set up
// by thread 0, made visible to the cluster, before any thread uses them.
__device__ __forceinline__ Ring make_ring(float* smem, int stages, int slab, int buf_floats,
                                          int consumer_warps) {
  Ring ring;
  ring.slabs = smem;
  ring.full = reinterpret_cast<uint64_t*>(smem + static_cast<size_t>(stages) * slab + buf_floats);
  ring.empty = ring.full + stages;
  ring.stages = stages;
  ring.slab = slab;
  ring.n = static_cast<int>(cooperative_groups::this_cluster().num_blocks());
  ring.rank = static_cast<int>(cooperative_groups::this_cluster().block_rank());
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], consumer_warps * ring.n);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  return ring;
}

// The producer (one thread a CTA): `count` slabs of w ([count][slab]
// floats), each into the next stage once the cluster has released it, this
// CTA's share multicast to the cluster.
__device__ __forceinline__ void produce(Ring& ring, const float* __restrict__ w, int count) {
  const unsigned bytes = static_cast<unsigned>(ring.slab * sizeof(float));
  const int share = ring.slab / ring.n;
  for (int j = 0; j < count; ++j) {
    mbar_wait(&ring.empty[ring.stage], ring.phase ^ 1u);
    mbar_expect_tx(&ring.full[ring.stage], bytes);
    bulk_copy(ring.slabs + static_cast<size_t>(ring.stage) * ring.slab + ring.rank * share,
              w + static_cast<size_t>(j) * ring.slab + ring.rank * share,
              static_cast<unsigned>(share * sizeof(float)), &ring.full[ring.stage], ring.n);
    ring.advance();
  }
}

// A consumer thread's place: rows r0 .. r0 + 7 of the tile, units ua and ua
// + 16 (its warp's 32 units are warp * 32 ..).
struct GateLane {
  int r0, ua, ub;
  __device__ GateLane() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    r0 = kThreadRows * (lane / 16);
    ua = warp * kUnitsPerWarp + lane % 16;
    ub = ua + 16;
  }
};

// acc[r][4 j + g] += sum over k < kSlabRows of a[k][r0 + r] * w[k][unit j's
// gate g]: one slab's products, k in order; a is [kSlabRows][kTileRows] in
// shared memory, w's rows `ld` floats.
__device__ __forceinline__ void slab_products(const float* a, const float* w, int ld,
                                              const GateLane& me,
                                              float (&acc)[kThreadRows][8]) {
#pragma unroll
  for (int kk = 0; kk < kSlabRows; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + kk * kTileRows + me.r0);
    const float4 a1 = *reinterpret_cast<const float4*>(a + kk * kTileRows + me.r0 + 4);
    const float4 wa = *reinterpret_cast<const float4*>(w + kk * ld + 4 * me.ua);
    const float4 wb = *reinterpret_cast<const float4*>(w + kk * ld + 4 * me.ub);
    const float av[kThreadRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], wv[c], acc[r][c]);
    }
  }
}

// The slab routine gate_product runs by default: slab_products.
struct GateSlabs {
  __device__ __forceinline__ void operator()(const float* a, const float* w, int ld,
                                             const GateLane& me,
                                             float (&acc)[kThreadRows][8]) const {
    slab_products(a, w, ld, me, acc);
  }
};

// The next kSlabs slabs of the ring, once arrived: their products into acc
// (a points at their rows of a_s; `products` runs one slab), then their
// release to the cluster.
template <int kSlabs, typename Products = GateSlabs>
__device__ __forceinline__ void take_slabs(Ring& ring, const float* a, int ld, const GateLane& me,
                                           bool active, float (&acc)[kThreadRows][8],
                                           Products products = Products()) {
  int s[kSlabs];
#pragma unroll
  for (int i = 0; i < kSlabs; ++i) {
    s[i] = ring.stage;
    mbar_wait(&ring.full[s[i]], ring.phase);
    ring.advance();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < kSlabs; ++i) {
      products(a + i * kSlabRows * kTileRows,
               ring.slabs + static_cast<size_t>(s[i]) * ring.slab, ld, me, acc);
    }
  }
  __syncwarp();
  const int lane = threadIdx.x % 32;
  if (lane < ring.n) {
#pragma unroll
    for (int i = 0; i < kSlabs; ++i) mbar_arrive_at(&ring.empty[s[i]], lane);
  }
}

// acc[r][4 j + g] += sum over k of a_s[k][r0 + r] * W[k][unit j's gate g]
// for the `count` slabs the ring brings next (k = 0 .. kSlabRows count - 1,
// in order); a_s is [K][kTileRows] in shared memory, W's rows 4 Hp floats
// (`ld`).  The slabs are taken two at a time, one wait for 8 rows k of
// straight-line code (one slab a wait ran slower on an H100, and so did
// loading a pair's first rows ahead of its wait, across the pairs: more
// registers, spills; PERF.md), and half the warps pair them one slab
// later than the others, mixed within each SM quarter, so that its warps
// do not all wait at once.  With `active` false the slabs are waited for and released
// without the products (a CTA without rows, or a P3 slot past the last
// step).  `products` runs one slab (default: slab_products; K3's backward
// passes its own for the dh product, csrc/gru_inproj.cu).
template <typename Products = GateSlabs>
__device__ __forceinline__ void gate_product(Ring& ring, const float* a_s, int count, int ld,
                                             const GateLane& me, bool active,
                                             float (&acc)[kThreadRows][8],
                                             Products products = Products()) {
  const int rows_a_slab = kSlabRows * kTileRows;
  int j = 0;
  const int warp = threadIdx.x / 32;  // an SM quarter runs warps q, q + 4, q + 8
  if ((warp + warp / 4) % 2 == 1 && count > 0) {
    take_slabs<1>(ring, a_s, ld, me, active, acc, products);
    j = 1;
  }
  for (; j + 2 <= count; j += 2) {
    take_slabs<2>(ring, a_s + j * rows_a_slab, ld, me, active, acc, products);
  }
  if (j < count) take_slabs<1>(ring, a_s + j * rows_a_slab, ld, me, active, acc, products);
}

// W [K, 4H] (gate-major columns g H + u) laid out by the caller as
// [K][4 Hp] unit-major (4 u + g, zero past H) is what gate_product reads;
// Hp = kUnitsPerWarp ceil(H / kUnitsPerWarp).
__host__ __device__ constexpr int padded_units(int H) {
  return (H + kUnitsPerWarp - 1) / kUnitsPerWarp * kUnitsPerWarp;
}

// The shared memory of a gate-product kernel's CTA (gate_smem_bytes), or 0
// unless (N, stages, In_p) is a tiling the kernels take: N = 2 or 4, a
// ring of 2 or more slabs within the block's shared memory, In_p = In
// rounded up to a pair of slabs, H at most 384.  The CTA's two operand
// buffers hold x's In_p rows and `h_blocks` blocks of Hp rows of h (P2: h1
// and h2; P3's dots-only: h), 16 columns each.
inline size_t gate_tiling_smem(int In, int H, int In_p, int N, int stages, int h_blocks) {
  if (N != 2 && N != kMaxGateCluster) return 0;
  if (H < 1 || padded_units(H) > kMaxWarps * kUnitsPerWarp || In < 1) return 0;
  if (In_p != (In + 2 * kSlabRows - 1) / (2 * kSlabRows) * 2 * kSlabRows || stages < 2) return 0;
  const int Hp = padded_units(H);
  const size_t bytes =
      gate_smem_bytes(stages, kSlabRows * 4 * Hp, 2 * (In_p + h_blocks * Hp) * kTileRows);
  return bytes <= kGateMaxSmem ? bytes : 0;
}

// The clusters of n CTAs of `kernel` with `smem` bytes and kGateThreads
// threads each that fit on the current device at once (minus a
// cudaError_t on an error); gives the kernel the shared memory first.
template <typename... Params>
int gate_active_clusters(void (*kernel)(Params...), int n, size_t smem) {
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kGateMaxSmem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(kGateThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return clusters;
}

constexpr int kWaveMaxStages = 8;  // ring slabs at most

// ---- The wave design of K2 and K3 (lstm_inproj.cu, gru_inproj.cu) ----------

// The shared memory of a wave-design CTA (gate_smem_bytes), or 0 unless
// (In_p, N, stages) is a tiling these kernels take: N = 2 or 4, In_p = In
// rounded up to a pair of slabs, H at most 384, a ring of 2 to 8 slabs
// within the block's shared memory.  Forward: two operand buffers [x; h]
// ([In_p + Hp][16] each); backward In_p + 5 Hp rows of 16: K3's buffer
// [x; h_prev; dys] (In_p + 2 Hp) and dhp (3 Hp), K2's buffer [x; h_prev]
// (In_p + Hp) and dgates (4 Hp; dys and the stash go to registers).
inline size_t wave_smem(bool backward, int In, int H, int In_p, int N, int stages) {
  if (N != 2 && N != kMaxGateCluster) return 0;
  if (H < 1 || padded_units(H) > kMaxWarps * kUnitsPerWarp || In < 1) return 0;
  if (In_p != (In + 2 * kSlabRows - 1) / (2 * kSlabRows) * 2 * kSlabRows) return 0;
  if (stages < 2 || stages > kWaveMaxStages) return 0;
  const int Hp = padded_units(H);
  const int buf = (backward ? In_p + 5 * Hp : 2 * (In_p + Hp)) * kTileRows;
  const size_t bytes = gate_smem_bytes(stages, kSlabRows * 4 * Hp, buf);
  return bytes <= kGateMaxSmem ? bytes : 0;
}

// dst[k][r] = src[r * ld + k] for r < rows, k < K (dst k-major, 16 columns):
// f32 by cp.async (waited for by wait_copies), bf16 loaded, widened and
// stored; the `count` threads from `first` share the elements.
template <typename TS>
__device__ __forceinline__ void stage_kmajor(float* dst, const TS* __restrict__ src, int rows,
                                             int K, int ld, int first, int count) {
  for (int i = threadIdx.x - first; i < rows * K; i += count) {
    const int r = i / K, k = i % K;
    if constexpr (kIsF32<TS>) {
      copy_async(dst + k * kTileRows + r, src + static_cast<size_t>(r) * ld + k);
    } else {
      dst[k * kTileRows + r] = to_f32(src[static_cast<size_t>(r) * ld + k]);
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[kThreadRows][8]) {
#pragma unroll
  for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  }
}

// A backward's dh product on the ring of W_hh^T: dh_prev[i] = sum over
// the gate-gradient rows k' = g Hp + j (K3: 3 Hp of dhp, K2: 4 Hp of
// dgates) of a[k'] W_hh[i][g H + j], the rows split into four parts of Q
// (K3: 3 Hp / 4; K2: Hp, a part a gate; part p: k' = p Q ..), laid out by
// the wrapper as wt [Q][Hp][4] (row kq, unit i, part p: W_hh^T[p Q +
// kq][i]).  A thread's 64 accumulators hold its 8 rows x 2 units x 4 parts,
// so each k of a slab serves the same 64 FMAs as the forward's product; the
// parts are summed in a fixed order after the last slab.  `part` is Q x
// 16, the floats between two parts of a [4 Q][16].
struct DhSlabs {
  int part;
  __device__ __forceinline__ void operator()(const float* a, const float* w, int ld,
                                             const GateLane& me,
                                             float (&acc)[kThreadRows][8]) const {
#pragma unroll
    for (int kk = 0; kk < kSlabRows; ++kk) {
      const float4 wa = *reinterpret_cast<const float4*>(w + kk * ld + 4 * me.ua);
      const float4 wb = *reinterpret_cast<const float4*>(w + kk * ld + 4 * me.ub);
      const float wv[2][4] = {{wa.x, wa.y, wa.z, wa.w}, {wb.x, wb.y, wb.z, wb.w}};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float* ap = a + p * part + kk * kTileRows + me.r0;
        const float4 a0 = *reinterpret_cast<const float4*>(ap);
        const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
        const float av[kThreadRows] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int r = 0; r < kThreadRows; ++r) {
          acc[r][p] = fmaf(av[r], wv[0][p], acc[r][p]);
          acc[r][4 + p] = fmaf(av[r], wv[1][p], acc[r][4 + p]);
        }
      }
    }
  }
};

// Launches `kernel` on `ctas` CTAs a stack (a multiple of n) for L stacks
// (gridDim.y), in clusters of n CTAs along x, kGateThreads threads and
// `smem` bytes each.
template <typename... Params, typename... Args>
cudaError_t launch_wave(void (*kernel)(Params...), int n, int ctas, int L, size_t smem,
                        cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kGateMaxSmem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(ctas, L);
  cfg.blockDim = dim3(kGateThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// CTAs a stack of the wave design: the 16-row tiles, rounded up to whole
// clusters of N.
inline int wave_ctas(int Bb, int N) {
  const int tiles = (Bb + kTileRows - 1) / kTileRows;
  return (tiles + N - 1) / N * N;
}

// Launches `kernel` on `ctas` CTAs (a multiple of n) in clusters of n, with
// kGateThreads threads and `smem` bytes each.
template <typename... Params, typename... Args>
cudaError_t launch_gate_clusters(void (*kernel)(Params...), int n, int ctas, size_t smem,
                                 cudaStream_t s, Args... args) {
  return launch_wave(kernel, n, ctas, 1, smem, s, args...);
}

}  // namespace
