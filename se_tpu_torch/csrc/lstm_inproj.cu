// LSTM scan with the input projection inside the kernel, forward and
// backward, for Hopper (sm_90a), in two designs: on thread-block clusters,
// or in waves of 16-row CTAs on the gate product of gate_product.cuh.
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
// Two designs; the planner in Python (se_tpu_torch/ops/fused_lstm_inproj.py
// ::plan) picks one per shape, the one measured faster there, and passes it
// to the entries below (one set per design), which never switch at run
// time.  The cluster design (lstm_cluster_{fwd,bwd}_kernel) runs CRN's,
// DCCRN's real LSTM's and the full band's few rows, the sub band at small
// batches and a stream's chunk; the wave design (lstm_wave_{fwd,bwd}_kernel,
// after the cluster design below) the sub band's many rows.
//
// The cluster design.  A cluster of N blocks (CTAs) owns a tile of R batch rows of one
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
// K3 (gru_inproj.cu); the kernels themselves are lstm_cluster.cuh's, shared
// with K1 (lstm_scan.cu), which runs them without the projection.
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
// The wave design (K3's at the sub band, gru_inproj.cu, on P2's gate
// product): a CTA owns 16 rows of one stack and all H (at most 384) units,
// so FullSubNet's sub band at B = 8 (Bb = 2056, In = 32 and 384, H = 384)
// runs in one wave of 129 CTAs, in clusters of 2 that share each W slab by
// multicast from a cp.async.bulk ring; f32 FFMA on 8 x 8 register tiles.
// The wrapper lays out (W_ih; W_hh) as [k][u][i, f, g, o]
// (fused_lstm_inproj.wave_layout), so a thread's 64 accumulators hold its
// 8 rows x 2 units x 4 gates and the cell runs straight from them, c in
// registers.  Each gate's sum runs over k in one chain, x then h, then the
// bias (within rounding of the cluster design, not its bits).  Rings: the
// forward's buffers [x; h] (two, In_p + Hp rows of 16 each) leave 7 slabs
// at the sub band's layer 0 and 5 at layer 1.  The backward recomputes the
// product per step, runs the cell backward from the stash (c_t, c_prev and
// dys read from memory into registers in the cell: they take no shared
// memory, so the ring keeps K3's 4 and 3 slabs beside [x; h_prev] and the
// step's dgates [4 Hp][16]), writes the dgates scratch, and adds dgates .
// W_hh^T from a second stretch of the same ring (DhSlabs, W_hh^T in four
// parts of Hp rows, a part a gate; fused_lstm_inproj.wave_transpose).  Its
// dx, dW and dbias passes are the cluster design's.
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
// The bf16 cell-state stash (pallas_lstm.py:32-41, the cs_dtype of
// _inproj_call, :432-434 and :473) is the storage type of cs alone: the
// forward rounds each stored c to bf16 (__float2bfloat16_rn, as the Pallas
// kernel's c.astype(cs_ref.dtype), :335) while its carry, hT and cT stay
// f32; the backward widens c_t and c_prev at t > 0 from it (:362, :377),
// c_prev at t = 0 coming from c0 in f32.  It halves the stash's bytes and
// is independent of the stream's type, so each form has a stash entry
// (se_lstm_inproj_{fwd,bwd}_{f32,bf16}_cs16) beside its f32-stash one.
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

#include "gate_product.cuh"
#include "lstm_cluster.cuh"

namespace {

template <int M, typename TS, typename TC>
cudaError_t launch_fwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
                       const float* h0, const float* c0, TS* ys, TC* cs, float* hT,
                       float* cT, int T, int L, int Bb, int In, int H, int R, int N, int C,
                       int resident, cudaStream_t s) {
  const size_t smem = tiling_smem(false, 4, R, N, C, resident, In, H);
  if (smem == 0) return cudaErrorInvalidValue;
  return launch_cluster(lstm_cluster_fwd_kernel<M, TS, true, TC>, N, (Bb + R - 1) / R, L, smem,
                        s, x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, R, N,
                        C, resident);
}

template <typename TS, typename TC>
int inproj_fwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
               const float* h0, const float* c0, TS* ys, TC* cs, float* hT, float* cT,
               int T, int L, int Bb, int In, int H, int R, int N, int C, int resident,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_fwd<kReal>(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L,
                                            Bb, In, H, R, N, C, resident,
                                            static_cast<cudaStream_t>(stream)));
}

// The backward's passes after the reverse scan, in both designs: dx =
// dgates . W_ih^T, dW_ih, dW_hh and dbias over the dgates scratch `dg`.
template <typename TS>
cudaError_t second_pass(const TS* x, const float* wih_t, const float* h0, const TS* ys, TS* dx,
                        float* dwih_t, float* dbias, float* dwhh_t, const float* dg, float* ws,
                        int T, int L, int Bb, int In, int H, int ws_floats, cudaStream_t s) {
  const int G = 4 * H;
  const size_t wsf = static_cast<size_t>(ws_floats);
  cudaError_t err = launch_dx(dg, wih_t, dx, T, L, Bb, In, G, s);
  if (err != cudaSuccess) return err;
  err = launch_dw(x, nullptr, dg, G, dwih_t, G, ws, wsf, T, L, Bb, In, G, 0, s);
  if (err != cudaSuccess) return err;
  err = launch_dw(ys, h0, dg, G, dwhh_t, G, ws, wsf, T, L, Bb, H, G, 1, s);
  if (err != cudaSuccess) return err;
  return launch_dbias(dg, G, dbias, G, ws, wsf, T, L, Bb, G, s);
}

template <typename TS, typename TC>
int inproj_bwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
               const float* whh, const float* h0, const float* c0, const TS* ys,
               const TC* cs, const TS* dys, const float* dhT, const float* dcT, TS* dx,
               float* dwih_t, float* dbias, float* dwhh_t, float* dh0, float* dc0, float* dg,
               float* ws, int T, int L, int Bb, int In, int H, int R, int N, int C,
               int resident, int ws_floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = tiling_smem(true, 4, R, N, C, resident, In, H);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  err = launch_cluster(lstm_cluster_bwd_kernel<TS, true, TC>, N, (Bb + R - 1) / R, L, smem, s, x,
                       wih_t, bias, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dh0, dc0, dg,
                       static_cast<TS*>(nullptr), T, L, Bb, In, H, R, N, C, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(second_pass(x, wih_t, h0, ys, dx, dwih_t, dbias, dwhh_t, dg, ws, T, L,
                                      Bb, In, H, ws_floats, s));
}

// ---- The wave design ------------------------------------------------------

// The forward's cell for the thread's 8 rows and 2 units, from the
// accumulated gates (i, f, g, o) plus the bias (pallas_lstm.py:327-335;
// cell_forward): c in place, h into the next buffer's h rows (h_s
// [Hp][16]), into ys and, where the caller passes it, c into the stash cs
// (rows past `rows` and units past H unwritten).
template <typename TS, typename TC>
__device__ __forceinline__ void lstm_wave_cell(const float (&acc)[kThreadRows][8],
                                               const float* __restrict__ bias,
                                               float (&c)[kThreadRows][2], float* h_s,
                                               TS* __restrict__ ys, TC* __restrict__ cs,
                                               const GateLane& me, int rows, int H) {
  const int units[2] = {me.ua, me.ub};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias) + units[j]);
    float h[kThreadRows];
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
      const float g4[4] = {acc[r][4 * j] + b.x, acc[r][4 * j + 1] + b.y,
                           acc[r][4 * j + 2] + b.z, acc[r][4 * j + 3] + b.w};
      c[r][j] = cell_forward(g4, 1, 0, c[r][j], &h[r]);
    }
    float* hs = h_s + units[j] * kTileRows + me.r0;
    *reinterpret_cast<float4*>(hs) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(hs + 4) = make_float4(h[4], h[5], h[6], h[7]);
    if (units[j] < H) {
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        if (me.r0 + r >= rows) continue;
        const size_t o = static_cast<size_t>(me.r0 + r) * H + units[j];
        store_as(ys + o, h[r]);
        if (cs != nullptr) store_as(cs + o, c[r][j]);
      }
    }
  }
}

// The forward (K2f) in the wave design:
//   x [T, L, Bb, In]; w [L][In_p + Hp][4 Hp] = (W_ih; W_hh) unit-major
//   (columns 4 u + gate, gates i, f, g, o; zero past In and H); bias
//   [L][4 Hp] (b_ih + b_hh, the same layout); h0, c0 [L, Bb, H] -> ys
//   [T, L, Bb, H], cs (the stash, if not null), hT, cT.
// A CTA owns 16 rows of one stack (blockIdx.y) and all its units; step t's
// product reads the buffer [x[t]; h] and the cell writes h into the other
// buffer, where x[t + 1] is copied meanwhile; one barrier of the consumer
// warps ends the step.  c stays in registers.
template <typename TS, typename TC>
__global__ void __launch_bounds__(kGateThreads, 1)
lstm_wave_fwd_kernel(const TS* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ h0,
                     const float* __restrict__ c0, TS* __restrict__ ys, TC* __restrict__ cs,
                     float* __restrict__ hT, float* __restrict__ cT, int T, int L, int Bb,
                     int In, int H, int In_p, int stages) {
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
  const size_t state0 = static_cast<size_t>(l) * Bb + b0;  // row of h0/c0/hT/cT
  const float* wl = w + static_cast<size_t>(l) * KB * ld;
  const float* bl = bias + static_cast<size_t>(l) * ld;
  auto at = [&](int t) { return (static_cast<size_t>(t) * L + l) * Bb + b0; };  // row of [T, L, Bb]

  // buffer 0: x[0] and h0; zeros elsewhere (padding, rows past the batch)
  for (int i = tid; i < 2 * KB * kTileRows; i += blockDim.x) buf[i] = 0.f;
  __syncthreads();
  stage_kmajor(buf, x + at(0) * In, rows, In, In, 0, blockDim.x);
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
    float c[kThreadRows][2];
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        c[r][j] = me.r0 + r < rows && units[j] < H
                      ? c0[(state0 + me.r0 + r) * H + units[j]] : 0.f;
      }
    }
    float acc[kThreadRows][8];
    for (int t = 0; t < T; ++t) {
      const float* cur = buf + static_cast<size_t>(t & 1) * KB * kTileRows;
      float* nxt = buf + static_cast<size_t>((t + 1) & 1) * KB * kTileRows;
      if (t + 1 < T) stage_kmajor(nxt, x + at(t + 1) * In, rows, In, In, 0, consumers);
      zero_acc(acc);
      gate_product(ring, cur, n1, ld, me, active, acc);
      lstm_wave_cell(acc, bl, c, nxt + In_p * kTileRows, ys + at(t) * H,
                     cs == nullptr ? cs : cs + at(t) * H, me, rows, H);
      wait_copies();
      consumers_sync(consumers);
    }
    // h of step T - 1 is in buffer T & 1 (this thread's own stores)
    const float* last = buf + (static_cast<size_t>(T & 1) * KB + In_p) * kTileRows;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (units[j] >= H) continue;
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        if (me.r0 + r >= rows) continue;
        const size_t o = (state0 + me.r0 + r) * H + units[j];
        hT[o] = last[units[j] * kTileRows + me.r0 + r];
        cT[o] = c[r][j];
      }
    }
  }
  __syncwarp();
  gate_cluster_sync();  // no CTA leaves while a peer may still copy into it or arrive on it
}

// The backward's reverse scan (K2b's first pass) in the wave design: the
// forward's w and bias, wt [L][Hp][4 Hp] (DhSlabs, a part a gate), h0, c0,
// ys, the stash cs (f32 or bf16, widened as read), dys, dhT and dcT -> dh0,
// dc0 and the dgates scratch dg [T, L, Bb, 4H], as the cluster design
// writes it.  Per step, in reverse: the product of [x[t]; h_prev] (h_prev =
// ys[t-1], or h0) recomputes the gates (the forward's product, the same
// slabs); the cell backward (cell_backward; pallas_lstm.py:373-386) from
// c_t, c_prev (cs[t-1], or c0) and dh = dys[t] + the dh carry, read into
// registers, and the dc carry writes dg and dgates into dg_s and leaves dc
// f in the dc carry; a barrier; step t-1's x and h_prev are copied into the
// one buffer while the dh product over the ring of W_hh^T makes the dh
// carry dgates . W_hh^T; a barrier ends the step.  The ring carries, each
// step, the forward's slabs then W_hh^T's.
template <typename TS, typename TC>
__global__ void __launch_bounds__(kGateThreads, 1)
lstm_wave_bwd_kernel(const TS* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ wt,
                     const float* __restrict__ h0, const float* __restrict__ c0,
                     const TS* __restrict__ ys, const TC* __restrict__ cs,
                     const TS* __restrict__ dys, const float* __restrict__ dhT,
                     const float* __restrict__ dcT, float* __restrict__ dh0,
                     float* __restrict__ dc0, float* __restrict__ dg, int T, int L, int Bb,
                     int In, int H, int In_p, int stages) {
  extern __shared__ __align__(16) float smem[];
  const int Hp = padded_units(H), ld = 4 * Hp, KB = In_p + Hp, G = 4 * H;
  const int warps = Hp / kUnitsPerWarp, consumers = 32 * warps;
  const int slab = kSlabRows * ld;
  Ring ring = make_ring(smem, stages, slab, (KB + 4 * Hp) * kTileRows, warps);
  float* buf = smem + static_cast<size_t>(stages) * slab;  // [KB][16]: x, h_prev
  float* dg_s = buf + static_cast<size_t>(KB) * kTileRows;  // [4 Hp][16]: dgates, gate-major
  const int l = blockIdx.y;
  const int b0 = blockIdx.x * kTileRows;
  const int rows = min(kTileRows, Bb - b0);
  const int tid = threadIdx.x, warp = tid / 32;
  const size_t state0 = static_cast<size_t>(l) * Bb + b0;  // row of h0/c0/dhT/dcT/dh0/dc0
  const size_t step = static_cast<size_t>(L) * Bb * H;      // cs[t] to cs[t-1]
  const float* wl = w + static_cast<size_t>(l) * KB * ld;
  const float* bl = bias + static_cast<size_t>(l) * ld;
  const float* wtl = wt + static_cast<size_t>(l) * Hp * ld;
  auto at = [&](int t) { return (static_cast<size_t>(t) * L + l) * Bb + b0; };  // row of [T, L, Bb]
  // step t's x and h_prev into the buffer (h_prev: ys[t-1], or h0)
  auto stage_step = [&](int t, int first, int count) {
    stage_kmajor(buf, x + at(t) * In, rows, In, In, first, count);
    if (t > 0) {
      stage_kmajor(buf + In_p * kTileRows, ys + at(t - 1) * H, rows, H, H, first, count);
    } else {
      stage_kmajor(buf + In_p * kTileRows, h0 + state0 * H, rows, H, H, first, count);
    }
  };

  for (int i = tid; i < (KB + 4 * Hp) * kTileRows; i += blockDim.x) buf[i] = 0.f;
  __syncthreads();
  stage_step(T - 1, 0, blockDim.x);
  wait_copies();
  gate_cluster_sync();

  const int n1 = KB / kSlabRows, n2 = Hp / kSlabRows;
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
    float dh[kThreadRows][2], dc[kThreadRows][2];
#pragma unroll
    for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool in = me.r0 + r < rows && units[j] < H;
        const size_t o = (state0 + me.r0 + r) * H + units[j];
        dh[r][j] = in ? dhT[o] : 0.f;
        dc[r][j] = in ? dcT[o] : 0.f;
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
          float d4[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = q + i, row = me.r0 + r;
            // rows past the batch and units past H see zero cotangents and
            // carries, so their dgates are 0 and add nothing to dh
            const bool in = row < rows && u < H;
            const size_t o = (at(t) + row) * H + u;
            const float c_prev = !in ? 0.f
                                 : t > 0 ? to_f32(cs[o - step]) : c0[(state0 + row) * H + u];
            const float c = in ? to_f32(cs[o]) : 0.f;
            const float dy = in ? to_f32(dys[o]) : 0.f;
            float g4[4] = {acc[r][4 * j] + b.x, acc[r][4 * j + 1] + b.y,
                           acc[r][4 * j + 2] + b.z, acc[r][4 * j + 3] + b.w};
            dc[r][j] = cell_backward(g4, g4, 1, 0, c_prev, c, dy + dh[r][j], dc[r][j]);
            if (in) {
              float* d = dg + (at(t) + row) * G + u;
#pragma unroll
              for (int g = 0; g < 4; ++g) d[g * H] = g4[g];
            }
#pragma unroll
            for (int g = 0; g < 4; ++g) d4[g][i] = g4[g];
          }
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            *reinterpret_cast<float4*>(dg_s + (g * Hp + u) * kTileRows + me.r0 + q) =
                make_float4(d4[g][0], d4[g][1], d4[g][2], d4[g][3]);
          }
        }
      }
      consumers_sync(consumers);  // the dgates complete; the buffer read by every warp
      if (t > 0) stage_step(t - 1, 0, consumers);
      zero_acc(acc);
      gate_product(ring, dg_s, n2, ld, me, active, acc, DhSlabs{Hp * kTileRows});
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          dh[r][j] = (acc[r][4 * j] + acc[r][4 * j + 1]) + (acc[r][4 * j + 2] + acc[r][4 * j + 3]);
        }
      }
      wait_copies();
      consumers_sync(consumers);  // step t-1's buffer in; the dgates free
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (units[j] >= H) continue;
#pragma unroll
      for (int r = 0; r < kThreadRows; ++r) {
        if (me.r0 + r >= rows) continue;
        const size_t o = (state0 + me.r0 + r) * H + units[j];
        dh0[o] = dh[r][j];
        dc0[o] = dc[r][j];
      }
    }
  }
  __syncwarp();
  gate_cluster_sync();
}

template <typename TS, typename TC>
int wave_fwd(const TS* x, const float* w, const float* bias, const float* h0, const float* c0,
             TS* ys, TC* cs, float* hT, float* cT, int T, int L, int Bb, int In, int H, int In_p,
             int N, int stages, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = wave_smem(false, In, H, In_p, N, stages);
  if (smem == 0 || T < 1 || Bb < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_wave(lstm_wave_fwd_kernel<TS, TC>, N, wave_ctas(Bb, N), L, smem,
                                      static_cast<cudaStream_t>(stream), x, w, bias, h0, c0, ys,
                                      cs, hT, cT, T, L, Bb, In, H, In_p, stages));
}

template <typename TS, typename TC>
int wave_bwd(const TS* x, const float* w, const float* bias, const float* wt, const float* h0,
             const float* c0, const TS* ys, const TC* cs, const TS* dys, const float* dhT,
             const float* dcT, const float* wih_t, TS* dx, float* dwih_t, float* dbias,
             float* dwhh_t, float* dh0, float* dc0, float* dg, float* ws, int T, int L, int Bb,
             int In, int H, int In_p, int N, int stages, int ws_floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = wave_smem(true, In, H, In_p, N, stages);
  if (smem == 0 || T < 1 || Bb < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch_wave(lstm_wave_bwd_kernel<TS, TC>, N, wave_ctas(Bb, N), L, smem, s, x, w, bias,
                    wt, h0, c0, ys, cs, dys, dhT, dcT, dh0, dc0, dg, T, L, Bb, In, H, In_p,
                    stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(second_pass(x, wih_t, h0, ys, dx, dwih_t, dbias, dwhh_t, dg, ws, T, L,
                                      Bb, In, H, ws_floats, s));
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

// The bf16-stash forwards: as se_lstm_inproj_fwd_f32 and _bf16, with the
// stash cs (not null) stored as bf16.
extern "C" int se_lstm_inproj_fwd_f32_cs16(const float* x, const float* wih_t,
                                           const float* bias, const float* whh_t,
                                           const float* h0, const float* c0,
                                           float* ys, __nv_bfloat16* cs, float* hT, float* cT,
                                           int T, int L, int Bb, int In, int H,
                                           int R, int N, int C, int resident,
                                           int device, void* stream) {
  return inproj_fwd(x, wih_t, bias, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, R, N, C,
                    resident, device, stream);
}

extern "C" int se_lstm_inproj_fwd_bf16_cs16(const __nv_bfloat16* x, const float* wih_t,
                                            const float* bias, const float* whh_t,
                                            const float* h0, const float* c0,
                                            __nv_bfloat16* ys, __nv_bfloat16* cs, float* hT,
                                            float* cT, int T, int L, int Bb, int In, int H,
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
  float* const no_cs = nullptr;  // no stash
  switch (mode) {
    case kReal: return launch_fwd<kReal>(x, wih_t, bias, whh_t, h0, c0, ys, no_cs, hT, cT, T, 1, Bb, In, H, R, N, C, resident, s);
    case kBf16Gates: return launch_fwd<kBf16Gates>(x, wih_t, bias, whh_t, h0, c0, ys, no_cs, hT, cT, T, 1, Bb, In, H, R, N, C, resident, s);
    case kPolySwap: return launch_fwd<kPolySwap>(x, wih_t, bias, whh_t, h0, c0, ys, no_cs, hT, cT, T, 1, Bb, In, H, R, N, C, resident, s);
    case kNoGates: return launch_fwd<kNoGates>(x, wih_t, bias, whh_t, h0, c0, ys, no_cs, hT, cT, T, 1, Bb, In, H, R, N, C, resident, s);
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

// The bf16-stash backwards: as se_lstm_inproj_bwd_f32 and _bf16, with the
// stash cs read as bf16.
extern "C" int se_lstm_inproj_bwd_f32_cs16(const float* x, const float* wih_t,
                                           const float* bias, const float* whh_t,
                                           const float* whh, const float* h0, const float* c0,
                                           const float* ys, const __nv_bfloat16* cs,
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

extern "C" int se_lstm_inproj_bwd_bf16_cs16(const __nv_bfloat16* x, const float* wih_t,
                                            const float* bias, const float* whh_t,
                                            const float* whh, const float* h0,
                                            const float* c0, const __nv_bfloat16* ys,
                                            const __nv_bfloat16* cs,
                                            const __nv_bfloat16* dys, const float* dhT,
                                            const float* dcT, __nv_bfloat16* dx,
                                            float* dwih_t, float* dbias, float* dwhh_t,
                                            float* dh0, float* dc0, float* dg, float* ws,
                                            int T, int L, int Bb, int In, int H,
                                            int R, int N, int C, int resident, int ws_floats,
                                            int device, void* stream) {
  return inproj_bwd(x, wih_t, bias, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dx, dwih_t,
                    dbias, dwhh_t, dh0, dc0, dg, ws, T, L, Bb, In, H, R, N, C, resident,
                    ws_floats, device, stream);
}

// Launches the forward scan in the wave design on `stream` of `device`:
// clusters of N (2 or 4) CTAs of 16 rows each, L stacks, a ring of
// `stages` slabs; w [L][In_p + Hp][4 Hp] and bias [L][4 Hp] laid out by
// the wrapper (lstm_wave_fwd_kernel); `cs` may be null, and then no stash
// is written.  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for a tiling the kernel does not take).
extern "C" int se_lstm_wave_fwd_f32(const float* x, const float* w, const float* bias,
                                    const float* h0, const float* c0, float* ys, float* cs,
                                    float* hT, float* cT, int T, int L, int Bb, int In, int H,
                                    int In_p, int N, int stages, int device, void* stream) {
  return wave_fwd(x, w, bias, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, In_p, N, stages, device,
                  stream);
}

// The bf16-stream forward in the wave design: x and ys bf16.
extern "C" int se_lstm_wave_fwd_bf16(const __nv_bfloat16* x, const float* w, const float* bias,
                                     const float* h0, const float* c0, __nv_bfloat16* ys,
                                     float* cs, float* hT, float* cT, int T, int L, int Bb,
                                     int In, int H, int In_p, int N, int stages, int device,
                                     void* stream) {
  return wave_fwd(x, w, bias, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, In_p, N, stages, device,
                  stream);
}

// The bf16-stash forwards in the wave design: the stash cs (not null) bf16.
extern "C" int se_lstm_wave_fwd_f32_cs16(const float* x, const float* w, const float* bias,
                                         const float* h0, const float* c0, float* ys,
                                         __nv_bfloat16* cs, float* hT, float* cT, int T, int L,
                                         int Bb, int In, int H, int In_p, int N, int stages,
                                         int device, void* stream) {
  return wave_fwd(x, w, bias, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, In_p, N, stages, device,
                  stream);
}

extern "C" int se_lstm_wave_fwd_bf16_cs16(const __nv_bfloat16* x, const float* w,
                                          const float* bias, const float* h0, const float* c0,
                                          __nv_bfloat16* ys, __nv_bfloat16* cs, float* hT,
                                          float* cT, int T, int L, int Bb, int In, int H,
                                          int In_p, int N, int stages, int device,
                                          void* stream) {
  return wave_fwd(x, w, bias, h0, c0, ys, cs, hT, cT, T, L, Bb, In, H, In_p, N, stages, device,
                  stream);
}

// Launches the backward in the wave design: the reverse scan
// (lstm_wave_bwd_kernel; wt [L][Hp][4 Hp] laid out by the wrapper), then
// the second pass as se_lstm_inproj_bwd_f32's (wih_t [L, In, 4H] for dx),
// all on `stream`.  Returns the first cudaError_t.
extern "C" int se_lstm_wave_bwd_f32(const float* x, const float* w, const float* bias,
                                    const float* wt, const float* h0, const float* c0,
                                    const float* ys, const float* cs, const float* dys,
                                    const float* dhT, const float* dcT, const float* wih_t,
                                    float* dx, float* dwih_t, float* dbias, float* dwhh_t,
                                    float* dh0, float* dc0, float* dg, float* ws, int T, int L,
                                    int Bb, int In, int H, int In_p, int N, int stages,
                                    int ws_floats, int device, void* stream) {
  return wave_bwd(x, w, bias, wt, h0, c0, ys, cs, dys, dhT, dcT, wih_t, dx, dwih_t, dbias,
                  dwhh_t, dh0, dc0, dg, ws, T, L, Bb, In, H, In_p, N, stages, ws_floats, device,
                  stream);
}

// The bf16-stream backward in the wave design: x, ys, dys and dx bf16.
extern "C" int se_lstm_wave_bwd_bf16(const __nv_bfloat16* x, const float* w, const float* bias,
                                     const float* wt, const float* h0, const float* c0,
                                     const __nv_bfloat16* ys, const float* cs,
                                     const __nv_bfloat16* dys, const float* dhT,
                                     const float* dcT, const float* wih_t, __nv_bfloat16* dx,
                                     float* dwih_t, float* dbias, float* dwhh_t, float* dh0,
                                     float* dc0, float* dg, float* ws, int T, int L, int Bb,
                                     int In, int H, int In_p, int N, int stages, int ws_floats,
                                     int device, void* stream) {
  return wave_bwd(x, w, bias, wt, h0, c0, ys, cs, dys, dhT, dcT, wih_t, dx, dwih_t, dbias,
                  dwhh_t, dh0, dc0, dg, ws, T, L, Bb, In, H, In_p, N, stages, ws_floats, device,
                  stream);
}

// The bf16-stash backwards in the wave design: the stash cs read as bf16.
extern "C" int se_lstm_wave_bwd_f32_cs16(const float* x, const float* w, const float* bias,
                                         const float* wt, const float* h0, const float* c0,
                                         const float* ys, const __nv_bfloat16* cs,
                                         const float* dys, const float* dhT, const float* dcT,
                                         const float* wih_t, float* dx, float* dwih_t,
                                         float* dbias, float* dwhh_t, float* dh0, float* dc0,
                                         float* dg, float* ws, int T, int L, int Bb, int In,
                                         int H, int In_p, int N, int stages, int ws_floats,
                                         int device, void* stream) {
  return wave_bwd(x, w, bias, wt, h0, c0, ys, cs, dys, dhT, dcT, wih_t, dx, dwih_t, dbias,
                  dwhh_t, dh0, dc0, dg, ws, T, L, Bb, In, H, In_p, N, stages, ws_floats, device,
                  stream);
}

extern "C" int se_lstm_wave_bwd_bf16_cs16(const __nv_bfloat16* x, const float* w,
                                          const float* bias, const float* wt, const float* h0,
                                          const float* c0, const __nv_bfloat16* ys,
                                          const __nv_bfloat16* cs, const __nv_bfloat16* dys,
                                          const float* dhT, const float* dcT,
                                          const float* wih_t, __nv_bfloat16* dx, float* dwih_t,
                                          float* dbias, float* dwhh_t, float* dh0, float* dc0,
                                          float* dg, float* ws, int T, int L, int Bb, int In,
                                          int H, int In_p, int N, int stages, int ws_floats,
                                          int device, void* stream) {
  return wave_bwd(x, w, bias, wt, h0, c0, ys, cs, dys, dhT, dcT, wih_t, dx, dwih_t, dbias,
                  dwhh_t, dh0, dc0, dg, ws, T, L, Bb, In, H, In_p, N, stages, ws_floats, device,
                  stream);
}

// How many clusters of N CTAs of the f32 wave kernel (forward, or with
// backward = 1 the reverse scan) with a ring of `stages` slabs fit on
// `device` at once; minus a cudaError_t on an error (cudaErrorInvalidValue:
// a tiling the kernels do not take).
extern "C" int se_lstm_wave_active_clusters(int backward, int In, int H, int In_p, int N,
                                            int stages, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = wave_smem(backward != 0, In, H, In_p, N, stages);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return backward ? gate_active_clusters(lstm_wave_bwd_kernel<float, float>, N, smem)
                  : gate_active_clusters(lstm_wave_fwd_kernel<float, float>, N, smem);
}
