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

template <typename TS, typename TC>
int inproj_bwd(const TS* x, const float* wih_t, const float* bias, const float* whh_t,
               const float* whh, const float* h0, const float* c0, const TS* ys,
               const TC* cs, const TS* dys, const float* dhT, const float* dcT, TS* dx,
               float* dwih_t, float* dbias, float* dwhh_t, float* dh0, float* dc0, float* dg,
               float* ws, int T, int L, int Bb, int In, int H, int R, int N, int C,
               int resident, int ws_floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = tiling_smem(true, 4, R, N, C, resident, In, H);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  err = launch_cluster(lstm_cluster_bwd_kernel<TS, true, TC>, N, (Bb + R - 1) / R, L, smem, s, x,
                       wih_t, bias, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dh0, dc0, dg,
                       static_cast<TS*>(nullptr), T, L, Bb, In, H, R, N, C, resident);
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
