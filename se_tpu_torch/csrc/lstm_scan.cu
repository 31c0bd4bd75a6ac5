// Fused LSTM-stack scan, forward and backward, for Hopper (sm_90a): K1.
//
// Replaces the Pallas kernels of `fused_lstm_scan` in
// se_tpu/ops/pallas_lstm.py: the forward (_fwd_kernel and _fwd_call,
// :56-87 and :158-196) and the backward (_bwd_kernel and _fused_bwd,
// :90-155 and :217-262).  One launch runs L independent LSTMs over T steps:
//
//   x_proj [T, L, Bb, 4H] f32 (input projection with both biases folded in)
//   w_hh_t [L, H, 4H]     f32 (recurrent weights, transposed)
//   h0, c0 [L, Bb, H]     f32
//   gates = x_proj[t] + h @ w_hh_t[l]   (gate order i, f, g, o)
//   c = f * c + i * g ;  h = o * tanh(c)
//   -> ys [T, L, Bb, H], hT, cT [L, Bb, H], all f32, and, when the caller
//      passes a buffer for it (training), the cell-state stash cs [T, L, Bb, H].
//
// The backward takes (x_proj, w_hh_t, h0, c0, ys, cs) and the cotangents
// (dys, dhT, dcT) and gives dx_proj [T, L, Bb, 4H] (= dgates), dw_hh_t
// [L, H, 4H], dh0 and dc0.  It recomputes the gates from (x_proj, h_prev)
// instead of stashing them, as the Pallas kernel does.
//
// What bounds them.  On DCCRN's main path (L=2, H=128, Bb=2B, T=483) the
// forward moves ~40 MB and does ~2 GFLOP at B=8; the backward at B=10
// moves ~110 MB and does ~7.6 GFLOP (three [Bb,H]x[H,4H] products a step:
// the recompute, dh and dW).  Both floors are a fraction of a millisecond
// at 67 TFLOP/s f32 and 3.35 TB/s.  The real limit is the chain of T
// dependent steps: each step needs the whole previous h (or dh), so a step
// costs one FMA chain over H, the cell update and an exchange of h (dh)
// among the blocks that share the stack.  The first design, one block per
// (stack, 4 rows), read W_hh[l] (128 x 512 f32 = 256 KiB, more than a
// block's shared memory) from L2 every step through one SM: 7.2 us a step
// forward, ~15 backward.
//
// Design.  K1 is K2 without the input projection: it runs the LSTM kernels
// on thread-block clusters of lstm_cluster.cuh (K2's, described at the top
// of lstm_inproj.cu) with kProj = false.  A cluster of N CTAs owns a tile
// of R rows of one stack; CTA q owns U = ceil(H / N) units and their four
// gate columns and keeps its W_hh slice in shared memory for all T steps
// (at H = 128 and N = 8, 34 KiB), stages its own gate columns of x_proj
// eight steps at a time (load_chunk), and trades h (forward) or its partial
// dh (backward, each unit's N partials summed in rank order) with its
// peers through distributed shared memory between cluster barriers; the
// reverse scan loads each step's cell operands and the next step's h_prev
// while the step computes.  One launch runs all L stacks.  Each gate is one
// FMA chain over k in order from 0, then + x_proj, and the cell update is
// the first design's (cell_k1 in lstm_cluster.cuh), so the forward keeps
// that design's bits; the backward's dh sums do not (rank order).  The
// tiling comes from ops/fused_lstm.py::plan, measured at DCCRN's shapes.
// dW_hh is summed over all T * Bb rows by lstm_dw_kernel (lstm_common.cuh,
// rows split into fixed-order partials), so two calls give the same bits
// (no atomics).
//
// The bf16-stream form (pallas_lstm.py:13-14; the kernels' :69, :86, :133)
// takes x_proj, and gives ys, as bf16, and in the backward takes ys and
// dys as bf16 and gives dx_proj as bf16: each value is converted at its
// load or store (to_f32, store_as), so the carry, the gates, the stash cs
// and every sum stay f32, and the f32 form compiles as if the type were
// fixed.  The carry h stays f32 from step to step; only its copy in ys is
// rounded.  The backward recomputes the gates from the rounded ys[t-1], as
// the Pallas backward does (:105).  Its dW_hh sums the f32 dgates
// (:144-153), so the bf16 form writes them to an f32 scratch buffer [T, L,
// Bb, 4H] that lstm_dw_kernel reads, and writes dx_proj rounded beside it;
// the f32 form reads dx_proj itself.

#include "lstm_cluster.cuh"

namespace {

template <typename TS>
int scan_fwd(const TS* xp, const float* whh_t, const float* h0, const float* c0, TS* ys,
             float* cs, float* hT, float* cT, int T, int L, int Bb, int H, int R, int N, int C,
             int resident, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = tiling_smem(false, 4, R, N, C, resident, 0, H);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* none = nullptr;  // no W_ih, no bias: x_proj has them folded in
  return static_cast<int>(launch_cluster(lstm_cluster_fwd_kernel<kReal, TS, false>, N,
                                         (Bb + R - 1) / R, L, smem,
                                         static_cast<cudaStream_t>(stream), xp, none, none,
                                         whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, 0, H, R, N, C,
                                         resident));
}

// The reverse scan, then the dW_hh reduction over the f32 dgates `dg`
// (dx_proj itself in the f32 form; the bf16 form also writes them rounded
// to dxp).
template <typename TS>
int scan_bwd(const TS* xp, const float* whh_t, const float* whh, const float* h0,
             const float* c0, const TS* ys, const float* cs, const TS* dys, const float* dhT,
             const float* dcT, float* dg, TS* dxp, float* dwhh_t, float* dh0, float* dc0,
             float* ws, int T, int L, int Bb, int H, int R, int N, int C, int resident,
             int ws_floats, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = 4 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = tiling_smem(true, 4, R, N, C, resident, 0, H);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* none = nullptr;
  err = launch_cluster(lstm_cluster_bwd_kernel<TS, false>, N, (Bb + R - 1) / R, L, smem, s, xp,
                       none, none, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dh0, dc0, dg, dxp,
                       T, L, Bb, 0, H, R, N, C, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_dw(ys, h0, dg, G, dwhh_t, G, ws, static_cast<size_t>(ws_floats),
                                    T, L, Bb, H, G, 1, s));
}

}  // namespace

// Launches the forward scan on `stream` (a cudaStream_t) of `device`, on
// the planner's tiling (ops/fused_lstm.py::plan): R rows a cluster, N CTAs
// a cluster, chunks of C steps (1 to 8), the W_hh slice resident in shared
// memory (resident = 1) or read from L2.  Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for a tiling these kernels
// do not take or whose buffers do not fit a block's shared memory,
// cudaErrorLaunchOutOfResources when no such cluster fits the card).  All
// pointers are device pointers to contiguous f32 arrays of the shapes
// above; `cs` may be null, and then no stash is written.
extern "C" int se_lstm_scan_fwd_f32(const float* xp, const float* whh_t,
                                    const float* h0, const float* c0,
                                    float* ys, float* cs, float* hT, float* cT,
                                    int T, int L, int Bb, int H,
                                    int R, int N, int C, int resident,
                                    int device, void* stream) {
  return scan_fwd(xp, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, H, R, N, C, resident, device,
                  stream);
}

// The bf16-stream forward: xp and ys bf16, the rest as se_lstm_scan_fwd_f32.
extern "C" int se_lstm_scan_fwd_bf16(const __nv_bfloat16* xp, const float* whh_t,
                                     const float* h0, const float* c0,
                                     __nv_bfloat16* ys, float* cs, float* hT, float* cT,
                                     int T, int L, int Bb, int H,
                                     int R, int N, int C, int resident,
                                     int device, void* stream) {
  return scan_fwd(xp, whh_t, h0, c0, ys, cs, hT, cT, T, L, Bb, H, R, N, C, resident, device,
                  stream);
}

// Launches the backward: the reverse scan (dx_proj, dh0, dc0) on the
// planner's tiling (as the forward's entry; w_hh [L, 4H, H] is w_hh_t's
// transpose, read only where the slice is not resident: a resident tiling
// takes any pointer there), then the dW_hh reduction that reads its
// dx_proj, its rows split over the workspace `ws` (ws_floats floats;
// lstm_common.cuh), all on `stream`.  Returns the first cudaError_t (0 on
// success; otherwise as for the forward).  Shapes as above; every pointer
// is a device pointer to a contiguous f32 array, none may be null.
extern "C" int se_lstm_scan_bwd_f32(const float* xp, const float* whh_t, const float* whh,
                                    const float* h0, const float* c0,
                                    const float* ys, const float* cs,
                                    const float* dys, const float* dhT,
                                    const float* dcT, float* dxp, float* dwhh_t,
                                    float* dh0, float* dc0, float* ws,
                                    int T, int L, int Bb, int H,
                                    int R, int N, int C, int resident,
                                    int ws_floats, int device, void* stream) {
  return scan_bwd(xp, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dxp,
                  static_cast<float*>(nullptr), dwhh_t, dh0, dc0, ws, T, L, Bb, H, R, N, C,
                  resident, ws_floats, device, stream);
}

// The bf16-stream backward: xp, ys, dys and dxp bf16, the rest f32 as in
// se_lstm_scan_bwd_f32, and `dg` an f32 scratch buffer [T, L, Bb, 4H] for
// the dgates that the dW_hh reduction sums.
extern "C" int se_lstm_scan_bwd_bf16(const __nv_bfloat16* xp, const float* whh_t,
                                     const float* whh, const float* h0, const float* c0,
                                     const __nv_bfloat16* ys, const float* cs,
                                     const __nv_bfloat16* dys, const float* dhT,
                                     const float* dcT, __nv_bfloat16* dxp, float* dwhh_t,
                                     float* dh0, float* dc0, float* dg, float* ws,
                                     int T, int L, int Bb, int H,
                                     int R, int N, int C, int resident,
                                     int ws_floats, int device, void* stream) {
  return scan_bwd(xp, whh_t, whh, h0, c0, ys, cs, dys, dhT, dcT, dg, dxp, dwhh_t, dh0, dc0, ws,
                  T, L, Bb, H, R, N, C, resident, ws_floats, device, stream);
}

// How many clusters of the f32 kernel (forward, or with backward = 1 the
// reverse scan) on the planner's tiling fit on `device` at once; 0 if none
// does, minus a cudaError_t on an error (cudaErrorInvalidValue: a tiling
// these kernels do not take).
extern "C" int se_lstm_scan_active_clusters(int backward, int H, int R, int N, int C,
                                            int resident, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = tiling_smem(backward != 0, 4, R, N, C, resident, 0, H);
  if (smem == 0) return -static_cast<int>(cudaErrorInvalidValue);
  return backward ? active_clusters(lstm_cluster_bwd_kernel<float, false>, N, smem)
                  : active_clusters(lstm_cluster_fwd_kernel<kReal, float, false>, N, smem);
}
