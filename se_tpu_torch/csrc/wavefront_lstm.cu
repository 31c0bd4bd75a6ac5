// Two stacked LSTM layers in one kernel, run as a wavefront, for Hopper
// (sm_90a): the wavefront probe (P2).
//
// Replaces the Pallas kernel of tools/wavefront_probe.py
// (_wavefront_fwd_kernel and wavefront_lstm2, :34-145).  It asks whether
// running layer 2 one step behind layer 1 in the same kernel hides the
// latency of a step of the recurrence, against two in-projection scans
// (K2, lstm_inproj.cu) one after the other:
//
//   x [T, Bb, In]  w_ih1 [In, 4H]  b1 [4H]  w_hh1 [H, 4H]
//                  w_ih2 [H, 4H]   b2 [4H]  w_hh2 [H, 4H]
//   h0, c0 [2, Bb, H] (layer 1, then layer 2), all f32
//   layer 1: gates = (x[t] . w_ih1 + h1 . w_hh1) + b1 ; layer 2 the same of
//   y1[t] with its own weights; gate order i, f, g, o
//   -> ys2, ys1 [T, Bb, H], hT, cT [2, Bb, H]
//
// Design.  K2's first one (PRs 3-7: one block per tile of rows, W from L2
// every step), with both layers in one block per tile of kRows rows and
// T + 1 iterations.  Iteration t:
//   0. at the start of a chunk of C steps, layer 1's input projections of
//      the chunk, in one pass over W_ih1 (stage_chunk, project_chunk);
//   1. over the gate columns: layer 1's gates of step t (recurrent_columns)
//      and layer 2's of step t - 1, whose input y1[t-1] is layer 1's carried
//      h (dot_column over W_ih2, then recurrent_columns over W_hh2);
//   2. after one barrier, both cell updates (cell_forward).
// Layer 1 idles at t = T and layer 2 at t = 0.  Each gate is the same sum
// in the same order as K2's (the cluster design kept that order), so the
// result equals two K2 calls bit for bit.  What bounds it is what bounded
// K2's first design: a step of either layer reads its W_hh (and layer 2
// its W_ih2) from L2 through one SM.

#include "lstm_common.cuh"

namespace {

constexpr int kMaxThreads = 512;     // block size cap; threads loop over columns
constexpr size_t kMaxSmem = 232448;  // shared memory a block can use (227 KB)

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
wavefront_lstm2_kernel(const float* __restrict__ x,
                       const float* __restrict__ wih1,
                       const float* __restrict__ b1,
                       const float* __restrict__ whh1,
                       const float* __restrict__ wih2,
                       const float* __restrict__ b2,
                       const float* __restrict__ whh2,
                       const float* __restrict__ h0,
                       const float* __restrict__ c0,
                       float* __restrict__ ys2,
                       float* __restrict__ ys1,
                       float* __restrict__ hT,
                       float* __restrict__ cT,
                       int T, int Bb, int In, int H) {
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  float* xc_s = reinterpret_cast<float*>(smem4);  // [C][In][kRows]  layer 1's chunk of x
  float* p_s = xc_s + C * In * kRows;             // [C][kRows][G]   layer 1's gates
  float* g2_s = p_s + C * kRows * G;              // [kRows][G]      layer 2's gates
  float* h_s = g2_s + kRows * G;                  // [2][H][kRows]   h1 (= y1), h2
  float* c_s = h_s + 2 * H * kRows;               // [2][kRows][H]   c1, c2

  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, Bb - b0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  float* h1_s = h_s;
  float* h2_s = h_s + H * kRows;

  // carries in; rows past the batch edge stay zero and are never written
  for (int idx = tid; idx < 2 * kRows * H; idx += nthr) {
    const int layer = idx / (kRows * H), r = (idx / H) % kRows, j = idx % H;
    float hv = 0.f, cv = 0.f;
    if (r < rows) {
      const size_t o = (static_cast<size_t>(layer) * Bb + b0 + r) * H + j;
      hv = h0[o];
      cv = c0[o];
    }
    h_s[(layer * H + j) * kRows + r] = hv;
    c_s[(layer * kRows + r) * H + j] = cv;
  }

  for (int t = 0; t <= T; ++t) {
    const int c = t % C;
    if (t < T && c == 0) {  // phase 0: layer 1's projections of the chunk
      stage_chunk<kRows, C>(xc_s, x, t, min(C, T - t), 1, Bb, 0, b0, rows, In);
      __syncthreads();
      project_chunk<kRows, C, false>(wih1, nullptr, xc_s, p_s, In, G);
      __syncthreads();
    }
    float* g1_s = p_s + c * kRows * G;

    // phase 1: layer 1's gates of step t, layer 2's of step t - 1
    if (t < T) recurrent_columns(whh1, b1, h1_s, g1_s, rows, H, G);
    if (t > 0) {
      for (int col = tid; col < G; col += nthr) {
        float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
        dot_column(wih2, h1_s, H, G, col, acc);
#pragma unroll
        for (int r = 0; r < kRows; ++r) g2_s[r * G + col] = acc[r];
      }
      recurrent_columns(whh2, b2, h2_s, g2_s, rows, H, G);  // same columns per thread
    }
    __syncthreads();

    // phase 2: both cell updates, for (layer, row r, unit j)
    for (int idx = tid; idx < 2 * rows * H; idx += nthr) {
      const int layer = idx / (rows * H), r = (idx / H) % rows, j = idx % H;
      if (layer == 0 ? t == T : t == 0) continue;
      const float* g = layer == 0 ? g1_s + r * G : g2_s + r * G;
      float* cv = c_s + (layer * kRows + r) * H + j;
      float h;
      *cv = cell_forward(g, H, j, *cv, &h);
      h_s[(layer * H + j) * kRows + r] = h;
      float* ys = layer == 0 ? ys1 + static_cast<size_t>(t) * Bb * H
                             : ys2 + static_cast<size_t>(t - 1) * Bb * H;
      ys[static_cast<size_t>(b0 + r) * H + j] = h;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < 2 * rows * H; idx += nthr) {
    const int layer = idx / (rows * H), r = (idx / H) % rows, j = idx % H;
    const size_t o = (static_cast<size_t>(layer) * Bb + b0 + r) * H + j;
    hT[o] = h_s[(layer * H + j) * kRows + r];
    cT[o] = c_s[(layer * kRows + r) * H + j];
  }
}

size_t smem_bytes(int C, int In, int H) {
  const size_t G = 4 * static_cast<size_t>(H);
  return sizeof(float) * (static_cast<size_t>(C) * kRows * (In + G) + kRows * G +
                          4 * static_cast<size_t>(H) * kRows);
}

template <int C>
cudaError_t launch(const float* x, const float* wih1, const float* b1, const float* whh1,
                   const float* wih2, const float* b2, const float* whh2, const float* h0,
                   const float* c0, float* ys2, float* ys1, float* hT, float* cT, int T,
                   int Bb, int In, int H, cudaStream_t s) {
  const size_t smem = smem_bytes(C, In, H);
  cudaError_t err = allow_smem(wavefront_lstm2_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  const int threads = ((4 * H < kMaxThreads ? 4 * H : kMaxThreads) + 31) / 32 * 32;
  wavefront_lstm2_kernel<C><<<(Bb + kRows - 1) / kRows, threads, smem, s>>>(
      x, wih1, b1, whh1, wih2, b2, whh2, h0, c0, ys2, ys1, hT, cT, T, Bb, In, H);
  return cudaGetLastError();
}

}  // namespace

// Launches the wavefront scan on `stream` of `device`: chunks of 8 steps of
// layer 1's projections where they fit a block's shared memory, else 4.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue when four
// steps' buffers do not fit).  Every pointer is a device pointer to a
// contiguous f32 array of the shapes above.
extern "C" int se_wavefront_lstm2_f32(const float* x, const float* wih1, const float* b1,
                                      const float* whh1, const float* wih2, const float* b2,
                                      const float* whh2, const float* h0, const float* c0,
                                      float* ys2, float* ys1, float* hT, float* cT,
                                      int T, int Bb, int In, int H, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes(8, In, H) <= kMaxSmem) {
    err = launch<8>(x, wih1, b1, whh1, wih2, b2, whh2, h0, c0, ys2, ys1, hT, cT, T, Bb, In, H, s);
  } else if (smem_bytes(4, In, H) <= kMaxSmem) {
    err = launch<4>(x, wih1, b1, whh1, wih2, b2, whh2, h0, c0, ys2, ys1, hT, cT, T, Bb, In, H, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
