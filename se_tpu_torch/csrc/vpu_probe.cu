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
//   dots-only:  x . w_ih + h . w_hh -> [BB, 4H]
//
// The result equals the op applied once to the tile.  Each op is the code
// the scans run: sigmoid_f32, tanhf and expf without fast-math,
// cell_forward and dot_column of lstm_common.cuh.
//
// Design.  The work of every step is really done:
//   - elementwise ops: one thread per element of the tile, blocks over the
//     elements and over `groups` groups of steps; step s reads its input at
//     an offset of s * stride floats, and keeps its value as fmaf(kept,
//     stride, value).  The caller passes stride = 0, so every step reads
//     the tile (from L1) and the kept value is the last one; as stride is
//     not known when compiling, no step's loads or math can be hoisted out
//     of the loop or dropped;
//   - dots-only: one block per (kRows rows, step), as a scan step forms its
//     gates (the rows in shared memory, W from L2 through dot_column); every
//     step's blocks write the same values.
// What bounds them: the elementwise ops, the SFU's rate of transcendental
// instructions (or the FP32 pipe's, for the instruction sequences of
// expf and tanhf); dots-only, the FP32 FMA rate, and at kRows rows a block
// the L2 reads of W.

#include "lstm_common.cuh"

namespace {

enum Op : int { kSigmoid = 0, kTanh = 1, kSigmoidTanh = 2, kExp = 3, kGates = 4, kDots = 5 };

constexpr int kThreads = 256;      // elementwise ops
constexpr int kDotThreads = 512;   // dots-only: threads loop over columns

template <int O>
__global__ void __launch_bounds__(O == kDots ? kDotThreads : kThreads)
vpu_probe_kernel(const float* __restrict__ g, const float* __restrict__ c,
                 const float* __restrict__ x, const float* __restrict__ h,
                 const float* __restrict__ wih, const float* __restrict__ whh,
                 float* __restrict__ out, int BB, int H, int In, int steps, int stride) {
  const int G = 4 * H;
  if constexpr (O == kDots) {
    __shared__ __align__(16) float xh_s[2 * 512 * kRows];  // x rows [In][kRows], h rows [H][kRows]
    float* x_s = xh_s;
    float* h_s = xh_s + In * kRows;
    const int b0 = blockIdx.x * kRows;
    const int rows = min(kRows, BB - b0);
    stage_rows<kRows>(x_s, x + static_cast<size_t>(b0) * In, rows, In);
    stage_rows<kRows>(h_s, h + static_cast<size_t>(b0) * H, rows, H);
    __syncthreads();
    for (int col = threadIdx.x; col < G; col += blockDim.x) {
      float ax[kRows] = {0.f, 0.f, 0.f, 0.f};
      float ah[kRows] = {0.f, 0.f, 0.f, 0.f};
      dot_column(wih, x_s, In, G, col, ax);
      dot_column(whh, h_s, H, G, col, ah);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) out[static_cast<size_t>(b0 + r) * G + col] = ax[r] + ah[r];
      }
    }
  } else {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= BB * H) return;
    const int r = e / H, j = e % H;
    const int per = (steps + gridDim.y - 1) / gridDim.y;
    const int s0 = blockIdx.y * per, s1 = min(steps, s0 + per);
    const float keep_scale = static_cast<float>(stride);
    float kept = 0.f;
    for (int s = s0; s < s1; ++s) {
      const size_t off = static_cast<size_t>(s) * stride;
      const float* gr = g + off + static_cast<size_t>(r) * G;
      float v;
      if constexpr (O == kSigmoid) {
        v = sigmoid_f32(gr[j]);
      } else if constexpr (O == kTanh) {
        v = tanhf(gr[j]);
      } else if constexpr (O == kSigmoidTanh) {
        v = 0.5f * tanhf(gr[j] * 0.5f) + 0.5f;
      } else if constexpr (O == kExp) {
        v = expf(gr[j]);
      } else {
        cell_forward(gr, H, j, c[off + static_cast<size_t>(r) * H + j], &v);
      }
      kept = fmaf(kept, keep_scale, v);
    }
    if (s0 < s1) out[e] = kept;
  }
}

template <int O>
cudaError_t launch(const float* g, const float* c, const float* x, const float* h,
                   const float* wih, const float* whh, float* out, int BB, int H, int In,
                   int steps, int groups, int stride, cudaStream_t s) {
  if constexpr (O == kDots) {
    if (In > 512 || H > 512) return cudaErrorInvalidValue;  // the rows' shared memory
    const dim3 grid((BB + kRows - 1) / kRows, steps);
    vpu_probe_kernel<O><<<grid, kDotThreads, 0, s>>>(g, c, x, h, wih, whh, out, BB, H, In,
                                                     steps, stride);
  } else {
    const dim3 grid((BB * H + kThreads - 1) / kThreads, groups);
    vpu_probe_kernel<O><<<grid, kThreads, 0, s>>>(g, c, x, h, wih, whh, out, BB, H, In,
                                                  steps, stride);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches op `op` (0 sigmoid, 1 tanh, 2 0.5 tanh(v / 2) + 0.5, 3 exp,
// 4 gates-only, 5 dots-only) over `steps` repetitions of the tile, the
// elementwise ops in `groups` groups of steps, on `stream` of `device`.
// `stride` must be 0 (see above).  Every pointer is a device pointer to a
// contiguous f32 array of the shapes above; out is [BB, H], or [BB, 4H] for
// dots-only.  Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for an unknown op, or In or H above 512 for dots-only).
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
    case kDots: err = launch<kDots>(g, c, x, h, wih, whh, out, BB, H, In, steps, groups, stride, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
