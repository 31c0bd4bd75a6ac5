// The DCCRN encoder's causal complex convolution, forward, for Hopper
// (sm_90a): K4.
//
// Replaces the Pallas kernel of `fused_complex_conv2d` in
// se_tpu/ops/pallas_conv.py (_kernel and _pallas_conv, :46-149).  One
// launch runs a stage's four real products at once over the doubled batch
// (rows 0..B-1 the real part, B..2B-1 the imaginary part; the wrapper in
// ops/fused_conv.py stacks the real and imaginary filters along Co):
//
//   x [B2, C, F, T] (F even)   w [Co, C, 5, 2]   b [Co]
//   y[n, o, f, t] = b[o] + sum over (c, kf, kt) of
//                   w[o, c, kf, kt] * x[n, c, 2 f + kf - 2, t + kt - 1]
//   -> y [B2, Co, F / 2, T]
//
// with x read as 0 at frequencies outside [0, F) (padding 2 on both sides)
// and at frame -1 (the causal time padding).  The padding is a masked
// load: no padded copy of x is made, and Co is not padded.
//
// What bounds it.  An implicit GEMM of M = B2 * F/2 * T output positions
// by N = Co channels over K = 10 C.  At the six encoder stages of the
// default DCCRN at B = 8 x 3 s (B2 = 16, T = 483), 132.3 GFLOP: 1.98 ms at
// 67 TFLOP/s f32, 0.13 ms at the tensor cores' 989 TFLOP/s bf16, against
// about 0.9 GB (f32) read and written: bound by operations in f32; in bf16
// the first three stages (C = 1, 16, 32) are bound by their bytes.  Both
// forms read x's rows at ten taps, so what they gather, not the arithmetic,
// is what a first design loses most time to.
//
// The f32 form: FFMA, no tensor cores.  TF32 would change the numerics of
// an f32 reference, and 3xTF32 the bits; each output is one FMA chain over
// k in order from 0, then + bias, so its bits equal those of this kernel's
// first design, a 4 x 4 register tile (and cuDNN's at DCCRN's stages).
// Blocks of 128 positions (m = f * T + t of a batch row, so a tile may span
// two bins) x BN channels (BN = 128, or 64 where Co <= 64), 256 threads
// each holding an 8 x (BN / 16) register tile (positions 4 tm .. and 64 +
// 4 tm .., channels 4 tn .. and 64 + 4 tn ..), so a k costs a thread four
// 16-byte shared loads for 64 FMAs; two blocks an SM, so that one block's
// FMAs run while the other waits at its barrier.  K runs in chunks of 16
// rows, row k = (c, kf, kt) = (k / 10, k % 10 / 2, k % 2) in w's own
// order, through two shared-memory buffers filled by cp.async: the im2col
// values 4 bytes each (zero-filled where masked), the weights 16 bytes each
// from wt, w transposed by the wrapper ([10 C][Cop], rows padded to 16
// bytes); the copies of chunk k+1 are in flight while the block multiplies
// chunk k, one barrier a chunk.  (Staging whole x rows by 16-byte copies
// and laying the tile out in shared memory, as the bf16 form does, took
// 10% longer: a second barrier a chunk and 128-frame tiles.)  No split of
// K and no atomics: two calls give the same bits.
//
// The bf16 form (pallas_conv.py:74-81, :122-123): x, b and y bf16, the
// products on the tensor cores by mma.sync.m16n8k16 (bf16 in, f32
// accumulators), the bias added in f32 and y rounded to bf16 once, at the
// store, as the Pallas kernel's `(acc + b).astype(...)`.  mma.sync, not
// wgmma: wgmma reads A from shared memory in its own swizzled layout (or
// from registers), and the A tile here is built from x's rows at ten taps,
// two of them one frame apart, which no 16-byte-aligned layout holds; this
// first tensor-core form gives up a share of the tensor cores' rate for
// that.  A block owns one output bin, 128 frames and BN channels (32, 64
// or 128 by Co).  K runs in chunks of 8 channels x 10 taps through three
// stages of shared memory, all filled by 16-byte cp.async two chunks ahead:
// the 40 x rows of the chunk's channels and the bin's five frequencies,
// each as the 16-byte pieces that cover frames t0 - 1 .. t0 + 127 (zero
// where the row is padding or past C), and the chunk's 80 rows of w, which
// the wrapper lays out tap by tap within chunks of 8 channels ([Co][10 Cp],
// Cp = C rounded up to 8).  An mma k-step is one kf: its 16 rows are kt = 0
// and kt = 1 of 8 channels, so a thread builds its A fragment (two
// channels at a frame and the next frame) from two staged rows at their
// own offsets, 16-bit loads paired into registers, and takes B through
// ldmatrix.  The x rows are each read once a chunk, for all ten taps.  y
// goes out through shared memory, a warp writing 64 contiguous bytes.  The
// f32 sums run in another order than the plain version's, so an output may
// round to the neighbouring bf16 value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "error_string.cuh"

namespace {

constexpr int kTaps = 10;      // the (5, 2) kernel
constexpr int kThreads = 256;  // both forms
constexpr int kBM = 128;       // output positions a block
constexpr int kBK = 16;        // rows of K a chunk (f32)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An asynchronous copy of 16 bytes global -> shared, zero-filled (and
// nothing read) where !ok; src must be a valid address either way.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// ---------------------------------------------------------------- f32 ----

// Two blocks an SM (at most 128 registers a thread): while one block waits
// at its barrier or issues its copies, the other's FMAs run.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
conv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ b, float* __restrict__ y,
                int C, int F, int T, int Co) {
  constexpr int TN = BN / 16;     // channels a thread: 8 or 4
  constexpr int kLdw = BN + 4;    // padded row of the weight chunk
  __shared__ __align__(16) float a_s[2][kBK][kBM];   // [k][position]
  __shared__ __align__(16) float w_s[2][kBK][kLdw];  // [k][channel]
  const int M = F / 2 * T;  // output positions of one batch row
  const int K = kTaps * C;
  const int Cop = (Co + 3) / 4 * 4;  // a row of wt
  const int n = blockIdx.z;
  const int m0 = blockIdx.x * kBM, o0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const size_t FT = static_cast<size_t>(F) * T;
  const float* xn = x + n * C * FT;

  // this thread's copies of a chunk: the im2col values of position m0 + am
  // at rows ak + 2 q, all of one time tap kt = ak (k0 is even and 10 c is):
  // row k = 2 kh + ak with kh = 5 c + kf, read from frame t + ak - 1
  const int am = tid % kBM, ak = tid / kBM;
  const int m = m0 + am;
  const int fo = m < M ? m / T : 0, tt = (m < M ? m % T : 0) + ak - 1;
  const bool a_ok = m < M && tt >= 0;
  auto copy = [&](int k0, int buf) {
#pragma unroll
    for (int q = 0; q < kBK / 2; ++q) {
      const int kh = k0 / 2 + q, c = kh / 5, f = 2 * fo + (kh - 5 * c) - 2;
      const bool ok = a_ok && 2 * kh + ak < K && f >= 0 && f < F;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_addr(&a_s[buf][ak + 2 * q][am])),
                      "l"(ok ? xn + c * FT + static_cast<size_t>(f) * T + tt : x),
                      "r"(ok ? 4 : 0) : "memory");
    }
    // the weights' rows k0 .. k0 + 15 of wt [K][Cop], BN channels each, as
    // 16-byte pieces
    for (int i = tid; i < kBK * BN / 4; i += kThreads) {
      const int kk = i / (BN / 4), o = 4 * (i % (BN / 4));
      const bool ok = k0 + kk < K && o0 + o < Cop;
      cp_async16(&w_s[buf][kk][o], ok ? wt + static_cast<size_t>(k0 + kk) * Cop + o0 + o : wt, ok);
    }
    cp_async_commit();
  };

  const int tm = tid % 16, tn = tid / 16;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  const int chunks = (K + kBK - 1) / kBK;
  copy(0, 0);
  for (int s = 0; s < chunks; ++s) {
    const int buf = s & 1;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // chunk s landed everywhere; every thread is done with chunk s - 1
    if (s + 1 < chunks) copy((s + 1) * kBK, buf ^ 1);  // in flight while chunk s is multiplied
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[8], wr[TN];
#pragma unroll
      for (int i4 = 0; i4 < 2; ++i4) {
        const float4 v = *reinterpret_cast<const float4*>(&a_s[buf][kk][i4 * 64 + 4 * tm]);
        ar[4 * i4 + 0] = v.x;
        ar[4 * i4 + 1] = v.y;
        ar[4 * i4 + 2] = v.z;
        ar[4 * i4 + 3] = v.w;
      }
#pragma unroll
      for (int j4 = 0; j4 < TN / 4; ++j4) {
        const float4 v = *reinterpret_cast<const float4*>(&w_s[buf][kk][j4 * 64 + 4 * tn]);
        wr[4 * j4 + 0] = v.x;
        wr[4 * j4 + 1] = v.y;
        wr[4 * j4 + 2] = v.z;
        wr[4 * j4 + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
      }
    }
  }

  // epilogue: + bias; a channel's positions are contiguous in y
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int o = o0 + (j / 4) * 64 + 4 * tn + j % 4;
    if (o >= Co) continue;
    const float bv = __ldg(b + o);
    float* yo = y + (static_cast<size_t>(n) * Co + o) * M;
#pragma unroll
    for (int i4 = 0; i4 < 2; ++i4) {
      const int mb = m0 + i4 * 64 + 4 * tm;
      if (mb >= M) continue;
      if ((M & 3) == 0) {  // mb is a multiple of 4 below M: four aligned positions
        *reinterpret_cast<float4*>(yo + mb) =
            make_float4(acc[4 * i4][j] + bv, acc[4 * i4 + 1][j] + bv, acc[4 * i4 + 2][j] + bv,
                        acc[4 * i4 + 3][j] + bv);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (mb + i < M) yo[mb + i] = acc[4 * i4 + i][j] + bv;
        }
      }
    }
  }
}

// One 16-byte piece of a staged x row: the row's frames t0 - 1 .. t0 + 127
// (element `first` of x on) are staged from the 16-byte boundary at or
// before `first`, so they start `first & (per - 1)` elements into the
// staged row (per = 16 / sizeof(T)).  Zero-filled for a row that is
// padding (ok false) and for pieces before x's start or past its `total`
// elements; a piece that straddles the end is copied in part.
template <typename T>
__device__ __forceinline__ void stage_piece(T* dst, const T* __restrict__ x, long long first,
                                            int part, long long total, bool ok) {
  constexpr int per = 16 / sizeof(T);
  const long long e = first - (first & (per - 1)) + per * part;
  int bytes = 0;
  if (ok && e >= 0 && e < total) {
    bytes = total - e >= per ? 16 : static_cast<int>(total - e) * static_cast<int>(sizeof(T));
  }
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(bytes > 0 ? x + e : x), "r"(bytes) : "memory");
}

// --------------------------------------------------------------- bf16 ----

constexpr int kChunkC = 8;                 // channels a chunk: 80 rows of K'
constexpr int kChunkK = kTaps * kChunkC;   // rows of K' a chunk: five mma k-steps, one per kf
constexpr int kStages = 3;                 // chunks in flight
constexpr int kRawRows = kChunkC * 5;      // x rows a chunk: (channel, kf)
constexpr int kRawPieces = 17;             // 16-byte pieces a row: frames t0 - 1 .. t0 + 127
constexpr int kRawPitch = 8 * kRawPieces;  // a staged x row: 136 bf16
constexpr int kWPitch = kChunkK + 8;       // a staged w row: 176 bytes, ldmatrix conflict-free
constexpr int kYPitch = kBM + 8;           // the bf16 output tile's channel row

// Shared memory of the bf16 kernel with BN channels: kStages stages of the
// staged x rows and w rows (the output tile reuses them).
__host__ __device__ constexpr int tc_smem(int BN) {
  return kStages * (kRawRows * kRawPitch + BN * kWPitch) * 2;
}

// ldmatrix: four (or two) 8 x 8 bf16 matrices, row addresses from lanes
// 8 i .. 8 i + 7 for matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 (16-bit patterns) as the low and high halves of a register.
__device__ __forceinline__ unsigned pack2(unsigned short lo, unsigned short hi) {
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// A block owns one output bin fo, frames t0 .. t0 + 127 and channels
// o0 .. o0 + BN - 1 of batch row n (blockIdx.x = fo * tiles of T + t tile).
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                 const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ y,
                 int C, int F, int T, int Co) {
  constexpr int NF = BN / 32;  // n8 fragments a warp: the warp tile is 64 x BN / 4
  constexpr int kRaw = kRawRows * kRawPitch, kW = BN * kWPitch;
  static_assert(BN * kYPitch <= kStages * (kRaw + kW), "the output tile reuses the stages");
  extern __shared__ __align__(16) unsigned short tc_s[];
  const int t_tiles = (T + kBM - 1) / kBM;
  const int fo = blockIdx.x / t_tiles, t0 = (blockIdx.x % t_tiles) * kBM;
  const int o0 = blockIdx.y * BN, n = blockIdx.z;
  const int M = F / 2 * T;
  const int Kp = kTaps * ((C + kChunkC - 1) / kChunkC) * kChunkC;
  const int chunks = Kp / kChunkK;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long total = static_cast<long long>(gridDim.z) * C * F * T;  // elements of x
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(x);
  auto raw_s = [&](int stage) { return tc_s + stage * (kRaw + kW); };
  auto w_s = [&](int stage) { return tc_s + stage * (kRaw + kW) + kRaw; };
  // element index of x at channel c, frequency f, frame t0 - 1 (the first
  // an output of the tile reads): a staged row starts at the 16-byte
  // boundary at or before it, `e0 & 7` elements earlier
  auto first = [&](int c, int f) {
    return ((static_cast<long long>(n) * C + c) * F + f) * T + t0 - 1;
  };

  // a chunk: x rows (channel c0 + cl, frequency 2 fo + kf - 2) of frames
  // t0 - 1 .., zero where the row is outside x (padding) or past C, and
  // the chunk's 80 rows of w' for BN channels
  auto copy = [&](int s, int stage) {
    const int c0 = s * kChunkC;
    unsigned short* raw = raw_s(stage);
    for (int i = tid; i < kRawRows * kRawPieces; i += kThreads) {
      const int row = i / kRawPieces, part = i % kRawPieces;
      const int c = c0 + row / 5, f = 2 * fo + row % 5 - 2;
      stage_piece(raw + row * kRawPitch + 8 * part, xs, first(c, f), part, total,
                  c < C && f >= 0 && f < F);
    }
    for (int i = tid; i < BN * (kChunkK / 8); i += kThreads) {
      const int o = i / (kChunkK / 8), part = i % (kChunkK / 8);
      const bool ok = o0 + o < Co;
      cp_async16(w_s(stage) + o * kWPitch + part * 8,
                 ok ? wp + static_cast<size_t>(o0 + o) * Kp + s * kChunkK + part * 8 : wp, ok);
    }
  };

  // The A fragments of this thread (mma's row g, g + 8; its k pairs 2q,
  // 2q + 1 and 8 + 2q, 8 + 2q + 1) are channels cl = 2q, 2q + 1 of a tap:
  // the offsets of their staged rows, three bits each by (kf, cl).
  const int wm = warp % 2, wn = warp / 2;  // the warp's 64 frames and BN / 4 channels
  const int g = lane / 4, q = lane % 4;
  unsigned offs = 0;
#pragma unroll
  for (int kf = 0; kf < 5; ++kf) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      offs |= static_cast<unsigned>(first(2 * q + p, 2 * fo + kf - 2) & 7) << (3 * (2 * kf + p));
    }
  }

  float acc[4][NF][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) copy(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < chunks; ++s) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    __syncthreads();  // chunk s is in shared memory; every warp is done with chunk s - 1
    if (s + kStages - 1 < chunks) copy(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned short* raw = raw_s(s % kStages);
    const unsigned short* W = w_s(s % kStages);
#pragma unroll
    for (int kf = 0; kf < 5; ++kf) {  // k-step kf: taps (kf, kt = 0) and (kf, kt = 1)
      unsigned bfr[NF][2];
#pragma unroll
      for (int j = 0; j < NF; j += 2) {
        if (j + 1 < NF) {
          unsigned r[4];
          ldmatrix_x4(r, W + (wn * (BN / 4) + j * 8 + (lane / 16) * 8 + lane % 8) * kWPitch +
                             kf * 16 + ((lane / 8) % 2) * 8);
          bfr[j][0] = r[0];
          bfr[j][1] = r[1];
          bfr[j + 1][0] = r[2];
          bfr[j + 1][1] = r[3];
        } else {
          ldmatrix_x2(bfr[j][0], bfr[j][1], W + (wn * (BN / 4) + j * 8 + lane % 8) * kWPitch +
                                                kf * 16 + ((lane / 8) % 2) * 8);
        }
      }
      const unsigned short* r0 = raw + (2 * q * 5 + kf) * kRawPitch +
                                 ((offs >> (6 * kf)) & 7);  // channel 2q
      const unsigned short* r1 = raw + ((2 * q + 1) * 5 + kf) * kRawPitch +
                                 ((offs >> (6 * kf + 3)) & 7);  // channel 2q + 1
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + i * 16 + g;  // frames t0 + m - 1 + kt
        unsigned af[4];
        af[0] = pack2(r0[m], r1[m]);
        af[1] = pack2(r0[m + 8], r1[m + 8]);
        af[2] = pack2(r0[m + 1], r1[m + 1]);
        af[3] = pack2(r0[m + 9], r1[m + 9]);
        if (t0 + m == 0) af[0] = 0;  // frame -1: the causal padding (the staged
                                     // element belongs to the row before)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_bf16(acc[i][j], af, bfr[j][0], bfr[j][1]);
      }
    }
  }

  // epilogue: acc + bias in f32, rounded once, through shared memory
  // [channel][frame] so that a warp writes 64 contiguous bytes of y
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  __nv_bfloat16* y_s = reinterpret_cast<__nv_bfloat16*>(tc_s);
#pragma unroll
  for (int j = 0; j < NF; ++j) {
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      const int ch = wn * (BN / 4) + j * 8 + 2 * q + col;
      const float bv = o0 + ch < Co ? __bfloat162float(b[o0 + ch]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          y_s[ch * kYPitch + wm * 64 + i * 16 + g + 8 * half] =
              __float2bfloat16_rn(acc[i][j][2 * half + col] + bv);
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BN * kBM; i += kThreads) {
    const int ch = i / kBM, pos = i % kBM;
    if (o0 + ch < Co && t0 + pos < T) {
      y[(static_cast<size_t>(n) * Co + o0 + ch) * M + static_cast<size_t>(fo) * T + t0 + pos] =
          y_s[ch * kYPitch + pos];
    }
  }
}

template <int BN>
cudaError_t launch_f32(const float* x, const float* w, const float* b, float* y, int B2, int C,
                       int F, int T, int Co, cudaStream_t s) {
  const int M = F / 2 * T;
  const dim3 grid((M + kBM - 1) / kBM, (Co + BN - 1) / BN, B2);
  conv_f32_kernel<BN><<<grid, kThreads, 0, s>>>(x, w, b, y, C, F, T, Co);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const __nv_bfloat16* b,
                        __nv_bfloat16* y, int B2, int C, int F, int T, int Co, cudaStream_t s) {
  const int smem = tc_smem(BN);
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(conv_bf16_kernel<BN>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(F / 2 * ((T + kBM - 1) / kBM), (Co + BN - 1) / BN, B2);
  conv_bf16_kernel<BN><<<grid, kThreads, smem, s>>>(x, w, b, y, C, F, T, Co);
  return cudaGetLastError();
}

}  // namespace

// Launches the conv on `stream` (a cudaStream_t) of `device`.  Every
// pointer is a device pointer to a contiguous f32 array of the shapes above
// (y [B2, Co, F / 2, T]; F must be even), but w, which comes as wt [10 C]
// [Cop]: w's rows k = (c, kf, kt) as columns, each row Co channels and
// zeros to Cop = Co rounded up to 4 (16-byte rows for cp.async).  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int se_complex_conv_fwd_f32(const float* x, const float* w, const float* b,
                                       float* y, int B2, int C, int F, int T, int Co,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = Co <= 64 ? launch_f32<64>(x, w, b, y, B2, C, F, T, Co, s)
                 : launch_f32<128>(x, w, b, y, B2, C, F, T, Co, s);
  return static_cast<int>(err);
}

// The bf16 form: x, b and y bf16 as above, and w bf16 in the tensor-core
// layout [Co][10 Cp] (Cp = C rounded up to 8): w'[o][80 (c / 8) + 8 (2 kf
// + kt) + c % 8] = w[o, c, kf, kt], zero for c >= C.  The products are
// summed in f32 and y is rounded once.
extern "C" int se_complex_conv_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                        const __nv_bfloat16* b, __nv_bfloat16* y,
                                        int B2, int C, int F, int T, int Co,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = Co <= 32   ? launch_bf16<32>(x, w, b, y, B2, C, F, T, Co, s)
        : Co <= 64 ? launch_bf16<64>(x, w, b, y, B2, C, F, T, Co, s)
                   : launch_bf16<128>(x, w, b, y, B2, C, F, T, Co, s);
  return static_cast<int>(err);
}
