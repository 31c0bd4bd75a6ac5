// Minimal power-of-two FFT utilities for the native metrics library.
#pragma once

#include <cmath>
#include <complex>
#include <vector>

namespace se_native {

inline long next_pow2(long n) {
  long p = 1;
  while (p < n) p <<= 1;
  return p;
}

// In-place iterative radix-2 complex FFT (inverse when inv = true,
// includes the 1/N scaling on inverse).
inline void fft(std::vector<std::complex<double>>& a, bool inv) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; i++) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * M_PI / (double)len * (inv ? 1.0 : -1.0);
    std::complex<double> wl(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      std::complex<double> w(1.0, 0.0);
      for (size_t j = 0; j < len / 2; j++) {
        std::complex<double> u = a[i + j];
        std::complex<double> v = a[i + j + len / 2] * w;
        a[i + j] = u + v;
        a[i + j + len / 2] = u - v;
        w *= wl;
      }
    }
  }
  if (inv) {
    for (auto& x : a) x /= (double)n;
  }
}

// rfft of a real vector zero-padded to pow2; returns pow2/2+1 bins.
inline std::vector<std::complex<double>> rfft(const double* x, long n,
                                              long pow2) {
  std::vector<std::complex<double>> a(pow2, {0.0, 0.0});
  for (long i = 0; i < n; i++) a[i] = {x[i], 0.0};
  fft(a, false);
  a.resize(pow2 / 2 + 1);
  return a;
}

// inverse of rfft: reconstruct the real signal of length pow2.
inline std::vector<double> irfft(const std::vector<std::complex<double>>& half,
                                 long pow2) {
  std::vector<std::complex<double>> a(pow2);
  for (long k = 0; k <= pow2 / 2; k++) a[k] = half[k];
  for (long k = pow2 / 2 + 1; k < pow2; k++) a[k] = std::conj(half[pow2 - k]);
  fft(a, true);
  std::vector<double> out(pow2);
  for (long i = 0; i < pow2; i++) out[i] = a[i].real();
  return out;
}

}  // namespace se_native
