// Composite objective measures: WSS, LLR, segSNR (Hu & Loizou 2006).
//
// C++ form of the numpy implementation in se_tpu_torch/eval/composite.py
// (the port's copy of the JAX package's; reference semantics:
// composite.m:151-562, executed via Octave in the reference).  Exported entry fills
// out[4] = {csig, cbak, covl, seg_snr} with the PESQ term at zero (the
// caller re-adds it, reference: tools_for_estimate.py:27-29).

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

#include "fftr.h"

namespace {

using se_native::fft;
using se_native::next_pow2;

const double CENT_FREQ[25] = {
    50.0,    120.0,   190.0,   260.0,   330.0,  400.0,  470.0,
    540.0,   617.372, 703.378, 798.717, 904.128, 1020.38, 1148.30,
    1288.72, 1442.54, 1610.70, 1794.16, 1993.93, 2211.08, 2446.71,
    2701.97, 2978.04, 3276.17, 3597.63};
const double BANDWIDTH[25] = {
    70.0,    70.0,    70.0,    70.0,    70.0,    70.0,    70.0,
    77.3724, 86.0056, 95.3398, 105.411, 116.256, 127.914, 140.423,
    153.823, 168.154, 183.457, 199.776, 217.153, 235.631, 255.255,
    276.072, 298.126, 321.465, 346.136};

std::vector<double> window_fn(int n) {
  std::vector<double> w(n);
  for (int k = 1; k <= n; k++)
    w[k - 1] = 0.5 * (1.0 - std::cos(2.0 * M_PI * k / (double)(n + 1)));
  return w;
}

// power spectrum |FFT|^2 of a windowed frame, first nfft/2 bins
void power_spec(const double* frame, const std::vector<double>& w, int n,
                int nfft, double* out) {
  std::vector<std::complex<double>> a(nfft, {0.0, 0.0});
  for (int i = 0; i < n; i++) a[i] = {frame[i] * w[i], 0.0};
  fft(a, false);
  for (int k = 0; k < nfft / 2; k++)
    out[k] = a[k].real() * a[k].real() + a[k].imag() * a[k].imag();
}

struct Frames {
  long num;
  int winlength, skiprate;
};

Frames framing(long len, long fs) {
  Frames f;
  f.winlength = (int)std::lround(30.0 * fs / 1000.0);
  f.skiprate = f.winlength / 4;
  f.num = (long)((double)len / f.skiprate - (double)f.winlength / f.skiprate);
  return f;
}

void wss(const double* clean, const double* processed, long len, long fs,
         std::vector<double>& dist) {
  Frames fr = framing(len, fs);
  const int num_crit = 25;
  const double max_freq = fs / 2.0;
  int n_fft = (int)next_pow2(2 * fr.winlength);
  int n_fftby2 = n_fft / 2;
  const double Kmax = 20.0, Klocmax = 1.0;
  const double min_factor = std::exp(-30.0 / (2.0 * 2.303));

  std::vector<std::vector<double>> crit(num_crit,
                                        std::vector<double>(n_fftby2));
  for (int i = 0; i < num_crit; i++) {
    double f0 = std::floor(CENT_FREQ[i] / max_freq * n_fftby2);
    double bw = BANDWIDTH[i] / max_freq * n_fftby2;
    double norm = std::log(BANDWIDTH[0]) - std::log(BANDWIDTH[i]);
    for (int j = 0; j < n_fftby2; j++) {
      double v = std::exp(-11.0 * std::pow(((double)j - f0) / bw, 2.0) + norm);
      crit[i][j] = v > min_factor ? v : 0.0;
    }
  }

  auto w = window_fn(fr.winlength);
  std::vector<double> cs(n_fftby2), ps(n_fftby2);
  std::vector<double> ce(num_crit), pe(num_crit);
  dist.resize(fr.num);
  for (long t = 0; t < fr.num; t++) {
    long start = t * fr.skiprate;
    power_spec(clean + start, w, fr.winlength, n_fft, cs.data());
    power_spec(processed + start, w, fr.winlength, n_fft, ps.data());
    for (int i = 0; i < num_crit; i++) {
      double ec = 0, ep = 0;
      for (int j = 0; j < n_fftby2; j++) {
        ec += cs[j] * crit[i][j];
        ep += ps[j] * crit[i][j];
      }
      ce[i] = 10.0 * std::log10(std::max(ec, 1e-10));
      pe[i] = 10.0 * std::log10(std::max(ep, 1e-10));
    }
    double csl[24], psl[24], clp[24], plp[24];
    for (int i = 0; i < num_crit - 1; i++) {
      csl[i] = ce[i + 1] - ce[i];
      psl[i] = pe[i + 1] - pe[i];
    }
    auto loc_peak = [&](const double* e, const double* s, double* out) {
      for (int i = 0; i < num_crit - 1; i++) {
        int n = i;
        if (s[i] > 0) {
          // composite.m:314 takes energy(n-1) at exit — one band below the
          // local maximum (oracle-pinned, tests/oracles/octave_composite.py)
          while (n < num_crit - 1 && s[n] > 0) n++;
          out[i] = e[n - 1];
        } else {
          while (n >= 0 && s[n] <= 0) n--;
          out[i] = e[n + 1];
        }
      }
    };
    loc_peak(ce.data(), csl, clp);
    loc_peak(pe.data(), psl, plp);
    double dbmax_c = *std::max_element(ce.begin(), ce.end());
    double dbmax_p = *std::max_element(pe.begin(), pe.end());
    double num = 0, den = 0;
    for (int i = 0; i < num_crit - 1; i++) {
      double wc = (Kmax / (Kmax + dbmax_c - ce[i])) *
                  (Klocmax / (Klocmax + clp[i] - ce[i]));
      double wp = (Kmax / (Kmax + dbmax_p - pe[i])) *
                  (Klocmax / (Klocmax + plp[i] - pe[i]));
      double W = (wc + wp) / 2.0;
      num += W * (csl[i] - psl[i]) * (csl[i] - psl[i]);
      den += W;
    }
    dist[t] = num / den;
  }
}

void lpcoeff(const double* frame, int n, int order, double* R, double* A) {
  for (int k = 0; k <= order; k++) {
    double s = 0.0;
    for (int i = 0; i < n - k; i++) s += frame[i] * frame[i + k];
    R[k] = s;
  }
  std::vector<double> a(order, 0.0), a_new(order);
  double E = R[0];
  for (int i = 0; i < order; i++) {
    double acc = 0.0;
    for (int k = 0; k < i; k++) acc += a[k] * R[i - k];
    double rc = (R[i + 1] - acc) / E;
    for (int k = 0; k < i; k++) a_new[k] = a[k] - rc * a[i - 1 - k];
    a_new[i] = rc;
    for (int k = 0; k <= i; k++) a[k] = a_new[k];
    E = (1 - rc * rc) * E;
  }
  A[0] = 1.0;
  for (int k = 0; k < order; k++) A[k + 1] = -a[k];
}

void llr(const double* clean, const double* processed, long len, long fs,
         std::vector<double>& dist) {
  Frames fr = framing(len, fs);
  const int order = fs < 10000 ? 10 : 16;
  auto w = window_fn(fr.winlength);
  std::vector<double> cf(fr.winlength), pf(fr.winlength);
  std::vector<double> Rc(order + 1), Rp(order + 1), Ac(order + 1),
      Ap(order + 1);
  dist.resize(fr.num);
  for (long t = 0; t < fr.num; t++) {
    long start = t * fr.skiprate;
    for (int i = 0; i < fr.winlength; i++) {
      cf[i] = clean[start + i] * w[i];
      pf[i] = processed[start + i] * w[i];
    }
    lpcoeff(cf.data(), fr.winlength, order, Rc.data(), Ac.data());
    lpcoeff(pf.data(), fr.winlength, order, Rp.data(), Ap.data());
    // A * toeplitz(Rc) * A'
    auto quad = [&](const double* A) {
      double s = 0.0;
      for (int i = 0; i <= order; i++)
        for (int j = 0; j <= order; j++)
          s += A[i] * Rc[std::abs(i - j)] * A[j];
      return s;
    };
    dist[t] = std::log(quad(Ap.data()) / quad(Ac.data()));
  }
}

double seg_snr(const double* clean, const double* processed, long len,
               long fs) {
  Frames fr = framing(len, fs);
  auto w = window_fn(fr.winlength);
  const double eps = 2.220446049250313e-16;
  double total = 0.0;
  for (long t = 0; t < fr.num; t++) {
    long start = t * fr.skiprate;
    double sig = 0, noi = 0;
    for (int i = 0; i < fr.winlength; i++) {
      double c = clean[start + i] * w[i];
      double p = processed[start + i] * w[i];
      sig += c * c;
      noi += (c - p) * (c - p);
    }
    double s = 10.0 * std::log10(sig / (noi + eps) + eps);
    total += std::min(std::max(s, -10.0), 35.0);
  }
  return total / (double)fr.num;
}

double trimmed_mean(std::vector<double>& v, double alpha) {
  std::sort(v.begin(), v.end());
  long keep = (long)std::lround((double)v.size() * alpha);
  double s = 0.0;
  for (long i = 0; i < keep; i++) s += v[i];
  return s / (double)keep;
}

}  // namespace

extern "C" void composite_measures_c(const double* clean_in,
                                     const double* processed_in, long len,
                                     long fs, double* out) {
  const double eps = 2.220446049250313e-16;
  std::vector<double> clean(len), processed(len);
  for (long i = 0; i < len; i++) {
    clean[i] = clean_in[i] + eps;
    processed[i] = processed_in[i] + eps;
  }
  const double alpha = 0.95;

  std::vector<double> wss_vec, llr_vec;
  wss(clean.data(), processed.data(), len, fs, wss_vec);
  llr(clean.data(), processed.data(), len, fs, llr_vec);
  double wss_dist = trimmed_mean(wss_vec, alpha);
  double llr_mean = trimmed_mean(llr_vec, alpha);
  double seg = seg_snr(clean.data(), processed.data(), len, fs);

  double csig = 3.093 - 1.029 * llr_mean - 0.009 * wss_dist;
  csig = std::min(std::max(csig, 1.0), 5.0);
  double cbak = 1.634 - 0.007 * wss_dist + 0.063 * seg;
  cbak = std::min(std::max(cbak, 1.0), 5.0);
  double covl = 1.594 - 0.512 * llr_mean - 0.007 * wss_dist;
  covl = std::min(std::max(covl, 1.0), 5.0);
  out[0] = csig;
  out[1] = cbak;
  out[2] = covl;
  out[3] = seg;
}
