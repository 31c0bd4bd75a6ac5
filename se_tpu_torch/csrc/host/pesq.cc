// PESQ — ITU-T P.862.2 (wideband, 16 kHz) native implementation.
//
// C++ form of the numpy specification in se_tpu_torch/eval/pesq_np.py
// (held to it by tests/test_torch_native_metrics.py).  Implements the complete P.862
// utterance time-alignment chain: VAD with activity smoothing,
// whole-signal + per-utterance crude alignment, histogram time
// alignment, utterance identification, recursive splitting, the
// signal-repetition amnesty and bad-interval reprocessing.  Constants
// are the published P.862 tables (p862_tables.h).  Exported entry:
//   double pesq_measure_wb(const double* clean, const double* degraded,
//                          long nclean, long ndeg, long fs);

#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>
#include <utility>
#include <vector>

#include "fftr.h"
#include "p862_tables.h"

namespace {

using se_native::fft;
using se_native::irfft;
using se_native::next_pow2;
using se_native::rfft;

constexpr long SEARCHBUFFER = 75;
constexpr long DATAPADDING_MSECS = 320;
constexpr long NF = 512;  // DOWNSAMPLE * 8
constexpr long ALIGN_NFFT = 1024;
constexpr double TARGET_POWER = 1e7;
constexpr double SP = 6.910853e-006;
constexpr double SL = 1.866055e-001;
constexpr double THRESHOLD_BAD_FRAMES = 30.0;
constexpr int SMEAR_RANGE = 2;
constexpr int MIN_BAD_INTERVAL = 5;
constexpr long BAD_INTERVAL_SEARCH = 2048;
constexpr long MINUTTLENGTH = 50;  // windows
constexpr int MAXNUTTERANCES = 50;
constexpr long MIN_SPLIT_LEN = 200;  // speech windows before split attempts
constexpr double CRIT_SILENCE_5 = 500.0;

inline long dp_samples() { return DATAPADDING_MSECS * (P862_FS / 1000); }
inline long div_trunc(long v, long d) { return v / d; }  // C semantics

struct Padded {
  std::vector<double> data;
  long nsamples;  // active length incl. search buffers, excl. datapadding
};

Padded pad_signal(const double* x, long n, long reserve_extra) {
  const long buf = SEARCHBUFFER * P862_DOWNSAMPLE;
  Padded p;
  p.nsamples = n + 2 * buf;
  p.data.assign(p.nsamples + dp_samples() + reserve_extra, 0.0);
  std::memcpy(p.data.data() + buf, x, sizeof(double) * n);
  return p;
}

double pow_of(const std::vector<double>& x, long start, long end, long div) {
  double s = 0.0;
  for (long i = start; i < end; i++) s += x[i] * x[i];
  return s / (double)div;
}

// FFT-domain piecewise-linear dB filter over the active region.
void apply_filter_db(std::vector<double>& x, long nsamples,
                     const double* filt, int npts) {
  const long buf = SEARCHBUFFER * P862_DOWNSAMPLE;
  const long n = nsamples - 2 * buf + dp_samples();
  const long pow2 = next_pow2(n);
  auto X = rfft(x.data() + buf, n, pow2);
  for (long k = 0; k < (long)X.size(); k++) {
    double freq = (double)k * (double)P862_FS / (double)pow2;
    double db;
    if (freq <= filt[0]) {
      db = filt[1];
    } else if (freq >= filt[2 * (npts - 1)]) {
      db = filt[2 * (npts - 1) + 1];
    } else {
      int j = 0;
      while (filt[2 * (j + 1)] < freq) j++;
      double f0 = filt[2 * j], f1 = filt[2 * (j + 1)];
      double d0 = filt[2 * j + 1], d1 = filt[2 * (j + 1) + 1];
      db = d0 + (d1 - d0) * (freq - f0) / (f1 - f0);
    }
    X[k] *= std::pow(10.0, db / 20.0);
  }
  auto y = irfft(X, pow2);
  for (long i = 0; i < n; i++) x[buf + i] = y[i];
}

void fix_power_level(Padded& p) {
  const long buf = SEARCHBUFFER * P862_DOWNSAMPLE;
  std::vector<double> filtered = p.data;
  apply_filter_db(filtered, p.nsamples, P862_ALIGN_FILTER_DB, 26);
  double power = pow_of(filtered, buf, p.nsamples - buf + dp_samples(),
                        p.nsamples - 2 * buf + dp_samples());
  double g = std::sqrt(TARGET_POWER / power);
  for (auto& v : p.data) v *= g;
}

// IIR biquad cascade over data[start, start + n), zero initial state.
void iir_sos_range(std::vector<double>& data, long start, long n,
                   const double (*sos)[5], int nsec) {
  for (int s = 0; s < nsec; s++) {
    const double b0 = sos[s][0], b1 = sos[s][1], b2 = sos[s][2],
                 a1 = sos[s][3], a2 = sos[s][4];
    double x1 = 0, x2 = 0, y1 = 0, y2 = 0;
    for (long i = start; i < start + n; i++) {
      double x0 = data[i];
      double y0 = b0 * x0 + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2;
      x2 = x1;
      x1 = x0;
      y2 = y1;
      y1 = y0;
      data[i] = y0;
    }
  }
}

// P.862.2 wideband model-path input filtering: zero the samples just
// outside the active region, 15-sample linear fades at the active-region
// edges, then the single-section wideband IIR over exactly
// [buf, nsamples - buf) (decoded from the reference binary's
// pesq_measure).
void taper_and_wb_filter(std::vector<double>& data, long nsamples,
                         const double (*sos)[5]) {
  const long buf = SEARCHBUFFER * P862_DOWNSAMPLE;
  data[buf - 1] = 0.0;
  data[nsamples - buf] = 0.0;
  for (long k = 0; k < 15; k++) {
    double ramp = (double)(k + 1) / 16.0;
    data[buf + k] *= ramp;
    data[nsamples - buf - 1 - k] *= ramp;
  }
  iir_sos_range(data, buf, nsamples - 2 * buf, sos, 1);
}

void dc_block(std::vector<double>& data, long nsamples) {
  const long buf = SEARCHBUFFER * P862_DOWNSAMPLE;
  const long n = nsamples;
  double mean = 0.0;
  for (long i = buf; i < n - buf; i++) mean += data[i];
  mean /= (double)(n - 2 * buf);
  for (long i = buf; i < n - buf; i++) data[i] -= mean;
  for (long i = 0; i < P862_DOWNSAMPLE; i++) {
    double ramp = ((double)i + 0.5) / (double)P862_DOWNSAMPLE;
    data[buf + i] *= ramp;
    data[n - buf - 1 - i] *= ramp;
  }
}

// P.862 apply_VAD: window powers, iterative mu + 2 sigma noise threshold,
// activity smoothing (drop runs < 5, join gaps <= MINUTTLENGTH, 0.3/0.1
// two-window edge extension).  Fills vad (0 where inactive) and logvad.
void apply_vad(const std::vector<double>& data, long nsamples,
               std::vector<double>& vad, std::vector<double>& logvad) {
  const long nwin = nsamples / P862_DOWNSAMPLE;
  vad.assign(nwin, 0.0);
  for (long i = 0; i < nwin; i++) {
    double s = 0.0;
    for (long j = 0; j < P862_DOWNSAMPLE; j++) {
      double v = data[i * P862_DOWNSAMPLE + j];
      s += v * v;
    }
    vad[i] = s / (double)P862_DOWNSAMPLE;
  }
  double thresh = 0.0, vmax = 0.0;
  for (double v : vad) {
    thresh += v;
    vmax = std::max(vmax, v);
  }
  thresh /= (double)nwin;
  double level_min = vmax * 1e-4;
  const bool clamped = level_min > 0;
  if (clamped) {
    for (auto& v : vad) v = std::max(v, level_min);
  }
  for (int it = 0; it < 12; it++) {
    double mu = 0.0, m2 = 0.0;
    long cnt = 0;
    for (double v : vad)
      if (v <= thresh) {
        mu += v;
        m2 += v * v;
        cnt++;
      }
    if (!cnt) break;
    mu /= (double)cnt;
    m2 /= (double)cnt;
    double sd = std::sqrt(std::max(m2 - mu * mu, 0.0));
    double nt = mu + 2.0 * sd;
    if (std::fabs(thresh - nt) < 1e-12 * thresh) break;
    thresh = nt;
  }
  // in exact arithmetic the refined threshold can never fall below the
  // clamp floor (every member of the below-population is >= level_min);
  // enforce it so float rounding can't flip clamped-silent windows active
  if (clamped) thresh = std::max(thresh, level_min);
  std::vector<char> active(nwin);
  for (long i = 0; i < nwin; i++) active[i] = vad[i] > thresh;
  // drop active runs shorter than 5 windows
  for (long i = 0; i < nwin;) {
    if (!active[i]) {
      i++;
      continue;
    }
    long j = i;
    while (j < nwin && active[j]) j++;
    if (j - i < 5)
      for (long k = i; k < j; k++) active[k] = 0;
    i = j;
  }
  // join inactive gaps of <= MINUTTLENGTH between surviving runs
  long prev_end = -1;
  for (long i = 0; i < nwin;) {
    if (!active[i]) {
      i++;
      continue;
    }
    long j = i;
    while (j < nwin && active[j]) j++;
    if (prev_end >= 0 && i - prev_end <= MINUTTLENGTH)
      for (long k = prev_end; k < i; k++) active[k] = 1;
    prev_end = j;
    i = j;
  }
  // 0.3/0.1 edge extension on the (joined) runs
  std::vector<double> out = vad;
  std::vector<char> act2 = active;
  for (long i = 0; i < nwin;) {
    if (!active[i]) {
      i++;
      continue;
    }
    long j = i;
    while (j < nwin && active[j]) j++;
    if (i - 1 >= 0) {
      out[i - 1] = 0.3 * vad[i];
      act2[i - 1] = 1;
    }
    if (i - 2 >= 0) {
      out[i - 2] = 0.1 * vad[i];
      act2[i - 2] = 1;
    }
    if (j < nwin) {
      out[j] = 0.3 * vad[j - 1];
      act2[j] = 1;
    }
    if (j + 1 < nwin) {
      out[j + 1] = 0.1 * vad[j - 1];
      act2[j + 1] = 1;
    }
    i = j;
  }
  logvad.assign(nwin, 0.0);
  for (long i = 0; i < nwin; i++) {
    vad[i] = act2[i] ? out[i] : 0.0;
    if (vad[i] > thresh)
      logvad[i] = std::log(std::max(vad[i] / thresh, 1e-30));
  }
}

// Full linear cross-correlation (P.862 FFTNXCorr):
// Y[i] = sum_j x1[j] * x2[i - (n1-1) + j], length n1 + n2 - 1.
std::vector<double> fft_nx_corr(const double* x1, long n1, const double* x2,
                                long n2) {
  long pow2 = next_pow2(n1 + n2 - 1);
  std::vector<double> a(pow2, 0.0);
  for (long i = 0; i < n1; i++) a[i] = x1[n1 - 1 - i];
  auto X1 = rfft(a.data(), pow2, pow2);
  auto X2 = rfft(x2, n2, pow2);
  std::vector<std::complex<double>> prod(X1.size());
  for (size_t k = 0; k < X1.size(); k++) prod[k] = X1[k] * X2[k];
  auto y = irfft(prod, pow2);
  y.resize(n1 + n2 - 1);
  return y;
}

long crude_align_whole(const std::vector<double>& lv_ref,
                       const std::vector<double>& lv_deg) {
  auto y = fft_nx_corr(lv_ref.data(), (long)lv_ref.size(), lv_deg.data(),
                       (long)lv_deg.size());
  long best = 0;
  for (long i = 1; i < (long)y.size(); i++)
    if (y[i] > y[best]) best = i;
  if (y[best] <= 0.0) return 0;
  return (best - ((long)lv_ref.size() - 1)) * P862_DOWNSAMPLE;
}

long crude_subalign(const std::vector<double>& lv_ref,
                    const std::vector<double>& lv_deg, long startr, long nr,
                    long startd, long nd) {
  if (nr <= 1 || nd <= 1) return 0;
  auto y = fft_nx_corr(lv_ref.data() + startr, nr, lv_deg.data() + startd, nd);
  long best = 0;
  for (long i = 1; i < (long)y.size(); i++)
    if (y[i] > y[best]) best = i;
  if (y[best] <= 0.0) return 0;
  return (best - (nr - 1)) * P862_DOWNSAMPLE;
}

long crude_align_utt(const std::vector<double>& lv_ref,
                     const std::vector<double>& lv_deg, long nd_windows,
                     long sw_start, long sw_end, long base_delay) {
  long startr = sw_start;
  long startd = startr + base_delay / P862_DOWNSAMPLE;
  if (startd < 0) {
    startr = -base_delay / P862_DOWNSAMPLE;
    startd = 0;
  }
  long nr_w = sw_end - startr;
  long nd_w = nr_w;
  if (startd + nd_w > nd_windows) nd_w = nd_windows - startd;
  return crude_subalign(lv_ref, lv_deg, startr, nr_w, startd, nd_w) +
         base_delay;
}

// Caches for time_align: windowed rFFTs keyed by start sample, and
// per-(startr, startd) histogram contributions (sparse).  split_align
// evaluates ~40 break points whose window pairs massively overlap, so
// caching turns its cost from O(BPs * windows * FFT) into O(windows * FFT).
struct TAContribution {
  double inc;
  std::vector<int> bins;
};
struct TACache {
  std::map<long, std::vector<std::complex<double>>> ref_fft, deg_fft;
  std::map<std::pair<long, long>, TAContribution> pair;
};

const std::vector<std::complex<double>>& windowed_fft(
    const std::vector<double>& x, long start, const std::vector<double>& w,
    std::map<long, std::vector<std::complex<double>>>& cache) {
  auto it = cache.find(start);
  if (it != cache.end()) return it->second;
  std::vector<double> buf(ALIGN_NFFT);
  for (long i = 0; i < ALIGN_NFFT; i++) buf[i] = x[start + i] * w[i];
  return cache.emplace(start, rfft(buf.data(), ALIGN_NFFT, ALIGN_NFFT))
      .first->second;
}

// P.862 time_align: histogram of windowed cross-correlation peaks.
void time_align(const std::vector<double>& ref, const std::vector<double>& deg,
                long nd, long sw_start_w, long sw_end_w, long estdelay,
                long* out_delay, double* out_conf, TACache* cache) {
  static std::vector<double> window;
  if ((long)window.size() != ALIGN_NFFT) {
    window.resize(ALIGN_NFFT);
    for (long i = 0; i < ALIGN_NFFT; i++)
      window[i] =
          0.5 * (1.0 - std::cos(2.0 * M_PI * (double)i / (double)ALIGN_NFFT));
  }
  std::vector<double> H(ALIGN_NFFT, 0.0);
  long startr = sw_start_w * P862_DOWNSAMPLE;
  long startd = startr + estdelay;
  if (startd < 0) {
    startr = -estdelay;
    startd = 0;
  }
  const long end_r = sw_end_w * P862_DOWNSAMPLE;
  while (startd + ALIGN_NFFT <= nd && startr + ALIGN_NFFT <= end_r) {
    const TAContribution* contrib = nullptr;
    TAContribution local;
    std::pair<long, long> key{startr, startd};
    auto it = cache->pair.find(key);
    if (it != cache->pair.end()) contrib = &it->second;
    if (!contrib) {
      const auto& X1 = windowed_fft(ref, startr, window, cache->ref_fft);
      const auto& X2 = windowed_fft(deg, startd, window, cache->deg_fft);
      std::vector<std::complex<double>> prod(X1.size());
      for (size_t k = 0; k < X1.size(); k++)
        prod[k] = std::conj(X1[k]) * X2[k];
      auto corr = irfft(prod, ALIGN_NFFT);
      double vmax = 0.0;
      for (long i = 0; i < ALIGN_NFFT; i++) {
        corr[i] = std::fabs(corr[i]);
        vmax = std::max(vmax, corr[i]);
      }
      vmax *= 0.99;
      local.inc = std::pow(vmax, 0.125);
      for (long i = 0; i < ALIGN_NFFT; i++)
        if (corr[i] > vmax) local.bins.push_back((int)i);
      contrib = &cache->pair.emplace(key, std::move(local)).first->second;
    }
    for (int b : contrib->bins) H[b] += contrib->inc;
    startr += ALIGN_NFFT / 4;
    startd += ALIGN_NFFT / 4;
  }
  double hsum = 0.0;
  for (double h : H) hsum += h;
  // circular triangular smoothing, half-width ALIGN_NFFT/64
  const long kernel = ALIGN_NFFT / 64;
  std::vector<double> sm(ALIGN_NFFT, 0.0);
  for (long c = 0; c < ALIGN_NFFT; c++) {
    if (H[c] == 0.0) continue;
    for (long k = 1 - kernel; k < kernel; k++) {
      long idx = ((c + k) % ALIGN_NFFT + ALIGN_NFFT) % ALIGN_NFFT;
      sm[idx] += H[c] * (1.0 - (double)std::labs(k) / (double)kernel);
    }
  }
  long imax = 0;
  for (long i = 1; i < ALIGN_NFFT; i++)
    if (sm[i] > sm[imax]) imax = i;
  double vmax = sm[imax];
  if (imax >= ALIGN_NFFT / 2) imax -= ALIGN_NFFT;
  *out_delay = estdelay + imax;
  *out_conf = hsum > 0.0 ? vmax / hsum : 0.0;
}

struct Utt {
  long start_w, end_w;  // body [start, end) in windows
  long delay;           // samples
  long delay_est;
  double conf;
};

// P.862 id_searchwindows.
void id_searchwindows(const std::vector<double>& vad_ref, long nr, long nd,
                      long crude, std::vector<std::pair<long, long>>& wins) {
  const long vad_length = nr / P862_DOWNSAMPLE;
  const long del_deg_start = MINUTTLENGTH - crude / P862_DOWNSAMPLE;
  const long del_deg_end =
      (nd - crude) / P862_DOWNSAMPLE - MINUTTLENGTH;
  bool speech = false;
  long this_start = 0, cur_start = 0;
  for (long count = 0; count < vad_length; count++) {
    double v = vad_ref[count];
    if (v > 0.0 && !speech) {
      speech = true;
      this_start = count;
      cur_start = std::max<long>(count - SEARCHBUFFER, 0);
    }
    if ((v == 0.0 || count == vad_length - 1) && speech) {
      speech = false;
      long end = std::min(count + SEARCHBUFFER, vad_length - 1);
      if (count - this_start >= MINUTTLENGTH && this_start < del_deg_end &&
          count > del_deg_start && (long)wins.size() < MAXNUTTERANCES)
        wins.push_back({cur_start, end});
    }
  }
}

// P.862 id_utterances.
void id_utterances(const std::vector<double>& vad_ref, long nr, long nd,
                   std::vector<Utt>& utts) {
  const long vad_length = nr / P862_DOWNSAMPLE;
  const long n_utt = (long)utts.size();
  if (!n_utt) return;
  const long del_deg_start =
      MINUTTLENGTH - utts.front().delay / P862_DOWNSAMPLE;
  const long del_deg_end =
      (nd - utts.back().delay) / P862_DOWNSAMPLE - MINUTTLENGTH;
  std::vector<std::pair<long, long>> bodies;
  bool speech = false;
  long this_start = 0;
  for (long count = 0; count < vad_length; count++) {
    double v = vad_ref[count];
    if (v > 0.0 && !speech) {
      speech = true;
      this_start = count;
    }
    if ((v == 0.0 || count == vad_length - 1) && speech) {
      speech = false;
      if (count - this_start >= MINUTTLENGTH && this_start < del_deg_end &&
          count > del_deg_start && (long)bodies.size() < MAXNUTTERANCES)
        bodies.push_back({this_start, count});
    }
  }
  long n = std::min((long)bodies.size(), n_utt);
  utts.resize(n);
  if (!n) return;
  for (long i = 0; i < n; i++) {
    utts[i].start_w = bodies[i].first;
    utts[i].end_w = bodies[i].second;
  }
  utts[0].start_w = SEARCHBUFFER;
  utts[n - 1].end_w = vad_length - SEARCHBUFFER;
  for (long u = 1; u < n; u++) {
    long ts = utts[u].start_w * P862_DOWNSAMPLE;
    long le = utts[u - 1].end_w * P862_DOWNSAMPLE;
    long mid = (ts + le) / 2;
    utts[u].start_w = mid / P862_DOWNSAMPLE;
    utts[u - 1].end_w = mid / P862_DOWNSAMPLE;
  }
  long first = utts[0].start_w * P862_DOWNSAMPLE + utts[0].delay;
  if (first < SEARCHBUFFER * P862_DOWNSAMPLE)
    utts[0].start_w = SEARCHBUFFER + (P862_DOWNSAMPLE - 1 - utts[0].delay) /
                                         P862_DOWNSAMPLE;
  long last = utts[n - 1].end_w * P862_DOWNSAMPLE + utts[n - 1].delay;
  if (last > nd - SEARCHBUFFER * P862_DOWNSAMPLE)
    utts[n - 1].end_w =
        (nd - utts[n - 1].delay) / P862_DOWNSAMPLE - SEARCHBUFFER;
  for (long u = 1; u < n; u++) {
    long ts = utts[u].start_w * P862_DOWNSAMPLE + utts[u].delay;
    long le = utts[u - 1].end_w * P862_DOWNSAMPLE + utts[u - 1].delay;
    if (ts < le) {
      long mid = (ts + le) / 2;
      utts[u].start_w =
          (mid + (P862_DOWNSAMPLE - 1) - utts[u].delay) / P862_DOWNSAMPLE;
      utts[u - 1].end_w = (mid - utts[u - 1].delay) / P862_DOWNSAMPLE;
    }
  }
}

// P.862 split_align: best break point splitting an utterance in two.
void split_align(const std::vector<double>& ref, const std::vector<double>& deg,
                 const std::vector<double>& lv_ref,
                 const std::vector<double>& lv_deg, long /*nr*/, long nd,
                 long utt_start, long speech_start, long speech_end,
                 long utt_end, long delay_est, double conf, long* ed1,
                 long* d1, double* dc1, long* ed2, long* d2, double* dc2,
                 long* best_bp, TACache* cache) {
  // Candidate grid and acceptance per the Recommendation: break points
  // start at speech_start + max(len/10, SEARCHBUFFER) with the first
  // candidate always evaluated (at most 41); a candidate qualifies only
  // when the halves' delays differ by at least one downsample window and
  // both confidences beat the whole utterance's; the winner maximises the
  // SUM of the two confidences.
  const long utt_len = speech_end - speech_start;
  const long pad = std::max(utt_len / 10, SEARCHBUFFER);
  const long nd_windows = nd / P862_DOWNSAMPLE;
  long step = (long)((0.801 * (double)utt_len + 40 * 4 - 1) / (40 * 4));
  step = std::max<long>(step, 1) * 4;
  *dc1 = 0.0;
  *dc2 = 0.0;
  std::vector<long> bps;
  bps.push_back(speech_start + pad);
  while (bps.back() + step <= speech_end - pad && (long)bps.size() < 41)
    bps.push_back(bps.back() + step);
  double best_sum = 0.0;
  for (long bp : bps) {
    long e1 = crude_align_utt(lv_ref, lv_deg, nd_windows, utt_start, bp,
                              delay_est);
    long dd1;
    double cc1;
    time_align(ref, deg, nd, utt_start, bp, e1, &dd1, &cc1, cache);
    if (cc1 <= conf) continue;
    long e2 =
        crude_align_utt(lv_ref, lv_deg, nd_windows, bp, utt_end, delay_est);
    long dd2;
    double cc2;
    time_align(ref, deg, nd, bp, utt_end, e2, &dd2, &cc2, cache);
    if (cc2 <= conf) continue;
    if (std::labs(dd1 - dd2) < P862_DOWNSAMPLE) continue;
    if (cc1 + cc2 > best_sum) {
      best_sum = cc1 + cc2;
      *ed1 = e1;
      *d1 = dd1;
      *dc1 = cc1;
      *ed2 = e2;
      *d2 = dd2;
      *dc2 = cc2;
      *best_bp = bp;
    }
  }
}

// Full P.862 utterance chain on the ALIGNMENT-path signals.
std::vector<Utt> utterance_locate(const std::vector<double>& ref,
                                  const std::vector<double>& deg,
                                  const std::vector<double>& vad_ref,
                                  const std::vector<double>& lv_ref,
                                  const std::vector<double>& lv_deg, long nr,
                                  long nd) {
  long crude = crude_align_whole(lv_ref, lv_deg);
  TACache cache;
  std::vector<std::pair<long, long>> wins;
  id_searchwindows(vad_ref, nr, nd, crude, wins);
  std::vector<Utt> utts;
  if (wins.empty()) {
    Utt u;
    u.start_w = SEARCHBUFFER;
    u.end_w = nr / P862_DOWNSAMPLE - SEARCHBUFFER;
    u.delay = crude;
    u.delay_est = crude;
    u.conf = 0.0;
    utts.push_back(u);
    return utts;
  }
  const long nd_windows = nd / P862_DOWNSAMPLE;
  for (auto& w : wins) {
    Utt u;
    u.delay_est =
        crude_align_utt(lv_ref, lv_deg, nd_windows, w.first, w.second, crude);
    time_align(ref, deg, nd, w.first, w.second, u.delay_est, &u.delay,
               &u.conf, &cache);
    u.start_w = w.first;
    u.end_w = w.second;
    utts.push_back(u);
  }
  id_utterances(vad_ref, nr, nd, utts);

  const long vad_length = nr / P862_DOWNSAMPLE;
  long u = 0;
  while (u < (long)utts.size() && (long)utts.size() <= MAXNUTTERANCES) {
    long start_w = utts[u].start_w, end_w = utts[u].end_w;
    long speech_start = start_w;
    while (speech_start < end_w && vad_ref[speech_start] <= 0.0) speech_start++;
    long speech_end = end_w;
    while (speech_end > start_w &&
           vad_ref[std::min(speech_end, vad_length - 1)] <= 0.0)
      speech_end--;
    speech_end++;
    if (speech_end - speech_start >= MIN_SPLIT_LEN &&
        (long)utts.size() < MAXNUTTERANCES) {
      long ed1 = 0, d1 = 0, ed2 = 0, d2 = 0, bp = 0;
      double dc1 = 0, dc2 = 0;
      split_align(ref, deg, lv_ref, lv_deg, nr, nd, start_w, speech_start,
                  speech_end, end_w, utts[u].delay_est, utts[u].conf, &ed1,
                  &d1, &dc1, &ed2, &d2, &dc2, &bp, &cache);
      if (dc1 > utts[u].conf && dc2 > utts[u].conf) {
        long end1, start2;
        if (d2 < d1) {
          end1 = bp;
          start2 = bp;
        } else {
          long spread = (d2 - d1) / (2 * P862_DOWNSAMPLE);
          end1 = bp + spread;
          start2 = bp - spread;
        }
        // post-split boundary clamps (P.862 utterance_split): keep the
        // first piece's deg start and the second piece's deg end inside
        // the degraded buffer
        long new_start = start_w, new_end = end_w;
        if ((new_start - SEARCHBUFFER) * P862_DOWNSAMPLE + d1 < 0)
          new_start =
              SEARCHBUFFER + (P862_DOWNSAMPLE - 1 - d1) / P862_DOWNSAMPLE;
        if (new_end * P862_DOWNSAMPLE + d2 >
            nd - SEARCHBUFFER * P862_DOWNSAMPLE)
          new_end = (nd - d2) / P862_DOWNSAMPLE - SEARCHBUFFER;
        utts[u].start_w = new_start;
        Utt second;
        second.start_w = start2;
        second.end_w = new_end;
        second.delay = d2;
        second.delay_est = ed2;
        second.conf = dc2;
        utts[u].end_w = end1;
        utts[u].delay = d1;
        utts[u].delay_est = ed1;
        utts[u].conf = dc1;
        utts.insert(utts.begin() + u + 1, second);
        continue;  // re-examine the first piece
      }
    }
    u++;
  }
  return utts;
}

// P.862 compute_delay on rectified series.
long compute_delay(const double* t1, const double* t2, long start, long stop,
                   long search, double* best_corr) {
  const long n = stop - start;
  const long pow2 = next_pow2(2 * search + n);
  double e1 = 0, e2 = 0;
  for (long i = start; i < stop; i++) {
    e1 += t1[i] * t1[i];
    e2 += t2[i] * t2[i];
  }
  double norm = std::sqrt(e1 * e2);
  if (norm <= 0) {
    *best_corr = 0.0;
    return 0;
  }
  std::vector<double> x1(pow2, 0.0), x2(pow2, 0.0);
  for (long i = 0; i < n; i++) {
    x1[i] = std::fabs(t1[start + i]);
    x2[i] = std::fabs(t2[start + i]);
  }
  auto X1 = rfft(x1.data(), pow2, pow2);
  auto X2 = rfft(x2.data(), pow2, pow2);
  std::vector<std::complex<double>> prod(X1.size());
  for (size_t k = 0; k < X1.size(); k++) prod[k] = std::conj(X1[k]) * X2[k];
  auto corr = irfft(prod, pow2);
  long best_lag = -search;
  double bv = -1e300;
  for (long lag = -search; lag <= search; lag++) {
    double v = corr[((lag % pow2) + pow2) % pow2];
    if (v > bv) {
      bv = v;
      best_lag = lag;
    }
  }
  *best_corr = bv / norm;
  return best_lag;
}

// ---- psychoacoustic model --------------------------------------------------

void short_term_spec(const std::vector<double>& data,
                     const std::vector<double>& w, long start, double* hz) {
  std::vector<std::complex<double>> a(NF);
  for (long i = 0; i < NF; i++) a[i] = {data[start + i] * w[i], 0.0};
  fft(a, false);
  for (long k = 0; k < NF / 2; k++)
    hz[k] = a[k].real() * a[k].real() + a[k].imag() * a[k].imag();
}

void freq_warping(const double* hz, double* bands) {
  int hz_band = 0;
  for (int b = 0; b < P862_NB; b++) {
    double s = 0.0;
    for (int j = 0; j < P862_NR_OF_HZ_BANDS[b]; j++) s += hz[hz_band++];
    bands[b] = s * P862_POW_DENS_CORRECTION[b] * SP;
  }
}

double total_audible(const double* bands, double factor) {
  double t = 0.0;
  for (int b = 1; b < P862_NB; b++) {
    if (bands[b] > factor * P862_ABS_THRESH_POWER[b]) t += bands[b];
  }
  return t;
}

void intensity_warping(const double* bands, double* loud) {
  for (int b = 0; b < P862_NB; b++) {
    double h = P862_CENTRE_OF_BAND_BARK[b] < 4.0
                   ? 6.0 / (P862_CENTRE_OF_BAND_BARK[b] + 2.0)
                   : 1.0;
    h = std::pow(std::min(h, 2.0), 0.15);
    double z = 0.23 * h;
    double t = P862_ABS_THRESH_POWER[b];
    if (bands[b] > t) {
      double l = SL * std::pow(t / 0.5, z) *
                 (std::pow(0.5 + 0.5 * bands[b] / t, z) - 1.0);
      loud[b] = std::max(l, 0.0);
    } else {
      loud[b] = 0.0;
    }
  }
}

double pseudo_lp(const double* d, double p) {
  double total_w = 0.0, res = 0.0;
  for (int b = 1; b < P862_NB; b++) {
    double h = std::fabs(d[b]) * P862_WIDTH_OF_BAND_BARK[b];
    res += std::pow(h, p);
    total_w += P862_WIDTH_OF_BAND_BARK[b];
  }
  return std::pow(res / total_w, 1.0 / p) * total_w;
}

// Raw disturbance of one frame inside a bad interval.  ta_ref is the
// frame's stored compensated-reference total audible power from the main
// pass; the short-term gain uses the P.862 0.2/0.8 smoothing carried
// across the interval (*old_scale in/out, stored pre-clamp).
void frame_disturbances(const double* ppd_ref_row, const double* ppd_deg_row,
                        const double* comp_x, double ta_ref,
                        double* old_scale, double* out_fd,
                        double* out_fda) {
  double mod_ref[64], mod_deg[64], loud_r[64], loud_d[64], d[64];
  for (int b = 0; b < P862_NB; b++) mod_ref[b] = ppd_ref_row[b] * comp_x[b];
  double ta_d = total_audible(ppd_deg_row, 1.0);
  double s = 0.2 * *old_scale + 0.8 * (ta_ref + 5e3) / (ta_d + 5e3);
  *old_scale = s;
  double scale = std::min(std::max(s, 3e-4), 5.0);
  for (int b = 0; b < P862_NB; b++) mod_deg[b] = ppd_deg_row[b] * scale;
  intensity_warping(mod_ref, loud_r);
  intensity_warping(mod_deg, loud_d);
  for (int b = 0; b < P862_NB; b++) {
    double dd = loud_d[b] - loud_r[b];
    double m = 0.25 * std::min(loud_d[b], loud_r[b]);
    if (dd > m)
      dd -= m;
    else if (dd < -m)
      dd += m;
    else
      dd = 0.0;
    d[b] = dd;
  }
  *out_fd = pseudo_lp(d, 2.0);
  for (int b = 0; b < P862_NB; b++) {
    double ratio = std::pow((mod_deg[b] + 50.0) / (mod_ref[b] + 50.0), 1.2);
    double asym = ratio < 3.0 ? 0.0 : std::min(ratio, 12.0);
    d[b] *= asym;
  }
  *out_fda = pseudo_lp(d, 1.0);
}

// P.862 Lpq_weight over frames [start_frame, stop_frame] inclusive.
double lpq_weight(const std::vector<double>& fd, long start_frame,
                  long stop_frame) {
  const long SYL = 20;
  double result_time = 0.0, total_w = 0.0;
  for (long start = start_frame; start <= stop_frame; start += SYL / 2) {
    double r = 0.0;
    long end = std::min(start + SYL, stop_frame + 1);
    if (end <= start) continue;
    for (long f = start; f < end; f++) r += std::pow(fd[f], 6.0);
    r = std::pow(r / (double)SYL, 1.0 / 6.0);
    result_time += r * r;
    total_w += 1.0;
  }
  return std::sqrt(result_time / total_w);
}

double psychoacoustic_model(const std::vector<double>& ref,
                            const std::vector<double>& deg, long max_n,
                            long nd, const std::vector<Utt>& utts) {
  const long buf = SEARCHBUFFER * P862_DOWNSAMPLE;

  // leading/trailing silence scans (sum of 5 |samples| >= 500)
  long skip_start = 0;
  const long limit = max_n / 2;
  while (skip_start < limit) {
    double s5 = 0.0;
    for (int i = 0; i < 5; i++)
      s5 += std::fabs(ref[buf + skip_start + i]);
    if (s5 >= CRIT_SILENCE_5) break;
    skip_start++;
  }
  const long anchor = max_n - buf + dp_samples() - 1;
  long skip_end = 0;
  while (skip_end < limit) {
    long lo = anchor - skip_end - 4;
    if (lo < 0) break;
    double s5 = 0.0;
    for (int i = 0; i < 5; i++) s5 += std::fabs(ref[lo + i]);
    if (s5 >= CRIT_SILENCE_5) break;
    skip_end++;
  }
  const long start_frame = skip_start / (NF / 2);
  const long n_frames =
      (max_n - 2 * buf + dp_samples() - skip_end) / (NF / 2);

  std::vector<double> w(NF);
  for (long i = 0; i < NF; i++)
    w[i] = 0.5 * (1.0 - std::cos(2.0 * M_PI * (double)i / (double)NF));

  // per-frame delay from the utterance table
  std::vector<long> fdel(n_frames);
  for (long f = 0; f < n_frames; f++) {
    long sr = buf + f * (NF / 2);
    long u = (long)utts.size() - 1;
    while (u >= 0 && utts[u].start_w * P862_DOWNSAMPLE > sr) u--;
    fdel[f] = utts[std::max<long>(u, 0)].delay;
  }

  std::vector<double> ppd_ref(n_frames * P862_NB), ppd_deg(n_frames * P862_NB);
  std::vector<double> hz(NF / 2);
  std::vector<char> silent(n_frames);
  const long dlim = max_n + dp_samples();
  for (long f = 0; f < n_frames; f++) {
    long sr = buf + f * (NF / 2);
    short_term_spec(ref, w, sr, hz.data());
    freq_warping(hz.data(), &ppd_ref[f * P862_NB]);
    long sd = sr + fdel[f];
    if (sd > 0 && sd + NF < dlim) {
      short_term_spec(deg, w, sd, hz.data());
      freq_warping(hz.data(), &ppd_deg[f * P862_NB]);
    } else {
      std::fill(&ppd_deg[f * P862_NB], &ppd_deg[(f + 1) * P862_NB], 0.0);
    }
    silent[f] = total_audible(&ppd_ref[f * P862_NB], 1e2) < 1e7;
  }

  // time-averaged audible spectra; divisor = (maxN-2buf+dp)/(Nf/2) - 1
  const long n_total = (max_n - 2 * buf + dp_samples()) / (NF / 2) - 1;
  std::vector<double> avg_ref(P862_NB, 0.0), avg_deg(P862_NB, 0.0);
  for (long f = 0; f < n_frames; f++) {
    if (silent[f]) continue;
    for (int b = 0; b < P862_NB; b++) {
      double r = ppd_ref[f * P862_NB + b];
      double d = ppd_deg[f * P862_NB + b];
      if (r > 100.0 * P862_ABS_THRESH_POWER[b]) avg_ref[b] += r;
      if (d > 100.0 * P862_ABS_THRESH_POWER[b]) avg_deg[b] += d;
    }
  }
  std::vector<double> comp_x(P862_NB);
  for (int b = 0; b < P862_NB; b++) {
    avg_ref[b] /= (double)n_total;
    avg_deg[b] /= (double)n_total;
    comp_x[b] = std::min(
        std::max((avg_deg[b] + 1000.0) / (avg_ref[b] + 1000.0), 0.01), 100.0);
  }
  std::vector<double> mod_ref(ppd_ref);
  for (long f = 0; f < n_frames; f++)
    for (int b = 0; b < P862_NB; b++) mod_ref[f * P862_NB + b] *= comp_x[b];

  // short-term gain compensation applied to deg
  std::vector<double> ta_ref(n_frames), scale(n_frames);
  double old_scale = 1.0;
  std::vector<double> mod_deg(ppd_deg);
  for (long f = 0; f < n_frames; f++) {
    double tr = total_audible(&mod_ref[f * P862_NB], 1.0);
    double td = total_audible(&ppd_deg[f * P862_NB], 1.0);
    ta_ref[f] = tr;
    double s = (tr + 5e3) / (td + 5e3);
    if (f > 0) s = 0.2 * old_scale + 0.8 * s;
    old_scale = s;
    s = std::min(std::max(s, 3e-4), 5.0);
    scale[f] = s;
    for (int b = 0; b < P862_NB; b++) mod_deg[f * P862_NB + b] *= s;
  }

  std::vector<double> fd(n_frames), fda(n_frames);
  std::vector<double> loud_r(P862_NB), loud_d(P862_NB), d(P862_NB);
  for (long f = 0; f < n_frames; f++) {
    intensity_warping(&mod_ref[f * P862_NB], loud_r.data());
    intensity_warping(&mod_deg[f * P862_NB], loud_d.data());
    for (int b = 0; b < P862_NB; b++) {
      double dd = loud_d[b] - loud_r[b];
      double m = 0.25 * std::min(loud_d[b], loud_r[b]);
      if (dd > m)
        dd -= m;
      else if (dd < -m)
        dd += m;
      else
        dd = 0.0;
      d[b] = dd;
    }
    fd[f] = pseudo_lp(d.data(), 2.0);
    for (int b = 0; b < P862_NB; b++) {
      double ratio = std::pow(
          (mod_deg[f * P862_NB + b] + 50.0) / (mod_ref[f * P862_NB + b] + 50.0),
          1.2);
      double asym = ratio < 3.0 ? 0.0 : std::min(ratio, 12.0);
      d[b] *= asym;
    }
    fda[f] = pseudo_lp(d.data(), 1.0);
  }

  // signal-repetition amnesty on delay decreases > Nf/2: the overlapped
  // frames' disturbances are zeroed (the Recommendation's per-frame flag
  // array is write-only — it never feeds the bad-interval detection); the
  // frame loop excludes the last frame
  for (long u = 1; u < (long)utts.size(); u++) {
    long jump = utts[u].delay - utts[u - 1].delay;
    if (jump >= -(NF / 2)) continue;
    long sf_next = div_trunc(
        (utts[u].start_w - SEARCHBUFFER) * P862_DOWNSAMPLE + utts[u].delay,
        NF / 2);
    long sf_prev = div_trunc((utts[u - 1].end_w - SEARCHBUFFER) *
                                     P862_DOWNSAMPLE +
                                 utts[u - 1].delay,
                             NF / 2);
    long lo = std::max<long>(0, std::min(sf_next, sf_prev));
    long hi = div_trunc((utts[u].start_w - SEARCHBUFFER) * P862_DOWNSAMPLE +
                            std::labs(jump),
                        NF / 2) +
              1;
    for (long fr = lo; fr <= hi && fr < n_frames - 1; fr++) {
      fd[fr] = 0.0;
      fda[fr] = 0.0;
    }
  }

  // bad-interval reprocessing
  bool any_bad = false;
  std::vector<char> bad(n_frames);
  for (long f = 0; f < n_frames; f++) {
    bad[f] = fd[f] > THRESHOLD_BAD_FRAMES;
    any_bad |= bad[f];
  }
  if (any_bad) {
    // smear over [SMEAR_RANGE, stop_frame - SMEAR_RANGE)
    std::vector<char> smeared(n_frames, 0);
    for (long f = SMEAR_RANGE; f < n_frames - 1 - SMEAR_RANGE; f++) {
      bool left = false, right = false;
      for (long i = f - SMEAR_RANGE; i <= f; i++) left |= bad[i];
      for (long i = f; i <= f + SMEAR_RANGE; i++) right |= bad[i];
      smeared[f] = left && right;
    }
    const long hop = NF / 2;
    const long fill_hi = max_n + dp_samples() - buf;  // fill spans padding
    // full-length per-sample retimed degraded copy: zeros outside
    // [buf, maxN + dp - buf); each sample takes the delay of the last
    // utterance whose start is at or before it
    std::vector<double> tweaked(max_n + dp_samples(), 0.0);
    for (long i = buf; i < fill_hi; i++) {
      long u = (long)utts.size() - 1;
      while (u >= 0 && utts[u].start_w * P862_DOWNSAMPLE > i) u--;
      long delay = utts[std::max<long>(u, 0)].delay;
      long j = std::min(std::max(i + delay, buf), fill_hi - 1);
      tweaked[i] = deg[j];
    }
    long f = 0;
    while (f < n_frames) {
      if (!smeared[f]) {
        f++;
        continue;
      }
      long g = f;
      while (g < n_frames && smeared[g]) g++;
      if (g - f >= MIN_BAD_INTERVAL) {
        // sample span per P.862: start frame inclusive, stop frame
        // exclusive (one hop past the last bad window)
        long s0 = f * hop + buf;
        long s1 = g * hop + NF + buf;
        long n = s1 - s0;
        long m = n + 2 * BAD_INTERVAL_SEARCH;
        // ref window zero-padded; deg window = clamped reads of tweaked
        std::vector<double> ref_win(m, 0.0), deg_win(m);
        for (long i = 0; i < n; i++) ref_win[BAD_INTERVAL_SEARCH + i] =
            ref[s0 + i];
        for (long i = 0; i < m; i++) {
          long idx = s0 - BAD_INTERVAL_SEARCH + i;
          deg_win[i] = tweaked[std::min(std::max(idx, buf), fill_hi - 1)];
        }
        double corr;
        long delta = compute_delay(ref_win.data(), deg_win.data(), 0, m,
                                   BAD_INTERVAL_SEARCH, &corr);
        if (corr < 0.5) delta = 0;
        // doubly-tweaked pass over frames [f, min(g, stop_frame)):
        // always runs (even at delta 0), short-term gain smoothing
        // restarted at 1.0 and carried across the interval's frames
        std::vector<double> hz_r(NF / 2), hz_d(NF / 2);
        double row_r[64], row_d[64];
        std::vector<double> dwin(NF);
        double old_scale = 1.0;
        for (long fr = f; fr < std::min(g, n_frames - 1); fr++) {
          long sr = buf + fr * hop;
          short_term_spec(ref, w, sr, hz_r.data());
          for (long i = 0; i < NF; i++) {
            long idx =
                std::min(std::max(sr + i + delta, 0L), max_n - 1);
            dwin[i] = tweaked[idx];
          }
          // windowed spectrum of the doubly-tweaked copy
          {
            std::vector<std::complex<double>> a(NF);
            for (long i = 0; i < NF; i++) a[i] = {dwin[i] * w[i], 0.0};
            fft(a, false);
            for (long k = 0; k < NF / 2; k++)
              hz_d[k] =
                  a[k].real() * a[k].real() + a[k].imag() * a[k].imag();
          }
          freq_warping(hz_r.data(), row_r);
          freq_warping(hz_d.data(), row_d);
          double nfd, nfda;
          frame_disturbances(row_r, row_d, comp_x.data(), ta_ref[fr],
                             &old_scale, &nfd, &nfda);
          fd[fr] = std::min(fd[fr], nfd);
          fda[fr] = std::min(fda[fr], nfda);
        }
      }
      f = g;
    }
  }

  // per-frame weighting and caps
  for (long f = 0; f < n_frames; f++) {
    double h = std::pow((ta_ref[f] + 1e5) / 1e7, 0.04);
    fd[f] = std::min(fd[f] / h, 45.0);
    fda[f] = std::min(fda[f] / h, 45.0);
  }
  double d_ind = lpq_weight(fd, start_frame, n_frames - 1);
  double a_ind = lpq_weight(fda, start_frame, n_frames - 1);
  return 4.5 - 0.1 * d_ind - 0.0309 * a_ind;
}

}  // namespace

extern "C" double pesq_measure_wb(const double* clean, const double* degraded,
                                  long nclean, long ndeg, long fs) {
  (void)fs;  // 16 kHz model
  // reserve extra tail so model frames over max(nr, nd) stay in range
  const long extra = std::labs(nclean - ndeg) + NF;
  Padded ref = pad_signal(clean, nclean, extra);
  Padded deg = pad_signal(degraded, ndeg, extra);
  const long nr = ref.nsamples, nd = deg.nsamples;

  fix_power_level(ref);
  fix_power_level(deg);

  // MODEL path: NO DC block — edge taper + the P.862.2 wideband input
  // filter over exactly the active region (decoded from the reference
  // binary's pesq_measure)
  static const double kWbSos[1][5] = {
      {P862_WB_IIR_SOS[0], P862_WB_IIR_SOS[1], P862_WB_IIR_SOS[2],
       P862_WB_IIR_SOS[3], P862_WB_IIR_SOS[4]}};
  taper_and_wb_filter(ref.data, nr, kWbSos);
  taper_and_wb_filter(deg.data, nd, kWbSos);

  // ALIGNMENT path: a copy gets a DC block + the standard 12-section
  // input filter over the ENTIRE buffer [0, Nsamples + datapadding);
  // VAD + all time alignment run on it
  std::vector<double> ref_a = ref.data, deg_a = deg.data;
  dc_block(ref_a, nr);
  dc_block(deg_a, nd);
  iir_sos_range(ref_a, 0, nr + dp_samples(), P862_STD_IIR_SOS,
                P862_STD_IIR_NSOS);
  iir_sos_range(deg_a, 0, nd + dp_samples(), P862_STD_IIR_SOS,
                P862_STD_IIR_NSOS);

  std::vector<double> vad_ref, lv_ref, vad_deg, lv_deg;
  apply_vad(ref_a, nr, vad_ref, lv_ref);
  apply_vad(deg_a, nd, vad_deg, lv_deg);

  auto utts = utterance_locate(ref_a, deg_a, vad_ref, lv_ref, lv_deg, nr, nd);

  const long max_n = std::max(nr, nd);
  double raw = psychoacoustic_model(ref.data, deg.data, max_n, nd, utts);
  return 0.999 + 4.0 / (1.0 + std::exp(-1.3669 * raw + 3.8224));
}
