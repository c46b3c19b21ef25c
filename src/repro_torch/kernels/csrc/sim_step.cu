// Fused sim-step kernel for the batched checkpoint-policy engine (Hopper).
//
// Replaces the TPU kernel repro/kernels/sim_step.py::_sim_step_kernel: up
// to `chunk` branchless engine steps (_attempt -> _replica_draw -> _apply,
// 4-iteration Lambert W) per cell with the carried state kept on chip.
//
// Design: one thread per cell.  The 34-double carried state lives in
// registers for the whole chunk (read once, written once); per-cell
// parameters are read from global memory; the per-step draws are read
// coalesced from a [chunk, n_draw, B] float64 array.  A warp leaves the
// step loop as soon as all of its cells are finished (__all_sync): steps
// after a cell finishes change nothing but the class-pooled variance, and
// the plain PyTorch version applies the same per-warp exit, so the two
// agree bit for bit.
//
// Bound on an H100: by the data-sheet rates the bytes it must move (24-48
// bytes of draws per cell-step, plus parameters and state once) set the
// bound at the fleet grid's shape, ahead of the few hundred FP64 operations
// per cell-step.  Measured, it runs about a hundred times above that bound:
// 10,000 cells fill about 2.4 warps per SM, so the latency of dependent
// FP64 chains and of the double-precision exp/log subroutines sets its
// time.  Neither reading is confirmed by a profile.  This first version
// keeps the work branch-light and the memory traffic minimal; some flag
// variants spill registers (see the -Xptxas -v report).
//
// Bitwise contract with PyTorch's elementwise kernels: the build uses
// -fmad=false (torch rounds after every op), every expression keeps the
// operation order of the plain version, min/max propagate NaN like
// torch.maximum/minimum/clamp, division is true division, x**2 is x*x, and
// the math functions are the CUDA double-precision library calls torch's
// kernels make (exp, log, log1p, exp2, sin, sqrt, pow, floor).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -shared -Xcompiler -fPIC (repro_torch/kernels/build.py)

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Rows of the packed [n, B] parameter array (sim_step.PARAM_ROWS).
enum ParamRow {
  P_POL, P_REGIME, P_G_PERIOD, P_G_FANOUT, P_G_WEIGHT, P_FIXED_T,
  P_PRIOR_MU, P_PRIOR_V, P_PRIOR_COUNT, P_WINDOW, P_LOG_DECAY,
  P_MIN_INTERVAL, P_MAX_INTERVAL, P_K, P_WORK, P_V, P_T_D, P_WATCH,
  P_MAX_WALL, P_T0, P_SCEN_KIND, P_TRACE_MIN_GAP, P_STORE_ON, P_R,
  P_REPAIR, P_TD_UP1, P_TD_CAP, P_TD_SRV, P_IMG_BYTES, P_HSUM_JOB,
  P_HSUM_WATCH, P_SPEED, P_STORE_MIX, P_SHOCK_RATE, P_SHOCK_PKILL,
  P_SHOCK_DWATCH, P_SHOCK_F, P_SHOCKED, P_PM_ON,
  N_PARAM_ROWS
};

// The [B, 4] tables, packed as [n, B, 4] (sim_step.TAB4).
enum Tab4 {
  T_SCEN_P, T_CLS_N, T_CLS_H, T_CLS_TD1, T_CLS_F, T_PM_NC, T_PM_RATE,
  T_PM_SHOCK,
  N_TAB4
};

// Rows of the packed [n, B] state array (sim_step.STATE_ROWS).
enum StateRow {
  S_T, S_DONE, S_IN_RESTORE, S_FINISHED, S_CENSORED, S_N_CKPT, S_N_FAIL,
  S_WASTED, S_CKPT_TIME, S_RESTORE_TIME, S_EMA_D, S_EMA_T, S_MU0,
  S_SEEN_CKPT, S_SEEN_RESTORE, S_TD_OBS, S_NEXT_G, S_N_ROUND, S_SV_BYTES,
  S_N_SRV, S_N_PEER,
  S_PM_D0, S_PM_D1, S_PM_D2, S_PM_D3,
  S_PM_T0, S_PM_T1, S_PM_T2, S_PM_T3,
  S_PM_MU00, S_PM_MU01, S_PM_MU02, S_PM_MU03,
  S_PM_V,
  N_STATE_ROWS
};

constexpr int kWarp = 32;
constexpr int kBlock = 128;
constexpr int kRMax = 8;         // repro_torch.p2p.store.R_MAX
constexpr int kPoisTerms = 16;   // engine._POIS_TERMS
constexpr double kPoisSwitch = 6.0;
constexpr double kMacroCap = 1e9;
constexpr int kLwIters = 4;
constexpr double kE = 2.718281828459045;   // math.e
constexpr double kBranch = -1.0 / kE;
constexpr double kTwoPi = 6.283185307179586;  // 2.0 * math.pi
constexpr double kTiny = 2.2250738585072014e-308;  // finfo(float64).tiny
constexpr double kC0 = -1.0, kC1 = 1.0, kC2 = -1.0 / 3.0, kC3 = 11.0 / 72.0,
                 kC4 = -43.0 / 540.0, kC5 = 769.0 / 17280.0;
constexpr int kDoubling = 1, kDiurnal = 2, kFlash = 3, kWeibull = 4,
              kTrace = 5;  // scenario kinds (CONSTANT = 0)
constexpr int kRegimeGossip = 2;

// NaN-propagating min/max (torch.maximum / torch.minimum / clamp).
__device__ __forceinline__ double nmax(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
__device__ __forceinline__ double nmin(double a, double b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}
__device__ __forceinline__ double clampd(double x, double lo, double hi) {
  return nmin(nmax(x, lo), hi);
}
__device__ __forceinline__ double b2d(bool b) { return b ? 1.0 : 0.0; }

// Lambert W0, 4 Halley iterations (repro_torch.core.lambertw.lambertw0).
__device__ double lambertw0(double z) {
  const double zc = nmax(z, kBranch);
  double w;
  if (zc < -0.25) {
    const double p = sqrt(nmax(2.0 * (kE * zc + 1.0), 0.0));
    w = kC0 + p * (kC1 + p * (kC2 + p * (kC3 + p * (kC4 + p * kC5))));
  } else if (zc < 1.0) {
    w = zc * (1.0 - zc);
  } else if (zc < 3.0) {
    w = 0.5 * log1p(zc);
  } else {
    const double logz = log(nmax(zc, 3.0));
    w = logz - log(logz);
  }
#pragma unroll 1
  for (int i = 0; i < kLwIters; ++i) {
    const double ew = exp(w);
    const double f = w * ew - zc;
    const double wp1 = w + 1.0;
    const double g = fabs(wp1) < 1e-12 ? 1e-12 : wp1;
    const double denom = ew * wp1 - (w + 2.0) * f / (2.0 * g);
    w = w - f / (fabs(denom) < kTiny ? kTiny : denom);
  }
  return zc <= kBranch ? -1.0 : w;
}

__device__ __forceinline__ double opt_interval(double mu, double k, double V,
                                               double T_d) {
  const double kmu = k * mu;
  const double arg = (V * kmu - T_d * kmu - 1.0) / (T_d * kmu + 1.0) / kE;
  const double x = lambertw0(arg) + 1.0;
  return x > 0.0 ? x / kmu : INFINITY;
}

__device__ __forceinline__ double striped(double m, double td_up1,
                                          double td_cap, double td_srv) {
  const double td_m = nmax(td_up1 / nmax(m, 1.0), td_cap);
  return m >= 1.0 ? td_m : td_srv;
}

// Mean/variance of X ~ Exp(kmu) conditioned on X < L; q = exp(-kmu L).
__device__ __forceinline__ void trunc_exp_moments(double kmu, double L,
                                                  double q, double& m,
                                                  double& v) {
  const double inv = 1.0 / kmu;
  const double ratio = q / nmax(1.0 - q, 1e-300);
  m = inv - L * ratio;
  const double ex2 = 2.0 * inv * inv - (L * L + 2.0 * L * inv) * ratio;
  v = nmax(ex2 - m * m, 0.0);
}

// Observed-death count ~ Poisson(lam), branchless inverse CDF / normal.
__device__ __forceinline__ double sample_counts(double lam, double u3,
                                                double z3) {
  const double lam_s = nmin(lam, kPoisSwitch);
  double pmf = exp(-lam_s);
  double cdf = pmf;
  double d = 0.0;
#pragma unroll 1
  for (int j = 0; j < kPoisTerms; ++j) {
    d = d + b2d(u3 > cdf);
    pmf = pmf * lam_s / (j + 1.0);
    cdf = cdf + pmf;
  }
  const double d_norm = nmax(lam + sqrt(nmax(lam, 0.0)) * z3, 0.0);
  return lam > kPoisSwitch ? d_norm : d;
}

struct Cell {
  const double* __restrict__ pf;
  const double* __restrict__ p4;
  long long B;
  long long b;
  __device__ __forceinline__ double p(int row) const {
    return __ldg(pf + row * B + b);
  }
  __device__ __forceinline__ double t4(int tab, int c) const {
    return __ldg(p4 + (tab * B + b) * 4 + c);
  }
};

__device__ double hazard(const Cell& c, double t,
                         const double* __restrict__ trace_t,
                         const double* __restrict__ trace_mtbf, int L) {
  const int kind = static_cast<int>(c.p(P_SCEN_KIND));
  const double p0 = c.t4(T_SCEN_P, 0), p1 = c.t4(T_SCEN_P, 1),
               p2 = c.t4(T_SCEN_P, 2), p3 = c.t4(T_SCEN_P, 3);
  if (kind == 0) return 1.0 / p0;
  if (kind == kDoubling) return 1.0 / nmax(p0 * exp2(-t / p1), p2);
  if (kind == kDiurnal) return (1.0 + p1 * sin(kTwoPi * (t + p3) / p2)) / p0;
  if (kind == kFlash) {
    const bool in_spike = (t >= p2) && (t < p2 + p3);
    return 1.0 / (in_spike ? p1 : p0);
  }
  if (kind == kWeibull) return 1.0 / p2;
  const double* tt = trace_t + c.b * L;
  int n = 0;
  for (int l = 0; l < L; ++l) n += (__ldg(tt + l) <= t) ? 1 : 0;
  int idx = n - 1;
  idx = idx < 0 ? 0 : (idx > L - 1 ? L - 1 : idx);
  return 1.0 / __ldg(trace_mtbf + c.b * L + idx);
}

// Endogenous restore law (engine._replica_draw).
template <bool HET, bool SHOCK>
__device__ void replica_draw(const Cell& c, double mu, double u2,
                             double kmu_bg, double srate, double& td_rest,
                             bool& from_server, double& td_expect) {
  const double repair = c.p(P_REPAIR), shock_rate = c.p(P_SHOCK_RATE);
  const double shock_f = c.p(P_SHOCK_F), R = c.p(P_R);
  const bool store_mix = c.p(P_STORE_MIX) != 0.0;
  const double A_hom = clampd(
      1.0 / (1.0 + mu * repair + (shock_rate * shock_f) * repair), 1e-12,
      1.0 - 1e-12);
  double A = A_hom;
  double td_up1 = c.p(P_TD_UP1);
  double A2_mix = 0.0, td2_mix = 0.0;
  if (HET) {
    double nA[4], nA2[4];
    const double mr = mu * repair, sr = shock_rate * repair;
    for (int k = 0; k < 4; ++k) {
      const double A_c =
          1.0 / (1.0 + mr * c.t4(T_CLS_H, k) + sr * c.t4(T_CLS_F, k));
      nA[k] = c.t4(T_CLS_N, k) * A_c;
    }
    const double sumA = nA[0] + nA[1] + nA[2] + nA[3];
    const double A_mix = clampd(sumA / nmax(R, 1.0), 1e-12, 1.0 - 1e-12);
    const double td_mix =
        sumA / nmax(nA[0] / c.t4(T_CLS_TD1, 0) + nA[1] / c.t4(T_CLS_TD1, 1) +
                        nA[2] / c.t4(T_CLS_TD1, 2) + nA[3] / c.t4(T_CLS_TD1, 3),
                    1e-300);
    if (store_mix) {
      A = A_mix;
      td_up1 = td_mix;
    }
    if (SHOCK) {
      for (int k = 0; k < 4; ++k) nA2[k] = nA[k] * (1.0 - c.t4(T_CLS_F, k));
      const double sumA2 = nA2[0] + nA2[1] + nA2[2] + nA2[3];
      A2_mix = clampd(sumA2 / nmax(R, 1.0), 0.0, 1.0 - 1e-12);
      td2_mix = sumA2 / nmax(nA2[0] / c.t4(T_CLS_TD1, 0) +
                                 nA2[1] / c.t4(T_CLS_TD1, 1) +
                                 nA2[2] / c.t4(T_CLS_TD1, 2) +
                                 nA2[3] / c.t4(T_CLS_TD1, 3),
                             1e-300);
    }
  }
  double q = 0.0, ratio_b = 0.0, pmf_b = 0.0;
  if (SHOCK) {
    q = srate / nmax(kmu_bg + srate, 1e-300);
    double A2 = A_hom * (1.0 - shock_f);
    if (HET && store_mix) {
      A2 = A2_mix;
      td_up1 = (1.0 - q) * td_up1 + q * td2_mix;
    }
    ratio_b = A2 / (1.0 - A2);
    pmf_b = pow(1.0 - A2, R);
  }
  const double ratio = A / (1.0 - A);
  double pmf_a = pow(1.0 - A, R);
  double pmf = SHOCK ? (1.0 - q) * pmf_a + q * pmf_b : pmf_a;
  double cdf = pmf;
  double m = 0.0;
  const double td_cap = c.p(P_TD_CAP), td_srv = c.p(P_TD_SRV);
  double etd = pmf * td_srv;
#pragma unroll 1
  for (int j = 0; j < kRMax; ++j) {
    m = m + b2d(u2 > cdf);
    pmf_a = nmax(pmf_a * (R - j) / (j + 1.0) * ratio, 0.0);
    if (SHOCK) {
      pmf_b = nmax(pmf_b * (R - j) / (j + 1.0) * ratio_b, 0.0);
      pmf = (1.0 - q) * pmf_a + q * pmf_b;
    } else {
      pmf = pmf_a;
    }
    cdf = cdf + pmf;
    etd = etd + pmf * striped(j + 1.0, td_up1, td_cap, td_srv);
  }
  m = nmin(m, R);
  const bool store_on = c.p(P_STORE_ON) != 0.0;
  const double T_d = c.p(P_T_D);
  td_rest = store_on ? striped(m, td_up1, td_cap, td_srv) : T_d;
  from_server = store_on && (m < 1.0);
  td_expect = store_on ? etd : T_d;
}

struct State {
  double t, done, n_ckpt, n_fail, wasted, ckpt_time, restore_time;
  double ema_d, ema_T, mu0, td_obs, next_g, n_round, sv_bytes, n_srv, n_peer;
  double pm_d[4], pm_T[4], pm_mu0[4], pm_v;
  bool in_restore, finished, censored, seen_ckpt, seen_restore;
};

// One engine step (engine._attempt + engine._apply, peer axis 1).
template <bool STORE, bool HET, bool SHOCK, bool PM>
__device__ void step(const Cell& c, State& s, double u, double z, double u2,
                     double u_pm, double z_pm0, double z_pm1,
                     double macro_threshold,
                     const double* __restrict__ hmean,
                     const double* __restrict__ sdpeer, int peer_w,
                     const double* __restrict__ trace_t,
                     const double* __restrict__ trace_mtbf, int L) {
  // ------------------------------ _attempt ------------------------------ //
  const double mu = hazard(c, s.t, trace_t, trace_mtbf, L);
  const double hsum_job = c.p(P_HSUM_JOB);
  const double kmu_bg = hsum_job * mu;
  const double srate = c.p(P_SHOCK_RATE) * c.p(P_SHOCK_PKILL);
  const double kmu = kmu_bg + srate;
  const double t0 = c.p(P_T0), max_wall = c.p(P_MAX_WALL);
  const bool active = !s.finished;
  const bool censor_now = active && (s.t - t0 > max_wall);
  const bool att = active && !censor_now;

  const double T_d = c.p(P_T_D), V = c.p(P_V), k = c.p(P_K);
  const bool store_on = c.p(P_STORE_ON) != 0.0;
  double td_rest = T_d, td_expect = T_d;
  bool from_server = store_on;
  if (STORE)
    replica_draw<HET, SHOCK>(c, mu, u2, kmu_bg, srate, td_rest, from_server,
                             td_expect);

  const double pol = c.p(P_POL);
  double interval;
  if (pol == 0.0) {
    interval = c.p(P_FIXED_T);
  } else if (pol == 1.0) {
    const double prior_count = c.p(P_PRIOR_COUNT);
    const double mu_hat =
        (s.ema_d + prior_count) / (s.ema_T + prior_count / s.mu0);
    const double V_hat = s.seen_ckpt ? V : c.p(P_PRIOR_V);
    const double td_known = store_on ? s.td_obs : T_d;
    const double Td_hat = s.seen_restore ? td_known : V_hat;
    interval = clampd(opt_interval(mu_hat, k, nmax(V_hat, 1e-6), Td_hat),
                      c.p(P_MIN_INTERVAL), c.p(P_MAX_INTERVAL));
  } else {
    const double mu_true = mu * (hsum_job / k) + srate / k;
    interval = clampd(opt_interval(mu_true, k, V, td_expect),
                      c.p(P_MIN_INTERVAL), c.p(P_MAX_INTERVAL));
  }
  interval = nmax(interval, 1e-3);

  const double work = c.p(P_WORK), speed = c.p(P_SPEED);
  const double remaining = nmax(work - s.done, 0.0);
  const double work_target = nmin(interval * speed, remaining);
  const bool is_final = work_target >= remaining;
  const double cycle_len = work_target / speed + (is_final ? 0.0 : V);
  const double attempt_len = s.in_restore ? td_rest : cycle_len;

  // ------------------------------- _apply ------------------------------- //
  const double p_surv = exp(-kmu * cycle_len);
  const double r = exp(-kmu * T_d);
  double m_a, v_a, m_r, v_r;
  trunc_exp_moments(kmu, cycle_len, p_surv, m_a, v_a);
  trunc_exp_moments(kmu, T_d, r, m_r, v_r);
  const double retries = 1.0 / nmax(r, 1e-300) - 1.0;
  const double mean_restore = T_d + retries * m_r;
  const double var_restore =
      retries * v_r + (retries / nmax(r, 1e-300)) * m_r * m_r;
  const double pair_m = m_a + mean_restore;
  const double pair_v = v_a + v_r + var_restore;
  const double M_want =
      floor(log(nmax(u, 1e-300)) / nmin(log1p(-p_surv), -1e-300));

  // Hazard coherence horizon (engine._coherence).
  const int kind = static_cast<int>(c.p(P_SCEN_KIND));
  const double p1 = c.t4(T_SCEN_P, 1), p2 = c.t4(T_SCEN_P, 2),
               p3 = c.t4(T_SCEN_P, 3);
  double coh;
  if (kind == kDoubling) {
    coh = p1 / 8.0;
  } else if (kind == kDiurnal) {
    coh = p2 / 32.0;
  } else if (kind == kFlash) {
    coh = s.t < p2 ? p2 - s.t : (s.t < p2 + p3 ? p2 + p3 - s.t : INFINITY);
  } else if (kind == kTrace) {
    coh = c.p(P_TRACE_MIN_GAP) / 4.0;
  } else {
    coh = INFINITY;
  }
  double horizon = nmin(coh, 0.5 * (t0 + max_wall - s.t) + pair_m);
  horizon = nmin(horizon, pol == 1.0 ? c.p(P_WINDOW) /
                                           nmax(c.p(P_HSUM_WATCH) * mu, 1e-300)
                                     : INFINITY);
  const double M_cap = floor(horizon / nmax(pair_m, 1e-300));
  const double M = clampd(nmin(M_want, M_cap), 0.0, kMacroCap);
  const bool macro = att && !s.in_restore && !store_on &&
                     !(c.p(P_SHOCKED) != 0.0) && (p_surv < macro_threshold) &&
                     isfinite(kmu) && (kmu > 0.0) && (M >= 1.0);
  const bool capped = macro && (M < M_want);
  const bool m_ok = macro && !capped;
  const double burst = nmax(M * pair_m + z * sqrt(M * pair_v), 0.0);
  const double burst_waste = nmin(M * m_a, burst);

  const bool reg = att && !macro;
  const double t_fail = -log1p(-u) / kmu;
  const bool fail = t_fail < attempt_len;
  const double dt = reg ? nmin(t_fail, attempt_len) : 0.0;
  const bool ws = reg && !s.in_restore && !fail;
  const bool wf = reg && !s.in_restore && fail;
  const bool rs = reg && s.in_restore && !fail;
  const bool rf = reg && s.in_restore && fail;
  const bool interior = (ws || m_ok) && !is_final;

  const double inc =
      ws ? cycle_len
         : ((wf || rf) ? dt
                       : (rs ? td_rest
                             : (macro ? burst + (m_ok ? cycle_len : 0.0)
                                      : 0.0)));
  const double t_new = s.t + inc;
  if (ws || m_ok) s.done = is_final ? work : s.done + work_target;
  s.n_ckpt = s.n_ckpt + b2d(interior);
  s.ckpt_time = s.ckpt_time + (interior ? V : 0.0);
  s.n_fail = s.n_fail + b2d(wf) + (macro ? M : 0.0);
  s.wasted = s.wasted + (wf ? dt : 0.0) + (macro ? burst_waste : 0.0);
  s.restore_time = s.restore_time + (rf ? dt : (rs ? td_rest : 0.0)) +
                   (macro ? burst - burst_waste : 0.0);
  s.in_restore = (s.in_restore || wf) && !rs;
  const bool finished = s.finished || censor_now || ((ws || m_ok) && is_final);
  s.censored = s.censored || censor_now;
  s.seen_ckpt = s.seen_ckpt || interior;
  s.seen_restore = s.seen_restore || rs || m_ok || capped;
  if (rs) s.td_obs = td_rest;
  const double R = c.p(P_R), img = c.p(P_IMG_BYTES);
  const bool srv_ckpt = interior && store_on && (R < 1.0);
  const bool srv_rest = rs && from_server;
  const bool srv_part = rf && from_server;
  const double frac = srv_part ? dt / nmax(td_rest, 1e-300) : 0.0;
  s.sv_bytes = s.sv_bytes + ((srv_ckpt || srv_rest) ? img : 0.0) + frac * img;
  s.n_srv = s.n_srv + b2d(srv_rest);
  s.n_peer = s.n_peer + b2d(rs && store_on && !from_server);

  // Pooled estimator: expectation feed into the decision row.
  const double elapsed = t_new - s.t;
  const double shock_rate = c.p(P_SHOCK_RATE);
  const double log_decay = c.p(P_LOG_DECAY);
  const double d =
      (c.p(P_HSUM_WATCH) * mu + shock_rate * c.p(P_SHOCK_DWATCH)) * elapsed;
  const double expo = c.p(P_WATCH) * elapsed;
  const double beta = exp(d * log_decay);
  const double ema_d_pooled = s.ema_d * beta + d;
  const double ema_T_pooled = s.ema_T * beta + expo;

  if (PM && c.p(P_PM_ON) != 0.0) {
    // Class-pooled form (engine._pool_update), from the pre-step state.
    const double a = c.p(P_PRIOR_COUNT);
    const double kk = k;
    const double share = c.p(P_WATCH) / kk;
    const double kw = nmax(kk - 1.0, 1.0);
    double nw[4];
    for (int j = 0; j < 4; ++j) nw[j] = c.t4(T_PM_NC, j) / kw;

    const double lam0 = (share * __ldg(hmean + c.b * peer_w) * mu +
                         shock_rate * __ldg(sdpeer + c.b * peer_w)) *
                        elapsed;
    const double d0 = sample_counts(lam0, u_pm, z_pm0);
    const double beta0 = exp(d0 * log_decay);
    double ema_d0 = s.ema_d * beta0 + d0;
    double ema_T0 = s.ema_T * beta0 + share * elapsed;

    double lam_c[4], beta_c[4], pm_d[4], pm_T[4];
    for (int j = 0; j < 4; ++j) {
      lam_c[j] = (share * c.t4(T_PM_RATE, j) * mu +
                  shock_rate * c.t4(T_PM_SHOCK, j)) *
                 elapsed;
      beta_c[j] = exp(lam_c[j] * log_decay);
      pm_d[j] = s.pm_d[j] * beta_c[j] + lam_c[j];
      pm_T[j] = s.pm_T[j] * beta_c[j] + share * elapsed;
    }
    double den_old = 0.0, den_new = 0.0, lam_bar = 0.0, beta_bar = 0.0;
    double t_old[4], t_new4[4], t_lam[4], t_beta[4];
    for (int j = 0; j < 4; ++j) {
      t_old[j] = nw[j] * (s.pm_T[j] + a / s.pm_mu0[j]);
      t_new4[j] = nw[j] * (pm_T[j] + a / s.pm_mu0[j]);
      t_lam[j] = nw[j] * lam_c[j];
      t_beta[j] = nw[j] * beta_c[j];
    }
    den_old = t_old[0] + t_old[1] + t_old[2] + t_old[3];
    den_new = t_new4[0] + t_new4[1] + t_new4[2] + t_new4[3];
    lam_bar = t_lam[0] + t_lam[1] + t_lam[2] + t_lam[3];
    beta_bar = t_beta[0] + t_beta[1] + t_beta[2] + t_beta[3];
    const double dn = nmax(den_new, 1e-300);
    double pm_v = (beta_bar * beta_bar * s.pm_v * (den_old * den_old) +
                   lam_bar) /
                  (dn * dn);

    const bool due = (c.p(P_REGIME) == kRegimeGossip) && !finished &&
                     (t_new >= s.next_g);
    const double mu_hat0 = (ema_d0 + a) / (ema_T0 + a / s.mu0);
    double mu_c[4], t_mu[4];
    for (int j = 0; j < 4; ++j) {
      mu_c[j] = (pm_d[j] + a) / (pm_T[j] + a / s.pm_mu0[j]);
      t_mu[j] = nw[j] * mu_c[j];
    }
    const double mbar = t_mu[0] + t_mu[1] + t_mu[2] + t_mu[3];
    const double N = kw;
    const double fanout = c.p(P_G_FANOUT);
    const double fpc = nmax(N - fanout, 0.0) / (nmax(N - 1.0, 1.0) * fanout);
    const double w = c.p(P_G_WEIGHT);
    if (due) {
      const double rem0 = mbar + z_pm1 * sqrt(nmax(pm_v, 0.0) * fpc);
      const double merged0 = (1.0 - w) * mu_hat0 + w * nmax(rem0, 1e-300);
      const double mall = (mu_hat0 + (kk - 1.0) * mbar) / nmax(kk, 1.0);
      const double w1 = 1.0 - w;
      const double contract = w1 * w1 + w * w * fpc;
      ema_d0 = 0.0;
      ema_T0 = 0.0;
      s.mu0 = merged0;
      for (int j = 0; j < 4; ++j) {
        pm_d[j] = 0.0;
        pm_T[j] = 0.0;
        s.pm_mu0[j] = w1 * mu_c[j] + w * mall;
      }
      pm_v = contract * pm_v;
      s.next_g = t_new + c.p(P_G_PERIOD);
    }
    s.ema_d = ema_d0;
    s.ema_T = ema_T0;
    for (int j = 0; j < 4; ++j) {
      s.pm_d[j] = pm_d[j];
      s.pm_T[j] = pm_T[j];
    }
    s.pm_v = pm_v;
    s.n_round = s.n_round + b2d(due);
  } else {
    s.ema_d = ema_d_pooled;
    s.ema_T = ema_T_pooled;
  }
  s.t = t_new;
  s.finished = finished;
}

template <bool STORE, bool HET, bool SHOCK, bool PM>
__global__ void __launch_bounds__(kBlock)
sim_step_kernel(const double* __restrict__ pf, const double* __restrict__ p4,
                const double* __restrict__ hmean,
                const double* __restrict__ sdpeer, int peer_w,
                const double* __restrict__ trace_t,
                const double* __restrict__ trace_mtbf, int L,
                double* __restrict__ st, const double* __restrict__ draws,
                int* __restrict__ taken, long long B, int chunk, int n_draw,
                double macro_threshold) {
  const long long b = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  const bool valid = b < B;
  Cell c{pf, p4, B, valid ? b : 0};
  State s;
  if (valid) {
    auto ld = [&](int row) { return st[row * B + b]; };
    s.t = ld(S_T);
    s.done = ld(S_DONE);
    s.in_restore = ld(S_IN_RESTORE) != 0.0;
    s.finished = ld(S_FINISHED) != 0.0;
    s.censored = ld(S_CENSORED) != 0.0;
    s.n_ckpt = ld(S_N_CKPT);
    s.n_fail = ld(S_N_FAIL);
    s.wasted = ld(S_WASTED);
    s.ckpt_time = ld(S_CKPT_TIME);
    s.restore_time = ld(S_RESTORE_TIME);
    s.ema_d = ld(S_EMA_D);
    s.ema_T = ld(S_EMA_T);
    s.mu0 = ld(S_MU0);
    s.seen_ckpt = ld(S_SEEN_CKPT) != 0.0;
    s.seen_restore = ld(S_SEEN_RESTORE) != 0.0;
    s.td_obs = ld(S_TD_OBS);
    s.next_g = ld(S_NEXT_G);
    s.n_round = ld(S_N_ROUND);
    s.sv_bytes = ld(S_SV_BYTES);
    s.n_srv = ld(S_N_SRV);
    s.n_peer = ld(S_N_PEER);
    for (int j = 0; j < 4; ++j) {
      s.pm_d[j] = ld(S_PM_D0 + j);
      s.pm_T[j] = ld(S_PM_T0 + j);
      s.pm_mu0[j] = ld(S_PM_MU00 + j);
    }
    s.pm_v = ld(S_PM_V);
  } else {
    s.finished = true;  // padding lanes take part in the warp vote only
  }

  int n = 0;
#pragma unroll 1
  for (int i = 0; i < chunk; ++i) {
    if (__all_sync(0xffffffffu, s.finished)) break;
    if (valid) {
      const double* dr = draws + static_cast<long long>(i) * n_draw * B + b;
      const double u = dr[0], z = dr[B], u2 = dr[2 * B];
      double u_pm = 0.0, z0 = 0.0, z1 = 0.0;
      if (PM) {
        u_pm = dr[3 * B];
        z0 = dr[4 * B];
        z1 = dr[5 * B];
      }
      step<STORE, HET, SHOCK, PM>(c, s, u, z, u2, u_pm, z0, z1,
                                  macro_threshold, hmean, sdpeer, peer_w,
                                  trace_t, trace_mtbf, L);
    }
    ++n;
  }

  if (valid) {
    auto stv = [&](int row, double v) { st[row * B + b] = v; };
    stv(S_T, s.t);
    stv(S_DONE, s.done);
    stv(S_IN_RESTORE, b2d(s.in_restore));
    stv(S_FINISHED, b2d(s.finished));
    stv(S_CENSORED, b2d(s.censored));
    stv(S_N_CKPT, s.n_ckpt);
    stv(S_N_FAIL, s.n_fail);
    stv(S_WASTED, s.wasted);
    stv(S_CKPT_TIME, s.ckpt_time);
    stv(S_RESTORE_TIME, s.restore_time);
    stv(S_EMA_D, s.ema_d);
    stv(S_EMA_T, s.ema_T);
    stv(S_MU0, s.mu0);
    stv(S_SEEN_CKPT, b2d(s.seen_ckpt));
    stv(S_SEEN_RESTORE, b2d(s.seen_restore));
    stv(S_TD_OBS, s.td_obs);
    stv(S_NEXT_G, s.next_g);
    stv(S_N_ROUND, s.n_round);
    stv(S_SV_BYTES, s.sv_bytes);
    stv(S_N_SRV, s.n_srv);
    stv(S_N_PEER, s.n_peer);
    for (int j = 0; j < 4; ++j) {
      stv(S_PM_D0 + j, s.pm_d[j]);
      stv(S_PM_T0 + j, s.pm_T[j]);
      stv(S_PM_MU00 + j, s.pm_mu0[j]);
    }
    stv(S_PM_V, s.pm_v);
  }
  if ((threadIdx.x & (kWarp - 1)) == 0 && b < B) taken[b / kWarp] = n;
}

template <bool STORE, bool HET, bool SHOCK, bool PM>
cudaError_t launch(const double* pf, const double* p4, const double* hmean,
                   const double* sdpeer, int peer_w, const double* trace_t,
                   const double* trace_mtbf, int L, double* st,
                   const double* draws, int* taken, long long B, int chunk,
                   int n_draw, double macro_threshold, cudaStream_t stream) {
  const unsigned grid = static_cast<unsigned>((B + kBlock - 1) / kBlock);
  sim_step_kernel<STORE, HET, SHOCK, PM><<<grid, kBlock, 0, stream>>>(
      pf, p4, hmean, sdpeer, peer_w, trace_t, trace_mtbf, L, st, draws, taken,
      B, chunk, n_draw, macro_threshold);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Advance B cells by up to `chunk` steps in place on `st` ([34, B]);
// writes the steps taken per warp of 32 cells to `taken`.  Returns the
// cudaError_t of the launch (0 on success); an empty batch or chunk is
// refused with cudaErrorInvalidValue, so 0 always means a launch.
int sim_step_launch(const double* pf, const double* p4, const double* hmean,
                    const double* sdpeer, int peer_w, const double* trace_t,
                    const double* trace_mtbf, int L, double* st,
                    const double* draws, int* taken, long long B, int chunk,
                    int n_draw, double macro_threshold, int any_store,
                    int any_het, int any_shock, int any_pm, void* stream) {
  if (B <= 0 || chunk <= 0 || n_draw != (any_pm ? 6 : 3) || L < 1 ||
      peer_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = (any_store ? 8 : 0) | (any_het ? 4 : 0) |
                  (any_shock ? 2 : 0) | (any_pm ? 1 : 0);
#define SIM_STEP_CASE(K, A, H, S, P)                                         \
  case K:                                                                    \
    return static_cast<int>(launch<A, H, S, P>(                              \
        pf, p4, hmean, sdpeer, peer_w, trace_t, trace_mtbf, L, st, draws,    \
        taken, B, chunk, n_draw, macro_threshold, s));
  switch (key) {
    SIM_STEP_CASE(0, false, false, false, false)
    SIM_STEP_CASE(1, false, false, false, true)
    SIM_STEP_CASE(2, false, false, true, false)
    SIM_STEP_CASE(3, false, false, true, true)
    SIM_STEP_CASE(4, false, true, false, false)
    SIM_STEP_CASE(5, false, true, false, true)
    SIM_STEP_CASE(6, false, true, true, false)
    SIM_STEP_CASE(7, false, true, true, true)
    SIM_STEP_CASE(8, true, false, false, false)
    SIM_STEP_CASE(9, true, false, false, true)
    SIM_STEP_CASE(10, true, false, true, false)
    SIM_STEP_CASE(11, true, false, true, true)
    SIM_STEP_CASE(12, true, true, false, false)
    SIM_STEP_CASE(13, true, true, false, true)
    SIM_STEP_CASE(14, true, true, true, false)
    SIM_STEP_CASE(15, true, true, true, true)
  }
#undef SIM_STEP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sim_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
