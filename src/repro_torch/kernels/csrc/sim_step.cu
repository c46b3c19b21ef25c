// Fused sim-step kernel for the batched checkpoint-policy engine (Hopper).
//
// Replaces the TPU kernel repro/kernels/sim_step.py::_sim_step_kernel: up
// to `chunk` branchless engine steps (_attempt -> _replica_draw -> _apply,
// 4-iteration Lambert W) per cell with the carried state kept on chip.
//
// Design: one thread per cell.  The carried state lives in registers for
// the whole chunk (read once, written once).  Before the step loop each
// thread reads its cell's parameters once into its column of the block's
// shared table and computes there, with the plain version's operations in
// its order, every value that does not change across steps: per-cell
// products and quotients (shock rate x kill probability, the class-pooled
// weights, the gossip contraction) and, for a hazard that does not change
// in time (constant and Weibull scenarios), every term that depends on
// the hazard alone (the restore moments, the oracle's interval, the
// expected death rates).  Other hazards recompute those terms each step
// into the same slots.  The adaptive and the oracle policy share one
// Lambert W solve, so a warp holding both runs it once.  The draws come
// from one of two routes, picked by the draw source alone:
//   * Philox (draws.PhiloxDraws; sim_step_philox_kernel): a block of two
//     warps for 32 cells.  One warp steps the cells; the other generates
//     their next kAhead steps' draws (Philox4x32-10 with __umulhi, the
//     53-bit uniforms and Box-Muller in torch's order of operations) from
//     the seeds and the step index into a double-buffered ring in shared
//     memory while the first runs the current ones.  Nothing is read from
//     device memory for the draws, only the steps a warp runs are drawn,
//     and the generator stays off the step's dependent chain.  Batches of
//     32 cells a block also spread a batch over every SM (313 blocks for
//     the fleet grid's 10,000 cells, 7 for a Fig. 4 batch);
//   * pre-generated (draws.NumpyDraws, the parity source; sim_step_kernel):
//     blocks of kBlock = 32 threads read the draws coalesced from a
//     [chunk, n_draw, B] float64 array, one step ahead.
// A warp leaves the step loop as soon as all of its cells are finished
// (__all_sync): steps after a cell finishes change nothing but the
// class-pooled variance, and the plain PyTorch version applies the same
// per-warp exit, so the two agree bit for bit.  The Poisson count of the
// class-pooled update stops its inverse-CDF walk once the CDF passes the
// uniform: later terms cannot change the count.
//
// Bound on an H100: at the fleet grid's shape the ~500 FP64 operations per
// cell-step (the step and Box-Muller, at one instruction per lane and
// clock: -fmad=false leaves no FMA) set the bound, ahead of the Philox
// route's ~184 32-bit integer operations per cell-step (a round is two
// wide multiplies and two three-input xors) and the bytes of the
// parameters and the state.  The kernel runs far above it: a batch of
// 10,000 cells is ~2.4 warps per SM, so the latency of each cell's
// dependent FP64 chain (the Lambert W iterations, the double-precision
// exp/log subroutines and divisions) sets its time.  The design takes
// work off that chain (values computed once, draws made in the kernel, the
// early stop of the Poisson walk) and keeps every variant free of spills
// (the build's -Xptxas -v report).
//
// Bitwise contract with PyTorch's elementwise kernels: the build uses
// -fmad=false (torch rounds after every op), every expression keeps the
// operation order of the plain version, min/max propagate NaN like
// torch.maximum/minimum/clamp, division is true division, x**2 is x*x, and
// the math functions are the CUDA double-precision library calls torch's
// kernels make (exp, log, log1p, exp2, sin, cos, sqrt, pow, floor).
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

// Slots of a cell's column in the block's shared table: parameters the
// step reads, values derived from them once, and the hazard terms (K_MU
// on), which are computed once for a time-invariant hazard and each step
// otherwise.  Four consecutive slots for each per-class value.
enum Slot {
  K_FIXED_T, K_PRIOR_V, K_PRIOR_COUNT, K_MIN_IV, K_MAX_IV, K_K, K_WORK,
  K_SPEED, K_V, K_T_D, K_T0, K_MAX_WALL, K_T_END, K_WINDOW, K_LOG_DECAY,
  K_WATCH, K_HSUM_JOB, K_HSUM_WATCH, K_STORE_ON, K_SHOCKED, K_R,
  K_IMG_BYTES, K_SRATE, K_HK, K_SK, K_SDW, K_P0, K_P1, K_P2, K_P3, K_COH,
  // endogenous restore law (store cells)
  K_REPAIR, K_SFR, K_SR, K_SHOCK_F, K_TD_UP1, K_TD_CAP, K_TD_SRV,
  K_STORE_MIX, K_CLS_N, K_CLS_H = K_CLS_N + 4, K_CLS_TD1 = K_CLS_H + 4,
  K_CLS_F = K_CLS_TD1 + 4,
  // class-pooled estimator
  K_PM_ON = K_CLS_F + 4, K_GOSSIP, K_G_PERIOD, K_G_WEIGHT, K_W1, K_SHARE,
  K_FPC, K_CONTRACT, K_KM1, K_KMAX1, K_SH0, K_SS0, K_NW,
  K_SPR = K_NW + 4, K_SPS = K_SPR + 4,
  // terms of the hazard mu
  K_MU = K_SPS + 4, K_KMU_BG, K_KMU, K_INV_KMU, K_V_R, K_MEAN_RESTORE,
  K_VAR_RESTORE, K_WIN, K_D_RATE, K_IV_ORACLE, K_LAM0, K_LAM,
  N_SLOTS = K_LAM + 4
};
// A thread's column stride in doubles: odd, so that a warp's 8-byte reads
// of one slot fall in distinct banks.
constexpr int kStride = N_SLOTS | 1;

constexpr int kWarp = 32;
constexpr int kBlock = 32;     // threads a block, pre-generated route
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

// Philox4x32-10 (repro_torch.sim.draws.PhiloxDraws): round multipliers,
// Weyl key increments, the per-seed stream tags and the 53-bit scale.
constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr uint32_t kMainStream = 0x6D61696Eu;
constexpr uint32_t kPmStream = 0x706D6573u;
constexpr int kPhiloxRounds = 10;
constexpr double kInv2p53 = 1.0 / 9007199254740992.0;

struct Words {
  uint32_t w0, w1, w2, w3;
};

__device__ __forceinline__ Words philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                        uint32_t c3, uint32_t k0,
                                        uint32_t k1) {
#pragma unroll
  for (int r = 0; r < kPhiloxRounds; ++r) {
    const uint32_t hi0 = __umulhi(c0, kPhiloxM0), lo0 = c0 * kPhiloxM0;
    const uint32_t hi1 = __umulhi(c2, kPhiloxM1), lo1 = c2 * kPhiloxM1;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kPhiloxW0;
    k1 += kPhiloxW1;
  }
  return {c0, c1, c2, c3};
}

// 53-bit uniform in [0, 1) from two words (draws._u53; exact).
__device__ __forceinline__ double u53(uint32_t hi, uint32_t lo) {
  return static_cast<double>((static_cast<uint64_t>(hi) << 21) + (lo >> 11)) *
         kInv2p53;
}

// One step's draws of one cell: u, z, u2 (+ u_pm, z_pm0, z_pm1).
struct Draws {
  double u, z, u2, u_pm, z0, z1;
};

// The cell's keys: (seed lo, seed hi ^ tag) for the main and pm streams.
struct Keys {
  uint32_t k0, k1_main, k1_pm;
};

__device__ __forceinline__ Keys keys_of(long long seed) {
  const uint64_t sd = static_cast<uint64_t>(seed);
  const uint32_t hi = static_cast<uint32_t>(sd >> 32);
  return {static_cast<uint32_t>(sd), hi ^ kMainStream, hi ^ kPmStream};
}

// PhiloxDraws.next for step `step`: counter (step lo, step hi, block, 0);
// the main stream's block 0 gives (u, u2), block 1 the Box-Muller pair of
// z; the pm stream's block 0 gives (u_pm, a), block 1 b.  Box-Muller in
// torch's order of operations.
template <bool PM>
__device__ __forceinline__ Draws philox_draws(const Keys& key,
                                              uint64_t step) {
  const uint32_t c0 = static_cast<uint32_t>(step);
  const uint32_t c1 = static_cast<uint32_t>(step >> 32);
  Draws d;
  const Words m0 = philox(c0, c1, 0u, 0u, key.k0, key.k1_main);
  const Words m1 = philox(c0, c1, 1u, 0u, key.k0, key.k1_main);
  d.u = u53(m0.w0, m0.w1);
  d.u2 = u53(m0.w2, m0.w3);
  const double a = u53(m1.w0, m1.w1), b = u53(m1.w2, m1.w3);
  d.z = sqrt(-2.0 * log1p(-a)) * cos(kTwoPi * b);
  if (PM) {
    const Words q0 = philox(c0, c1, 0u, 0u, key.k0, key.k1_pm);
    const Words q1 = philox(c0, c1, 1u, 0u, key.k0, key.k1_pm);
    d.u_pm = u53(q0.w0, q0.w1);
    const double a2 = u53(q0.w2, q0.w3), b2 = u53(q1.w0, q1.w1);
    const double r = sqrt(-2.0 * log1p(-a2));
    d.z0 = r * cos(kTwoPi * b2);
    d.z1 = r * sin(kTwoPi * b2);
  } else {
    d.u_pm = d.z0 = d.z1 = 0.0;
  }
  return d;
}

// Step i's draws from a pre-generated [chunk, n_draw, B] array.
template <bool PM>
__device__ __forceinline__ Draws load_draws(const double* __restrict__ draws,
                                            int i, long long B,
                                            long long b) {
  const double* dr = draws + static_cast<long long>(i) * (PM ? 6 : 3) * B + b;
  Draws d;
  d.u = dr[0];
  d.z = dr[B];
  d.u2 = dr[2 * B];
  if (PM) {
    d.u_pm = dr[3 * B];
    d.z0 = dr[4 * B];
    d.z1 = dr[5 * B];
  } else {
    d.u_pm = d.z0 = d.z1 = 0.0;
  }
  return d;
}

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
__device__ __forceinline__ double lambertw0(double z) {
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
#pragma unroll
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

// Mean/variance of X ~ Exp(kmu) conditioned on X < L; q = exp(-kmu L);
// inv = 1 / kmu.
__device__ __forceinline__ void trunc_exp_moments(double inv, double L,
                                                  double q, double& m,
                                                  double& v) {
  const double ratio = q / nmax(1.0 - q, 1e-300);
  m = inv - L * ratio;
  const double ex2 = 2.0 * inv * inv - (L * L + 2.0 * L * inv) * ratio;
  v = nmax(ex2 - m * m, 0.0);
}

// Observed-death count ~ Poisson(lam), inverse CDF / normal.  The CDF does
// not decrease (lam_s >= 0), so once it reaches u3 no later term adds to
// the count and the walk stops; its value is not needed above the switch.
__device__ __forceinline__ double sample_counts(double lam, double u3,
                                                double z3) {
  if (lam > kPoisSwitch) return nmax(lam + sqrt(nmax(lam, 0.0)) * z3, 0.0);
  const double lam_s = nmin(lam, kPoisSwitch);
  double pmf = exp(-lam_s);
  double cdf = pmf;
  double d = 0.0;
  const bool monotone = lam_s >= 0.0;
#pragma unroll 1
  for (int j = 0; j < kPoisTerms; ++j) {
    if (monotone && !(u3 > cdf)) break;
    d = d + b2d(u3 > cdf);
    pmf = pmf * lam_s / (j + 1.0);
    cdf = cdf + pmf;
  }
  return d;
}

// Shared-memory reads and writes the compiler neither hoists nor sinks
// (plain loads could be hoisted out of the step loop into registers and
// spilled).
__device__ __forceinline__ double lds(const double* p) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];"
               : "=d"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}
__device__ __forceinline__ void sts(double* p, double v) {
  asm volatile("st.shared.f64 [%0], %1;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(p))),
               "d"(v)
               : "memory");
}

// A cell: its column of the block's shared table, the kind of its policy
// and scenario, and its trace row.
struct Cell {
  double* col;
  int pol;     // 0 fixed, 1 adaptive, 2 oracle
  int kind;    // scenario kind
  bool const_mu;
  const double* __restrict__ trace_t;
  const double* __restrict__ trace_mtbf;
  int L;
  __device__ __forceinline__ double k(int slot) const {
    return lds(col + slot);
  }
  __device__ __forceinline__ void set(int slot, double v) const {
    sts(col + slot, v);
  }
};

__device__ __forceinline__ double hazard(const Cell& c, double t) {
  const double p0 = c.k(K_P0), p1 = c.k(K_P1), p2 = c.k(K_P2),
               p3 = c.k(K_P3);
  if (c.kind == 0) return 1.0 / p0;
  if (c.kind == kDoubling) return 1.0 / nmax(p0 * exp2(-t / p1), p2);
  if (c.kind == kDiurnal)
    return (1.0 + p1 * sin(kTwoPi * (t + p3) / p2)) / p0;
  if (c.kind == kFlash) {
    const bool in_spike = (t >= p2) && (t < p2 + p3);
    return 1.0 / (in_spike ? p1 : p0);
  }
  if (c.kind == kWeibull) return 1.0 / p2;
  int n = 0;
  for (int l = 0; l < c.L; ++l) n += (__ldg(c.trace_t + l) <= t) ? 1 : 0;
  int idx = n - 1;
  idx = idx < 0 ? 0 : (idx > c.L - 1 ? c.L - 1 : idx);
  return 1.0 / __ldg(c.trace_mtbf + idx);
}

// Endogenous restore law (engine._replica_draw).
template <bool HET, bool SHOCK>
__device__ __forceinline__ void replica_draw(const Cell& c, double mu,
                                             double u2, double& td_rest,
                                             bool& from_server,
                                             double& td_expect) {
  const double repair = c.k(K_REPAIR), shock_f = c.k(K_SHOCK_F),
               R = c.k(K_R);
  const bool store_mix = c.k(K_STORE_MIX) != 0.0;
  const double A_hom =
      clampd(1.0 / (1.0 + mu * repair + c.k(K_SFR)), 1e-12, 1.0 - 1e-12);
  double A = A_hom;
  double td_up1 = c.k(K_TD_UP1);
  double A2_mix = 0.0, td2_mix = 0.0;
  if (HET) {
    double nA[4], nA2[4], td1[4];
    const double mr = mu * repair, sr = c.k(K_SR);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const double A_c =
          1.0 / (1.0 + mr * c.k(K_CLS_H + j) + sr * c.k(K_CLS_F + j));
      nA[j] = c.k(K_CLS_N + j) * A_c;
      td1[j] = c.k(K_CLS_TD1 + j);
    }
    const double sumA = nA[0] + nA[1] + nA[2] + nA[3];
    const double A_mix = clampd(sumA / nmax(R, 1.0), 1e-12, 1.0 - 1e-12);
    const double td_mix =
        sumA / nmax(nA[0] / td1[0] + nA[1] / td1[1] + nA[2] / td1[2] +
                        nA[3] / td1[3],
                    1e-300);
    if (store_mix) {
      A = A_mix;
      td_up1 = td_mix;
    }
    if (SHOCK) {
#pragma unroll
      for (int j = 0; j < 4; ++j) nA2[j] = nA[j] * (1.0 - c.k(K_CLS_F + j));
      const double sumA2 = nA2[0] + nA2[1] + nA2[2] + nA2[3];
      A2_mix = clampd(sumA2 / nmax(R, 1.0), 0.0, 1.0 - 1e-12);
      td2_mix = sumA2 / nmax(nA2[0] / td1[0] + nA2[1] / td1[1] +
                                 nA2[2] / td1[2] + nA2[3] / td1[3],
                             1e-300);
    }
  }
  double q = 0.0, ratio_b = 0.0, pmf_b = 0.0;
  if (SHOCK) {
    const double srate = c.k(K_SRATE);
    q = srate / nmax(c.k(K_KMU_BG) + srate, 1e-300);
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
  const double td_cap = c.k(K_TD_CAP), td_srv = c.k(K_TD_SRV);
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
  const bool store_on = c.k(K_STORE_ON) != 0.0;
  const double T_d = c.k(K_T_D);
  td_rest = store_on ? striped(m, td_up1, td_cap, td_srv) : T_d;
  from_server = store_on && (m < 1.0);
  td_expect = store_on ? etd : T_d;
}

// The terms that depend on the hazard mu alone, into the cell's slots.
template <bool PM>
__device__ __forceinline__ void set_mu_terms(const Cell& c, double mu) {
  const double kmu_bg = c.k(K_HSUM_JOB) * mu;
  const double kmu = kmu_bg + c.k(K_SRATE);
  const double T_d = c.k(K_T_D);
  const double inv = 1.0 / kmu;
  const double r = exp(-kmu * T_d);
  double m_r, v_r;
  trunc_exp_moments(inv, T_d, r, m_r, v_r);
  const double retries = 1.0 / nmax(r, 1e-300) - 1.0;
  const double hsum_watch = c.k(K_HSUM_WATCH);
  c.set(K_MU, mu);
  c.set(K_KMU_BG, kmu_bg);
  c.set(K_KMU, kmu);
  c.set(K_INV_KMU, inv);
  c.set(K_V_R, v_r);
  c.set(K_MEAN_RESTORE, T_d + retries * m_r);
  c.set(K_VAR_RESTORE,
        retries * v_r + (retries / nmax(r, 1e-300)) * m_r * m_r);
  c.set(K_WIN, c.k(K_WINDOW) / nmax(hsum_watch * mu, 1e-300));
  c.set(K_D_RATE, hsum_watch * mu + c.k(K_SDW));
  if (PM) {
    c.set(K_LAM0, c.k(K_SH0) * mu + c.k(K_SS0));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c.set(K_LAM + j, c.k(K_SPR + j) * mu + c.k(K_SPS + j));
  }
}

// Read the cell's parameters once and compute what does not change across
// steps (the plain version's operations, in its order).
template <bool STORE, bool HET, bool SHOCK, bool PM>
__device__ __forceinline__ void init_cell(Cell& c, const double* __restrict__ pf,
                                          const double* __restrict__ p4,
                                          const double* __restrict__ hmean,
                                          const double* __restrict__ sdpeer,
                                          int peer_w, long long B,
                                          long long b) {
  auto p = [&](int row) { return __ldg(pf + row * B + b); };
  auto t4 = [&](int tab, int j) { return __ldg(p4 + (tab * B + b) * 4 + j); };
  const double pol = p(P_POL);
  c.pol = pol == 0.0 ? 0 : (pol == 1.0 ? 1 : 2);
  c.kind = static_cast<int>(p(P_SCEN_KIND));
  c.const_mu = c.kind == 0 || c.kind == kWeibull;
  const double k = p(P_K), t0 = p(P_T0), max_wall = p(P_MAX_WALL);
  const double shock_rate = p(P_SHOCK_RATE), hsum_job = p(P_HSUM_JOB);
  const double srate = shock_rate * p(P_SHOCK_PKILL);
  c.set(K_FIXED_T, p(P_FIXED_T));
  c.set(K_PRIOR_V, p(P_PRIOR_V));
  c.set(K_PRIOR_COUNT, p(P_PRIOR_COUNT));
  c.set(K_MIN_IV, p(P_MIN_INTERVAL));
  c.set(K_MAX_IV, p(P_MAX_INTERVAL));
  c.set(K_K, k);
  c.set(K_WORK, p(P_WORK));
  c.set(K_SPEED, p(P_SPEED));
  c.set(K_V, p(P_V));
  c.set(K_T_D, p(P_T_D));
  c.set(K_T0, t0);
  c.set(K_MAX_WALL, max_wall);
  c.set(K_T_END, t0 + max_wall);
  c.set(K_WINDOW, p(P_WINDOW));
  c.set(K_LOG_DECAY, p(P_LOG_DECAY));
  c.set(K_WATCH, p(P_WATCH));
  c.set(K_HSUM_JOB, hsum_job);
  c.set(K_HSUM_WATCH, p(P_HSUM_WATCH));
  c.set(K_STORE_ON, p(P_STORE_ON));
  c.set(K_SHOCKED, p(P_SHOCKED));
  c.set(K_R, p(P_R));
  c.set(K_IMG_BYTES, p(P_IMG_BYTES));
  c.set(K_SRATE, srate);
  c.set(K_HK, hsum_job / k);
  c.set(K_SK, srate / k);
  c.set(K_SDW, shock_rate * p(P_SHOCK_DWATCH));
  const double p1 = t4(T_SCEN_P, 1), p2 = t4(T_SCEN_P, 2);
  c.set(K_P0, t4(T_SCEN_P, 0));
  c.set(K_P1, p1);
  c.set(K_P2, p2);
  c.set(K_P3, t4(T_SCEN_P, 3));
  // Hazard coherence horizon (engine._coherence); a flash crowd's depends
  // on t and is computed each step.
  c.set(K_COH, c.kind == kDoubling ? p1 / 8.0
               : c.kind == kDiurnal ? p2 / 32.0
               : c.kind == kTrace   ? p(P_TRACE_MIN_GAP) / 4.0
                                    : INFINITY);
  if (STORE) {
    const double repair = p(P_REPAIR), shock_f = p(P_SHOCK_F);
    c.set(K_REPAIR, repair);
    c.set(K_SFR, (shock_rate * shock_f) * repair);
    c.set(K_SR, shock_rate * repair);
    c.set(K_SHOCK_F, shock_f);
    c.set(K_TD_UP1, p(P_TD_UP1));
    c.set(K_TD_CAP, p(P_TD_CAP));
    c.set(K_TD_SRV, p(P_TD_SRV));
    c.set(K_STORE_MIX, p(P_STORE_MIX));
    if (HET) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c.set(K_CLS_N + j, t4(T_CLS_N, j));
        c.set(K_CLS_H + j, t4(T_CLS_H, j));
        c.set(K_CLS_TD1 + j, t4(T_CLS_TD1, j));
        c.set(K_CLS_F + j, t4(T_CLS_F, j));
      }
    }
  }
  if (PM) {
    const double share = p(P_WATCH) / k;
    const double kw = nmax(k - 1.0, 1.0);
    const double fanout = p(P_G_FANOUT), w = p(P_G_WEIGHT);
    const double fpc = nmax(kw - fanout, 0.0) / (nmax(kw - 1.0, 1.0) * fanout);
    const double w1 = 1.0 - w;
    c.set(K_PM_ON, p(P_PM_ON));
    c.set(K_GOSSIP, b2d(p(P_REGIME) == kRegimeGossip));
    c.set(K_G_PERIOD, p(P_G_PERIOD));
    c.set(K_G_WEIGHT, w);
    c.set(K_W1, w1);
    c.set(K_SHARE, share);
    c.set(K_FPC, fpc);
    c.set(K_CONTRACT, w1 * w1 + w * w * fpc);
    c.set(K_KM1, k - 1.0);
    c.set(K_KMAX1, nmax(k, 1.0));
    c.set(K_SH0, share * __ldg(hmean + b * peer_w));
    c.set(K_SS0, shock_rate * __ldg(sdpeer + b * peer_w));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c.set(K_NW + j, t4(T_PM_NC, j) / kw);
      c.set(K_SPR + j, share * t4(T_PM_RATE, j));
      c.set(K_SPS + j, shock_rate * t4(T_PM_SHOCK, j));
    }
  }
  if (c.const_mu) {
    const double mu = hazard(c, 0.0);
    set_mu_terms<PM>(c, mu);
    double td_rest, td_expect = c.k(K_T_D);
    bool from_server;
    if (STORE)
      replica_draw<HET, SHOCK>(c, mu, 0.5, td_rest, from_server, td_expect);
    c.set(K_IV_ORACLE,
          clampd(opt_interval(mu * c.k(K_HK) + c.k(K_SK), k, c.k(K_V),
                              td_expect),
                 c.k(K_MIN_IV), c.k(K_MAX_IV)));
  }
}

struct State {
  double t, done, n_ckpt, n_fail, wasted, ckpt_time, restore_time;
  double ema_d, ema_T, mu0, td_obs, next_g, n_round, sv_bytes, n_srv, n_peer;
  double pm_d[4], pm_T[4], pm_mu0[4], pm_v;
  bool in_restore, finished, censored, seen_ckpt, seen_restore;
};

// One engine step (engine._attempt + engine._apply, peer axis 1).
template <bool STORE, bool HET, bool SHOCK, bool PM>
__device__ __forceinline__ void step(const Cell& c, State& s, const Draws& d,
                                     double macro_threshold) {
  // ------------------------------ _attempt ------------------------------ //
  if (!c.const_mu) set_mu_terms<PM>(c, hazard(c, s.t));
  const double kmu = c.k(K_KMU);
  const double t0 = c.k(K_T0), max_wall = c.k(K_MAX_WALL);
  const bool active = !s.finished;
  const bool censor_now = active && (s.t - t0 > max_wall);
  const bool att = active && !censor_now;

  const double T_d = c.k(K_T_D), V = c.k(K_V);
  const bool store_on = c.k(K_STORE_ON) != 0.0;
  double td_rest = T_d, td_expect = T_d;
  bool from_server = store_on;
  if (STORE)
    replica_draw<HET, SHOCK>(c, c.k(K_MU), d.u2, td_rest, from_server,
                             td_expect);

  // The adaptive and the oracle policy share one Lambert W solve, so a
  // warp that holds both runs it once.
  double interval;
  if (c.pol == 0) {
    interval = c.k(K_FIXED_T);
  } else if (c.pol == 2 && c.const_mu) {
    interval = c.k(K_IV_ORACLE);
  } else {
    double mu_i, V_i, Td_i;
    if (c.pol == 1) {
      const double prior_count = c.k(K_PRIOR_COUNT);
      mu_i = (s.ema_d + prior_count) / (s.ema_T + prior_count / s.mu0);
      const double V_hat = s.seen_ckpt ? V : c.k(K_PRIOR_V);
      const double td_known = store_on ? s.td_obs : T_d;
      Td_i = s.seen_restore ? td_known : V_hat;
      V_i = nmax(V_hat, 1e-6);
    } else {
      mu_i = c.k(K_MU) * c.k(K_HK) + c.k(K_SK);
      V_i = V;
      Td_i = td_expect;
    }
    interval = clampd(opt_interval(mu_i, c.k(K_K), V_i, Td_i), c.k(K_MIN_IV),
                      c.k(K_MAX_IV));
  }
  interval = nmax(interval, 1e-3);

  const double work = c.k(K_WORK), speed = c.k(K_SPEED);
  const double remaining = nmax(work - s.done, 0.0);
  const double work_target = nmin(interval * speed, remaining);
  const bool is_final = work_target >= remaining;
  const double cycle_len = work_target / speed + (is_final ? 0.0 : V);
  const double attempt_len = s.in_restore ? td_rest : cycle_len;

  // ------------------------------- _apply ------------------------------- //
  const double p_surv = exp(-kmu * cycle_len);
  double m_a, v_a;
  trunc_exp_moments(c.k(K_INV_KMU), cycle_len, p_surv, m_a, v_a);
  const double pair_m = m_a + c.k(K_MEAN_RESTORE);
  const double pair_v = v_a + c.k(K_V_R) + c.k(K_VAR_RESTORE);
  const double M_want =
      floor(log(nmax(d.u, 1e-300)) / nmin(log1p(-p_surv), -1e-300));

  double coh = c.k(K_COH);
  if (c.kind == kFlash) {
    const double p2 = c.k(K_P2), p3 = c.k(K_P3);
    coh = s.t < p2 ? p2 - s.t : (s.t < p2 + p3 ? p2 + p3 - s.t : INFINITY);
  }
  double horizon = nmin(coh, 0.5 * (c.k(K_T_END) - s.t) + pair_m);
  horizon = nmin(horizon, c.pol == 1 ? c.k(K_WIN) : INFINITY);
  const double M_cap = floor(horizon / nmax(pair_m, 1e-300));
  const double M = clampd(nmin(M_want, M_cap), 0.0, kMacroCap);
  const bool macro = att && !s.in_restore && !store_on &&
                     !(c.k(K_SHOCKED) != 0.0) && (p_surv < macro_threshold) &&
                     isfinite(kmu) && (kmu > 0.0) && (M >= 1.0);
  const bool capped = macro && (M < M_want);
  const bool m_ok = macro && !capped;
  const double burst = nmax(M * pair_m + d.z * sqrt(M * pair_v), 0.0);
  const double burst_waste = nmin(M * m_a, burst);

  const bool reg = att && !macro;
  const double t_fail = -log1p(-d.u) / kmu;
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
  const double R = c.k(K_R), img = c.k(K_IMG_BYTES);
  const bool srv_ckpt = interior && store_on && (R < 1.0);
  const bool srv_rest = rs && from_server;
  const bool srv_part = rf && from_server;
  const double frac = srv_part ? dt / nmax(td_rest, 1e-300) : 0.0;
  s.sv_bytes = s.sv_bytes + ((srv_ckpt || srv_rest) ? img : 0.0) + frac * img;
  s.n_srv = s.n_srv + b2d(srv_rest);
  s.n_peer = s.n_peer + b2d(rs && store_on && !from_server);

  // Estimator: the pooled expectation feed, or the class-pooled update.
  const double elapsed = t_new - s.t;
  const double log_decay = c.k(K_LOG_DECAY);
  if (PM && c.k(K_PM_ON) != 0.0) {
    // Class-pooled form (engine._pool_update), from the pre-step state.
    const double a = c.k(K_PRIOR_COUNT);
    const double share = c.k(K_SHARE);
    double nw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nw[j] = c.k(K_NW + j);

    const double lam0 = c.k(K_LAM0) * elapsed;
    const double d0 = sample_counts(lam0, d.u_pm, d.z0);
    const double beta0 = exp(d0 * log_decay);
    double ema_d0 = s.ema_d * beta0 + d0;
    double ema_T0 = s.ema_T * beta0 + share * elapsed;

    double lam_c[4], beta_c[4], pm_d[4], pm_T[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lam_c[j] = c.k(K_LAM + j) * elapsed;
      beta_c[j] = exp(lam_c[j] * log_decay);
      pm_d[j] = s.pm_d[j] * beta_c[j] + lam_c[j];
      pm_T[j] = s.pm_T[j] * beta_c[j] + share * elapsed;
    }
    double a_mu[4], t_old[4], t_new4[4], t_lam[4], t_beta[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a_mu[j] = a / s.pm_mu0[j];
      t_old[j] = nw[j] * (s.pm_T[j] + a_mu[j]);
      t_new4[j] = nw[j] * (pm_T[j] + a_mu[j]);
      t_lam[j] = nw[j] * lam_c[j];
      t_beta[j] = nw[j] * beta_c[j];
    }
    const double den_old = t_old[0] + t_old[1] + t_old[2] + t_old[3];
    const double den_new = t_new4[0] + t_new4[1] + t_new4[2] + t_new4[3];
    const double lam_bar = t_lam[0] + t_lam[1] + t_lam[2] + t_lam[3];
    const double beta_bar = t_beta[0] + t_beta[1] + t_beta[2] + t_beta[3];
    const double dn = nmax(den_new, 1e-300);
    double pm_v = (beta_bar * beta_bar * s.pm_v * (den_old * den_old) +
                   lam_bar) /
                  (dn * dn);

    const bool due = (c.k(K_GOSSIP) != 0.0) && !finished &&
                     (t_new >= s.next_g);
    const double mu_hat0 = (ema_d0 + a) / (ema_T0 + a / s.mu0);
    double mu_c[4], t_mu[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mu_c[j] = (pm_d[j] + a) / (pm_T[j] + a_mu[j]);
      t_mu[j] = nw[j] * mu_c[j];
    }
    const double mbar = t_mu[0] + t_mu[1] + t_mu[2] + t_mu[3];
    if (due) {
      const double w = c.k(K_G_WEIGHT), w1 = c.k(K_W1);
      const double rem0 =
          mbar + d.z1 * sqrt(nmax(pm_v, 0.0) * c.k(K_FPC));
      const double merged0 = w1 * mu_hat0 + w * nmax(rem0, 1e-300);
      const double mall = (mu_hat0 + c.k(K_KM1) * mbar) / c.k(K_KMAX1);
      ema_d0 = 0.0;
      ema_T0 = 0.0;
      s.mu0 = merged0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pm_d[j] = 0.0;
        pm_T[j] = 0.0;
        s.pm_mu0[j] = w1 * mu_c[j] + w * mall;
      }
      pm_v = c.k(K_CONTRACT) * pm_v;
      s.next_g = t_new + c.k(K_G_PERIOD);
    }
    s.ema_d = ema_d0;
    s.ema_T = ema_T0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.pm_d[j] = pm_d[j];
      s.pm_T[j] = pm_T[j];
    }
    s.pm_v = pm_v;
    s.n_round = s.n_round + b2d(due);
  } else {
    const double dd = c.k(K_D_RATE) * elapsed;
    const double expo = c.k(K_WATCH) * elapsed;
    const double beta = exp(dd * log_decay);
    s.ema_d = s.ema_d * beta + dd;
    s.ema_T = s.ema_T * beta + expo;
  }
  s.t = t_new;
  s.finished = finished;
}

struct Args {
  const double* pf;
  const double* p4;
  const double* hmean;
  const double* sdpeer;
  int peer_w;
  const double* trace_t;
  const double* trace_mtbf;
  int L;
  double* st;
  const double* draws;      // pre-generated route
  const long long* seeds;   // Philox route
  long long step0;
  int* taken;
  long long B;
  int chunk;
  double macro_threshold;
};

// The cell's parameters into its column of the shared table, and its state
// into registers (the rows only the class-pooled update moves are read
// and written in the pm variants alone).
template <bool STORE, bool HET, bool SHOCK, bool PM>
__device__ __forceinline__ void load_cell(const Args& a, long long b, Cell& c,
                                          State& s) {
  const long long B = a.B;
  c.trace_t = a.trace_t + b * a.L;
  c.trace_mtbf = a.trace_mtbf + b * a.L;
  init_cell<STORE, HET, SHOCK, PM>(c, a.pf, a.p4, a.hmean, a.sdpeer,
                                   a.peer_w, B, b);
  auto ld = [&](int row) { return a.st[row * B + b]; };
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
  s.sv_bytes = ld(S_SV_BYTES);
  s.n_srv = ld(S_N_SRV);
  s.n_peer = ld(S_N_PEER);
  if (PM) {
    s.next_g = ld(S_NEXT_G);
    s.n_round = ld(S_N_ROUND);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.pm_d[j] = ld(S_PM_D0 + j);
      s.pm_T[j] = ld(S_PM_T0 + j);
      s.pm_mu0[j] = ld(S_PM_MU00 + j);
    }
    s.pm_v = ld(S_PM_V);
  }
}

template <bool PM>
__device__ __forceinline__ void store_state(const Args& a, long long b,
                                            const State& s) {
  const long long B = a.B;
  auto stv = [&](int row, double v) { a.st[row * B + b] = v; };
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
  stv(S_SEEN_CKPT, b2d(s.seen_ckpt));
  stv(S_SEEN_RESTORE, b2d(s.seen_restore));
  stv(S_TD_OBS, s.td_obs);
  stv(S_SV_BYTES, s.sv_bytes);
  stv(S_N_SRV, s.n_srv);
  stv(S_N_PEER, s.n_peer);
  if (PM) {
    stv(S_MU0, s.mu0);
    stv(S_NEXT_G, s.next_g);
    stv(S_N_ROUND, s.n_round);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      stv(S_PM_D0 + j, s.pm_d[j]);
      stv(S_PM_T0 + j, s.pm_T[j]);
      stv(S_PM_MU00 + j, s.pm_mu0[j]);
    }
    stv(S_PM_V, s.pm_v);
  }
}

// Pre-generated route: one thread per cell, blocks of kBlock threads (313
// blocks for the fleet grid, 7 for a Fig. 4 batch); each step's draws are
// loaded one step ahead.  The launch bounds ask for one block per SM, so
// that ptxas may use up to 255 registers a thread: without the minimum it
// may hold a variant to 128 registers and spill.
template <bool STORE, bool HET, bool SHOCK, bool PM>
__global__ void __launch_bounds__(kBlock, 1)
    sim_step_kernel(const Args a) {
  extern __shared__ double table[];
  const long long b = static_cast<long long>(blockIdx.x) * kBlock +
                      threadIdx.x;
  const bool valid = b < a.B;
  Cell c{table + threadIdx.x * kStride, 0, 0, true, nullptr, nullptr, a.L};
  State s;
  Draws next{};
  if (valid) {
    load_cell<STORE, HET, SHOCK, PM>(a, b, c, s);
    next = load_draws<PM>(a.draws, 0, a.B, b);
  } else {
    s.finished = true;  // padding lanes take part in the warp vote only
  }
  int n = 0;
#pragma unroll 1
  for (int i = 0; i < a.chunk; ++i) {
    if (__all_sync(0xffffffffu, s.finished)) break;
    if (valid) {
      const Draws d = next;
      if (i + 1 < a.chunk) next = load_draws<PM>(a.draws, i + 1, a.B, b);
      step<STORE, HET, SHOCK, PM>(c, s, d, a.macro_threshold);
    }
    ++n;
  }
  if (valid) store_state<PM>(a, b, s);
  if ((threadIdx.x & (kWarp - 1)) == 0 && valid) a.taken[b / kWarp] = n;
}

// Philox route: steps drawn ahead per producer phase, a double-buffered
// ring of them in shared memory.
constexpr int kAhead = 4;

template <bool PM>
__device__ __forceinline__ void produce(double* ring, const Keys& key,
                                        uint64_t step, int m, int lane) {
  constexpr int nd = PM ? 6 : 3;
#pragma unroll 1
  for (int j = 0; j < m; ++j) {
    const Draws d = philox_draws<PM>(key, step + j);
    double* o = ring + j * nd * kWarp + lane;
    o[0] = d.u;
    o[kWarp] = d.z;
    o[2 * kWarp] = d.u2;
    if (PM) {
      o[3 * kWarp] = d.u_pm;
      o[4 * kWarp] = d.z0;
      o[5 * kWarp] = d.z1;
    }
  }
}

// Philox route: a block of two warps for 32 cells.  Warp 0 steps the
// cells; warp 1 draws their next kAhead steps (Philox4x32-10 and
// Box-Muller, from the seeds and the step index) into the ring while warp
// 0 runs the current kAhead, so the generator stays off the step's
// dependent chain.  The two meet at a __syncthreads every kAhead steps;
// warp 0's early exit (all 32 cells finished) ends the block at the next
// meeting.
template <bool STORE, bool HET, bool SHOCK, bool PM>
__global__ void __launch_bounds__(2 * kWarp, 1)
    sim_step_philox_kernel(const Args a) {
  constexpr int nd = PM ? 6 : 3;
  extern __shared__ double table[];   // [kWarp][kStride], then the ring
  double* ring = table + kWarp * kStride;   // [2][kAhead][nd][kWarp]
  __shared__ int stop;
  const int lane = threadIdx.x & (kWarp - 1);
  const bool producer = threadIdx.x >= kWarp;
  const long long b = static_cast<long long>(blockIdx.x) * kWarp + lane;
  const bool valid = b < a.B;
  Cell c{table + lane * kStride, 0, 0, true, nullptr, nullptr, a.L};
  State s;
  Keys key{0u, 0u, 0u};
  if (threadIdx.x == 0) stop = 0;
  if (producer) {
    if (valid) {
      key = keys_of(a.seeds[b]);
      produce<PM>(ring, key, static_cast<uint64_t>(a.step0),
                  a.chunk < kAhead ? a.chunk : kAhead, lane);
    }
  } else if (valid) {
    load_cell<STORE, HET, SHOCK, PM>(a, b, c, s);
  } else {
    s.finished = true;  // padding lanes take part in the warp vote only
  }
  __syncthreads();
  int n = 0;
#pragma unroll 1
  for (int base = 0; base < a.chunk; base += kAhead) {
    double* cur = ring + ((base / kAhead) & 1) * kAhead * nd * kWarp;
    if (producer) {
      const int nb = base + kAhead;
      double* nxt = ring + (((base / kAhead) + 1) & 1) * kAhead * nd * kWarp;
      if (valid && nb < a.chunk)
        produce<PM>(nxt, key, static_cast<uint64_t>(a.step0) + nb,
                    a.chunk - nb < kAhead ? a.chunk - nb : kAhead, lane);
    } else {
      const int m = a.chunk - base < kAhead ? a.chunk - base : kAhead;
#pragma unroll 1
      for (int j = 0; j < m; ++j) {
        if (__all_sync(0xffffffffu, s.finished)) {
          if (lane == 0) stop = 1;
          break;
        }
        if (valid) {
          const double* dr = cur + j * nd * kWarp + lane;
          Draws d;
          d.u = dr[0];
          d.z = dr[kWarp];
          d.u2 = dr[2 * kWarp];
          if (PM) {
            d.u_pm = dr[3 * kWarp];
            d.z0 = dr[4 * kWarp];
            d.z1 = dr[5 * kWarp];
          } else {
            d.u_pm = d.z0 = d.z1 = 0.0;
          }
          step<STORE, HET, SHOCK, PM>(c, s, d, a.macro_threshold);
        }
        ++n;
      }
    }
    __syncthreads();
    if (stop) break;
  }
  if (!producer && valid) {
    store_state<PM>(a, b, s);
    if (lane == 0) a.taken[b / kWarp] = n;
  }
}

template <bool STORE, bool HET, bool SHOCK, bool PM, bool PHILOX>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if (PHILOX) {
    const size_t smem =
        sizeof(double) * (kWarp * kStride + 2 * kAhead * (PM ? 6 : 3) * kWarp);
    const unsigned grid = static_cast<unsigned>((a.B + kWarp - 1) / kWarp);
    sim_step_philox_kernel<STORE, HET, SHOCK, PM>
        <<<grid, 2 * kWarp, smem, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = sizeof(double) * kStride * kBlock;
  const unsigned grid = static_cast<unsigned>((a.B + kBlock - 1) / kBlock);
  sim_step_kernel<STORE, HET, SHOCK, PM><<<grid, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

// The launch of instantiation KEY = (store, het, shock, pm, philox) bits.
template <int KEY>
cudaError_t dispatch(int key, const Args& a, cudaStream_t stream) {
  if (key == KEY)
    return launch<(KEY & 16) != 0, (KEY & 8) != 0, (KEY & 4) != 0,
                  (KEY & 2) != 0, (KEY & 1) != 0>(a, stream);
  if constexpr (KEY > 0) return dispatch<KEY - 1>(key, a, stream);
  return cudaErrorInvalidValue;
}

// The in-kernel generator on its own: out[i, :, b] = the draws of step
// step0 + i of cell b (a check against PhiloxDraws, not on the main path).
template <bool PM>
__global__ void philox_draws_kernel(const long long* __restrict__ seeds,
                                    long long step0, int n,
                                    double* __restrict__ out, long long B) {
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (b >= B) return;
  const Keys key = keys_of(seeds[b]);
  const int nd = PM ? 6 : 3;
  for (int i = 0; i < n; ++i) {
    const Draws d = philox_draws<PM>(key, static_cast<uint64_t>(step0) + i);
    double* o = out + static_cast<long long>(i) * nd * B + b;
    o[0] = d.u;
    o[B] = d.z;
    o[2 * B] = d.u2;
    if (PM) {
      o[3 * B] = d.u_pm;
      o[4 * B] = d.z0;
      o[5 * B] = d.z1;
    }
  }
}

}  // namespace

extern "C" {

// Advance B cells by up to `chunk` steps in place on `st` ([34, B]);
// writes the steps taken per warp of 32 cells to `taken`.  The draws come
// from `draws` ([chunk, n_draw, B]) when it is given, else from the
// in-kernel Philox stream of `seeds` ([B] int64) at steps step0 ...
// Returns the cudaError_t of the launch (0 on success); a call it does not take
// (an empty batch or chunk, both or neither draw source) is refused with
// cudaErrorInvalidValue, so 0 always means a launch.
int sim_step_launch(const double* pf, const double* p4, const double* hmean,
                    const double* sdpeer, int peer_w, const double* trace_t,
                    const double* trace_mtbf, int L, double* st,
                    const double* draws, const long long* seeds,
                    long long step0, int* taken, long long B, int chunk,
                    int n_draw, double macro_threshold, int any_store,
                    int any_het, int any_shock, int any_pm, void* stream) {
  const bool philox = draws == nullptr;
  if (B <= 0 || chunk <= 0 || L < 1 || peer_w < 1 ||
      philox == (seeds == nullptr) || (philox && step0 < 0) ||
      (!philox && n_draw != (any_pm ? 6 : 3)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{pf,      p4,    hmean, sdpeer, peer_w, trace_t,
               trace_mtbf, L,  st,    draws,  seeds,  step0,
               taken,   B,     chunk, macro_threshold};
  const int key = (any_store ? 16 : 0) | (any_het ? 8 : 0) |
                  (any_shock ? 4 : 0) | (any_pm ? 2 : 0) | (philox ? 1 : 0);
  return static_cast<int>(
      dispatch<31>(key, a, static_cast<cudaStream_t>(stream)));
}

// Writes the in-kernel generator's draws of steps step0 .. step0 + n - 1
// to `out` ([n, 3 or 6, B]).  Returns the cudaError_t of the launch.
int sim_step_philox_draws(const long long* seeds, long long step0, int n,
                          int any_pm, double* out, long long B, void* stream) {
  if (B <= 0 || n <= 0 || step0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>((B + 127) / 128);
  if (any_pm)
    philox_draws_kernel<true><<<grid, 128, 0, s>>>(seeds, step0, n, out, B);
  else
    philox_draws_kernel<false><<<grid, 128, 0, s>>>(seeds, step0, n, out, B);
  return static_cast<int>(cudaGetLastError());
}

const char* sim_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
