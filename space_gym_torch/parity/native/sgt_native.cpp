// Native host physics runtime: scipy-exact adaptive RK45 with terminal-event
// Brent root-finding, specialized to the spaceship dynamics.
//
// Role: the reference's per-step physics runtime is native code (scipy's
// compiled solver machinery + BLAS invoked from gym_space/dynamic_model.py:
// 94-125).  This library is the TPU build's equivalent: the identical
// published algorithms (Dormand-Prince 5(4), Hairer initial-step heuristic,
// scipy's accept/reject controller, quartic dense output, zeros.c brentq at
// xtol=rtol=4*eps) with the same operation order as ../host_rk45.py.
//
// BIT PARITY: numpy/scipy's np.dot and np.linalg.norm bottom out in the
// OpenBLAS bundled with numpy, whose FMA kernels are layout- and
// implementation-specific — no hand-written loop reproduces them exactly.
// So this library dlopens THE SAME shared object (numpy.libs/
// libscipy_openblas64_*.so, ILP64 symbols scipy_cblas_{dgemv,ddot,dgemm}64_)
// and issues the cblas calls with the strides numpy's dispatch would use;
// probing 15k random cases showed zero bit mismatches.  Without the library
// (sgt_native_init not called / dlopen fails) it falls back to sequential-FMA
// kernels that agree to <= 1 ulp per step.
//
// The ship RHS replicates gym_space/dynamic_model.py:129-176 including the
// velocity-steering in-place omega override (:138-141, value 5.0 — SURVEY.md
// Q2) and the float32 action arithmetic of continuous envs
// (spaceship_env.py:69-71).  Compile with -ffp-contract=off.

#include <cmath>
#include <cstdint>
#include <dlfcn.h>
#include <limits>

namespace {

typedef long long bint;  // ILP64 BLAS integer
typedef void (*dgemv_t)(int, int, bint, bint, double, const double*, bint,
                        const double*, bint, double, double*, bint);
typedef double (*ddot_t)(bint, const double*, bint, const double*, bint);
typedef void (*dgemm_t)(int, int, int, bint, bint, bint, double, const double*,
                        bint, const double*, bint, double, double*, bint);

dgemv_t cblas_gemv = nullptr;
ddot_t cblas_dot = nullptr;
dgemm_t cblas_gemm = nullptr;

constexpr int ColMajor = 102, RowMajor = 101, NoTrans = 111, Trans = 112;

constexpr double SAFETY = 0.9;
constexpr double MIN_FACTOR = 0.2;
constexpr double MAX_FACTOR = 10.0;
constexpr double ERROR_EXPONENT = -0.2;  // -1/(order+1)
constexpr double G = 6.6743e-11;         // helpers.py:19
constexpr int MAXP = 16;
constexpr int NDIM = 6;

const double DP_C[6] = {0.0, 1.0 / 5, 3.0 / 10, 4.0 / 5, 8.0 / 9, 1.0};
const double DP_A[6][5] = {
    {0, 0, 0, 0, 0},
    {1.0 / 5, 0, 0, 0, 0},
    {3.0 / 40, 9.0 / 40, 0, 0, 0},
    {44.0 / 45, -56.0 / 15, 32.0 / 9, 0, 0},
    {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0},
    {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656},
};
const double DP_B[6] = {35.0 / 384, 0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784, 11.0 / 84};
const double DP_E[7] = {-71.0 / 57600, 0,           71.0 / 16695, -71.0 / 1920,
                        17253.0 / 339200, -22.0 / 525, 1.0 / 40};
const double DP_P[7][4] = {
    {1, -8048581381.0 / 2820520608, 8663915743.0 / 2820520608, -12715105075.0 / 11282082432},
    {0, 0, 0, 0},
    {0, 131558114200.0 / 32700410799, -68118460800.0 / 10900136933, 87487479700.0 / 32700410799},
    {0, -1754552775.0 / 470086768, 14199869525.0 / 1410260304, -10690763975.0 / 1880347072},
    {0, 127303824393.0 / 49829197408, -318862633887.0 / 49829197408, 701980252875.0 / 199316789632},
    {0, -282668133.0 / 205662961, 2019193451.0 / 616988883, -1453857185.0 / 822651844},
    {0, 40617522.0 / 29380423, -110615467.0 / 29380423, 69997945.0 / 29380423},
};

// ---- dot/gemv/gemm with BLAS-or-fallback dispatch ----

inline double dotv(const double* x, const double* y, int n) {
  if (cblas_dot) return cblas_dot(n, x, 1, y, 1);
  double a = 0.0;
  for (int j = 0; j < n; ++j) a = std::fma(x[j], y[j], a);
  return a;
}

// out = np.dot(K[:s].T, c); K row-major (7, 6).
inline void kt_dot(const double* K, const double* c, int s, double* out) {
  if (cblas_gemv) {
    cblas_gemv(ColMajor, NoTrans, NDIM, s, 1.0, K, NDIM, c, 1, 0.0, out, 1);
    return;
  }
  for (int i = 0; i < NDIM; ++i) {
    double a = 0.0;
    for (int j = 0; j < s; ++j) a = std::fma(K[j * NDIM + i], c[j], a);
    out[i] = a;
  }
}

// Q (6,4) row-major = np.dot(K.T, P); K row-major (7,6), P row-major (7,4).
inline void kt_dot_P(const double* K, double* Q) {
  if (cblas_gemm) {
    cblas_gemm(RowMajor, Trans, NoTrans, NDIM, 4, 7, 1.0, K, NDIM,
               &DP_P[0][0], 4, 0.0, Q, 4);
    return;
  }
  for (int i = 0; i < NDIM; ++i)
    for (int m = 0; m < 4; ++m) {
      double a = 0.0;
      for (int j = 0; j < 7; ++j) a = std::fma(K[j * NDIM + i], DP_P[j][m], a);
      Q[i * 4 + m] = a;
    }
}

// out = np.dot(Q, p); Q row-major (6,4).
inline void q_dot_p(const double* Q, const double* p, double* out) {
  if (cblas_gemv) {
    cblas_gemv(RowMajor, NoTrans, NDIM, 4, 1.0, Q, 4, p, 1, 0.0, out, 1);
    return;
  }
  for (int i = 0; i < NDIM; ++i) {
    double a = 0.0;
    for (int m = 0; m < 4; ++m) a = std::fma(Q[i * 4 + m], p[m], a);
    out[i] = a;
  }
}

// np.linalg.norm(x) / sqrt(n)  (host_rk45._norm)
inline double rms_norm(const double* x, int n) {
  return std::sqrt(dotv(x, x, n)) / std::sqrt(static_cast<double>(n));
}

// np.linalg.norm of a 2-vector (gravity / planet events).
inline double norm2d(double a, double b) {
  double v[2] = {a, b};
  return std::sqrt(dotv(v, v, 2));
}

struct Model {
  int n_planets;
  int steering;     // 0 accel, 1 velocity
  int f32_actions;  // continuous envs: float32 action arithmetic
  double mass, moi, max_engine_force, max_thruster_force;
  double world_half, max_abs_vel_angle;
  const double* planets_pos;
  const double* planet_masses;
  const double* planet_radii;
  double engine_action, thruster_action;
};

// RHS (dynamic_model.py:129-176); omega override applied once by the caller.
void rhs(const Model& m, const double* y, double* dy) {
  double engine_force_scalar, ext_force_angle_d;
  if (m.f32_actions) {
    float efs = static_cast<float>(m.engine_action) * static_cast<float>(m.max_engine_force);
    engine_force_scalar = static_cast<double>(efs);
    if (m.steering == 0) {
      float efa = static_cast<float>(m.thruster_action) * static_cast<float>(m.max_thruster_force);
      float aa = efa / static_cast<float>(m.moi);
      ext_force_angle_d = static_cast<double>(aa);
    } else {
      ext_force_angle_d = 0.0;
    }
  } else {
    engine_force_scalar = m.engine_action * m.max_engine_force;
    ext_force_angle_d =
        (m.steering == 0) ? m.thruster_action * m.max_thruster_force / m.moi : 0.0;
  }

  double fx = -std::cos(y[2]) * engine_force_scalar;
  double fy = -std::sin(y[2]) * engine_force_scalar;
  for (int i = 0; i < m.n_planets; ++i) {
    double dx = m.planets_pos[2 * i] - y[0];
    double dyp = m.planets_pos[2 * i + 1] - y[1];
    double dist = norm2d(dx, dyp);
    // dist**2 upstream is a numpy SCALAR power = libm pow(dist, 2.0), which
    // differs from dist*dist by 1 ulp on some inputs (this was the cause of
    // the Kepler ep1 t46 divergence chased in round 1).
    double scalar = G * m.mass * m.planet_masses[i] / std::pow(dist, 2.0);
    fx += (dx / dist) * scalar;
    fy += (dyp / dist) * scalar;
  }
  dy[0] = y[3];
  dy[1] = y[4];
  dy[2] = y[5];
  dy[3] = fx / m.mass;
  dy[4] = fy / m.mass;
  dy[5] = ext_force_angle_d;
}

double event_val(const Model& m, int e, const double* y) {
  if (e < m.n_planets) {
    double dx = m.planets_pos[2 * e] - y[0];
    double dyp = m.planets_pos[2 * e + 1] - y[1];
    return norm2d(dx, dyp) - m.planet_radii[e];
  }
  if (e == m.n_planets) {
    double a = m.world_half - y[0], b = m.world_half - y[1];
    return a < b ? a : b;
  }
  if (e == m.n_planets + 1) {
    double a = m.world_half + y[0], b = m.world_half + y[1];
    return a < b ? a : b;
  }
  return m.max_abs_vel_angle - std::fabs(y[5]);
}

struct DenseSeg {
  double t_old, h;
  double y_old[NDIM];
  double Q[NDIM * 4];
};

// host_rk45.sol: hseg * np.dot(Q, cumprod([x]*4)) + y_old
void dense_eval(const DenseSeg& d, double tq, double* out) {
  double x = (tq - d.t_old) / d.h;
  double p[4];
  p[0] = x;
  p[1] = p[0] * x;
  p[2] = p[1] * x;
  p[3] = p[2] * x;
  double acc[NDIM];
  q_dot_p(d.Q, p, acc);
  for (int i = 0; i < NDIM; ++i) out[i] = d.h * acc[i] + d.y_old[i];
}

double event_on_dense(const Model& m, const DenseSeg& d, int e, double tq) {
  double yq[NDIM];
  dense_eval(d, tq, yq);
  return event_val(m, e, yq);
}

// Brent's method exactly as zeros.c / host_rk45.brentq.
double brentq(const Model& m, const DenseSeg& d, int e, double xa, double xb,
              double xtol, double rtol, int maxiter) {
  double xpre = xa, xcur = xb;
  double fpre = event_on_dense(m, d, e, xpre);
  double fcur = event_on_dense(m, d, e, xcur);
  if (fpre == 0) return xpre;
  if (fcur == 0) return xcur;
  double xblk = 0, fblk = 0, spre = 0, scur = 0;
  for (int it = 0; it < maxiter; ++it) {
    if (fpre != 0 && fcur != 0 && std::signbit(fpre) != std::signbit(fcur)) {
      xblk = xpre;
      fblk = fpre;
      spre = scur = xcur - xpre;
    }
    if (std::fabs(fblk) < std::fabs(fcur)) {
      xpre = xcur; xcur = xblk; xblk = xpre;
      fpre = fcur; fcur = fblk; fblk = fpre;
    }
    double delta = (xtol + rtol * std::fabs(xcur)) / 2;
    double sbis = (xblk - xcur) / 2;
    if (fcur == 0 || std::fabs(sbis) < delta) return xcur;
    if (std::fabs(spre) > delta && std::fabs(fcur) < std::fabs(fpre)) {
      double stry;
      if (xpre == xblk) {
        stry = -fcur * (xcur - xpre) / (fcur - fpre);
      } else {
        double dpre = (fpre - fcur) / (xpre - xcur);
        double dblk = (fblk - fcur) / (xblk - xcur);
        stry = -fcur * (fblk * dblk - fpre * dpre) / (dblk * dpre * (fblk - fpre));
      }
      double m1 = std::fabs(spre), m2 = 3 * std::fabs(sbis) - delta;
      if (2 * std::fabs(stry) < (m1 < m2 ? m1 : m2)) {
        spre = scur;
        scur = stry;
      } else {
        spre = scur = sbis;
      }
    } else {
      spre = scur = sbis;
    }
    xpre = xcur;
    fpre = fcur;
    if (std::fabs(scur) > delta) {
      xcur += scur;
    } else {
      xcur += (sbis > 0 ? delta : -delta);
    }
    fcur = event_on_dense(m, d, e, xcur);
  }
  return xcur;
}

double select_initial_step(const Model& m, double t0, const double* y0, const double* f0,
                           double t_bound, double rtol, double atol) {
  double interval = std::fabs(t_bound - t0);
  double scale[NDIM], tmp[NDIM];
  for (int i = 0; i < NDIM; ++i) scale[i] = atol + std::fabs(y0[i]) * rtol;
  for (int i = 0; i < NDIM; ++i) tmp[i] = y0[i] / scale[i];
  double d0 = rms_norm(tmp, NDIM);
  for (int i = 0; i < NDIM; ++i) tmp[i] = f0[i] / scale[i];
  double d1 = rms_norm(tmp, NDIM);
  double h0 = (d0 < 1e-5 || d1 < 1e-5) ? 1e-6 : 0.01 * d0 / d1;
  if (h0 > interval) h0 = interval;
  double y1[NDIM], f1[NDIM];
  for (int i = 0; i < NDIM; ++i) y1[i] = y0[i] + h0 * f0[i];
  rhs(m, y1, f1);
  for (int i = 0; i < NDIM; ++i) tmp[i] = (f1[i] - f0[i]) / scale[i];
  double d2 = rms_norm(tmp, NDIM) / h0;
  double h1;
  if (d1 <= 1e-15 && d2 <= 1e-15) {
    h1 = 1e-6 > h0 * 1e-3 ? 1e-6 : h0 * 1e-3;
  } else {
    h1 = std::pow(0.01 / (d1 > d2 ? d1 : d2), 0.2);
  }
  double out = 100 * h0;
  if (h1 < out) out = h1;
  if (interval < out) out = interval;
  return out;
}

}  // namespace

extern "C" {

// Debug probes (parity triage): evaluate the RHS / initial-step heuristic in
// isolation so divergences can be bisected against the numpy host path.
void sgt_debug_rhs(const double* y, double engine_action, double thruster_action,
                   const double* planets_pos, const double* planet_masses,
                   const double* planet_radii, int n_planets, int steering,
                   int f32_actions, double mass, double moi, double max_engine_force,
                   double max_thruster_force, double* dy_out) {
  Model m;
  m.n_planets = n_planets; m.steering = steering; m.f32_actions = f32_actions;
  m.mass = mass; m.moi = moi;
  m.max_engine_force = max_engine_force; m.max_thruster_force = max_thruster_force;
  m.world_half = 0; m.max_abs_vel_angle = 0;
  m.planets_pos = planets_pos; m.planet_masses = planet_masses;
  m.planet_radii = planet_radii;
  m.engine_action = engine_action; m.thruster_action = thruster_action;
  rhs(m, y, dy_out);
}

double sgt_debug_h0(const double* y, double engine_action, double thruster_action,
                    const double* planets_pos, const double* planet_masses,
                    const double* planet_radii, int n_planets, int steering,
                    int f32_actions, double mass, double moi, double max_engine_force,
                    double max_thruster_force, double t_bound) {
  Model m;
  m.n_planets = n_planets; m.steering = steering; m.f32_actions = f32_actions;
  m.mass = mass; m.moi = moi;
  m.max_engine_force = max_engine_force; m.max_thruster_force = max_thruster_force;
  m.world_half = 0; m.max_abs_vel_angle = 0;
  m.planets_pos = planets_pos; m.planet_masses = planet_masses;
  m.planet_radii = planet_radii;
  m.engine_action = engine_action; m.thruster_action = thruster_action;
  double f0[NDIM];
  rhs(m, y, f0);
  return select_initial_step(m, 0.0, y, f0, t_bound, 1e-3, 1e-6);
}

// Load numpy's bundled OpenBLAS for bit-exact dot/gemv/gemm; 0 on success.
int sgt_native_init(const char* openblas_path) {
  void* h = dlopen(openblas_path, RTLD_NOW | RTLD_LOCAL);
  if (!h) return -1;
  cblas_gemv = reinterpret_cast<dgemv_t>(dlsym(h, "scipy_cblas_dgemv64_"));
  cblas_dot = reinterpret_cast<ddot_t>(dlsym(h, "scipy_cblas_ddot64_"));
  cblas_gemm = reinterpret_cast<dgemm_t>(dlsym(h, "scipy_cblas_dgemm64_"));
  return (cblas_gemv && cblas_dot && cblas_gemm) ? 0 : -2;
}

int sgt_has_blas(void) { return cblas_dot != nullptr; }

// Returns 0 ok, 1 terminated-by-event, negative on error.
int sgt_solve_step(const double* y0_in, double engine_action, double thruster_action,
                   const double* planets_pos, const double* planet_masses,
                   const double* planet_radii, int n_planets, int steering,
                   int f32_actions, double mass, double moi, double max_engine_force,
                   double max_thruster_force, double world_size, double max_abs_vel_angle,
                   double t_bound, double rtol, double atol, double* y_out) {
  if (n_planets > MAXP || n_planets < 1) return -2;
  Model m;
  m.n_planets = n_planets;
  m.steering = steering;
  m.f32_actions = f32_actions;
  m.mass = mass;
  m.moi = moi;
  m.max_engine_force = max_engine_force;
  m.max_thruster_force = max_thruster_force;
  m.world_half = world_size / 2;
  m.max_abs_vel_angle = max_abs_vel_angle;
  m.planets_pos = planets_pos;
  m.planet_masses = planet_masses;
  m.planet_radii = planet_radii;
  m.engine_action = engine_action;
  m.thruster_action = thruster_action;

  const double EPS = 2.220446049250313e-16;
  const double tol4 = 4 * EPS;

  double y[NDIM];
  for (int i = 0; i < NDIM; ++i) y[i] = y0_in[i];
  // Velocity-steering in-place override (dynamic_model.py:138-141): the first
  // RHS call mutates y[5]; d(omega)/dt == 0 makes a pre-step override exact.
  if (steering == 1) {
    if (f32_actions) {
      float v = static_cast<float>(thruster_action) * 5.0f;
      y[5] = static_cast<double>(v);
    } else {
      y[5] = thruster_action * 5.0;
    }
  }

  double t = 0.0;
  double f[NDIM];
  rhs(m, y, f);
  double h_abs = select_initial_step(m, t, y, f, t_bound, rtol, atol);
  int n_events = n_planets + 3;
  double g[MAXP + 3], g_new[MAXP + 3];
  for (int e = 0; e < n_events; ++e) g[e] = event_val(m, e, y);

  double K[7][NDIM];
  for (int iter = 0; iter < 100000; ++iter) {
    double min_step =
        10 * std::fabs(std::nextafter(t, std::numeric_limits<double>::infinity()) - t);
    if (h_abs < min_step) h_abs = min_step;
    bool accepted = false, rejected = false;
    double t_new = t, h = 0, y_new[NDIM], f_new[NDIM];
    while (!accepted) {
      if (h_abs < min_step) return -3;  // underflow
      t_new = t + h_abs;
      if (t_new > t_bound) t_new = t_bound;
      h = t_new - t;
      h_abs = std::fabs(h);
      // rk_step (host_rk45.py:139-146): dy = dot(K[:s].T, A[s,:s]) * h.
      for (int i = 0; i < NDIM; ++i) K[0][i] = f[i];
      for (int s = 1; s < 6; ++s) {
        double dy[NDIM], ys[NDIM];
        kt_dot(&K[0][0], DP_A[s], s, dy);
        for (int i = 0; i < NDIM; ++i) ys[i] = y[i] + dy[i] * h;
        rhs(m, ys, K[s]);
      }
      double by[NDIM];
      kt_dot(&K[0][0], DP_B, 6, by);
      for (int i = 0; i < NDIM; ++i) y_new[i] = y[i] + h * by[i];
      rhs(m, y_new, f_new);
      for (int i = 0; i < NDIM; ++i) K[6][i] = f_new[i];
      double ev[NDIM], err[NDIM];
      kt_dot(&K[0][0], DP_E, 7, ev);
      for (int i = 0; i < NDIM; ++i) {
        double ay = std::fabs(y[i]), an = std::fabs(y_new[i]);
        double scale = atol + (ay > an ? ay : an) * rtol;
        err[i] = ev[i] * h / scale;
      }
      double error_norm = rms_norm(err, NDIM);
      if (error_norm < 1) {
        double factor = (error_norm == 0.0)
                            ? MAX_FACTOR
                            : std::fmin(MAX_FACTOR, SAFETY * std::pow(error_norm, ERROR_EXPONENT));
        if (rejected && factor > 1) factor = 1;
        h_abs *= factor;
        accepted = true;
      } else {
        h_abs *= std::fmax(MIN_FACTOR, SAFETY * std::pow(error_norm, ERROR_EXPONENT));
        rejected = true;
      }
    }

    double t_old = t;
    DenseSeg dseg;
    dseg.t_old = t_old;
    dseg.h = t_new - t_old;
    for (int i = 0; i < NDIM; ++i) dseg.y_old[i] = y[i];

    t = t_new;
    for (int i = 0; i < NDIM; ++i) y[i] = y_new[i];
    for (int i = 0; i < NDIM; ++i) f[i] = f_new[i];

    for (int e = 0; e < n_events; ++e) g_new[e] = event_val(m, e, y);
    bool any_active = false;
    bool active[MAXP + 3];
    for (int e = 0; e < n_events; ++e) {
      active[e] = ((g[e] <= 0 && g_new[e] >= 0) || (g[e] >= 0 && g_new[e] <= 0));
      any_active |= active[e];
    }
    if (any_active) {
      kt_dot_P(&K[0][0], dseg.Q);  // Q = K.T.dot(P), host_rk45.py:170
      double t_event = 0;
      bool first = true;
      for (int e = 0; e < n_events; ++e) {
        if (!active[e]) continue;
        double root = brentq(m, dseg, e, t_old, t, tol4, tol4, 100);
        if (first || root < t_event) {  // stable first-min (argsort order)
          t_event = root;
          first = false;
        }
      }
      dense_eval(dseg, t_event, y_out);
      return 1;
    }
    for (int e = 0; e < n_events; ++e) g[e] = g_new[e];

    if (t >= t_bound) {
      for (int i = 0; i < NDIM; ++i) y_out[i] = y[i];
      return 0;
    }
  }
  return -4;  // iteration cap
}

}  // extern "C"
