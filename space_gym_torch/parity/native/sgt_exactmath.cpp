// Numpy-exact math for the device parity tier (ops/exact.py).
//
// Role: the parity engine (parity/device_replay.py) must reproduce the
// reference's numpy arithmetic bit for bit.  Five op families cannot be
// matched by PyTorch's own kernels:
//
//  * np.dot / np.linalg.norm bottom out in the OpenBLAS bundled with numpy,
//    whose FMA kernels have implementation-specific accumulation orders.
//    Like sgt_native.cpp, this library dlopens THE SAME shared object
//    (numpy.libs/libscipy_openblas64_*.so) and issues the cblas calls with
//    the strides numpy's dispatch would use.  There is no fallback: a
//    library whose BLAS did not load is never called (ops/exact.py raises).
//  * pow: scipy's step controller computes error_norm ** -0.2, and the
//    reference squares numpy scalars, through libm pow; PyTorch squares by
//    multiplication and its pow differs by an ulp on some inputs.
//  * atan2: glibc atan2 (the reference's scalar obs path goes through numpy,
//    which ops/exact.py calls itself; this entry is libm's).
//  * cos / sin: libm's, which numpy's float64 loops call on the host that
//    recorded the goldens; PyTorch's vectorized CPU kernels (SLEEF) and the
//    card's differ by an ulp on some inputs.
//  * sqrt: the IEEE square root, which numpy computes; PyTorch's vectorized
//    CPU sqrt is off by an ulp on about 0.7% of float64 inputs.
//
// Plain C entry points over pointers and counts, called through ctypes; every
// array is C-contiguous, its leading axes flattened into `count`.
//
// Reference use sites: scipy RK45 controller/stage math as invoked by
// gym_space/dynamic_model.py:94-125; obs lidar atan2/norm
// (gym_space/envs/spaceship_env.py:133-140); Kepler orbit math norms/rotate
// (gym_space/envs/kepler.py:43-109).  Compile with -ffp-contract=off.

#include <cmath>
#include <cstdint>
#include <dlfcn.h>

namespace {

typedef long long bint;  // ILP64 BLAS integer
typedef void (*dgemv_t)(int, int, bint, bint, double, const double*, bint,
                        const double*, bint, double, double*, bint);
typedef double (*ddot_t)(bint, const double*, bint, const double*, bint);
typedef float (*sdot_t)(bint, const float*, bint, const float*, bint);
typedef void (*dgemm_t)(int, int, int, bint, bint, bint, double, const double*,
                        bint, const double*, bint, double, double*, bint);

dgemv_t cblas_gemv = nullptr;
ddot_t cblas_dot = nullptr;
sdot_t cblas_sdot = nullptr;
dgemm_t cblas_gemm = nullptr;
const char* load_error = "sgt_exact_init was not called";

constexpr int ColMajor = 102, RowMajor = 101, NoTrans = 111, Trans = 112;

// Dormand-Prince coefficient vectors for the staged combinations
// (published constants, identical to scipy rk.RK45.{A,B,E,P}).
const double DP_A1[1] = {1.0 / 5};
const double DP_A2[2] = {3.0 / 40, 9.0 / 40};
const double DP_A3[3] = {44.0 / 45, -56.0 / 15, 32.0 / 9};
const double DP_A4[4] = {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729};
const double DP_A5[5] = {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176,
                         -5103.0 / 18656};
const double DP_B[6] = {35.0 / 384, 0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
                        11.0 / 84};
const double DP_E[7] = {-71.0 / 57600, 0, 71.0 / 16695, -71.0 / 1920,
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

const double* dp_coeffs(std::int64_t which, int* len) {
  switch (which) {
    case 1: *len = 1; return DP_A1;
    case 2: *len = 2; return DP_A2;
    case 3: *len = 3; return DP_A3;
    case 4: *len = 4; return DP_A4;
    case 5: *len = 5; return DP_A5;
    case 6: *len = 6; return DP_B;
    default: *len = 7; return DP_E;
  }
}

}  // namespace

extern "C" {

// ---- elementwise libm ----

void sgt_exact_pow(const double* x, double e, double* out, std::int64_t n) {
  for (std::int64_t i = 0; i < n; ++i) out[i] = std::pow(x[i], e);
}

void sgt_exact_atan2(const double* y, const double* x, double* out, std::int64_t n) {
  for (std::int64_t i = 0; i < n; ++i) out[i] = std::atan2(y[i], x[i]);
}

void sgt_exact_cos(const double* x, double* out, std::int64_t n) {
  for (std::int64_t i = 0; i < n; ++i) out[i] = std::cos(x[i]);
}

void sgt_exact_sin(const double* x, double* out, std::int64_t n) {
  for (std::int64_t i = 0; i < n; ++i) out[i] = std::sin(x[i]);
}

void sgt_exact_sqrt(const double* x, double* out, std::int64_t n) {
  for (std::int64_t i = 0; i < n; ++i) out[i] = std::sqrt(x[i]);
}

// ---- np.linalg.norm over the trailing axis: sqrt(ddot(x, x)) ----

void sgt_exact_norm_last(const double* x, std::int64_t count, std::int64_t n, double* out) {
  for (std::int64_t i = 0; i < count; ++i)
    out[i] = std::sqrt(cblas_dot(n, x + i * n, 1, x + i * n, 1));
}

void sgt_exact_norm_last_f32(const float* x, std::int64_t count, std::int64_t n, float* out) {
  for (std::int64_t i = 0; i < count; ++i)
    out[i] = std::sqrt(cblas_sdot(n, x + i * n, 1, x + i * n, 1));
}

// ---- np.dot(K[:s].T, coeffs): K (count, rows, ncols) row-major, of which
// the first s rows are read; coeffs baked by `which` (1..5 = DP_A row,
// 6 = DP_B, 7 = DP_E).  Matches the cblas call numpy dispatches for a
// (ncols, s) F-contiguous view: ColMajor NoTrans. ----

void sgt_exact_kt_dot(const double* k, std::int64_t count, std::int64_t rows,
                      std::int64_t ncols, std::int64_t which, double* out) {
  int s;
  const double* c = dp_coeffs(which, &s);
  for (std::int64_t i = 0; i < count; ++i)
    cblas_gemv(ColMajor, NoTrans, ncols, s, 1.0, k + i * rows * ncols, ncols, c, 1, 0.0,
               out + i * ncols, 1);
}

// ---- Q = np.dot(K.T, P): K (count, 7, ncols) -> Q (count, ncols, 4).
// Matches numpy's dgemm for the F-contiguous K.T times C-contiguous P
// (RowMajor Trans x NoTrans, as probed bitwise in sgt_native.cpp). ----

void sgt_exact_ktp(const double* k, std::int64_t count, std::int64_t ncols, double* out) {
  for (std::int64_t i = 0; i < count; ++i)
    cblas_gemm(RowMajor, Trans, NoTrans, ncols, 4, 7, 1.0, k + i * 7 * ncols, ncols,
               &DP_P[0][0], 4, 0.0, out + i * ncols * 4, 4);
}

// ---- np.dot(A, x) for small row-major A (count, m, n) and x (count, n):
// numpy dispatches RowMajor NoTrans dgemv (dense-output Q @ p, Kepler's 2x2
// rotation matrix times position). ----

void sgt_exact_dot_mv(const double* a, const double* x, std::int64_t count, std::int64_t m,
                      std::int64_t n, double* out) {
  for (std::int64_t i = 0; i < count; ++i)
    cblas_gemv(RowMajor, NoTrans, m, n, 1.0, a + i * m * n, n, x + i * n, 1, 0.0,
               out + i * m, 1);
}

// Load numpy's bundled OpenBLAS; 0 on success, else -1 with the loader's
// message in sgt_exact_error().
int sgt_exact_init(const char* openblas_path) {
  void* h = dlopen(openblas_path, RTLD_NOW | RTLD_LOCAL);
  if (!h) {
    load_error = dlerror();
    return -1;
  }
  cblas_gemv = reinterpret_cast<dgemv_t>(dlsym(h, "scipy_cblas_dgemv64_"));
  cblas_dot = reinterpret_cast<ddot_t>(dlsym(h, "scipy_cblas_ddot64_"));
  cblas_sdot = reinterpret_cast<sdot_t>(dlsym(h, "scipy_cblas_sdot64_"));
  cblas_gemm = reinterpret_cast<dgemm_t>(dlsym(h, "scipy_cblas_dgemm64_"));
  if (cblas_gemv && cblas_dot && cblas_sdot && cblas_gemm) return 0;
  load_error = "a scipy_cblas_{dgemv,ddot,sdot,dgemm}64_ symbol is missing";
  return -1;
}

const char* sgt_exact_error(void) { return load_error; }

}  // extern "C"
