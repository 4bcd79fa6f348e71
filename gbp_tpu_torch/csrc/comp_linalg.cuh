// Small symmetric-matrix algebra for one factor per CUDA thread.
//
// The CUDA counterpart of gbp_tpu/ops/comp_linalg.py (component lists of
// TPU vreg tiles): here a d x d matrix is a `T[d][d]` array that the fully
// unrolled loops keep in registers.  Same closed forms and the same
// operation order as the plain version (gbp_tpu_torch/ops/comp_linalg.py):
// d <= 3 closed form, d >= 4 the 2x2-block Schur recursion with
// d1 = ceil(d/2), and the Jacobi normalization of `cscaled_sym_inv`.
// Templates over the scalar type T (float or double).
#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define GBP_HD __host__ __device__ __forceinline__
#else
#define GBP_HD inline
#endif

namespace gbp {

GBP_HD float g_sqrt(float x) { return sqrtf(x); }
GBP_HD double g_sqrt(double x) { return sqrt(x); }
GBP_HD float g_sin(float x) { return sinf(x); }
GBP_HD double g_sin(double x) { return sin(x); }
GBP_HD float g_cos(float x) { return cosf(x); }
GBP_HD double g_cos(double x) { return cos(x); }
GBP_HD float g_tan(float x) { return tanf(x); }
GBP_HD double g_tan(double x) { return tan(x); }
GBP_HD float g_floor(float x) { return floorf(x); }
GBP_HD double g_floor(double x) { return floor(x); }
GBP_HD float g_abs(float x) { return fabsf(x); }
GBP_HD double g_abs(double x) { return fabs(x); }

// Separately rounded multiply / add (never contracted into an FMA): used
// where a threshold decision must match the plain version bit for bit.
#if defined(__CUDA_ARCH__)
GBP_HD float mul_rn(float a, float b) { return __fmul_rn(a, b); }
GBP_HD double mul_rn(double a, double b) { return __dmul_rn(a, b); }
GBP_HD float add_rn(float a, float b) { return __fadd_rn(a, b); }
GBP_HD double add_rn(double a, double b) { return __dadd_rn(a, b); }
#else
template <typename T> GBP_HD T mul_rn(T a, T b) { return a * b; }
template <typename T> GBP_HD T add_rn(T a, T b) { return a + b; }
#endif

// max / min that propagate NaN like torch.clamp and jnp.maximum.
template <typename T> GBP_HD T max_nan(T x, T lo) { return x < lo ? lo : x; }
template <typename T> GBP_HD T min_nan(T x, T hi) { return x > hi ? hi : x; }

// c = a @ b for [R x K] @ [K x C].
template <typename T, int R, int K, int C>
GBP_HD void mm(const T (&a)[R][K], const T (&b)[K][C], T (&c)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      T acc = a[i][0] * b[0][j];
#pragma unroll
      for (int s = 1; s < K; ++s) acc = acc + a[i][s] * b[s][j];
      c[i][j] = acc;
    }
  }
}

// c = a @ b^T for [R x K] @ [C x K]^T.
template <typename T, int R, int K, int C>
GBP_HD void mm_bt(const T (&a)[R][K], const T (&b)[C][K], T (&c)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      T acc = a[i][0] * b[j][0];
#pragma unroll
      for (int s = 1; s < K; ++s) acc = acc + a[i][s] * b[j][s];
      c[i][j] = acc;
    }
  }
}

// c = a^T @ b for [K x R]^T @ [K x C].
template <typename T, int K, int R, int C>
GBP_HD void mm_at(const T (&a)[K][R], const T (&b)[K][C], T (&c)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      T acc = a[0][i] * b[0][j];
#pragma unroll
      for (int s = 1; s < K; ++s) acc = acc + a[s][i] * b[s][j];
      c[i][j] = acc;
    }
  }
}

// y = a @ v for [R x K] @ [K].
template <typename T, int R, int K>
GBP_HD void mv(const T (&a)[R][K], const T (&v)[K], T (&y)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T acc = a[i][0] * v[0];
#pragma unroll
    for (int s = 1; s < K; ++s) acc = acc + a[i][s] * v[s];
    y[i] = acc;
  }
}

// y = a^T @ v for [K x R]^T @ [K].
template <typename T, int K, int R>
GBP_HD void mv_at(const T (&a)[K][R], const T (&v)[K], T (&y)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T acc = a[0][i] * v[0];
#pragma unroll
    for (int s = 1; s < K; ++s) acc = acc + a[s][i] * v[s];
    y[i] = acc;
  }
}

// Symmetric inverse.  D >= 4: A = [[P, Q], [Q^T, S]] block-Schur inverse.
template <typename T, int D>
struct SymInv {
  GBP_HD static void run(const T (&a)[D][D], T (&out)[D][D]) {
    constexpr int D1 = (D + 1) / 2;
    constexpr int D2 = D - D1;
    T p[D1][D1], q[D1][D2], s[D2][D2];
#pragma unroll
    for (int i = 0; i < D1; ++i) {
#pragma unroll
      for (int j = 0; j < D1; ++j) p[i][j] = a[i][j];
#pragma unroll
      for (int j = 0; j < D2; ++j) q[i][j] = a[i][D1 + j];
    }
#pragma unroll
    for (int i = 0; i < D2; ++i) {
#pragma unroll
      for (int j = 0; j < D2; ++j) s[i][j] = a[D1 + i][D1 + j];
    }
    T p_inv[D1][D1];
    SymInv<T, D1>::run(p, p_inv);
    T pq[D1][D2];
    mm(p_inv, q, pq);
    T qtpq[D2][D2];
    mm_at(q, pq, qtpq);
#pragma unroll
    for (int i = 0; i < D2; ++i) {
#pragma unroll
      for (int j = 0; j < D2; ++j) s[i][j] = s[i][j] - qtpq[i][j];
    }
    T schur_inv[D2][D2];
    SymInv<T, D2>::run(s, schur_inv);
    T ps[D1][D2];  // pq @ schur_inv
    mm(pq, schur_inv, ps);
    T tl[D1][D1];  // ps @ pq^T
    mm_bt(ps, pq, tl);
#pragma unroll
    for (int i = 0; i < D1; ++i) {
#pragma unroll
      for (int j = 0; j < D1; ++j) out[i][j] = p_inv[i][j] + tl[i][j];
#pragma unroll
      for (int j = 0; j < D2; ++j) {
        const T tr = ps[i][j] * T(-1.0);
        out[i][D1 + j] = tr;
        out[D1 + j][i] = tr;
      }
    }
#pragma unroll
    for (int i = 0; i < D2; ++i) {
#pragma unroll
      for (int j = 0; j < D2; ++j) out[D1 + i][D1 + j] = schur_inv[i][j];
    }
  }
};

template <typename T>
struct SymInv<T, 1> {
  GBP_HD static void run(const T (&a)[1][1], T (&out)[1][1]) {
    out[0][0] = T(1.0) / a[0][0];
  }
};

template <typename T>
struct SymInv<T, 2> {
  GBP_HD static void run(const T (&a)[2][2], T (&out)[2][2]) {
    const T inv_det = T(1.0) / (a[0][0] * a[1][1] - a[0][1] * a[0][1]);
    out[0][0] = a[1][1] * inv_det;
    out[0][1] = -a[0][1] * inv_det;
    out[1][0] = -a[0][1] * inv_det;
    out[1][1] = a[0][0] * inv_det;
  }
};

template <typename T>
struct SymInv<T, 3> {
  GBP_HD static void run(const T (&a)[3][3], T (&out)[3][3]) {
    const T c00 = a[1][1] * a[2][2] - a[1][2] * a[1][2];
    const T c01 = a[0][2] * a[1][2] - a[0][1] * a[2][2];
    const T c02 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
    const T c11 = a[0][0] * a[2][2] - a[0][2] * a[0][2];
    const T c12 = a[0][1] * a[0][2] - a[0][0] * a[1][2];
    const T c22 = a[0][0] * a[1][1] - a[0][1] * a[0][1];
    const T inv_det = T(1.0) / (a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02);
    out[0][0] = c00 * inv_det;
    out[0][1] = c01 * inv_det;
    out[0][2] = c02 * inv_det;
    out[1][0] = c01 * inv_det;
    out[1][1] = c11 * inv_det;
    out[1][2] = c12 * inv_det;
    out[2][0] = c02 * inv_det;
    out[2][1] = c12 * inv_det;
    out[2][2] = c22 * inv_det;
  }
};

// f32-safe inverse: Jacobi-normalize to unit diagonal, invert, undo.
template <typename T, int D>
GBP_HD void scaled_sym_inv(const T (&a)[D][D], T (&out)[D][D]) {
  if constexpr (D == 1) {
    out[0][0] = T(1.0) / a[0][0];
  } else {
    T s[D];
#pragma unroll
    for (int i = 0; i < D; ++i) s[i] = g_sqrt(max_nan(a[i][i], T(1e-30)));
    T a_n[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) a_n[i][j] = a[i][j] / (s[i] * s[j]);
    }
    T inv_n[D][D];
    SymInv<T, D>::run(a_n, inv_n);
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) out[i][j] = inv_n[i][j] / (s[i] * s[j]);
    }
  }
}

// x = A^-1 b by the Jacobi-normalized inverse, as smalllinalg.py's
// `scaled_sym_solve` (D >= 2): D^-1 inv(D^-1 A D^-1) D^-1 b with
// D = sqrt(clamp(diag A, 1e-30)).
template <typename T, int D>
GBP_HD void scaled_sym_solve(const T (&a)[D][D], const T (&b)[D], T (&x)[D]) {
  static_assert(D >= 2, "scaled_sym_solve: d = 1 divides directly");
  T s[D];
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = g_sqrt(max_nan(a[i][i], T(1e-30)));
  T a_n[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) a_n[i][j] = a[i][j] / (s[i] * s[j]);
  }
  T inv_n[D][D];
  SymInv<T, D>::run(a_n, inv_n);
  T b_n[D], y[D];
#pragma unroll
  for (int i = 0; i < D; ++i) b_n[i] = b[i] / s[i];
  mv(inv_n, b_n, y);
#pragma unroll
  for (int i = 0; i < D; ++i) x[i] = y[i] / s[i];
}

// out = 0.5 * (a + a^T).
template <typename T, int D>
GBP_HD void sym(const T (&a)[D][D], T (&out)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) out[i][j] = T(0.5) * (a[i][j] + a[j][i]);
  }
}

}  // namespace gbp
