// The step of kernels 2 and 3 (csrc/live_scan.cu, live_bank_scan_kernel
// and live_bank_scan_mixed_kernel): the live block-sparse predict with
// diagonal Q, then the closed-form update of one of the 8 live kinds
// (live_lane.LANE_KINDS), split into phases that run one after another,
// with a barrier between two phases. Kernel 2 updates the one kind
// ECEF_POS every step, a compile-time constant; kernel 3 the step's kind
// of a schedule. Both run the same step loop (scan, at the end).
//
// Every function here is __host__ __device__ and templated on the scalar
// type: the card instantiates float, and the tests build this file with
// the host C++ compiler as double (REDNOSE_LIVE_MIXED_HOST, the entry points
// live_mixed_host and live_scan_host at the end), which runs the same phases
// in barrier order.
//
// A filter's state is read through Lane<S>: element i at p[i * ld]. On the
// card p points into a block's shared-memory tile, [(i * DE + j)][32] for
// P, so the 32 lanes of a warp (32 filters) touch 32 consecutive words; on
// the host ld is 1. The phases, and who runs them (W roles, one warp each
// on the card; role r handles its share of the entries of a split phase):
//   1. nominal (one role): the nominal predict of x and the 27
//      coefficients of dt A (dt R(q), dt [R(q) w]x, dt [R(q) a]x) from the
//      old x, into the scratch;
//   2. predict_m (split by column): M = (dt A) P, rows 0:9, into the
//      scratch;
//   3. predict_p (split): P += M + M^T + M (dt A)^T / 2 + its transpose on
//      the 9 x 9 block, M on the 9 x 13 coupling, dt q on the diagonal;
//   4. innovate<KIND> (one role): h, H, HP = H P, S, S^-1, the gate, K,
//      the Joseph factor Tm = 0.5 S K^T - HP into the scratch, then the
//      error injection and quaternion renorm of x;
//   5. joseph (split): P += W + W^T, W = K Tm, over the 253 upper-triangle
//      entries; the next step's nominal overlaps it (it reads and writes
//      only x and the coefficients, which the Joseph phase does not touch).
// A phase writes P only at the entries it computes and reads P only at
// those and at entries no phase beside it writes, so each entry is stored
// as soon as it is computed. The gate decision, K and dx exist once per
// filter and step (phase 4); every role reads K and Tm from the scratch.
// Each symmetric entry is computed once and written to (i, j) and (j, i),
// so P stays bitwise symmetric. The gate compares dist > thresh, false for
// a NaN distance.

#ifndef REDNOSE_LIVE_MIXED_CUH
#define REDNOSE_LIVE_MIXED_CUH

#include <math.h>
#include <stddef.h>

#ifdef __CUDACC__
#define LM_HD __host__ __device__ __forceinline__
#else
#define LM_HD inline
#endif

namespace live_mixed {

// roles (warps) a block splits each step across, kernel 3's (WARPS) and
// kernel 2's (POS_WARPS); measured on the H100 among 1, 2, 4 and 8
// (PERF.md): at 8 kernel 3 needs 213 registers a thread and fits one block
// an SM, kernel 2 keeps 128 and two
constexpr int WARPS = 4;
constexpr int POS_WARPS = 8;

constexpr int DX = 23;
constexpr int DE = 22;
constexpr int NTRI = DE * (DE + 1) / 2;
constexpr double EARTH_GM = 3.986005e14;

// live observation kinds (models/live.py ObservationKind)
constexpr int ODOMETRIC_SPEED = 3;
constexpr int PHONE_GYRO = 4;
constexpr int NO_ROT = 9;
constexpr int PHONE_ACCEL = 10;
constexpr int ECEF_POS = 12;
constexpr int CAMERA_ODO_TRANSLATION = 13;
constexpr int CAMERA_ODO_ROTATION = 14;
constexpr int IMU_FRAME = 19;

// error-state column offsets (models/live.py States *_ERR slices)
constexpr int C_POS = 0, C_ATT = 3, C_VEL = 6, C_OMEGA = 9;
constexpr int C_BIAS = 12, C_SCALE = 15, C_ACC = 16, C_OFF = 19;

// scratch, values per filter: the coefficients of dt A, then M (9 x 22)
// during the predict, or K (22 x 3, row-major) and Tm (3 x 22) during the
// update, in the same room
constexpr int SC_COEF = 0;
constexpr int SC_M = 27;
constexpr int SC_K = 27;
constexpr int SC_T = SC_K + DE * 3;
constexpr int NSC = SC_M + 9 * DE;
// values per filter in a block's tile: P, x, scratch
constexpr int TILE = DE * DE + DX + NSC;

template <typename S>
struct Lane {
  S* p;
  int ld;
  LM_HD S& operator[](int i) const { return p[(size_t)i * ld]; }
};

LM_HD float m_sqrt(float a) { return sqrtf(a); }
LM_HD double m_sqrt(double a) { return sqrt(a); }
LM_HD float m_sin(float a) { return sinf(a); }
LM_HD double m_sin(double a) { return sin(a); }
LM_HD float m_cos(float a) { return cosf(a); }
LM_HD double m_cos(double a) { return cos(a); }
LM_HD float m_fmax(float a, float b) { return fmaxf(a, b); }
LM_HD double m_fmax(double a, double b) { return fmax(a, b); }
LM_HD float m_rsqrt(float a) {
#ifdef __CUDA_ARCH__
  return rsqrtf(a);
#else
  return 1.0f / sqrtf(a);
#endif
}
LM_HD double m_rsqrt(double a) { return 1.0 / sqrt(a); }

// A read-only input on the card goes through the read-only cache (ldg), a
// measurement row, read once, is streamed past it (ldcs)
template <typename S>
LM_HD S m_ldg(const S* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}
template <typename S>
LM_HD S m_ldcs(const S* p) {
#ifdef __CUDA_ARCH__
  return __ldcs(p);
#else
  return *p;
#endif
}

// dz of a live lane kind, 0 for any other kind
LM_HD int kind_dz(int kind) {
  switch (kind) {
    case ODOMETRIC_SPEED:
      return 1;
    case PHONE_GYRO:
    case NO_ROT:
    case PHONE_ACCEL:
    case ECEF_POS:
    case CAMERA_ODO_TRANSLATION:
    case CAMERA_ODO_ROTATION:
    case IMU_FRAME:
      return 3;
    default:
      return 0;
  }
}

template <typename S>
LM_HD void quat_to_rot(const S* q, S R[3][3]) {
  const S q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  R[0][0] = q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3;
  R[0][1] = S(2) * (q1 * q2 - q0 * q3);
  R[0][2] = S(2) * (q1 * q3 + q0 * q2);
  R[1][0] = S(2) * (q1 * q2 + q0 * q3);
  R[1][1] = q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3;
  R[1][2] = S(2) * (q2 * q3 - q0 * q1);
  R[2][0] = S(2) * (q1 * q3 - q0 * q2);
  R[2][1] = S(2) * (q2 * q3 + q0 * q1);
  R[2][2] = q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3;
}

template <typename S>
LM_HD void skew(const S v[3], S M[3][3]) {
  M[0][0] = S(0);  M[0][1] = -v[2]; M[0][2] = v[1];
  M[1][0] = v[2];  M[1][1] = S(0);  M[1][2] = -v[0];
  M[2][0] = -v[1]; M[2][1] = v[0];  M[2][2] = S(0);
}

template <typename S>
LM_HD void mm3(const S A[3][3], const S B[3][3], S C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

template <typename S>
LM_HD void mv3(const S A[3][3], const S v[3], S out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2];
}

template <typename S>
LM_HD void transpose3(const S A[3][3], S T[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i][j] = A[j][i];
}

template <typename S>
LM_HD void cross3(const S a[3], const S b[3], S out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename S>
LM_HD void normalize_quat(S* x) {
  const S inv = m_rsqrt(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
  x[3] *= inv;
  x[4] *= inv;
  x[5] *= inv;
  x[6] *= inv;
}

// euler_to_rot: R = Rz(yaw) Ry(pitch) Rx(roll)
template <typename S>
LM_HD void euler_rot(const S e[3], S R[3][3]) {
  const S cr = m_cos(e[0]), sr = m_sin(e[0]);
  const S cp = m_cos(e[1]), sp = m_sin(e[1]);
  const S cy = m_cos(e[2]), sy = m_sin(e[2]);
  const S rr[3][3] = {{S(1), S(0), S(0)}, {S(0), cr, -sr}, {S(0), sr, cr}};
  const S rp[3][3] = {{cp, S(0), sp}, {S(0), S(1), S(0)}, {-sp, S(0), cp}};
  const S ry[3][3] = {{cy, -sy, S(0)}, {sy, cy, S(0)}, {S(0), S(0), S(1)}};
  S pr[3][3];
  mm3(rp, rr, pr);
  mm3(ry, pr, R);
}

// d(R(e) u)/de given R(e) and u' = R(e) u: columns (R e_x) x u',
// (Rz e_y) x u', e_z x u'
template <typename S>
LM_HD void d_euler_rot(const S e[3], const S Re[3][3], const S up[3],
                       S D[3][3]) {
  const S cy = m_cos(e[2]), sy = m_sin(e[2]);
  const S ex[3] = {Re[0][0], Re[1][0], Re[2][0]};
  const S ey[3] = {-sy, cy, S(0)};
  const S ez[3] = {S(0), S(0), S(1)};
  S c0[3], c1[3], c2[3];
  cross3(ex, up, c0);
  cross3(ey, up, c1);
  cross3(ez, up, c2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    D[i][0] = c0[i];
    D[i][1] = c1[i];
    D[i][2] = c2[i];
  }
}

// ------------------------------------------------------------ the predict

// Phase 1: x <- f(x, dt) (first-order integrator, all from the old state,
// quaternion renormalized), and the coefficients dt Rq, dt [Rq w]x,
// dt [Rq a]x of the old x into the scratch.
template <typename S>
LM_HD void nominal(Lane<S> x, Lane<S> sc, S dt) {
  S xv[DX];
#pragma unroll
  for (int i = 0; i < DX; ++i) xv[i] = x[i];
  S Rq[3][3];
  quat_to_rot(xv + 3, Rq);
  const S* w = xv + 10;
  const S* a = xv + 17;
  S wd[3], ad[3];
  mv3(Rq, w, wd);
  mv3(Rq, a, ad);

  S xn[DX];
#pragma unroll
  for (int i = 0; i < DX; ++i) xn[i] = xv[i];
  const S q0 = xv[3], q1 = xv[4], q2 = xv[5], q3 = xv[6];
  const S qd0 = S(0.5) * (-w[0] * q1 - w[1] * q2 - w[2] * q3);
  const S qd1 = S(0.5) * (w[0] * q0 + w[2] * q2 - w[1] * q3);
  const S qd2 = S(0.5) * (w[1] * q0 - w[2] * q1 + w[0] * q3);
  const S qd3 = S(0.5) * (w[2] * q0 + w[1] * q1 - w[0] * q2);
#pragma unroll
  for (int i = 0; i < 3; ++i) xn[i] = xv[i] + dt * xv[7 + i];
  xn[3] = q0 + dt * qd0;
  xn[4] = q1 + dt * qd1;
  xn[5] = q2 + dt * qd2;
  xn[6] = q3 + dt * qd3;
#pragma unroll
  for (int i = 0; i < 3; ++i) xn[7 + i] = xv[7 + i] + dt * ad[i];
  normalize_quat(xn);
#pragma unroll
  for (int i = 0; i < DX; ++i) x[i] = xn[i];

  S Swd[3][3], Sad[3][3];
  skew(wd, Swd);
  skew(ad, Sad);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      sc[SC_COEF + i * 3 + j] = dt * Rq[i][j];
      sc[SC_COEF + 9 + i * 3 + j] = Swd[i][j] * dt;
      sc[SC_COEF + 18 + i * 3 + j] = Sad[i][j] * dt;
    }
}

// Phase 2: M = (dt A) P, rows 0:9 (pos <- vel, att, vel rows), role r
// taking the columns j = r, r + W, ...
template <typename S, int W>
LM_HD void predict_m(int role, Lane<S> P, Lane<S> sc, S dt) {
  S Rqd[3][3], Swd[3][3], Sad[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Rqd[i][j] = sc[SC_COEF + i * 3 + j];
      Swd[i][j] = sc[SC_COEF + 9 + i * 3 + j];
      Sad[i][j] = sc[SC_COEF + 18 + i * 3 + j];
    }
  for (int j = role; j < DE; j += W) {
    S pa[3], pv[3], pw[3], pc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pa[k] = P[(C_ATT + k) * DE + j];
      pv[k] = P[(C_VEL + k) * DE + j];
      pw[k] = P[(C_OMEGA + k) * DE + j];
      pc[k] = P[(C_ACC + k) * DE + j];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sc[SC_M + i * DE + j] = dt * pv[i];
      sc[SC_M + (3 + i) * DE + j] =
          (Rqd[i][0] * pw[0] + Rqd[i][1] * pw[1] + Rqd[i][2] * pw[2])
          - (Swd[i][0] * pa[0] + Swd[i][1] * pa[1] + Swd[i][2] * pa[2]);
      sc[SC_M + (6 + i) * DE + j] =
          (Rqd[i][0] * pc[0] + Rqd[i][1] * pc[1] + Rqd[i][2] * pc[2])
          - (Sad[i][0] * pa[0] + Sad[i][1] * pa[1] + Sad[i][2] * pa[2]);
    }
  }
}

// Half of N = M (dt A)^T at (r, c), r, c < 9, from M and the coefficients
// in the scratch.
template <typename S>
LM_HD S half_n(Lane<S> sc, int r, int c, S dt) {
  const int m = SC_M + r * DE;
  const int cc = c % 3;
  if (c < 3) return (S(0.5) * dt) * sc[m + C_VEL + cc];
  const int rq = SC_COEF + cc * 3;
  const int sk = SC_COEF + (c < 6 ? 9 : 18) + cc * 3;
  const int col = c < 6 ? C_OMEGA : C_ACC;
  return S(0.5) * (
      (sc[m + col] * sc[rq] + sc[m + col + 1] * sc[rq + 1]
       + sc[m + col + 2] * sc[rq + 2])
      - (sc[m + C_ATT] * sc[sk] + sc[m + C_ATT + 1] * sc[sk + 1]
         + sc[m + C_ATT + 2] * sc[sk + 2]));
}

// Phase 3: the new P on the 9 x 9 block (its 45 upper-triangle entries
// split over the roles), the 9 x 13 coupling and the diagonal Q adds
// (columns 9..21 split over the roles).
template <typename S, int W>
LM_HD void predict_p(int role, Lane<S> P, Lane<S> sc, const S* q_diag,
                     S dt) {
  for (int e = role; e < 45; e += W) {
    int i = 0, r = e;
    while (r >= 9 - i) {
      r -= 9 - i;
      ++i;
    }
    const int j = i + r;
    S v = (P[i * DE + j] + (sc[SC_M + i * DE + j] + sc[SC_M + j * DE + i]))
          + (half_n(sc, i, j, dt) + half_n(sc, j, i, dt));
    if (i == j) v = v + dt * q_diag[i];
    P[i * DE + j] = v;
    P[j * DE + i] = v;
  }
  for (int j = 9 + role; j < DE; j += W) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const S v = P[i * DE + j] + sc[SC_M + i * DE + j];
      P[i * DE + j] = v;
      P[j * DE + i] = v;
    }
    P[j * DE + j] = P[j * DE + j] + dt * q_diag[j];
  }
}

// ------------------------------------------------------------- the update

// The blocks of H = H_raw @ H_mod of one kind (live_lane._hH_*): block nb
// covers error-state columns col(nb) .. col(nb) + width(nb); IDENT kinds
// have one identity block.
template <int KIND>
struct Kind;
template <>
struct Kind<ECEF_POS> {
  static constexpr int dz = 3, nb = 1, off = 0;
  static constexpr bool ident = true;
  LM_HD static constexpr int col(int) { return C_POS; }
  LM_HD static constexpr int width(int) { return 3; }
};
template <>
struct Kind<NO_ROT> {
  static constexpr int dz = 3, nb = 1, off = 10;
  static constexpr bool ident = true;
  LM_HD static constexpr int col(int) { return C_OMEGA; }
  LM_HD static constexpr int width(int) { return 3; }
};
template <>
struct Kind<CAMERA_ODO_ROTATION> {
  static constexpr int dz = 3, nb = 1, off = 10;
  static constexpr bool ident = true;
  LM_HD static constexpr int col(int) { return C_OMEGA; }
  LM_HD static constexpr int width(int) { return 3; }
};
template <>
struct Kind<IMU_FRAME> {
  static constexpr int dz = 3, nb = 1, off = 20;
  static constexpr bool ident = true;
  LM_HD static constexpr int col(int) { return C_OFF; }
  LM_HD static constexpr int width(int) { return 3; }
};
template <>
struct Kind<ODOMETRIC_SPEED> {
  static constexpr int dz = 1, nb = 2, off = 0;
  static constexpr bool ident = false;
  LM_HD static constexpr int col(int nb) { return nb == 0 ? C_VEL : C_SCALE; }
  LM_HD static constexpr int width(int nb) { return nb == 0 ? 3 : 1; }
};
template <>
struct Kind<CAMERA_ODO_TRANSLATION> {
  static constexpr int dz = 3, nb = 2, off = 0;
  static constexpr bool ident = false;
  LM_HD static constexpr int col(int nb) { return nb == 0 ? C_ATT : C_VEL; }
  LM_HD static constexpr int width(int) { return 3; }
};
template <>
struct Kind<PHONE_GYRO> {
  static constexpr int dz = 3, nb = 3, off = 0;
  static constexpr bool ident = false;
  LM_HD static constexpr int col(int nb) {
    return nb == 0 ? C_OMEGA : (nb == 1 ? C_BIAS : C_OFF);
  }
  LM_HD static constexpr int width(int) { return 3; }
};
template <>
struct Kind<PHONE_ACCEL> {
  static constexpr int dz = 3, nb = 4, off = 0;
  static constexpr bool ident = false;
  LM_HD static constexpr int col(int nb) {
    return nb == 0 ? C_POS : (nb == 1 ? C_ATT : (nb == 2 ? C_ACC : C_OFF));
  }
  LM_HD static constexpr int width(int) { return 3; }
};

template <typename S>
LM_HD void copy3(const S A[3][3], S B[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) B[i][j] = A[i][j];
}

// h and the non-identity H blocks of a kind at x (live_lane._hH_*)
template <typename S, int KIND>
LM_HD void build_h(const S* x, S h[3], S H[4][3][3]) {
  if constexpr (Kind<KIND>::ident) {
#pragma unroll
    for (int i = 0; i < 3; ++i) h[i] = x[Kind<KIND>::off + i];
  } else if constexpr (KIND == ODOMETRIC_SPEED) {
    const S* v = x + 7;
    const S s = x[16];
    const S speed = m_sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
    // |v| -> 0: clamped, a standstill update is information-free on the
    // velocity rows instead of NaN
    const S c = s / m_fmax(speed, S(1e-6));
    h[0] = speed * s;
#pragma unroll
    for (int k = 0; k < 3; ++k) H[0][0][k] = c * v[k];
    H[1][0][0] = speed;
  } else if constexpr (KIND == CAMERA_ODO_TRANSLATION) {
    S Rq[3][3], RqT[3][3], Sv[3][3];
    quat_to_rot(x + 3, Rq);
    transpose3(Rq, RqT);
    mv3(RqT, x + 7, h);
    skew(x + 7, Sv);
    mm3(RqT, Sv, H[0]);
    copy3(RqT, H[1]);
  } else if constexpr (KIND == PHONE_GYRO) {
    const S* o = x + 20;
    S Re[3][3], wb[3];
    euler_rot(o, Re);
#pragma unroll
    for (int i = 0; i < 3; ++i) wb[i] = x[10 + i] + x[13 + i];
    mv3(Re, wb, h);
    d_euler_rot(o, Re, h, H[2]);
    copy3(Re, H[0]);
    copy3(Re, H[1]);
  } else {  // PHONE_ACCEL
    const S* p = x;
    const S* o = x + 20;
    S Rq[3][3], RqT[3][3], Re[3][3], ReRqT[3][3];
    quat_to_rot(x + 3, Rq);
    transpose3(Rq, RqT);
    euler_rot(o, Re);
    const S r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
    const S scale = S(EARTH_GM) / (r2 * m_sqrt(r2));
    S u[3], g[3], ga[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = scale * p[i];   // GM p / r^3
    mv3(RqT, u, g);
#pragma unroll
    for (int i = 0; i < 3; ++i) ga[i] = g[i] + x[17 + i];
    mv3(Re, ga, h);
    mm3(Re, RqT, ReRqT);
    // d u / d p = scale * (I - 3 p p^T / r^2)
    S IP[3][3], Su[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        IP[i][j] = (i == j ? S(1) : S(0)) - p[i] * p[j] * (S(3) / r2);
    mm3(ReRqT, IP, H[0]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) H[0][i][j] *= scale;
    skew(u, Su);
    mm3(ReRqT, Su, H[1]);
    copy3(Re, H[2]);
    d_euler_rot(o, Re, h, H[3]);
  }
}

// Phase 4 (live_lane.live_update_slab): HP = H P, S = HP H^T + R,
// K = HP^T S^-1, the zero-gain gate, Tm = 0.5 S K^T - HP; K and Tm into
// the scratch; then dx = K y, the error injection (the quaternion composes
// with [1, 0.5 dtheta]) and the renorm of x.
template <typename S, int KIND>
LM_HD void innovate(Lane<S> x, Lane<S> P, Lane<S> sc, const S z[3],
                    const S R[3][3], bool gate, S gate_thresh) {
  using KI = Kind<KIND>;
  constexpr int dz = KI::dz;
  S xv[DX];
#pragma unroll
  for (int i = 0; i < DX; ++i) xv[i] = x[i];
  S h[3], H[4][3][3];
  build_h<S, KIND>(xv, h, H);
  S y[3];
#pragma unroll
  for (int r = 0; r < dz; ++r) y[r] = z[r] - h[r];

  S HP[dz][DE];
#pragma unroll
  for (int j = 0; j < DE; ++j)
#pragma unroll
    for (int r = 0; r < dz; ++r) HP[r][j] = S(0);
#pragma unroll
  for (int nb = 0; nb < KI::nb; ++nb) {
    const int col = KI::col(nb);
#pragma unroll
    for (int j = 0; j < DE; ++j) {
#pragma unroll
      for (int r = 0; r < dz; ++r) {
        S term;
        if constexpr (KI::ident) {
          term = P[(col + r) * DE + j];
        } else {
          term = S(0);
#pragma unroll
          for (int k = 0; k < KI::width(nb); ++k)
            term += H[nb][r][k] * P[(col + k) * DE + j];
        }
        HP[r][j] += term;
      }
    }
  }

  S Sm[3][3];
#pragma unroll
  for (int r = 0; r < dz; ++r)
#pragma unroll
    for (int c = 0; c < dz; ++c) {
      S s = S(0);
#pragma unroll
      for (int nb = 0; nb < KI::nb; ++nb) {
        const int col = KI::col(nb);
        if constexpr (KI::ident) {
          s += HP[r][col + c];
        } else {
          S term = S(0);
#pragma unroll
          for (int k = 0; k < KI::width(nb); ++k)
            term += HP[r][col + k] * H[nb][c][k];
          s += term;
        }
      }
      Sm[r][c] = s + R[r][c];
    }

  S Si[3][3];
  if constexpr (dz == 1) {
    Si[0][0] = S(1) / Sm[0][0];
  } else {
    const S c00 = Sm[1][1] * Sm[2][2] - Sm[1][2] * Sm[2][1];
    const S c01 = Sm[0][2] * Sm[2][1] - Sm[0][1] * Sm[2][2];
    const S c02 = Sm[0][1] * Sm[1][2] - Sm[0][2] * Sm[1][1];
    const S c10 = Sm[1][2] * Sm[2][0] - Sm[1][0] * Sm[2][2];
    const S c11 = Sm[0][0] * Sm[2][2] - Sm[0][2] * Sm[2][0];
    const S c12 = Sm[0][2] * Sm[1][0] - Sm[0][0] * Sm[1][2];
    const S c20 = Sm[1][0] * Sm[2][1] - Sm[1][1] * Sm[2][0];
    const S c21 = Sm[0][1] * Sm[2][0] - Sm[0][0] * Sm[2][1];
    const S c22 = Sm[0][0] * Sm[1][1] - Sm[0][1] * Sm[1][0];
    const S det = Sm[0][0] * c00 + Sm[0][1] * c10 + Sm[0][2] * c20;
    Si[0][0] = c00 / det; Si[0][1] = c01 / det; Si[0][2] = c02 / det;
    Si[1][0] = c10 / det; Si[1][1] = c11 / det; Si[1][2] = c12 / det;
    Si[2][0] = c20 / det; Si[2][1] = c21 / det; Si[2][2] = c22 / det;
  }

  bool gated = false;
  if (gate) {
    S dist = S(0);
#pragma unroll
    for (int i = 0; i < dz; ++i)
#pragma unroll
      for (int j = 0; j < dz; ++j) dist += y[i] * Si[i][j] * y[j];
    gated = dist > gate_thresh;  // NaN compares false: not gated
  }

  S dx[DE];
#pragma unroll
  for (int i = 0; i < DE; ++i) {
    S Ki[3];
#pragma unroll
    for (int c = 0; c < dz; ++c) {
      S v = S(0);
#pragma unroll
      for (int k = 0; k < dz; ++k) v += HP[k][i] * Si[k][c];
      Ki[c] = gated ? S(0) : v;
      sc[SC_K + i * 3 + c] = Ki[c];
    }
    // Joseph factor column i: Tm[r][i] = 0.5 (S K^T)[r][i] - HP[r][i]
#pragma unroll
    for (int r = 0; r < dz; ++r) {
      S v = S(0);
#pragma unroll
      for (int k = 0; k < dz; ++k) v += Sm[r][k] * Ki[k];
      sc[SC_T + r * DE + i] = S(0.5) * v - HP[r][i];
    }
    S d = S(0);
#pragma unroll
    for (int k = 0; k < dz; ++k) d += Ki[k] * y[k];
    dx[i] = d;
  }

  const S q0 = xv[3], q1 = xv[4], q2 = xv[5], q3 = xv[6];
  const S d1 = S(0.5) * dx[3], d2 = S(0.5) * dx[4], d3 = S(0.5) * dx[5];
#pragma unroll
  for (int i = 0; i < 3; ++i) xv[i] += dx[i];
  xv[3] = q0 - q1 * d1 - q2 * d2 - q3 * d3;
  xv[4] = q1 + q0 * d1 + q3 * d2 - q2 * d3;
  xv[5] = q2 - q3 * d1 + q0 * d2 + q1 * d3;
  xv[6] = q3 + q2 * d1 - q1 * d2 + q0 * d3;
#pragma unroll
  for (int i = 0; i < 16; ++i) xv[7 + i] += dx[6 + i];
  normalize_quat(xv);
#pragma unroll
  for (int i = 0; i < DX; ++i) x[i] = xv[i];
}

// Phase 4 for the kind of this step: a switch that is uniform across the
// bank. Returns the kind's dz (0 and no update for a kind that is not a
// live lane kind; the wrapper refuses those).
template <typename S>
LM_HD int innovate_kind(int kind, Lane<S> x, Lane<S> P, Lane<S> sc,
                        const S z[3], const S R[3][3], bool gate,
                        S gate_thresh) {
  switch (kind) {
    case ECEF_POS:
      innovate<S, ECEF_POS>(x, P, sc, z, R, gate, gate_thresh);
      return 3;
    case NO_ROT:
      innovate<S, NO_ROT>(x, P, sc, z, R, gate, gate_thresh);
      return 3;
    case CAMERA_ODO_ROTATION:
      innovate<S, CAMERA_ODO_ROTATION>(x, P, sc, z, R, gate, gate_thresh);
      return 3;
    case IMU_FRAME:
      innovate<S, IMU_FRAME>(x, P, sc, z, R, gate, gate_thresh);
      return 3;
    case ODOMETRIC_SPEED:
      innovate<S, ODOMETRIC_SPEED>(x, P, sc, z, R, gate, gate_thresh);
      return 1;
    case CAMERA_ODO_TRANSLATION:
      innovate<S, CAMERA_ODO_TRANSLATION>(x, P, sc, z, R, gate,
                                          gate_thresh);
      return 3;
    case PHONE_GYRO:
      innovate<S, PHONE_GYRO>(x, P, sc, z, R, gate, gate_thresh);
      return 3;
    case PHONE_ACCEL:
      innovate<S, PHONE_ACCEL>(x, P, sc, z, R, gate, gate_thresh);
      return 3;
    default:
      return 0;
  }
}

// Phase 5: P(i, j) += W(i, j) + W(j, i), W = K Tm, over the upper
// triangle in row-major order, role r taking the entries r, r + W, ...;
// the row's K and Tm values stay in registers while the row lasts.
template <typename S, int DZ, int W>
LM_HD void joseph(int role, Lane<S> P, Lane<S> sc) {
  int i = 0, j = role;
  while (j >= DE) {  // the role's first entry: skip whole rows
    const int o = j - DE;
    ++i;
    j = i + o;
  }
  int row = -1;
  S Ki[DZ] = {}, Ti[DZ] = {};
  for (int e = role; e < NTRI; e += W) {
    if (i != row) {
#pragma unroll
      for (int k = 0; k < DZ; ++k) {
        Ki[k] = sc[SC_K + i * 3 + k];
        Ti[k] = sc[SC_T + k * DE + i];
      }
      row = i;
    }
    S wij = S(0), wji = S(0);
#pragma unroll
    for (int k = 0; k < DZ; ++k) {
      wij += Ki[k] * sc[SC_T + k * DE + j];
      wji += sc[SC_K + j * 3 + k] * Ti[k];
    }
    const S v = P[i * DE + j] + (wij + wji);
    P[i * DE + j] = v;
    P[j * DE + i] = v;
    if (e + W >= NTRI) break;  // past the last entry there is no next row
    j += W;
    while (j >= DE) {
      const int o = j - DE;
      ++i;
      j = i + o;
    }
  }
}

template <typename S, int W>
LM_HD void joseph_dz(int dz, int role, Lane<S> P, Lane<S> sc) {
  if (dz == 3)
    joseph<S, 3, W>(role, P, sc);
  else if (dz == 1)
    joseph<S, 1, W>(role, P, sc);
}

// The step's R: diag(r_stream[t]) for a streamed kind, else the kind's R
template <typename S>
LM_HD void step_R(int ki, int t, const S* R_by_kind, const int* stream_flags,
                  const S* r_stream, S R[3][3]) {
  const bool streamed = m_ldg(stream_flags + ki) != 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[i][j] = streamed ? (i == j ? m_ldg(r_stream + t * 3 + i) : S(0))
                         : m_ldg(R_by_kind + ki * 9 + i * 3 + j);
}

// ------------------------------------------------------------ the step loop

// Who runs a phase. On the card (CardRoles) a thread is the role of its
// warp, and a barrier ends each phase; on the host (HostRoles<W>) every
// role of a split phase runs in turn, so the phases run in barrier order.
struct CardRoles {
  int role;
  template <typename F>
  LM_HD void all(F f) const { f(role); }
  template <typename F>
  LM_HD void one(int r, F f) const {
    if (role == r) f();
  }
  LM_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

template <int W>
struct HostRoles {
  template <typename F>
  LM_HD void all(F f) const {
    for (int r = 0; r < W; ++r) f(r);
  }
  template <typename F>
  LM_HD void one(int, F f) const { f(); }
  LM_HD void sync() const {}
};

// Kernel 2's inputs of filter b at step t: the ECEF_POS fix zs[t, :, b],
// the one R and gate threshold.
template <typename S>
struct PosInput {
  const S* zs;
  const S* dts;
  const S* R;
  S thresh;
  int B, b;
  LM_HD S dt(int t) const { return m_ldg(dts + t); }
  LM_HD void step(int t, S z[3], S Rt[3][3], S* th) const {
#pragma unroll
    for (int r = 0; r < 3; ++r) z[r] = m_ldcs(zs + ((size_t)t * 3 + r) * B + b);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Rt[i][j] = m_ldg(R + i * 3 + j);
    *th = thresh;
  }
};

// Kernel 3's inputs of filter b at step t: the kind kinds[kind_idx[t]],
// its measurement row, its R (streamed or the kind's) and gate threshold.
template <typename S>
struct MixedInput {
  const S* zs;
  const S* dts;
  const int* kind_idx;
  const int* kinds;
  const S* R_by_kind;
  const int* stream_flags;
  const S* gate_thresh;
  const S* r_stream;
  int B, b;
  LM_HD S dt(int t) const { return m_ldg(dts + t); }
  LM_HD int kind(int t) const { return m_ldg(kinds + m_ldg(kind_idx + t)); }
  LM_HD void step(int t, S z[3], S R[3][3], S* th) const {
    const int ki = m_ldg(kind_idx + t);
    step_R(ki, t, R_by_kind, stream_flags, r_stream, R);
#pragma unroll
    for (int r = 0; r < 3; ++r) z[r] = m_ldcs(zs + ((size_t)t * 3 + r) * B + b);
    *th = m_ldg(gate_thresh + ki);
  }
};

// KIND of scan for a schedule: each step's kind is read from the input
constexpr int ANY_KIND = -1;

// T steps of one filter (x, P and the scratch sc) through the five phases,
// a barrier after each (roles.sync()). KIND is a live kind, every step's
// (kernel 2: no switch, no step_R), or ANY_KIND, each step's from in.kind
// (kernel 3: a switch that is uniform across the bank). The nominal
// predict of step t + 1 runs on the last role beside step t's Joseph phase.
template <typename S, int W, int KIND, typename Roles, typename In>
LM_HD void scan(const Roles& roles, Lane<S> x, Lane<S> P, Lane<S> sc,
                const S* q_diag, int T, bool gate, const In& in) {
  constexpr int NOMINAL_ROLE = W - 1;
  if (T > 0) roles.one(NOMINAL_ROLE, [&] { nominal(x, sc, in.dt(0)); });
  roles.sync();
  for (int t = 0; t < T; ++t) {
    const S dt = in.dt(t);
    roles.all([&](int r) { predict_m<S, W>(r, P, sc, dt); });
    roles.sync();
    roles.all([&](int r) { predict_p<S, W>(r, P, sc, q_diag, dt); });
    roles.sync();
    int kind = KIND;
    if constexpr (KIND == ANY_KIND) kind = in.kind(t);
    roles.one(0, [&] {
      S z[3], R[3][3], thresh;
      in.step(t, z, R, &thresh);
      if constexpr (KIND == ANY_KIND)
        innovate_kind(kind, x, P, sc, z, R, gate, thresh);
      else
        innovate<S, KIND>(x, P, sc, z, R, gate, thresh);
    });
    roles.sync();
    roles.all([&](int r) {
      if constexpr (KIND == ANY_KIND)
        joseph_dz<S, W>(kind_dz(kind), r, P, sc);
      else
        joseph<S, Kind<KIND>::dz, W>(r, P, sc);
      if (r == NOMINAL_ROLE && t + 1 < T) nominal(x, sc, in.dt(t + 1));
    });
    roles.sync();
  }
}

}  // namespace live_mixed

#if defined(REDNOSE_LIVE_MIXED_HOST) && !defined(__CUDACC__)

// The host builds (tests): filter by filter, the kernels' step loop with
// each kernel's roles in barrier order, float64, each kernel's argument
// layout.
template <int W, int KIND, typename In>
static void live_host_bank(double* xs, double* Ps, const double* q_diag,
                           int T, int B, int gate, In in) {
  using namespace live_mixed;
  for (int b = 0; b < B; ++b) {
    double xl[DX], Pl[DE * DE], sl[NSC];
    for (int i = 0; i < DX; ++i) xl[i] = xs[(size_t)i * B + b];
    for (int e = 0; e < DE * DE; ++e) Pl[e] = Ps[(size_t)e * B + b];
    const Lane<double> x{xl, 1}, P{Pl, 1}, sc{sl, 1};
    in.b = b;
    scan<double, W, KIND>(HostRoles<W>{}, x, P, sc, q_diag, T, gate != 0,
                          in);
    for (int i = 0; i < DX; ++i) xs[(size_t)i * B + b] = xl[i];
    for (int e = 0; e < DE * DE; ++e) Ps[(size_t)e * B + b] = Pl[e];
  }
}

// kernel 3 (live_bank_scan_mixed_launch's arguments)
extern "C" int live_mixed_host(double* xs, double* Ps, const double* zs,
                               const double* dts, const int* kind_idx,
                               const int* kinds, const double* R_by_kind,
                               const int* stream_flags,
                               const double* gate_thresh,
                               const double* r_stream, const double* q_diag,
                               int T, int B, int gate) {
  using namespace live_mixed;
  live_host_bank<WARPS, ANY_KIND>(
      xs, Ps, q_diag, T, B, gate,
      MixedInput<double>{zs, dts, kind_idx, kinds, R_by_kind, stream_flags,
                         gate_thresh, r_stream, B, 0});
  return 0;
}

// kernel 2 (live_bank_scan_launch's arguments)
extern "C" int live_scan_host(double* xs, double* Ps, const double* zs,
                              const double* dts, const double* q_diag,
                              const double* R, int T, int B, int gate,
                              double gate_thresh) {
  using namespace live_mixed;
  live_host_bank<POS_WARPS, ECEF_POS>(
      xs, Ps, q_diag, T, B, gate,
      PosInput<double>{zs, dts, R, gate_thresh, B, 0});
  return 0;
}

#endif  // REDNOSE_LIVE_MIXED_HOST
#endif  // REDNOSE_LIVE_MIXED_CUH
