// Kernels 2 and 3: fused T-step scans of the live 23/22-dim ESKF bank.
//
// Kernel 2 (live_bank_scan_kernel) replaces the Pallas TPU kernel
// rednose_tpu/ops/pallas_live.py:_kernel (launched by live_bank_scan):
// every step is live_lane.live_step_slab, the block-sparse predict with
// diagonal Q and the ECEF_POS update.
// Kernel 3 (live_bank_scan_mixed_kernel) replaces
// rednose_tpu/ops/pallas_live.py:_mixed_kernel (launched by
// live_bank_scan_mixed): the same predict, then the closed-form update of
// the step's kind, any of the 8 live kinds (live_lane.LANE_KINDS), with a
// per-kind R or a streamed diagonal R (camera-odometry kinds).
// Plain versions and wrappers: rednose_tpu_torch/ops/live_lane.py and
// rednose_tpu_torch/ops/live_scan.py.
//
// Layout, bank-minor: x (23, B), P (22, 22, B), zs (T, 3, B). Element (i, j)
// of filter b's covariance is P[(i * 22 + j) * B + b], so 32 consecutive
// filters' values of every (i, j) are one coalesced 128-byte line.
//
// Kernel 2's design: one thread per filter, a loop over T inside the
// kernel (the TPU grid's sequential time axis). x (23 floats) stays in
// registers. P does not fit: 484 floats exceed the 255 registers a thread
// may hold; kernel 2 keeps P in global memory, updated in place: at
// B = 8192 the whole bank is 15.9 MB and stays resident in the 50 MB L2
// across all T steps, every P access is coalesced. Bound: operations,
// 0.04977 ms at B = 8192, T = 64; in practice the L2 latency of ~1,000 P
// accesses a filter a step, which nothing hides with one warp an SM or
// two. The temporaries M (9 x 22), N (9 x 9), HP, K and the Joseph factor
// (3 x 22 each) are thread-local arrays with run-time indices, in local
// memory. ptxas -v (CUDA 12.8, sm_90a): 200 registers, 1,384-byte stack.
//
// Kernel 3's design (csrc/live_mixed.cuh, redesigned for the H100): a
// block of 32 filters (lane = filter) and live_mixed::WARPS warps (role =
// warp). P, x and 225 scratch values a filter stay in the block's shared
// memory for the whole T loop, 93,696 B a block, laid out [(value)][32] so
// a warp's 32 lanes touch 32 consecutive words (no bank conflict); they are
// loaded once, coalesced, from the bank-minor arrays and stored once. A
// step is five phases between barriers: the nominal predict of x and the
// 27 coefficients of dt A (one warp); M = (dt A) P rows 0:9 into the
// scratch (the warps split the columns); the P predict (the warps split
// the 45 entries of the 9 x 9 block and the columns of the coupling and
// the diagonal Q adds); the innovation of the step's kind (one warp, once
// a filter: h, H, HP, S, S^-1, the gate, K and the Joseph factor into the
// scratch, the error injection of x); the Joseph downdate (the warps split
// the 253 upper-triangle entries). The update is a template on the kind,
// so dz, the H blocks and their widths are constants, every loop unrolls
// and HP, S^-1, K and Tm live in registers or the scratch, never on the
// stack. The kind switch is uniform across the bank, so no warp diverges.
// Bound: operations, 0.05562 ms at B = 8192, T = 64 (the live 4-kind
// cycle, 67 TFLOP/s float32). The one-thread-a-filter kernel 3 it
// replaces ran 9.0530 ms there (80 registers, a 2,344-byte stack for HP,
// K and Tm with run-time indices, P through L2). ptxas -v (CUDA 12.8,
// sm_90a, WARPS = 4): 168 registers, a 32-byte stack frame (sinf / cosf's
// slow path), 0 bytes of spill stores / loads; the runtime fits 2 blocks
// an SM. WARPS = 4 is the fastest of 1, 2, 4 and 8 (sweep_warps.py;
// PERF.md has the times).
//
// Numerics (IEEE f32, no fast-math: the gyro and accel kinds call sinf /
// cosf): P stays bitwise symmetric because every symmetric entry is
// computed once, for the upper triangle, and written to (i, j) and (j, i);
// with FMA contraction, computing (i, j) and (j, i) separately could give
// two values. The quaternion renorm uses rsqrtf (about 2 ulp), where the
// plain torch version uses torch.rsqrt. The gate `dist > thresh` is false
// for a NaN distance, so NaN does not gate. Kernels update x and P in
// place and allocate nothing.

#include <cuda_runtime.h>

#include "live_mixed.cuh"

namespace lm = live_mixed;

namespace {

constexpr int DX = 23;
constexpr int DE = 22;
constexpr float EARTH_GM = 3.986005e14f;

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

// One filter's view of the bank-minor covariance.
struct Cov {
  float* p;  // &P[0, 0, b]
  int B;
  __device__ float& operator()(int i, int j) const {
    return p[(size_t)(i * DE + j) * B];
  }
};

__device__ void quat_to_rot(const float* q, float R[3][3]) {
  const float q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3];
  R[0][0] = q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3;
  R[0][1] = 2.0f * (q1 * q2 - q0 * q3);
  R[0][2] = 2.0f * (q1 * q3 + q0 * q2);
  R[1][0] = 2.0f * (q1 * q2 + q0 * q3);
  R[1][1] = q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3;
  R[1][2] = 2.0f * (q2 * q3 - q0 * q1);
  R[2][0] = 2.0f * (q1 * q3 - q0 * q2);
  R[2][1] = 2.0f * (q2 * q3 + q0 * q1);
  R[2][2] = q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3;
}

__device__ void skew(const float v[3], float S[3][3]) {
  S[0][0] = 0.0f;  S[0][1] = -v[2]; S[0][2] = v[1];
  S[1][0] = v[2];  S[1][1] = 0.0f;  S[1][2] = -v[0];
  S[2][0] = -v[1]; S[2][1] = v[0];  S[2][2] = 0.0f;
}

__device__ void mm3(const float A[3][3], const float B[3][3], float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

__device__ void mv3(const float A[3][3], const float v[3], float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2];
}

__device__ void transpose3(const float A[3][3], float T[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i][j] = A[j][i];
}

__device__ void cross3(const float a[3], const float b[3], float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ void normalize_quat(float* x) {
  const float inv =
      rsqrtf(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
  x[3] *= inv;
  x[4] *= inv;
  x[5] *= inv;
  x[6] *= inv;
}

// euler_to_rot: R = Rz(yaw) Ry(pitch) Rx(roll)
__device__ void euler_rot(const float e[3], float R[3][3]) {
  const float cr = cosf(e[0]), sr = sinf(e[0]);
  const float cp = cosf(e[1]), sp = sinf(e[1]);
  const float cy = cosf(e[2]), sy = sinf(e[2]);
  const float rr[3][3] = {{1.0f, 0.0f, 0.0f}, {0.0f, cr, -sr}, {0.0f, sr, cr}};
  const float rp[3][3] = {{cp, 0.0f, sp}, {0.0f, 1.0f, 0.0f}, {-sp, 0.0f, cp}};
  const float ry[3][3] = {{cy, -sy, 0.0f}, {sy, cy, 0.0f}, {0.0f, 0.0f, 1.0f}};
  float pr[3][3];
  mm3(rp, rr, pr);
  mm3(ry, pr, R);
}

// d(R(e) u)/de given R(e) and u' = R(e) u: columns (R e_x) x u',
// (Rz e_y) x u', e_z x u'
__device__ void d_euler_rot(const float e[3], const float Re[3][3],
                            const float up[3], float D[3][3]) {
  const float cy = cosf(e[2]), sy = sinf(e[2]);
  const float ex[3] = {Re[0][0], Re[1][0], Re[2][0]};
  const float ey[3] = {-sy, cy, 0.0f};
  const float ez[3] = {0.0f, 0.0f, 1.0f};
  float c0[3], c1[3], c2[3];
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

// ------------------------------------------------------------------ predict
// x <- f(x, dt) with quaternion renorm; P <- P + M + M^T + N + dt*Q with
// M = (dt A) P (rows 0:9) and N = M (dt A)^T (block 0:9 x 0:9), A the
// five-block error-dynamics Jacobian (live_lane.live_predict_slab).
__device__ void live_predict(float* x, const Cov& P, const float* q_diag,
                             float dt) {
  float Rq[3][3];
  quat_to_rot(x + 3, Rq);
  const float* w = x + 10;
  const float* a = x + 17;
  float wd[3], ad[3];
  mv3(Rq, w, wd);
  mv3(Rq, a, ad);

  // nominal state: first-order integrator, all from the old state
  {
    const float q0 = x[3], q1 = x[4], q2 = x[5], q3 = x[6];
    const float qd0 = 0.5f * (-w[0] * q1 - w[1] * q2 - w[2] * q3);
    const float qd1 = 0.5f * (w[0] * q0 + w[2] * q2 - w[1] * q3);
    const float qd2 = 0.5f * (w[1] * q0 - w[2] * q1 + w[0] * q3);
    const float qd3 = 0.5f * (w[2] * q0 + w[1] * q1 - w[0] * q2);
#pragma unroll
    for (int i = 0; i < 3; ++i) x[i] = x[i] + dt * x[7 + i];
    x[3] = q0 + dt * qd0;
    x[4] = q1 + dt * qd1;
    x[5] = q2 + dt * qd2;
    x[6] = q3 + dt * qd3;
#pragma unroll
    for (int i = 0; i < 3; ++i) x[7 + i] = x[7 + i] + dt * ad[i];
    normalize_quat(x);
  }

  float Swd[3][3], Sad[3][3], Rqd[3][3];
  skew(wd, Swd);
  skew(ad, Sad);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      Swd[i][j] *= dt;
      Sad[i][j] *= dt;
      Rqd[i][j] = dt * Rq[i][j];
    }

  // M = (dt A) P, rows 0:9 (pos <- vel, att, vel rows)
  float M[9][DE];
  for (int j = 0; j < DE; ++j) {
    float pa[3], pv[3], pw[3], pc[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pa[k] = P(C_ATT + k, j);
      pv[k] = P(C_VEL + k, j);
      pw[k] = P(C_OMEGA + k, j);
      pc[k] = P(C_ACC + k, j);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      M[i][j] = dt * pv[i];
      M[3 + i][j] = (Rqd[i][0] * pw[0] + Rqd[i][1] * pw[1] + Rqd[i][2] * pw[2])
                  - (Swd[i][0] * pa[0] + Swd[i][1] * pa[1] + Swd[i][2] * pa[2]);
      M[6 + i][j] = (Rqd[i][0] * pc[0] + Rqd[i][1] * pc[1] + Rqd[i][2] * pc[2])
                  - (Sad[i][0] * pa[0] + Sad[i][1] * pa[1] + Sad[i][2] * pa[2]);
    }
  }

  // half of N = M (dt A)^T, columns 0:9
  float Nh[9][9];
  for (int r = 0; r < 9; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Nh[r][c] = (0.5f * dt) * M[r][C_VEL + c];
      Nh[r][3 + c] = 0.5f * (
          (M[r][C_OMEGA] * Rqd[c][0] + M[r][C_OMEGA + 1] * Rqd[c][1]
           + M[r][C_OMEGA + 2] * Rqd[c][2])
          - (M[r][C_ATT] * Swd[c][0] + M[r][C_ATT + 1] * Swd[c][1]
             + M[r][C_ATT + 2] * Swd[c][2]));
      Nh[r][6 + c] = 0.5f * (
          (M[r][C_ACC] * Rqd[c][0] + M[r][C_ACC + 1] * Rqd[c][1]
           + M[r][C_ACC + 2] * Rqd[c][2])
          - (M[r][C_ATT] * Sad[c][0] + M[r][C_ATT + 1] * Sad[c][1]
             + M[r][C_ATT + 2] * Sad[c][2]));
    }
  }

  // top-left 9x9 block: upper triangle computed once, mirrored
  for (int i = 0; i < 9; ++i) {
    for (int j = i; j < 9; ++j) {
      float v = (P(i, j) + (M[i][j] + M[j][i])) + (Nh[i][j] + Nh[j][i]);
      if (i == j) v = v + dt * q_diag[i];
      P(i, j) = v;
      P(j, i) = v;
    }
    // top-right block and its transpose
    for (int j = 9; j < DE; ++j) {
      const float v = P(i, j) + M[i][j];
      P(i, j) = v;
      P(j, i) = v;
    }
  }
  for (int i = 9; i < DE; ++i) P(i, i) = P(i, i) + dt * q_diag[i];
}

// ------------------------------------------------------------------ update
// h and the sparse H = H_raw @ H_mod of one kind: up to four blocks, each a
// (dz x width) matrix on error-state columns col..col+width, or identity.
struct HBlock {
  int col, width;
  bool ident;
  float H[3][3];
};

struct HSet {
  int dz, n;
  float h[3];
  HBlock blk[4];
};

__device__ void set_block(HBlock& b, int col, int width, bool ident) {
  b.col = col;
  b.width = width;
  b.ident = ident;
}

__device__ void set_block(HBlock& b, int col, const float H[3][3]) {
  set_block(b, col, 3, false);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) b.H[i][j] = H[i][j];
}

// live_lane._hH_* for every LANE_KINDS entry; returns false for a kind
// that is not a live lane kind
__device__ bool build_h(int kind, const float* x, HSet& hs) {
  switch (kind) {
    case ECEF_POS:
    case NO_ROT:
    case CAMERA_ODO_ROTATION:
    case IMU_FRAME: {
      const int off = kind == ECEF_POS ? 0 : (kind == IMU_FRAME ? 20 : 10);
      const int col = kind == ECEF_POS ? C_POS
                      : (kind == IMU_FRAME ? C_OFF : C_OMEGA);
      hs.dz = 3;
      hs.n = 1;
#pragma unroll
      for (int i = 0; i < 3; ++i) hs.h[i] = x[off + i];
      set_block(hs.blk[0], col, 3, true);
      return true;
    }
    case ODOMETRIC_SPEED: {
      const float* v = x + 7;
      const float s = x[16];
      const float speed = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
      // |v| -> 0: clamped, a standstill update is information-free on the
      // velocity rows instead of NaN
      const float c = s / fmaxf(speed, 1e-6f);
      hs.dz = 1;
      hs.n = 2;
      hs.h[0] = speed * s;
      set_block(hs.blk[0], C_VEL, 3, false);
#pragma unroll
      for (int k = 0; k < 3; ++k) hs.blk[0].H[0][k] = c * v[k];
      set_block(hs.blk[1], C_SCALE, 1, false);
      hs.blk[1].H[0][0] = speed;
      return true;
    }
    case CAMERA_ODO_TRANSLATION: {
      float Rq[3][3], RqT[3][3], Sv[3][3], A[3][3];
      quat_to_rot(x + 3, Rq);
      transpose3(Rq, RqT);
      mv3(RqT, x + 7, hs.h);
      skew(x + 7, Sv);
      mm3(RqT, Sv, A);
      hs.dz = 3;
      hs.n = 2;
      set_block(hs.blk[0], C_ATT, A);
      set_block(hs.blk[1], C_VEL, RqT);
      return true;
    }
    case PHONE_GYRO: {
      const float* o = x + 20;
      float Re[3][3], wb[3], D[3][3];
      euler_rot(o, Re);
#pragma unroll
      for (int i = 0; i < 3; ++i) wb[i] = x[10 + i] + x[13 + i];
      mv3(Re, wb, hs.h);
      d_euler_rot(o, Re, hs.h, D);
      hs.dz = 3;
      hs.n = 3;
      set_block(hs.blk[0], C_OMEGA, Re);
      set_block(hs.blk[1], C_BIAS, Re);
      set_block(hs.blk[2], C_OFF, D);
      return true;
    }
    case PHONE_ACCEL: {
      const float* p = x;
      const float* o = x + 20;
      float Rq[3][3], RqT[3][3], Re[3][3], ReRqT[3][3];
      quat_to_rot(x + 3, Rq);
      transpose3(Rq, RqT);
      euler_rot(o, Re);
      const float r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
      const float scale = EARTH_GM / (r2 * sqrtf(r2));
      float u[3], g[3], ga[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] = scale * p[i];   // GM p / r^3
      mv3(RqT, u, g);
#pragma unroll
      for (int i = 0; i < 3; ++i) ga[i] = g[i] + x[17 + i];
      mv3(Re, ga, hs.h);
      mm3(Re, RqT, ReRqT);
      // d u / d p = scale * (I - 3 p p^T / r^2)
      float IP[3][3], Hp[3][3], Su[3][3], Ha[3][3], D[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          IP[i][j] = (i == j ? 1.0f : 0.0f) - p[i] * p[j] * (3.0f / r2);
      mm3(ReRqT, IP, Hp);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Hp[i][j] *= scale;
      skew(u, Su);
      mm3(ReRqT, Su, Ha);
      d_euler_rot(o, Re, hs.h, D);
      hs.dz = 3;
      hs.n = 4;
      set_block(hs.blk[0], C_POS, Hp);
      set_block(hs.blk[1], C_ATT, Ha);
      set_block(hs.blk[2], C_ACC, Re);
      set_block(hs.blk[3], C_OFF, D);
      return true;
    }
    default:
      return false;
  }
}

// The shared update (live_lane.live_update_slab): HP = H P, S = HP H^T + R,
// K = HP^T S^-1, optional zero-gain gate, Joseph downdate
// P += W + W^T with W = K (0.5 S K^T - HP), error injection + renorm.
__device__ void live_update(float* x, const Cov& P, const HSet& hs,
                            const float* z, const float R[3][3], bool gate,
                            float gate_thresh) {
  const int dz = hs.dz;
  float y[3];
  for (int r = 0; r < dz; ++r) y[r] = z[r] - hs.h[r];

  float HP[3][DE];
  for (int j = 0; j < DE; ++j)
    for (int r = 0; r < dz; ++r) HP[r][j] = 0.0f;
  for (int nb = 0; nb < hs.n; ++nb) {
    const HBlock& b = hs.blk[nb];
    for (int j = 0; j < DE; ++j) {
      for (int r = 0; r < dz; ++r) {
        float term;
        if (b.ident) {
          term = P(b.col + r, j);
        } else {
          term = 0.0f;
          for (int k = 0; k < b.width; ++k) term += b.H[r][k] * P(b.col + k, j);
        }
        HP[r][j] += term;
      }
    }
  }

  float S[3][3];
  for (int r = 0; r < dz; ++r)
    for (int c = 0; c < dz; ++c) {
      float s = 0.0f;
      for (int nb = 0; nb < hs.n; ++nb) {
        const HBlock& b = hs.blk[nb];
        if (b.ident) {
          s += HP[r][b.col + c];
        } else {
          float term = 0.0f;
          for (int k = 0; k < b.width; ++k) term += HP[r][b.col + k] * b.H[c][k];
          s += term;
        }
      }
      S[r][c] = s + R[r][c];
    }

  float Si[3][3];
  if (dz == 1) {
    Si[0][0] = 1.0f / S[0][0];
  } else {
    const float c00 = S[1][1] * S[2][2] - S[1][2] * S[2][1];
    const float c01 = S[0][2] * S[2][1] - S[0][1] * S[2][2];
    const float c02 = S[0][1] * S[1][2] - S[0][2] * S[1][1];
    const float c10 = S[1][2] * S[2][0] - S[1][0] * S[2][2];
    const float c11 = S[0][0] * S[2][2] - S[0][2] * S[2][0];
    const float c12 = S[0][2] * S[1][0] - S[0][0] * S[1][2];
    const float c20 = S[1][0] * S[2][1] - S[1][1] * S[2][0];
    const float c21 = S[0][1] * S[2][0] - S[0][0] * S[2][1];
    const float c22 = S[0][0] * S[1][1] - S[0][1] * S[1][0];
    const float det = S[0][0] * c00 + S[0][1] * c10 + S[0][2] * c20;
    Si[0][0] = c00 / det; Si[0][1] = c01 / det; Si[0][2] = c02 / det;
    Si[1][0] = c10 / det; Si[1][1] = c11 / det; Si[1][2] = c12 / det;
    Si[2][0] = c20 / det; Si[2][1] = c21 / det; Si[2][2] = c22 / det;
  }

  bool gated = false;
  if (gate) {
    float dist = 0.0f;
    for (int i = 0; i < dz; ++i)
      for (int j = 0; j < dz; ++j) dist += y[i] * Si[i][j] * y[j];
    gated = dist > gate_thresh;  // NaN compares false: not gated
  }

  float K[DE][3];
  for (int i = 0; i < DE; ++i)
    for (int c = 0; c < dz; ++c) {
      float v = 0.0f;
      for (int k = 0; k < dz; ++k) v += HP[k][i] * Si[k][c];
      K[i][c] = gated ? 0.0f : v;
    }

  // Joseph factor Tm = 0.5 S K^T - HP, (dz x 22)
  float Tm[3][DE];
  for (int r = 0; r < dz; ++r)
    for (int j = 0; j < DE; ++j) {
      float v = 0.0f;
      for (int k = 0; k < dz; ++k) v += S[r][k] * K[j][k];
      Tm[r][j] = 0.5f * v - HP[r][j];
    }
  for (int i = 0; i < DE; ++i)
    for (int j = i; j < DE; ++j) {
      float wij = 0.0f, wji = 0.0f;
      for (int k = 0; k < dz; ++k) {
        wij += K[i][k] * Tm[k][j];
        wji += K[j][k] * Tm[k][i];
      }
      const float v = P(i, j) + (wij + wji);
      P(i, j) = v;
      P(j, i) = v;
    }

  // error injection: dx = K y; quaternion composes with [1, 0.5 dtheta]
  float dx[DE];
  for (int i = 0; i < DE; ++i) {
    float v = 0.0f;
    for (int k = 0; k < dz; ++k) v += K[i][k] * y[k];
    dx[i] = v;
  }
  const float q0 = x[3], q1 = x[4], q2 = x[5], q3 = x[6];
  const float d1 = 0.5f * dx[3], d2 = 0.5f * dx[4], d3 = 0.5f * dx[5];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] += dx[i];
  x[3] = q0 - q1 * d1 - q2 * d2 - q3 * d3;
  x[4] = q1 + q0 * d1 + q3 * d2 - q2 * d3;
  x[5] = q2 - q3 * d1 + q0 * d2 + q1 * d3;
  x[6] = q3 + q2 * d1 - q1 * d2 + q0 * d3;
#pragma unroll
  for (int i = 0; i < 16; ++i) x[7 + i] += dx[6 + i];
  normalize_quat(x);
}

__device__ void load_x(const float* xs, int B, int b, float* x) {
#pragma unroll
  for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * B + b];
}

__device__ void store_x(float* xs, int B, int b, const float* x) {
#pragma unroll
  for (int i = 0; i < DX; ++i) xs[(size_t)i * B + b] = x[i];
}

// Kernel 2: T x (predict + ECEF_POS update); x, P updated in place.
__global__ void live_bank_scan_kernel(
    float* __restrict__ xs, float* __restrict__ Pg,
    const float* __restrict__ zs, const float* __restrict__ dts,
    const float* __restrict__ q_diag, const float* __restrict__ Rg, int T,
    int B, int gate, float gate_thresh) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Cov P{Pg + b, B};
  float x[DX];
  load_x(xs, B, b, x);
  float R[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = Rg[i * 3 + j];
  HSet hs;
  for (int t = 0; t < T; ++t) {
    live_predict(x, P, q_diag, __ldg(dts + t));
    float z[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) z[r] = __ldcs(zs + ((size_t)t * 3 + r) * B + b);
    build_h(ECEF_POS, x, hs);
    live_update(x, P, hs, z, R, gate != 0, gate_thresh);
  }
  store_x(xs, B, b, x);
}

// Kernel 3: T x (predict + update of kinds[kind_idx[t]]) on a block of 32
// filters (lane = filter) and live_mixed::WARPS warps (role = warp), P, x
// and the scratch in the block's shared-memory tile for the whole T loop
// (csrc/live_mixed.cuh). kind_idx[t] is the same for the whole bank, so the
// kind switch never diverges. Per kind: R_by_kind (n_kinds, 3, 3),
// stream_flags (n_kinds,) -> R = diag(r_stream[t]) instead, gate_thresh
// (n_kinds,). A lane past the bank (b >= B, the last block of a ragged
// bank) computes on a copy of filter B - 1, reaches every barrier, and
// stores nothing.
__global__ void __launch_bounds__(32 * lm::WARPS) live_bank_scan_mixed_kernel(
    float* __restrict__ xs, float* __restrict__ Pg,
    const float* __restrict__ zs, const float* __restrict__ dts,
    const int* __restrict__ kind_idx, const int* __restrict__ kinds,
    const float* __restrict__ R_by_kind, const int* __restrict__ stream_flags,
    const float* __restrict__ gate_thresh, const float* __restrict__ r_stream,
    const float* __restrict__ q_diag, int T, int B, int gate) {
  extern __shared__ float lm_tile[];
  constexpr int W = lm::WARPS;
  constexpr int NOMINAL_ROLE = W - 1;
  const int lane = threadIdx.x, role = threadIdx.y;
  const int b = blockIdx.x * 32 + lane;
  const int bc = b < B ? b : B - 1;
  float* Pt = lm_tile;
  float* xt = Pt + lm::DE * lm::DE * 32;
  float* st = xt + lm::DX * 32;
  for (int e = role; e < lm::DE * lm::DE; e += W)
    Pt[e * 32 + lane] = Pg[(size_t)e * B + bc];
  for (int i = role; i < lm::DX; i += W)
    xt[i * 32 + lane] = xs[(size_t)i * B + bc];
  const lm::Lane<float> x{xt + lane, 32}, P{Pt + lane, 32}, sc{st + lane, 32};
  __syncthreads();
  if (T > 0 && role == NOMINAL_ROLE) lm::nominal(x, sc, __ldg(dts));
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float dt = __ldg(dts + t);
    lm::predict_m<float, W>(role, P, sc, dt);
    __syncthreads();
    lm::predict_p<float, W>(role, P, sc, q_diag, dt);
    __syncthreads();
    const int ki = __ldg(kind_idx + t);
    const int kind = __ldg(kinds + ki);
    if (role == 0) {
      float R[3][3], z[3];
      lm::step_R(ki, t, R_by_kind, stream_flags, r_stream, R);
#pragma unroll
      for (int r = 0; r < 3; ++r)
        z[r] = __ldcs(zs + ((size_t)t * 3 + r) * B + bc);
      lm::innovate_kind(kind, x, P, sc, z, R, gate != 0,
                        __ldg(gate_thresh + ki));
    }
    __syncthreads();
    lm::joseph_dz<float, W>(lm::kind_dz(kind), role, P, sc);
    // the next step's nominal predict writes x and the coefficients, which
    // the Joseph phase does not read
    if (role == NOMINAL_ROLE && t + 1 < T)
      lm::nominal(x, sc, __ldg(dts + t + 1));
    __syncthreads();
  }
  if (b < B) {
    for (int e = role; e < lm::DE * lm::DE; e += W)
      Pg[(size_t)e * B + b] = Pt[e * 32 + lane];
    for (int i = role; i < lm::DX; i += W)
      xs[(size_t)i * B + b] = xt[i * 32 + lane];
  }
}

// kernel 3's dynamic shared memory: 32 filters x (P, x, scratch), 93,696 B
constexpr int LM_SMEM = (int)sizeof(float) * 32 * lm::TILE;

// kernel 2: 32 threads a block; at B = 8192 that is 256 blocks, so all 132
// SMs hold filters (larger blocks would leave SMs idle at this bank width)
constexpr int THREADS = 32;

}  // namespace

extern "C" int live_bank_scan_launch(void* x, void* P, const void* zs,
                                     const void* dts, const void* q_diag,
                                     const void* R, int T, int B, int gate,
                                     float gate_thresh, void* stream) {
  const int blocks = (B + THREADS - 1) / THREADS;
  live_bank_scan_kernel<<<blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(P),
      static_cast<const float*>(zs), static_cast<const float*>(dts),
      static_cast<const float*>(q_diag), static_cast<const float*>(R), T, B,
      gate, gate_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int live_bank_scan_mixed_launch(
    void* x, void* P, const void* zs, const void* dts, const void* kind_idx,
    const void* kinds, const void* R_by_kind, const void* stream_flags,
    const void* gate_thresh, const void* r_stream, const void* q_diag, int T,
    int B, int gate, void* stream) {
  // kind_idx is checked against the number of kinds by the wrapper
  cudaError_t e = cudaFuncSetAttribute(
      live_bank_scan_mixed_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LM_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + 31) / 32;
  live_bank_scan_mixed_kernel<<<blocks, dim3(32, lm::WARPS), LM_SMEM,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(P),
      static_cast<const float*>(zs), static_cast<const float*>(dts),
      static_cast<const int*>(kind_idx), static_cast<const int*>(kinds),
      static_cast<const float*>(R_by_kind),
      static_cast<const int*>(stream_flags),
      static_cast<const float*>(gate_thresh),
      static_cast<const float*>(r_stream), static_cast<const float*>(q_diag),
      T, B, gate);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3's launch shape as the runtime reads it: out[0] warps a block,
// out[1] threads a block, out[2] dynamic shared memory bytes, out[3] blocks
// an SM holds at once, out[4] registers a thread, out[5] local memory
// (stack) bytes a thread.
extern "C" int live_bank_scan_mixed_info(int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      live_bank_scan_mixed_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, LM_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, live_bank_scan_mixed_kernel, 32 * lm::WARPS, LM_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, live_bank_scan_mixed_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = lm::WARPS;
  out[1] = 32 * lm::WARPS;
  out[2] = LM_SMEM;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
