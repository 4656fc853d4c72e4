// Kernel 8: MSCKF feature triangulation, N tracks of K frames at once.
//
// Replaces rednose_tpu/msckf/triangulation.py:compute_pos_batch, an XLA
// program and not a Pallas kernel: jax.jit of a vmap over the tracks of a
// per-track lax.while_loop (compute_pos, :58-103), which solves the whole
// frame's tracks in one program. Wrapper and plain version:
// rednose_tpu_torch/msckf/triangulation.py.
//
// What it computes, for each track (compute_pos): the feature as
// (alpha, beta, rho), (u, v, inverse depth) in the track's last camera
// frame, from (u_last, v_last, 0.1); a do-while of at most MAX_ITERS
// undamped Gauss-Newton steps on the stacked (2K,) reprojection residual,
// kept going while the squared step norm is > STEP_TOL_SQ (a NaN norm
// stops it); each step the least-squares solution of J delta = r by a
// Householder QR of the 2K x 3 Jacobian and a back substitution (as JAX's
// qr and solve_triangular: the normal equations would square the
// condition number); out the ECEF position R(q_last) to_c^T
// (alpha, beta, 1) / rho + p_last and converged = (norm <= STEP_TOL_SQ).
// Every quaternion is normalised first (triangulation.py:37, :50).
//
// The Jacobian is written in closed form: with M = R(q_last) to_c^T and
// A_k = to_c R(q_k)^T, frame k sees p_c = A_k (M rel + p_last - p_k),
// rel = (alpha, beta, 1) / rho, so dp_c / dparam = A_k M D with
// D = drel / dparam = [[1/rho, 0, -alpha/rho^2], [0, 1/rho, -beta/rho^2],
// [0, 0, -1/rho^2]], and the residual row (p_c0 / p_c2 - u_k) has the
// derivative (dp_c0 - (p_c0 / p_c2) dp_c2) / p_c2. The plain version takes
// jacfwd of the same residual: the same values in another rounding order.
//
// Design: one thread a track, everything in registers or the thread's
// local memory (K <= MAX_K: the poses' 12 values a frame, J and r of
// 2 MAX_K rows); 64 threads a block. Poses and observations are read
// through their strides, so a stride-0 (expanded) pose window is read as
// it is. Bound: at the main path's 768 tracks of K = 4 the work is ~2-5
// MFLOP and ~0.3 MB, microseconds either way; the launch's own latency
// sets the pace. Templated on float and double (IEEE, no fast-math, and
// no FMA contraction: see mul / add below).
//
// The per-track solver is a __host__ __device__ function: the CPU tests
// build this file with the host C++ compiler (-x c++), entry
// triangulate_host, and run it against the JAX package.

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TRI_HD __host__ __device__
#else
#define TRI_HD
#endif

namespace rn_tri {

constexpr int MAX_K = 16;
constexpr int MAX_ITERS = 30;
constexpr double STEP_TOL_SQ = 1e-4;

TRI_HD inline float tri_sqrt(float a) { return sqrtf(a); }
TRI_HD inline double tri_sqrt(double a) { return sqrt(a); }

// Every product and sum rounded on its own. nvcc would contract a * b + c
// into one FMA (one rounding), which neither the plain version's torch
// operations nor the host build do; on a degenerate track (the padding's
// sentinel rows, u = v = 0 in every frame of a moving camera) that
// rounding decides whether rho reaches 0 exactly, and so whether the track
// comes out NaN and unconverged as in the plain version or finite. With
// each operation rounded alone the kernel computes what its host build
// computes, bit for bit.
TRI_HD inline float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
TRI_HD inline double mul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
TRI_HD inline float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
TRI_HD inline double add(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
template <typename S>
TRI_HD inline S sub(S a, S b) { return add(a, -b); }
// a0 b0 + a1 b1 + a2 b2, left to right
template <typename S>
TRI_HD inline S dot3(const S* a, S b0, S b1, S b2) {
  return add(add(mul(a[0], b0), mul(a[1], b1)), mul(a[2], b2));
}

// quat_to_rot of the normalised quaternion (w, x, y, z), row-major 3 x 3
template <typename S>
TRI_HD inline void quat_rot(S q0, S q1, S q2, S q3, S* R) {
  const S n = tri_sqrt(add(add(add(mul(q0, q0), mul(q1, q1)), mul(q2, q2)),
                           mul(q3, q3)));
  q0 /= n;
  q1 /= n;
  q2 /= n;
  q3 /= n;
  const S two = 2;
  R[0] = sub(sub(add(mul(q0, q0), mul(q1, q1)), mul(q2, q2)), mul(q3, q3));
  R[1] = mul(two, sub(mul(q1, q2), mul(q0, q3)));
  R[2] = mul(two, add(mul(q1, q3), mul(q0, q2)));
  R[3] = mul(two, add(mul(q1, q2), mul(q0, q3)));
  R[4] = sub(add(sub(mul(q0, q0), mul(q1, q1)), mul(q2, q2)), mul(q3, q3));
  R[5] = mul(two, sub(mul(q2, q3), mul(q0, q1)));
  R[6] = mul(two, sub(mul(q1, q3), mul(q0, q2)));
  R[7] = mul(two, add(mul(q2, q3), mul(q0, q1)));
  R[8] = add(sub(sub(mul(q0, q0), mul(q1, q1)), mul(q2, q2)), mul(q3, q3));
}

// One track. pose(k, c) = poses[k * ps1 + c * ps2], uv(k, c) likewise;
// to_c row-major 3 x 3. Writes pos[0:3], *conv and *iters.
template <typename S>
TRI_HD inline void solve_track(const S* to_c, const S* poses, int64_t ps1,
                               int64_t ps2, const S* uv, int64_t us1,
                               int64_t us2, int K, S* pos, uint8_t* conv,
                               int* iters) {
  S A[MAX_K][9], p[MAX_K][3], obs[MAX_K][2];
  S M[9], Rk[9];
  for (int k = 0; k < K; ++k) {
    const S* pk = poses + k * ps1;
    quat_rot(pk[3 * ps2], pk[4 * ps2], pk[5 * ps2], pk[6 * ps2], Rk);
    // A_k = to_c R_k^T
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        A[k][3 * i + j] =
            dot3(to_c + 3 * i, Rk[3 * j], Rk[3 * j + 1], Rk[3 * j + 2]);
    for (int c = 0; c < 3; ++c) p[k][c] = pk[c * ps2];
    obs[k][0] = uv[k * us1];
    obs[k][1] = uv[k * us1 + us2];
  }
  // M = R_last to_c^T (Rk holds the last frame's rotation)
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M[3 * i + j] =
          dot3(Rk + 3 * i, to_c[3 * j], to_c[3 * j + 1], to_c[3 * j + 2]);
  const S* pl = p[K - 1];
  S prm[3] = {obs[K - 1][0], obs[K - 1][1], (S)0.1};
  S J[2 * MAX_K][3], r[2 * MAX_K];
  S dsq = 0;
  int it = 0;
  const int n = 2 * K;
  do {
    const S ir = 1 / prm[2];
    const S rel[3] = {mul(prm[0], ir), mul(prm[1], ir), ir};
    S pe[3], G[9];
    for (int i = 0; i < 3; ++i) {
      const S mr = dot3(M + 3 * i, rel[0], rel[1], rel[2]);
      pe[i] = add(mr, pl[i]);
      // G = M D: d p_ecef / d (alpha, beta, rho)
      G[3 * i] = mul(M[3 * i], ir);
      G[3 * i + 1] = mul(M[3 * i + 1], ir);
      G[3 * i + 2] = -mul(mr, ir);
    }
    for (int k = 0; k < K; ++k) {
      const S d0 = sub(pe[0], p[k][0]), d1 = sub(pe[1], p[k][1]),
              d2 = sub(pe[2], p[k][2]);
      S pc[3], E[9];
      for (int i = 0; i < 3; ++i) {
        pc[i] = dot3(A[k] + 3 * i, d0, d1, d2);
        for (int j = 0; j < 3; ++j)
          E[3 * i + j] = dot3(A[k] + 3 * i, G[j], G[3 + j], G[6 + j]);
      }
      const S iz = 1 / pc[2];
      const S u = mul(pc[0], iz), v = mul(pc[1], iz);
      r[2 * k] = sub(u, obs[k][0]);
      r[2 * k + 1] = sub(v, obs[k][1]);
      for (int j = 0; j < 3; ++j) {
        J[2 * k][j] = mul(sub(E[j], mul(u, E[6 + j])), iz);
        J[2 * k + 1][j] = mul(sub(E[3 + j], mul(v, E[6 + j])), iz);
      }
    }
    // Householder QR of J, each reflector applied to the later columns and
    // to r: R in the upper triangle of J, Q^T r in r
    S diag[3];
    for (int j = 0; j < 3; ++j) {
      S sigma = 0;
      for (int i = j + 1; i < n; ++i) sigma = add(sigma, mul(J[i][j], J[i][j]));
      const S alpha = J[j][j];
      const S norm = tri_sqrt(add(mul(alpha, alpha), sigma));
      if (norm == 0) {  // a zero column: reflect by the identity
        diag[j] = 0;
        continue;
      }
      const S beta = alpha >= 0 ? -norm : norm;
      const S v0 = sub(alpha, beta);
      const S vtv = add(mul(v0, v0), sigma);
      diag[j] = beta;
      if (vtv == 0) continue;
      const S two_vtv = 2 / vtv;
      for (int c = j + 1; c < 3; ++c) {
        S w = mul(v0, J[j][c]);
        for (int i = j + 1; i < n; ++i) w = add(w, mul(J[i][j], J[i][c]));
        w = mul(w, two_vtv);
        J[j][c] = sub(J[j][c], mul(w, v0));
        for (int i = j + 1; i < n; ++i) J[i][c] = sub(J[i][c], mul(w, J[i][j]));
      }
      S w = mul(v0, r[j]);
      for (int i = j + 1; i < n; ++i) w = add(w, mul(J[i][j], r[i]));
      w = mul(w, two_vtv);
      r[j] = sub(r[j], mul(w, v0));
      for (int i = j + 1; i < n; ++i) r[i] = sub(r[i], mul(w, J[i][j]));
    }
    // back substitution R delta = (Q^T r)[0:3]
    S delta[3];
    delta[2] = r[2] / diag[2];
    delta[1] = sub(r[1], mul(J[1][2], delta[2])) / diag[1];
    delta[0] =
        sub(sub(r[0], mul(J[0][1], delta[1])), mul(J[0][2], delta[2])) /
        diag[0];
    dsq = add(add(mul(delta[0], delta[0]), mul(delta[1], delta[1])),
              mul(delta[2], delta[2]));
    for (int j = 0; j < 3; ++j) prm[j] = sub(prm[j], delta[j]);
    ++it;
  } while (dsq > (S)STEP_TOL_SQ && it < MAX_ITERS);
  const S ir = 1 / prm[2];
  const S rel[3] = {mul(prm[0], ir), mul(prm[1], ir), ir};
  for (int i = 0; i < 3; ++i)
    pos[i] = add(dot3(M + 3 * i, rel[0], rel[1], rel[2]), pl[i]);
  *conv = dsq <= (S)STEP_TOL_SQ;
  *iters = it;
}

}  // namespace rn_tri

#ifdef __CUDACC__

namespace {

template <typename S>
__global__ void __launch_bounds__(64) triangulate_kernel(
    const S* __restrict__ to_c, const S* __restrict__ poses, int64_t ps0,
    int64_t ps1, int64_t ps2, const S* __restrict__ uv, int64_t us0,
    int64_t us1, int64_t us2, S* __restrict__ pos,
    uint8_t* __restrict__ conv, int* __restrict__ iters, int N, int K) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N) return;
  rn_tri::solve_track(to_c, poses + t * ps0, ps1, ps2, uv + t * us0, us1,
                      us2, K, pos + 3 * t, conv + t, iters + t);
}

template <typename S>
int launch(const void* to_c, const void* poses, long long ps0, long long ps1,
           long long ps2, const void* uv, long long us0, long long us1,
           long long us2, void* pos, void* conv, void* iters, int N, int K,
           void* stream) {
  const int threads = 64;
  triangulate_kernel<S><<<(N + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(to_c), static_cast<const S*>(poses), ps0, ps1,
      ps2, static_cast<const S*>(uv), us0, us1, us2, static_cast<S*>(pos),
      static_cast<uint8_t*>(conv), static_cast<int*>(iters), N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides in elements; pos (N, 3), conv (N,) bytes, iters (N,) int32, all
// contiguous; is_double picks the scalar type. Returns the launch's
// cudaGetLastError().
extern "C" int triangulate_launch(const void* to_c, const void* poses,
                                  long long ps0, long long ps1, long long ps2,
                                  const void* uv, long long us0,
                                  long long us1, long long us2, void* pos,
                                  void* conv, void* iters, int N, int K,
                                  int is_double, void* stream) {
  if (N <= 0) return 0;
  if (K < 1 || K > rn_tri::MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? launch<double>(to_c, poses, ps0, ps1, ps2, uv, us0, us1,
                                    us2, pos, conv, iters, N, K, stream)
                   : launch<float>(to_c, poses, ps0, ps1, ps2, uv, us0, us1,
                                   us2, pos, conv, iters, N, K, stream);
}

#else

// The host build (tests): the same solver, track by track.
extern "C" int triangulate_host(const void* to_c, const void* poses,
                                long long ps0, long long ps1, long long ps2,
                                const void* uv, long long us0, long long us1,
                                long long us2, void* pos, void* conv,
                                void* iters, int N, int K, int is_double) {
  if (K < 1 || K > rn_tri::MAX_K) return 1;
  for (int t = 0; t < N; ++t) {
    if (is_double)
      rn_tri::solve_track(static_cast<const double*>(to_c),
                          static_cast<const double*>(poses) + t * ps0, ps1,
                          ps2, static_cast<const double*>(uv) + t * us0, us1,
                          us2, K, static_cast<double*>(pos) + 3 * t,
                          static_cast<uint8_t*>(conv) + t,
                          static_cast<int*>(iters) + t);
    else
      rn_tri::solve_track(static_cast<const float*>(to_c),
                          static_cast<const float*>(poses) + t * ps0, ps1,
                          ps2, static_cast<const float*>(uv) + t * us0, us1,
                          us2, K, static_cast<float*>(pos) + 3 * t,
                          static_cast<uint8_t*>(conv) + t,
                          static_cast<int*>(iters) + t);
  }
  return 0;
}

#endif  // __CUDACC__
