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
// Every quaternion is normalised first (triangulation.py:37, :50). With
// K = 1 the system has two rows for three unknowns: the missing third row
// of the QR is zero, so the step and the position are NaN and the track
// unconverged (the plain version refuses K = 1).
//
// The Jacobian is written in closed form: with M = R(q_last) to_c^T and
// A_k = to_c R(q_k)^T, frame k sees p_c = A_k (M rel + p_last - p_k),
// rel = (alpha, beta, 1) / rho, so dp_c / dparam = A_k M D with
// D = drel / dparam = [[1/rho, 0, -alpha/rho^2], [0, 1/rho, -beta/rho^2],
// [0, 0, -1/rho^2]], and the residual row (p_c0 / p_c2 - u_k) has the
// derivative (dp_c0 - (p_c0 / p_c2) dp_c2) / p_c2. The plain version takes
// jacfwd of the same residual: the same values in another rounding order.
//
// What bounds it. At the VIO store's 768 tracks of K = 4 the work is
// ~0.6 MFLOP and ~0.07 MB (a 2.1e-5 ms byte bound), and no track takes
// more than two Gauss-Newton iterations: the launch floor (an empty kernel
// on the same grid, 1.9 us raw) and one track's chain of setup and
// iterations set the time, not bytes or operations. The chain is serial:
// each iteration runs 1 / rho, a division a frame, then per QR column a
// row-ordered sum, a square root and a division, and a back substitution
// of three chained divisions (float64 division and square root are
// multi-instruction sequences on this card); the rounding order is fixed
// (below), so the design cuts what lies around the chain.
//
// Design, chosen by sweep_warps.py --parts triangulate (PERF.md, row 8;
// raw device time, H100 80GB HBM3 at 700 W; the design before it, with J
// and r in 2,816 B of local memory, in brackets):
// - one thread a track, K a template parameter (a switch over 1..MAX_K),
//   so every per-track array has a fixed size and fixed indices: at K = 4
//   a track lives in 250 registers, no stack in float or double; at K = 8
//   its 176 doubles of state (A, p, obs, J, r) exceed a thread's 255
//   registers and 704 B go to the stack (float: none). Store frame 31
//   (K = 4): 9.67 us (17.56); the long-tail batch (768 tracks of K = 8,
//   17 at 30 iterations): 116.9 us (207.5);
// - a stride-0 pose window (track stride ps0 == 0, as the VIO store and
//   models/msckf_vo.frame_update pass it) is set up once a block in
//   shared memory (A_k, p_k, M: one thread a frame, then a barrier); any
//   other stride sets up each track's frames from its poses (each thread
//   K frames, a square root and four divisions each): frame 31 as its
//   contiguous copy takes 12.58 us;
// - 32 threads a block, so that 768 tracks take 24 SMs: 0.03-0.21 us
//   faster than 64 (the design before), 128 up to 1.1 us slower.
// Not kept: a track's frames spread over lanes of a warp, each QR sum
// gathered by __shfl_sync in row order. It was slower at K = 4 and
// faster at K = 8, but every caller in the port triangulates K = 4
// (N_AUGMENT of both MSCKF models).
// Every product and sum is rounded on its own (mul / add below), so the
// kernel computes the host build's values bit for bit. Templated on float
// and double (IEEE, no fast-math, no FMA contraction).
//
// The solver is __host__ __device__: the CPU tests build this file with
// the host C++ compiler (-x c++, entry triangulate_host) and run it
// against the JAX package.

#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define TRI_HD __host__ __device__
#define TRI_UNROLL _Pragma("unroll")
#else
#define TRI_HD
#define TRI_UNROLL
#endif

namespace rn_tri {

constexpr int MAX_K = 16;
constexpr int MAX_ITERS = 30;
constexpr double STEP_TOL_SQ = 1e-4;
// threads (tracks) a block, at least MAX_K + 1 (a stride-0 window's
// frames and M are set up by a thread each)
constexpr int BLOCK_THREADS = 32;

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

// Frame k's A_k = to_c R(q_k)^T and p_k from its pose pk (read through
// the stride ps2)
template <typename S>
TRI_HD inline void frame_setup(const S* to_c, const S* pk, int64_t ps2, S* A,
                               S* p) {
  S R[9];
  quat_rot(pk[3 * ps2], pk[4 * ps2], pk[5 * ps2], pk[6 * ps2], R);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      A[3 * i + j] = dot3(to_c + 3 * i, R[3 * j], R[3 * j + 1], R[3 * j + 2]);
  for (int c = 0; c < 3; ++c) p[c] = pk[c * ps2];
}

// M = R(q_last) to_c^T from the last pose pl
template <typename S>
TRI_HD inline void last_setup(const S* to_c, const S* pl, int64_t ps2, S* M) {
  S R[9];
  quat_rot(pl[3 * ps2], pl[4 * ps2], pl[5 * ps2], pl[6 * ps2], R);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M[3 * i + j] = dot3(R + 3 * i, to_c[3 * j], to_c[3 * j + 1],
                          to_c[3 * j + 2]);
}

// A pose window set up once: every frame's A_k and p_k, and M
template <typename S>
struct Window {
  S A[MAX_K][9];
  S p[MAX_K][3];
  S M[9];
};

template <typename S>
TRI_HD inline void window_part(const S* to_c, const S* poses, int64_t ps1,
                               int64_t ps2, int K, int part, Window<S>* w) {
  if (part < K)
    frame_setup(to_c, poses + part * ps1, ps2, w->A[part], w->p[part]);
  else if (part == K)
    last_setup(to_c, poses + (K - 1) * ps1, ps2, w->M);
}

// One track of K frames. win: the set-up window, or null to set up the
// track's frames from its poses. pose(k, c) = poses[k * ps1 + c * ps2],
// uv(k, c) likewise; to_c row-major 3 x 3. Writes pos[0:3], *conv and
// *iters.
template <typename S, int K>
TRI_HD inline void solve_track(const Window<S>* win, const S* to_c,
                               const S* poses, int64_t ps1, int64_t ps2,
                               const S* uv, int64_t us1, int64_t us2, S* pos,
                               uint8_t* conv, int* iters) {
  constexpr int n = 2 * K;
  S A[K][9], p[K][3], obs[K][2], M[9], pl[3];
  for (int k = 0; k < K; ++k) {
    if (win) {
      for (int e = 0; e < 9; ++e) A[k][e] = win->A[k][e];
      for (int c = 0; c < 3; ++c) p[k][c] = win->p[k][c];
    } else {
      frame_setup(to_c, poses + k * ps1, ps2, A[k], p[k]);
    }
    obs[k][0] = uv[k * us1];
    obs[k][1] = uv[k * us1 + us2];
  }
  if (win) {
    for (int e = 0; e < 9; ++e) M[e] = win->M[e];
  } else {
    last_setup(to_c, poses + (K - 1) * ps1, ps2, M);
  }
  for (int c = 0; c < 3; ++c) pl[c] = poses[(K - 1) * ps1 + c * ps2];
  S prm[3] = {uv[(K - 1) * us1], uv[(K - 1) * us1 + us2], (S)0.1};
  // J[k][h][c] and r[k][h]: row 2 k + h of J and r
  S J[K][2][3] = {}, r[K][2] = {};
  // row i of J and r for a compile-time i (rows past n are zero: K = 1)
  auto Jrow = [&](int i, int c) -> S {
    return i < n ? J[i / 2][i % 2][c] : (S)0;
  };
  auto rrow = [&](int i) -> S { return i < n ? r[i / 2][i % 2] : (S)0; };
  S dsq = 0;
  int it = 0;
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
TRI_UNROLL
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
      r[k][0] = sub(u, obs[k][0]);
      r[k][1] = sub(v, obs[k][1]);
      for (int j = 0; j < 3; ++j) {
        J[k][0][j] = mul(sub(E[j], mul(u, E[6 + j])), iz);
        J[k][1][j] = mul(sub(E[3 + j], mul(v, E[6 + j])), iz);
      }
    }
    // Householder QR of J, each reflector applied to the later columns and
    // to r: R in the upper triangle of J, Q^T r in r. Every sum runs over
    // the rows in order.
    S diag[3];
TRI_UNROLL
    for (int j = 0; j < 3; ++j) {
      S sigma = 0;
TRI_UNROLL
      for (int i = j + 1; i < n; ++i)
        sigma = add(sigma, mul(Jrow(i, j), Jrow(i, j)));
      const S alpha = Jrow(j, j);
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
      // columns c = j + 1, j + 2 of J, then r as column 3
TRI_UNROLL
      for (int c = j + 1; c < 4; ++c) {
        auto val = [&](int i) { return c < 3 ? Jrow(i, c) : rrow(i); };
        S w = mul(v0, val(j));
TRI_UNROLL
        for (int i = j + 1; i < n; ++i) w = add(w, mul(Jrow(i, j), val(i)));
        w = mul(w, two_vtv);
TRI_UNROLL
        for (int i = j; i < n; ++i) {
          S& x = c < 3 ? J[i / 2][i % 2][c] : r[i / 2][i % 2];
          x = sub(x, mul(w, i == j ? v0 : J[i / 2][i % 2][j]));
        }
      }
    }
    // back substitution R delta = (Q^T r)[0:3]
    S delta[3];
    delta[2] = rrow(2) / diag[2];
    delta[1] = sub(rrow(1), mul(Jrow(1, 2), delta[2])) / diag[1];
    delta[0] = sub(sub(rrow(0), mul(Jrow(0, 1), delta[1])),
                   mul(Jrow(0, 2), delta[2])) / diag[0];
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

// f<K>() for the runtime K (1..MAX_K): the dispatch to the K-templated
// solver
template <typename Fn>
inline int dispatch_k(int K, Fn&& fn) {
  switch (K) {
#define RN_TRI_K(k) \
  case k:           \
    return fn(std::integral_constant<int, k>());
    RN_TRI_K(1) RN_TRI_K(2) RN_TRI_K(3) RN_TRI_K(4) RN_TRI_K(5) RN_TRI_K(6)
    RN_TRI_K(7) RN_TRI_K(8) RN_TRI_K(9) RN_TRI_K(10) RN_TRI_K(11)
    RN_TRI_K(12) RN_TRI_K(13) RN_TRI_K(14) RN_TRI_K(15) RN_TRI_K(16)
#undef RN_TRI_K
  }
  return -1;
}
static_assert(MAX_K == 16, "dispatch_k lists K = 1..16");
static_assert(BLOCK_THREADS % 32 == 0 && BLOCK_THREADS > MAX_K,
              "a block sets up a window a thread a frame");

}  // namespace rn_tri

#ifdef __CUDACC__

namespace {

using rn_tri::BLOCK_THREADS;

template <typename S, int K>
__global__ void __launch_bounds__(BLOCK_THREADS) triangulate_kernel(
    const S* __restrict__ to_c, const S* __restrict__ poses, int64_t ps0,
    int64_t ps1, int64_t ps2, const S* __restrict__ uv, int64_t us0,
    int64_t us1, int64_t us2, S* __restrict__ pos,
    uint8_t* __restrict__ conv, int* __restrict__ iters, int N) {
  __shared__ rn_tri::Window<S> win;
  const bool shared = ps0 == 0;
  if (shared) {  // every block takes the same branch
    if (threadIdx.x <= K)
      rn_tri::window_part(to_c, poses, ps1, ps2, K, threadIdx.x, &win);
    __syncthreads();
  }
  const int t = blockIdx.x * BLOCK_THREADS + threadIdx.x;
  if (t >= N) return;
  rn_tri::solve_track<S, K>(shared ? &win : nullptr, to_c, poses + t * ps0,
                            ps1, ps2, uv + t * us0, us1, us2, pos + 3 * t,
                            conv + t, iters + t);
}

// The launch floor: an empty kernel on triangulate_kernel's grid (a
// timing aid)
__global__ void __launch_bounds__(BLOCK_THREADS) triangulate_floor_kernel() {}

int blocks_for(int N) { return (N + BLOCK_THREADS - 1) / BLOCK_THREADS; }

template <typename S>
int launch(const void* to_c, const void* poses, long long ps0, long long ps1,
           long long ps2, const void* uv, long long us0, long long us1,
           long long us2, void* pos, void* conv, void* iters, int N, int K,
           void* stream) {
  return rn_tri::dispatch_k(K, [&](auto k) {
    triangulate_kernel<S, decltype(k)::value>
        <<<blocks_for(N), BLOCK_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const S*>(to_c), static_cast<const S*>(poses), ps0,
            ps1, ps2, static_cast<const S*>(uv), us0, us1, us2,
            static_cast<S*>(pos), static_cast<uint8_t*>(conv),
            static_cast<int*>(iters), N);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename S>
int info(int K, int* out) {
  return rn_tri::dispatch_k(K, [&](auto k) {
    const void* fn = (const void*)triangulate_kernel<S, decltype(k)::value>;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, fn);
    if (e != cudaSuccess) return static_cast<int>(e);
    int blocks = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      BLOCK_THREADS, 0);
    out[0] = BLOCK_THREADS;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = blocks;
    out[3] = a.numRegs;
    out[4] = (int)a.localSizeBytes;
    return static_cast<int>(e);
  });
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

// The empty kernel on the grid triangulate_launch takes for N tracks of
// K frames (a timing aid: the launch floor).
extern "C" int triangulate_floor_launch(int N, int K, void* stream) {
  if (N <= 0 || K < 1 || K > rn_tri::MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  triangulate_floor_kernel<<<blocks_for(N), BLOCK_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// out (5 ints) for triangulate_kernel<K, is_double>: threads a block,
// static shared bytes, blocks an SM holds, registers, local bytes.
extern "C" int triangulate_info(int K, int is_double, int* out) {
  if (K < 1 || K > rn_tri::MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  return is_double ? info<double>(K, out) : info<float>(K, out);
}

#else

namespace {

template <typename S>
int host_solve(const void* to_c_, const void* poses_, long long ps0,
               long long ps1, long long ps2, const void* uv_, long long us0,
               long long us1, long long us2, void* pos_, void* conv_,
               void* iters_, int N, int K) {
  const S* to_c = static_cast<const S*>(to_c_);
  const S* poses = static_cast<const S*>(poses_);
  const S* uv = static_cast<const S*>(uv_);
  return rn_tri::dispatch_k(K, [&](auto k) {
    constexpr int KK = decltype(k)::value;
    rn_tri::Window<S> win;
    const bool shared = ps0 == 0;
    if (shared)
      for (int part = 0; part <= KK; ++part)
        rn_tri::window_part(to_c, poses, ps1, ps2, KK, part, &win);
    for (int t = 0; t < N; ++t)
      rn_tri::solve_track<S, KK>(
          shared ? &win : nullptr, to_c, poses + t * ps0, ps1, ps2,
          uv + t * us0, us1, us2, static_cast<S*>(pos_) + 3 * t,
          static_cast<uint8_t*>(conv_) + t, static_cast<int*>(iters_) + t);
    return 0;
  });
}

}  // namespace

// The host build (tests): the same solver, track by track; a stride-0
// window set up once as the kernel's blocks do.
extern "C" int triangulate_host(const void* to_c, const void* poses,
                                long long ps0, long long ps1, long long ps2,
                                const void* uv, long long us0, long long us1,
                                long long us2, void* pos, void* conv,
                                void* iters, int N, int K, int is_double) {
  if (K < 1 || K > rn_tri::MAX_K) return 1;
  return is_double ? host_solve<double>(to_c, poses, ps0, ps1, ps2, uv, us0,
                                        us1, us2, pos, conv, iters, N, K)
                   : host_solve<float>(to_c, poses, ps0, ps1, ps2, uv, us0,
                                       us1, us2, pos, conv, iters, N, K);
}

#endif  // __CUDACC__
