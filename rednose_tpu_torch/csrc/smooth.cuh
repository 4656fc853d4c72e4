// Kernels 11, 12 and 14: the offline RTS smoother of any filter spec,
// around the spec's error-state functions emitted per spec by
// rednose_tpu_torch/ops/entry_slab.py (mode "smooth", smooth_source),
// which includes this file after them. Kernel 13, the suffix scan of the
// parallel form, is csrc/affine_scan.cu. Wrappers and plain versions:
// rednose_tpu_torch/ops/smooth_scan.py; the entry points that run them,
// rednose_tpu_torch/smoothing/rts.py.
//
// They replace the JAX package's smoother, one XLA program and not a
// Pallas kernel (rednose_tpu/smoothing/rts.py:_jit_rts, jax.jit of
// rts_smooth or rts_smooth_parallel):
//
//   kernel 11 (smooth_gains): _smoother_gain (rts.py:49) under the reverse
//     lax.scan (:121) and the parallel form's gains and elements
//     (:314-342): C_k = P_{k|k} F_k^T P_{k+1|k}^-1 on the main block, and
//     b_k = C_k u_{k+1}, V_k = C_k (P_{k+1|k+1} - P_{k+1|k}) C_k^T with
//     u_{k+1} = inv_err(x_{k+1|k}, x_{k+1|k+1})[:D2]. Its refine variant
//     (the Newton passes, :372-393): A_k = C_k J_v, b_k = C_k (v - J_v e)
//     with v(e) = inv_err(x_{k+1|k}, inject(x_{k+1|k+1}, e))[:D2] at the
//     current correction e of step k+1, J_v = dv/de.
//   kernel 12 (smooth_backward): the reverse lax.scan's body (:95-121),
//     the sequential backward pass: dx = inv_err(x_{k+1|k}, x_next),
//     dx[:D2] = C_k dx[:D2], x_s = inject(x_{k|k}, dx), P_s = sym(P_{k|k}
//     + pad(C_k (P_next - P_{k+1|k}) C_k^T)).
//   kernel 14 (smooth_inject): the parallel form's inject and covariance
//     add (:358-364, :395-397): x_s = inject(x_{k|k}, [e_k, 0]), P_s =
//     sym(P_{k|k} + pad(D_k)); the rows past the elements copied.
//
// inject(x, dx) = err(x, dx) on the main state, x's clone slots kept,
// quaternions renormalized when norm_quats; sym(A) = (A + A^T) / 2, the
// port's symmetrizing add, entry by entry.
//
// Layout, lane-major with time next (the stacks of runtime/scan.py's
// op): x_pred, x_post (B, T, DX); P_pred, P_post (B, T, DE, DE); dts
// (B, T - 1); the elements C, V, A (B, T - 1, D2, D2) and b, e (B, T - 1,
// D2), every matrix row-major; the params vector p (NP,).
//
// Bound and design. Kernels 11 and 14 are parallel over (lane, step):
// 64 x 8191 independent items on the offline path. Kernel 11 is bound by
// its operations: F P^T, the Cholesky of P_{k+1|k}, the solve with D2
// right-hand sides and C dP C^T are ~45k FMAs an item at D2 = 22
// (PERF.md), so one thread an item would hold four 22 x 22 matrices in
// registers and spill (kernel 10's first form lost 8x that way). Here a
// WARP takes an item: its matrices sit in the warp's slice of shared
// memory, each product is spread over the 32 lanes a few entries a lane,
// the Cholesky goes column by column (a lane a row, two __syncwarp a
// column), the solve a lane a right-hand side; the spec's functions (F's
// taps, inv_err, inject, the refine taps) are serial scalar code on lane
// 0, a call of their own (GEN_PHASE), so ptxas allocates their registers
// apart. Kernel 14 is bound by bytes (it reads and writes each row once):
// a warp a row, lane 0 the injection, the 32 lanes the covariance.
// Kernel 12 is a chain over k for each lane: a BLOCK a lane
// (SM_BACK_THREADS threads), each step two dependent D2^3 products and
// the spec's inv_err / inject on thread 0 between barriers; C_k comes
// from kernel 11. Only B blocks run (64 on the offline path, of 132 SMs):
// its time is the chain's latency, step after step.
//
// Numerics: IEEE, no fast-math, float or double as the stacks are. The
// gains solve by Cholesky where the JAX package's sequential pass solves
// by LU (jnp.linalg.solve): the two agree to rounding. P_s is symmetric
// bitwise (each entry computed once from the pair).

#include <math.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

namespace rn_sm {

using rn_gen::D1;
using rn_gen::D2;
using rn_gen::DE;
using rn_gen::DX;
using rn_gen::NP;

constexpr int SM_WARPS = 4;            // items (warps) a block, kernels 11, 14
constexpr int SM_BACK_THREADS = 128;   // threads of kernel 12's block

template <bool BLOCK>
GEN_HD GEN_INLINE void sync_() {
#ifdef __CUDA_ARCH__
  if (BLOCK) __syncthreads(); else __syncwarp();
#endif
}

template <typename S>
GEN_HD GEN_INLINE void inject(bool norm, const S* x, const S* dx, const S* p,
                              S* out) {
  if (norm) rn_gen::gen_sm_inject_n1<S>(x, dx, p, out);
  else rn_gen::gen_sm_inject_n0<S>(x, dx, p, out);
}

// the Cholesky factor of the symmetric positive definite A (D2 x D2,
// row-major; its lower triangle read), in place: L's strict lower
// triangle in A, its diagonal in diag (A's diagonal keeps the pivots'
// squares). Left-looking, a thread a row of each column.
template <typename S, bool BLOCK>
GEN_HD GEN_INLINE void cholesky(S* A, S* diag, int tid, int nt) {
  for (int j = 0; j < D2; ++j) {
    for (int i = j + tid; i < D2; i += nt) {
      S s = A[i * D2 + j];
      for (int k = 0; k < j; ++k) s -= A[i * D2 + k] * A[j * D2 + k];
      A[i * D2 + j] = s;
    }
    sync_<BLOCK>();
    const S d = g_sqrt(A[j * D2 + j]);
    for (int i = j + 1 + tid; i < D2; i += nt) A[i * D2 + j] /= d;
    if (tid == 0) diag[j] = d;
    sync_<BLOCK>();
  }
}

// X := (L L^T)^-1 X for X (D2 x D2, row-major), a thread a column
template <typename S>
GEN_HD GEN_INLINE void cho_solve(const S* L, const S* diag, S* X, int tid,
                                 int nt) {
  for (int c = tid; c < D2; c += nt) {
    for (int i = 0; i < D2; ++i) {
      S s = X[i * D2 + c];
      for (int k = 0; k < i; ++k) s -= L[i * D2 + k] * X[k * D2 + c];
      X[i * D2 + c] = s / diag[i];
    }
    for (int i = D2 - 1; i >= 0; --i) {
      S s = X[i * D2 + c];
      for (int k = i + 1; k < D2; ++k) s -= L[k * D2 + i] * X[k * D2 + c];
      X[i * D2 + c] = s / diag[i];
    }
  }
}

// ------------------------------------------------------------- kernel 11

// scalars of a gains item's slice of shared memory
constexpr int GAINS_SMEM = 4 * D2 * D2 + D2 + DE;
constexpr int REFINE_SMEM = 2 * D2 * D2 + 2 * D2;

// One item (lane, k): C_k (row-major D2 x D2) into C and, with b given,
// b_k and V_k. xq0, Pq0: x_{k|k}, P_{k|k}; xp1, Pp1: x_{k+1|k},
// P_{k+1|k}; xq1, Pq1: x_{k+1|k+1}, P_{k+1|k+1}.
template <typename S, bool BLOCK>
GEN_HD void gains_item(const S* xq0, const S* Pq0, const S* xp1,
                       const S* Pp1, const S* xq1, const S* Pq1, S dt,
                       const S* p, S* C, S* b, S* V, S* sm, int tid,
                       int nt) {
  S* L = sm;                  // P_{k+1|k}, then its factor
  S* F = L + D2 * D2;         // F_k, then P_{k+1|k+1} - P_{k+1|k}
  S* Pk = F + D2 * D2;        // P_{k|k}, then C dP
  S* X = Pk + D2 * D2;        // F P^T, then X = C^T
  S* diag = X + D2 * D2;
  S* u = diag + D2;           // inv_err(x_{k+1|k}, x_{k+1|k+1}), DE
  if (tid == 0) rn_gen::gen_sm_F<S>(xq0, dt, p, F);
  for (int e = tid; e < D2 * D2; e += nt) {
    const int i = e / D2, j = e % D2;
    L[e] = Pp1[i * DE + j];
    Pk[e] = Pq0[i * DE + j];
  }
  sync_<BLOCK>();
  for (int e = tid; e < D2 * D2; e += nt) {   // X = F P_{k|k}^T
    const int i = e / D2, j = e % D2;
    S s = 0;
    for (int k = 0; k < D2; ++k) s += F[i * D2 + k] * Pk[j * D2 + k];
    X[e] = s;
  }
  cholesky<S, BLOCK>(L, diag, tid, nt);   // syncs first: X is complete
  cho_solve<S>(L, diag, X, tid, nt);
  sync_<BLOCK>();
  for (int e = tid; e < D2 * D2; e += nt) C[e] = X[(e % D2) * D2 + e / D2];
  if (b == nullptr) return;
  if (tid == 0) rn_gen::gen_sm_inv_err<S>(xp1, xq1, p, u);
  for (int e = tid; e < D2 * D2; e += nt) {
    const int i = e / D2, j = e % D2;
    F[e] = Pq1[i * DE + j] - Pp1[i * DE + j];
  }
  sync_<BLOCK>();
  for (int i = tid; i < D2; i += nt) {         // b = C u
    S s = 0;
    for (int k = 0; k < D2; ++k) s += X[k * D2 + i] * u[k];
    b[i] = s;
  }
  for (int e = tid; e < D2 * D2; e += nt) {   // Pk = C dP
    const int i = e / D2, j = e % D2;
    S s = 0;
    for (int k = 0; k < D2; ++k) s += X[k * D2 + i] * F[k * D2 + j];
    Pk[e] = s;
  }
  sync_<BLOCK>();
  for (int e = tid; e < D2 * D2; e += nt) {   // V = C dP C^T
    const int i = e / D2, j = e % D2;
    S s = 0;
    for (int k = 0; k < D2; ++k) s += Pk[i * D2 + k] * X[k * D2 + j];
    V[e] = s;
  }
}

// The refine variant's item: A = C J, b = C (v - J e) at the correction e
// (nullptr: 0) of step k + 1; xp1, xq1: x_{k+1|k}, x_{k+1|k+1}.
template <typename S, bool BLOCK>
GEN_HD void refine_item(const S* xp1, const S* xq1, const S* e,
                        const S* Cg, bool norm, const S* p, S* A, S* b,
                        S* sm, int tid, int nt) {
  S* Cs = sm;
  S* J = Cs + D2 * D2;
  S* v = J + D2 * D2;
  S* w = v + D2;
  if (tid == 0) {
    S zero[D2];
    const S* eh = e;
    if (e == nullptr) {
      for (int i = 0; i < D2; ++i) zero[i] = 0;
      eh = zero;
    }
    if (norm) rn_gen::gen_sm_refine_n1<S>(xp1, xq1, eh, p, v, J);
    else rn_gen::gen_sm_refine_n0<S>(xp1, xq1, eh, p, v, J);
  }
  for (int i = tid; i < D2 * D2; i += nt) Cs[i] = Cg[i];
  sync_<BLOCK>();
  for (int i = tid; i < D2; i += nt) {
    S s = 0;
    if (e != nullptr)
      for (int j = 0; j < D2; ++j) s += J[i * D2 + j] * e[j];
    w[i] = v[i] - s;
  }
  for (int q = tid; q < D2 * D2; q += nt) {   // A = C J
    const int i = q / D2, j = q % D2;
    S s = 0;
    for (int k = 0; k < D2; ++k) s += Cs[i * D2 + k] * J[k * D2 + j];
    A[q] = s;
  }
  sync_<BLOCK>();
  for (int i = tid; i < D2; i += nt) {         // b = C w
    S s = 0;
    for (int k = 0; k < D2; ++k) s += Cs[i * D2 + k] * w[k];
    b[i] = s;
  }
}

// ------------------------------------------------------------- kernel 14

constexpr int INJECT_SMEM = DE;

// One row: x_s = inject(x, [e, 0]), P_s = sym(P + pad(D)); with e ==
// nullptr the row is copied.
template <typename S, bool BLOCK>
GEN_HD void inject_item(const S* x, const S* P, const S* e, const S* D,
                        bool norm, const S* p, S* xs, S* Ps, S* sm, int tid,
                        int nt) {
  if (e == nullptr) {
    for (int i = tid; i < DX; i += nt) xs[i] = x[i];
    for (int i = tid; i < DE * DE; i += nt) Ps[i] = P[i];
    return;
  }
  if (tid == 0) {
    for (int i = 0; i < DE; ++i) sm[i] = i < D2 ? e[i] : (S)0;
    inject<S>(norm, x, sm, p, xs);
  }
  for (int q = tid; q < DE * DE; q += nt) {
    const int i = q / DE, j = q % DE;
    const bool main = i < D2 && j < D2;
    const S a = P[q] + (main ? D[i * D2 + j] : (S)0);
    const S t = P[j * DE + i] + (main ? D[j * D2 + i] : (S)0);
    Ps[q] = (S)0.5 * (a + t);
  }
}

// ------------------------------------------------------------- kernel 12

constexpr int BACK_SMEM = 5 * D2 * D2 + DX + DE + D2;

// One lane's backward pass over its T rows (T >= 1).
template <typename S, bool BLOCK>
GEN_HD void backward_lane(const S* xp, const S* Pp, const S* xq,
                          const S* Pq, const S* C, int T, bool norm,
                          bool ref_seed, const S* p, S* xs, S* Ps, S* sm,
                          int tid, int nt) {
  S* Cs = sm;
  S* Pn = Cs + D2 * D2;       // P_next's main block
  S* Df = Pn + D2 * D2;       // P_next - P_{k+1|k}
  S* M1 = Df + D2 * D2;       // C Df
  S* M = M1 + D2 * D2;        // C Df C^T
  S* xn = M + D2 * D2;        // x_next
  S* dx = xn + DX;
  S* dxm = dx + DE;
  const size_t rx = DX, rp = (size_t)DE * DE;
  const S* x0 = (ref_seed ? xp : xq) + (T - 1) * rx;
  const S* P0 = (ref_seed ? Pp : Pq) + (T - 1) * rp;
  for (int i = tid; i < DX; i += nt) {
    xn[i] = x0[i];
    xs[(T - 1) * rx + i] = x0[i];
  }
  for (int q = tid; q < DE * DE; q += nt) {
    Ps[(T - 1) * rp + q] = P0[q];
    const int i = q / DE, j = q % DE;
    if (i < D2 && j < D2) Pn[i * D2 + j] = P0[q];
  }
  sync_<BLOCK>();
  for (int k = T - 2; k >= 0; --k) {
    const S* Ck = C + (size_t)k * D2 * D2;
    const S* xp1 = xp + (k + 1) * rx;
    const S* Pp1 = Pp + (k + 1) * rp;
    const S* xk = xq + k * rx;
    const S* Pk = Pq + k * rp;
    if (tid == 0) rn_gen::gen_sm_inv_err<S>(xp1, xn, p, dx);
    for (int q = tid; q < D2 * D2; q += nt) {
      Cs[q] = Ck[q];
      Df[q] = Pn[q] - Pp1[(q / D2) * DE + q % D2];
    }
    sync_<BLOCK>();
    for (int i = tid; i < D2; i += nt) {
      S s = 0;
      for (int j = 0; j < D2; ++j) s += Cs[i * D2 + j] * dx[j];
      dxm[i] = s;
    }
    for (int q = tid; q < D2 * D2; q += nt) {
      const int i = q / D2, j = q % D2;
      S s = 0;
      for (int l = 0; l < D2; ++l) s += Cs[i * D2 + l] * Df[l * D2 + j];
      M1[q] = s;
    }
    sync_<BLOCK>();
    if (tid == 0) {
      for (int i = 0; i < D2; ++i) dx[i] = dxm[i];
      inject<S>(norm, xk, dx, p, xn);
    }
    for (int q = tid; q < D2 * D2; q += nt) {
      const int i = q / D2, j = q % D2;
      S s = 0;
      for (int l = 0; l < D2; ++l) s += M1[i * D2 + l] * Cs[j * D2 + l];
      M[q] = s;
    }
    sync_<BLOCK>();
    for (int i = tid; i < DX; i += nt) xs[k * rx + i] = xn[i];
    for (int q = tid; q < DE * DE; q += nt) {
      const int i = q / DE, j = q % DE;
      const bool main = i < D2 && j < D2;
      const S a = Pk[q] + (main ? M[i * D2 + j] : (S)0);
      const S t = Pk[j * DE + i] + (main ? M[j * D2 + i] : (S)0);
      const S v = (S)0.5 * (a + t);
      Ps[k * rp + q] = v;
      if (main) Pn[i * D2 + j] = v;
    }
    sync_<BLOCK>();
  }
}

}  // namespace rn_sm

#ifdef __CUDACC__

namespace rn_sm {

template <typename S>
__global__ void gains_kernel(const S* __restrict__ xp, const S* __restrict__ Pp,
                             const S* __restrict__ xq, const S* __restrict__ Pq,
                             const S* __restrict__ dts, const S* __restrict__ p,
                             S* C, S* b, S* V, int B, int T) {
  extern __shared__ __align__(16) unsigned char smem_[];
  const int n = T - 1;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long item = (long long)blockIdx.x * SM_WARPS + w;
  if (item >= (long long)B * n) return;
  const long long l = item / n, k = item % n;
  const size_t r0 = (size_t)(l * T + k), r1 = r0 + 1;
  const size_t rx = DX, rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  gains_item<S, false>(xq + r0 * rx, Pq + r0 * rp, xp + r1 * rx, Pp + r1 * rp,
                       xq + r1 * rx, Pq + r1 * rp, dts[item], p,
                       C + item * rc, b ? b + item * D2 : nullptr,
                       V ? V + item * rc : nullptr,
                       reinterpret_cast<S*>(smem_) + w * GAINS_SMEM, lane,
                       32);
}

template <typename S>
__global__ void refine_kernel(const S* __restrict__ xp,
                              const S* __restrict__ xq,
                              const S* __restrict__ C,
                              const S* __restrict__ e, int ne,
                              const S* __restrict__ p, S* A, S* b, int B,
                              int T, int norm) {
  extern __shared__ __align__(16) unsigned char smem_[];
  const int n = T - 1;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long item = (long long)blockIdx.x * SM_WARPS + w;
  if (item >= (long long)B * n) return;
  const long long l = item / n, k = item % n;
  const size_t r1 = (size_t)(l * T + k + 1);
  const S* eh = k + 1 < ne ? e + ((size_t)l * ne + k + 1) * D2 : nullptr;
  refine_item<S, false>(xp + r1 * DX, xq + r1 * DX, eh,
                        C + item * (size_t)D2 * D2, norm != 0, p,
                        A + item * (size_t)D2 * D2, b + item * D2,
                        reinterpret_cast<S*>(smem_) + w * REFINE_SMEM, lane,
                        32);
}

template <typename S>
__global__ void inject_kernel(const S* __restrict__ xq,
                              const S* __restrict__ Pq,
                              const S* __restrict__ e,
                              const S* __restrict__ D,
                              const S* __restrict__ p, S* xs, S* Ps, int B,
                              int T, int n, int norm) {
  extern __shared__ __align__(16) unsigned char smem_[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * SM_WARPS + w;
  if (row >= (long long)B * T) return;
  const long long l = row / T, k = row % T;
  const size_t rp = (size_t)DE * DE;
  const size_t el = (size_t)(l * n + k);
  inject_item<S, false>(xq + row * DX, Pq + row * rp,
                        k < n ? e + el * D2 : nullptr,
                        k < n ? D + el * D2 * D2 : nullptr, norm != 0, p,
                        xs + row * DX, Ps + row * rp,
                        reinterpret_cast<S*>(smem_) + w * INJECT_SMEM, lane,
                        32);
}

template <typename S>
__global__ void backward_kernel(const S* __restrict__ xp,
                                const S* __restrict__ Pp,
                                const S* __restrict__ xq,
                                const S* __restrict__ Pq,
                                const S* __restrict__ C,
                                const S* __restrict__ p, S* xs, S* Ps, int T,
                                int norm, int ref_seed) {
  extern __shared__ __align__(16) unsigned char smem_[];
  const size_t l = blockIdx.x;
  const size_t rx = (size_t)T * DX, rp = (size_t)T * DE * DE;
  backward_lane<S, true>(xp + l * rx, Pp + l * rp, xq + l * rx, Pq + l * rp,
                         C + l * (size_t)(T > 1 ? T - 1 : 0) * D2 * D2, T,
                         norm != 0, ref_seed != 0, p, xs + l * rx,
                         Ps + l * rp, reinterpret_cast<S*>(smem_),
                         threadIdx.x, blockDim.x);
}

// blocks of SM_WARPS items for n items
inline unsigned blocks_for(long long n) {
  return (unsigned)((n + SM_WARPS - 1) / SM_WARPS);
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename S>
int gains_launch(const void* xp, const void* Pp, const void* xq,
                 const void* Pq, const void* dts, const void* p, void* C,
                 void* b, void* V, int B, int T, cudaStream_t st) {
  const size_t smem = sizeof(S) * SM_WARPS * GAINS_SMEM;
  cudaError_t err = allow_smem(gains_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  gains_kernel<S><<<blocks_for((long long)B * (T - 1)), 32 * SM_WARPS, smem,
                    st>>>(
      (const S*)xp, (const S*)Pp, (const S*)xq, (const S*)Pq, (const S*)dts,
      (const S*)p, (S*)C, (S*)b, (S*)V, B, T);
  return (int)cudaGetLastError();
}

template <typename S>
int refine_launch(const void* xp, const void* xq, const void* C,
                  const void* e, int ne, const void* p, void* A, void* b,
                  int B, int T, int norm, cudaStream_t st) {
  const size_t smem = sizeof(S) * SM_WARPS * REFINE_SMEM;
  cudaError_t err = allow_smem(refine_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  refine_kernel<S><<<blocks_for((long long)B * (T - 1)), 32 * SM_WARPS, smem,
                     st>>>(
      (const S*)xp, (const S*)xq, (const S*)C, (const S*)e, ne, (const S*)p,
      (S*)A, (S*)b, B, T, norm);
  return (int)cudaGetLastError();
}

template <typename S>
int inject_launch(const void* xq, const void* Pq, const void* e,
                  const void* D, const void* p, void* xs, void* Ps, int B,
                  int T, int n, int norm, cudaStream_t st) {
  const size_t smem = sizeof(S) * SM_WARPS * INJECT_SMEM;
  inject_kernel<S><<<blocks_for((long long)B * T), 32 * SM_WARPS, smem,
                     st>>>(
      (const S*)xq, (const S*)Pq, (const S*)e, (const S*)D, (const S*)p,
      (S*)xs, (S*)Ps, B, T, n, norm);
  return (int)cudaGetLastError();
}

template <typename S>
int backward_launch(const void* xp, const void* Pp, const void* xq,
                    const void* Pq, const void* C, const void* p, void* xs,
                    void* Ps, int B, int T, int norm, int ref_seed,
                    cudaStream_t st) {
  const size_t smem = sizeof(S) * BACK_SMEM;
  cudaError_t err = allow_smem(backward_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  backward_kernel<S><<<B, SM_BACK_THREADS, smem, st>>>(
      (const S*)xp, (const S*)Pp, (const S*)xq, (const S*)Pq, (const S*)C,
      (const S*)p, (S*)xs, (S*)Ps, T, norm, ref_seed);
  return (int)cudaGetLastError();
}

template <typename K>
int kernel_info(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = threads;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}

template <typename S>
int info(int which, int* out) {
  switch (which) {
    case 0:
      return kernel_info(gains_kernel<S>, 32 * SM_WARPS,
                         sizeof(S) * SM_WARPS * GAINS_SMEM, out);
    case 1:
      return kernel_info(refine_kernel<S>, 32 * SM_WARPS,
                         sizeof(S) * SM_WARPS * REFINE_SMEM, out);
    case 2:
      return kernel_info(backward_kernel<S>, SM_BACK_THREADS,
                         sizeof(S) * BACK_SMEM, out);
    default:
      return kernel_info(inject_kernel<S>, 32 * SM_WARPS,
                         sizeof(S) * SM_WARPS * INJECT_SMEM, out);
  }
}

}  // namespace rn_sm

// C entries: every pointer a device pointer, is_double picks the scalar
// type; each returns the launch's cudaGetLastError().
extern "C" int rn_smooth_gains_launch(const void* xp, const void* Pp,
                                      const void* xq, const void* Pq,
                                      const void* dts, const void* p,
                                      void* C, void* b, void* V, int B,
                                      int T, int is_double, void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double
      ? rn_sm::gains_launch<double>(xp, Pp, xq, Pq, dts, p, C, b, V, B, T, st)
      : rn_sm::gains_launch<float>(xp, Pp, xq, Pq, dts, p, C, b, V, B, T, st);
}

extern "C" int rn_smooth_refine_launch(const void* xp, const void* xq,
                                       const void* C, const void* e, int ne,
                                       const void* p, void* A, void* b,
                                       int B, int T, int norm, int is_double,
                                       void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double
      ? rn_sm::refine_launch<double>(xp, xq, C, e, ne, p, A, b, B, T, norm, st)
      : rn_sm::refine_launch<float>(xp, xq, C, e, ne, p, A, b, B, T, norm, st);
}

extern "C" int rn_smooth_backward_launch(const void* xp, const void* Pp,
                                         const void* xq, const void* Pq,
                                         const void* C, const void* p,
                                         void* xs, void* Ps, int B, int T,
                                         int norm, int ref_seed,
                                         int is_double, void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double
      ? rn_sm::backward_launch<double>(xp, Pp, xq, Pq, C, p, xs, Ps, B, T,
                                       norm, ref_seed, st)
      : rn_sm::backward_launch<float>(xp, Pp, xq, Pq, C, p, xs, Ps, B, T,
                                      norm, ref_seed, st);
}

extern "C" int rn_smooth_inject_launch(const void* xq, const void* Pq,
                                       const void* e, const void* D,
                                       const void* p, void* xs, void* Ps,
                                       int B, int T, int n, int norm,
                                       int is_double, void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double
      ? rn_sm::inject_launch<double>(xq, Pq, e, D, p, xs, Ps, B, T, n, norm,
                                     st)
      : rn_sm::inject_launch<float>(xq, Pq, e, D, p, xs, Ps, B, T, n, norm,
                                    st);
}

// out (5 ints): threads a block, dynamic shared bytes, blocks an SM
// holds, registers, local (stack) bytes of kernel `which`: 0 gains, 1 its
// refine variant, 2 the backward pass, 3 the inject
extern "C" int rn_smooth_info(int which, int is_double, int* out) {
  return is_double ? rn_sm::info<double>(which, out)
                   : rn_sm::info<float>(which, out);
}

#else  // the host build (tests): the same item functions, one thread each

namespace rn_sm {

template <typename S>
int gains_host(const S* xp, const S* Pp, const S* xq, const S* Pq,
               const S* dts, const S* p, S* C, S* b, S* V, int B, int T) {
  const int n = T - 1;
  S* sm = (S*)malloc(sizeof(S) * GAINS_SMEM);
  const size_t rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  for (long long item = 0; item < (long long)B * n; ++item) {
    const long long l = item / n, k = item % n;
    const size_t r0 = (size_t)(l * T + k), r1 = r0 + 1;
    gains_item<S, false>(xq + r0 * DX, Pq + r0 * rp, xp + r1 * DX,
                         Pp + r1 * rp, xq + r1 * DX, Pq + r1 * rp, dts[item],
                         p, C + item * rc, b ? b + item * D2 : nullptr,
                         V ? V + item * rc : nullptr, sm, 0, 1);
  }
  free(sm);
  return 0;
}

template <typename S>
int refine_host(const S* xp, const S* xq, const S* C, const S* e, int ne,
                const S* p, S* A, S* b, int B, int T, int norm) {
  const int n = T - 1;
  S* sm = (S*)malloc(sizeof(S) * REFINE_SMEM);
  for (long long item = 0; item < (long long)B * n; ++item) {
    const long long l = item / n, k = item % n;
    const size_t r1 = (size_t)(l * T + k + 1);
    const S* eh = k + 1 < ne ? e + ((size_t)l * ne + k + 1) * D2 : nullptr;
    refine_item<S, false>(xp + r1 * DX, xq + r1 * DX, eh,
                          C + item * (size_t)D2 * D2, norm != 0, p,
                          A + item * (size_t)D2 * D2, b + item * D2, sm, 0,
                          1);
  }
  free(sm);
  return 0;
}

template <typename S>
int backward_host(const S* xp, const S* Pp, const S* xq, const S* Pq,
                  const S* C, const S* p, S* xs, S* Ps, int B, int T,
                  int norm, int ref_seed) {
  S* sm = (S*)malloc(sizeof(S) * BACK_SMEM);
  const size_t rx = (size_t)T * DX, rp = (size_t)T * DE * DE;
  for (size_t l = 0; l < (size_t)B; ++l)
    backward_lane<S, true>(xp + l * rx, Pp + l * rp, xq + l * rx,
                           Pq + l * rp,
                           C + l * (size_t)(T > 1 ? T - 1 : 0) * D2 * D2, T,
                           norm != 0, ref_seed != 0, p, xs + l * rx,
                           Ps + l * rp, sm, 0, 1);
  free(sm);
  return 0;
}

template <typename S>
int inject_host(const S* xq, const S* Pq, const S* e, const S* D,
                const S* p, S* xs, S* Ps, int B, int T, int n, int norm) {
  S sm[INJECT_SMEM];
  const size_t rp = (size_t)DE * DE;
  for (long long row = 0; row < (long long)B * T; ++row) {
    const long long l = row / T, k = row % T;
    const size_t el = (size_t)(l * n + k);
    inject_item<S, false>(xq + row * DX, Pq + row * rp,
                          k < n ? e + el * D2 : nullptr,
                          k < n ? D + el * D2 * D2 : nullptr, norm != 0, p,
                          xs + row * DX, Ps + row * rp, sm, 0, 1);
  }
  return 0;
}

}  // namespace rn_sm

// the device entries' signatures, without the stream
extern "C" int rn_smooth_gains_host(const void* xp, const void* Pp,
                                    const void* xq, const void* Pq,
                                    const void* dts, const void* p, void* C,
                                    void* b, void* V, int B, int T,
                                    int is_double) {
  if (!is_double)
    return rn_sm::gains_host<float>(
        (const float*)xp, (const float*)Pp, (const float*)xq,
        (const float*)Pq, (const float*)dts, (const float*)p, (float*)C,
        (float*)b, (float*)V, B, T);
  return rn_sm::gains_host<double>(
      (const double*)xp, (const double*)Pp, (const double*)xq,
      (const double*)Pq, (const double*)dts, (const double*)p, (double*)C,
      (double*)b, (double*)V, B, T);
}

extern "C" int rn_smooth_refine_host(const void* xp, const void* xq,
                                     const void* C, const void* e, int ne,
                                     const void* p, void* A, void* b, int B,
                                     int T, int norm, int is_double) {
  if (!is_double)
    return rn_sm::refine_host<float>(
        (const float*)xp, (const float*)xq, (const float*)C,
        (const float*)e, ne, (const float*)p, (float*)A, (float*)b, B, T,
        norm);
  return rn_sm::refine_host<double>(
      (const double*)xp, (const double*)xq, (const double*)C,
      (const double*)e, ne, (const double*)p, (double*)A, (double*)b, B, T,
      norm);
}

extern "C" int rn_smooth_backward_host(const void* xp, const void* Pp,
                                       const void* xq, const void* Pq,
                                       const void* C, const void* p,
                                       void* xs, void* Ps, int B, int T,
                                       int norm, int ref_seed,
                                       int is_double) {
  if (!is_double)
    return rn_sm::backward_host<float>(
        (const float*)xp, (const float*)Pp, (const float*)xq,
        (const float*)Pq, (const float*)C, (const float*)p, (float*)xs,
        (float*)Ps, B, T, norm, ref_seed);
  return rn_sm::backward_host<double>(
      (const double*)xp, (const double*)Pp, (const double*)xq,
      (const double*)Pq, (const double*)C, (const double*)p, (double*)xs,
      (double*)Ps, B, T, norm, ref_seed);
}

extern "C" int rn_smooth_inject_host(const void* xq, const void* Pq,
                                     const void* e, const void* D,
                                     const void* p, void* xs, void* Ps,
                                     int B, int T, int n, int norm,
                                     int is_double) {
  if (!is_double)
    return rn_sm::inject_host<float>(
        (const float*)xq, (const float*)Pq, (const float*)e,
        (const float*)D, (const float*)p, (float*)xs, (float*)Ps, B, T, n,
        norm);
  return rn_sm::inject_host<double>(
      (const double*)xq, (const double*)Pq, (const double*)e,
      (const double*)D, (const double*)p, (double*)xs, (double*)Ps, B, T, n,
      norm);
}

#endif  // __CUDACC__
