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
// registers and spill (kernel 10's first form lost 8x that way). A WARP
// takes an item: its matrices sit in the warp's slice of shared memory at
// an odd row stride (LD), each product is spread over the 32 lanes a
// SM_TILE x SM_TILE register tile a lane (its operands loaded once a k:
// 2 / SM_TILE shared loads a multiply-add, not 2), the Cholesky goes
// column by column (a lane a row, two __syncwarp a column), the solve a
// lane a right-hand side. The spec's F (and the refine taps) come in
// SM_PARTS parts; a block of SM_GAINS_WARPS items runs part r on warp r,
// its lane i for item i, so each part is one instruction stream over the
// block's items; inv_err is serial code on lane 0. Each emitted function
// is a call of its own (GEN_PHASE), so ptxas allocates its registers
// apart. Kernel 14 is bound by bytes (it reads and writes each row once):
// a warp a row, lane 0 the injection, the 32 lanes the covariance.
// Kernel 12 is a chain over k for each lane: a BLOCK a lane (a mapping
// that does not depend on B, so a bank's lane is bitwise that lane
// alone). Its step is two chains that depend on nothing of each other:
// the state chain (inv_err, C dx, inject) on one warp, and the
// covariance chain (two dependent D2^3 products) on SM_COV_WARPS warps
// with two named barriers a step; an IO warp keeps their inputs
// SM_BACK_STAGES steps ahead in a shared-memory ring and writes their
// rows out, so no chain waits on global memory, and a step costs the
// longer chain, not the sum. C_k comes from kernel 11. Only B blocks run
// (64 on the offline path, of 132 SMs): its time is the chain's latency,
// step after step.
//
// Numerics: IEEE, no fast-math, float or double as the stacks are. The
// gains solve by Cholesky where the JAX package's sequential pass solves
// by LU (jnp.linalg.solve): the two agree to rounding. Every product
// entry is one FMA chain in ascending k, as in the first design, so the
// tiles change no rounding. P_s is symmetric bitwise (each entry
// computed once from the pair).

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

// Design constants; each may be set by a -D or a #define before this file
// (sweep_warps.py --parts smooth builds every candidate that way).
#ifndef RN_SM_GAINS_WARPS
#define RN_SM_GAINS_WARPS 4
#endif
#ifndef RN_SM_COV_WARPS
#define RN_SM_COV_WARPS 8
#endif
#ifndef RN_SM_BACK_STAGES
#define RN_SM_BACK_STAGES 4
#endif
// RN_SM_TILE 0: kernel 11's tile from D2 (SM_TILE below)
#ifndef RN_SM_TILE
#define RN_SM_TILE 0
#endif
// Timing aids (sweep_warps.py; their outputs are garbage), bits: kernel
// 11 without the spec's functions (1), without its products (2), without
// its factor and solve (4); kernel 12 without the state chain (8), without
// the covariance chain (16), without the ring (32: the chains read their
// inputs from global memory).
#ifndef RN_SM_AID
#define RN_SM_AID 0
#endif
// kernel 12's tiles of M1 and of M's pairs (0: the least that fit the
// covariance warps' threads); 3 x 3 for M1 measured best (PERF.md)
#ifndef RN_SM_COV_T1
#define RN_SM_COV_T1 3
#endif
#ifndef RN_SM_COV_T2
#define RN_SM_COV_T2 0
#endif

// a loop the card unrolls whole (its trip count a constant), so that its
// loads are issued ahead of the chain of multiply-adds
#ifdef __CUDA_ARCH__
#define SM_UNROLL _Pragma("unroll")
#else
#define SM_UNROLL
#endif

namespace rn_sm {

using rn_gen::D1;
using rn_gen::D2;
using rn_gen::DE;
using rn_gen::DX;
using rn_gen::NP;
using rn_gen::SM_PARTS;

constexpr int SM_WARPS = 4;            // rows (warps) a block, kernel 14
// items (warps) a block of kernel 11: the spec's F is split into
// SM_PARTS parts, run a part a warp for all the block's items at once
constexpr int SM_GAINS_WARPS = RN_SM_GAINS_WARPS;
// kernel 12's block: an IO warp (the ring's copies in and the rows out), a
// state warp and SM_COV_WARPS covariance warps; SM_COV_WARPS = 8 and
// SM_BACK_STAGES = 4 measured among 2-16 warps and 2-8 stages (PERF.md,
// sweep_warps.py --parts smooth)
constexpr int SM_COV_WARPS = RN_SM_COV_WARPS;
constexpr int SM_BACK_STAGES = RN_SM_BACK_STAGES;
constexpr int SM_BACK_THREADS = 32 * (2 + SM_COV_WARPS);
static_assert(SM_BACK_STAGES >= 2, "kernel 12's ring holds two steps or more");
// odd row stride of kernel 11's matrices in shared memory: a column read
// across the lanes meets 32 banks
constexpr int LD = D2 | 1;

GEN_HD constexpr int min_(int a, int b) { return a < b ? a : b; }

// tiles of t x t outputs over a D2 x D2 product, all of them or those of
// the upper triangle (diagonal tiles included)
GEN_HD constexpr int tiles_of(int t, bool upper) {
  return upper ? ((D2 + t - 1) / t) * ((D2 + t - 1) / t + 1) / 2
               : ((D2 + t - 1) / t) * ((D2 + t - 1) / t);
}

// the least tile (1-4) whose tiles fit `threads` threads
GEN_HD constexpr int tile_for(int threads, bool upper) {
  return tiles_of(1, upper) <= threads   ? 1
         : tiles_of(2, upper) <= threads ? 2
         : tiles_of(3, upper) <= threads ? 3
                                         : 4;
}

// kernel 11's tile: at most two tiles a lane
constexpr int SM_TILE = RN_SM_TILE ? RN_SM_TILE : tile_for(64, false);
// kernel 12's tiles of M1 = C dP (all) and of M = M1 C^T (upper pairs)
constexpr int COV_T1 =
    RN_SM_COV_T1 ? RN_SM_COV_T1 : tile_for(32 * SM_COV_WARPS, false);
constexpr int COV_T2 =
    RN_SM_COV_T2 ? RN_SM_COV_T2 : tile_for(32 * SM_COV_WARPS, true);

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

// O(i, j) = sum_{k < D2} A(i, k) B(k, j) for i, j < D2, each entry one FMA
// chain in ascending k; a thread a TT x TT tile of outputs at a time, its
// operands loaded once a k into registers. A(i, k) is A[i * ai + k * ak],
// B(k, j) is B[k * bk + j * bj], O(i, j) goes to O[i * oi + j * oj]. A
// tile past D2 repeats the last row or column and stores nothing there.
template <typename S, int TT>
GEN_HD GEN_INLINE void mm_tiles(const S* A, int ai, int ak, const S* B,
                                int bk, int bj, S* O, int oi, int oj, int tid,
                                int nt) {
  constexpr int G = (D2 + TT - 1) / TT;
  for (int t = tid; t < G * G; t += nt) {
    const int i0 = t / G * TT, j0 = t % G * TT;
    int ra[TT], cb[TT];
    S acc[TT][TT];
    for (int a = 0; a < TT; ++a) {
      ra[a] = min_(i0 + a, D2 - 1) * ai;
      cb[a] = min_(j0 + a, D2 - 1) * bj;
      for (int b = 0; b < TT; ++b) acc[a][b] = 0;
    }
    SM_UNROLL
    for (int k = 0; k < D2; ++k) {
      S av[TT], bv[TT];
      for (int a = 0; a < TT; ++a) av[a] = A[ra[a] + k * ak];
      for (int b = 0; b < TT; ++b) bv[b] = B[k * bk + cb[b]];
      for (int a = 0; a < TT; ++a)
        for (int b = 0; b < TT; ++b) acc[a][b] += av[a] * bv[b];
    }
    for (int a = 0; a < TT; ++a)
      for (int b = 0; b < TT; ++b)
        if (i0 + a < D2 && j0 + b < D2)
          O[(i0 + a) * oi + (j0 + b) * oj] = acc[a][b];
  }
}

// the Cholesky factor of the symmetric positive definite A (D2 x D2, row
// stride LD; its lower triangle read), in place: L's strict lower triangle
// in A, its diagonal in diag (A's diagonal keeps the pivots' squares).
// Left-looking, of a warp's NL threads (tid: this one's) a thread a row of
// each column. (A lane's row kept in registers, the loops unrolled, took
// 255 registers and spilled: PERF.md.)
template <typename S, int NL>
GEN_HD GEN_INLINE void cholesky(S* A, S* diag, int tid) {
  for (int j = 0; j < D2; ++j) {
    for (int i = j + tid; i < D2; i += NL) {
      S s = A[i * LD + j];
      for (int k = 0; k < j; ++k) s -= A[i * LD + k] * A[j * LD + k];
      A[i * LD + j] = s;
    }
    sync_<false>();
    const S d = g_sqrt(A[j * LD + j]);
    for (int i = j + 1 + tid; i < D2; i += NL) A[i * LD + j] /= d;
    if (tid == 0) diag[j] = d;
    sync_<false>();
  }
}

// X := (L L^T)^-1 X for X (D2 x D2, row stride LD), of NL threads a
// thread a column (a column kept in registers spilled too: PERF.md)
template <typename S, int NL>
GEN_HD GEN_INLINE void cho_solve(const S* L, const S* diag, S* X, int tid) {
  for (int c = tid; c < D2; c += NL) {
    for (int i = 0; i < D2; ++i) {
      S s = X[i * LD + c];
      for (int k = 0; k < i; ++k) s -= L[i * LD + k] * X[k * LD + c];
      X[i * LD + c] = s / diag[i];
    }
    for (int i = D2 - 1; i >= 0; --i) {
      S s = X[i * LD + c];
      for (int k = i + 1; k < D2; ++k) s -= L[k * LD + i] * X[k * LD + c];
      X[i * LD + c] = s / diag[i];
    }
  }
}

// ------------------------------------------------------------- kernel 11
//
// A block takes SM_GAINS_WARPS items (lane, k), a warp each, and first
// runs the spec's F for all of them at once: warp w runs parts w, w +
// SM_GAINS_WARPS, ... of gen_sm_F_part, its lane i for item i (so a part
// is one instruction stream over the block's items). Then each warp
// finishes its item alone: the products in SM_TILE x SM_TILE register
// tiles, the Cholesky and the solve over its lanes, inv_err on lane 0.

// scalars of a gains item's slice of shared memory
constexpr int GAINS_SMEM = 4 * D2 * LD + D2 + DE;
constexpr int REFINE_SMEM = 2 * D2 * LD + 3 * D2;

// an item's loads: P_{k+1|k} and P_{k|k}'s main blocks into L and Pk
template <typename S>
GEN_HD GEN_INLINE void gains_load(const S* Pq0, const S* Pp1, S* sm, int tid,
                                  int nt) {
  S* L = sm;
  S* Pk = L + 2 * D2 * LD;
  for (int e = tid; e < D2 * D2; e += nt) {
    const int i = e / D2, j = e % D2;
    L[i * LD + j] = Pp1[i * DE + j];
    Pk[i * LD + j] = Pq0[i * DE + j];
  }
}

// part r of an item's F (x_{k|k}, dt) into its slice
template <typename S>
GEN_HD GEN_INLINE void gains_F(const S* xq0, S dt, const S* p, S* sm, int r) {
#if defined(RN_SM_F_WHOLE)   // a timing aid's F: one whole function
  if (r == 0) rn_gen::gen_sm_F_whole<S>(xq0, dt, p, sm + D2 * LD);
#elif !(RN_SM_AID & 1)
  rn_gen::gen_sm_F_part<S>(xq0, dt, p, sm + D2 * LD, LD, r);
#endif
}

// The rest of an item (lane, k), its F and loads in its slice: C_k
// (row-major D2 x D2) into C and, with b given, b_k and V_k. xp1:
// x_{k+1|k}, Pp1: P_{k+1|k}; xq1, Pq1: x_{k+1|k+1}, P_{k+1|k+1}.
template <typename S, int NL>
GEN_HD void gains_item(const S* xp1, const S* Pp1, const S* xq1,
                       const S* Pq1, const S* p, S* C, S* b, S* V, S* sm,
                       int tid) {
  constexpr int nt = NL;
  S* L = sm;                  // P_{k+1|k}, then its factor
  S* F = L + D2 * LD;         // F_k, then P_{k+1|k+1} - P_{k+1|k}
  S* Pk = F + D2 * LD;        // P_{k|k}, then C dP
  S* X = Pk + D2 * LD;        // F P^T, then X = C^T
  S* diag = X + D2 * LD;
  S* u = diag + D2;           // inv_err(x_{k+1|k}, x_{k+1|k+1}), DE
  sync_<false>();
#if !(RN_SM_AID & 2)
  mm_tiles<S, SM_TILE>(F, LD, 1, Pk, 1, LD, X, LD, 1, tid, nt);
#endif
#if !(RN_SM_AID & 4)
  cholesky<S, NL>(L, diag, tid);   // syncs first: X is complete
  cho_solve<S, NL>(L, diag, X, tid);
#endif
  sync_<false>();
  for (int e = tid; e < D2 * D2; e += nt) C[e] = X[(e % D2) * LD + e / D2];
  if (b == nullptr) return;
#if !(RN_SM_AID & 1)
  if (tid == 0) rn_gen::gen_sm_inv_err<S>(xp1, xq1, p, u);
#endif
  for (int e = tid; e < D2 * D2; e += nt) {
    const int i = e / D2, j = e % D2;
    F[i * LD + j] = Pq1[i * DE + j] - Pp1[i * DE + j];
  }
  sync_<false>();
#if !(RN_SM_AID & 2)
  for (int i = tid; i < D2; i += nt) {         // b = C u
    S s = 0;
    for (int k = 0; k < D2; ++k) s += X[k * LD + i] * u[k];
    b[i] = s;
  }
  mm_tiles<S, SM_TILE>(X, 1, LD, F, LD, 1, Pk, LD, 1, tid, nt);
  sync_<false>();                               // Pk = C dP complete
  mm_tiles<S, SM_TILE>(Pk, LD, 1, X, LD, 1, V, D2, 1, tid, nt);
#endif
}

// part r of the refine taps of an item (x_{k+1|k}, x_{k+1|k+1}, the
// correction e of step k + 1, nullptr: 0) into its slice
template <typename S>
GEN_HD GEN_INLINE void refine_taps(const S* xp1, const S* xq1, const S* e,
                                   bool norm, const S* p, S* sm, int r) {
  S* J = sm + D2 * LD;
  S* v = J + D2 * LD;
  S* z = v + 2 * D2;
  if (e == nullptr) {
    for (int i = 0; i < D2; ++i) z[i] = 0;
    e = z;
  }
#if !(RN_SM_AID & 1)
  if (norm) rn_gen::gen_sm_refine_n1_part<S>(xp1, xq1, e, p, v, J, LD, r);
  else rn_gen::gen_sm_refine_n0_part<S>(xp1, xq1, e, p, v, J, LD, r);
#endif
}

// The refine variant's item, its taps in its slice: A = C J, b = C (v -
// J e) at the correction e (nullptr: 0) of step k + 1.
template <typename S, bool BLOCK>
GEN_HD void refine_item(const S* e, const S* Cg, S* A, S* b, S* sm,
                        int tid, int nt) {
  S* Cs = sm;
  S* J = Cs + D2 * LD;
  S* v = J + D2 * LD;
  S* w = v + D2;
  for (int q = tid; q < D2 * D2; q += nt) Cs[(q / D2) * LD + q % D2] = Cg[q];
  sync_<BLOCK>();
  for (int i = tid; i < D2; i += nt) {
    S s = 0;
    if (e != nullptr)
      for (int j = 0; j < D2; ++j) s += J[i * LD + j] * e[j];
    w[i] = v[i] - s;
  }
#if !(RN_SM_AID & 2)
  mm_tiles<S, SM_TILE>(Cs, LD, 1, J, LD, 1, A, D2, 1, tid, nt);
#endif
  sync_<BLOCK>();
  for (int i = tid; i < D2; i += nt) {         // b = C w
    S s = 0;
    for (int k = 0; k < D2; ++k) s += Cs[i * LD + k] * w[k];
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
//
// A block a lane, its chain over k in two chains that share no barrier:
// the state chain (x_next -> inv_err -> C dx -> inject, one warp) and the
// covariance chain (P_next -> M1 = C (P_next - P_{k+1|k}) -> M1 C^T + sym
// -> P_next, SM_COV_WARPS warps, two named barriers a step). Neither reads
// global memory: an IO warp stages each step's inputs SM_BACK_STAGES steps
// ahead in a ring of shared memory (cp.async, an mbarrier a stage), and
// writes each step's rows x_s, P_s out of the ring once both chains are
// done with it. P_s replaces P_{k|k} in its stage; P_next stays in shared
// memory.

// 16-byte multiples of a count of scalars
template <typename S>
GEN_HD constexpr int pad16(int n) {
  return (n * (int)sizeof(S) + 15) / 16 * 16 / (int)sizeof(S);
}

// kernel 12's shared memory, in scalars after the barriers: the ring's
// stages (C_k, P_{k+1|k}'s main block, P_{k|k} then P_s, x_{k+1|k},
// x_{k|k}, x_s), then Df = P_next - P_{k+1|k} on the main block (formed
// as P_next is, one step ahead), M1, x_next, dx and C dx
template <typename S>
struct Back {
  static constexpr int C = 0;
  static constexpr int PQ = C + pad16<S>(D2 * D2);
  static constexpr int P = PQ + pad16<S>(D2 * D2);
  static constexpr int XP = P + pad16<S>(DE * DE);
  static constexpr int XQ = XP + pad16<S>(DX);
  static constexpr int XS = XQ + pad16<S>(DX);
  static constexpr int STAGE = XS + pad16<S>(DX);
  static constexpr int DF = SM_BACK_STAGES * STAGE;
  static constexpr int M1 = DF + D2 * D2;
  static constexpr int XN = M1 + D2 * D2;
  static constexpr int DXV = XN + DX;
  static constexpr int DXM = DXV + DE;
  static constexpr int TOTAL = DXM + D2;
};
// bytes of the ring's mbarriers (full and done, a pair a stage)
constexpr int BACK_BAR_BYTES = (2 * SM_BACK_STAGES * 8 + 15) / 16 * 16;

template <typename S>
constexpr size_t back_smem() {
  return BACK_BAR_BYTES + sizeof(S) * Back<S>::TOTAL;
}

// The state chain's step k on one warp (lanes lane, lane + nl, ...): dx =
// inv_err(x_{k+1|k}, x_next), dx[:D2] = C_k dx[:D2], x_next = x_s =
// inject(x_{k|k}, dx), also written to xs.
template <typename S>
GEN_HD GEN_INLINE void back_state(const S* Ck, const S* xp1, const S* xk,
                                  S* xs, S* xn, S* dx, S* dxm, bool norm,
                                  const S* p, int lane, int nl) {
  if (lane == 0) rn_gen::gen_sm_inv_err<S>(xp1, xn, p, dx);
  sync_<false>();
  for (int i = lane; i < D2; i += nl) {
    S s = 0;
    SM_UNROLL
    for (int j = 0; j < D2; ++j) s += Ck[i * D2 + j] * dx[j];
    dxm[i] = s;
  }
  sync_<false>();
  for (int i = lane; i < D2; i += nl) dx[i] = dxm[i];
  sync_<false>();
  if (lane == 0) inject<S>(norm, xk, dx, p, xn);
  sync_<false>();
  for (int i = lane; i < DX; i += nl) xs[i] = xn[i];
}

// The covariance chain's first product: M1 = C_k Df, Df = P_next -
// P_{k+1|k} on the main block.
template <typename S>
GEN_HD GEN_INLINE void back_m1(const S* Ck, const S* Df, S* M1, int tid,
                               int nt) {
  mm_tiles<S, COV_T1>(Ck, D2, 1, Df, D2, 1, M1, D2, 1, tid, nt);
}

// Df of the seed: P_next's main block (row stride DE) less P_{k+1|k}'s
// (Pq, row stride ldq)
template <typename S>
GEN_HD GEN_INLINE void back_seed_df(const S* P0, const S* Pq, int ldq, S* Df,
                                    int tid, int nt) {
  for (int q = tid; q < D2 * D2; q += nt) {
    const int i = q / D2, j = q % D2;
    Df[q] = P0[i * DE + j] - Pq[i * ldq + j];
  }
}

// Its second: M = M1 C_k^T by upper pairs of COV_T2 x COV_T2 tiles (a tile
// and its mirror on one thread), fused with P_s = sym(P_{k|k} + pad(M))
// (Pk: P_{k|k}; into Ps, which may be Pk) and, with the next step's
// P_{k|k-1} given (Pq, row stride ldq), the next step's Df = P_s -
// P_{k|k-1} on the main block.
template <typename S>
GEN_HD GEN_INLINE void back_sym(const S* M1, const S* Ck, const S* Pk,
                                S* Ps, const S* Pq, int ldq, S* Df, int tid,
                                int nt) {
  constexpr int TT = COV_T2, G = (D2 + TT - 1) / TT;
  for (int t = tid; t < G * (G + 1) / 2; t += nt) {
    int I = 0, r = t;
    while (r >= G - I) r -= G - I++;
    const int J = I + r;
    int ri[TT], cj[TT];
    S m[TT][TT], mt[TT][TT];   // M(i, j), M(j, i) over the tile's (i, j)
    for (int a = 0; a < TT; ++a) {
      ri[a] = min_(I * TT + a, D2 - 1) * D2;
      cj[a] = min_(J * TT + a, D2 - 1) * D2;
      for (int b = 0; b < TT; ++b) m[a][b] = mt[a][b] = 0;
    }
    SM_UNROLL
    for (int l = 0; l < D2; ++l) {
      S mi[TT], ci[TT], mj[TT], cjv[TT];
      for (int a = 0; a < TT; ++a) {
        mi[a] = M1[ri[a] + l];
        cjv[a] = Ck[cj[a] + l];
      }
      for (int a = 0; a < TT; ++a)
        for (int b = 0; b < TT; ++b) m[a][b] += mi[a] * cjv[b];
      if (I < J) {
        for (int a = 0; a < TT; ++a) {
          mj[a] = M1[cj[a] + l];
          ci[a] = Ck[ri[a] + l];
        }
        for (int a = 0; a < TT; ++a)
          for (int b = 0; b < TT; ++b) mt[a][b] += mj[b] * ci[a];
      }
    }
    for (int a = 0; a < TT; ++a)
      for (int b = 0; b < TT; ++b) {
        const int i = I * TT + a, j = J * TT + b;
        if (i >= D2 || j >= D2 || (I == J && a > b)) continue;
        const S mij = m[a][b], mji = I < J ? mt[a][b] : m[b][a];
        const S x = Pk[i * DE + j] + mij;
        const S y = Pk[j * DE + i] + mji;
        const S v = (S)0.5 * (x + y);
        Ps[i * DE + j] = v;
        Ps[j * DE + i] = v;
        if (Pq != nullptr) {
          Df[i * D2 + j] = v - Pq[i * ldq + j];
          Df[j * D2 + i] = v - Pq[j * ldq + i];
        }
      }
  }
  for (int q = tid; q < DE * DE; q += nt) {    // the rows past the block
    const int i = q / DE, j = q % DE;
    if (j < D2 || j < i) continue;
    const S x = Pk[q] + (S)0;
    const S y = Pk[j * DE + i] + (S)0;
    const S v = (S)0.5 * (x + y);
    Ps[q] = v;
    Ps[j * DE + i] = v;
  }
}

// step k's inputs into stage g (one thread: the host build's ring as a
// plain copy)
template <typename S>
GEN_HD GEN_INLINE void back_fill_plain(S* g, const S* xp, const S* Pp,
                                       const S* xq, const S* Pq,
                                       const S* C, int k) {
  const size_t rx = DX, rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  for (int q = 0; q < D2 * D2; ++q) {
    g[Back<S>::C + q] = C[k * rc + q];
    g[Back<S>::PQ + q] = Pp[(k + 1) * rp + (q / D2) * DE + q % D2];
  }
  for (int q = 0; q < DE * DE; ++q) g[Back<S>::P + q] = Pq[k * rp + q];
  for (int i = 0; i < DX; ++i) {
    g[Back<S>::XP + i] = xp[(k + 1) * rx + i];
    g[Back<S>::XQ + i] = xq[k * rx + i];
  }
}

}  // namespace rn_sm

#ifdef __CUDACC__

namespace rn_sm {

// the ring's primitives: mbarriers in shared memory, cp.async into it
__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}" ::"r"(
          smem_u32(bar))
      : "memory");
}

// arrives once every cp.async this thread issued before has landed
__device__ __forceinline__ void bar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned ok = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!ok);
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N)
               : "memory");
}

// n scalars from global src to shared dst over a warp: 16-byte copies
// where both ends and the length allow, else a scalar each
template <typename S>
__device__ __forceinline__ void copy_async(S* dst, const S* src, int n,
                                           int lane) {
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) &
       15) == 0 && (n * sizeof(S)) % 16 == 0) {
    const int m = (int)(n * sizeof(S) / 16);
    for (int c = lane; c < m; c += 32)
      cp_async<16>(reinterpret_cast<char*>(dst) + 16 * c,
                   reinterpret_cast<const char*>(src) + 16 * c);
  } else {
    for (int i = lane; i < n; i += 32)
      cp_async<(int)sizeof(S)>(dst + i, src + i);
  }
}

// N scalars from shared src to global dst over a warp, every load ahead
// of every store: 16 bytes a copy where both ends allow, else a scalar
template <typename S, int N>
__device__ __forceinline__ void rows_out(S* dst, const S* src, int lane) {
  constexpr int V = N * (int)sizeof(S) % 16 == 0 ? N * (int)sizeof(S) / 16
                                                 : 0;
  if (V && ((reinterpret_cast<uintptr_t>(dst) |
             reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    constexpr int PL = V ? (V + 31) / 32 : 1;
    int4 v[PL];
    SM_UNROLL
    for (int q = 0; q < PL; ++q)
      if (lane + 32 * q < V)
        v[q] = reinterpret_cast<const int4*>(src)[lane + 32 * q];
    SM_UNROLL
    for (int q = 0; q < PL; ++q)
      if (lane + 32 * q < V)
        reinterpret_cast<int4*>(dst)[lane + 32 * q] = v[q];
  } else {
    constexpr int PL = (N + 31) / 32;
    S v[PL];
    SM_UNROLL
    for (int q = 0; q < PL; ++q)
      if (lane + 32 * q < N) v[q] = src[lane + 32 * q];
    SM_UNROLL
    for (int q = 0; q < PL; ++q)
      if (lane + 32 * q < N) dst[lane + 32 * q] = v[q];
  }
}

}  // namespace rn_sm

#endif  // __CUDACC__

// RN_SM_HELPERS_ONLY (csrc/smooth_adjoint.cuh's sources): the helpers
// above without kernels 11, 12 and 14 and their entries
#ifndef RN_SM_HELPERS_ONLY

#ifdef __CUDACC__

namespace rn_sm {

template <typename S>
__global__ void gains_kernel(const S* __restrict__ xp, const S* __restrict__ Pp,
                             const S* __restrict__ xq, const S* __restrict__ Pq,
                             const S* __restrict__ dts, const S* __restrict__ p,
                             S* C, S* b, S* V, int B, int T) {
  extern __shared__ __align__(16) unsigned char smem_[];
  S* sm = reinterpret_cast<S*>(smem_);
  const long long n = T - 1, items = (long long)B * n;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long first = (long long)blockIdx.x * SM_GAINS_WARPS;
  const size_t rx = DX, rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  const long long item = first + w;
  size_t r0 = 0;
  if (item < items) {
    r0 = (size_t)((item / n) * T + item % n);
    gains_load<S>(Pq + r0 * rp, Pp + (r0 + 1) * rp, sm + w * GAINS_SMEM, lane,
                  32);
  }
  // F of the block's items, part by part: lane i of warp w runs parts w,
  // w + SM_GAINS_WARPS, ... of item first + i
  if (lane < SM_GAINS_WARPS && first + lane < items) {
    const long long it = first + lane;
    const size_t q0 = (size_t)((it / n) * T + it % n);
    for (int r = w; r < SM_PARTS; r += SM_GAINS_WARPS)
      gains_F<S>(xq + q0 * rx, dts[it], p, sm + lane * GAINS_SMEM, r);
  }
  __syncthreads();
  if (item >= items) return;
  const size_t r1 = r0 + 1;
  gains_item<S, 32>(xp + r1 * rx, Pp + r1 * rp, xq + r1 * rx, Pq + r1 * rp, p,
                    C + item * rc, b ? b + item * D2 : nullptr,
                    V ? V + item * rc : nullptr, sm + w * GAINS_SMEM, lane);
}

template <typename S>
__global__ void refine_kernel(const S* __restrict__ xp,
                              const S* __restrict__ xq,
                              const S* __restrict__ C,
                              const S* __restrict__ e, int ne,
                              const S* __restrict__ p, S* A, S* b, int B,
                              int T, int norm) {
  extern __shared__ __align__(16) unsigned char smem_[];
  S* sm = reinterpret_cast<S*>(smem_);
  const long long n = T - 1, items = (long long)B * n;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long first = (long long)blockIdx.x * SM_GAINS_WARPS;
  if (lane < SM_GAINS_WARPS && first + lane < items) {
    const long long it = first + lane, l = it / n, k = it % n;
    const size_t r1 = (size_t)(l * T + k + 1);
    const S* eh = k + 1 < ne ? e + ((size_t)l * ne + k + 1) * D2 : nullptr;
    for (int r = w; r < SM_PARTS; r += SM_GAINS_WARPS)
      refine_taps<S>(xp + r1 * DX, xq + r1 * DX, eh, norm != 0, p,
                     sm + lane * REFINE_SMEM, r);
  }
  __syncthreads();
  const long long item = first + w;
  if (item >= items) return;
  const long long l = item / n, k = item % n;
  const S* eh = k + 1 < ne ? e + ((size_t)l * ne + k + 1) * D2 : nullptr;
  refine_item<S, false>(eh, C + item * (size_t)D2 * D2,
                        A + item * (size_t)D2 * D2, b + item * D2,
                        sm + w * REFINE_SMEM, lane, 32);
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

// the IO warp's copies of step k's inputs into stage g
template <typename S>
__device__ __forceinline__ void back_fill(S* g, const S* xp, const S* Pp,
                                          const S* xq, const S* Pq,
                                          const S* C, int k, int lane) {
  const size_t rx = DX, rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  copy_async<S>(g + Back<S>::C, C + k * rc, D2 * D2, lane);
  if (DE == D2) {
    copy_async<S>(g + Back<S>::PQ, Pp + (k + 1) * rp, D2 * D2, lane);
  } else {
    for (int i = 0; i < D2; ++i)
      copy_async<S>(g + Back<S>::PQ + i * D2, Pp + (k + 1) * rp + i * DE, D2,
                    lane);
  }
  copy_async<S>(g + Back<S>::P, Pq + k * rp, DE * DE, lane);
  copy_async<S>(g + Back<S>::XP, xp + (k + 1) * rx, DX, lane);
  copy_async<S>(g + Back<S>::XQ, xq + k * rx, DX, lane);
}

__device__ __forceinline__ void cov_barrier(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(32 * SM_COV_WARPS)
               : "memory");
}

template <typename S>
__global__ void __launch_bounds__(SM_BACK_THREADS)
    backward_kernel(const S* __restrict__ xp, const S* __restrict__ Pp,
                    const S* __restrict__ xq, const S* __restrict__ Pq,
                    const S* __restrict__ C, const S* __restrict__ p, S* xs,
                    S* Ps, int T, int norm, int ref_seed) {
  extern __shared__ __align__(16) unsigned char smem_[];
  using L = Back<S>;
  constexpr int NS = SM_BACK_STAGES;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_);
  unsigned long long* done = full + NS;
  S* sm = reinterpret_cast<S*>(smem_ + BACK_BAR_BYTES);
  const size_t l = blockIdx.x;
  const size_t rx = DX, rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  xp += l * T * rx;
  xq += l * T * rx;
  Pp += l * T * rp;
  Pq += l * T * rp;
  C += l * (size_t)(T > 1 ? T - 1 : 0) * rc;
  xs += l * T * rx;
  Ps += l * T * rp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const S* x0 = (ref_seed ? xp : xq) + (T - 1) * rx;
  const S* P0 = (ref_seed ? Pp : Pq) + (T - 1) * rp;
  if (threadIdx.x == 0)
    for (int s = 0; s < NS; ++s) {
      bar_init(full + s, 32);
      bar_init(done + s, 32 * (1 + SM_COV_WARPS));
    }
  if (warp == 0) {            // row T - 1: the seed
    for (int i = lane; i < DX; i += 32) xs[(T - 1) * rx + i] = x0[i];
    for (int q = lane; q < DE * DE; q += 32) Ps[(T - 1) * rp + q] = P0[q];
  } else if (warp == 1) {
    for (int i = lane; i < DX; i += 32) sm[L::XN + i] = x0[i];
  }
  __syncthreads();
  const int n = T - 1;
  constexpr bool RING = !(RN_SM_AID & 32);
  if (warp == 0) {            // the IO warp
    for (int s = 0; s < n && s < NS; ++s) {
      if (RING) back_fill<S>(sm + s * L::STAGE, xp, Pp, xq, Pq, C, n - 1 - s,
                             lane);
      if (RING) bar_arrive_copies(full + s); else bar_arrive(full + s);
    }
    for (int s = 0; s < n; ++s) {
      const int k = n - 1 - s, st = s % NS;
      S* g = sm + st * L::STAGE;
      bar_wait(done + st, (s / NS) & 1);
      rows_out<S, DX>(xs + k * rx, g + L::XS, lane);
      rows_out<S, DE * DE>(Ps + k * rp, g + L::P, lane);
      __syncwarp();
      if (s + NS < n) {
        if (RING) back_fill<S>(g, xp, Pp, xq, Pq, C, k - NS, lane);
        if (RING) bar_arrive_copies(full + st); else bar_arrive(full + st);
      }
    }
  } else if (warp == 1) {     // the state chain
    for (int s = 0; s < n; ++s) {
      const int k = n - 1 - s, st = s % NS;
      S* g = sm + st * L::STAGE;
      bar_wait(full + st, (s / NS) & 1);
#if !(RN_SM_AID & 8)
      back_state<S>(RING ? g + L::C : C + k * rc,
                    RING ? g + L::XP : xp + (k + 1) * rx,
                    RING ? g + L::XQ : xq + k * rx, g + L::XS, sm + L::XN,
                    sm + L::DXV, sm + L::DXM, norm != 0, p, lane, 32);
#endif
      bar_arrive(done + st);
    }
  } else {                    // the covariance chain
    const int tid = threadIdx.x - 64, nt = 32 * SM_COV_WARPS;
    // P_{k+1|k}'s main block of step s: in its stage, or (no ring) global
    auto pq = [&](int s) -> const S* {
      return RING ? sm + (s % NS) * L::STAGE + L::PQ : Pp + (n - s) * rp;
    };
    constexpr int ldq = RING ? D2 : DE;
    if (n > 0) {
      bar_wait(full, 0);
      back_seed_df<S>(P0, pq(0), ldq, sm + L::DF, tid, nt);
      cov_barrier(2);
    }
    for (int s = 0; s < n; ++s) {
      const int k = n - 1 - s, st = s % NS;
      S* g = sm + st * L::STAGE;
      bar_wait(full + st, (s / NS) & 1);
#if !(RN_SM_AID & 16)
      const S* Ck = RING ? g + L::C : C + k * rc;
      back_m1<S>(Ck, sm + L::DF, sm + L::M1, tid, nt);
      cov_barrier(1);
      if (s + 1 < n) bar_wait(full + (s + 1) % NS, ((s + 1) / NS) & 1);
      back_sym<S>(sm + L::M1, Ck, RING ? g + L::P : Pq + k * rp, g + L::P,
                  s + 1 < n ? pq(s + 1) : nullptr, ldq, sm + L::DF, tid, nt);
#endif
      bar_arrive(done + st);
#if !(RN_SM_AID & 16)
      cov_barrier(2);
#endif
    }
  }
}

// blocks of SM_WARPS items for n items
inline unsigned blocks_for(long long n) {
  return (unsigned)((n + SM_WARPS - 1) / SM_WARPS);
}

// blocks of SM_GAINS_WARPS items for n items
inline unsigned gains_blocks(long long n) {
  return (unsigned)((n + SM_GAINS_WARPS - 1) / SM_GAINS_WARPS);
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
  const size_t smem = sizeof(S) * SM_GAINS_WARPS * GAINS_SMEM;
  cudaError_t err = allow_smem(gains_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  gains_kernel<S><<<gains_blocks((long long)B * (T - 1)),
                    32 * SM_GAINS_WARPS, smem, st>>>(
      (const S*)xp, (const S*)Pp, (const S*)xq, (const S*)Pq, (const S*)dts,
      (const S*)p, (S*)C, (S*)b, (S*)V, B, T);
  return (int)cudaGetLastError();
}

template <typename S>
int refine_launch(const void* xp, const void* xq, const void* C,
                  const void* e, int ne, const void* p, void* A, void* b,
                  int B, int T, int norm, cudaStream_t st) {
  const size_t smem = sizeof(S) * SM_GAINS_WARPS * REFINE_SMEM;
  cudaError_t err = allow_smem(refine_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  refine_kernel<S><<<gains_blocks((long long)B * (T - 1)),
                     32 * SM_GAINS_WARPS, smem, st>>>(
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
  const size_t smem = back_smem<S>();
  cudaError_t err = allow_smem(backward_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  backward_kernel<S><<<B, SM_BACK_THREADS, smem, st>>>(
      (const S*)xp, (const S*)Pp, (const S*)xq, (const S*)Pq, (const S*)C,
      (const S*)p, (S*)xs, (S*)Ps, T, norm, ref_seed);
  return (int)cudaGetLastError();
}

template <typename K>
int kernel_info(K kernel, int threads, size_t smem, int d0, int d1, int d2,
                int d3, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int v[9] = {threads, (int)smem, blocks, attr.numRegs,
                    (int)attr.localSizeBytes, d0, d1, d2, d3};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

template <typename S>
int info(int which, int* out) {
  switch (which) {
    case 0:
      return kernel_info(gains_kernel<S>, 32 * SM_GAINS_WARPS,
                         sizeof(S) * SM_GAINS_WARPS * GAINS_SMEM,
                         SM_GAINS_WARPS, SM_TILE, SM_PARTS, LD, out);
    case 1:
      return kernel_info(refine_kernel<S>, 32 * SM_GAINS_WARPS,
                         sizeof(S) * SM_GAINS_WARPS * REFINE_SMEM,
                         SM_GAINS_WARPS, SM_TILE, SM_PARTS, LD, out);
    case 2:
      return kernel_info(backward_kernel<S>, SM_BACK_THREADS, back_smem<S>(),
                         SM_COV_WARPS, SM_BACK_STAGES, COV_T1, COV_T2, out);
    default:
      return kernel_info(inject_kernel<S>, 32 * SM_WARPS,
                         sizeof(S) * SM_WARPS * INJECT_SMEM, SM_WARPS, 0, 0,
                         0, out);
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

// out (9 ints): threads a block, dynamic shared bytes, blocks an SM
// holds, registers, local (stack) bytes of kernel `which` (0 gains, 1 its
// refine variant, 2 the backward pass, 3 the inject), then its design:
// kernel 11 items a block, tile, F's parts, row stride; kernel 12
// covariance warps, ring stages, M1's and M's tiles; kernel 14 rows a block
extern "C" int rn_smooth_info(int which, int is_double, int* out) {
  return is_double ? rn_sm::info<double>(which, out)
                   : rn_sm::info<float>(which, out);
}

#else  // the host build (tests): the same item functions, one thread each

namespace rn_sm {

template <typename S>
int gains_host(const S* xp, const S* Pp, const S* xq, const S* Pq,
               const S* dts, const S* p, S* C, S* b, S* V, int B, int T) {
  const long long n = T - 1;
  S* sm = (S*)malloc(sizeof(S) * GAINS_SMEM);
  const size_t rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  for (long long item = 0; item < (long long)B * n; ++item) {
    const size_t r0 = (size_t)((item / n) * T + item % n), r1 = r0 + 1;
    gains_load<S>(Pq + r0 * rp, Pp + r1 * rp, sm, 0, 1);
    for (int r = 0; r < SM_PARTS; ++r)
      gains_F<S>(xq + r0 * DX, dts[item], p, sm, r);
    gains_item<S, 1>(xp + r1 * DX, Pp + r1 * rp, xq + r1 * DX, Pq + r1 * rp,
                     p, C + item * rc, b ? b + item * D2 : nullptr,
                     V ? V + item * rc : nullptr, sm, 0);
  }
  free(sm);
  return 0;
}

template <typename S>
int refine_host(const S* xp, const S* xq, const S* C, const S* e, int ne,
                const S* p, S* A, S* b, int B, int T, int norm) {
  const long long n = T - 1;
  S* sm = (S*)malloc(sizeof(S) * REFINE_SMEM);
  for (long long item = 0; item < (long long)B * n; ++item) {
    const long long l = item / n, k = item % n;
    const size_t r1 = (size_t)(l * T + k + 1);
    const S* eh = k + 1 < ne ? e + ((size_t)l * ne + k + 1) * D2 : nullptr;
    for (int r = 0; r < SM_PARTS; ++r)
      refine_taps<S>(xp + r1 * DX, xq + r1 * DX, eh, norm != 0, p, sm, r);
    refine_item<S, false>(eh, C + item * (size_t)D2 * D2,
                          A + item * (size_t)D2 * D2, b + item * D2, sm, 0,
                          1);
  }
  free(sm);
  return 0;
}

// a lane's pass as the kernel's roles run a step, in order: the ring's
// stage as a plain copy (two stages, the next step's filled before the
// sym reads its P_{k|k-1}), the state chain, the covariance chain, the
// rows out of the stage
template <typename S>
int backward_host(const S* xp, const S* Pp, const S* xq, const S* Pq,
                  const S* C, const S* p, S* xs, S* Ps, int B, int T,
                  int norm, int ref_seed) {
  using L = Back<S>;
  S* sm = (S*)malloc(sizeof(S) * L::TOTAL);
  const size_t rx = DX, rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  for (size_t l = 0; l < (size_t)B; ++l) {
    const S* xpl = xp + l * T * rx;
    const S* xql = xq + l * T * rx;
    const S* Ppl = Pp + l * T * rp;
    const S* Pql = Pq + l * T * rp;
    const S* Cl = C + l * (size_t)(T > 1 ? T - 1 : 0) * rc;
    S* xsl = xs + l * T * rx;
    S* Psl = Ps + l * T * rp;
    const S* x0 = (ref_seed ? xpl : xql) + (T - 1) * rx;
    const S* P0 = (ref_seed ? Ppl : Pql) + (T - 1) * rp;
    for (int i = 0; i < DX; ++i) xsl[(T - 1) * rx + i] = sm[L::XN + i] = x0[i];
    for (int q = 0; q < DE * DE; ++q) Psl[(T - 1) * rp + q] = P0[q];
    const int n = T - 1;
    if (n > 0) {
      back_fill_plain<S>(sm, xpl, Ppl, xql, Pql, Cl, n - 1);
      back_seed_df<S>(P0, sm + L::PQ, D2, sm + L::DF, 0, 1);
    }
    for (int s = 0; s < n; ++s) {
      const int k = n - 1 - s;
      S* g = sm + (s % 2) * L::STAGE;
      S* g1 = sm + ((s + 1) % 2) * L::STAGE;
      back_state<S>(g + L::C, g + L::XP, g + L::XQ, g + L::XS, sm + L::XN,
                    sm + L::DXV, sm + L::DXM, norm != 0, p, 0, 1);
      back_m1<S>(g + L::C, sm + L::DF, sm + L::M1, 0, 1);
      if (s + 1 < n) back_fill_plain<S>(g1, xpl, Ppl, xql, Pql, Cl, k - 1);
      back_sym<S>(sm + L::M1, g + L::C, g + L::P, g + L::P,
                  s + 1 < n ? g1 + L::PQ : nullptr, D2, sm + L::DF, 0, 1);
      for (int i = 0; i < DX; ++i) xsl[k * rx + i] = g[L::XS + i];
      for (int q = 0; q < DE * DE; ++q) Psl[k * rp + q] = g[L::P + q];
    }
  }
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

#endif  // RN_SM_HELPERS_ONLY
