// Kernels 11', 12' and 14': the adjoint of the offline RTS smoother's
// kernels 11, 12 and 14 (csrc/smooth.cuh), around the spec's functions and
// their VJPs emitted per spec by rednose_tpu_torch/ops/adjoint.py (mode
// "smooth_adjoint", smooth_adjoint_source), which includes smooth.cuh's
// helpers and then this file. Kernel 13' (the suffix scan's adjoint) is
// csrc/affine_scan.cu's transposed, time-reversed form. Wrappers and plain
// versions: rednose_tpu_torch/ops/smooth_scan.py (smooth_gains_adjoint,
// smooth_backward_adjoint, smooth_inject_adjoint); the autograd rules that
// run them: rednose_tpu_torch/smoothing/rts.py.
//
// They replace jax.grad through the JAX package's jitted smoother
// (rednose_tpu/smoothing/rts.py:_jit_rts), XLA's transpose of:
//
//   kernel 11' (smooth_gains_adjoint): the gains C_k = (P_{k+1|k}^-1 F_k
//     P_{k|k}^T)^T (_smoother_gain, rts.py:49; the parallel form's gains,
//     :319-333) and, in the parallel form, the elements b_k = C_k u_{k+1},
//     V_k = C_k dP_{k+1} C_k^T (:335-342) with the suffix scan's share of
//     C_k's cotangent, lambda_k e_{k+1}^T + Lambda_k C_k (D_{k+1} +
//     D_{k+1}^T), lambda and Lambda from kernel 13'. It refactors P_{k+1|k}
//     (Cholesky, as kernel 11) and solves once more: with X = C^T, gY =
//     P_{k+1|k}^-1 gC^T, then gP_{k+1|k} = -gY C, gF = gY P_{k|k}, gP_{k|k}
//     = gY^T F, and gF goes through the spec's emitted F VJP (second
//     derivatives of f) to x_{k|k}, dt_k and the params; gu = C^T lambda
//     through the inv_err VJP to x_{k+1|k}, x_{k+1|k+1} and the params.
//   kernel 12' (smooth_backward_adjoint): the reverse lax.scan's body
//     (:95-121) run forward in time, k = 0 ... T-2, carrying the total
//     cotangents of x_s[k] and P_s[k] into step k + 1: with S = sym(G_k),
//     gP_{k|k} = S, gC_k = S_main C_k (Df + Df^T) (Df = P_s[k+1] -
//     P_{k+1|k} on the main block), G_{k+1} += pad(C_k^T S_main C_k) and
//     gP_{k+1|k} -= the same; the state through the emitted inject and
//     inv_err VJPs at the saved x_s[k+1] (dx = inv_err(x_{k+1|k},
//     x_s[k+1]) recomputed, as kernel 12 computed it), gC_k += gdx'
//     dx^T. Row T-1, the seed, passes its total to x_{T-1|T-1} /
//     P_{T-1|T-1} (x_{T-1|T-2} / P_{T-1|T-2} with reference_seed).
//   kernel 14' (smooth_inject_adjoint): the parallel form's inject and
//     covariance add (:358-364, :395-397): x_s = inject(x_{k|k}, [e_k, 0])
//     through the emitted inject VJP (gx_{k|k}, ge_k, the params), P_s =
//     sym(P_{k|k} + pad(D_k)): gP_{k|k} = sym(G), gD_k = sym(G)_main; the
//     rows past the elements copied, so their cotangents pass as they are.
//
// Layout as kernels 11-14's: x_pred, x_post, x_s (B, T, DX); P_pred,
// P_post, P_s (B, T, DE, DE); dts (B, T - 1); C, V, D and their cotangents
// (B, T - 1, D2, D2); b, e (B, T - 1, D2), every matrix row-major. An
// absent cotangent (nullptr) is 0. The covariance cotangents are full
// matrices of the entries each kernel reads (the Cholesky reads one
// triangle); the wrappers' callers symmetrize the totals. A share that two
// items would write (x_post_k from F and x_post_{k+1} from u) goes to an
// output of its own, summed by the wrapper; the params' cotangent goes out
// a (lane, step) share, NPP scalars each (NP, at least 1), summed by the
// wrapper in double.
//
// Design (12' and 11' as the RN_SMA_AID timing aids split them:
// PERF.md).
//
// Kernel 12' is a chain over k for each lane, and of each step's work
// only two chains carry a cotangent to the next step: the covariance
// chain CP_{k+1} = C_k^T sym(gP_s[k] + pad(CP_k))_main C_k (two dependent
// D2^3 products, the chain kernel 12 runs) and the state chain AX_{k+1}
// = A_k (gx_s[k] + AX_k), where A_k = J_b^T Cbar_k^T J_dx^T (DX x DX) is
// the step's linear map: the inject VJP's cotangent toward dx, C^T on the
// main block, the inv_err VJP's toward x_s[k+1]. Everything else depends
// on the inputs only, or is linear in the chains' values once known. So
// it runs as three kernels of one entry call (counted once):
//   the pass before, parallel over (lane, k) on every SM: A_k's columns,
//     the emitted VJPs pruned to the carried cotangents
//     (gen_sm_inject_vjp_dx_n*, gen_sm_inv_err_vjp_xb) at the unit seeds,
//     a lane a column, into the scratch;
//   the chain, a block a lane: an IO warp stages each step's C_k,
//     gP_s[k]'s main block, A_k and gx_s[k] BA_STAGES steps ahead in a
//     cp.async ring (a full and a done mbarrier a stage) and writes the
//     chains' values out of it; a state warp runs the state chain, one
//     matvec a step (a lane a row); BA_COV_WARPS covariance warps run the
//     covariance chain (W2 = C^T GM in tiles, then CP = W2 C by upper
//     tile pairs fused with the next step's sym, two named barriers a
//     step). The two chains meet only at the ring's barriers; no block
//     barrier a step, no global memory on either chain;
//   the pass after, parallel over (lane, k), a warp a row: the full
//     emitted VJPs at the now known x_s[k] totals (gx_{k|k}, gx_{k+1|k},
//     the params' share, gC's gdx' dx^T term), gC's (GM C)(Df + Df^T),
//     gP_{k|k}'s rows past the main block, the seed row's state.
// The state map as a DX x DX matvec, and not the pruned VJPs on the
// chain, because those are serial scalar code on one thread with their
// primal halves, while the matvec is DX multiply-adds on a warp.
// Kernel 11' is parallel over (lane, k), a warp an item: its matrices in
// the warp's slice of shared memory at the odd row stride LD, each
// product in smooth.cuh's mm_tiles register tiles over the lanes, the
// Cholesky and the solve with a lane's row (the factor) or column (the
// solve) in registers where D2 <= 32 (the same operations in the same
// order as smooth.cuh's loops over shared memory, which larger specs
// keep), F and F's VJP in SM_PARTS parts a warp for the block's items
// (lane i: item i), inv_err and its VJP (the parallel form) on an
// auxiliary warp beside the parts. 14' is a warp a row, the inject VJP on
// lane 0.
//
// Numerics: IEEE, no fast-math, float or double as the stacks are. 12''s
// covariance chain is kernel 12's order (each product entry one FMA chain
// in ascending k), so its values are the first design's bitwise; the
// state chain's matvec and 11''s sum of F's VJP parts part from it by
// rounding.

// Timing aids (outputs garbage; a #define ahead of this file sets them:
// sweep_warps.py --parts smooth_adjoint), bits: 12' without the state
// chain (1), without the covariance chain (2), without the emitted
// functions of its passes (4), without the pass after's products (8; with
// 1, 2, 4: loads and stores only); 11' without F's VJP (16), without the
// factor and solve (32), without its products (64), with smooth.cuh's
// factor and solve over shared memory on the card too (1024); 12' without
// the pass before (128), the chain (256), the pass after (512).
#ifndef RN_SMA_AID
#define RN_SMA_AID 0
#endif

namespace rn_sma {

using rn_gen::D1;
using rn_gen::D2;
using rn_gen::DE;
using rn_gen::DX;
using rn_gen::NP;
using rn_gen::SM_PARTS;
using rn_sm::LD;
using rn_sm::SM_TILE;
using rn_sm::pad16;

// params' scalars a share (one where the spec takes none)
constexpr int NPP = NP > 0 ? NP : 1;
// items (warps) a block of kernel 11', beside its auxiliary warp; rows
// (warps) a block of 14' and of 12''s pass after; items of its pass before
constexpr int GA_WARPS = 4;
constexpr int GA_THREADS = 32 * (GA_WARPS + 1);
constexpr int IA_WARPS = 4;
constexpr int POST_WARPS = 4;
constexpr int PRE_WARPS = 2;
// kernel 12''s chain block: an IO warp, a state warp and the covariance
// warps, whose chain is kernel 12's (its 8 warps, M1's 3 x 3 tiles for
// W2 and the least pair tiles that fit, as kernel 12's sweep chose:
// PERF.md); its ring's stages, fewer where they do not fit a block
constexpr int BA_COV_WARPS = 8;
constexpr int BA_THREADS = 32 * (2 + BA_COV_WARPS);
constexpr int BA_COV = 32 * BA_COV_WARPS;
constexpr int BA_T1 = 3;
constexpr int BA_T2 = rn_sm::tile_for(BA_COV, true);
constexpr int BA_STAGES = 4;
// a part of F's VJP: its gx, gdt and gp
constexpr int PART_VALS = DX + 1 + NPP;

template <typename S>
GEN_HD GEN_INLINE void inject_vjp(bool norm, const S* x, const S* dx,
                                  const S* p, const S* g, S* gx, S* gdx,
                                  S* gp) {
  if (norm) rn_gen::gen_sm_inject_vjp_n1<S>(x, dx, p, g, gx, gdx, gp);
  else rn_gen::gen_sm_inject_vjp_n0<S>(x, dx, p, g, gx, gdx, gp);
}

template <typename S>
GEN_HD GEN_INLINE void inject_vjp_dx(bool norm, const S* x, const S* dx,
                                     const S* p, const S* g, S* gdx) {
  if (norm) rn_gen::gen_sm_inject_vjp_dx_n1<S>(x, dx, p, g, gdx);
  else rn_gen::gen_sm_inject_vjp_dx_n0<S>(x, dx, p, g, gdx);
}

// ------------------------------------------------------------ kernel 11'
//
// An item's slice of shared memory, in scalars: nine D2 x D2 matrices at
// row stride LD, then vectors, then its F VJP's parts.
struct GA {
  static constexpr int L = 0;                // P_{k+1|k}, then its factor
  static constexpr int F = L + D2 * LD;      // F_k
  static constexpr int PK = F + D2 * LD;     // P_{k|k}
  static constexpr int CM = PK + D2 * LD;    // C_k
  static constexpr int G = CM + D2 * LD;     // C_k's total cotangent
  static constexpr int W1 = G + D2 * LD;
  static constexpr int W2 = W1 + D2 * LD;
  static constexpr int W3 = W2 + D2 * LD;    // Lambda_k, then gP_{k+1|k}
  static constexpr int W4 = W3 + D2 * LD;    // ..., then gF
  static constexpr int DIAG = W4 + D2 * LD;
  static constexpr int U = DIAG + D2;        // u (DE)
  static constexpr int GU = U + DE;          // [C^T lambda, 0] (DE)
  static constexpr int LAM = GU + DE;        // lambda_k
  static constexpr int EN = LAM + D2;        // e_{k+1}
  static constexpr int GP2 = EN + D2;        // inv_err VJP's params' share
  static constexpr int FV = GP2 + NPP;       // F VJP's parts (PART_VALS each)
  static constexpr int TOTAL = FV + SM_PARTS * PART_VALS;
};

// Kernel 11''s pointers: its inputs (the forward's stacks and gains, the
// cotangents) and its outputs (each (B, T - 1, ...) a share per item).
template <typename S>
struct GainsAdj {
  const S *xp, *Pp, *xq, *Pq, *dts, *p, *C;
  const S *gC, *lam, *Lam, *e, *D;   // gC optional; the rest: the
                                     // parallel form (lam null: gains only)
  S *gxq0, *gPq0, *gPp1, *gdts, *gp;
  S *gxp1, *gxq1, *gPq1;             // the parallel form's
};

// an item's loads (lane, k) = item: P_{k+1|k}, P_{k|k}, C_k, gC_k, and in
// the parallel form lambda_k, sym(Lambda_k) (into W3), e_{k+1} and Xs =
// dP + dP^T + D_{k+1} + D_{k+1}^T (into W1): V = C dP C^T and D_k's
// A D_{k+1} A^T are symmetric, so their shares of gC are 2 sym(Lambda) C
// dP and 2 sym(Lambda) C D_{k+1}, whatever Lambda's asymmetric part
template <typename S>
GEN_HD GEN_INLINE void ga_load(const GainsAdj<S>& a, long long item,
                               long long n, int T, S* sm, int tid, int nt) {
  const long long l = item / n, k = item % n;
  const size_t r0 = (size_t)(l * T + k), r1 = r0 + 1;
  const size_t rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  const S* Pp1 = a.Pp + r1 * rp;
  const S* Pq0 = a.Pq + r0 * rp;
  const S* Pq1 = a.Pq + r1 * rp;
  const S* Ck = a.C + item * rc;
  const S* gCk = a.gC ? a.gC + item * rc : nullptr;
  const bool par = a.lam != nullptr;
  const bool nxt = par && k + 1 < n;
  const S* Dn = nxt ? a.D + (item + 1) * rc : nullptr;
  const S* Lk = par ? a.Lam + item * rc : nullptr;
  for (int q = tid; q < D2 * D2; q += nt) {
    const int i = q / D2, j = q % D2, o = i * LD + j;
    sm[GA::L + o] = Pp1[i * DE + j];
    sm[GA::PK + o] = Pq0[i * DE + j];
    sm[GA::CM + o] = Ck[q];
    sm[GA::G + o] = gCk ? gCk[q] : (S)0;
    if (par) {   // Lambda read as symmetric: (L + L^T) / 2
      sm[GA::W3 + o] = (S)0.5 * (Lk[q] + Lk[j * D2 + i]);
      S x = (Pq1[i * DE + j] - Pp1[i * DE + j]) +
            (Pq1[j * DE + i] - Pp1[j * DE + i]);
      if (nxt) x += Dn[q] + Dn[j * D2 + i];
      sm[GA::W1 + o] = x;
    }
  }
  if (par)
    for (int i = tid; i < D2; i += nt) {
      sm[GA::LAM + i] = a.lam[item * D2 + i];
      sm[GA::EN + i] = nxt ? a.e[(item + 1) * D2 + i] : (S)0;
    }
}

// part r of an item's F (x_{k|k}, dt_k) into its slice
template <typename S>
GEN_HD GEN_INLINE void ga_F(const GainsAdj<S>& a, long long item,
                            long long n, int T, S* sm, int r) {
  const size_t r0 = (size_t)((item / n) * T + item % n);
  rn_gen::gen_sm_F_part<S>(a.xq + r0 * DX, a.dts[item], a.p, sm + GA::F, LD,
                           r);
}

// part r of an item's F VJP at gF (W4): its gx, gdt, gp into the slice
template <typename S>
GEN_HD GEN_INLINE void ga_F_vjp(const GainsAdj<S>& a, long long item,
                                long long n, int T, S* sm, int r) {
  const size_t r0 = (size_t)((item / n) * T + item % n);
  S* fv = sm + GA::FV + r * PART_VALS;
#if !(RN_SMA_AID & 16)
  rn_gen::gen_sm_F_vjp_part<S>(a.xq + r0 * DX, a.dts[item], a.p,
                               sm + GA::W4, LD, fv, fv + DX, fv + DX + 1, r);
#else
  (void)r0;
  (void)fv;
#endif
}

// the parallel form's u = inv_err(x_{k+1|k}, x_{k+1|k+1}) of an item
template <typename S>
GEN_HD GEN_INLINE void ga_err(const GainsAdj<S>& a, long long item,
                              long long n, int T, S* sm) {
  const size_t r1 = (size_t)((item / n) * T + item % n) + 1;
  rn_gen::gen_sm_inv_err<S>(a.xp + r1 * DX, a.xq + r1 * DX, a.p, sm + GA::U);
}

// its VJP at gu: the cotangents of x_{k+1|k}, x_{k+1|k+1} and the params
template <typename S>
GEN_HD GEN_INLINE void ga_err_vjp(const GainsAdj<S>& a, long long item,
                                  long long n, int T, S* sm) {
  const size_t r1 = (size_t)((item / n) * T + item % n) + 1;
  rn_gen::gen_sm_inv_err_vjp<S>(a.xp + r1 * DX, a.xq + r1 * DX, a.p,
                                sm + GA::GU, a.gxp1 + item * DX,
                                a.gxq1 + item * DX, sm + GA::GP2);
}

#ifdef __CUDA_ARCH__
// a compiler barrier: the loads after it are not hoisted above it (each
// row's loads stay with that row, not all of L in registers at once)
__device__ __forceinline__ void row_fence() { asm volatile("" ::: "memory"); }

// The Cholesky factor of a warp's A (D2 <= 32), smooth.cuh's cholesky
// operation for operation: lane i keeps row i in registers; column j's
// pivot comes from lane j by a shuffle, its entries go to shared memory
// for the columns after it.
template <typename S>
__device__ __forceinline__ void chol_lanes(S* A, S* diag, int lane) {
  S a[D2];
  SM_UNROLL
  for (int k = 0; k < D2; ++k) a[k] = lane < D2 ? A[lane * LD + k] : (S)0;
  SM_UNROLL
  for (int j = 0; j < D2; ++j) {
    row_fence();
    S s = a[j];
    SM_UNROLL
    for (int k = 0; k < j; ++k) s -= a[k] * A[j * LD + k];
    const S d = g_sqrt(__shfl_sync(0xffffffffu, s, j));
    if (lane == j) A[j * LD + j] = s;
    if (lane > j && lane < D2) {
      a[j] = s / d;
      A[lane * LD + j] = a[j];
    }
    if (lane == 0) diag[j] = d;
    __syncwarp();
  }
}

// X := (L L^T)^-1 X, smooth.cuh's cho_solve operation for operation, lane
// c's column of X in registers
template <typename S>
__device__ __forceinline__ void solve_lanes(const S* L, const S* diag, S* X,
                                            int lane) {
  if (lane >= D2) return;
  S x[D2];
  SM_UNROLL
  for (int i = 0; i < D2; ++i) x[i] = X[i * LD + lane];
  SM_UNROLL
  for (int i = 0; i < D2; ++i) {
    row_fence();
    S s = x[i];
    SM_UNROLL
    for (int k = 0; k < i; ++k) s -= L[i * LD + k] * x[k];
    x[i] = s / diag[i];
  }
  SM_UNROLL
  for (int i = D2 - 1; i >= 0; --i) {
    row_fence();
    S s = x[i];
    SM_UNROLL
    for (int k = i + 1; k < D2; ++k) s -= L[k * LD + i] * x[k];
    x[i] = s / diag[i];
  }
  row_fence();
  SM_UNROLL
  for (int i = 0; i < D2; ++i) X[i * LD + lane] = x[i];
}
#endif

// X := P^-1 X by P's Cholesky factor, in place in P (syncs first): in
// registers on a warp where D2 <= 32, else smooth.cuh's loops
template <typename S, int NL>
GEN_HD GEN_INLINE void factor_solve(S* P, S* diag, S* X, int tid) {
#if defined(__CUDA_ARCH__) && !(RN_SMA_AID & 1024)
  if constexpr (NL == 32 && D2 <= 32) {
    chol_lanes<S>(P, diag, tid);
    solve_lanes<S>(P, diag, X, tid);
    return;
  }
#endif
  rn_sm::cholesky<S, NL>(P, diag, tid);
  rn_sm::cho_solve<S, NL>(P, diag, X, tid);
}

// a product of 11' (an aid leaves them out)
template <typename S>
GEN_HD GEN_INLINE void ga_mm(const S* A, int ai, int ak, const S* B, int bk,
                             int bj, S* O, int tid, int nt) {
#if !(RN_SMA_AID & 64)
  rn_sm::mm_tiles<S, SM_TILE>(A, ai, ak, B, bk, bj, O, LD, 1, tid, nt);
#endif
}

// The rest of an item, its loads, F and (the parallel form) u in its
// slice, on NL threads (tid: this one's), up to gF (W4) and the stores of
// gP_{k|k}, gP_{k+1|k} and (the parallel form) gP_{k+1|k+1}; gu (GU) for
// the inv_err VJP.
template <typename S, int NL>
GEN_HD void ga_item(const GainsAdj<S>& a, long long item, S* sm, int tid) {
  constexpr int nt = NL;
  const size_t rc = (size_t)D2 * D2;
  S* L = sm + GA::L;
  S* F = sm + GA::F;
  S* PK = sm + GA::PK;
  S* CM = sm + GA::CM;
  S* G = sm + GA::G;
  S* W1 = sm + GA::W1;
  S* W2 = sm + GA::W2;
  S* W3 = sm + GA::W3;
  S* W4 = sm + GA::W4;
  const bool par = a.lam != nullptr;
  rn_sm::sync_<false>();
  if (par) {
    // the elements' and the scan's shares of gC, and gdP = C^T Lambda C
    ga_mm<S>(W3, LD, 1, CM, LD, 1, W2, tid, nt);
    rn_sm::sync_<false>();                       // W2 = Lambda C
    ga_mm<S>(W2, LD, 1, W1, LD, 1, W4, tid, nt);
    for (int i = tid; i < D2; i += nt) {         // gu = C^T lambda
      S s = 0;
      for (int q = 0; q < D2; ++q) s += CM[q * LD + i] * sm[GA::LAM + q];
      sm[GA::GU + i] = s;
    }
    for (int i = D2 + tid; i < DE; i += nt) sm[GA::GU + i] = 0;
    rn_sm::sync_<false>();                       // W4 = Lambda C Xs; gu
    for (int q = tid; q < D2 * D2; q += nt) {
      const int i = q / D2, j = q % D2;
      G[i * LD + j] += sm[GA::LAM + i] * (sm[GA::U + j] + sm[GA::EN + j]) +
                       W4[i * LD + j];
    }
    ga_mm<S>(CM, 1, LD, W2, LD, 1, W1, tid, nt);
    rn_sm::sync_<false>();                       // W1 = gdP = C^T Lambda C
    for (int q = tid; q < D2 * D2; q += nt) {
      const int i = q / D2, j = q % D2;
      a.gPq1[item * rc + q] = W1[i * LD + j];
      W3[i * LD + j] = -W1[i * LD + j];
    }
  } else {
    for (int q = tid; q < D2 * D2; q += nt) W3[(q / D2) * LD + q % D2] = 0;
  }
  rn_sm::sync_<false>();
  // gX = gC^T, then gY = P_{k+1|k}^-1 gX by the factor of P_{k+1|k}
  for (int q = tid; q < D2 * D2; q += nt) {
    const int i = q / D2, j = q % D2;
    W1[i * LD + j] = G[j * LD + i];
  }
#if !(RN_SMA_AID & 32)
  factor_solve<S, NL>(L, sm + GA::DIAG, W1, tid);
#endif
  rn_sm::sync_<false>();                           // W1 = gY
  ga_mm<S>(W1, LD, 1, CM, LD, 1, W2, tid, nt);
  ga_mm<S>(W1, LD, 1, PK, LD, 1, W4, tid, nt);
  rn_sm::sync_<false>();                           // W2 = gY C, W4 = gF
  for (int q = tid; q < D2 * D2; q += nt) {
    const int i = q / D2, j = q % D2;
    a.gPp1[item * rc + q] = W3[i * LD + j] - W2[i * LD + j];
  }
  rn_sm::sync_<false>();
  ga_mm<S>(W1, 1, LD, F, LD, 1, W2, tid, nt);
  rn_sm::sync_<false>();                           // W2 = gY^T F
  for (int q = tid; q < D2 * D2; q += nt)
    a.gPq0[item * rc + q] = W2[(q / D2) * LD + q % D2];
}

// An item's outputs from its F VJP's parts (summed in part order) and,
// in the parallel form, the inv_err VJP's params' share.
template <typename S>
GEN_HD GEN_INLINE void ga_sum(const GainsAdj<S>& a, long long item,
                              const S* sm, int tid, int nt) {
  const S* fv = sm + GA::FV;
  for (int i = tid; i < PART_VALS; i += nt) {
    S s = fv[i];
    for (int r = 1; r < SM_PARTS; ++r) s += fv[r * PART_VALS + i];
    if (i < DX) {
      a.gxq0[item * DX + i] = s;
    } else if (i == DX) {
      a.gdts[item] = s;
    } else {
      const int j = i - DX - 1;
      a.gp[item * NPP + j] =
          j < NP ? s + (a.lam != nullptr ? sm[GA::GP2 + j] : (S)0) : (S)0;
    }
  }
}

// ------------------------------------------------------------ kernel 14'

constexpr int IA_SMEM = 2 * DE + NPP;

// One row (lane, k) of B x T: k < n injected (e, D given), else copied.
template <typename S>
GEN_HD void ia_item(const S* xq, const S* e, const S* gxs, const S* gPs,
                    bool norm, const S* p, S* gxq, S* gPq, S* ge, S* gD,
                    S* gp, S* sm, int tid, int nt) {
  if (e == nullptr) {
    for (int i = tid; i < DX; i += nt) gxq[i] = gxs ? gxs[i] : (S)0;
    for (int q = tid; q < DE * DE; q += nt) gPq[q] = gPs ? gPs[q] : (S)0;
    for (int j = tid; j < NPP; j += nt) gp[j] = 0;
    return;
  }
  if (tid == 0) {
    S* dx = sm;
    S* gdx = sm + DE;
    S* gpp = sm + 2 * DE;
    for (int i = 0; i < DE; ++i) dx[i] = i < D2 ? e[i] : (S)0;
    if (gxs != nullptr) {
      inject_vjp<S>(norm, xq, dx, p, gxs, gxq, gdx, gpp);
    } else {
      for (int i = 0; i < DX; ++i) gxq[i] = 0;
      for (int i = 0; i < DE; ++i) gdx[i] = 0;
      for (int j = 0; j < NPP; ++j) gpp[j] = 0;
    }
    for (int i = 0; i < D2; ++i) ge[i] = gdx[i];
    for (int j = 0; j < NPP; ++j) gp[j] = j < NP ? gpp[j] : (S)0;
  }
  for (int q = tid; q < DE * DE; q += nt) {
    const int i = q / DE, j = q % DE;
    const S s = gPs ? (S)0.5 * (gPs[q] + gPs[j * DE + i]) : (S)0;
    gPq[q] = s;
    if (i < D2 && j < D2) gD[i * D2 + j] = s;
  }
}

// ------------------------------------------------------------ kernel 12'

// A_k's scalars in the scratch and in a stage: DX x DX, padded to 16 bytes
template <typename S>
GEN_HD constexpr int at_size() {
  return pad16<S>(DX * DX);
}

// the scratch of a call (scalars): A_k^T of every (lane, k < T - 1), then
// every row's x_s total (B, T, DX)
template <typename S>
GEN_HD GEN_INLINE long long work_scalars(int B, int T) {
  return (long long)B * (T > 1 ? T - 1 : 0) * at_size<S>() +
         (long long)B * T * DX;
}

// Kernel 12''s pointers: the forward's stacks and outputs (xs, Ps), its
// gains, the cotangents of xs, Ps (either may be null) and the outputs,
// zeroed by the wrapper (the kernels write only what they compute): gxp,
// gPp, gxq, gPq (B, T, ...), gC (B, T - 1, D2, D2), gp (B, T - 1, NPP);
// the scratch: at (A_k^T, at_size a step), go (x_s[k]'s totals).
template <typename S>
struct BackAdj {
  const S *xp, *Pp, *xq, *Pq, *C, *p, *xs, *Ps, *gxs, *gPs;
  S *gxp, *gPp, *gxq, *gPq, *gC, *gp, *at, *go;
};

// a lane's pointers (lane l of B x T)
template <typename S>
GEN_HD GEN_INLINE BackAdj<S> ba_lane(BackAdj<S> a, size_t l, int T) {
  const size_t rx = DX, rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  const size_t n = T > 1 ? T - 1 : 0;
  a.xp += l * T * rx;
  a.xq += l * T * rx;
  a.xs += l * T * rx;
  a.Pp += l * T * rp;
  a.Pq += l * T * rp;
  a.Ps += l * T * rp;
  a.C += l * n * rc;
  if (a.gxs) a.gxs += l * T * rx;
  if (a.gPs) a.gPs += l * T * rp;
  a.gxp += l * T * rx;
  a.gxq += l * T * rx;
  a.gPp += l * T * rp;
  a.gPq += l * T * rp;
  a.gC += l * n * rc;
  a.gp += l * n * NPP;
  a.at += l * n * at_size<S>();
  a.go += l * T * rx;
  return a;
}

// the pass before's shared memory a warp: dx, dx' = [C dx, dx[D2:]], then
// a lane's seed (DX), gdx' and gdx2 (DE each)
struct PRE {
  static constexpr int DXV = 0;
  static constexpr int DXP = DE;
  static constexpr int LANE = 2 * DE;
  static constexpr int LANE_SIZE = DX + 2 * DE;
  static constexpr int TOTAL = LANE + 32 * LANE_SIZE;
};

// The pass before, step k of a lane on NL threads: A_k's columns c (a
// thread's c, c + NL, ...): x_s[k]'s unit cotangent e_c through the inject
// VJP toward dx', C^T on the main block, the inv_err VJP toward x_s[k+1],
// stored as row c of A_k^T.
template <typename S, int NL>
GEN_HD void ba_pre(const BackAdj<S>& a, int k, bool norm, S* sm, int lane) {
  const S* Ck = a.C + (size_t)k * D2 * D2;
  const S* xp1 = a.xp + (size_t)(k + 1) * DX;
  const S* xs1 = a.xs + (size_t)(k + 1) * DX;
  S* dx = sm + PRE::DXV;
  S* dxp = sm + PRE::DXP;
#if !(RN_SMA_AID & 4)
  if (lane == 0) rn_gen::gen_sm_inv_err<S>(xp1, xs1, a.p, dx);
#endif
  rn_sm::sync_<false>();
  for (int i = lane; i < DE; i += NL) {
    S s = dx[i];
    if (i < D2) {
      s = 0;
      for (int j = 0; j < D2; ++j) s += Ck[i * D2 + j] * dx[j];
    }
    dxp[i] = s;
  }
  rn_sm::sync_<false>();
  S* g = sm + PRE::LANE + lane * PRE::LANE_SIZE;
  S* gdx = g + DX;
  S* gdx2 = gdx + DE;
  for (int c = lane; c < DX; c += NL) {
    for (int i = 0; i < DX; ++i) g[i] = i == c ? (S)1 : (S)0;
#if !(RN_SMA_AID & 4)
    inject_vjp_dx<S>(norm, a.xq + (size_t)k * DX, dxp, a.p, g, gdx);
#endif
    for (int i = 0; i < DE; ++i) {
      S s = gdx[i];
      if (i < D2) {
        s = 0;
        for (int j = 0; j < D2; ++j) s += Ck[j * D2 + i] * gdx[j];
      }
      gdx2[i] = s;
    }
#if !(RN_SMA_AID & 4)
    rn_gen::gen_sm_inv_err_vjp_xb<S>(xp1, xs1, a.p, gdx2,
                                     a.at + (size_t)k * at_size<S>() + c * DX);
#endif
  }
}

// The state chain's step on NL threads (a thread's rows lane, lane + NL,
// ...): go := x_s[k]'s total (gx_s[k], in go where has_gx, + ax), then ax
// := A_k go, A_k^T's row j at At + j * DX.
template <typename S, int NL>
GEN_HD GEN_INLINE void ba_state(S* go, const S* At, S* ax, bool has_gx,
                                int lane) {
  constexpr int XR = (DX + NL - 1) / NL;
  SM_UNROLL
  for (int r = 0; r < XR; ++r) {
    const int i = lane + NL * r;
    if (i < DX) go[i] = (has_gx ? go[i] : (S)0) + ax[r];
  }
  rn_sm::sync_<false>();
  SM_UNROLL
  for (int r = 0; r < XR; ++r) {
    const int i = lane + NL * r;
    if (i >= DX) continue;
    S v = 0;
    SM_UNROLL
    for (int j = 0; j < DX; ++j) v += At[j * DX + i] * go[j];
    ax[r] = v;
  }
}

// GM_0 = sym(gP_s[0]'s main block) in place in G (0 without gP_s), a
// thread a pair (i <= j)
template <typename S>
GEN_HD GEN_INLINE void ba_gm0(S* G, bool has_gP, int tid, int nt) {
  for (int q = tid; q < D2 * D2; q += nt) {
    const int i = q / D2, j = q % D2;
    if (j < i) continue;
    const S v = has_gP ? (S)0.5 * (G[i * D2 + j] + G[j * D2 + i]) : (S)0;
    G[i * D2 + j] = v;
    G[j * D2 + i] = v;
  }
}

// The covariance chain's second product, CP = W2 C_k by upper pairs of
// BA_T2 x BA_T2 tiles (a tile and its mirror on one thread), fused with
// the stores -CP into ncp and, with the next step's stage given (Gn: its
// gP_s main block, or garbage without gP_s), GM_{k+1} = sym(gP_s[k+1] +
// CP) in place there. Each entry one FMA chain in ascending l, as the
// first design's products.
template <typename S>
GEN_HD GEN_INLINE void ba_cp(const S* W2, const S* Ck, S* ncp, S* Gn,
                             bool has_gP, int tid, int nt) {
  constexpr int TT = BA_T2, G = (D2 + TT - 1) / TT;
  for (int t = tid; t < G * (G + 1) / 2; t += nt) {
    int I = 0, r = t;
    while (r >= G - I) r -= G - I++;
    const int J = I + r;
    int ri[TT], rj[TT], ci[TT], cj[TT];
    S m[TT][TT], mt[TT][TT];   // CP(i, j), CP(j, i) over the tile's (i, j)
    for (int u = 0; u < TT; ++u) {
      ci[u] = rn_sm::min_(I * TT + u, D2 - 1);
      cj[u] = rn_sm::min_(J * TT + u, D2 - 1);
      ri[u] = ci[u] * D2;
      rj[u] = cj[u] * D2;
      for (int v = 0; v < TT; ++v) m[u][v] = mt[u][v] = 0;
    }
    SM_UNROLL
    for (int l = 0; l < D2; ++l) {
      S wi[TT], cv[TT], wj[TT], cu[TT];
      for (int u = 0; u < TT; ++u) {
        wi[u] = W2[ri[u] + l];
        cv[u] = Ck[l * D2 + cj[u]];
      }
      for (int u = 0; u < TT; ++u)
        for (int v = 0; v < TT; ++v) m[u][v] += wi[u] * cv[v];
      if (I < J) {
        for (int u = 0; u < TT; ++u) {
          wj[u] = W2[rj[u] + l];
          cu[u] = Ck[l * D2 + ci[u]];
        }
        for (int u = 0; u < TT; ++u)
          for (int v = 0; v < TT; ++v) mt[u][v] += wj[v] * cu[u];
      }
    }
    for (int u = 0; u < TT; ++u)
      for (int v = 0; v < TT; ++v) {
        const int i = I * TT + u, j = J * TT + v;
        if (i >= D2 || j >= D2 || (I == J && u > v)) continue;
        const S pij = m[u][v], pji = I < J ? mt[u][v] : m[v][u];
        ncp[i * D2 + j] = -pij;
        ncp[j * D2 + i] = -pji;
        if (Gn != nullptr) {
          const S x = (has_gP ? Gn[i * D2 + j] : (S)0) + pij;
          const S y = (has_gP ? Gn[j * D2 + i] : (S)0) + pji;
          const S s = (S)0.5 * (x + y);
          Gn[i * D2 + j] = s;
          Gn[j * D2 + i] = s;
        }
      }
  }
}

// row T - 1's covariance, the seed (all threads, after the chain): its
// total gP_s[T-1] + pad(CP_{T-1}) (CP = -ncp, 0 without steps) added to
// P_post[T-1]'s cotangent (P_pred[T-1]'s with reference_seed)
template <typename S>
GEN_HD GEN_INLINE void ba_seed(const BackAdj<S>& a, int T, bool ref_seed,
                               const S* ncp, int tid, int nt) {
  const size_t rp = (size_t)DE * DE;
  const int k = T - 1;
  S* gP = ref_seed ? a.gPp : a.gPq;
  for (int q = tid; q < DE * DE; q += nt) {
    const int i = q / DE, j = q % DE;
    gP[k * rp + q] += (a.gPs ? a.gPs[k * rp + q] : (S)0) +
                      (i < D2 && j < D2 && ncp ? -ncp[i * D2 + j] : (S)0);
  }
}

// the pass after's shared memory a warp, in scalars: four D2 x D2 matrices
// at row stride LD, then vectors
struct PO {
  static constexpr int GM = 0;               // sym(G_k)'s main block, then gC
  static constexpr int CM = GM + D2 * LD;    // C_k
  static constexpr int DF = CM + D2 * LD;    // Df + Df^T
  static constexpr int W1 = DF + D2 * LD;    // GM C
  static constexpr int DXV = W1 + D2 * LD;   // dx (DE)
  static constexpr int DXP = DXV + DE;       // dx' (DE)
  static constexpr int GDX = DXP + DE;       // dx''s cotangent (DE)
  static constexpr int GDX2 = GDX + DE;      // dx's (DE)
  static constexpr int GXB = GDX2 + DE;      // (x_s[k+1]'s, unused: DX)
  static constexpr int GP1 = GXB + DX;
  static constexpr int GP2 = GP1 + NPP;
  static constexpr int TOTAL = GP2 + NPP;
};

// The pass after, row k of a lane on NL threads (the emitted functions on
// tid 0), x_s[k]'s total in go (the chain's): k < T - 1 the step's VJPs
// (gx_{k|k}, gx_{k+1|k}, the params' share), gC_k = (GM C)(Df + Df^T) +
// gdx'[:D2] dx[:D2]^T, gP_{k|k}'s rows past the main block; k = T - 1 the
// seed's state (x_post[T-1]'s, or x_pred[T-1]'s with reference_seed, which
// the step before adds where there is one).
template <typename S, int NL>
GEN_HD void ba_post(const BackAdj<S>& a, int k, int T, bool norm,
                    bool ref_seed, S* sm, int tid) {
  constexpr int nt = NL;
  const size_t rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  const int n = T - 1;
  const S* go = a.go + (size_t)k * DX;
  if (k == n) {
    if (!ref_seed)
      for (int i = tid; i < DX; i += nt) a.gxq[(size_t)k * DX + i] += go[i];
    else if (n == 0)
      for (int i = tid; i < DX; i += nt) a.gxp[i] += go[i];
    return;
  }
  const S* Ck = a.C + k * rc;
  const S* P1 = a.Ps + (k + 1) * rp;
  const S* Pp1 = a.Pp + (k + 1) * rp;
  const S* xp1 = a.xp + (size_t)(k + 1) * DX;
  const S* xs1 = a.xs + (size_t)(k + 1) * DX;
  S* GM = sm + PO::GM;
  S* CM = sm + PO::CM;
  S* DF = sm + PO::DF;
  S* W1 = sm + PO::W1;
  S* dx = sm + PO::DXV;
  S* dxp = sm + PO::DXP;
  S* gdx = sm + PO::GDX;
  S* gdx2 = sm + PO::GDX2;
  for (int q = tid; q < DE * DE; q += nt) {
    const int i = q / DE, j = q % DE;
    if (i < D2 && j < D2) {
      const int o = i * LD + j;
      GM[o] = a.gPq[k * rp + q];
      CM[o] = Ck[i * D2 + j];
      DF[o] = (P1[i * DE + j] - Pp1[i * DE + j]) +
              (P1[j * DE + i] - Pp1[j * DE + i]);
    } else {   // gP_{k|k} = sym(G_k) past the main block
      const S* gP = a.gPs ? a.gPs + k * rp : nullptr;
      a.gPq[k * rp + q] =
          gP ? (S)0.5 * (gP[q] + gP[j * DE + i]) : (S)0;
    }
  }
#if !(RN_SMA_AID & 4)
  if (tid == 0) rn_gen::gen_sm_inv_err<S>(xp1, xs1, a.p, dx);
#endif
  rn_sm::sync_<false>();
  for (int i = tid; i < DE; i += nt) {
    S s = dx[i];
    if (i < D2) {
      s = 0;
      for (int j = 0; j < D2; ++j) s += CM[i * LD + j] * dx[j];
    }
    dxp[i] = s;
  }
#if !(RN_SMA_AID & 8)
  rn_sm::mm_tiles<S, SM_TILE>(GM, LD, 1, CM, LD, 1, W1, LD, 1, tid, nt);
#endif
  rn_sm::sync_<false>();                           // dx', W1 = GM C
#if !(RN_SMA_AID & 4)
  if (tid == 0)
    inject_vjp<S>(norm, a.xq + (size_t)k * DX, dxp, a.p, go,
                  a.gxq + (size_t)k * DX, gdx, sm + PO::GP1);
#endif
#if !(RN_SMA_AID & 8)
  rn_sm::mm_tiles<S, SM_TILE>(W1, LD, 1, DF, LD, 1, GM, LD, 1, tid, nt);
#endif
  rn_sm::sync_<false>();                           // gdx', GM = W1 Df
  for (int i = tid; i < DE; i += nt) {
    S s = gdx[i];
    if (i < D2) {
      s = 0;
      for (int j = 0; j < D2; ++j) s += CM[j * LD + i] * gdx[j];
    }
    gdx2[i] = s;
  }
  for (int q = tid; q < D2 * D2; q += nt) {
    const int i = q / D2, j = q % D2;
    a.gC[k * rc + q] = GM[i * LD + j] + gdx[i] * dx[j];
  }
  rn_sm::sync_<false>();
  if (tid != 0) return;
#if !(RN_SMA_AID & 4)
  rn_gen::gen_sm_inv_err_vjp<S>(xp1, xs1, a.p, gdx2,
                                a.gxp + (size_t)(k + 1) * DX, sm + PO::GXB,
                                sm + PO::GP2);
#endif
  if (ref_seed && k + 1 == n)   // the seed's state, after the step's share
    for (int i = 0; i < DX; ++i) a.gxp[(size_t)n * DX + i] += a.go[n * DX + i];
  for (int j = 0; j < NPP; ++j)
    a.gp[(size_t)k * NPP + j] =
        j < NP ? sm[PO::GP1 + j] + sm[PO::GP2 + j] : (S)0;
}

}  // namespace rn_sma

// the C entries' arguments and their structs
#define RN_SMA_GAINS_ARGS                                                    \
  const void *xp, const void *Pp, const void *xq, const void *Pq,            \
      const void *dts, const void *p, const void *C, const void *gC,         \
      const void *lam, const void *Lam, const void *e, const void *D,        \
      void *gxq0, void *gPq0, void *gPp1, void *gdts, void *gp, void *gxp1,  \
      void *gxq1, void *gPq1, int B, int T
#define RN_SMA_GAINS_INIT(S)                                                 \
  rn_sma::GainsAdj<S>{(const S*)xp,   (const S*)Pp,  (const S*)xq,           \
                      (const S*)Pq,   (const S*)dts, (const S*)p,            \
                      (const S*)C,    (const S*)gC,  (const S*)lam,          \
                      (const S*)Lam,  (const S*)e,   (const S*)D,            \
                      (S*)gxq0,       (S*)gPq0,      (S*)gPp1,               \
                      (S*)gdts,       (S*)gp,        (S*)gxp1,               \
                      (S*)gxq1,       (S*)gPq1}
#define RN_SMA_BACK_ARGS                                                     \
  const void *xp, const void *Pp, const void *xq, const void *Pq,            \
      const void *C, const void *p, const void *xs, const void *Ps,          \
      const void *gxs, const void *gPs, void *gxp, void *gPp, void *gxq,     \
      void *gPq, void *gC, void *gp, void *work, int B, int T, int norm,     \
      int ref_seed
// the scratch's two parts: A_k^T of every (lane, k), then the x_s totals
#define RN_SMA_BACK_INIT(S)                                                  \
  rn_sma::BackAdj<S>{(const S*)xp,  (const S*)Pp,  (const S*)xq,             \
                     (const S*)Pq,  (const S*)C,   (const S*)p,              \
                     (const S*)xs,  (const S*)Ps,  (const S*)gxs,            \
                     (const S*)gPs, (S*)gxp,       (S*)gPp,                  \
                     (S*)gxq,       (S*)gPq,       (S*)gC,                   \
                     (S*)gp,        (S*)work,                                \
                     (S*)work + (size_t)B * (T > 1 ? T - 1 : 0) *            \
                                    rn_sma::at_size<S>()}

// the scalars of kernel 12''s scratch for B lanes of T steps (into *out)
extern "C" int rn_smooth_backward_adjoint_work(int B, int T, int is_double,
                                               long long* out) {
  *out = is_double ? rn_sma::work_scalars<double>(B, T)
                   : rn_sma::work_scalars<float>(B, T);
  return 0;
}

#ifdef __CUDACC__

namespace rn_sma {

// ------------------------------------------------- kernel 12''s chain ring
//
// A stage, in scalars: C_k, gP_s[k]'s main block (then GM_k, in place),
// -CP_{k+1}, gx_s[k] (then x_s[k]'s total, in place), A_k^T (the state
// map, where two stages of it fit a block; else the state warp reads it
// from the scratch). Then W2.
constexpr int BA_BAR_BYTES = (2 * BA_STAGES * 8 + 15) / 16 * 16;
constexpr size_t BA_SMEM_MAX = 232448;   // 227 KB, a block's most

template <typename S>
constexpr bool ba_fits(int stages, int stage) {
  return BA_BAR_BYTES + sizeof(S) * ((size_t)stages * stage + D2 * D2) <=
         BA_SMEM_MAX;
}

template <typename S>
constexpr int ba_stages(int stage) {
  int ns = BA_STAGES;
  while (ns > 2 && !ba_fits<S>(ns, stage)) --ns;
  return ns;
}

template <typename S>
struct Ring {
  static constexpr int C = 0;
  static constexpr int G = C + pad16<S>(D2 * D2);
  static constexpr int NCP = G + pad16<S>(D2 * D2);
  static constexpr int GO = NCP + pad16<S>(D2 * D2);
  static constexpr int AT = GO + pad16<S>(DX);
  static constexpr bool AT_RING = ba_fits<S>(2, AT + at_size<S>());
  static constexpr int STAGE = AT + (AT_RING ? at_size<S>() : 0);
  static constexpr int NS = ba_stages<S>(STAGE);
  static constexpr int W2 = NS * STAGE;
  static constexpr int TOTAL = W2 + D2 * D2;
};

template <typename S>
constexpr size_t ba_smem() {
  return BA_BAR_BYTES + sizeof(S) * Ring<S>::TOTAL;
}

// the IO warp's copies of step k's inputs into stage g
template <typename S>
__device__ __forceinline__ void ba_fill(const BackAdj<S>& a, S* g, int k,
                                        int lane) {
  using R = Ring<S>;
  const size_t rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  rn_sm::copy_async<S>(g + R::C, a.C + k * rc, D2 * D2, lane);
  if (a.gPs != nullptr) {
    if (DE == D2)
      rn_sm::copy_async<S>(g + R::G, a.gPs + k * rp, D2 * D2, lane);
    else
      for (int i = 0; i < D2; ++i)
        rn_sm::copy_async<S>(g + R::G + i * D2, a.gPs + k * rp + i * DE, D2,
                             lane);
  }
  if (R::AT_RING)
    rn_sm::copy_async<S>(g + R::AT, a.at + (size_t)k * at_size<S>(),
                         at_size<S>(), lane);
  if (a.gxs != nullptr)
    rn_sm::copy_async<S>(g + R::GO, a.gxs + (size_t)k * DX, DX, lane);
}

// the IO warp's stores of step k out of stage g: gP_{k|k}'s and
// gP_{k+1|k}'s main blocks, x_s[k]'s total
template <typename S>
__device__ __forceinline__ void ba_rows(const BackAdj<S>& a, const S* g,
                                        int k, int lane) {
  using R = Ring<S>;
  const size_t rp = (size_t)DE * DE;
  if (DE == D2) {
    rn_sm::rows_out<S, D2 * D2>(a.gPq + k * rp, g + R::G, lane);
    rn_sm::rows_out<S, D2 * D2>(a.gPp + (k + 1) * rp, g + R::NCP, lane);
  } else {
    for (int i = 0; i < D2; ++i) {
      rn_sm::rows_out<S, D2>(a.gPq + k * rp + i * DE, g + R::G + i * D2,
                             lane);
      rn_sm::rows_out<S, D2>(a.gPp + (k + 1) * rp + i * DE,
                             g + R::NCP + i * D2, lane);
    }
  }
  rn_sm::rows_out<S, DX>(a.go + (size_t)k * DX, g + R::GO, lane);
}

// the covariance warps' barrier (the IO and state warps are not in it)
__device__ __forceinline__ void cov_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(BA_COV) : "memory");
}

template <typename S>
__global__ void __launch_bounds__(GA_THREADS)
    gains_adjoint_kernel(GainsAdj<S> a, int B, int T) {
  extern __shared__ __align__(16) unsigned char smem_[];
  S* sm = reinterpret_cast<S*>(smem_);
  const long long n = T - 1, items = (long long)B * n;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long first = (long long)blockIdx.x * GA_WARPS;
  const long long item = first + w;
  const bool mine = w < GA_WARPS && item < items;
  const bool par = a.lam != nullptr;
  // lane i of warp w < GA_WARPS runs parts w, w + GA_WARPS, ... of item
  // first + i's F (then of its F's VJP); lane i of the auxiliary warp its
  // inv_err (then that VJP), in the parallel form
  const bool part = lane < GA_WARPS && first + lane < items;
  S* mi = sm + lane * GA::TOTAL;
  if (mine) ga_load<S>(a, item, n, T, sm + w * GA::TOTAL, lane, 32);
  if (part) {
    if (w < GA_WARPS)
      for (int r = w; r < SM_PARTS; r += GA_WARPS)
        ga_F<S>(a, first + lane, n, T, mi, r);
    else if (par)
      ga_err<S>(a, first + lane, n, T, mi);
  }
  __syncthreads();
  if (mine) ga_item<S, 32>(a, item, sm + w * GA::TOTAL, lane);
  __syncthreads();
  if (part) {
    if (w < GA_WARPS)
      for (int r = w; r < SM_PARTS; r += GA_WARPS)
        ga_F_vjp<S>(a, first + lane, n, T, mi, r);
    else if (par)
      ga_err_vjp<S>(a, first + lane, n, T, mi);
  }
  __syncthreads();
  if (mine) ga_sum<S>(a, item, sm + w * GA::TOTAL, lane, 32);
}

template <typename S>
__global__ void inject_adjoint_kernel(const S* __restrict__ xq,
                                      const S* __restrict__ e,
                                      const S* __restrict__ gxs,
                                      const S* __restrict__ gPs,
                                      const S* __restrict__ p, S* gxq, S* gPq,
                                      S* ge, S* gD, S* gp, int B, int T,
                                      int n, int norm) {
  extern __shared__ __align__(16) unsigned char smem_[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * IA_WARPS + w;
  if (row >= (long long)B * T) return;
  const long long l = row / T, k = row % T;
  const size_t rp = (size_t)DE * DE;
  const size_t el = (size_t)(l * n + k);
  ia_item<S>(xq + row * DX, k < n ? e + el * D2 : nullptr,
             gxs ? gxs + row * DX : nullptr, gPs ? gPs + row * rp : nullptr,
             norm != 0, p, gxq + row * DX, gPq + row * rp,
             k < n ? ge + el * D2 : nullptr,
             k < n ? gD + el * D2 * D2 : nullptr, gp + row * NPP,
             reinterpret_cast<S*>(smem_) + w * IA_SMEM, lane, 32);
}

// kernel 12''s pass before: a warp an item (lane, k)
template <typename S>
__global__ void __launch_bounds__(32 * PRE_WARPS)
    backward_adjoint_pre_kernel(BackAdj<S> a, int B, int T, int norm) {
  extern __shared__ __align__(16) unsigned char smem_[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long n = T - 1;
  const long long item = (long long)blockIdx.x * PRE_WARPS + w;
  if (item >= (long long)B * n) return;
  ba_pre<S, 32>(ba_lane<S>(a, item / n, T), (int)(item % n), norm != 0,
                reinterpret_cast<S*>(smem_) + w * PRE::TOTAL, lane);
}

// kernel 12''s chain: a block a lane, warp 0 the IO warp, warp 1 the state
// chain, the rest the covariance chain
template <typename S>
__global__ void __launch_bounds__(BA_THREADS)
    backward_adjoint_chain_kernel(BackAdj<S> a, int T, int ref_seed) {
  extern __shared__ __align__(16) unsigned char smem_[];
  using R = Ring<S>;
  constexpr int NS = R::NS;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_);
  unsigned long long* done = full + NS;
  S* sm = reinterpret_cast<S*>(smem_ + BA_BAR_BYTES);
  a = ba_lane<S>(a, blockIdx.x, T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = T - 1;
  if (threadIdx.x == 0)
    for (int s = 0; s < NS; ++s) {
      rn_sm::bar_init(full + s, 32);
      rn_sm::bar_init(done + s, 32 * (1 + BA_COV_WARPS));
    }
  __syncthreads();
  if (warp == 0) {            // the IO warp
    for (int s = 0; s < n && s < NS; ++s) {
      ba_fill<S>(a, sm + s * R::STAGE, s, lane);
      rn_sm::bar_arrive_copies(full + s);
    }
    for (int s = 0; s < n; ++s) {
      const int st = s % NS;
      S* g = sm + st * R::STAGE;
      rn_sm::bar_wait(done + st, (s / NS) & 1);
      ba_rows<S>(a, g, s, lane);
      __syncwarp();
      if (s + NS < n) {
        ba_fill<S>(a, g, s + NS, lane);
        rn_sm::bar_arrive_copies(full + st);
      }
    }
  } else if (warp == 1) {     // the state chain
    S ax[(DX + 31) / 32];
    for (int r = 0; r < (DX + 31) / 32; ++r) ax[r] = 0;
    for (int s = 0; s < n; ++s) {
      const int st = s % NS;
      S* g = sm + st * R::STAGE;
      rn_sm::bar_wait(full + st, (s / NS) & 1);
#if !(RN_SMA_AID & 1)
      ba_state<S, 32>(g + R::GO, R::AT_RING ? g + R::AT
                                            : a.at + (size_t)s * at_size<S>(),
                      ax, a.gxs != nullptr, lane);
#endif
      rn_sm::bar_arrive(done + st);
    }
    for (int r = 0; r < (DX + 31) / 32; ++r) {   // x_s[T-1]'s total
      const int i = lane + 32 * r;
      if (i < DX)
        a.go[(size_t)n * DX + i] =
            (a.gxs ? a.gxs[(size_t)n * DX + i] : (S)0) + ax[r];
    }
  } else {                    // the covariance chain
    const int tid = threadIdx.x - 64, nt = BA_COV;
    const bool has_gP = a.gPs != nullptr;
    S* W2 = sm + R::W2;
    if (n > 0) {
      rn_sm::bar_wait(full, 0);
      ba_gm0<S>(sm + R::G, has_gP, tid, nt);
      cov_sync(2);
    }
    for (int s = 0; s < n; ++s) {
      const int st = s % NS;
      S* g = sm + st * R::STAGE;
      rn_sm::bar_wait(full + st, (s / NS) & 1);
#if !(RN_SMA_AID & 2)
      rn_sm::mm_tiles<S, BA_T1>(g + R::C, 1, D2, g + R::G, D2, 1, W2, D2, 1,
                                tid, nt);
      cov_sync(1);
      S* gn = nullptr;
      if (s + 1 < n) {
        rn_sm::bar_wait(full + (s + 1) % NS, ((s + 1) / NS) & 1);
        gn = sm + ((s + 1) % NS) * R::STAGE + R::G;
      }
      ba_cp<S>(W2, g + R::C, g + R::NCP, gn, has_gP, tid, nt);
#endif
      rn_sm::bar_arrive(done + st);
      cov_sync(2);
    }
  }
  __syncthreads();
  ba_seed<S>(a, T, ref_seed != 0,
             n > 0 ? sm + ((n - 1) % NS) * R::STAGE + R::NCP : nullptr,
             threadIdx.x, BA_THREADS);
}

// kernel 12''s pass after: a warp a row (lane, k)
template <typename S>
__global__ void __launch_bounds__(32 * POST_WARPS)
    backward_adjoint_post_kernel(BackAdj<S> a, int B, int T, int norm,
                                 int ref_seed) {
  extern __shared__ __align__(16) unsigned char smem_[];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * POST_WARPS + w;
  if (row >= (long long)B * T) return;
  ba_post<S, 32>(ba_lane<S>(a, row / T, T), (int)(row % T), T, norm != 0,
                 ref_seed != 0, reinterpret_cast<S*>(smem_) + w * PO::TOTAL,
                 lane);
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename S>
constexpr size_t ga_smem() {
  return sizeof(S) * GA_WARPS * GA::TOTAL;
}
template <typename S>
constexpr size_t pre_smem() {
  return sizeof(S) * PRE_WARPS * PRE::TOTAL;
}
template <typename S>
constexpr size_t post_smem() {
  return sizeof(S) * POST_WARPS * PO::TOTAL;
}
template <typename S>
constexpr size_t ia_smem() {
  return sizeof(S) * IA_WARPS * IA_SMEM;
}

inline unsigned blocks_of(long long n, int per) {
  return (unsigned)((n + per - 1) / per);
}

template <typename S>
int gains_adjoint_launch(const GainsAdj<S>& a, int B, int T,
                         cudaStream_t st) {
  cudaError_t err = allow_smem(gains_adjoint_kernel<S>, ga_smem<S>());
  if (err != cudaSuccess) return (int)err;
  gains_adjoint_kernel<S>
      <<<blocks_of((long long)B * (T - 1), GA_WARPS), GA_THREADS,
         ga_smem<S>(), st>>>(a, B, T);
  return (int)cudaGetLastError();
}

// the three kernels of 12' in order on the stream (the aids leave passes
// out); each launch's error checked before the next
template <typename S>
int backward_adjoint_launch(const BackAdj<S>& a, int B, int T, int norm,
                            int ref_seed, cudaStream_t st) {
  const long long items = (long long)B * (T - 1), rows = (long long)B * T;
  cudaError_t err = allow_smem(backward_adjoint_pre_kernel<S>, pre_smem<S>());
  if (err == cudaSuccess)
    err = allow_smem(backward_adjoint_chain_kernel<S>, ba_smem<S>());
  if (err == cudaSuccess)
    err = allow_smem(backward_adjoint_post_kernel<S>, post_smem<S>());
  if (err != cudaSuccess) return (int)err;
  if (!(RN_SMA_AID & 128) && items > 0) {
    backward_adjoint_pre_kernel<S>
        <<<blocks_of(items, PRE_WARPS), 32 * PRE_WARPS, pre_smem<S>(), st>>>(
            a, B, T, norm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (!(RN_SMA_AID & 256)) {
    backward_adjoint_chain_kernel<S><<<B, BA_THREADS, ba_smem<S>(), st>>>(
        a, T, ref_seed);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (!(RN_SMA_AID & 512))
    backward_adjoint_post_kernel<S>
        <<<blocks_of(rows, POST_WARPS), 32 * POST_WARPS, post_smem<S>(),
           st>>>(a, B, T, norm, ref_seed);
  return (int)cudaGetLastError();
}

template <typename S>
int inject_adjoint_launch(const void* xq, const void* e, const void* gxs,
                          const void* gPs, const void* p, void* gxq,
                          void* gPq, void* ge, void* gD, void* gp, int B,
                          int T, int n, int norm, cudaStream_t st) {
  const long long rows = (long long)B * T;
  inject_adjoint_kernel<S>
      <<<blocks_of(rows, IA_WARPS), 32 * IA_WARPS, ia_smem<S>(), st>>>(
          (const S*)xq, (const S*)e, (const S*)gxs, (const S*)gPs,
          (const S*)p, (S*)gxq, (S*)gPq, (S*)ge, (S*)gD, (S*)gp, B, T, n,
          norm);
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
      return kernel_info(gains_adjoint_kernel<S>, GA_THREADS, ga_smem<S>(),
                         GA_WARPS, SM_TILE, GA_THREADS / 32 - GA_WARPS,
                         D2 <= 32, out);
    case 1:
      return kernel_info(backward_adjoint_chain_kernel<S>, BA_THREADS,
                         ba_smem<S>(), BA_COV_WARPS, Ring<S>::NS, BA_T1,
                         BA_T2, out);
    case 2:
      return kernel_info(inject_adjoint_kernel<S>, 32 * IA_WARPS,
                         ia_smem<S>(), IA_WARPS, 0, 0, 0, out);
    case 3:
      return kernel_info(backward_adjoint_pre_kernel<S>, 32 * PRE_WARPS,
                         pre_smem<S>(), PRE_WARPS, Ring<S>::AT_RING, 0, 0,
                         out);
    default:
      return kernel_info(backward_adjoint_post_kernel<S>, 32 * POST_WARPS,
                         post_smem<S>(), POST_WARPS, SM_TILE, 0, 0, out);
  }
}

}  // namespace rn_sma

// C entries: every pointer a device pointer (an absent cotangent null),
// is_double picks the scalar type; each returns the launch's
// cudaGetLastError(). Kernel 11': the forward's xp, Pp, xq, Pq, dts, p, C;
// the cotangents gC (optional) and, for the parallel form, lam, Lam (kernel
// 13''s), e, D (the forward scan's); the outputs gxq0, gPq0, gPp1, gdts,
// gp and the parallel form's gxp1, gxq1, gPq1 (each (B, T - 1, ...)).
extern "C" int rn_smooth_gains_adjoint_launch(RN_SMA_GAINS_ARGS,
                                              int is_double, void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double ? rn_sma::gains_adjoint_launch<double>(
                         RN_SMA_GAINS_INIT(double), B, T, st)
                   : rn_sma::gains_adjoint_launch<float>(
                         RN_SMA_GAINS_INIT(float), B, T, st);
}

// Kernel 12': the forward's xp, Pp, xq, Pq, C, p and outputs xs, Ps; the
// cotangents gxs, gPs; the outputs gxp, gPp, gxq, gPq (zeroed), gC, gp;
// the scratch work (rn_smooth_backward_adjoint_work scalars). Three
// kernels: the pass before, the chain, the pass after.
extern "C" int rn_smooth_backward_adjoint_launch(RN_SMA_BACK_ARGS,
                                                 int is_double,
                                                 void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double ? rn_sma::backward_adjoint_launch<double>(
                         RN_SMA_BACK_INIT(double), B, T, norm, ref_seed, st)
                   : rn_sma::backward_adjoint_launch<float>(
                         RN_SMA_BACK_INIT(float), B, T, norm, ref_seed, st);
}

// Kernel 14': xq, e (B, n, D2), the cotangents gxs, gPs; the outputs gxq,
// gPq (B, T, ...), ge, gD (B, n, ...), gp (B, T, NPP).
extern "C" int rn_smooth_inject_adjoint_launch(
    const void* xq, const void* e, const void* gxs, const void* gPs,
    const void* p, void* gxq, void* gPq, void* ge, void* gD, void* gp, int B,
    int T, int n, int norm, int is_double, void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double ? rn_sma::inject_adjoint_launch<double>(
                         xq, e, gxs, gPs, p, gxq, gPq, ge, gD, gp, B, T, n,
                         norm, st)
                   : rn_sma::inject_adjoint_launch<float>(
                         xq, e, gxs, gPs, p, gxq, gPq, ge, gD, gp, B, T, n,
                         norm, st);
}

// out (9 ints): threads a block, dynamic shared bytes, blocks an SM,
// registers, local (stack) bytes of kernel `which`, then its design: 0
// 11' items a block, tile, auxiliary warps, factor in registers; 1 12''s
// chain covariance warps, ring stages, the tiles of W2 and of CP's pairs;
// 2 14' rows a block; 3 12''s pass before items a block, the state map
// staged in the ring; 4 its pass after rows a block, tile
extern "C" int rn_smooth_adjoint_info(int which, int is_double, int* out) {
  return is_double ? rn_sma::info<double>(which, out)
                   : rn_sma::info<float>(which, out);
}

#else  // the host build (tests): the same item functions, one thread each

namespace rn_sma {

// 11''s item in the kernel's phases, in order
template <typename S>
int gains_adjoint_host(const GainsAdj<S>& a, int B, int T) {
  const long long n = T - 1;
  const bool par = a.lam != nullptr;
  S* sm = (S*)malloc(sizeof(S) * GA::TOTAL);
  for (long long item = 0; item < (long long)B * n; ++item) {
    ga_load<S>(a, item, n, T, sm, 0, 1);
    for (int r = 0; r < SM_PARTS; ++r) ga_F<S>(a, item, n, T, sm, r);
    if (par) ga_err<S>(a, item, n, T, sm);
    ga_item<S, 1>(a, item, sm, 0);
    for (int r = 0; r < SM_PARTS; ++r) ga_F_vjp<S>(a, item, n, T, sm, r);
    if (par) ga_err_vjp<S>(a, item, n, T, sm);
    ga_sum<S>(a, item, sm, 0, 1);
  }
  free(sm);
  return 0;
}

// the chain's stage as a plain copy (the host build's ring)
template <typename S>
struct HostStage {
  S C[D2 * D2], G[D2 * D2], NCP[D2 * D2], GO[DX];
};

template <typename S>
void fill_plain(const BackAdj<S>& a, HostStage<S>* g, int k) {
  const size_t rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  for (int q = 0; q < D2 * D2; ++q) {
    g->C[q] = a.C[k * rc + q];
    g->G[q] = a.gPs ? a.gPs[k * rp + (q / D2) * DE + q % D2] : (S)0;
  }
  for (int i = 0; i < DX; ++i)
    g->GO[i] = a.gxs ? a.gxs[(size_t)k * DX + i] : (S)0;
}

// a lane as the kernels run it: the pass before over every step, the
// chain a step at a time (the state chain, the covariance chain, the rows
// out; two stages, the next filled before the fused product reads it),
// the seed, the pass after over every row
template <typename S>
int backward_adjoint_host(const BackAdj<S>& a0, int B, int T, int norm,
                          int ref_seed) {
  const int n = T - 1;
  const size_t rp = (size_t)DE * DE;
  S* pre = (S*)malloc(sizeof(S) * PRE::TOTAL);
  S* post = (S*)malloc(sizeof(S) * PO::TOTAL);
  HostStage<S>* stg = (HostStage<S>*)malloc(sizeof(HostStage<S>) * 2);
  S* W2 = (S*)malloc(sizeof(S) * D2 * D2);
  for (size_t l = 0; l < (size_t)B; ++l) {
    const BackAdj<S> a = ba_lane<S>(a0, l, T);
    for (int k = 0; k < n; ++k) ba_pre<S, 1>(a, k, norm != 0, pre, 0);
    S ax[DX];
    for (int i = 0; i < DX; ++i) ax[i] = 0;
    if (n > 0) {
      fill_plain<S>(a, stg, 0);
      ba_gm0<S>(stg->G, a.gPs != nullptr, 0, 1);
    }
    for (int s = 0; s < n; ++s) {
      HostStage<S>* g = stg + s % 2;
      HostStage<S>* gn = s + 1 < n ? stg + (s + 1) % 2 : nullptr;
      ba_state<S, 1>(g->GO, a.at + (size_t)s * at_size<S>(), ax,
                     a.gxs != nullptr, 0);
      rn_sm::mm_tiles<S, BA_T1>(g->C, 1, D2, g->G, D2, 1, W2, D2, 1, 0, 1);
      if (gn) fill_plain<S>(a, gn, s + 1);
      ba_cp<S>(W2, g->C, g->NCP, gn ? gn->G : nullptr, a.gPs != nullptr, 0,
               1);
      for (int q = 0; q < D2 * D2; ++q) {
        const size_t o = (q / D2) * DE + q % D2;
        a.gPq[s * rp + o] = g->G[q];
        a.gPp[(s + 1) * rp + o] = g->NCP[q];
      }
      for (int i = 0; i < DX; ++i) a.go[(size_t)s * DX + i] = g->GO[i];
    }
    for (int i = 0; i < DX; ++i)
      a.go[(size_t)n * DX + i] =
          (a.gxs ? a.gxs[(size_t)n * DX + i] : (S)0) + ax[i];
    ba_seed<S>(a, T, ref_seed != 0, n > 0 ? stg[(n - 1) % 2].NCP : nullptr,
               0, 1);
    for (int k = 0; k < T; ++k)
      ba_post<S, 1>(a, k, T, norm != 0, ref_seed != 0, post, 0);
  }
  free(pre);
  free(post);
  free(stg);
  free(W2);
  return 0;
}

template <typename S>
int inject_adjoint_host(const S* xq, const S* e, const S* gxs, const S* gPs,
                        const S* p, S* gxq, S* gPq, S* ge, S* gD, S* gp,
                        int B, int T, int n, int norm) {
  S sm[IA_SMEM];
  const size_t rp = (size_t)DE * DE;
  for (long long row = 0; row < (long long)B * T; ++row) {
    const long long l = row / T, k = row % T;
    const size_t el = (size_t)(l * n + k);
    ia_item<S>(xq + row * DX, k < n ? e + el * D2 : nullptr,
               gxs ? gxs + row * DX : nullptr,
               gPs ? gPs + row * rp : nullptr, norm != 0, p, gxq + row * DX,
               gPq + row * rp, k < n ? ge + el * D2 : nullptr,
               k < n ? gD + el * D2 * D2 : nullptr, gp + row * NPP, sm, 0, 1);
  }
  return 0;
}

// The tests' check of the decompositions at one point (x, dt, p, gF; xa,
// xb, xk, dx' and x_s[k]'s total go; C), into out: F's VJP summed over its
// parts, then whole (gx, gdt, gp: PART_VALS each); the state map's A go,
// then inv_err's VJP toward xb of C^T (inject's VJP toward dx' of go),
// the full VJPs (DX each).
template <typename S>
void parts_check(const S* x, S dt, const S* p, const S* gF, const S* xa,
                 const S* xb, const S* xk, const S* dxp, const S* go,
                 const S* Ck, int norm, S* out) {
  S part[PART_VALS];
  for (int i = 0; i < PART_VALS; ++i) out[i] = 0;
  for (int r = 0; r < SM_PARTS; ++r) {
    for (int i = 0; i < PART_VALS; ++i) part[i] = 0;
    rn_gen::gen_sm_F_vjp_part<S>(x, dt, p, gF, D2, part, part + DX,
                                 part + DX + 1, r);
    for (int i = 0; i < PART_VALS; ++i) out[i] += part[i];
  }
  S* whole = out + PART_VALS;
  for (int i = 0; i < NPP; ++i) whole[DX + 1 + i] = 0;
  rn_gen::gen_sm_F_vjp<S>(x, dt, p, gF, D2, whole, whole + DX,
                          whole + DX + 1);
  S* ax = whole + PART_VALS;
  S* ref = ax + DX;
  S At[DX * DX], g[DX], gdx[DE], gdx2[DE], gx[DX], gxa[DX], gp[NPP];
  for (int c = 0; c < DX; ++c) {   // A's columns, as the pass before
    for (int i = 0; i < DX; ++i) g[i] = i == c ? (S)1 : (S)0;
    inject_vjp_dx<S>(norm != 0, xk, dxp, p, g, gdx);
    for (int i = 0; i < DE; ++i) {
      S s = gdx[i];
      if (i < D2) {
        s = 0;
        for (int j = 0; j < D2; ++j) s += Ck[j * D2 + i] * gdx[j];
      }
      gdx2[i] = s;
    }
    rn_gen::gen_sm_inv_err_vjp_xb<S>(xa, xb, p, gdx2, At + c * DX);
  }
  for (int i = 0; i < DX; ++i) {
    S v = 0;
    for (int j = 0; j < DX; ++j) v += At[j * DX + i] * go[j];
    ax[i] = v;
  }
  inject_vjp<S>(norm != 0, xk, dxp, p, go, gx, gdx, gp);
  for (int i = 0; i < DE; ++i) {
    S s = gdx[i];
    if (i < D2) {
      s = 0;
      for (int j = 0; j < D2; ++j) s += Ck[j * D2 + i] * gdx[j];
    }
    gdx2[i] = s;
  }
  rn_gen::gen_sm_inv_err_vjp<S>(xa, xb, p, gdx2, gxa, ref, gp);
}

}  // namespace rn_sma

// the device entries' signatures, without the stream
extern "C" int rn_smooth_gains_adjoint_host(RN_SMA_GAINS_ARGS,
                                            int is_double) {
  return is_double ? rn_sma::gains_adjoint_host<double>(
                         RN_SMA_GAINS_INIT(double), B, T)
                   : rn_sma::gains_adjoint_host<float>(
                         RN_SMA_GAINS_INIT(float), B, T);
}

extern "C" int rn_smooth_backward_adjoint_host(RN_SMA_BACK_ARGS,
                                               int is_double) {
  return is_double ? rn_sma::backward_adjoint_host<double>(
                         RN_SMA_BACK_INIT(double), B, T, norm, ref_seed)
                   : rn_sma::backward_adjoint_host<float>(
                         RN_SMA_BACK_INIT(float), B, T, norm, ref_seed);
}

extern "C" int rn_smooth_inject_adjoint_host(
    const void* xq, const void* e, const void* gxs, const void* gPs,
    const void* p, void* gxq, void* gPq, void* ge, void* gD, void* gp, int B,
    int T, int n, int norm, int is_double) {
  if (is_double)
    return rn_sma::inject_adjoint_host<double>(
        (const double*)xq, (const double*)e, (const double*)gxs,
        (const double*)gPs, (const double*)p, (double*)gxq, (double*)gPq,
        (double*)ge, (double*)gD, (double*)gp, B, T, n, norm);
  return rn_sma::inject_adjoint_host<float>(
      (const float*)xq, (const float*)e, (const float*)gxs,
      (const float*)gPs, (const float*)p, (float*)gxq, (float*)gPq,
      (float*)ge, (float*)gD, (float*)gp, B, T, n, norm);
}

// rn_sma::parts_check in double: out holds 2 * (DX + 1 + max(NP, 1)) + 2
// * DX scalars
extern "C" int rn_smooth_adjoint_parts_host(
    const void* x, double dt, const void* p, const void* gF, const void* xa,
    const void* xb, const void* xk, const void* dxp, const void* go,
    const void* C, int norm, void* out) {
  rn_sma::parts_check<double>(
      (const double*)x, dt, (const double*)p, (const double*)gF,
      (const double*)xa, (const double*)xb, (const double*)xk,
      (const double*)dxp, (const double*)go, (const double*)C, norm,
      (double*)out);
  return 0;
}

#endif  // __CUDACC__
