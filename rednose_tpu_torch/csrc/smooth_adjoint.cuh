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
// Design, the first: simple and right (kernels 11 and 12's first designs
// are the model). 11' and 14' are parallel over (lane, k): a
// WARP an item, its matrices in the warp's slice of shared memory at the
// odd row stride LD, each product in smooth.cuh's mm_tiles register tiles
// over the 32 lanes, the Cholesky and solve over the lanes, the emitted
// functions serial on lane 0 (F's taps in SM_PARTS parts a warp for the
// block's items, as kernel 11). 12' is a chain over k for each lane: a
// BLOCK a lane, warp 0 the state chain (the emitted VJPs on its lane 0,
// C dx and C^T gdx' over its lanes), the other warps the covariance
// chain's four products a step; every input read from global memory as
// the step needs it.
//
// Numerics: IEEE, no fast-math, float or double as the stacks are.

namespace rn_sma {

using rn_gen::D1;
using rn_gen::D2;
using rn_gen::DE;
using rn_gen::DX;
using rn_gen::NP;
using rn_gen::SM_PARTS;
using rn_sm::LD;
using rn_sm::SM_TILE;

// params' scalars a share (one where the spec takes none)
constexpr int NPP = NP > 0 ? NP : 1;
// items (warps) a block of kernel 11'; rows (warps) a block of 14'
constexpr int GA_WARPS = 4;
constexpr int IA_WARPS = 4;
// kernel 12''s block: warp 0 the state chain, the rest the covariance's
constexpr int BA_WARPS = 4;
static_assert(BA_WARPS >= 2, "kernel 12' needs a state warp and one more");
constexpr int BA_THREADS = 32 * BA_WARPS;
constexpr int BA_COV = 32 * (BA_WARPS - 1);
// the covariance warps' tile: the least that fits their threads
constexpr int BA_TILE = rn_sm::tile_for(BA_COV, false);

template <typename S>
GEN_HD GEN_INLINE void inject_vjp(bool norm, const S* x, const S* dx,
                                  const S* p, const S* g, S* gx, S* gdx,
                                  S* gp) {
  if (norm) rn_gen::gen_sm_inject_vjp_n1<S>(x, dx, p, g, gx, gdx, gp);
  else rn_gen::gen_sm_inject_vjp_n0<S>(x, dx, p, g, gx, gdx, gp);
}

// ------------------------------------------------------------ kernel 11'
//
// An item's slice of shared memory, in scalars: nine D2 x D2 matrices at
// row stride LD, then vectors.
struct GA {
  static constexpr int L = 0;                // P_{k+1|k}, then its factor
  static constexpr int F = L + D2 * LD;      // F_k
  static constexpr int PK = F + D2 * LD;     // P_{k|k}
  static constexpr int CM = PK + D2 * LD;    // C_k
  static constexpr int G = CM + D2 * LD;     // C_k's total cotangent
  static constexpr int W1 = G + D2 * LD;
  static constexpr int W2 = W1 + D2 * LD;
  static constexpr int W3 = W2 + D2 * LD;    // Lambda_k, then gP_{k+1|k}
  static constexpr int W4 = W3 + D2 * LD;
  static constexpr int DIAG = W4 + D2 * LD;
  static constexpr int U = DIAG + D2;        // u (DE)
  static constexpr int GU = U + DE;          // [C^T lambda, 0] (DE)
  static constexpr int LAM = GU + DE;        // lambda_k
  static constexpr int EN = LAM + D2;        // e_{k+1}
  static constexpr int GP1 = EN + D2;        // params' shares
  static constexpr int GP2 = GP1 + NPP;
  static constexpr int TOTAL = GP2 + NPP;
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

// The rest of an item, its loads and F in its slice; NL threads (tid:
// this one's; the slice's products over them, the emitted functions on
// thread 0).
template <typename S, int NL>
GEN_HD void ga_item(const GainsAdj<S>& a, long long item, long long n, int T,
                    S* sm, int tid) {
  constexpr int nt = NL;
  const long long l = item / n, k = item % n;
  const size_t r0 = (size_t)(l * T + k), r1 = r0 + 1;
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
    if (tid == 0)
      rn_gen::gen_sm_inv_err<S>(a.xp + r1 * DX, a.xq + r1 * DX, a.p,
                                sm + GA::U);
    rn_sm::mm_tiles<S, SM_TILE>(W3, LD, 1, CM, LD, 1, W2, LD, 1, tid, nt);
    rn_sm::sync_<false>();                       // W2 = Lambda C; u
    rn_sm::mm_tiles<S, SM_TILE>(W2, LD, 1, W1, LD, 1, W4, LD, 1, tid, nt);
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
    rn_sm::mm_tiles<S, SM_TILE>(CM, 1, LD, W2, LD, 1, W1, LD, 1, tid, nt);
    if (tid == 0)
      rn_gen::gen_sm_inv_err_vjp<S>(a.xp + r1 * DX, a.xq + r1 * DX, a.p,
                                    sm + GA::GU, a.gxp1 + item * DX,
                                    a.gxq1 + item * DX, sm + GA::GP2);
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
  rn_sm::cholesky<S, NL>(L, sm + GA::DIAG, tid);   // syncs first
  rn_sm::cho_solve<S, NL>(L, sm + GA::DIAG, W1, tid);
  rn_sm::sync_<false>();                           // W1 = gY
  rn_sm::mm_tiles<S, SM_TILE>(W1, LD, 1, CM, LD, 1, W2, LD, 1, tid, nt);
  rn_sm::mm_tiles<S, SM_TILE>(W1, LD, 1, PK, LD, 1, W4, LD, 1, tid, nt);
  rn_sm::sync_<false>();                           // W2 = gY C, W4 = gF
  for (int q = tid; q < D2 * D2; q += nt) {
    const int i = q / D2, j = q % D2;
    a.gPp1[item * rc + q] = W3[i * LD + j] - W2[i * LD + j];
  }
  rn_sm::sync_<false>();
  rn_sm::mm_tiles<S, SM_TILE>(W1, 1, LD, F, LD, 1, W2, LD, 1, tid, nt);
  if (tid == 0)
    rn_gen::gen_sm_F_vjp<S>(a.xq + r0 * DX, a.dts[item], a.p, W4, LD,
                            a.gxq0 + item * DX, a.gdts + item, sm + GA::GP1);
  rn_sm::sync_<false>();                           // W2 = gY^T F
  for (int q = tid; q < D2 * D2; q += nt)
    a.gPq0[item * rc + q] = W2[(q / D2) * LD + q % D2];
  if (tid == 0)
    for (int j = 0; j < NPP; ++j)
      a.gp[item * NPP + j] =
          j < NP ? sm[GA::GP1 + j] + (par ? sm[GA::GP2 + j] : (S)0) : (S)0;
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
//
// A lane's shared memory, in scalars: six D2 x D2 matrices (row-major),
// then vectors.
struct BA {
  static constexpr int CM = 0;               // C_k
  static constexpr int GM = CM + D2 * D2;    // sym(G_k) on the main block
  static constexpr int DFS = GM + D2 * D2;   // Df + Df^T
  static constexpr int W1 = DFS + D2 * D2;   // gM C
  static constexpr int W2 = W1 + D2 * D2;    // C^T gM
  static constexpr int CP = W2 + D2 * D2;    // the carried cotangent of
                                             // P_s[k]'s main block
  static constexpr int GC = CP + D2 * D2;    // gC_k
  static constexpr int AX = GC + D2 * D2;    // the carried cotangent of
                                             // x_s[k] (DX)
  static constexpr int GO = AX + DX;         // x_s[k]'s total (DX)
  static constexpr int DXV = GO + DX;        // dx = inv_err(...) (DE)
  static constexpr int DXP = DXV + DE;       // [C dx, dx[D2:]] (DE)
  static constexpr int GDX = DXP + DE;       // its cotangent (DE)
  static constexpr int GDX2 = GDX + DE;      // dx's (DE)
  static constexpr int GP1 = GDX2 + DE;
  static constexpr int GP2 = GP1 + NPP;
  static constexpr int TOTAL = GP2 + NPP;
};

// Kernel 12''s pointers: the forward's stacks and outputs (xs, Ps), its
// gains, the cotangents of xs, Ps (either may be null) and the outputs,
// zeroed by the wrapper (the kernel writes only what it computes):
// gxp, gPp, gxq, gPq (B, T, ...), gC (B, T - 1, D2, D2), gp (B, T - 1,
// NPP).
template <typename S>
struct BackAdj {
  const S *xp, *Pp, *xq, *Pq, *C, *p, *xs, *Ps, *gxs, *gPs;
  S *gxp, *gPp, *gxq, *gPq, *gC, *gp;
};

// the state chain's step k on one warp (lanes lane, lane + nl, ...; the
// emitted functions on lane 0, the products C dx and C^T gdx' over the
// lanes): x_s[k]'s total GO, then the inject and inv_err VJPs; AX := the
// cotangent of x_s[k+1] from step k
template <typename S>
GEN_HD GEN_INLINE void ba_state(const BackAdj<S>& a, int k, bool norm,
                                S* sm, int lane, int nl) {
  S* CM = sm + BA::CM;
  S* dx = sm + BA::DXV;
  S* dxp = sm + BA::DXP;
  S* gdx = sm + BA::GDX;
  S* gdx2 = sm + BA::GDX2;
  const S* xp1 = a.xp + (size_t)(k + 1) * DX;
  const S* xs1 = a.xs + (size_t)(k + 1) * DX;
  if (lane == 0) rn_gen::gen_sm_inv_err<S>(xp1, xs1, a.p, dx);
  rn_sm::sync_<false>();
  for (int i = lane; i < DE; i += nl) {
    S s = dx[i];
    if (i < D2) {
      s = 0;
      for (int j = 0; j < D2; ++j) s += CM[i * D2 + j] * dx[j];
    }
    dxp[i] = s;
  }
  rn_sm::sync_<false>();
  if (lane == 0)
    inject_vjp<S>(norm, a.xq + (size_t)k * DX, dxp, a.p, sm + BA::GO,
                  a.gxq + (size_t)k * DX, gdx, sm + BA::GP1);
  rn_sm::sync_<false>();
  for (int i = lane; i < DE; i += nl) {
    S s = gdx[i];
    if (i < D2) {
      s = 0;
      for (int j = 0; j < D2; ++j) s += CM[j * D2 + i] * gdx[j];
    }
    gdx2[i] = s;
  }
  rn_sm::sync_<false>();
  if (lane != 0) return;
  rn_gen::gen_sm_inv_err_vjp<S>(xp1, xs1, a.p, gdx2, a.gxp + (size_t)(k + 1) *
                                DX, sm + BA::AX, sm + BA::GP2);
  for (int j = 0; j < NPP; ++j)
    a.gp[(size_t)k * NPP + j] =
        j < NP ? sm[BA::GP1 + j] + sm[BA::GP2 + j] : (S)0;
}

// step k's loads (all threads): C_k; G_k = gPs[k] + pad(CP), its sym
// written to gPq[k] and its main block to GM; Df + Df^T; x_s[k]'s total
template <typename S>
GEN_HD GEN_INLINE void ba_load(const BackAdj<S>& a, int k, S* sm, int tid,
                               int nt) {
  const size_t rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  const S* gP = a.gPs ? a.gPs + k * rp : nullptr;
  const S* P1 = a.Ps + (k + 1) * rp;
  const S* Pp1 = a.Pp + (k + 1) * rp;
  for (int q = tid; q < D2 * D2; q += nt) sm[BA::CM + q] = a.C[k * rc + q];
  for (int q = tid; q < DE * DE; q += nt) {
    const int i = q / DE, j = q % DE;
    const bool main = i < D2 && j < D2;
    const S gij = (gP ? gP[q] : (S)0) +
                  (main ? sm[BA::CP + i * D2 + j] : (S)0);
    const S gji = (gP ? gP[j * DE + i] : (S)0) +
                  (main ? sm[BA::CP + j * D2 + i] : (S)0);
    const S s = (S)0.5 * (gij + gji);
    a.gPq[k * rp + q] = s;
    if (main) {
      sm[BA::GM + i * D2 + j] = s;
      sm[BA::DFS + i * D2 + j] = (P1[i * DE + j] - Pp1[i * DE + j]) +
                                 (P1[j * DE + i] - Pp1[j * DE + i]);
    }
  }
  for (int i = tid; i < DX; i += nt)
    sm[BA::GO + i] = (a.gxs ? a.gxs[(size_t)k * DX + i] : (S)0) +
                     sm[BA::AX + i];
}

// the covariance warps' barrier (the state warp is not in it)
GEN_HD GEN_INLINE void cov_sync() {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 1, %0;" ::"n"(BA_COV) : "memory");
#endif
}

// the covariance chain's products of step k (threads tid of nt): W1 = gM
// C, W2 = C^T gM, then GC = W1 (Df + Df^T), CP = W2 C
template <typename S, int TT>
GEN_HD GEN_INLINE void ba_cov(S* sm, int tid, int nt) {
  rn_sm::mm_tiles<S, TT>(sm + BA::GM, D2, 1, sm + BA::CM, D2, 1, sm + BA::W1,
                         D2, 1, tid, nt);
  rn_sm::mm_tiles<S, TT>(sm + BA::CM, 1, D2, sm + BA::GM, D2, 1, sm + BA::W2,
                         D2, 1, tid, nt);
  cov_sync();
  rn_sm::mm_tiles<S, TT>(sm + BA::W1, D2, 1, sm + BA::DFS, D2, 1,
                         sm + BA::GC, D2, 1, tid, nt);
  rn_sm::mm_tiles<S, TT>(sm + BA::W2, D2, 1, sm + BA::CM, D2, 1, sm + BA::CP,
                         D2, 1, tid, nt);
}

// step k's stores (all threads): gC_k = GC + gdx'[:D2] dx[:D2]^T, and
// gP_{k+1|k}'s main block -CP
template <typename S>
GEN_HD GEN_INLINE void ba_store(const BackAdj<S>& a, int k, S* sm, int tid,
                                int nt) {
  const size_t rp = (size_t)DE * DE, rc = (size_t)D2 * D2;
  for (int q = tid; q < D2 * D2; q += nt) {
    const int i = q / D2, j = q % D2;
    a.gC[k * rc + q] = sm[BA::GC + q] + sm[BA::GDX + i] * sm[BA::DXV + j];
    a.gPp[(k + 1) * rp + i * DE + j] = -sm[BA::CP + q];
  }
}

// row T - 1, the seed (all threads): its total to x_post / P_post[T-1],
// or added to x_pred / P_pred[T-1]'s (reference_seed)
template <typename S>
GEN_HD GEN_INLINE void ba_seed(const BackAdj<S>& a, int T, bool ref_seed,
                               S* sm, int tid, int nt) {
  const size_t rp = (size_t)DE * DE;
  const int k = T - 1;
  S* gx = ref_seed ? a.gxp : a.gxq;
  S* gP = ref_seed ? a.gPp : a.gPq;
  for (int i = tid; i < DX; i += nt)
    gx[(size_t)k * DX + i] += (a.gxs ? a.gxs[(size_t)k * DX + i] : (S)0) +
                              sm[BA::AX + i];
  for (int q = tid; q < DE * DE; q += nt) {
    const int i = q / DE, j = q % DE;
    gP[k * rp + q] += (a.gPs ? a.gPs[k * rp + q] : (S)0) +
                      (i < D2 && j < D2 ? sm[BA::CP + i * D2 + j] : (S)0);
  }
}

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
  return a;
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
      void *gPq, void *gC, void *gp, int B, int T, int norm, int ref_seed
#define RN_SMA_BACK_INIT(S)                                                  \
  rn_sma::BackAdj<S>{(const S*)xp,  (const S*)Pp,  (const S*)xq,             \
                     (const S*)Pq,  (const S*)C,   (const S*)p,              \
                     (const S*)xs,  (const S*)Ps,  (const S*)gxs,            \
                     (const S*)gPs, (S*)gxp,       (S*)gPp,                  \
                     (S*)gxq,       (S*)gPq,       (S*)gC,                   \
                     (S*)gp}

#ifdef __CUDACC__

namespace rn_sma {

template <typename S>
__global__ void gains_adjoint_kernel(GainsAdj<S> a, int B, int T) {
  extern __shared__ __align__(16) unsigned char smem_[];
  S* sm = reinterpret_cast<S*>(smem_);
  const long long n = T - 1, items = (long long)B * n;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long first = (long long)blockIdx.x * GA_WARPS;
  const long long item = first + w;
  if (item < items) ga_load<S>(a, item, n, T, sm + w * GA::TOTAL, lane, 32);
  // F of the block's items, part by part: lane i of warp w runs parts w,
  // w + GA_WARPS, ... of item first + i
  if (lane < GA_WARPS && first + lane < items)
    for (int r = w; r < SM_PARTS; r += GA_WARPS)
      ga_F<S>(a, first + lane, n, T, sm + lane * GA::TOTAL, r);
  __syncthreads();
  if (item >= items) return;
  ga_item<S, 32>(a, item, n, T, sm + w * GA::TOTAL, lane);
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

template <typename S>
__global__ void __launch_bounds__(BA_THREADS)
    backward_adjoint_kernel(BackAdj<S> a, int T, int norm, int ref_seed) {
  extern __shared__ __align__(16) unsigned char smem_[];
  S* sm = reinterpret_cast<S*>(smem_);
  a = ba_lane<S>(a, blockIdx.x, T);
  const int tid = threadIdx.x;
  for (int q = tid; q < BA::TOTAL; q += BA_THREADS) sm[q] = 0;
  __syncthreads();
  for (int k = 0; k + 1 < T; ++k) {
    ba_load<S>(a, k, sm, tid, BA_THREADS);
    __syncthreads();
    if (tid < 32) {
      ba_state<S>(a, k, norm != 0, sm, tid, 32);
    } else {
      ba_cov<S, BA_TILE>(sm, tid - 32, BA_COV);
    }
    __syncthreads();
    ba_store<S>(a, k, sm, tid, BA_THREADS);
    __syncthreads();
  }
  ba_seed<S>(a, T, ref_seed != 0, sm, tid, BA_THREADS);
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
constexpr size_t ba_smem() {
  return sizeof(S) * BA::TOTAL;
}
template <typename S>
constexpr size_t ia_smem() {
  return sizeof(S) * IA_WARPS * IA_SMEM;
}

template <typename S>
int gains_adjoint_launch(const GainsAdj<S>& a, int B, int T,
                         cudaStream_t st) {
  cudaError_t err = allow_smem(gains_adjoint_kernel<S>, ga_smem<S>());
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)B * (T - 1);
  gains_adjoint_kernel<S>
      <<<(unsigned)((items + GA_WARPS - 1) / GA_WARPS), 32 * GA_WARPS,
         ga_smem<S>(), st>>>(a, B, T);
  return (int)cudaGetLastError();
}

template <typename S>
int backward_adjoint_launch(const BackAdj<S>& a, int B, int T, int norm,
                            int ref_seed, cudaStream_t st) {
  cudaError_t err = allow_smem(backward_adjoint_kernel<S>, ba_smem<S>());
  if (err != cudaSuccess) return (int)err;
  backward_adjoint_kernel<S><<<B, BA_THREADS, ba_smem<S>(), st>>>(
      a, T, norm, ref_seed);
  return (int)cudaGetLastError();
}

template <typename S>
int inject_adjoint_launch(const void* xq, const void* e, const void* gxs,
                          const void* gPs, const void* p, void* gxq,
                          void* gPq, void* ge, void* gD, void* gp, int B,
                          int T, int n, int norm, cudaStream_t st) {
  const long long rows = (long long)B * T;
  inject_adjoint_kernel<S>
      <<<(unsigned)((rows + IA_WARPS - 1) / IA_WARPS), 32 * IA_WARPS,
         ia_smem<S>(), st>>>(
          (const S*)xq, (const S*)e, (const S*)gxs, (const S*)gPs,
          (const S*)p, (S*)gxq, (S*)gPq, (S*)ge, (S*)gD, (S*)gp, B, T, n,
          norm);
  return (int)cudaGetLastError();
}

template <typename K>
int kernel_info(K kernel, int threads, size_t smem, int d0, int d1, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int v[9] = {threads, (int)smem, blocks, attr.numRegs,
                    (int)attr.localSizeBytes, d0, d1, 0, 0};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

template <typename S>
int info(int which, int* out) {
  switch (which) {
    case 0:
      return kernel_info(gains_adjoint_kernel<S>, 32 * GA_WARPS,
                         ga_smem<S>(), GA_WARPS, SM_TILE, out);
    case 1:
      return kernel_info(backward_adjoint_kernel<S>, BA_THREADS,
                         ba_smem<S>(), BA_WARPS, BA_TILE, out);
    default:
      return kernel_info(inject_adjoint_kernel<S>, 32 * IA_WARPS,
                         ia_smem<S>(), IA_WARPS, 0, out);
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
// cotangents gxs, gPs; the outputs gxp, gPp, gxq, gPq (zeroed), gC, gp.
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
// registers, local (stack) bytes of kernel `which` (0: 11', 1: 12', 2:
// 14'), then its design: 11' items a block and tile; 12' warps and the
// covariance warps' tile; 14' rows a block
extern "C" int rn_smooth_adjoint_info(int which, int is_double, int* out) {
  return is_double ? rn_sma::info<double>(which, out)
                   : rn_sma::info<float>(which, out);
}

#else  // the host build (tests): the same item functions, one thread each

namespace rn_sma {

template <typename S>
int gains_adjoint_host(const GainsAdj<S>& a, int B, int T) {
  const long long n = T - 1;
  S* sm = (S*)malloc(sizeof(S) * GA::TOTAL);
  for (long long item = 0; item < (long long)B * n; ++item) {
    ga_load<S>(a, item, n, T, sm, 0, 1);
    for (int r = 0; r < SM_PARTS; ++r) ga_F<S>(a, item, n, T, sm, r);
    ga_item<S, 1>(a, item, n, T, sm, 0);
  }
  free(sm);
  return 0;
}

// a lane's chain as the kernel's roles run a step, in order: the loads,
// the state chain, the covariance chain, the stores
template <typename S>
int backward_adjoint_host(const BackAdj<S>& a0, int B, int T, int norm,
                          int ref_seed) {
  S* sm = (S*)malloc(sizeof(S) * BA::TOTAL);
  for (size_t l = 0; l < (size_t)B; ++l) {
    const BackAdj<S> a = ba_lane<S>(a0, l, T);
    for (int q = 0; q < BA::TOTAL; ++q) sm[q] = 0;
    for (int k = 0; k + 1 < T; ++k) {
      ba_load<S>(a, k, sm, 0, 1);
      ba_state<S>(a, k, norm != 0, sm, 0, 1);
      ba_cov<S, BA_TILE>(sm, 0, 1);
      ba_store<S>(a, k, sm, 0, 1);
    }
    ba_seed<S>(a, T, ref_seed != 0, sm, 0, 1);
  }
  free(sm);
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

#endif  // __CUDACC__
