// Kernel 10 (emitted mode "stream_adjoint"): the adjoint scan of kernel 9,
// the offline log scan. It replaces the gradient of
// rednose_tpu/runtime/scan.py:scan_fn under jax.grad, XLA's transpose of
// the lax.scan (not a Pallas kernel). Wrappers:
// rednose_tpu_torch/ops/generic_scan.py (stream_bank_scan_adjoint) and
// the autograd rule of the custom op rednose::scan_stream
// (rednose_tpu_torch/runtime/scan.py); its plain version is autograd
// through build_scan_stream_reference.
//
// An emitted source (rednose_tpu_torch/ops/adjoint.py) defines
// REDNOSE_SCALAR, includes csrc/generic_scan.cuh once for its prelude
// (scalar_t, GEN_HD, the g_* math), defines in namespace rn_gen the
// constants DX, DE, NP, NZROWS, NEAROWS and the adjoint phases
// gen_adj_predict and gen_adj_update(ki, ...) (the reverse mode of the
// emitted predict and of each kind's update, entry_slab.py), then defines
// REDNOSE_GENERIC_STREAM_ADJOINT and includes this file: the loop, the
// __global__ kernel and its C entry points under nvcc, or a host loop over
// the lanes under a host compiler (the same emitted text in both).
//
// Each lane b runs t = T-1 ... 0 carrying the cotangents (lx, L) of its
// state: lx of x in registers, L of P's upper entries in global memory
// (the dP0 output, bank-minor, its lower entries kept 0). A full-matrix
// cotangent G of a stored P enters an upper entry (i, j), i < j, as
// G_ij + G_ji, a diagonal one as G_ii. At step t: the posterior stacks'
// cotangents (gxq[t], gPq[t]; at T-1 also those of the final state, first)
// enter; the update of kind kind_idx[t] is recomputed from the predicted
// state the forward stored (xp[t], Pp[t]) and its adjoint gives the
// cotangents of the predicted state, of z (dzs[t]), of R's upper entries
// within the kind's block (dRs[t]), of ea (deas[t]) and of the params
// (dprm, accumulated); the predicted stacks' cotangents (gxp[t], gPp[t])
// enter; Q's cotangent takes dt[t] times L on every upper entry (dense:
// an entry of Q off its pattern has a cotangent too); the predict is
// recomputed from the state before it (xq[t-1], Pq[t-1], or x0 and P0 at
// t = 0) and its adjoint gives the cotangents of that state, of dt[t]
// (ddts[t]) and of the params. Nothing beyond kernel 9's stacks is saved
// in the forward.
//
// The gate: a rejected update leaves P exactly as predicted (the gated
// gain is 0, and P + 0 is P bitwise), so the forward's decision at step t
// is read from the stacks (every diagonal entry of Pq[t] equal to Pp[t]'s)
// and the adjoint follows it; the decision recomputed from xp[t], Pp[t]
// (kernel 9's tile rounds otherwise than this global form, so in float32 a
// step at the threshold can flip) is compared with it, and flips[b] counts
// the steps of lane b where the two differ.
//
// Outputs, bank-minor: dx0 (DX, B), dP0 (DE, DE, B) and dQ (DE, DE, B)
// as upper entries (lower ones 0; the wrapper symmetrizes: (A + A^T) / 2),
// dzs (T, NZROWS, B), dRs (T, NZROWS, NZROWS, B) upper entries of each
// kind's block (the rest 0), ddts (T, B), deas (T, NEAROWS, B), dprm
// (NP, B), flips (B,) int32: per lane; the wrapper sums the shared
// inputs' over the lanes.
//
// Two designs, chosen when the source is emitted (ops/adjoint.py names it
// in the source's `// design:` line). The tile form (REDNOSE_ADJOINT_TILE,
// the section below; every float32 variant the port ships, and the
// float64 ones whose tile fits): a block of 32 lanes x NROLES warps
// (entry_slab.TILE_ROLES_ADJOINT) keeps in shared memory, for the whole
// reverse T loop, L and Q's cotangent gQ (upper entries, [entry][32]), lx,
// the update's inputs of the step (Pp[t]'s upper entries, xp[t], its z
// and ea rows, R, dt, the kind index), the predict's (Pq[t-1]'s or P0's
// upper entries, xq[t-1] or x0), the diagonal of Pq[t] that holds the
// forward's gate decision, and the scratch of the phases' cut values.
// Each adjoint phase runs in stages (ops/adjoint.TilePlan): in stage g
// every warp computes its share of the cut values of level g (the values
// that more than one node reads: the reductions over L that the update's
// heavy outputs share, the predict's products of L with F and P) into
// the scratch, then a barrier; then every warp computes its share of the
// phase's outputs into registers, barrier, stores them, adding the next
// incoming cotangent (read from global memory, a coalesced row of 32
// lanes) and, after the update, dt times L into gQ, barrier. The next
// phase's inputs are copied into the tile with cp.async while this phase
// computes: the predict's at the top of a step, the next step's update's
// once this step's update has read its own. The global form (the section
// after it; a variant whose tile does not fit, and
// KernelCall.source(tile=False), the design before): one thread a lane
// and the T loop inside the kernel, 32 threads a block; each phase is a
// call of its own (GEN_PHASE), x and lx pass through local memory.
// Bound: the bytes of the stacks and their cotangents read and the
// gradients written, or the adjoint's emitted operations at the card's
// peak rate; a log is a few dozen lanes, so one warp's chain of a step's
// stages, not the card's rate, sets the pace (PERF.md).
//
// An absent cotangent (a null gx, gP, gxp, gPp, gxq or gPq: an output
// that the loss does not read) is read as zeros, in both designs.
//
// The lane form (REDNOSE_STREAM_ADJOINT_LANE, the global form only; the
// backward of runtime/bank.run_bank, after kernel 9's lane form
// recomputed the stacks): Rs (T, NZROWS, NZROWS, B) by lane, and one more
// incoming cotangent, gys (T, NZROWS, B), that of each step's innovations
// z - h(x_pred), which the emitted update adjoint seeds on its y (a null
// gys: none); entries rn_generic_stream_adjoint_lane_launch / _host.

#ifndef REDNOSE_GENERIC_STREAM_ADJOINT
#error "csrc/stream_adjoint.cuh is included by an emitted adjoint source"
#endif

namespace rn_gen {

// base + off, or null for an absent (null) cotangent
GEN_HD GEN_INLINE const scalar_t* rn_at(const scalar_t* base, size_t off) {
  return base == nullptr ? nullptr : base + off;
}

}  // namespace rn_gen

#define RN_ADJ_ARGS(cast_in, cast_out)                                       \
  cast_in(x0), cast_in(P0), cast_in(zs), cast_in(eas), cast_in(dts),         \
      static_cast<const int*>(kind_idx), cast_in(Rs), cast_in(prm),          \
      cast_in(Q), cast_in(xp), cast_in(Pp), cast_in(xq), cast_in(Pq),        \
      cast_in(gx), cast_in(gP), cast_in(gxp), cast_in(gPp), cast_in(gxq),    \
      cast_in(gPq), cast_out(dx0), cast_out(dP0), cast_out(dzs),             \
      cast_out(dRs), cast_out(ddts), cast_out(deas), cast_out(dQ),           \
      cast_out(dprm), static_cast<int*>(flips)
// the entry's own void* parameters passed through unchanged
#define RN_ADJ_ARGS_V                                                        \
  x0, P0, zs, eas, dts, kind_idx, Rs, prm, Q, xp, Pp, xq, Pq, gx, gP, gxp,   \
      gPp, gxq, gPq, dx0, dP0, dzs, dRs, ddts, deas, dQ, dprm, flips
#define RN_ADJ_IN(a) static_cast<const scalar_t*>(a)
#define RN_ADJ_OUT(a) static_cast<scalar_t*>(a)
#define RN_ADJ_PARAMS                                                        \
  const void *x0, const void *P0, const void *zs, const void *eas,           \
      const void *dts, const void *kind_idx, const void *Rs,                 \
      const void *prm, const void *Q, const void *xp, const void *Pp,        \
      const void *xq, const void *Pq, const void *gx, const void *gP,        \
      const void *gxp, const void *gPp, const void *gxq, const void *gPq,    \
      void *dx0, void *dP0, void *dzs, void *dRs, void *ddts, void *deas,    \
      void *dQ, void *dprm, void *flips

#ifdef REDNOSE_ADJOINT_TILE

// ------------------------------------------------------------ the tile form
// The emitted source defines, besides the constants above, NROLES, NSCR,
// NVAL, the tile's macros (RN_UP(i, j), the upper index of (i, j), i <= j;
// GEN_P, GEN_L, GEN_GQ, GEN_X, GEN_LX, GEN_S), rn_gin / rn_gx (the next
// incoming cotangent of an entry, zero from a null one) and each phase's
// dispatchers: gen_adjt_predict_stage(g, r, ...), _final(r, ...),
// _store(r, ...) and gen_adjt_predict_NSTAGES; gen_adjt_update_nstages(ki)
// and gen_adjt_update_stage / _final / _store(ki, ...), switched on the
// step's kind index (uniform across the bank, so no warp diverges).
//
// A step t, every barrier a __syncthreads of the block:
// - at its top the tile holds the update's inputs (Pp[t]'s upper entries,
//   xp[t], the z and ea rows of step t, R, dt, the kind index) and the
//   diagonal of Pq[t]; the block copies the predict's inputs (Pq[t-1]'s
//   upper entries and xq[t-1], or P0 and x0 at t = 0) into their buffer
//   with cp.async, and every thread reads the forward's gate decision of
//   its lane (rej: every diagonal entry of Pq[t] equal to Pp[t]'s);
// - the update's stages: every warp its cut values into the scratch,
//   barrier; its outputs into registers, barrier; the next step's update
//   inputs start into their buffer; the outputs stored (L and lx with
//   gPp[t], gxp[t] added, gQ += dt L on every upper entry; dzs, dRs, deas
//   and dprm of a lane in the bank to global memory), the predict's inputs
//   waited for, barrier;
// - the predict's stages the same way, its outputs stored with gPq[t-1],
//   gxq[t-1] added (ddts and dprm to global memory), the diagonal of
//   Pq[t-1] kept for the next step's decision, the next update's inputs
//   waited for, barrier.
// A copy is 16 B a thread where the block's 32 lanes are whole and every
// row 16-B aligned, else a value a thread (a lane past the bank copying
// lane B - 1). A lane past the bank computes on a copy of lane B - 1,
// reaches every barrier and stores nothing. flips[b] sums the warps'
// counts of the lane's steps whose recomputed decision differs.

namespace rn_gen {
constexpr int TILE_LANES = 32;
constexpr int UP = DE * (DE + 1) / 2;      // upper entries of a DE x DE
constexpr int IN_ROWS = NZROWS + NEAROWS;  // a step's z and ea rows
constexpr int IN_R = NZROWS * NZROWS;      // a step's R
constexpr int A_ROWS = UP + DX + IN_ROWS;  // the update's staged rows
constexpr int B_ROWS = UP + DX;            // the predict's
// values a lane: L, gQ, lx, the two phases' inputs, Pq's diagonal, scratch
constexpr int LANE_VALS = 2 * UP + DX + A_ROWS + B_ROWS + DE + NSCR;
// values a block: R, dt, the kind index, the flip counts, the row table
constexpr int BLOCK_VALS = IN_R + 2 + TILE_LANES + UP;
}  // namespace rn_gen

#ifdef __CUDACC__

__device__ __forceinline__ void rn_adj_cp_async(void* dst, const void* src,
                                                int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

// rows rows of the block's lanes b0.. into dst ([row][32]), asynchronously:
// the UP upper entries of the P at Pst (row upr[k] of a DE x DE matrix,
// bank-minor), the DX entries of the x at xst, then (rows > B_ROWS) the
// NZROWS z rows at zst and the NEAROWS ea rows at est; the caller commits.
__device__ __forceinline__ void rn_adj_stage(
    scalar_t* dst, const scalar_t* Pst, const scalar_t* xst,
    const scalar_t* zst, const scalar_t* est, int rows, const int* upr,
    int B, int b0, int tid, bool whole) {
  using namespace rn_gen;
  constexpr int NTHR = TILE_LANES * NROLES;
  constexpr int V = 16 / (int)sizeof(scalar_t);  // values a 16-B copy moves
  constexpr int PIECES = TILE_LANES / V;
  auto row = [&](int k) -> const scalar_t* {
    if (k < UP) return Pst + (size_t)upr[k] * B;
    if (k < B_ROWS) return xst + (size_t)(k - UP) * B;
    if (k < B_ROWS + NZROWS) return zst + (size_t)(k - B_ROWS) * B;
    return est + (size_t)(k - B_ROWS - NZROWS) * B;
  };
  if (whole) {
    for (int c = tid; c < rows * PIECES; c += NTHR) {
      const int k = c / PIECES, col = (c % PIECES) * V;
      rn_adj_cp_async(dst + k * TILE_LANES + col, row(k) + b0 + col, 16);
    }
  } else {
    for (int c = tid; c < rows * TILE_LANES; c += NTHR) {
      const int k = c / TILE_LANES;
      const int b = min(b0 + c % TILE_LANES, B - 1);
      rn_adj_cp_async(dst + c, row(k) + b, (int)sizeof(scalar_t));
    }
  }
}

// one block an SM (its shared memory), so ptxas may give a thread all of
// 65,536 / (32 NROLES) registers
__global__ void __launch_bounds__(rn_gen::TILE_LANES * rn_gen::NROLES, 1)
rn_generic_stream_adjoint_tile_kernel(
    const scalar_t* __restrict__ x0, const scalar_t* __restrict__ P0,
    const scalar_t* __restrict__ zs, const scalar_t* __restrict__ eas,
    const scalar_t* __restrict__ dts, const int* __restrict__ kind_idx,
    const scalar_t* __restrict__ Rs, const scalar_t* __restrict__ prm,
    const scalar_t* __restrict__ Q, const scalar_t* __restrict__ xp,
    const scalar_t* __restrict__ Pp, const scalar_t* __restrict__ xq,
    const scalar_t* __restrict__ Pq, const scalar_t* __restrict__ gx,
    const scalar_t* __restrict__ gP, const scalar_t* __restrict__ gxp,
    const scalar_t* __restrict__ gPp, const scalar_t* __restrict__ gxq,
    const scalar_t* __restrict__ gPq, scalar_t* __restrict__ dx0,
    scalar_t* __restrict__ dP0, scalar_t* __restrict__ dzs,
    scalar_t* __restrict__ dRs, scalar_t* __restrict__ ddts,
    scalar_t* __restrict__ deas, scalar_t* __restrict__ dQ,
    scalar_t* __restrict__ dprm, int* __restrict__ flips, int T, int B) {
  using namespace rn_gen;
  constexpr int NTHR = TILE_LANES * NROLES;
  constexpr size_t XS = DX, PS = (size_t)DE * DE;
  extern __shared__ __align__(16) unsigned char rn_tile[];
  scalar_t* Lt = reinterpret_cast<scalar_t*>(rn_tile);
  scalar_t* gQt = Lt + UP * TILE_LANES;
  scalar_t* lxt = gQt + UP * TILE_LANES;
  scalar_t* At = lxt + DX * TILE_LANES;       // the update's inputs
  scalar_t* Bt = At + A_ROWS * TILE_LANES;    // the predict's
  scalar_t* dq = Bt + B_ROWS * TILE_LANES;    // Pq[t]'s diagonal
  scalar_t* st = dq + DE * TILE_LANES;        // the scratch
  scalar_t* Rin = st + NSCR * TILE_LANES;
  scalar_t* dtin = Rin + IN_R;
  int* kin = reinterpret_cast<int*>(dtin + 1);
  int* fl = reinterpret_cast<int*>(dtin + 2);
  int* upr = reinterpret_cast<int*>(dtin + 2 + TILE_LANES);
  const int lane = threadIdx.x, role = threadIdx.y;
  const int tid = role * TILE_LANES + lane;
  const int b0 = blockIdx.x * TILE_LANES, b = b0 + lane;
  const int bc = b < B ? b : B - 1;
  const bool live = b < B;
  constexpr int V = 16 / (int)sizeof(scalar_t);
  const bool whole =
      b0 + TILE_LANES <= B && B % V == 0 &&
      ((reinterpret_cast<size_t>(x0) | reinterpret_cast<size_t>(P0) |
        reinterpret_cast<size_t>(zs) | reinterpret_cast<size_t>(xp) |
        reinterpret_cast<size_t>(Pp) | reinterpret_cast<size_t>(xq) |
        reinterpret_cast<size_t>(Pq) |
        (NEAROWS > 0 ? reinterpret_cast<size_t>(eas) : 0)) %
       16) == 0;
  const size_t ldb = (size_t)B;
  // the update's inputs of step u into At, with its R, dt and kind index
  auto stage_update = [&](int u) {
    rn_adj_stage(At, Pp + u * PS * ldb, xp + u * XS * ldb,
                 zs + (size_t)u * NZROWS * ldb,
                 NEAROWS > 0 ? eas + (size_t)u * NEAROWS * ldb : zs, A_ROWS,
                 upr, B, b0, tid, whole);
    for (int c = tid; c < IN_R; c += NTHR)
      rn_adj_cp_async(Rin + c, Rs + (size_t)u * IN_R + c,
                      (int)sizeof(scalar_t));
    if (tid == NTHR - 1) {
      rn_adj_cp_async(dtin, dts + u, (int)sizeof(scalar_t));
      rn_adj_cp_async(kin, kind_idx + u, 4);
    }
  };
  // the predict's inputs of step u into Bt: the state before it
  auto stage_predict = [&](int u) {
    if (u > 0)
      rn_adj_stage(Bt, Pq + (u - 1) * PS * ldb, xq + (u - 1) * XS * ldb,
                   nullptr, nullptr, B_ROWS, upr, B, b0, tid, whole);
    else
      rn_adj_stage(Bt, P0, x0, nullptr, nullptr, B_ROWS, upr, B, b0, tid,
                   whole);
  };
  for (int k = tid; k < UP; k += NTHR) {
    int i = 0, first = 0;  // the row i whose upper entries hold k
    while (k >= first + DE - i) first += DE - i++;
    upr[k] = i * DE + i + (k - first);
  }
  if (tid < TILE_LANES) fl[tid] = 0;
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  if (role == 0 && live)
    for (int i = 0; i < NP; ++i) dprm[(size_t)i * ldb + b] = 0;
  scalar_t* L = Lt + lane;
  scalar_t* gQ = gQt + lane;
  scalar_t* lx = lxt + lane;
  scalar_t* s = st + lane;
  const size_t ld = TILE_LANES;
  __syncthreads();
  // the final state's cotangents and the last step's posterior ones
  {
    const scalar_t* gPT =
        T > 0 ? rn_at(gPq, (T - 1) * PS * ldb + bc) : nullptr;
    const scalar_t* gxT =
        T > 0 ? rn_at(gxq, (T - 1) * XS * ldb + bc) : nullptr;
    const scalar_t* gPl = rn_at(gP, bc);
    const scalar_t* gxl = rn_at(gx, bc);
    for (int k = role; k < UP; k += NROLES) {
      const int i = upr[k] / DE, j = upr[k] % DE;
      L[(size_t)k * ld] = rn_gin(gPl, i, j, ldb) + rn_gin(gPT, i, j, ldb);
      gQ[(size_t)k * ld] = 0;
    }
    for (int i = role; i < DX; i += NROLES)
      lx[(size_t)i * ld] = rn_gx(gxl, i, ldb) + rn_gx(gxT, i, ldb);
  }
  if (T > 0) {
    stage_update(T - 1);
    rn_adj_stage(Bt, Pq + (T - 1) * PS * ldb, xq + (T - 1) * XS * ldb,
                 nullptr, nullptr, B_ROWS, upr, B, b0, tid, whole);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = role; i < DE; i += NROLES)
    dq[i * TILE_LANES + lane] = Bt[RN_UP(i, i) * TILE_LANES + lane];
  __syncthreads();
  int nflip = 0;
  const scalar_t* xA = At + UP * TILE_LANES + lane;
  const scalar_t* PA = At + lane;
  const scalar_t* zA = At + B_ROWS * TILE_LANES + lane;
  const scalar_t* eaA = zA + NZROWS * TILE_LANES;
  const scalar_t* xB = Bt + UP * TILE_LANES + lane;
  const scalar_t* PB = Bt + lane;
  for (int t = T - 1; t >= 0; --t) {
    const scalar_t dt = dtin[0];
    const int ki = kin[0];
    stage_predict(t);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    bool rej = true;
    for (int i = 0; i < DE; ++i)
      rej = rej && dq[i * TILE_LANES + lane] ==
                       PA[(size_t)RN_UP(i, i) * TILE_LANES];
    // the update's adjoint, from the predicted state the forward stored
    const int nst = gen_adjt_update_nstages(ki);
    for (int g = 0; g < nst; ++g) {
      gen_adjt_update_stage(ki, g, role, xA, PA, ld, dt, p, Q, zA, eaA, ld,
                            Rin, rej, L, lx, s);
      __syncthreads();
    }
    scalar_t v[NVAL];
    gen_adjt_update_final(ki, role, xA, PA, ld, dt, p, Q, zA, eaA, ld, Rin,
                          rej, L, lx, s, v);
    __syncthreads();
    // the update has read its inputs: the next step's start to arrive (an
    // empty group at t = 0, so the predict's is always the second newest)
    if (t > 0) stage_update(t - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    gen_adjt_update_store(
        ki, role, L, lx, gQ, ld, v, rn_at(gPp, t * PS * ldb + bc),
        rn_at(gxp, t * XS * ldb + bc), ldb, dt,
        dzs + (size_t)t * NZROWS * ldb + bc,
        NEAROWS > 0 ? deas + (size_t)t * NEAROWS * ldb + bc : nullptr,
        dRs + (size_t)t * IN_R * ldb + bc, dprm + bc, nullptr, &nflip, rej,
        live);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    // the predict's adjoint, from the state before it
    for (int g = 0; g < gen_adjt_predict_NSTAGES; ++g) {
      gen_adjt_predict_stage(g, role, xB, PB, ld, dt, p, Q, nullptr, nullptr,
                             ld, nullptr, rej, L, lx, s);
      __syncthreads();
    }
    gen_adjt_predict_final(role, xB, PB, ld, dt, p, Q, nullptr, nullptr, ld,
                           nullptr, rej, L, lx, s, v);
    __syncthreads();
    gen_adjt_predict_store(
        role, L, lx, gQ, ld, v,
        t > 0 ? rn_at(gPq, (t - 1) * PS * ldb + bc) : nullptr,
        t > 0 ? rn_at(gxq, (t - 1) * XS * ldb + bc) : nullptr, ldb, dt,
        nullptr, nullptr, nullptr, dprm + bc, ddts + (size_t)t * ldb + bc,
        &nflip, rej, live);
    for (int i = role; i < DE; i += NROLES)
      dq[i * TILE_LANES + lane] = Bt[RN_UP(i, i) * TILE_LANES + lane];
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  }
  atomicAdd(&fl[lane], nflip);
  __syncthreads();
  if (live) {
    for (int i = role; i < DX; i += NROLES)
      dx0[(size_t)i * ldb + b] = lxt[i * TILE_LANES + lane];
    for (int e = role; e < DE * DE; e += NROLES) {
      const int i = e / DE, j = e % DE;
      const bool up = i <= j;
      dP0[(size_t)e * ldb + b] = up ? Lt[RN_UP(i, j) * TILE_LANES + lane] : 0;
      dQ[(size_t)e * ldb + b] = up ? gQt[RN_UP(i, j) * TILE_LANES + lane] : 0;
    }
    if (role == 0) flips[b] = fl[lane];
  }
}

static const int rn_adj_smem =
    (int)sizeof(scalar_t) * (rn_gen::TILE_LANES * rn_gen::LANE_VALS +
                             rn_gen::BLOCK_VALS);

extern "C" int rn_generic_stream_adjoint_launch(RN_ADJ_PARAMS, int T, int B,
                                                void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      rn_generic_stream_adjoint_tile_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, rn_adj_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + rn_gen::TILE_LANES - 1) / rn_gen::TILE_LANES;
  rn_generic_stream_adjoint_tile_kernel<<<
      blocks, dim3(rn_gen::TILE_LANES, rn_gen::NROLES), rn_adj_smem,
      static_cast<cudaStream_t>(stream)>>>(
      RN_ADJ_ARGS(RN_ADJ_IN, RN_ADJ_OUT), T, B);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape as the runtime reads it (generic_scan.cuh's
// rn_generic_scan_info: design 1, the tile, NROLES warps a block).
extern "C" int rn_generic_scan_info(int* out) {
  const int threads = rn_gen::TILE_LANES * rn_gen::NROLES;
  cudaError_t e = cudaFuncSetAttribute(
      rn_generic_stream_adjoint_tile_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, rn_adj_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rn_generic_stream_adjoint_tile_kernel, threads, rn_adj_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, rn_generic_stream_adjoint_tile_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 1;
  out[1] = rn_gen::NROLES;
  out[2] = threads;
  out[3] = rn_adj_smem;
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

#else

// The host build of the tile (tests): lane by lane, a copy of its tile
// (ld = 1), each phase's stages, outputs and stores in barrier order (every
// role computes, then every role stores), as the loop above.
extern "C" int rn_generic_stream_adjoint_host(RN_ADJ_PARAMS, int T, int B) {
  using namespace rn_gen;
  const scalar_t* x0_ = static_cast<const scalar_t*>(x0);
  const scalar_t* P0_ = static_cast<const scalar_t*>(P0);
  const scalar_t* zs_ = static_cast<const scalar_t*>(zs);
  const scalar_t* eas_ = static_cast<const scalar_t*>(eas);
  const scalar_t* dts_ = static_cast<const scalar_t*>(dts);
  const int* ki_ = static_cast<const int*>(kind_idx);
  const scalar_t* Rs_ = static_cast<const scalar_t*>(Rs);
  const scalar_t* Q_ = static_cast<const scalar_t*>(Q);
  const scalar_t* xp_ = static_cast<const scalar_t*>(xp);
  const scalar_t* Pp_ = static_cast<const scalar_t*>(Pp);
  const scalar_t* xq_ = static_cast<const scalar_t*>(xq);
  const scalar_t* Pq_ = static_cast<const scalar_t*>(Pq);
  const scalar_t* g[6] = {
      static_cast<const scalar_t*>(gx), static_cast<const scalar_t*>(gP),
      static_cast<const scalar_t*>(gxp), static_cast<const scalar_t*>(gPp),
      static_cast<const scalar_t*>(gxq), static_cast<const scalar_t*>(gPq)};
  scalar_t* dprm_ = static_cast<scalar_t*>(dprm);
  const size_t ldb = (size_t)B, XS = DX, PS = (size_t)DE * DE;
  for (int b = 0; b < B; ++b) {
    scalar_t L[UP], gQ[UP], lx[DX], xa[DX], Pa[UP], in[IN_ROWS + 1],
        xb[DX], Pb[UP], s[NSCR > 0 ? NSCR : 1];
    scalar_t v[NROLES][NVAL];
    scalar_t p[NP > 0 ? NP : 1];
    for (int i = 0; i < NP; ++i) {
      p[i] = static_cast<const scalar_t*>(prm)[i];
      dprm_[(size_t)i * ldb + b] = 0;
    }
    // a stacked state's upper entries and x into P and x
    auto load = [&](scalar_t* Pl, scalar_t* xl, const scalar_t* Ps,
                    const scalar_t* xs) {
      for (int i = 0; i < DE; ++i)
        for (int j = i; j < DE; ++j)
          Pl[RN_UP(i, j)] = Ps[(size_t)(i * DE + j) * ldb + b];
      for (int i = 0; i < DX; ++i) xl[i] = xs[(size_t)i * ldb + b];
    };
    {
      const scalar_t* gPT = T > 0 ? rn_at(g[5], (T - 1) * PS * ldb + b)
                                  : nullptr;
      const scalar_t* gxT = T > 0 ? rn_at(g[4], (T - 1) * XS * ldb + b)
                                  : nullptr;
      for (int i = 0; i < DE; ++i)
        for (int j = i; j < DE; ++j) {
          L[RN_UP(i, j)] = rn_gin(rn_at(g[1], b), i, j, ldb) +
                           rn_gin(gPT, i, j, ldb);
          gQ[RN_UP(i, j)] = 0;
        }
      for (int i = 0; i < DX; ++i)
        lx[i] = rn_gx(rn_at(g[0], b), i, ldb) + rn_gx(gxT, i, ldb);
    }
    int nflip = 0;
    for (int t = T - 1; t >= 0; --t) {
      const scalar_t dt = dts_[t];
      const int ki = ki_[t];
      load(Pa, xa, Pp_ + t * PS * ldb, xp_ + t * XS * ldb);
      for (int r = 0; r < NZROWS; ++r)
        in[r] = zs_[((size_t)t * NZROWS + r) * ldb + b];
      for (int r = 0; r < NEAROWS; ++r)
        in[NZROWS + r] = eas_[((size_t)t * NEAROWS + r) * ldb + b];
      const scalar_t* R = Rs_ + (size_t)t * IN_R;
      bool rej = true;
      for (int i = 0; i < DE; ++i)
        rej = rej && Pq_[(t * PS + i * DE + i) * ldb + b] ==
                         Pa[RN_UP(i, i)];
      if (t > 0)
        load(Pb, xb, Pq_ + (t - 1) * PS * ldb, xq_ + (t - 1) * XS * ldb);
      else
        load(Pb, xb, P0_, x0_);
      for (int k = 0; k < gen_adjt_update_nstages(ki); ++k)
        for (int r = 0; r < NROLES; ++r)
          gen_adjt_update_stage(ki, k, r, xa, Pa, 1, dt, p, Q_, in,
                                in + NZROWS, 1, R, rej, L, lx, s);
      for (int r = 0; r < NROLES; ++r)
        gen_adjt_update_final(ki, r, xa, Pa, 1, dt, p, Q_, in, in + NZROWS,
                              1, R, rej, L, lx, s, v[r]);
      for (int r = 0; r < NROLES; ++r)
        gen_adjt_update_store(
            ki, r, L, lx, gQ, 1, v[r], rn_at(g[3], t * PS * ldb + b),
            rn_at(g[2], t * XS * ldb + b), ldb, dt,
            static_cast<scalar_t*>(dzs) + (size_t)t * NZROWS * ldb + b,
            NEAROWS > 0
                ? static_cast<scalar_t*>(deas) + (size_t)t * NEAROWS * ldb + b
                : nullptr,
            static_cast<scalar_t*>(dRs) + (size_t)t * IN_R * ldb + b,
            dprm_ + b, nullptr, &nflip, rej, true);
      for (int k = 0; k < gen_adjt_predict_NSTAGES; ++k)
        for (int r = 0; r < NROLES; ++r)
          gen_adjt_predict_stage(k, r, xb, Pb, 1, dt, p, Q_, nullptr,
                                 nullptr, 1, nullptr, rej, L, lx, s);
      for (int r = 0; r < NROLES; ++r)
        gen_adjt_predict_final(r, xb, Pb, 1, dt, p, Q_, nullptr, nullptr, 1,
                               nullptr, rej, L, lx, s, v[r]);
      for (int r = 0; r < NROLES; ++r)
        gen_adjt_predict_store(
            r, L, lx, gQ, 1, v[r],
            t > 0 ? rn_at(g[5], (t - 1) * PS * ldb + b) : nullptr,
            t > 0 ? rn_at(g[4], (t - 1) * XS * ldb + b) : nullptr, ldb, dt,
            nullptr, nullptr, nullptr, dprm_ + b,
            static_cast<scalar_t*>(ddts) + (size_t)t * ldb + b, &nflip, rej,
            true);
    }
    for (int i = 0; i < DX; ++i)
      static_cast<scalar_t*>(dx0)[(size_t)i * ldb + b] = lx[i];
    for (int i = 0; i < DE; ++i)
      for (int j = 0; j < DE; ++j) {
        const size_t e = (size_t)(i * DE + j) * ldb + b;
        static_cast<scalar_t*>(dP0)[e] = i <= j ? L[RN_UP(i, j)] : 0;
        static_cast<scalar_t*>(dQ)[e] = i <= j ? gQ[RN_UP(i, j)] : 0;
      }
    static_cast<int*>(flips)[b] = nflip;
  }
  return 0;
}

#endif  // __CUDACC__

#else  // REDNOSE_ADJOINT_TILE: the global form

namespace rn_gen {

// the cotangents (gx, gP) of a stored x and P, lane-offset with stride ld,
// added into lx and the upper entries of L; a null one adds nothing
GEN_HD GEN_INLINE void adj_enter(scalar_t* lx, scalar_t* L, size_t ld,
                                 const scalar_t* gx, const scalar_t* gP) {
  if (gx != nullptr)
    for (int i = 0; i < DX; ++i) lx[i] += gx[(size_t)i * ld];
  if (gP == nullptr) return;
  for (int i = 0; i < DE; ++i) {
    L[(size_t)(i * DE + i) * ld] += gP[(size_t)(i * DE + i) * ld];
    for (int j = i + 1; j < DE; ++j)
      L[(size_t)(i * DE + j) * ld] +=
          gP[(size_t)(i * DE + j) * ld] + gP[(size_t)(j * DE + i) * ld];
  }
}

// One lane b through all T steps of the log, backwards.
GEN_HD GEN_INLINE void adjoint_filter(
    int b, int B, int T, const scalar_t* x0, const scalar_t* P0,
    const scalar_t* zs, const scalar_t* eas, const scalar_t* dts,
    const int* kind_idx, const scalar_t* Rs, const scalar_t* prm,
    const scalar_t* Q, const scalar_t* xp, const scalar_t* Pp,
    const scalar_t* xq, const scalar_t* Pq, const scalar_t* gx,
    const scalar_t* gP, const scalar_t* gxp, const scalar_t* gPp,
    const scalar_t* gxq, const scalar_t* gPq, scalar_t* dx0, scalar_t* dP0,
    scalar_t* dzs, scalar_t* dRs, scalar_t* ddts, scalar_t* deas,
    scalar_t* dQ, scalar_t* dprm, int* flips, const scalar_t* gys) {
  const size_t ld = (size_t)B;
  const size_t XS = DX, PS = (size_t)DE * DE;  // a step's values a lane
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) {
    p[i] = prm[i];
    dprm[(size_t)i * ld + b] = 0;
  }
  scalar_t x[DX], lx[DX];
  scalar_t* L = dP0 + b;
  scalar_t* gQ = dQ + b;
#ifdef REDNOSE_STREAM_ADJOINT_LANE
  // the lane form sums Q's cotangent, dt L, over a lane's steps in
  // double and stores it once: a bank's lanes' sums cancel (65-165 fold
  // on the smoke's kinematic bank), so a float32 lane's rounding over 500
  // steps (~1e-6 of it) came out ~1e-4 of the bank's sum
  double gq[DE * DE];
  for (int e = 0; e < DE * DE; ++e) gq[e] = 0;
#endif
  for (int i = 0; i < DX; ++i) lx[i] = 0;
  for (size_t e = 0; e < PS; ++e) {
    L[e * ld] = 0;
    gQ[e * ld] = 0;
  }
  adj_enter(lx, L, ld, rn_at(gx, b), rn_at(gP, b));
  int nflip = 0;
  for (int t = T - 1; t >= 0; --t) {
    adj_enter(lx, L, ld, rn_at(gxq, t * XS * ld + b),
              rn_at(gPq, t * PS * ld + b));
    // the update of step t, from the predicted state the forward stored
    const scalar_t* Ppt = Pp + t * PS * ld + b;
    const scalar_t* Pqt = Pq + t * PS * ld + b;
    for (int i = 0; i < DX; ++i) x[i] = xp[(t * XS + i) * ld + b];
    bool rej = true;
    for (int i = 0; i < DE; ++i)
      rej = rej && Pqt[(size_t)(i * DE + i) * ld] ==
                       Ppt[(size_t)(i * DE + i) * ld];
    scalar_t* gz = dzs + (size_t)t * NZROWS * ld + b;
    scalar_t* gR = dRs + (size_t)t * NZROWS * NZROWS * ld + b;
    scalar_t* gea = NEAROWS > 0 ? deas + (size_t)t * NEAROWS * ld + b
                                : nullptr;
    for (int r = 0; r < NZROWS; ++r) gz[(size_t)r * ld] = 0;
    for (int e = 0; e < NZROWS * NZROWS; ++e) gR[(size_t)e * ld] = 0;
    for (int k = 0; k < NEAROWS; ++k) gea[(size_t)k * ld] = 0;
    const scalar_t* ea =
        NEAROWS > 0 ? eas + (size_t)t * NEAROWS * ld + b : nullptr;
    bool rec = rej;
#ifdef REDNOSE_STREAM_ADJOINT_LANE
    // the lane form: Rs (T, NZROWS, NZROWS, B) by lane, and the
    // innovations' cotangent gys (T, NZROWS, B) seeded on the update's y
    gen_adj_update(kind_idx[t], x, Ppt, ld, zs + (size_t)t * NZROWS * ld + b,
                   ea, ld, Rs + (size_t)t * NZROWS * NZROWS * ld + b, ld, p,
                   rej, rn_at(gys, (size_t)t * NZROWS * ld + b), lx, L, ld,
                   gz, gea, gR, dprm + b, ld, &rec);
#else
    (void)gys;
    gen_adj_update(kind_idx[t], x, Ppt, ld, zs + (size_t)t * NZROWS * ld + b,
                   ea, ld, Rs + (size_t)t * NZROWS * NZROWS, p, rej, lx, L,
                   ld, gz, gea, gR, dprm + b, ld, &rec);
#endif
    nflip += rec != rej;
    adj_enter(lx, L, ld, rn_at(gxp, t * XS * ld + b),
              rn_at(gPp, t * PS * ld + b));
    // Q's cotangent: dt times the predicted P's, on every upper entry
    const scalar_t dt = dts[t];
    for (int i = 0; i < DE; ++i)
      for (int j = i; j < DE; ++j)
#ifdef REDNOSE_STREAM_ADJOINT_LANE
        gq[i * DE + j] += (double)dt * (double)L[(size_t)(i * DE + j) * ld];
#else
        gQ[(size_t)(i * DE + j) * ld] += dt * L[(size_t)(i * DE + j) * ld];
#endif
    // the predict of step t, from the state before it
    const scalar_t* xs = t > 0 ? xq + (t - 1) * XS * ld + b : x0 + b;
    const scalar_t* Ps = t > 0 ? Pq + (t - 1) * PS * ld + b : P0 + b;
    for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * ld];
    gen_adj_predict(x, Ps, ld, dt, p, Q, lx, L, ld, ddts + (size_t)t * ld + b,
                    dprm + b, ld);
  }
  for (int i = 0; i < DX; ++i) dx0[(size_t)i * ld + b] = lx[i];
#ifdef REDNOSE_STREAM_ADJOINT_LANE
  for (int e = 0; e < DE * DE; ++e) gQ[(size_t)e * ld] = (scalar_t)gq[e];
#endif
  flips[b] = nflip;
}

}  // namespace rn_gen


#ifdef __CUDACC__

__global__ void rn_generic_stream_adjoint_kernel(
    const scalar_t* __restrict__ x0, const scalar_t* __restrict__ P0,
    const scalar_t* __restrict__ zs, const scalar_t* __restrict__ eas,
    const scalar_t* __restrict__ dts, const int* __restrict__ kind_idx,
    const scalar_t* __restrict__ Rs, const scalar_t* __restrict__ prm,
    const scalar_t* __restrict__ Q, const scalar_t* __restrict__ xp,
    const scalar_t* __restrict__ Pp, const scalar_t* __restrict__ xq,
    const scalar_t* __restrict__ Pq, const scalar_t* __restrict__ gx,
    const scalar_t* __restrict__ gP, const scalar_t* __restrict__ gxp,
    const scalar_t* __restrict__ gPp, const scalar_t* __restrict__ gxq,
    const scalar_t* __restrict__ gPq, scalar_t* __restrict__ dx0,
    scalar_t* __restrict__ dP0, scalar_t* __restrict__ dzs,
    scalar_t* __restrict__ dRs, scalar_t* __restrict__ ddts,
    scalar_t* __restrict__ deas, scalar_t* __restrict__ dQ,
    scalar_t* __restrict__ dprm, int* __restrict__ flips,
    const scalar_t* __restrict__ gys, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B)
    rn_gen::adjoint_filter(b, B, T, x0, P0, zs, eas, dts, kind_idx, Rs, prm,
                           Q, xp, Pp, xq, Pq, gx, gP, gxp, gPp, gxq, gPq, dx0,
                           dP0, dzs, dRs, ddts, deas, dQ, dprm, flips, gys);
}

static int rn_adjoint_launch(RN_ADJ_PARAMS, const void* gys, int T, int B,
                             void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  rn_generic_stream_adjoint_kernel<<<blocks, threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      RN_ADJ_ARGS(RN_ADJ_IN, RN_ADJ_OUT), RN_ADJ_IN(gys), T, B);
  return static_cast<int>(cudaGetLastError());
}

#ifdef REDNOSE_STREAM_ADJOINT_LANE
// the lane form: gys (T, NZROWS, B), or null for no cotangent of the
// innovations
extern "C" int rn_generic_stream_adjoint_lane_launch(RN_ADJ_PARAMS,
                                                     const void* gys, int T,
                                                     int B, void* stream) {
  return rn_adjoint_launch(RN_ADJ_ARGS_V, gys, T, B, stream);
}
#else
extern "C" int rn_generic_stream_adjoint_launch(RN_ADJ_PARAMS, int T, int B,
                                                void* stream) {
  return rn_adjoint_launch(RN_ADJ_ARGS_V, nullptr, T, B, stream);
}
#endif

// The launch shape as the runtime reads it (generic_scan.cuh's
// rn_generic_scan_info: design 0, the global form, one warp a block).
extern "C" int rn_generic_scan_info(int* out) {
  int blocks = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rn_generic_stream_adjoint_kernel, 32, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, rn_generic_stream_adjoint_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = 0;
  out[1] = 1;
  out[2] = 32;
  out[3] = 0;
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

#else

// The host build (tests): the same emitted adjoint, lane by lane.
#ifdef REDNOSE_STREAM_ADJOINT_LANE
extern "C" int rn_generic_stream_adjoint_lane_host(RN_ADJ_PARAMS,
                                                   const void* gys, int T,
                                                   int B) {
  for (int b = 0; b < B; ++b)
    rn_gen::adjoint_filter(b, B, T, RN_ADJ_ARGS(RN_ADJ_IN, RN_ADJ_OUT),
                           RN_ADJ_IN(gys));
  return 0;
}
#else
extern "C" int rn_generic_stream_adjoint_host(RN_ADJ_PARAMS, int T, int B) {
  for (int b = 0; b < B; ++b)
    rn_gen::adjoint_filter(b, B, T, RN_ADJ_ARGS(RN_ADJ_IN, RN_ADJ_OUT),
                           nullptr);
  return 0;
}
#endif

#endif  // __CUDACC__
#endif  // REDNOSE_ADJOINT_TILE
