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
// Design: one thread a lane and the T loop inside the kernel (kernel 9's
// global form, run backwards), 32 threads a block; each phase is a call
// of its own (GEN_PHASE), x and lx pass through local memory. Bound: the
// bytes of the stacks and their cotangents read and the gradients
// written, or the adjoint's emitted operations at the card's peak rate;
// a log is a few dozen lanes, so one thread's chain of a step's
// operations sets the pace (PERF.md).

#ifndef REDNOSE_GENERIC_STREAM_ADJOINT
#error "csrc/stream_adjoint.cuh is included by an emitted adjoint source"
#endif

namespace rn_gen {

// the cotangents (gx, gP) of a stored x and P, lane-offset with stride ld,
// added into lx and the upper entries of L
GEN_HD GEN_INLINE void adj_enter(scalar_t* lx, scalar_t* L, size_t ld,
                                 const scalar_t* gx, const scalar_t* gP) {
  for (int i = 0; i < DX; ++i) lx[i] += gx[(size_t)i * ld];
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
    scalar_t* dQ, scalar_t* dprm, int* flips) {
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
  for (int i = 0; i < DX; ++i) lx[i] = 0;
  for (size_t e = 0; e < PS; ++e) {
    L[e * ld] = 0;
    gQ[e * ld] = 0;
  }
  adj_enter(lx, L, ld, gx + b, gP + b);
  int nflip = 0;
  for (int t = T - 1; t >= 0; --t) {
    adj_enter(lx, L, ld, gxq + t * XS * ld + b, gPq + t * PS * ld + b);
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
    gen_adj_update(kind_idx[t], x, Ppt, ld, zs + (size_t)t * NZROWS * ld + b,
                   ea, ld, Rs + (size_t)t * NZROWS * NZROWS, p, rej, lx, L,
                   ld, gz, gea, gR, dprm + b, ld, &rec);
    nflip += rec != rej;
    adj_enter(lx, L, ld, gxp + t * XS * ld + b, gPp + t * PS * ld + b);
    // Q's cotangent: dt times the predicted P's, on every upper entry
    const scalar_t dt = dts[t];
    for (int i = 0; i < DE; ++i)
      for (int j = i; j < DE; ++j)
        gQ[(size_t)(i * DE + j) * ld] += dt * L[(size_t)(i * DE + j) * ld];
    // the predict of step t, from the state before it
    const scalar_t* xs = t > 0 ? xq + (t - 1) * XS * ld + b : x0 + b;
    const scalar_t* Ps = t > 0 ? Pq + (t - 1) * PS * ld + b : P0 + b;
    for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * ld];
    gen_adj_predict(x, Ps, ld, dt, p, Q, lx, L, ld, ddts + (size_t)t * ld + b,
                    dprm + b, ld);
  }
  for (int i = 0; i < DX; ++i) dx0[(size_t)i * ld + b] = lx[i];
  flips[b] = nflip;
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
    scalar_t* __restrict__ dprm, int* __restrict__ flips, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B)
    rn_gen::adjoint_filter(b, B, T, x0, P0, zs, eas, dts, kind_idx, Rs, prm,
                           Q, xp, Pp, xq, Pq, gx, gP, gxp, gPp, gxq, gPq, dx0,
                           dP0, dzs, dRs, ddts, deas, dQ, dprm, flips);
}

extern "C" int rn_generic_stream_adjoint_launch(RN_ADJ_PARAMS, int T, int B,
                                                void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  rn_generic_stream_adjoint_kernel<<<blocks, threads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      RN_ADJ_ARGS(RN_ADJ_IN, RN_ADJ_OUT), T, B);
  return static_cast<int>(cudaGetLastError());
}

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
extern "C" int rn_generic_stream_adjoint_host(RN_ADJ_PARAMS, int T, int B) {
  for (int b = 0; b < B; ++b)
    rn_gen::adjoint_filter(b, B, T, RN_ADJ_ARGS(RN_ADJ_IN, RN_ADJ_OUT));
  return 0;
}

#endif  // __CUDACC__
