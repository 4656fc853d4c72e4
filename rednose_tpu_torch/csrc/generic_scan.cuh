// Kernels 4, 5, 6 and 7: fused T-step scans of a bank of ANY filter spec,
// around a step body emitted per spec by rednose_tpu_torch/ops/entry_slab.py;
// kernel 9, the offline log scan (mode "stream", its own section below,
// REDNOSE_GENERIC_SCAN_STREAM, and its lane form, REDNOSE_STREAM_LANE_R);
// and kernel 15, run_bank's bank scan (mode "bank",
// REDNOSE_GENERIC_SCAN_BANK, the first section below).
//
// Kernel 4 (emitted mode "single") replaces the Pallas TPU kernel
// rednose_tpu/ops/pallas_bank.py:_kernel (launched by generic_bank_scan):
// T x (predict + the update of one kind). Kernel 5 (mode "epoch") replaces
// pallas_bank.py:_epoch_kernel (generic_bank_scan_epoch): T x (predict +
// K slot updates, inline). Kernel 6 (mode "mixed") replaces
// pallas_bank.py:_mixed_kernel (generic_bank_scan_mixed), its MSCKF
// camera-frame branch included: T x (predict + the update of the streamed
// kind, a switch that is uniform across the bank, so no warp diverges); a
// feature kind's case is a camera frame. Kernel 7 (mode "frame") replaces
// pallas_bank.py:_vo_kernel (vo_bank_scan, flat form): T MSCKF camera
// frames. A camera frame, in either kernel, is a block predict, the
// feature kind's update projected onto the left null space of He
// (Householder reflectors, a dz' = 5 Cholesky, the gate) and a factored
// Joseph store with the window augment folded in; eas carries the
// landmark positions.
// Wrappers and plain versions: rednose_tpu_torch/ops/generic_scan.py and
// rednose_tpu_torch/ops/lane_bank.py.
//
// An emitted source defines REDNOSE_SCALAR (float, or double for a float64
// bank and the host tests) and includes this file twice. The first include
// (the prelude) defines scalar_t as that type, GEN_HD / GEN_INLINE and the
// g_* math overloads the emitted code calls. The emitted code then defines,
// in namespace rn_gen, the constants DX, DE, NP, NPS, NZROWS, NEAROWS and
// ps_idx(i), and either gen_step(x, P, ld, z, ea, dt, ki, p, Q, R), one
// predict and the step's updates of one filter (the global form), or, for
// kernels 4-7 in tile form (REDNOSE_GENERIC_SCAN_TILE), NROLES, NSCR, NVAL
// and the role dispatchers gen_tile_*, which for kernel 6
// (REDNOSE_GENERIC_SCAN_TILE_KINDS) also take the step's kind index, and
// for kernel 5 (REDNOSE_GENERIC_SCAN_TILE_EPOCH) the slot's unit, with
// NSLOTS and the slot table gen_slot(k). The
// second include (REDNOSE_GENERIC_SCAN_LOOPS) adds the scan loop, the
// __global__ kernel and its C entry points under nvcc, or a host loop over
// the bank under a host compiler: the same emitted text runs in both.
//
// Layout, bank-minor: xs (DX, B), Ps (DE, DE, B), zs (T, NZROWS, B), eas
// (T, NEAROWS, B), dts (T,), kind_idx (T,) int32, pss (T, NPS); the
// params vector prm (NP,), Q (DE, DE) and the packed per-unit R are
// run-time inputs, so a new value never needs a new build.
//
// The tile form (mode "single", kernel 4, mode "epoch", kernel 5, mode
// "mixed", kernel 6, and mode "frame", kernel 7, whenever 32 filters' P, x
// and update scratch (and an epoch's staged inputs) fit in a block's shared
// memory, which every such float32 variant the port ships does;
// ops/entry_slab.py decides when it emits the source and names the design
// in its header): a block of 32 filters (lane = filter) and NROLES
// warps (role = warp) keeps P, x and the scratch in shared memory for the
// whole T loop, and splits each step's phases over the warps between
// barriers (see the tile section below). NROLES is the variant's own: 2
// without a camera frame, more with one (a camera frame's roles hold
// ~DE * DE / (2 NROLES) values each until the barrier). At B = 8192
// that is NROLES x the warps in flight of one thread a filter, every P
// access a shared-memory access. Bound: operations (the live ECEF_POS
// variant 0.04977 ms, the live 4-kind mixed variant 0.05562 ms at
// B = 8192, T = 64, 67 TFLOP/s), against which redundant work across
// roles (shared subexpressions of the predict that more than one role
// needs are computed by each) and the serial update sub-phase count. A
// camera frame's sub-phase is most of its step, so it runs in stages
// (below): one warp He's reflectors and the projected innovation, every
// warp its columns of the projected H, then of HP, then its entries of S,
// one warp S's Cholesky factor and the gate, every warp its columns of
// K^T, the Joseph factor rows and dx. An epoch (kernel 5) is bound by the
// bytes of its inputs (loc's 8 slots at B = 8192, T = 64 in float32:
// 0.03764 ms), which it stages a step ahead; each slot's serial shared
// function on one warp sets its pace (PERF.md).
//
// The global form (a variant whose tile does not fit: msckf_eskf in
// double; the design before the tile, which KernelCall.source(tile=False)
// prints), kernel 2's first design: one thread per
// filter and the T loop inside the kernel, so the state never leaves the
// card during a scan. x is a thread-local array that the emitted code
// indexes with constants, so it lives in registers. P stays in global
// memory, updated in place, read and written at constant offsets; across a
// warp every access is one coalesced 128-byte line. dts, kind_idx and the
// pss row are read once per step. The emitted body is straight-line scalar
// code; what does not fit in registers, nvcc spills to local memory (the
// ptxas report kept beside each build says how much). Bound: the L2
// traffic of P (at B = 8192 a 22 x 22 bank is 15.9 MB, at B = 4096 a
// 36 x 36 MSCKF bank 21.2 MB, resident in the 50 MB L2) and local-memory
// traffic of the spills; a camera frame's augmented store reads nearly
// every old P entry before it writes another, so its body holds most of P
// in registers or local memory (the tile form stores after a barrier
// instead).
//
// Numerics: IEEE, no fast-math, in float or double as the bank's dtype
// says (the wrappers pick the variant). P stays bitwise symmetric: each symmetric
// entry is computed once and written to (i, j) and (j, i). g_rsqrt is
// rsqrtf on the card (~2 ulp) and 1/sqrt elsewhere; the gate compare is
// false for a NaN distance, so NaN does not gate.

#ifndef REDNOSE_GENERIC_SCAN_LOOPS
#ifndef REDNOSE_GENERIC_SCAN_PRELUDE
#define REDNOSE_GENERIC_SCAN_PRELUDE

#include <math.h>
#include <stddef.h>

// GEN_PHASE marks the phase functions of a variant with a camera frame
// (in the global form the predict and each frame unit, in the tile form
// each frame unit's shared function): on the card each is a call of its
// own, so ptxas allocates registers per phase (the msckf_eskf frame body
// then builds in ~2/3 of the inlined time and runs no slower).
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GEN_HD __host__ __device__
#define GEN_INLINE __forceinline__
#define GEN_PHASE __noinline__
#else
#define GEN_HD
#define GEN_INLINE inline
#define GEN_PHASE inline
#endif

#ifndef REDNOSE_SCALAR
#define REDNOSE_SCALAR float
#endif
typedef REDNOSE_SCALAR scalar_t;

#define GEN_UNARY(name, ff, fd)                                    \
  GEN_HD GEN_INLINE float name(float a) { return ff(a); }          \
  GEN_HD GEN_INLINE double name(double a) { return fd(a); }
GEN_UNARY(g_sqrt, sqrtf, sqrt)
GEN_UNARY(g_sin, sinf, sin)
GEN_UNARY(g_cos, cosf, cos)
GEN_UNARY(g_tan, tanf, tan)
GEN_UNARY(g_tanh, tanhf, tanh)
GEN_UNARY(g_sinh, sinhf, sinh)
GEN_UNARY(g_cosh, coshf, cosh)
GEN_UNARY(g_asin, asinf, asin)
GEN_UNARY(g_acos, acosf, acos)
GEN_UNARY(g_atan, atanf, atan)
GEN_UNARY(g_asinh, asinhf, asinh)
GEN_UNARY(g_atanh, atanhf, atanh)
GEN_UNARY(g_exp, expf, exp)
GEN_UNARY(g_expm1, expm1f, expm1)
GEN_UNARY(g_log, logf, log)
GEN_UNARY(g_log1p, log1pf, log1p)
GEN_UNARY(g_abs, fabsf, fabs)
GEN_UNARY(g_erf, erff, erf)
GEN_UNARY(g_floor, floorf, floor)
GEN_UNARY(g_ceil, ceilf, ceil)
#undef GEN_UNARY

GEN_HD GEN_INLINE float g_rsqrt(float a) {
#ifdef __CUDA_ARCH__
  return rsqrtf(a);
#else
  return 1.0f / sqrtf(a);
#endif
}
GEN_HD GEN_INLINE double g_rsqrt(double a) { return 1.0 / sqrt(a); }
GEN_HD GEN_INLINE float g_pow(float a, float b) { return powf(a, b); }
GEN_HD GEN_INLINE double g_pow(double a, double b) { return pow(a, b); }
GEN_HD GEN_INLINE float g_atan2(float a, float b) { return atan2f(a, b); }
GEN_HD GEN_INLINE double g_atan2(double a, double b) { return atan2(a, b); }
GEN_HD GEN_INLINE float g_fmod(float a, float b) { return fmodf(a, b); }
GEN_HD GEN_INLINE double g_fmod(double a, double b) { return fmod(a, b); }
GEN_HD GEN_INLINE float g_hypot(float a, float b) { return hypotf(a, b); }
GEN_HD GEN_INLINE double g_hypot(double a, double b) { return hypot(a, b); }
// floor-mod taking the divisor's sign, as torch.remainder computes it
template <typename S>
GEN_HD GEN_INLINE S g_remainder(S a, S b) {
  const S m = g_fmod(a, b);
  return (m != 0 && ((b < 0) != (m < 0))) ? m + b : m;
}
template <typename S>
GEN_HD GEN_INLINE S g_sign(S a) { return (S)((a > 0) - (a < 0)); }
// NaN-propagating, as torch.clamp / maximum / minimum
template <typename S>
GEN_HD GEN_INLINE S g_max(S a, S b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename S>
GEN_HD GEN_INLINE S g_min(S a, S b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

#endif  // REDNOSE_GENERIC_SCAN_PRELUDE
#else   // REDNOSE_GENERIC_SCAN_LOOPS: after the emitted rn_gen definitions
#if defined(REDNOSE_GENERIC_SCAN_BANK)

// Kernel 15 (emitted mode "bank"): the bank scan of runtime/bank.run_bank.
// It replaces rednose_tpu/runtime/bank.py:jit_run_bank, an XLA program and
// not a Pallas kernel: jax.jit of one lax.scan over T steps of the
// vmapped predict + update of one kind. Wrappers and plain versions:
// rednose_tpu_torch/ops/generic_scan.py (bank_run_scan,
// bank_run_scan_reference) and the custom op rednose::run_bank
// (rednose_tpu_torch/runtime/bank.py). Each step t of each lane: the
// emitted predict with dts[t] and Q; the emitted update of the kind
// (gated as its maha_test says) with z = zs[t] and R step t's dz x dz
// noise of the lane; the innovations z - h(x_pred) stored into ys[t];
// t += dts[t] in the state's type (one add a step, as the plain loop's
// state.t + dt).
//
// Layout, bank-minor: xs (DX, B), Ps (DE, DE, B), ts (B,), updated in
// place; zs (T, NZROWS, B), eas (T, NEAROWS, B), dts (T,); Rs either
// (T, NZROWS, NZROWS, B), read by lane (r_lane 1), or (T, NZROWS,
// NZROWS), one R a step that every lane reads (r_lane 0: a lane stride of
// 0, so a shared R costs no copy); the emitted update reads entry k of R
// at R[k * ld_r]. ys (T, NZROWS, B).
//
// Design: the tile form where a block's state and a ring of its inputs
// fit (every variant the port ships; ops/entry_slab.bank_design sizes
// both and names them in the source's design line), else the global form.
// Tile: a block of 32 lanes streams its inputs through a ring of
// BANK_STAGES stages in shared memory, each BANK_CHUNK steps of the
// block's z and ea rows and, R by lane, its R rows ([step][row][32]; R
// shared: the steps' NZROWS x NZROWS values once for the block), and the
// steps' dts. Before the block computes chunk k it issues the cp.async
// copies of chunk k + BANK_STAGES - 1 (16 B a thread where the block's 32
// lanes are whole and 16-B aligned, else a value a thread, a lane past the
// bank copying lane B - 1) and waits once, at the chunk's start, for chunk
// k's (wait_group), so no step waits on a global load. A run shorter than
// BANK_CHUNK stages its T steps only, in one stage. A chunk's step loop is
// unrolled BANK_UNROLL steps, so a step's ring loads issue ahead of the
// steps before it, off their chain. The emitter sizes the ring and the
// unroll (the step's operations) and picks the warps a block (NROLES) from
// the lane's size (sweep_warps.py --parts bank measured each; PERF.md):
// - one warp (BANK_REGS): the lane's P, x and scratch are thread-local
//   arrays that the emitted code indexes with constants (ld = 1), so they
//   live in registers as kernel 1's state does, and every phase of a lane
//   runs in its own thread: a step has no barrier at all. A __syncwarp at
//   a chunk's start frees the stage the next copies fill, and one after
//   the wait makes the other lanes' copies visible.
// - NROLES >= 2: mode "single"'s tile (kernel 4): P, x and the scratch in
//   shared memory for the whole T loop, each step the predict's roles,
//   then one warp the update's shared values, then the update's roles,
//   between barriers.
// Either way the update computes the innovations into the scratch, and
// gen_tile_y stores them into ys from there, off the step's chain.
// Global: one thread a lane, x in registers, P in global memory, each
// step's inputs read from global memory.
// Bound: the bytes of zs, R (by lane) and ys, or the emitted operations at
// the card's peak rate; and T times the step's dependent chain (predict,
// gain, gate, Joseph: for the kinematic spec kernel 1's recurrence floor).
// RN_BANK_AID bits (timing aids of sweep_warps.py, outputs garbage): 1
// runs no step's compute (each step stores its z rows as ys and adds dt:
// the ring and the stores alone), 2 copies only the first chunk of each
// stage, which every later chunk reuses (the compute alone, on real data).

namespace rn_gen {

// step t's R of lane b: a (T, NZROWS, NZROWS, B) stack by lane, or one R a
// step shared by the lanes (r_lane 0)
GEN_HD GEN_INLINE const scalar_t* bank_R(const scalar_t* Rs, int t, int b,
                                         int B, int r_lane) {
  return r_lane ? Rs + (size_t)t * NZROWS * NZROWS * B + b
                : Rs + (size_t)t * NZROWS * NZROWS;
}

}  // namespace rn_gen

#define RN_BANK_PARAMS                                                       \
  void *xs, void *Ps, void *ts, const void *zs, const void *eas,             \
      const void *dts, const void *Rs, int r_lane, const void *prm,          \
      const void *Q, void *ys, int T, int B
#define RN_BANK_ARGS                                                         \
  static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),                    \
      static_cast<scalar_t*>(ts), static_cast<const scalar_t*>(zs),          \
      static_cast<const scalar_t*>(eas), static_cast<const scalar_t*>(dts),  \
      static_cast<const scalar_t*>(Rs), r_lane,                              \
      static_cast<const scalar_t*>(prm), static_cast<const scalar_t*>(Q),    \
      static_cast<scalar_t*>(ys)

#ifdef REDNOSE_GENERIC_SCAN_TILE

#ifndef RN_BANK_AID
#define RN_BANK_AID 0
#endif

namespace rn_gen {
constexpr int TILE_LANES = 32;
constexpr int TILE_VALS = DE * DE + DX + NSCR;
constexpr bool BANK_REGS = NROLES == 1;   // the lane's state in registers
constexpr int BANK_NR = NZROWS * NZROWS;  // a step's R entries

// The ring's layout for R by lane (RL 1) or shared (RL 0): a stage of
// `chunk` steps holds ROWS rows of TILE_LANES values a step (z, ea, and R
// by lane), then SHARED R values a step, then a dt a step; its size is
// rounded up to 16 B, so every stage starts 16-B aligned.
template <int RL>
struct BankRing {
  static constexpr int ROWS = NZROWS + NEAROWS + (RL ? BANK_NR : 0);
  static constexpr int SHARED = RL ? 0 : BANK_NR;
  static constexpr int V = 16 / (int)sizeof(scalar_t);  // values in 16 B
  GEN_HD static constexpr int stage_vals(int chunk) {
    return (chunk * (ROWS * TILE_LANES + SHARED + 1) + V - 1) / V * V;
  }
  // the steps a stage holds and the stages of a run of T steps: no more
  // than the run has
  GEN_HD static constexpr int chunk(int T) {
    return T < BANK_CHUNK ? T : BANK_CHUNK;
  }
  GEN_HD static constexpr int stages(int T) {
    return (T + chunk(T) - 1) / chunk(T) < BANK_STAGES
               ? (T + chunk(T) - 1) / chunk(T)
               : BANK_STAGES;
  }
  // a block's shared memory for a run of T steps: the tile (NROLES >= 2)
  // and the ring
  GEN_HD static constexpr int smem(int T) {
    return (int)sizeof(scalar_t) *
           ((BANK_REGS ? 0 : TILE_LANES * TILE_VALS) +
            stages(T) * stage_vals(chunk(T)));
  }
};

// A copy of n values (16 B, or one value) into the ring: cp.async on the
// card (the caller commits the group), a plain copy on the host.
GEN_HD GEN_INLINE void bank_copy(scalar_t* dst, const scalar_t* src, int n) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (n * (int)sizeof(scalar_t) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (sizeof(scalar_t) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
#else
  for (int i = 0; i < n; ++i) dst[i] = src[i];
#endif
}

GEN_HD GEN_INLINE bool bank_aligned(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

// whether the block of lanes b0 .. b0 + 31 copies its rows 16 B at a time:
// all 32 lanes in the bank, every row 16-B aligned
template <int RL>
GEN_HD GEN_INLINE bool bank_whole(const scalar_t* zs, const scalar_t* eas,
                                  const scalar_t* Rs, int B, int b0) {
  return b0 + TILE_LANES <= B && B % BankRing<RL>::V == 0 &&
         bank_aligned(zs) && (NEAROWS == 0 || bank_aligned(eas)) &&
         (!RL || bank_aligned(Rs));
}

// Steps t0 .. t0 + n - 1 of the block's lanes b0 .. into the stage st of
// `chunk` steps, the copies c = tid, tid + nthr, ... of this thread: row
// by row (z, then ea, then R by lane), each step's row of the block's 32
// lanes from its source row, whose rows a step apart lie `step` apart.
template <int RL>
GEN_HD GEN_INLINE void bank_stage(scalar_t* st, int chunk,
                                  const scalar_t* zs, const scalar_t* eas,
                                  const scalar_t* Rs, const scalar_t* dts,
                                  int t0, int n, int B, int b0, int tid,
                                  int nthr, bool whole) {
  using Ring = BankRing<RL>;
  constexpr int ROWS = Ring::ROWS, V = Ring::V, PIECES = TILE_LANES / V;
  for (int r = 0; r < ROWS; ++r) {
    const bool zr = r < NZROWS, er = !zr && r < NZROWS + NEAROWS;
    const size_t step = (size_t)(zr ? NZROWS : er ? NEAROWS : BANK_NR) * B;
    const scalar_t* src =
        (zr ? zs + (size_t)r * B
            : er ? eas + (size_t)(r - NZROWS) * B
                 : Rs + (size_t)(r - NZROWS - NEAROWS) * B) +
        (size_t)t0 * step;
    scalar_t* dst = st + r * TILE_LANES;
    if (whole) {
      for (int c = tid; c < n * PIECES; c += nthr) {
        const int j = c / PIECES, col = (c - j * PIECES) * V;
        bank_copy(dst + j * ROWS * TILE_LANES + col, src + j * step + b0 + col,
                  V);
      }
    } else {
      for (int c = tid; c < n * TILE_LANES; c += nthr) {
        const int j = c / TILE_LANES, l = c - j * TILE_LANES;
        bank_copy(dst + j * ROWS * TILE_LANES + l,
                  src + j * step + (b0 + l < B ? b0 + l : B - 1), 1);
      }
    }
  }
  scalar_t* rsh = st + chunk * Ring::ROWS * TILE_LANES;
  if (!RL)
    for (int c = tid; c < n * BANK_NR; c += nthr)
      bank_copy(rsh + c, Rs + (size_t)t0 * BANK_NR + c, 1);
  scalar_t* dtr = rsh + chunk * Ring::SHARED;
  for (int c = tid; c < n; c += nthr) bank_copy(dtr + c, dts + t0 + c, 1);
}

}  // namespace rn_gen

#ifdef __CUDACC__

// Every thread of the block at once: a warp's (one warp) or the block's.
__device__ __forceinline__ void rn_bank_sync() {
  if (rn_gen::BANK_REGS)
    __syncwarp();
  else
    __syncthreads();
}

// The barriers inside a step: none with one warp (each lane's phases run
// in its own thread).
__device__ __forceinline__ void rn_bank_step_sync() {
  if (!rn_gen::BANK_REGS) __syncthreads();
}

template <int RL>
__global__ void __launch_bounds__(rn_gen::TILE_LANES * rn_gen::NROLES)
rn_generic_bank_kernel(
    scalar_t* __restrict__ xs, scalar_t* __restrict__ Ps,
    scalar_t* __restrict__ ts, const scalar_t* __restrict__ zs,
    const scalar_t* __restrict__ eas, const scalar_t* __restrict__ dts,
    const scalar_t* __restrict__ Rs, const scalar_t* __restrict__ prm,
    const scalar_t* __restrict__ Q, scalar_t* __restrict__ ys, int T,
    int B) {
  using namespace rn_gen;
  using Ring = BankRing<RL>;
  constexpr int NTHR = TILE_LANES * NROLES;
  extern __shared__ __align__(16) unsigned char rn_tile[];
  scalar_t* tile = reinterpret_cast<scalar_t*>(rn_tile);
  scalar_t* ring = tile + (BANK_REGS ? 0 : TILE_LANES * TILE_VALS);
  // one warp: role 0, a constant, so the dispatchers fold away
  const int lane = threadIdx.x, role = BANK_REGS ? 0 : threadIdx.y;
  const int tid = role * TILE_LANES + lane;
  const int b0 = blockIdx.x * TILE_LANES, b = b0 + lane;
  const int bc = b < B ? b : B - 1;
  const int chunk = Ring::chunk(T), nst = Ring::stages(T);
  const int nchunks = (T + chunk - 1) / chunk;
  const int sv = Ring::stage_vals(chunk);
  const bool whole = bank_whole<RL>(zs, eas, Rs, B, b0);
  // chunk k into its stage, asynchronously (the caller commits the group)
  auto stage_of = [&](int k) {
    if (k < nchunks && (!(RN_BANK_AID & 2) || k < nst))
      bank_stage<RL>(ring + (k % nst) * sv, chunk, zs, eas, Rs, dts,
                     k * chunk, T - k * chunk < chunk ? T - k * chunk : chunk,
                     B, b0, tid, NTHR, whole);
  };
  // the first BANK_STAGES - 1 chunks, one group each (empty past the end)
  for (int k = 0; k < BANK_STAGES - 1; ++k) {
    stage_of(k);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // the lane's state: registers with one warp, else the block's tile
  scalar_t xr[DX], Pr[DE * DE], sr[NSCR > 0 ? NSCR : 1];
  scalar_t* x = BANK_REGS ? xr : tile + DE * DE * TILE_LANES + lane;
  scalar_t* P = BANK_REGS ? Pr : tile + lane;
  scalar_t* s = BANK_REGS ? sr : tile + (DE * DE + DX) * TILE_LANES + lane;
  constexpr size_t ld = BANK_REGS ? 1 : TILE_LANES;
  // (one warp: every entry, at constant indices, so into registers)
#pragma unroll
  for (int e = role; e < DE * DE; e += NROLES)
    P[e * ld] = Ps[(size_t)e * B + bc];
#pragma unroll
  for (int i = role; i < DX; i += NROLES) x[i * ld] = xs[(size_t)i * B + bc];
  scalar_t tl = ts[bc];
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  constexpr size_t ld_in = TILE_LANES;
  constexpr size_t ld_r = RL ? TILE_LANES : 1;
  // the chunk loop's steps unrolled (the emitter's BANK_UNROLL, or
  // RN_BANK_UNROLL where defined: sweep_warps.py), so a step's ring loads
  // (dt, z, R) issue ahead, off the steps' dependent chain
#ifdef RN_BANK_UNROLL
  constexpr int RN_BANK_UNROLL_N = RN_BANK_UNROLL;
#else
  constexpr int RN_BANK_UNROLL_N = BANK_UNROLL;
#endif
  for (int k = 0; k < nchunks; ++k) {
    // chunk k + BANK_STAGES - 1 into the stage chunk k - 1 used, once
    // every thread is done with it; then wait for chunk k (all groups but
    // the BANK_STAGES - 1 newest) and see every thread's copies
    rn_bank_sync();
    stage_of(k + BANK_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(BANK_STAGES - 1)
                 : "memory");
    rn_bank_sync();
    const scalar_t* st = ring + (k % nst) * sv;
    const scalar_t* rsh = st + chunk * Ring::ROWS * TILE_LANES;
    const scalar_t* dtr = rsh + chunk * Ring::SHARED;
    const int t0 = k * chunk, n = T - t0 < chunk ? T - t0 : chunk;
#pragma unroll RN_BANK_UNROLL_N
    for (int j = 0; j < n; ++j) {
      const scalar_t dt = dtr[j];
      const scalar_t* z = st + j * Ring::ROWS * TILE_LANES + lane;
      const scalar_t* ea = z + NZROWS * TILE_LANES;
      const scalar_t* R = RL ? ea + NEAROWS * TILE_LANES : rsh + j * BANK_NR;
      scalar_t* y = ys + (size_t)(t0 + j) * NZROWS * B + b;
      if (RN_BANK_AID & 1) {
        if (role == 0 && b < B)
          for (int r = 0; r < NZROWS; ++r) y[(size_t)r * B] = z[r * ld_in];
      } else {
        scalar_t v[NVAL];
        gen_tile_predict(role, x, P, ld, dt, p, Q, v);
        rn_bank_step_sync();
        gen_tile_predict_store(role, x, P, ld, v);
        rn_bank_step_sync();
        if (role == 0) gen_tile_shared(x, P, ld, z, ea, ld_in, R, ld_r, p, s);
        rn_bank_step_sync();
        // the innovations leave from the scratch while the roles compute
        if (role == NROLES - 1 && b < B)
          gen_tile_y(x, P, ld, z, ea, ld_in, R, ld_r, p, s, y, (size_t)B);
        gen_tile_update(role, x, P, ld, z, ea, ld_in, R, ld_r, p, s, v);
        rn_bank_step_sync();
        gen_tile_update_store(role, x, P, ld, v);
        rn_bank_step_sync();
      }
      tl = tl + dt;
    }
  }
  if (b < B) {
#pragma unroll
    for (int e = role; e < DE * DE; e += NROLES)
      Ps[(size_t)e * B + b] = P[e * ld];
#pragma unroll
    for (int i = role; i < DX; i += NROLES) xs[(size_t)i * B + b] = x[i * ld];
    if (role == 0) ts[b] = tl;
  }
}

template <int RL>
static int rn_bank_launch(RN_BANK_PARAMS, void* stream) {
  const int smem = rn_gen::BankRing<RL>::smem(T);
  cudaError_t e = cudaFuncSetAttribute(
      rn_generic_bank_kernel<RL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + rn_gen::TILE_LANES - 1) / rn_gen::TILE_LANES;
  rn_generic_bank_kernel<RL>
      <<<blocks, dim3(rn_gen::TILE_LANES, rn_gen::NROLES), smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
          static_cast<scalar_t*>(ts), static_cast<const scalar_t*>(zs),
          static_cast<const scalar_t*>(eas),
          static_cast<const scalar_t*>(dts), static_cast<const scalar_t*>(Rs),
          static_cast<const scalar_t*>(prm), static_cast<const scalar_t*>(Q),
          static_cast<scalar_t*>(ys), T, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rn_generic_bank_launch(RN_BANK_PARAMS, void* stream) {
  return r_lane ? rn_bank_launch<1>(xs, Ps, ts, zs, eas, dts, Rs, r_lane,
                                    prm, Q, ys, T, B, stream)
                : rn_bank_launch<0>(xs, Ps, ts, zs, eas, dts, Rs, r_lane,
                                    prm, Q, ys, T, B, stream);
}

// the launch shape the info entry reads: R by lane with a full ring
static const int rn_tile_smem =
    rn_gen::BankRing<1>::smem(rn_gen::BANK_CHUNK * rn_gen::BANK_STAGES);

#define RN_GEN_KERNEL rn_generic_bank_kernel<1>
#define RN_GEN_DESIGN 1
#define RN_GEN_ROLES rn_gen::NROLES
#define RN_GEN_SMEM rn_tile_smem

#else

#include <stdlib.h>

// The host build of the tile form (tests): a block of 32 lanes at a time,
// its tile laid out as the card's ([value][32], ld = 32) and its inputs
// staged through the same ring by the same copies (every thread's, in
// turn, in the card's order), each step's phases lane by lane in barrier
// order. One warp or more: the same arithmetic, so the same bits.
namespace rn_gen {

template <int RL>
void bank_tile_host(scalar_t* xs, scalar_t* Ps, scalar_t* ts,
                    const scalar_t* zs, const scalar_t* eas,
                    const scalar_t* dts, const scalar_t* Rs, const scalar_t* prm,
                    const scalar_t* Q, scalar_t* ys, int T, int B) {
  using Ring = BankRing<RL>;
  constexpr int NTHR = TILE_LANES * NROLES;
  const int chunk = Ring::chunk(T), nst = Ring::stages(T);
  const int nchunks = (T + chunk - 1) / chunk;
  const int sv = Ring::stage_vals(chunk);
  scalar_t* tile = static_cast<scalar_t*>(
      malloc(sizeof(scalar_t) * TILE_LANES * TILE_VALS));
  scalar_t* ring =
      static_cast<scalar_t*>(malloc(sizeof(scalar_t) * nst * sv));
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  auto stage = [&](int k, int b0, bool whole) {
    for (int tid = 0; tid < NTHR; ++tid)
      bank_stage<RL>(ring + (k % nst) * sv, chunk, zs, eas, Rs, dts,
                     k * chunk, T - k * chunk < chunk ? T - k * chunk : chunk,
                     B, b0, tid, NTHR, whole);
  };
  for (int b0 = 0; b0 < B; b0 += TILE_LANES) {
    const bool whole = bank_whole<RL>(zs, eas, Rs, B, b0);
    scalar_t tl[TILE_LANES];
    for (int l = 0; l < TILE_LANES; ++l) {
      const int bc = b0 + l < B ? b0 + l : B - 1;
      for (int e = 0; e < DE * DE; ++e)
        tile[e * TILE_LANES + l] = Ps[(size_t)e * B + bc];
      for (int i = 0; i < DX; ++i)
        tile[(DE * DE + i) * TILE_LANES + l] = xs[(size_t)i * B + bc];
      tl[l] = ts[bc];
    }
    for (int k = 0; k < BANK_STAGES - 1 && k < nchunks; ++k)
      stage(k, b0, whole);
    for (int k = 0; k < nchunks; ++k) {
      if (k + BANK_STAGES - 1 < nchunks) stage(k + BANK_STAGES - 1, b0, whole);
      const scalar_t* st = ring + (k % nst) * sv;
      const scalar_t* rsh = st + chunk * Ring::ROWS * TILE_LANES;
      const scalar_t* dtr = rsh + chunk * Ring::SHARED;
      const int t0 = k * chunk, n = T - t0 < chunk ? T - t0 : chunk;
      for (int j = 0; j < n; ++j) {
        const scalar_t dt = dtr[j];
        for (int l = 0; l < TILE_LANES; ++l) {
          scalar_t* P = tile + l;
          scalar_t* x = tile + DE * DE * TILE_LANES + l;
          scalar_t* s = tile + (DE * DE + DX) * TILE_LANES + l;
          const size_t ld = TILE_LANES, ld_in = TILE_LANES;
          const size_t ld_r = RL ? TILE_LANES : 1;
          const scalar_t* z = st + j * Ring::ROWS * TILE_LANES + l;
          const scalar_t* ea = z + NZROWS * TILE_LANES;
          const scalar_t* R =
              RL ? ea + NEAROWS * TILE_LANES : rsh + j * BANK_NR;
          scalar_t v[NROLES][NVAL];
          for (int r = 0; r < NROLES; ++r)
            gen_tile_predict(r, x, P, ld, dt, p, Q, v[r]);
          for (int r = 0; r < NROLES; ++r)
            gen_tile_predict_store(r, x, P, ld, v[r]);
          gen_tile_shared(x, P, ld, z, ea, ld_in, R, ld_r, p, s);
          if (b0 + l < B)
            gen_tile_y(x, P, ld, z, ea, ld_in, R, ld_r, p, s,
                       ys + (size_t)(t0 + j) * NZROWS * B + b0 + l, (size_t)B);
          for (int r = 0; r < NROLES; ++r)
            gen_tile_update(r, x, P, ld, z, ea, ld_in, R, ld_r, p, s, v[r]);
          for (int r = 0; r < NROLES; ++r)
            gen_tile_update_store(r, x, P, ld, v[r]);
          tl[l] = tl[l] + dt;
        }
      }
    }
    for (int l = 0; l < TILE_LANES && b0 + l < B; ++l) {
      for (int e = 0; e < DE * DE; ++e)
        Ps[(size_t)e * B + b0 + l] = tile[e * TILE_LANES + l];
      for (int i = 0; i < DX; ++i)
        xs[(size_t)i * B + b0 + l] = tile[(DE * DE + i) * TILE_LANES + l];
      ts[b0 + l] = tl[l];
    }
  }
  free(ring);
  free(tile);
}

}  // namespace rn_gen

extern "C" int rn_generic_bank_host(RN_BANK_PARAMS) {
  if (T == 0) return 0;
  auto run = r_lane ? rn_gen::bank_tile_host<1> : rn_gen::bank_tile_host<0>;
  run(static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
      static_cast<scalar_t*>(ts), static_cast<const scalar_t*>(zs),
      static_cast<const scalar_t*>(eas), static_cast<const scalar_t*>(dts),
      static_cast<const scalar_t*>(Rs), static_cast<const scalar_t*>(prm),
      static_cast<const scalar_t*>(Q), static_cast<scalar_t*>(ys), T, B);
  return 0;
}

#endif  // __CUDACC__
#else   // REDNOSE_GENERIC_SCAN_TILE: the global form

namespace rn_gen {

// One lane b through all T steps: x in registers, P in global memory.
GEN_HD GEN_INLINE void bank_filter(
    int b, int B, int T, scalar_t* xs, scalar_t* Ps, scalar_t* ts,
    const scalar_t* zs, const scalar_t* eas, const scalar_t* dts,
    const scalar_t* Rs, int r_lane, const scalar_t* prm, const scalar_t* Q,
    scalar_t* ys) {
  scalar_t x[DX];
  for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * B + b];
  scalar_t* P = Ps + b;
  scalar_t tl = ts[b];
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  const size_t ld_r = r_lane ? (size_t)B : 1;
  for (int t = 0; t < T; ++t) {
    const scalar_t dt = dts[t];
    gen_predict(x, P, (size_t)B, dt, p, Q);
    const scalar_t* z = zs + (size_t)t * NZROWS * B + b;
    const scalar_t* ea =
        NEAROWS > 0 ? eas + (size_t)t * NEAROWS * B + b : nullptr;
    gen_bank_update(x, P, (size_t)B, z, ea, (size_t)B,
                    bank_R(Rs, t, b, B, r_lane), ld_r, p,
                    ys + (size_t)t * NZROWS * B + b);
    tl = tl + dt;
  }
  for (int i = 0; i < DX; ++i) xs[(size_t)i * B + b] = x[i];
  ts[b] = tl;
}

}  // namespace rn_gen

#ifdef __CUDACC__

__global__ void rn_generic_bank_kernel(
    scalar_t* __restrict__ xs, scalar_t* __restrict__ Ps,
    scalar_t* __restrict__ ts, const scalar_t* __restrict__ zs,
    const scalar_t* __restrict__ eas, const scalar_t* __restrict__ dts,
    const scalar_t* __restrict__ Rs, int r_lane,
    const scalar_t* __restrict__ prm, const scalar_t* __restrict__ Q,
    scalar_t* __restrict__ ys, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B)
    rn_gen::bank_filter(b, B, T, xs, Ps, ts, zs, eas, dts, Rs, r_lane, prm, Q,
                        ys);
}

extern "C" int rn_generic_bank_launch(RN_BANK_PARAMS, void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  rn_generic_bank_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(RN_BANK_ARGS,
                                                               T, B);
  return static_cast<int>(cudaGetLastError());
}

#define RN_GEN_KERNEL rn_generic_bank_kernel
#define RN_GEN_DESIGN 0
#define RN_GEN_ROLES 1
#define RN_GEN_SMEM 0

#else

// The host build (tests): the same emitted body, lane by lane.
extern "C" int rn_generic_bank_host(RN_BANK_PARAMS) {
  for (int b = 0; b < B; ++b) rn_gen::bank_filter(b, B, T, RN_BANK_ARGS);
  return 0;
}

#endif  // __CUDACC__
#endif  // REDNOSE_GENERIC_SCAN_TILE
#elif defined(REDNOSE_GENERIC_SCAN_STREAM) && !defined(REDNOSE_GENERIC_SCAN_TILE)

// Kernel 9 (emitted mode "stream"): the offline log scan. It replaces
// rednose_tpu/runtime/scan.py:scan_fn, an XLA program and not a Pallas
// kernel: jax.jit of one lax.scan over the log with a lax.switch over the
// observation kinds. Wrappers and plain versions:
// rednose_tpu_torch/ops/generic_scan.py (stream_bank_scan) and
// rednose_tpu_torch/runtime/scan.py (scan_fn, vmapped over lanes). Each
// step t of each lane: the emitted predict with dts[t]; x and P stored
// into the stacks xp[t], Pp[t]; the emitted update of the kind kind_idx[t]
// (gen_stream_update, gated as the kind's maha_test says) with z = zs[t]
// and R the leading dz x dz block of Rs[t], a NZROWS x NZROWS matrix
// shared by the bank (its padded slots carry PAD_R, no information, and
// the padded rows of y and H are zero, so the block is the whole update);
// x and P stored into xq[t], Pq[t].
//
// Layout, bank-minor: xs (DX, B), Ps (DE, DE, B), updated in place; zs
// (T, NZROWS, B), eas (T, NEAROWS, B), dts (T,), kind_idx (T,) int32, Rs
// (T, NZROWS, NZROWS); the stacks xp, xq (T, DX, B) and Pp, Pq (T, DE, DE,
// B), so a warp's 32 lanes store 32 consecutive values of every entry.
// A log is a few dozen lanes (64 in the offline path, 1 in the float64
// refinement), so one block of 32 lanes runs on each of one or two SMs
// and a step's latency, not the card's rate, sets the pace. Bound: the
// stacks' bytes at the card's memory rate (4,056 B a lane-step in float32:
// 0.635 ms for 64 x 8192), or the emitted operations at its peak rate.
// Two floors lie above it: the stacks leaving through two SMs (the
// stores alone, 2.3 us a step at 64 lanes: PERF.md) and one warp's
// serial share of the update.
// Design: the tile form (the REDNOSE_GENERIC_SCAN_STREAM tile section
// below; every variant the port ships): 32 lanes x W warps
// (entry_slab.TILE_ROLES_STREAM, 8, measured among 2-32: PERF.md) keep P,
// x and the scratch in shared memory and split each step over the warps;
// the inputs are staged a step ahead; the predicted state leaves the tile
// while one warp computes the update's shared values, the posterior while
// the next step's predict computes, as TMA tensor stores issued by one
// thread where the stacks' rows are 16-B aligned (a value a thread
// elsewhere, as at B = 1). The global form below (a variant whose tile
// does not fit; KernelCall.source(tile=False), the design before): one
// thread a lane and the T loop inside the kernel, x in registers, P in
// global memory (L1 / L2); 32 threads a block.

namespace rn_gen {

GEN_HD GEN_INLINE void stream_store(int t, int b, int B, const scalar_t* x,
                                    const scalar_t* P, scalar_t* xo,
                                    scalar_t* Po) {
  for (int i = 0; i < DX; ++i) xo[((size_t)t * DX + i) * B + b] = x[i];
  for (int e = 0; e < DE * DE; ++e)
    Po[((size_t)t * DE * DE + e) * B + b] = P[(size_t)e * B];
}

// One lane b through all T steps of the log.
GEN_HD GEN_INLINE void stream_filter(
    int b, int B, int T, scalar_t* xs, scalar_t* Ps, const scalar_t* zs,
    const scalar_t* eas, const scalar_t* dts, const int* kind_idx,
    const scalar_t* Rs, const scalar_t* prm, const scalar_t* Q,
    scalar_t* xp, scalar_t* Pp, scalar_t* xq, scalar_t* Pq) {
  scalar_t x[DX];
  for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * B + b];
  scalar_t* P = Ps + b;
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  for (int t = 0; t < T; ++t) {
    gen_predict(x, P, (size_t)B, dts[t], p, Q);
    stream_store(t, b, B, x, P, xp, Pp);
    const scalar_t* z = zs + (size_t)t * NZROWS * B + b;
    const scalar_t* ea =
        NEAROWS > 0 ? eas + (size_t)t * NEAROWS * B + b : nullptr;
#ifdef REDNOSE_STREAM_LANE_R
    // the lane form: Rs (T, NZROWS, NZROWS, B), R by lane
    gen_stream_update(x, P, (size_t)B, z, ea, (size_t)B, kind_idx[t],
                      Rs + (size_t)t * NZROWS * NZROWS * B + b, (size_t)B, p);
#else
    gen_stream_update(x, P, (size_t)B, z, ea, (size_t)B, kind_idx[t],
                      Rs + (size_t)t * NZROWS * NZROWS, p);
#endif
    stream_store(t, b, B, x, P, xq, Pq);
  }
  for (int i = 0; i < DX; ++i) xs[(size_t)i * B + b] = x[i];
}

}  // namespace rn_gen

#ifdef __CUDACC__

__global__ void rn_generic_stream_kernel(
    scalar_t* __restrict__ xs, scalar_t* __restrict__ Ps,
    const scalar_t* __restrict__ zs, const scalar_t* __restrict__ eas,
    const scalar_t* __restrict__ dts, const int* __restrict__ kind_idx,
    const scalar_t* __restrict__ Rs, const scalar_t* __restrict__ prm,
    const scalar_t* __restrict__ Q, scalar_t* __restrict__ xp,
    scalar_t* __restrict__ Pp, scalar_t* __restrict__ xq,
    scalar_t* __restrict__ Pq, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B)
    rn_gen::stream_filter(b, B, T, xs, Ps, zs, eas, dts, kind_idx, Rs, prm, Q,
                          xp, Pp, xq, Pq);
}

extern "C" int rn_generic_stream_launch(void* xs, void* Ps, const void* zs,
                                        const void* eas, const void* dts,
                                        const void* kind_idx, const void* Rs,
                                        const void* prm, const void* Q,
                                        void* xp, void* Pp, void* xq,
                                        void* Pq, int T, int B,
                                        void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  rn_generic_stream_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
      static_cast<const scalar_t*>(zs), static_cast<const scalar_t*>(eas),
      static_cast<const scalar_t*>(dts), static_cast<const int*>(kind_idx),
      static_cast<const scalar_t*>(Rs), static_cast<const scalar_t*>(prm),
      static_cast<const scalar_t*>(Q), static_cast<scalar_t*>(xp),
      static_cast<scalar_t*>(Pp), static_cast<scalar_t*>(xq),
      static_cast<scalar_t*>(Pq), T, B);
  return static_cast<int>(cudaGetLastError());
}

#define RN_GEN_KERNEL rn_generic_stream_kernel
#define RN_GEN_DESIGN 0
#define RN_GEN_ROLES 1
#define RN_GEN_SMEM 0

#else

// The host build (tests): the same emitted body, lane by lane.
extern "C" int rn_generic_stream_host(void* xs, void* Ps, const void* zs,
                                      const void* eas, const void* dts,
                                      const void* kind_idx, const void* Rs,
                                      const void* prm, const void* Q,
                                      void* xp, void* Pp, void* xq, void* Pq,
                                      int T, int B) {
  for (int b = 0; b < B; ++b)
    rn_gen::stream_filter(
        b, B, T, static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
        static_cast<const scalar_t*>(zs), static_cast<const scalar_t*>(eas),
        static_cast<const scalar_t*>(dts), static_cast<const int*>(kind_idx),
        static_cast<const scalar_t*>(Rs), static_cast<const scalar_t*>(prm),
        static_cast<const scalar_t*>(Q), static_cast<scalar_t*>(xp),
        static_cast<scalar_t*>(Pp), static_cast<scalar_t*>(xq),
        static_cast<scalar_t*>(Pq));
  return 0;
}

#endif  // __CUDACC__
#elif defined(REDNOSE_GENERIC_SCAN_TILE)

// Kernels 4, 6 and 7 in tile form (modes "single", "mixed" and "frame",
// when the tile fits): a block of 32 filters (lane = filter) and NROLES
// warps (role = warp). P, x and the update's NSCR
// scratch values of its 32 filters stay in the block's dynamic shared
// memory for the whole T loop, laid out [(value)][32] so a warp's 32 lanes
// touch 32 consecutive words; they are loaded once, coalesced, from the
// bank-minor arrays and stored once at the end. Each step runs in phases
// between barriers: every role computes its share of the predicted P (and
// role 0 the new x) into NVAL registers, barrier, every role stores its
// share, barrier; role 0 computes the update's shared values (gated gains,
// Joseph factor rows, dx) into the scratch (a camera frame: in stages,
// REDNOSE_GENERIC_SCAN_TILE_STAGES), barrier; every role computes
// its share of the updated P (role 0 the new x) from P and the scratch,
// barrier, stores, barrier. A lane past the bank (the last block of a
// ragged bank) computes on a copy of filter B - 1, reaches every barrier
// and stores nothing. A camera frame's update is the projected update and
// the window roll: each role computes its share of the rolled P (new
// (i, j) is the updated (old(i), old(j))) and role 0 the rolled x, all
// from the old values and the scratch, and stores them after the barrier,
// so the roll needs no copy of P. The emitted dispatchers gen_tile_*
// switch on the role, which is uniform across a warp; a mixed variant's
// update dispatchers (REDNOSE_GENERIC_SCAN_TILE_KINDS) switch first on the
// step's kind index ki = kind_idx[t], read once a step and uniform across
// the bank, so no warp diverges.

namespace rn_gen {
constexpr int TILE_LANES = 32;
constexpr int TILE_VALS = DE * DE + DX + NSCR;
}  // namespace rn_gen

// the update dispatchers' leading argument: the step's kind index for a
// mixed variant, none for a single one
#ifdef REDNOSE_GENERIC_SCAN_TILE_KINDS
#define RN_KI ki,
#define RN_KI_ONLY ki
#else
#define RN_KI
#define RN_KI_ONLY
#endif

// A variant with a camera frame (REDNOSE_GENERIC_SCAN_TILE_STAGES) computes
// the update's shared values in gen_tile_nstages(ki) stages instead of one
// role's gen_tile_shared: in each, every role runs gen_tile_stage (a
// serial stage on role 0 alone, storing into the scratch as it goes; a
// split stage on every role, its share into v), barrier, every role stores
// its share (gen_tile_stage_store), barrier. A stage reads what earlier
// stages stored; a slot is reused once no later stage reads its value.

#if defined(REDNOSE_GENERIC_SCAN_TILE_EPOCH) || defined(REDNOSE_GENERIC_SCAN_STREAM)

// The inputs of kernels 5 and 9, staged in shared memory a step ahead
// (the tile sections below).

namespace rn_gen {
constexpr int IN_ROWS = NZROWS + NEAROWS;  // one step's staged input rows
}  // namespace rn_gen

#ifdef __CUDACC__

__device__ __forceinline__ void rn_cp_async(void* dst, const void* src,
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

// Step t's input rows of the block's filters b0.. into in ([row][32]),
// asynchronously; the caller commits the group.
__device__ __forceinline__ void rn_stage_inputs(
    scalar_t* in, const scalar_t* zs, const scalar_t* eas, int t, int B,
    int b0, int tid, bool whole) {
  using namespace rn_gen;
  constexpr int NTHR = TILE_LANES * NROLES;
  constexpr int V = 16 / (int)sizeof(scalar_t);  // values a 16-B copy moves
  constexpr int PIECES = TILE_LANES / V;          // 16-B copies a row
  const scalar_t* zt = zs + (size_t)t * NZROWS * B;
  const scalar_t* et = NEAROWS > 0 ? eas + (size_t)t * NEAROWS * B : zt;
  if (whole) {
    for (int c = tid; c < IN_ROWS * PIECES; c += NTHR) {
      const int row = c / PIECES, col = (c % PIECES) * V;
      const scalar_t* src = row < NZROWS ? zt + (size_t)row * B
                                         : et + (size_t)(row - NZROWS) * B;
      rn_cp_async(in + row * TILE_LANES + col, src + b0 + col, 16);
    }
  } else {
    for (int c = tid; c < IN_ROWS * TILE_LANES; c += NTHR) {
      const int row = c / TILE_LANES, b = min(b0 + c % TILE_LANES, B - 1);
      const scalar_t* src = row < NZROWS ? zt + (size_t)row * B
                                         : et + (size_t)(row - NZROWS) * B;
      rn_cp_async(in + c, src + b, (int)sizeof(scalar_t));
    }
  }
}

#endif  // __CUDACC__
#endif  // REDNOSE_GENERIC_SCAN_TILE_EPOCH, REDNOSE_GENERIC_SCAN_STREAM

#if defined(REDNOSE_GENERIC_SCAN_STREAM)

// Kernel 9 in tile form (mode "stream", when its tile fits: every variant
// the port ships; see the kernel 9 section at the top for what a step
// computes and what bounds it). A block of 32 lanes x NROLES warps keeps
// P, x and the update's scratch in shared memory for the whole T loop, the
// tile loop above with the kinds switched on the step's kind index (read
// once a step from the staged inputs, uniform across the bank, so no warp
// diverges). A step:
// - inputs: at the top of step t the block copies step t + 1's z and ea
//   rows ([row][32]), its R (the step's NZROWS x NZROWS Rs[t]; each unit
//   reads its leading dz x dz block), dts[t + 1] and kind_idx[t + 1] into
//   the other half of a double buffer with cp.async; it waits for them
//   before the update's barrier, so they have the whole step to land;
// - predict: every role computes its share into registers, barrier,
//   stores it to the tile, barrier;
// - predicted stacks: xp[t] and Pp[t] leave the tile while role 0
//   computes the update's shared values (gen_tile_shared); neither writes
//   what the other reads, so the barrier after the shared function is the
//   only one;
// - update: every role its share, barrier, stores, barrier;
// - posterior stacks: xq[t] and Pq[t] leave the tile while the next step's
//   predict computes, which only reads the tile until its own barrier.
// A stack's rows of a step are the tile's rows as they lie, [value][32].
// Where the stacks' rows are 16-B aligned (B a multiple of 16 /
// sizeof(scalar_t)), one thread issues them as two TMA tensor stores a
// stack and waits for the TMA to have read the tile (wait_group.read)
// before the barrier after which the tile is next written; every thread
// fences its tile writes to the TMA (fence.proxy.async) before the barrier
// ahead of the stores. Elsewhere (the refinement log's B = 1) the threads
// store them a value each (rn_stream_store): the predicted state every
// warp but role 0's, the posterior every warp. A lane past the bank
// computes on a copy of lane B - 1, reaches every barrier and stores
// nothing.

namespace rn_gen {
constexpr int IN_R = NZROWS * NZROWS;     // one step's staged R
constexpr int STACK_ROWS = DE * DE + DX;  // a stack's rows a step: P, then x
static_assert(NROLES > 1, "the predicted state leaves the tile from the "
              "warps other than role 0's");
}  // namespace rn_gen

#ifdef __CUDACC__

#include <cuda.h>  // CUtensorMap

// The block's tile rows (P's entries, then x's) of its nb lanes in the
// bank (nb = min(32, B - b0)) into step t's rows of the stacks xo (T, DX,
// B) and Po (T, DE, DE, B), a value a thread, the threads c0, c0 + nc, ...
// taking the (row, lane) pairs c = e * nb + l in turn: the stores where
// the stacks' rows are not 16-B aligned (TMA's rule). A warp stores one
// row of 32 lanes, or at B = 1 the one lane's 32 consecutive rows, a
// coalesced line either way.
__device__ __forceinline__ void rn_stream_store(
    const scalar_t* tile, scalar_t* xo, scalar_t* Po, int t, int B, int b0,
    int nb, int c0, int nc) {
  using namespace rn_gen;
  for (int c = c0; c < STACK_ROWS * nb; c += nc) {
    const int e = nb == TILE_LANES ? c / TILE_LANES : c / nb;
    const int l = c - e * nb;
    const scalar_t v = tile[e * TILE_LANES + l];
    if (e < DE * DE)
      Po[((size_t)t * DE * DE + e) * B + b0 + l] = v;
    else
      xo[((size_t)t * DX + e - DE * DE) * B + b0 + l] = v;
  }
}

// Step t's rows of the tile (P's DE x DE, then x's DX) into the stacks
// with two TMA tensor stores issued by one thread, bulk group committed:
// tP views Po (T, DE, DE, B) as (B, DE, T * DE), tx views xo (T, DX, B) as
// (B, DX, T), each box 32 lanes x one step's rows, the tile's [value][32]
// rows as they lie; the hardware clips a ragged block's lanes past B. The
// caller waits (wait_group.read) before the tile is next written.
__device__ __forceinline__ void rn_stream_store_tma(const CUtensorMap* tx,
                                                    const CUtensorMap* tP,
                                                    const scalar_t* tile,
                                                    int t, int b0) {
  using namespace rn_gen;
  const unsigned sP = static_cast<unsigned>(__cvta_generic_to_shared(tile));
  const unsigned sx = static_cast<unsigned>(
      __cvta_generic_to_shared(tile + DE * DE * TILE_LANES));
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(tP), "r"(b0), "r"(0),
      "r"(t * DE), "r"(sP) : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3}], [%4];\n" ::"l"(tx), "r"(b0), "r"(0), "r"(t),
      "r"(sx) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Step t's inputs into buffer half h: the z and ea rows (rn_stage_inputs),
// R, dt and the kind index; the caller commits the group.
__device__ __forceinline__ void rn_stream_stage(
    scalar_t* in, scalar_t* rin, scalar_t* dtin, int* kin, const scalar_t* zs,
    const scalar_t* eas, const scalar_t* Rs, const scalar_t* dts,
    const int* kind_idx, int t, int h, int B, int b0, int tid, bool whole) {
  using namespace rn_gen;
  constexpr int NTHR = TILE_LANES * NROLES;
  rn_stage_inputs(in + h * IN_ROWS * TILE_LANES, zs, eas, t, B, b0, tid,
                  whole);
  for (int c = tid; c < IN_R; c += NTHR)
    rn_cp_async(rin + h * IN_R + c, Rs + (size_t)t * IN_R + c,
                (int)sizeof(scalar_t));
  if (tid == NTHR - 1) {
    rn_cp_async(dtin + h, dts + t, (int)sizeof(scalar_t));
    rn_cp_async(kin + h, kind_idx + t, 4);
  }
}

__global__ void __launch_bounds__(rn_gen::TILE_LANES * rn_gen::NROLES)
rn_generic_stream_tile_kernel(
    scalar_t* __restrict__ xs, scalar_t* __restrict__ Ps,
    const scalar_t* __restrict__ zs, const scalar_t* __restrict__ eas,
    const scalar_t* __restrict__ dts, const int* __restrict__ kind_idx,
    const scalar_t* __restrict__ Rs, const scalar_t* __restrict__ prm,
    const scalar_t* __restrict__ Q, scalar_t* __restrict__ xp,
    scalar_t* __restrict__ Pp, scalar_t* __restrict__ xq,
    scalar_t* __restrict__ Pq, const __grid_constant__ CUtensorMap tm_xp,
    const __grid_constant__ CUtensorMap tm_Pp,
    const __grid_constant__ CUtensorMap tm_xq,
    const __grid_constant__ CUtensorMap tm_Pq, int tma, int T, int B) {
  using namespace rn_gen;
  // a TMA box's rows start 128-B aligned: the tile's rows of 32 lanes
  extern __shared__ __align__(128) unsigned char rn_tile[];
  scalar_t* Pt = reinterpret_cast<scalar_t*>(rn_tile);
  scalar_t* xt = Pt + DE * DE * TILE_LANES;
  scalar_t* st = xt + DX * TILE_LANES;
  scalar_t* in = st + NSCR * TILE_LANES;          // 2 x IN_ROWS x 32
  scalar_t* rin = in + 2 * IN_ROWS * TILE_LANES;  // 2 x IN_R
  scalar_t* dtin = rin + 2 * IN_R;                // 2
  int* kin = reinterpret_cast<int*>(dtin + 2);    // 2, in 2 values' room
  const int lane = threadIdx.x, role = threadIdx.y;
  const int tid = role * TILE_LANES + lane;
  const int b0 = blockIdx.x * TILE_LANES, b = b0 + lane;
  const int bc = b < B ? b : B - 1;
  const int nb = min(TILE_LANES, B - b0);  // the block's lanes in the bank
  // the thread that issues the TMA stores: lane 0 of the last warp (its
  // warp stays clear of role 0's shared function)
  const bool issuer = tma && tid == TILE_LANES * (NROLES - 1);
  constexpr int V = 16 / (int)sizeof(scalar_t);
  const bool whole =
      b0 + TILE_LANES <= B && B % V == 0 &&
      reinterpret_cast<size_t>(zs) % 16 == 0 &&
      (NEAROWS == 0 || reinterpret_cast<size_t>(eas) % 16 == 0);
  rn_stream_stage(in, rin, dtin, kin, zs, eas, Rs, dts, kind_idx, 0, 0, B, b0,
                  tid, whole);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = role; e < DE * DE; e += NROLES)
    Pt[e * TILE_LANES + lane] = Ps[(size_t)e * B + bc];
  for (int i = role; i < DX; i += NROLES)
    xt[i * TILE_LANES + lane] = xs[(size_t)i * B + bc];
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  scalar_t* P = Pt + lane;
  scalar_t* x = xt + lane;
  scalar_t* s = st + lane;
  const size_t ld = TILE_LANES;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int h = t & 1;
    if (t + 1 < T)
      rn_stream_stage(in, rin, dtin, kin, zs, eas, Rs, dts, kind_idx, t + 1,
                      h ^ 1, B, b0, tid, whole);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const scalar_t dt = dtin[h];
    const int ki = kin[h];
    const scalar_t* z = in + h * IN_ROWS * TILE_LANES + lane;
    const scalar_t* ea = z + NZROWS * TILE_LANES;
    const scalar_t* R = rin + h * IN_R;
    scalar_t v[NVAL];
    gen_tile_predict(role, x, P, ld, dt, p, Q, v);
    // the last step's posterior store has read the tile
    if (issuer) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
    gen_tile_predict_store(role, x, P, ld, v);
    // this thread's tile writes, seen by the TMA (async proxy)
    if (tma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (role == 0) gen_tile_shared(ki, x, P, ld, z, ea, ld, R, p, s);
    if (tma) {
      if (issuer) rn_stream_store_tma(&tm_xp, &tm_Pp, Pt, t, b0);
    } else if (role > 0) {
      rn_stream_store(Pt, xp, Pp, t, B, b0, nb, tid - TILE_LANES,
                      TILE_LANES * (NROLES - 1));
    }
    __syncthreads();
    gen_tile_update(ki, role, x, P, ld, z, ea, ld, R, p, s, v);
    if (issuer) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    gen_tile_update_store(ki, role, x, P, ld, v);
    if (tma) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tma) {
      if (issuer) rn_stream_store_tma(&tm_xq, &tm_Pq, Pt, t, b0);
    } else {
      rn_stream_store(Pt, xq, Pq, t, B, b0, nb, tid, TILE_LANES * NROLES);
    }
  }
  // the last stores done before the block's shared memory goes
  if (issuer) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  if (b < B) {
    for (int e = role; e < DE * DE; e += NROLES)
      Ps[(size_t)e * B + b] = Pt[e * TILE_LANES + lane];
    for (int i = role; i < DX; i += NROLES)
      xs[(size_t)i * B + b] = xt[i * TILE_LANES + lane];
  }
}

static const int rn_tile_smem =
    (int)sizeof(scalar_t) *
    (rn_gen::TILE_LANES * rn_gen::TILE_VALS +
     2 * (rn_gen::IN_ROWS * rn_gen::TILE_LANES + rn_gen::IN_R + 2));

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// libcuda)
typedef CUresult (*rn_encode_tiled_t)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static rn_encode_tiled_t rn_encode_tiled() {
  static rn_encode_tiled_t fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<rn_encode_tiled_t>(p);
  }
  return fn;
}

// The tensor map of a stack (T, n1, n2, B) of values bank-minor, as (B, n2,
// T * n1) with a box of 32 lanes x n2 x n1: one step's rows (a P stack: n1
// = n2 = DE; an x stack: n1 = 1, n2 = DX).
static int rn_stack_map(CUtensorMap* m, void* base, int T, int n1, int n2,
                        int B) {
  rn_encode_tiled_t encode = rn_encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)n2,
                              (cuuint64_t)T * n1};
  const cuuint64_t strides[2] = {(cuuint64_t)B * sizeof(scalar_t),
                                 (cuuint64_t)n2 * B * sizeof(scalar_t)};
  const cuuint32_t box[3] = {(cuuint32_t)rn_gen::TILE_LANES, (cuuint32_t)n2,
                             (cuuint32_t)n1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      m, sizeof(scalar_t) == 8 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT64
                               : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, base, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rn_generic_stream_launch(void* xs, void* Ps, const void* zs,
                                        const void* eas, const void* dts,
                                        const void* kind_idx, const void* Rs,
                                        const void* prm, const void* Q,
                                        void* xp, void* Pp, void* xq,
                                        void* Pq, int T, int B,
                                        void* stream) {
  using rn_gen::DE;
  using rn_gen::DX;
  cudaError_t e = cudaFuncSetAttribute(
      rn_generic_stream_tile_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, rn_tile_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // TMA stores where every stack row is 16-B aligned (the tensor map's
  // rule): B a multiple of 16 / sizeof(scalar_t), aligned stacks; a map
  // takes no empty log
  const bool tma =
      T > 0 && (B * sizeof(scalar_t)) % 16 == 0 &&
      ((reinterpret_cast<size_t>(xp) | reinterpret_cast<size_t>(Pp) |
        reinterpret_cast<size_t>(xq) | reinterpret_cast<size_t>(Pq)) %
       16) == 0;
  CUtensorMap maps[4] = {};  // xp, Pp, xq, Pq
  if (tma) {
    void* stacks[4] = {xp, Pp, xq, Pq};
    for (int k = 0; k < 4; ++k) {
      const int code = rn_stack_map(&maps[k], stacks[k], T, k % 2 ? DE : 1,
                                    k % 2 ? DE : DX, B);
      if (code != 0) return code;
    }
  }
  const int blocks = (B + rn_gen::TILE_LANES - 1) / rn_gen::TILE_LANES;
  rn_generic_stream_tile_kernel<<<blocks,
                                  dim3(rn_gen::TILE_LANES, rn_gen::NROLES),
                                  rn_tile_smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
      static_cast<const scalar_t*>(zs), static_cast<const scalar_t*>(eas),
      static_cast<const scalar_t*>(dts), static_cast<const int*>(kind_idx),
      static_cast<const scalar_t*>(Rs), static_cast<const scalar_t*>(prm),
      static_cast<const scalar_t*>(Q), static_cast<scalar_t*>(xp),
      static_cast<scalar_t*>(Pp), static_cast<scalar_t*>(xq),
      static_cast<scalar_t*>(Pq), maps[0], maps[1], maps[2], maps[3],
      tma ? 1 : 0, T, B);
  return static_cast<int>(cudaGetLastError());
}

#define RN_GEN_KERNEL rn_generic_stream_tile_kernel
#define RN_GEN_DESIGN 1
#define RN_GEN_ROLES rn_gen::NROLES
#define RN_GEN_SMEM rn_tile_smem

#else

// The host build of the log-scan tile (tests): lane by lane, a copy of its
// P, x and scratch (ld = 1) and of each step's input rows (ld_in = 1),
// each phase in barrier order, as the tile loop above; the stacks stored
// after the predict and after the update.
extern "C" int rn_generic_stream_host(void* xs_, void* Ps_, const void* zs_,
                                      const void* eas_, const void* dts_,
                                      const void* kind_idx_, const void* Rs_,
                                      const void* prm, const void* Q_,
                                      void* xp_, void* Pp_, void* xq_,
                                      void* Pq_, int T, int B) {
  using namespace rn_gen;
  scalar_t* xs = static_cast<scalar_t*>(xs_);
  scalar_t* Ps = static_cast<scalar_t*>(Ps_);
  const scalar_t* zs = static_cast<const scalar_t*>(zs_);
  const scalar_t* eas = static_cast<const scalar_t*>(eas_);
  const scalar_t* dts = static_cast<const scalar_t*>(dts_);
  const int* kind_idx = static_cast<const int*>(kind_idx_);
  const scalar_t* Rs = static_cast<const scalar_t*>(Rs_);
  const scalar_t* Q = static_cast<const scalar_t*>(Q_);
  scalar_t* stacks[2][2] = {{static_cast<scalar_t*>(xp_),
                             static_cast<scalar_t*>(Pp_)},
                            {static_cast<scalar_t*>(xq_),
                             static_cast<scalar_t*>(Pq_)}};
  for (int b = 0; b < B; ++b) {
    scalar_t x[DX], P[DE * DE], s[NSCR > 0 ? NSCR : 1], in[IN_ROWS];
    scalar_t v[NROLES][NVAL];
    for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * B + b];
    for (int e = 0; e < DE * DE; ++e) P[e] = Ps[(size_t)e * B + b];
    scalar_t p[NP > 0 ? NP : 1];
    for (int i = 0; i < NP; ++i) p[i] = static_cast<const scalar_t*>(prm)[i];
    auto store = [&](int t, scalar_t* const* xo_Po) {
      for (int e = 0; e < DE * DE; ++e)
        xo_Po[1][((size_t)t * DE * DE + e) * B + b] = P[e];
      for (int i = 0; i < DX; ++i)
        xo_Po[0][((size_t)t * DX + i) * B + b] = x[i];
    };
    for (int t = 0; t < T; ++t) {
      const int ki = kind_idx[t];
      for (int r = 0; r < NZROWS; ++r)
        in[r] = zs[((size_t)t * NZROWS + r) * B + b];
      for (int r = 0; r < NEAROWS; ++r)
        in[NZROWS + r] = eas[((size_t)t * NEAROWS + r) * B + b];
      const scalar_t* R = Rs + (size_t)t * IN_R;
      for (int r = 0; r < NROLES; ++r)
        gen_tile_predict(r, x, P, 1, dts[t], p, Q, v[r]);
      for (int r = 0; r < NROLES; ++r) gen_tile_predict_store(r, x, P, 1, v[r]);
      store(t, stacks[0]);
      gen_tile_shared(ki, x, P, 1, in, in + NZROWS, 1, R, p, s);
      for (int r = 0; r < NROLES; ++r)
        gen_tile_update(ki, r, x, P, 1, in, in + NZROWS, 1, R, p, s, v[r]);
      for (int r = 0; r < NROLES; ++r)
        gen_tile_update_store(ki, r, x, P, 1, v[r]);
      store(t, stacks[1]);
    }
    for (int i = 0; i < DX; ++i) xs[(size_t)i * B + b] = x[i];
    for (int e = 0; e < DE * DE; ++e) Ps[(size_t)e * B + b] = P[e];
  }
  return 0;
}

#endif  // __CUDACC__

#elif defined(REDNOSE_GENERIC_SCAN_TILE_EPOCH)

// Kernel 5 in tile form (mode "epoch", when the tile fits): the tile loop
// above with each step's slots in order, each step's inputs staged in
// shared memory a step ahead. A step is the predict (every role computes,
// barrier, stores, barrier), then for each slot k of the slot table
// gen_slot(k): role 0 runs its unit's shared function into the scratch,
// barrier, every role its share of the update, barrier, stores, barrier
// (a loc slot's shared values are too few to split across the warps in
// stages as a camera frame's: measured slower at every W; PERF.md).
// The inputs do not depend on the state: at the top of step t the block
// copies step t + 1's NZROWS + NEAROWS rows of its 32 filters into the
// other half of a double buffer ([row][32] each) with cp.async, 16 B a
// thread where every row of the block is whole and 16-B aligned (else one
// value a thread, a lane past the bank copying filter B - 1), and waits
// for step t's copies before the predict's barrier. The units read their
// rows there (ld_in = 32) in place of 8 dependent global loads a step.

#ifdef __CUDACC__

__global__ void __launch_bounds__(rn_gen::TILE_LANES * rn_gen::NROLES)
rn_generic_epoch_kernel(
    scalar_t* __restrict__ xs, scalar_t* __restrict__ Ps,
    const scalar_t* __restrict__ zs, const scalar_t* __restrict__ eas,
    const scalar_t* __restrict__ dts, const scalar_t* __restrict__ pss,
    const scalar_t* __restrict__ prm, const scalar_t* __restrict__ Q,
    const scalar_t* __restrict__ R, int T, int B) {
  using namespace rn_gen;
  extern __shared__ __align__(16) unsigned char rn_tile[];
  scalar_t* Pt = reinterpret_cast<scalar_t*>(rn_tile);
  scalar_t* xt = Pt + DE * DE * TILE_LANES;
  scalar_t* st = xt + DX * TILE_LANES;
  scalar_t* in = st + NSCR * TILE_LANES;  // 2 x IN_ROWS x 32
  const int lane = threadIdx.x, role = threadIdx.y;
  const int tid = role * TILE_LANES + lane;
  const int b0 = blockIdx.x * TILE_LANES, b = b0 + lane;
  const int bc = b < B ? b : B - 1;
  constexpr int V = 16 / (int)sizeof(scalar_t);
  const bool whole =
      b0 + TILE_LANES <= B && B % V == 0 &&
      reinterpret_cast<size_t>(zs) % 16 == 0 &&
      (NEAROWS == 0 || reinterpret_cast<size_t>(eas) % 16 == 0);
  rn_stage_inputs(in, zs, eas, 0, B, b0, tid, whole);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = role; e < DE * DE; e += NROLES)
    Pt[e * TILE_LANES + lane] = Ps[(size_t)e * B + bc];
  for (int i = role; i < DX; i += NROLES)
    xt[i * TILE_LANES + lane] = xs[(size_t)i * B + bc];
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  scalar_t* P = Pt + lane;
  scalar_t* x = xt + lane;
  scalar_t* s = st + lane;
  const size_t ld = TILE_LANES;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    // step t + 1's inputs into the other buffer while step t runs (an
    // empty group at the last step, so step t's is always the second
    // newest)
    if (t + 1 < T)
      rn_stage_inputs(in + ((t + 1) & 1) * IN_ROWS * TILE_LANES, zs, eas,
                      t + 1, B, b0, tid, whole);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = 0; i < NPS; ++i) p[ps_idx(i)] = pss[(size_t)t * NPS + i];
    const scalar_t dt = dts[t];
    scalar_t v[NVAL];
    gen_tile_predict(role, x, P, ld, dt, p, Q, v);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    gen_tile_predict_store(role, x, P, ld, v);
    __syncthreads();
    const scalar_t* zt = in + (t & 1) * IN_ROWS * TILE_LANES + lane;
    // not unrolled: one copy of each unit's code, switched on the slot's
    // unit (unrolled, loc's 8 slots are ~8 copies of a unit in every step,
    // and instruction fetch set the pace: 1.3x slower in float32, 1.5x in
    // double; PERF.md)
#pragma unroll 1
    for (int k = 0; k < NSLOTS; ++k) {
      const GenSlot sl = gen_slot(k);
      const scalar_t* z = zt + sl.zrow * TILE_LANES;
      const scalar_t* ea = zt + (NZROWS + sl.earow) * TILE_LANES;
      if (role == 0)
        gen_tile_shared(sl.unit, x, P, ld, z, ea, ld, R + sl.roff, p, s);
      __syncthreads();
      gen_tile_update(sl.unit, role, x, P, ld, z, ea, ld, R + sl.roff, p, s,
                      v);
      __syncthreads();
      gen_tile_update_store(sl.unit, role, x, P, ld, v);
      __syncthreads();
    }
  }
  if (b < B) {
    for (int e = role; e < DE * DE; e += NROLES)
      Ps[(size_t)e * B + b] = Pt[e * TILE_LANES + lane];
    for (int i = role; i < DX; i += NROLES)
      xs[(size_t)i * B + b] = xt[i * TILE_LANES + lane];
  }
}

static const int rn_tile_smem =
    (int)sizeof(scalar_t) * rn_gen::TILE_LANES *
    (rn_gen::TILE_VALS + 2 * rn_gen::IN_ROWS);

extern "C" int rn_generic_scan_launch(void* xs, void* Ps, const void* zs,
                                      const void* eas, const void* dts,
                                      const void* kind_idx, const void* pss,
                                      const void* prm, const void* Q,
                                      const void* R, int T, int B,
                                      void* stream) {
  (void)kind_idx;
  cudaError_t e = cudaFuncSetAttribute(
      rn_generic_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rn_tile_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + rn_gen::TILE_LANES - 1) / rn_gen::TILE_LANES;
  rn_generic_epoch_kernel<<<blocks, dim3(rn_gen::TILE_LANES, rn_gen::NROLES),
                            rn_tile_smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
      static_cast<const scalar_t*>(zs), static_cast<const scalar_t*>(eas),
      static_cast<const scalar_t*>(dts), static_cast<const scalar_t*>(pss),
      static_cast<const scalar_t*>(prm), static_cast<const scalar_t*>(Q),
      static_cast<const scalar_t*>(R), T, B);
  return static_cast<int>(cudaGetLastError());
}

#define RN_GEN_KERNEL rn_generic_epoch_kernel
#define RN_GEN_DESIGN 1
#define RN_GEN_ROLES rn_gen::NROLES
#define RN_GEN_SMEM rn_tile_smem

#else

// The host build of the epoch tile (tests): filter by filter, a copy of its
// P, x and scratch (ld = 1) and of each step's input rows (ld_in = 1), each
// phase in barrier order, as the tile loop above.
extern "C" int rn_generic_scan_host(void* xs_, void* Ps_, const void* zs_,
                                    const void* eas_, const void* dts_,
                                    const void* kind_idx, const void* pss_,
                                    const void* prm, const void* Q_,
                                    const void* R_, int T, int B) {
  using namespace rn_gen;
  (void)kind_idx;
  scalar_t* xs = static_cast<scalar_t*>(xs_);
  scalar_t* Ps = static_cast<scalar_t*>(Ps_);
  const scalar_t* zs = static_cast<const scalar_t*>(zs_);
  const scalar_t* eas = static_cast<const scalar_t*>(eas_);
  const scalar_t* dts = static_cast<const scalar_t*>(dts_);
  const scalar_t* pss = static_cast<const scalar_t*>(pss_);
  const scalar_t* Q = static_cast<const scalar_t*>(Q_);
  const scalar_t* R = static_cast<const scalar_t*>(R_);
  for (int b = 0; b < B; ++b) {
    scalar_t x[DX], P[DE * DE], s[NSCR > 0 ? NSCR : 1], in[IN_ROWS];
    scalar_t v[NROLES][NVAL];
    for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * B + b];
    for (int e = 0; e < DE * DE; ++e) P[e] = Ps[(size_t)e * B + b];
    scalar_t p[NP > 0 ? NP : 1];
    for (int i = 0; i < NP; ++i) p[i] = static_cast<const scalar_t*>(prm)[i];
    for (int t = 0; t < T; ++t) {
      for (int r = 0; r < NZROWS; ++r)
        in[r] = zs[((size_t)t * NZROWS + r) * B + b];
      for (int r = 0; r < NEAROWS; ++r)
        in[NZROWS + r] = eas[((size_t)t * NEAROWS + r) * B + b];
      for (int i = 0; i < NPS; ++i) p[ps_idx(i)] = pss[(size_t)t * NPS + i];
      for (int r = 0; r < NROLES; ++r)
        gen_tile_predict(r, x, P, 1, dts[t], p, Q, v[r]);
      for (int r = 0; r < NROLES; ++r) gen_tile_predict_store(r, x, P, 1, v[r]);
      for (int k = 0; k < NSLOTS; ++k) {
        const GenSlot sl = gen_slot(k);
        const scalar_t* z = in + sl.zrow;
        const scalar_t* ea = in + NZROWS + sl.earow;
        gen_tile_shared(sl.unit, x, P, 1, z, ea, 1, R + sl.roff, p, s);
        for (int r = 0; r < NROLES; ++r)
          gen_tile_update(sl.unit, r, x, P, 1, z, ea, 1, R + sl.roff, p, s,
                          v[r]);
        for (int r = 0; r < NROLES; ++r)
          gen_tile_update_store(sl.unit, r, x, P, 1, v[r]);
      }
    }
    for (int i = 0; i < DX; ++i) xs[(size_t)i * B + b] = x[i];
    for (int e = 0; e < DE * DE; ++e) Ps[(size_t)e * B + b] = P[e];
  }
  return 0;
}

#endif  // __CUDACC__
#elif defined(__CUDACC__)

__global__ void __launch_bounds__(rn_gen::TILE_LANES * rn_gen::NROLES)
rn_generic_tile_kernel(
    scalar_t* __restrict__ xs, scalar_t* __restrict__ Ps,
    const scalar_t* __restrict__ zs, const scalar_t* __restrict__ eas,
    const scalar_t* __restrict__ dts, const int* __restrict__ kind_idx,
    const scalar_t* __restrict__ pss, const scalar_t* __restrict__ prm,
    const scalar_t* __restrict__ Q, const scalar_t* __restrict__ R, int T,
    int B) {
  using namespace rn_gen;
  extern __shared__ __align__(16) unsigned char rn_tile[];
  scalar_t* Pt = reinterpret_cast<scalar_t*>(rn_tile);
  scalar_t* xt = Pt + DE * DE * TILE_LANES;
  scalar_t* st = xt + DX * TILE_LANES;
  const int lane = threadIdx.x, role = threadIdx.y;
  const int b = blockIdx.x * TILE_LANES + lane;
  const int bc = b < B ? b : B - 1;
  for (int e = role; e < DE * DE; e += NROLES)
    Pt[e * TILE_LANES + lane] = Ps[(size_t)e * B + bc];
  for (int i = role; i < DX; i += NROLES)
    xt[i * TILE_LANES + lane] = xs[(size_t)i * B + bc];
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  scalar_t* P = Pt + lane;
  scalar_t* x = xt + lane;
  scalar_t* s = st + lane;
  const size_t ld = TILE_LANES;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < NPS; ++i) p[ps_idx(i)] = pss[(size_t)t * NPS + i];
    const scalar_t dt = dts[t];
    const scalar_t* z = zs + (size_t)t * NZROWS * B + bc;
    const scalar_t* ea =
        NEAROWS > 0 ? eas + (size_t)t * NEAROWS * B + bc : nullptr;
#ifdef REDNOSE_GENERIC_SCAN_TILE_KINDS
    const int ki = __ldg(kind_idx + t);
#endif
    scalar_t v[NVAL];
    gen_tile_predict(role, x, P, ld, dt, p, Q, v);
    __syncthreads();
    gen_tile_predict_store(role, x, P, ld, v);
    __syncthreads();
#ifdef REDNOSE_GENERIC_SCAN_TILE_STAGES
    for (int g = 0; g < gen_tile_nstages(RN_KI_ONLY); ++g) {
      gen_tile_stage(RN_KI g, role, x, P, ld, z, ea, (size_t)B, R, p, s, v);
      __syncthreads();
      gen_tile_stage_store(RN_KI g, role, s, ld, v);
      __syncthreads();
    }
#else
    if (role == 0) gen_tile_shared(RN_KI x, P, ld, z, ea, (size_t)B, R, p, s);
    __syncthreads();
#endif
    gen_tile_update(RN_KI role, x, P, ld, z, ea, (size_t)B, R, p, s, v);
    __syncthreads();
    gen_tile_update_store(RN_KI role, x, P, ld, v);
    __syncthreads();
  }
  if (b < B) {
    for (int e = role; e < DE * DE; e += NROLES)
      Ps[(size_t)e * B + b] = Pt[e * TILE_LANES + lane];
    for (int i = role; i < DX; i += NROLES)
      xs[(size_t)i * B + b] = xt[i * TILE_LANES + lane];
  }
}

static const int rn_tile_smem =
    (int)sizeof(scalar_t) * rn_gen::TILE_LANES * rn_gen::TILE_VALS;

extern "C" int rn_generic_scan_launch(void* xs, void* Ps, const void* zs,
                                      const void* eas, const void* dts,
                                      const void* kind_idx, const void* pss,
                                      const void* prm, const void* Q,
                                      const void* R, int T, int B,
                                      void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      rn_generic_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      rn_tile_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + rn_gen::TILE_LANES - 1) / rn_gen::TILE_LANES;
  rn_generic_tile_kernel<<<blocks, dim3(rn_gen::TILE_LANES, rn_gen::NROLES),
                           rn_tile_smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
      static_cast<const scalar_t*>(zs), static_cast<const scalar_t*>(eas),
      static_cast<const scalar_t*>(dts), static_cast<const int*>(kind_idx),
      static_cast<const scalar_t*>(pss),
      static_cast<const scalar_t*>(prm), static_cast<const scalar_t*>(Q),
      static_cast<const scalar_t*>(R), T, B);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape as the runtime reads it (rn_generic_scan_info below)
#define RN_GEN_KERNEL rn_generic_tile_kernel
#define RN_GEN_DESIGN 1
#define RN_GEN_ROLES rn_gen::NROLES
#define RN_GEN_SMEM rn_tile_smem

#else

// The host build of the tile form (tests): filter by filter, a copy of its
// P, x and scratch (ld = 1), each phase in barrier order: every role
// computes, then every role stores.
extern "C" int rn_generic_scan_host(void* xs_, void* Ps_, const void* zs_,
                                    const void* eas_, const void* dts_,
                                    const void* kind_idx, const void* pss_,
                                    const void* prm, const void* Q_,
                                    const void* R_, int T, int B) {
  using namespace rn_gen;
  scalar_t* xs = static_cast<scalar_t*>(xs_);
  scalar_t* Ps = static_cast<scalar_t*>(Ps_);
  const scalar_t* zs = static_cast<const scalar_t*>(zs_);
  const scalar_t* eas = static_cast<const scalar_t*>(eas_);
  const scalar_t* dts = static_cast<const scalar_t*>(dts_);
  const scalar_t* pss = static_cast<const scalar_t*>(pss_);
  const scalar_t* Q = static_cast<const scalar_t*>(Q_);
  const scalar_t* R = static_cast<const scalar_t*>(R_);
  for (int b = 0; b < B; ++b) {
    scalar_t x[DX], P[DE * DE], s[NSCR > 0 ? NSCR : 1];
    scalar_t v[NROLES][NVAL];
    for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * B + b];
    for (int e = 0; e < DE * DE; ++e) P[e] = Ps[(size_t)e * B + b];
    scalar_t p[NP > 0 ? NP : 1];
    for (int i = 0; i < NP; ++i) p[i] = static_cast<const scalar_t*>(prm)[i];
    for (int t = 0; t < T; ++t) {
      for (int i = 0; i < NPS; ++i) p[ps_idx(i)] = pss[(size_t)t * NPS + i];
      const scalar_t* z = zs + (size_t)t * NZROWS * B + b;
      const scalar_t* ea =
          NEAROWS > 0 ? eas + (size_t)t * NEAROWS * B + b : nullptr;
#ifdef REDNOSE_GENERIC_SCAN_TILE_KINDS
      const int ki = static_cast<const int*>(kind_idx)[t];
#else
      (void)kind_idx;
#endif
      for (int r = 0; r < NROLES; ++r)
        gen_tile_predict(r, x, P, 1, dts[t], p, Q, v[r]);
      for (int r = 0; r < NROLES; ++r) gen_tile_predict_store(r, x, P, 1, v[r]);
#ifdef REDNOSE_GENERIC_SCAN_TILE_STAGES
      for (int g = 0; g < gen_tile_nstages(RN_KI_ONLY); ++g) {
        for (int r = 0; r < NROLES; ++r)
          gen_tile_stage(RN_KI g, r, x, P, 1, z, ea, (size_t)B, R, p, s,
                         v[r]);
        for (int r = 0; r < NROLES; ++r)
          gen_tile_stage_store(RN_KI g, r, s, 1, v[r]);
      }
#else
      gen_tile_shared(RN_KI x, P, 1, z, ea, (size_t)B, R, p, s);
#endif
      for (int r = 0; r < NROLES; ++r)
        gen_tile_update(RN_KI r, x, P, 1, z, ea, (size_t)B, R, p, s, v[r]);
      for (int r = 0; r < NROLES; ++r)
        gen_tile_update_store(RN_KI r, x, P, 1, v[r]);
    }
    for (int i = 0; i < DX; ++i) xs[(size_t)i * B + b] = x[i];
    for (int e = 0; e < DE * DE; ++e) Ps[(size_t)e * B + b] = P[e];
  }
  return 0;
}

#endif  // REDNOSE_GENERIC_SCAN_TILE_EPOCH, __CUDACC__
#else   // REDNOSE_GENERIC_SCAN_TILE


namespace rn_gen {

// One filter b through all T steps.
GEN_HD GEN_INLINE void scan_filter(
    int b, int B, int T, scalar_t* xs, scalar_t* Ps, const scalar_t* zs,
    const scalar_t* eas, const scalar_t* dts, const int* kind_idx,
    const scalar_t* pss, const scalar_t* prm, const scalar_t* Q,
    const scalar_t* R) {
  scalar_t x[DX];
  for (int i = 0; i < DX; ++i) x[i] = xs[(size_t)i * B + b];
  scalar_t* P = Ps + b;
  scalar_t p[NP > 0 ? NP : 1];
  for (int i = 0; i < NP; ++i) p[i] = prm[i];
  for (int t = 0; t < T; ++t) {
    for (int i = 0; i < NPS; ++i) p[ps_idx(i)] = pss[(size_t)t * NPS + i];
    const scalar_t* z = zs + (size_t)t * NZROWS * B + b;
    const scalar_t* ea =
        NEAROWS > 0 ? eas + (size_t)t * NEAROWS * B + b : nullptr;
    gen_step(x, P, (size_t)B, z, ea, dts[t], kind_idx ? kind_idx[t] : 0, p,
             Q, R);
  }
  for (int i = 0; i < DX; ++i) xs[(size_t)i * B + b] = x[i];
}

}  // namespace rn_gen

#ifdef __CUDACC__

__global__ void rn_generic_scan_kernel(
    scalar_t* __restrict__ xs, scalar_t* __restrict__ Ps,
    const scalar_t* __restrict__ zs, const scalar_t* __restrict__ eas,
    const scalar_t* __restrict__ dts, const int* __restrict__ kind_idx,
    const scalar_t* __restrict__ pss, const scalar_t* __restrict__ prm,
    const scalar_t* __restrict__ Q, const scalar_t* __restrict__ R, int T,
    int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B)
    rn_gen::scan_filter(b, B, T, xs, Ps, zs, eas, dts, kind_idx, pss, prm, Q,
                        R);
}

// 32 threads a block, as kernel 2: at B = 8192 that is 256 blocks, so all
// 132 SMs hold filters
extern "C" int rn_generic_scan_launch(void* xs, void* Ps, const void* zs,
                                      const void* eas, const void* dts,
                                      const void* kind_idx, const void* pss,
                                      const void* prm, const void* Q,
                                      const void* R, int T, int B,
                                      void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  rn_generic_scan_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
      static_cast<const scalar_t*>(zs), static_cast<const scalar_t*>(eas),
      static_cast<const scalar_t*>(dts), static_cast<const int*>(kind_idx),
      static_cast<const scalar_t*>(pss), static_cast<const scalar_t*>(prm),
      static_cast<const scalar_t*>(Q), static_cast<const scalar_t*>(R), T, B);
  return static_cast<int>(cudaGetLastError());
}

#define RN_GEN_KERNEL rn_generic_scan_kernel
#define RN_GEN_DESIGN 0
#define RN_GEN_ROLES 1
#define RN_GEN_SMEM 0

#else

// The host build of the same emitted body (tests): a loop over the bank.
extern "C" int rn_generic_scan_host(void* xs, void* Ps, const void* zs,
                                    const void* eas, const void* dts,
                                    const void* kind_idx, const void* pss,
                                    const void* prm, const void* Q,
                                    const void* R, int T, int B) {
  for (int b = 0; b < B; ++b)
    rn_gen::scan_filter(
        b, B, T, static_cast<scalar_t*>(xs), static_cast<scalar_t*>(Ps),
        static_cast<const scalar_t*>(zs), static_cast<const scalar_t*>(eas),
        static_cast<const scalar_t*>(dts), static_cast<const int*>(kind_idx),
        static_cast<const scalar_t*>(pss), static_cast<const scalar_t*>(prm),
        static_cast<const scalar_t*>(Q), static_cast<const scalar_t*>(R));
  return 0;
}

#endif  // __CUDACC__
#endif  // REDNOSE_GENERIC_SCAN_BANK, _STREAM, _TILE

#ifdef __CUDACC__
// The variant's launch shape as the runtime reads it: out[0] the design (1
// tile, 0 global), out[1] warps a block, out[2] threads a block, out[3]
// dynamic shared memory bytes, out[4] blocks an SM holds at once, out[5]
// registers a thread, out[6] local memory (stack) bytes a thread.
extern "C" int rn_generic_scan_info(int* out) {
  const int threads = 32 * RN_GEN_ROLES;
  cudaError_t e = cudaSuccess;
  if (RN_GEN_SMEM > 0)
    e = cudaFuncSetAttribute(RN_GEN_KERNEL,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             RN_GEN_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, RN_GEN_KERNEL,
                                                    threads, RN_GEN_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, RN_GEN_KERNEL);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = RN_GEN_DESIGN;
  out[1] = RN_GEN_ROLES;
  out[2] = threads;
  out[3] = RN_GEN_SMEM;
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
#endif  // __CUDACC__
#endif  // REDNOSE_GENERIC_SCAN_LOOPS
