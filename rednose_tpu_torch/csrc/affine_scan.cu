// Kernel 13: the inclusive suffix combine of affine maps along time, the
// parallel-in-time RTS smoother's scan. It replaces the JAX package's
// rednose_tpu/smoothing/rts.py:_suffix_scan_lane (:157, the chunked scan
// of long logs) and its jax.lax.associative_scan (:351, short ones), part
// of one XLA program (_jit_rts) and not a Pallas kernel. Wrapper and
// plain version: rednose_tpu_torch/ops/smooth_scan.py
// (affine_suffix_scan; rednose_tpu_torch/smoothing/rts.py's
// _suffix_scan_lane is the plain doubling scan).
//
// An element k is the map (A_k, b_k[, V_k]): e -> A_k e + b_k and
// D -> V_k + A_k D A_k^T. out[k] = x[n-1] o ... o x[k], each earlier
// element wrapping the later ones (_affine_combine_lane: e = A_b (A_a e +
// b_a) + b_b with b the earlier). Without V it is _affine_combine_ab.
//
// Hand-written, not emitted: D (the main error block, D2) is a template
// parameter, and a source of one line per D instantiates it
// (`#define RN_AFFINE_D 22` then this file; ops/smooth_scan.py), for
// float and double, with V and without.
//
// Layout: A (N, n, D, D), b (N, n, D), V (N, n, D, D), the N lanes'
// elements time-major and each matrix row-major; out b (N, n, D), V and,
// when asked, A in the same layouts.
//
// Three passes over chunks of `chunk` elements (the JAX package's chunked
// scan, with the lanes on blocks): (1) a block per (chunk, lane) composes
// its chunk's elements, the latest innermost, into the chunk's total; (2)
// a block per lane composes the totals from the last chunk back, giving
// each chunk the composition of every later chunk (its carry); (3) a block
// per (chunk, lane) walks its chunk from the carry, last element first,
// storing each out[k]. Passes 1 and 2 compose A (the totals need it); pass
// 3 only where out A is asked for.
//
// Bound: a combine is D^3 multiply-adds for A and 2 D^3 for V, ~5 D^3 an
// element over passes 1 and 3 with V; the bytes are the elements read
// twice (passes 1 and 3) and the outputs written once. The first design (a
// thread an output entry, both operands of every multiply-add read from
// shared memory) was bound by its shared loads, two a multiply-add, ~8x
// its byte bound at D = 22 (PERF.md). Here a block (a chunk; in pass 2 a
// lane) is a warp or a few, and each thread owns a tile of every product:
// TR rows by a 1 / SPLIT share (CW columns) of them, chosen per type and
// pass by the sweep (RN_AF_* below; at D = 22, float passes 1 and 3: 3
// rows x 6 columns, the 8 row groups x 4 column parts filling one warp;
// double: a row x 6 columns, 3 warps; pass 2: a row x 2 columns, 8 warps,
// a shorter chain for its one block a lane). The thread keeps its rows of
// A_k in registers for the whole combine, so each product is the same
// loop: for each l, one shared load of the right operand's CW columns of
// row l (8 bytes a load at D = 22 in float, each quarter-warp on one
// address), then TR x CW multiply-adds. The right operands: A (for A_k A),
// V (for M = A_k V), and M^T for V_k + M A_k^T, taken as its transpose
// A_k M^T (M is stored transposed as it is made, at an odd count of
// 16-byte vectors a row, so those stores meet distinct banks). A combine
// needs two barriers (a __syncwarp in a one-warp block): before the new V
// is written in place, and before the next element. Matrices sit in
// shared memory as in global memory (row-major, stride D), so the
// elements are staged by cp.async in 16-byte copies without index
// arithmetic, RN_AF_STAGES - 1 elements ahead of the combine, and the
// outputs leave the state the same way.
//
// Numerics: every output entry is one multiply-add chain in ascending l,
// with b_k / V_k added after the chain, as in the first design, so the
// tiles change no rounding: bitwise the first design in float and double.
//
// Kernel 13' (entry rn_affine_scan_adjoint_launch; ops/smooth_scan.py
// affine_suffix_scan_adjoint) is the adjoint of this scan, the backward of
// jax.grad through the same suffix scans: the same three passes, their
// block functions instantiated with REV (the elements read in reversed
// time, each A from the element a step back and transposed as its rows
// are loaded), below. Kernel 13's own instantiations (REV false) are
// unchanged: bitwise the parent.

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define AF_HD __host__ __device__
#else
#define AF_HD
#endif
#ifdef __CUDA_ARCH__
#define AF_UNROLL _Pragma("unroll")
#else
#define AF_UNROLL
#endif

#ifndef RN_AFFINE_D
#error "define RN_AFFINE_D, the elements' size, before including affine_scan.cu"
#endif
// Design constants; each may be set by a #define before this file
// (sweep_warps.py --parts affine builds every candidate that way): ring
// stages; the tiles (rows, threads a row) of passes 1 and 3 in float and
// in double, and of pass 2 (both types).
#ifndef RN_AF_STAGES
#define RN_AF_STAGES 2
#endif
#ifndef RN_AF_ROWS
#define RN_AF_ROWS 3
#endif
#ifndef RN_AF_SPLIT
#define RN_AF_SPLIT 4
#endif
#ifndef RN_AF_ROWS64
#define RN_AF_ROWS64 1
#endif
#ifndef RN_AF_SPLIT64
#define RN_AF_SPLIT64 4
#endif
#ifndef RN_AF_CROWS
#define RN_AF_CROWS 1
#endif
#ifndef RN_AF_CSPLIT
#define RN_AF_CSPLIT 11
#endif
// whether a tile runs a combine's first two products in one loop (float,
// double, pass 2)
#ifndef RN_AF_FUSE
#define RN_AF_FUSE 0
#endif
#ifndef RN_AF_FUSE64
#define RN_AF_FUSE64 1
#endif
#ifndef RN_AF_CFUSE
#define RN_AF_CFUSE 1
#endif
// blocks an SM the compiler is to fit passes 1 and 3 to (the launch
// bounds' second value: at most 65536 / (threads x blocks) registers a
// thread), float and double
#ifndef RN_AF_MINB
#define RN_AF_MINB 13
#endif
#ifndef RN_AF_MINB64
#define RN_AF_MINB64 5
#endif
// Timing aids (their outputs are garbage), bits: without the elements'
// copies into the ring (1), without the combines' products (2), without
// the output stores (4).
#ifndef RN_AF_AID
#define RN_AF_AID 0
#endif

namespace rn_affine {

constexpr int D = RN_AFFINE_D;
constexpr int NS = RN_AF_STAGES;
constexpr int AID = RN_AF_AID;
static_assert(NS >= 2, "kernel 13's ring holds two elements or more");

AF_HD constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }
AF_HD constexpr int max_(int a, int b) { return a > b ? a : b; }
AF_HD constexpr int min_(int a, int b) { return a < b ? a : b; }
// the widest of 16, 8, 4 bytes that divides every size given (bytes)
AF_HD constexpr int width(int a, int b = 16, int c = 16) {
  return (a | b | c) % 16 == 0 ? 16 : (a | b | c) % 8 == 0 ? 8 : 4;
}

// A tile of the products: R rows by CW columns, a 1 / P share of them;
// GROUPS row groups x P column parts, one a thread, in whole warps. F: the
// first two products of a combine in one loop over l (both right rows
// loaded ahead of both chains; more registers)
template <int R, int P, int F>
struct Tile {
  static_assert(R >= 1 && P >= 1, "a tile of one row and column or more");
  static constexpr int TR = R, SPLIT = P;
  static constexpr bool FUSE = F != 0;
  static constexpr int GROUPS = (D + R - 1) / R;
  static constexpr int VT = GROUPS * P;
  static constexpr int CW = (D + P - 1) / P;
  static constexpr int THREADS = (VT + 31) / 32 * 32;
};
template <typename S> struct ChunkTile {   // float
  using T = Tile<RN_AF_ROWS, RN_AF_SPLIT, RN_AF_FUSE>;
  static constexpr int MINB = RN_AF_MINB;
};
template <> struct ChunkTile<double> {
  using T = Tile<RN_AF_ROWS64, RN_AF_SPLIT64, RN_AF_FUSE64>;
  static constexpr int MINB = RN_AF_MINB64;
};
using CarryTile = Tile<RN_AF_CROWS, RN_AF_CSPLIT, RN_AF_CFUSE>;

// on the card a thread keeps its tile's rows of A_k in registers from one
// phase of a combine to the next (it has one tile); the host build's one
// thread reloads them
#ifdef __CUDACC__
constexpr bool AKREG = true;
#else
constexpr bool AKREG = false;
#endif

constexpr size_t TOT = 2 * D * D + D;   // scalars of a stored map

// The shared memory of a block in scalars of S, every part 16-byte
// aligned: the state (the composition so far: A in two buffers, b in two,
// V in place; matrices row-major at stride D, as in global memory), M^T
// (M = A_k V transposed, at stride LDT), then the ring's NS stages (A_k,
// V_k, b_k, as in global memory).
template <typename S, typename T>
struct Lay {
  static constexpr int SZ = (int)sizeof(S);
  static constexpr int VEC = 16 / SZ;                    // scalars a vector
  static constexpr int MATP = round_up(D * D, VEC);
  static constexpr int BP = round_up(D, VEC);
  // M^T's stride: whole vectors, an odd number of them
  static constexpr int LDT0 = round_up(max_(D, T::SPLIT * T::CW), VEC);
  static constexpr int LDT = (LDT0 / VEC) % 2 ? LDT0 : LDT0 + VEC;
  static constexpr int A0 = 0, B0 = 2 * MATP, V0 = B0 + 2 * BP;
  static constexpr int T0 = V0 + MATP;
  static constexpr int STATE = T0 + round_up(D * LDT, VEC);
  static constexpr int SA = 0, SV = MATP, SB = 2 * MATP;
  static constexpr int STAGE = 2 * MATP + BP;
  static constexpr int TOTAL = STATE + NS * STAGE;
  // bytes a shared load of a tile's columns of a row of A or V (stride
  // D), of M^T (stride LDT), of a whole row of A_k
  static constexpr int SEG = width(D * SZ, T::CW * SZ);
  static constexpr int SEGT = width(LDT * SZ, T::CW * SZ);
  static constexpr int ROWV = width(D * SZ);
  // bytes a copy between global and shared memory: the elements' and
  // outputs' matrices and b (passes 1 and 3), a stored map's parts
  static constexpr int WM = width(D * D * SZ);
  static constexpr int WB = width(D * SZ);
  static constexpr int WT = width((int)TOT * SZ, D * D * SZ, D * SZ);
};

template <typename T>
AF_HD inline void sync_() {
#ifdef __CUDA_ARCH__
  if (T::THREADS == 32) __syncwarp(); else __syncthreads();
#endif
}

#ifdef __CUDA_ARCH__
// a vector of VB bytes of S in registers
template <typename S, int VB> struct Vec;
template <> struct Vec<float, 4> {
  using T = float;
  __device__ static void put(float v, float* d) { d[0] = v; }
};
template <> struct Vec<float, 8> {
  using T = float2;
  __device__ static void put(const float2& v, float* d) {
    d[0] = v.x; d[1] = v.y;
  }
};
template <> struct Vec<float, 16> {
  using T = float4;
  __device__ static void put(const float4& v, float* d) {
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
};
template <> struct Vec<double, 8> {
  using T = double;
  __device__ static void put(double v, double* d) { d[0] = v; }
};
template <> struct Vec<double, 16> {
  using T = double2;
  __device__ static void put(const double2& v, double* d) {
    d[0] = v.x; d[1] = v.y;
  }
};
template <int W> struct Chunk;
template <> struct Chunk<4> { using T = unsigned; };
template <> struct Chunk<8> { using T = uint2; };
template <> struct Chunk<16> { using T = uint4; };
#endif

// N scalars of shared memory (VB-byte aligned) into registers: vectors of
// VB bytes on the card (dst holds N rounded up to them)
template <typename S, int N, int VB>
AF_HD inline void ld_row(const S* src, S* dst) {
#ifdef __CUDA_ARCH__
  constexpr int V = VB / (int)sizeof(S) > 0 ? VB / (int)sizeof(S) : 1;
  constexpr int B = V * (int)sizeof(S);
  using T = typename Vec<S, B>::T;
  AF_UNROLL
  for (int q = 0; q < (N + V - 1) / V; ++q)
    Vec<S, B>::put(reinterpret_cast<const T*>(src)[q], dst + q * V);
#else
  for (int q = 0; q < N; ++q) dst[q] = src[q];
#endif
}

// ------------------------------------------------------------ a combine
//
// The element in stage st (A_k, b_k, V_k) wraps the composition in the
// state: A := A_k A (into the other A buffer, with do_A), b := A_k b + b_k
// (into the other b buffer), V := V_k + A_k V A_k^T (in place, with do_V).
// Tile v: rows i0 = TR (v % GROUPS) ... of the products, columns c0 = CW
// (v / GROUPS) ... (tile 0 of a group also computes its rows of b). Every
// product reads A_k's rows from registers and a row l of the right operand
// as a shared load of the tile's CW columns: A_k A (right: A), M = A_k V
// (right: V), and V_k + M A_k^T by its transpose A_k M^T (right: M^T), so
// entry (i, j) of the new V is the chain over l of A_k[j][l] M[i][l].

// a tile's rows of A_k into ak (REV, kernel 13''s transposed form: the
// stage holds A_k^T, so a row is a column of it)
template <typename S, typename T, bool REV = false>
AF_HD inline void load_ak(const S* st, int i0, S (&ak)[T::TR][D + 4]) {
  using L = Lay<S, T>;
  if constexpr (REV) {
    AF_UNROLL
    for (int a = 0; a < T::TR; ++a)
      AF_UNROLL
      for (int l = 0; l < D; ++l)
        ak[a][l] = st[L::SA + l * D + min_(i0 + a, D - 1)];
  } else {
    AF_UNROLL
    for (int a = 0; a < T::TR; ++a)
      ld_row<S, D, L::ROWV>(st + L::SA + min_(i0 + a, D - 1) * D, ak[a]);
  }
}

// acc[a][q] = sum_l ak[a][l] R[l][c0 + q], each a chain in ascending l (R
// at stride ld, its rows read VB bytes a load)
template <typename S, typename T, int ld, int VB>
AF_HD inline void product(const S (&ak)[T::TR][D + 4], const S* R, int c0,
                          S (&acc)[T::TR][T::CW + 4]) {
  AF_UNROLL
  for (int a = 0; a < T::TR; ++a)
    AF_UNROLL
    for (int q = 0; q < T::CW; ++q) acc[a][q] = 0;
  AF_UNROLL
  for (int l = 0; l < D; ++l) {
    S r[T::CW + 4];
    ld_row<S, T::CW, VB>(R + l * ld + c0, r);
    AF_UNROLL
    for (int a = 0; a < T::TR; ++a)
      AF_UNROLL
      for (int q = 0; q < T::CW; ++q) acc[a][q] += ak[a][l] * r[q];
  }
}

// product for two right operands at once (R1, R2 at stride D): the loads
// of both ahead of both chains' multiply-adds
template <typename S, typename T, int VB>
AF_HD inline void product2(const S (&ak)[T::TR][D + 4], const S* R1,
                           const S* R2, int c0, S (&acc1)[T::TR][T::CW + 4],
                           S (&acc2)[T::TR][T::CW + 4]) {
  AF_UNROLL
  for (int a = 0; a < T::TR; ++a)
    AF_UNROLL
    for (int q = 0; q < T::CW; ++q) acc1[a][q] = acc2[a][q] = 0;
  AF_UNROLL
  for (int l = 0; l < D; ++l) {
    S r1[T::CW + 4], r2[T::CW + 4];
    ld_row<S, T::CW, VB>(R1 + l * D + c0, r1);
    ld_row<S, T::CW, VB>(R2 + l * D + c0, r2);
    AF_UNROLL
    for (int a = 0; a < T::TR; ++a)
      AF_UNROLL
      for (int q = 0; q < T::CW; ++q) {
        acc1[a][q] += ak[a][l] * r1[q];
        acc2[a][q] += ak[a][l] * r2[q];
      }
  }
}

// phase a of tile v: its rows of A_k A and A_k b + b_k, its entries of M
// (into M^T)
template <typename S, typename T, bool REV = false>
AF_HD inline void phase_a(int v, const S* st, const S* Ap, const S* bp,
                          const S* Vp, S* An, S* bn, S* MT, bool do_A,
                          bool do_V, S (&ak)[T::TR][D + 4]) {
  using L = Lay<S, T>;
  constexpr int TR = T::TR, CW = T::CW;
  const int i0 = v % T::GROUPS * TR, c0 = v / T::GROUPS * CW;
  load_ak<S, T, REV>(st, i0, ak);
  S acc[TR][CW + 4], accm[TR][CW + 4];
  const bool fused = T::FUSE && do_A && do_V;
  if (fused) product2<S, T, L::SEG>(ak, Ap, Vp, c0, acc, accm);
  else if (do_A) product<S, T, D, L::SEG>(ak, Ap, c0, acc);
  if (do_A)
    AF_UNROLL
    for (int a = 0; a < TR; ++a)
      AF_UNROLL
      for (int q = 0; q < CW; ++q)
        if (i0 + a < D && c0 + q < D) An[(i0 + a) * D + c0 + q] = acc[a][q];
  if (c0 == 0) {
    S r[D + 4];
    ld_row<S, D, 16>(bp, r);
    AF_UNROLL
    for (int a = 0; a < TR; ++a) {
      S s = 0;
      AF_UNROLL
      for (int j = 0; j < D; ++j) s += ak[a][j] * r[j];
      if (i0 + a < D) bn[i0 + a] = s + st[L::SB + i0 + a];
    }
  }
  if (!do_V) return;
  if (!fused) product<S, T, D, L::SEG>(ak, Vp, c0, accm);
  AF_UNROLL
  for (int a = 0; a < TR; ++a)
    AF_UNROLL
    for (int q = 0; q < CW; ++q)
      if (i0 + a < D && c0 + q < D)
        MT[(c0 + q) * L::LDT + i0 + a] = accm[a][q];
}

// phase b of tile v: its entries of V_k + M A_k^T, in place in V: entry
// (c0 + q, i0 + a), the chain of A_k's row i0 + a against M's row c0 + q
template <typename S, typename T, bool REV = false>
AF_HD inline void phase_b(int v, const S* st, const S* MT, S* Vn,
                          S (&ak)[T::TR][D + 4]) {
  using L = Lay<S, T>;
  constexpr int TR = T::TR, CW = T::CW;
  const int i0 = v % T::GROUPS * TR, c0 = v / T::GROUPS * CW;
  if (!AKREG) load_ak<S, T, REV>(st, i0, ak);
  S acc[TR][CW + 4];
  product<S, T, L::LDT, L::SEGT>(ak, MT, c0, acc);
  AF_UNROLL
  for (int a = 0; a < TR; ++a)
    AF_UNROLL
    for (int q = 0; q < CW; ++q) {
      const int i = c0 + q, j = i0 + a;
      if (i < D && j < D)
        Vn[i * D + j] = acc[a][q] + st[L::SV + i * D + j];
    }
}

// one combine of stage st into the state (A and b from buffer cur into
// cur ^ 1); ends with the threads apart (the next sync_ orders them)
template <typename S, typename T, bool REV = false>
AF_HD inline void combine(const S* st, S* sm, int cur, bool do_A, bool do_V,
                          int tid, int nt) {
  using L = Lay<S, T>;
  const S* Ap = sm + L::A0 + cur * L::MATP;
  const S* bp = sm + L::B0 + cur * L::BP;
  S* An = sm + L::A0 + (cur ^ 1) * L::MATP;
  S* bn = sm + L::B0 + (cur ^ 1) * L::BP;
  S* Vs = sm + L::V0;
  S* MT = sm + L::T0;
  S ak[T::TR][D + 4];
  for (int v = tid; v < T::VT; v += nt)
    phase_a<S, T, REV>(v, st, Ap, bp, Vs, An, bn, MT, do_A, do_V, ak);
  if (!do_V) return;
  sync_<T>();   // every read of V and every write of M^T done
  for (int v = tid; v < T::VT; v += nt)
    phase_b<S, T, REV>(v, st, MT, Vs, ak);
}

// ---------------------------------------------------- copies and chains

// a map of D x D (A), D (b), D x D (V) scalars in global memory, row-major
template <typename S>
struct Map {
  S* A;
  S* b;
  S* V;
};

// the map t steps on from x: A and V dA a step, b db (absent parts stay
// absent)
template <typename S>
AF_HD inline Map<S> step(Map<S> x, int t, ptrdiff_t dA, ptrdiff_t db) {
  return Map<S>{x.A ? x.A + t * dA : nullptr, x.b + t * db,
                x.V ? x.V + t * dA : nullptr};
}

// n scalars between global g and shared s (both W-byte aligned where
// vec), plain loads and stores: copies of W bytes, else a scalar each
template <typename S, int W>
AF_HD inline void copy(S* g, S* s, int n, bool to_shared, bool vec, int tid,
                       int nt) {
#ifdef __CUDA_ARCH__
  constexpr int PER = W / (int)sizeof(S);
  if (vec && PER > 0) {
    using C = typename Chunk<W>::T;
    C* gp = reinterpret_cast<C*>(g);
    C* sp = reinterpret_cast<C*>(s);
    for (int q = tid; q < n / PER; q += nt)
      if (to_shared) sp[q] = gp[q]; else gp[q] = sp[q];
    return;
  }
#endif
  (void)vec;
  for (int q = tid; q < n; q += nt)
    if (to_shared) s[q] = g[q]; else g[q] = s[q];
}

#ifdef __CUDA_ARCH__
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(N)
               : "memory");
}

// n scalars from global g to shared s by cp.async: copies of W bytes
// where vec (both ends W-byte aligned, n of them whole), else a scalar
// each
template <typename S, int W>
__device__ __forceinline__ void copy_async(S* s, const S* g, int n, bool vec,
                                           int tid, int nt) {
  constexpr int WS = W > (int)sizeof(S) ? W : (int)sizeof(S);
  constexpr int PER = WS / (int)sizeof(S);
  if (vec) {
    for (int q = tid; q < n / PER; q += nt)
      cp_async<WS>(s + q * PER, g + q * PER);
  } else {
    for (int q = tid; q < n; q += nt)
      cp_async<(int)sizeof(S)>(s + q, g + q);
  }
}
#endif

// element x into stage st: cp.async on the card (completes at a later
// wait), a plain copy on the host; W: bytes a copy of A and V, WBB of b
// (REV: an element without A, kernel 13''s last, takes A = 0 by plain
// stores)
template <typename S, typename T, int W, int WBB, bool REV = false>
AF_HD inline void fill(S* st, Map<S> x, bool vec, int tid, int nt) {
  using L = Lay<S, T>;
  if (AID & 1) return;
  const bool zero_a = REV && x.A == nullptr;
  if constexpr (REV) {
    if (zero_a)
      for (int q = tid; q < D * D; q += nt) st[L::SA + q] = 0;
  }
#ifdef __CUDA_ARCH__
  if (!zero_a) copy_async<S, W>(st + L::SA, x.A, D * D, vec, tid, nt);
  if (x.V) copy_async<S, W>(st + L::SV, x.V, D * D, vec, tid, nt);
  copy_async<S, WBB>(st + L::SB, x.b, D, vec, tid, nt);
#else
  if (!zero_a) copy<S, W>(x.A, st + L::SA, D * D, true, vec, tid, nt);
  if (x.V) copy<S, W>(x.V, st + L::SV, D * D, true, vec, tid, nt);
  copy<S, WBB>(x.b, st + L::SB, D, true, vec, tid, nt);
#endif
}

AF_HD inline void commit_() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// waits for all but the NS - 2 latest groups of this thread's copies
AF_HD inline void wait_() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2) : "memory");
#endif
}

// the state's map (A from buffer cur where o.A is given, V where o.V is)
// to o, in copies of W (A, V) and WBB (b) bytes
template <typename S, typename T, int W, int WBB>
AF_HD inline void store_map(S* sm, int cur, Map<S> o, bool vec, int tid,
                            int nt) {
  using L = Lay<S, T>;
  if (AID & 4) return;
  if (o.A) copy<S, W>(o.A, sm + L::A0 + cur * L::MATP, D * D, false, vec, tid,
                      nt);
  copy<S, WBB>(o.b, sm + L::B0 + cur * L::BP, D, false, vec, tid, nt);
  if (o.V) copy<S, W>(o.V, sm + L::V0, D * D, false, vec, tid, nt);
}

// the state := x (its A into buffer 0 where x.A is given, V where x.V is;
// a stored map, copies of WT bytes), or the identity map where x.b is
// null; the rest of the block's shared memory zeroed
template <typename S, typename T>
AF_HD inline void load_map(S* sm, Map<S> x, bool vec, int tid, int nt) {
  using L = Lay<S, T>;
  for (int q = tid; q < L::TOTAL; q += nt) sm[q] = 0;
  sync_<T>();
  if (x.b == nullptr) {
    for (int i = tid; i < D; i += nt) sm[L::A0 + i * D + i] = 1;
  } else {
    if (x.A) copy<S, L::WT>(x.A, sm + L::A0, D * D, true, vec, tid, nt);
    copy<S, L::WT>(x.b, sm + L::B0, D, true, vec, tid, nt);
    if (x.V) copy<S, L::WT>(x.V, sm + L::V0, D * D, true, vec, tid, nt);
  }
  sync_<T>();
}

// element t of a chain: step(x0, t, dxA, dxb), and with REV (kernel 13''s
// transposed form) its A the one a step back, x0.A + (t - 1) dxA, none
// (A = 0) for t = 0 where zero_first
template <typename S, bool REV>
AF_HD inline Map<S> elem(Map<S> x0, int t, ptrdiff_t dxA, ptrdiff_t dxb,
                         bool zero_first) {
  Map<S> x = step<S>(x0, t, dxA, dxb);
  if constexpr (REV)
    x.A = t == 0 && zero_first ? nullptr : x0.A + (ptrdiff_t)(t - 1) * dxA;
  return x;
}

// The chain of a block: elements x(t) = elem(x0, t, ...), t < cnt,
// applied in order to the state (A, b in buffer cur); after element t its
// map goes to step(o0, t, doA, dob) where o0.b is given. Elements are
// staged NS - 1 ahead. W / WBB: bytes a copy of the elements' and the
// outputs' matrices / b. Returns the buffer that holds the result.
template <typename S, typename T, int W, int WBB, bool REV = false>
AF_HD int chain(S* sm, int cur, Map<S> x0, ptrdiff_t dxA, ptrdiff_t dxb,
                int cnt, Map<S> o0, ptrdiff_t doA, ptrdiff_t dob,
                bool do_A, bool vec, int tid, int nt,
                bool zero_first = false) {
  using L = Lay<S, T>;
  const bool do_V = x0.V != nullptr;
  S* ring = sm + L::STATE;
  for (int s = 0; s < NS - 1; ++s) {
    if (s < cnt)
      fill<S, T, W, WBB, REV>(ring + s * L::STAGE,
                              elem<S, REV>(x0, s, dxA, dxb, zero_first), vec,
                              tid, nt);
    commit_();
  }
  for (int t = 0; t < cnt; ++t) {
    wait_();
    sync_<T>();   // element t landed; combine t - 1 done
    if (t > 0 && o0.b)
      store_map<S, T, W, WBB>(sm, cur, step<S>(o0, t - 1, doA, dob), vec,
                              tid, nt);
    const int nx = t + NS - 1;   // into the stage combine t - 1 read
    if (nx < cnt)
      fill<S, T, W, WBB, REV>(ring + (nx % NS) * L::STAGE,
                              elem<S, REV>(x0, nx, dxA, dxb, zero_first),
                              vec, tid, nt);
    commit_();
    if (!(AID & 2))
      combine<S, T, REV>(ring + (t % NS) * L::STAGE, sm, cur, do_A, do_V,
                         tid, nt);
    cur ^= 1;   // A (where composed) and b now in the other buffer
  }
  sync_<T>();
  if (cnt > 0 && o0.b)
    store_map<S, T, W, WBB>(sm, cur, step<S>(o0, cnt - 1, doA, dob), vec,
                            tid, nt);
  return cur;
}

// ---------------------------------------------------------- the passes

// pass 1: chunk c of lane l composed into tot[l, c]
template <typename S, typename T>
AF_HD void totals_block(const S* A, const S* b, const S* V, S* tot, int n,
                        int chunk, int nc, int c, int l, bool vec, S* sm,
                        int tid, int nt) {
  using L = Lay<S, T>;
  load_map<S, T>(sm, Map<S>{nullptr, nullptr, nullptr}, vec, tid, nt);
  const int lo = c * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const size_t e = (size_t)l * n + hi - 1;
  const Map<S> x0{const_cast<S*>(A) + e * D * D, const_cast<S*>(b) + e * D,
                  V ? const_cast<S*>(V) + e * D * D : nullptr};
  const int cur = chain<S, T, L::WM, L::WB>(
      sm, 0, x0, -(ptrdiff_t)(D * D), -(ptrdiff_t)D, hi - lo,
      Map<S>{nullptr, nullptr, nullptr}, 0, 0, true, vec, tid, nt);
  S* t = tot + ((size_t)l * nc + c) * TOT;
  store_map<S, T, L::WT, L::WT>(
      sm, cur, Map<S>{t, t + D * D, V ? t + D * D + D : nullptr}, vec, tid,
      nt);
}

// pass 2: excl[l, c] = tot[l, nc-1] o ... o tot[l, c+1] (the identity for
// the last chunk)
template <typename S, typename T>
AF_HD void carry_block(const S* tot, S* excl, bool has_v, int nc, int l,
                       bool vec, S* sm, int tid, int nt) {
  using L = Lay<S, T>;
  load_map<S, T>(sm, Map<S>{nullptr, nullptr, nullptr}, vec, tid, nt);
  const size_t l0 = (size_t)l * nc;
  S* x = excl + (l0 + nc - 1) * TOT;
  const Map<S> last{x, x + D * D, has_v ? x + D * D + D : nullptr};
  store_map<S, T, L::WT, L::WT>(sm, 0, last, vec, tid, nt);
  if (nc < 2) return;
  S* t = const_cast<S*>(tot) + (l0 + nc - 1) * TOT;
  S* o = excl + (l0 + nc - 2) * TOT;
  chain<S, T, L::WT, L::WT>(
      sm, 0, Map<S>{t, t + D * D, has_v ? t + D * D + D : nullptr},
      -(ptrdiff_t)TOT, -(ptrdiff_t)TOT, nc - 1,
      Map<S>{o, o + D * D, has_v ? o + D * D + D : nullptr}, -(ptrdiff_t)TOT,
      -(ptrdiff_t)TOT, true, vec, tid, nt);
}

// pass 3: chunk c of lane l from its carry (excl null: the identity)
template <typename S, typename T>
AF_HD void apply_block(const S* A, const S* b, const S* V, const S* excl,
                       S* Ao, S* bo, S* Vo, int n, int chunk, int nc, int c,
                       int l, bool vec, S* sm, int tid, int nt) {
  using L = Lay<S, T>;
  S* x = excl ? const_cast<S*>(excl) + ((size_t)l * nc + c) * TOT : nullptr;
  load_map<S, T>(sm, x ? Map<S>{Ao ? x : nullptr, x + D * D,
                                V ? x + D * D + D : nullptr}
                       : Map<S>{nullptr, nullptr, nullptr}, vec, tid, nt);
  const int lo = c * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const size_t e = (size_t)l * n + hi - 1;
  const Map<S> x0{const_cast<S*>(A) + e * D * D, const_cast<S*>(b) + e * D,
                  V ? const_cast<S*>(V) + e * D * D : nullptr};
  const Map<S> o0{Ao ? Ao + e * D * D : nullptr, bo + e * D,
                  V ? Vo + e * D * D : nullptr};
  chain<S, T, L::WM, L::WB>(sm, 0, x0, -(ptrdiff_t)(D * D), -(ptrdiff_t)D,
                            hi - lo, o0, -(ptrdiff_t)(D * D), -(ptrdiff_t)D,
                            Ao != nullptr, vec, tid, nt);
}

// ------------------------------------------- kernel 13': the adjoint
//
// The adjoint of the scan e_k = b_k + A_k e_{k+1}, D_k = V_k + A_k D_{k+1}
// A_k^T (k < n, e_n = D_n = 0) from the cotangents gb (of e) and gV (of
// D): lambda_k = gb_k + A_{k-1}^T lambda_{k-1}, Lambda_k = gV_k +
// A_{k-1}^T Lambda_{k-1} A_{k-1} (k = 0 ... n-1), the cotangents of b and
// V. It is the same suffix scan over reversed time, k' = n - 1 - k, of the
// elements (A_{k-1}^T, gb_k, gV_k) (A_{-1} = 0): each chunk's elements are
// read in place, their A from the element a step back and transposed as
// it is loaded (load_ak's REV), so nothing is copied on the host. The
// carry pass is pass 2 as it is (it composes the chunks' totals, which are
// maps like any other); the outputs lambda and Lambda land at the rows of
// their b and V. A (N, n, D, D), gb, lam (N, n, D), gV, Lam (N, n, D, D).

// pass 1 of the adjoint: reversed chunk c of lane l composed into tot
template <typename S, typename T>
AF_HD void totals_rev_block(const S* A, const S* b, const S* V, S* tot,
                            int n, int chunk, int nc, int c, int l, bool vec,
                            S* sm, int tid, int nt) {
  load_map<S, T>(sm, Map<S>{nullptr, nullptr, nullptr}, vec, tid, nt);
  const int lo = c * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const int o0 = n - hi;           // the row of the chain's first element
  const size_t e = (size_t)l * n + o0;
  const Map<S> x0{const_cast<S*>(A) + e * D * D, const_cast<S*>(b) + e * D,
                  V ? const_cast<S*>(V) + e * D * D : nullptr};
  const int cur = chain<S, T, Lay<S, T>::WM, Lay<S, T>::WB, true>(
      sm, 0, x0, (ptrdiff_t)(D * D), (ptrdiff_t)D, hi - lo,
      Map<S>{nullptr, nullptr, nullptr}, 0, 0, true, vec, tid, nt, o0 == 0);
  S* t = tot + ((size_t)l * nc + c) * TOT;
  store_map<S, T, Lay<S, T>::WT, Lay<S, T>::WT>(
      sm, cur, Map<S>{t, t + D * D, V ? t + D * D + D : nullptr}, vec, tid,
      nt);
}

// pass 3 of the adjoint: reversed chunk c of lane l from its carry
template <typename S, typename T>
AF_HD void apply_rev_block(const S* A, const S* b, const S* V,
                           const S* excl, S* bo, S* Vo, int n, int chunk,
                           int nc, int c, int l, bool vec, S* sm, int tid,
                           int nt) {
  S* x = excl ? const_cast<S*>(excl) + ((size_t)l * nc + c) * TOT : nullptr;
  load_map<S, T>(sm, x ? Map<S>{nullptr, x + D * D,
                                V ? x + D * D + D : nullptr}
                       : Map<S>{nullptr, nullptr, nullptr}, vec, tid, nt);
  const int lo = c * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const int o0 = n - hi;
  const size_t e = (size_t)l * n + o0;
  const Map<S> x0{const_cast<S*>(A) + e * D * D, const_cast<S*>(b) + e * D,
                  V ? const_cast<S*>(V) + e * D * D : nullptr};
  const Map<S> out{nullptr, bo + e * D, V ? Vo + e * D * D : nullptr};
  chain<S, T, Lay<S, T>::WM, Lay<S, T>::WB, true>(
      sm, 0, x0, (ptrdiff_t)(D * D), (ptrdiff_t)D, hi - lo, out,
      (ptrdiff_t)(D * D), (ptrdiff_t)D, false, vec, tid, nt, o0 == 0);
}

}  // namespace rn_affine

#ifdef __CUDACC__

#include <initializer_list>

namespace rn_affine {

template <typename S>
__global__ void __launch_bounds__(ChunkTile<S>::T::THREADS,
                                  ChunkTile<S>::MINB)
    totals_kernel(const S* __restrict__ A, const S* __restrict__ b,
                  const S* __restrict__ V, S* tot, int n, int chunk, int nc,
                  int vec) {
  using T = typename ChunkTile<S>::T;
  extern __shared__ __align__(16) unsigned char smem_[];
  totals_block<S, T>(A, b, V, tot, n, chunk, nc, blockIdx.x, blockIdx.y,
                     vec != 0, reinterpret_cast<S*>(smem_), threadIdx.x,
                     T::THREADS);
}

template <typename S>
__global__ void __launch_bounds__(CarryTile::THREADS)
    carry_kernel(const S* tot, S* excl, int has_v, int nc, int vec) {
  extern __shared__ __align__(16) unsigned char smem_[];
  carry_block<S, CarryTile>(tot, excl, has_v != 0, nc, blockIdx.x, vec != 0,
                            reinterpret_cast<S*>(smem_), threadIdx.x,
                            CarryTile::THREADS);
}

template <typename S>
__global__ void __launch_bounds__(ChunkTile<S>::T::THREADS,
                                  ChunkTile<S>::MINB)
    apply_kernel(const S* __restrict__ A, const S* __restrict__ b,
                 const S* __restrict__ V, const S* excl, S* Ao, S* bo, S* Vo,
                 int n, int chunk, int nc, int vec) {
  using T = typename ChunkTile<S>::T;
  extern __shared__ __align__(16) unsigned char smem_[];
  apply_block<S, T>(A, b, V, excl, Ao, bo, Vo, n, chunk, nc, blockIdx.x,
                    blockIdx.y, vec != 0, reinterpret_cast<S*>(smem_),
                    threadIdx.x, T::THREADS);
}

template <typename S>
__global__ void __launch_bounds__(ChunkTile<S>::T::THREADS,
                                  ChunkTile<S>::MINB)
    totals_rev_kernel(const S* __restrict__ A, const S* __restrict__ b,
                      const S* __restrict__ V, S* tot, int n, int chunk,
                      int nc, int vec) {
  using T = typename ChunkTile<S>::T;
  extern __shared__ __align__(16) unsigned char smem_[];
  totals_rev_block<S, T>(A, b, V, tot, n, chunk, nc, blockIdx.x, blockIdx.y,
                         vec != 0, reinterpret_cast<S*>(smem_), threadIdx.x,
                         T::THREADS);
}

template <typename S>
__global__ void __launch_bounds__(ChunkTile<S>::T::THREADS,
                                  ChunkTile<S>::MINB)
    apply_rev_kernel(const S* __restrict__ A, const S* __restrict__ b,
                     const S* __restrict__ V, const S* excl, S* bo, S* Vo,
                     int n, int chunk, int nc, int vec) {
  using T = typename ChunkTile<S>::T;
  extern __shared__ __align__(16) unsigned char smem_[];
  apply_rev_block<S, T>(A, b, V, excl, bo, Vo, n, chunk, nc, blockIdx.x,
                        blockIdx.y, vec != 0, reinterpret_cast<S*>(smem_),
                        threadIdx.x, T::THREADS);
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// whether every pointer given is 16-byte aligned (then every copy, at the
// widths Lay chose from the sizes, is aligned too)
inline int aligned(std::initializer_list<const void*> ps) {
  for (const void* p : ps)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return 1;
}

// bytes of shared memory of the chunk passes and of the carry
template <typename S>
constexpr size_t chunk_smem() {
  return sizeof(S) * Lay<S, typename ChunkTile<S>::T>::TOTAL;
}
template <typename S>
constexpr size_t carry_smem() {
  return sizeof(S) * Lay<S, CarryTile>::TOTAL;
}

// pass 0 (totals), 1 (carry), 2 (apply) or -1 (all three in order; passes
// 0 and 1 only where n > chunk)
template <typename S>
int launch(int pass, const void* A, const void* b, const void* V, void* Ao,
           void* bo, void* Vo, void* tot, void* excl, int N, int n,
           int chunk, cudaStream_t st) {
  constexpr int threads = ChunkTile<S>::T::THREADS;
  const int nc = (n + chunk - 1) / chunk;
  const int vec = aligned({A, b, V, Ao, bo, Vo, tot, excl});
  cudaError_t err = allow_smem(totals_kernel<S>, chunk_smem<S>());
  if (err == cudaSuccess) err = allow_smem(carry_kernel<S>, carry_smem<S>());
  if (err == cudaSuccess) err = allow_smem(apply_kernel<S>, chunk_smem<S>());
  if (err != cudaSuccess) return (int)err;
  if (nc > 1 && (pass == -1 || pass == 0))
    totals_kernel<S><<<dim3(nc, N), threads, chunk_smem<S>(), st>>>(
        (const S*)A, (const S*)b, (const S*)V, (S*)tot, n, chunk, nc, vec);
  if (nc > 1 && (pass == -1 || pass == 1))
    carry_kernel<S><<<N, CarryTile::THREADS, carry_smem<S>(), st>>>(
        (const S*)tot, (S*)excl, V != nullptr, nc, vec);
  if (pass == -1 || pass == 2)
    apply_kernel<S><<<dim3(nc, N), threads, chunk_smem<S>(), st>>>(
        (const S*)A, (const S*)b, (const S*)V,
        nc > 1 ? (const S*)excl : nullptr, (S*)Ao, (S*)bo, (S*)Vo, n, chunk,
        nc, vec);
  return (int)cudaGetLastError();
}

// kernel 13': pass 1 (totals_rev), 2 (the carry, as kernel 13's) and 3
// (apply_rev); pass -1 all three in order (1 and 2 only where n > chunk)
template <typename S>
int launch_adjoint(int pass, const void* A, const void* gb, const void* gV,
                   void* lam, void* Lam, void* tot, void* excl, int N, int n,
                   int chunk, cudaStream_t st) {
  constexpr int threads = ChunkTile<S>::T::THREADS;
  const int nc = (n + chunk - 1) / chunk;
  const int vec = aligned({A, gb, gV, lam, Lam, tot, excl});
  cudaError_t err = allow_smem(totals_rev_kernel<S>, chunk_smem<S>());
  if (err == cudaSuccess) err = allow_smem(carry_kernel<S>, carry_smem<S>());
  if (err == cudaSuccess) err = allow_smem(apply_rev_kernel<S>,
                                           chunk_smem<S>());
  if (err != cudaSuccess) return (int)err;
  if (nc > 1 && (pass == -1 || pass == 0))
    totals_rev_kernel<S><<<dim3(nc, N), threads, chunk_smem<S>(), st>>>(
        (const S*)A, (const S*)gb, (const S*)gV, (S*)tot, n, chunk, nc, vec);
  if (nc > 1 && (pass == -1 || pass == 1))
    carry_kernel<S><<<N, CarryTile::THREADS, carry_smem<S>(), st>>>(
        (const S*)tot, (S*)excl, gV != nullptr, nc, vec);
  if (pass == -1 || pass == 2)
    apply_rev_kernel<S><<<dim3(nc, N), threads, chunk_smem<S>(), st>>>(
        (const S*)A, (const S*)gb, (const S*)gV,
        nc > 1 ? (const S*)excl : nullptr, (S*)lam, (S*)Lam, n, chunk, nc,
        vec);
  return (int)cudaGetLastError();
}

template <typename T, typename K>
int kernel_info(K kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        T::THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int v[9] = {T::THREADS, (int)smem, blocks, attr.numRegs,
                    (int)attr.localSizeBytes, NS, T::TR, T::SPLIT, T::CW};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

template <typename S>
int info(int pass, int* out) {
  using T = typename ChunkTile<S>::T;
  return pass == 0   ? kernel_info<T>(totals_kernel<S>, chunk_smem<S>(), out)
         : pass == 1 ? kernel_info<CarryTile>(carry_kernel<S>,
                                              carry_smem<S>(), out)
         : pass == 3 ? kernel_info<T>(totals_rev_kernel<S>, chunk_smem<S>(),
                                      out)
         : pass == 4 ? kernel_info<T>(apply_rev_kernel<S>, chunk_smem<S>(),
                                      out)
                     : kernel_info<T>(apply_kernel<S>, chunk_smem<S>(), out);
}

}  // namespace rn_affine

// A, b, V (V null: the (A, b) scan) and the outputs bo, Vo (with V), Ao
// (null: not stored); tot and excl scratch of N * ceil(n / chunk) maps
// (2 D^2 + D scalars each); device pointers. Three launches on the
// stream (one where n <= chunk); returns cudaGetLastError().
extern "C" int rn_affine_scan_launch(const void* A, const void* b,
                                     const void* V, void* Ao, void* bo,
                                     void* Vo, void* tot, void* excl, int N,
                                     int n, int chunk, int is_double,
                                     void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double ? rn_affine::launch<double>(-1, A, b, V, Ao, bo, Vo, tot,
                                               excl, N, n, chunk, st)
                   : rn_affine::launch<float>(-1, A, b, V, Ao, bo, Vo, tot,
                                              excl, N, n, chunk, st);
}

// one pass of rn_affine_scan_launch (0 totals, 1 carry, 2 apply; passes 0
// and 1 launch nothing where n <= chunk), for timing each apart
extern "C" int rn_affine_scan_pass(int pass, const void* A, const void* b,
                                   const void* V, void* Ao, void* bo,
                                   void* Vo, void* tot, void* excl, int N,
                                   int n, int chunk, int is_double,
                                   void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double ? rn_affine::launch<double>(pass, A, b, V, Ao, bo, Vo, tot,
                                               excl, N, n, chunk, st)
                   : rn_affine::launch<float>(pass, A, b, V, Ao, bo, Vo, tot,
                                              excl, N, n, chunk, st);
}

// Kernel 13': A (the forward's elements), gb and gV (null: the (A, b)
// scan's adjoint), the outputs lam, Lam (with gV); tot and excl scratch as
// rn_affine_scan_launch's. Three launches on the stream (one where n <=
// chunk); returns cudaGetLastError().
extern "C" int rn_affine_scan_adjoint_launch(const void* A, const void* gb,
                                             const void* gV, void* lam,
                                             void* Lam, void* tot, void* excl,
                                             int N, int n, int chunk,
                                             int is_double, void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double ? rn_affine::launch_adjoint<double>(
                         -1, A, gb, gV, lam, Lam, tot, excl, N, n, chunk, st)
                   : rn_affine::launch_adjoint<float>(
                         -1, A, gb, gV, lam, Lam, tot, excl, N, n, chunk, st);
}

// out (9 ints) of pass 0 (totals), 1 (carry), 2 (apply), 3 (kernel 13''s
// totals) or 4 (its apply): threads a block, dynamic shared bytes, blocks
// an SM holds, registers, local bytes; then the design: ring stages, a
// tile's rows, threads a row, a tile's columns
extern "C" int rn_affine_scan_info(int pass, int is_double, int* out) {
  return is_double ? rn_affine::info<double>(pass, out)
                   : rn_affine::info<float>(pass, out);
}

#else  // the host build (tests): the same block functions, one thread each

namespace rn_affine {

template <typename S>
int host(const S* A, const S* b, const S* V, S* Ao, S* bo, S* Vo, S* tot,
         S* excl, int N, int n, int chunk) {
  using T = typename ChunkTile<S>::T;
  const int nc = (n + chunk - 1) / chunk;
  S* sm = (S*)malloc(sizeof(S) * max_(Lay<S, T>::TOTAL,
                                      Lay<S, CarryTile>::TOTAL));
  if (nc > 1) {
    for (int l = 0; l < N; ++l)
      for (int c = 0; c < nc; ++c)
        totals_block<S, T>(A, b, V, tot, n, chunk, nc, c, l, false, sm, 0, 1);
    for (int l = 0; l < N; ++l)
      carry_block<S, CarryTile>(tot, excl, V != nullptr, nc, l, false, sm, 0,
                                1);
  }
  for (int l = 0; l < N; ++l)
    for (int c = 0; c < nc; ++c)
      apply_block<S, T>(A, b, V, nc > 1 ? excl : nullptr, Ao, bo, Vo, n,
                        chunk, nc, c, l, false, sm, 0, 1);
  free(sm);
  return 0;
}

template <typename S>
int host_adjoint(const S* A, const S* gb, const S* gV, S* lam, S* Lam,
                 S* tot, S* excl, int N, int n, int chunk) {
  using T = typename ChunkTile<S>::T;
  const int nc = (n + chunk - 1) / chunk;
  S* sm = (S*)malloc(sizeof(S) * max_(Lay<S, T>::TOTAL,
                                      Lay<S, CarryTile>::TOTAL));
  if (nc > 1) {
    for (int l = 0; l < N; ++l)
      for (int c = 0; c < nc; ++c)
        totals_rev_block<S, T>(A, gb, gV, tot, n, chunk, nc, c, l, false, sm,
                               0, 1);
    for (int l = 0; l < N; ++l)
      carry_block<S, CarryTile>(tot, excl, gV != nullptr, nc, l, false, sm,
                                0, 1);
  }
  for (int l = 0; l < N; ++l)
    for (int c = 0; c < nc; ++c)
      apply_rev_block<S, T>(A, gb, gV, nc > 1 ? excl : nullptr, lam, Lam, n,
                            chunk, nc, c, l, false, sm, 0, 1);
  free(sm);
  return 0;
}

}  // namespace rn_affine

extern "C" int rn_affine_scan_adjoint_host(const void* A, const void* gb,
                                           const void* gV, void* lam,
                                           void* Lam, void* tot, void* excl,
                                           int N, int n, int chunk,
                                           int is_double) {
  if (is_double)
    return rn_affine::host_adjoint<double>(
        (const double*)A, (const double*)gb, (const double*)gV, (double*)lam,
        (double*)Lam, (double*)tot, (double*)excl, N, n, chunk);
  return rn_affine::host_adjoint<float>(
      (const float*)A, (const float*)gb, (const float*)gV, (float*)lam,
      (float*)Lam, (float*)tot, (float*)excl, N, n, chunk);
}

extern "C" int rn_affine_scan_host(const void* A, const void* b,
                                   const void* V, void* Ao, void* bo,
                                   void* Vo, void* tot, void* excl, int N,
                                   int n, int chunk, int is_double) {
  if (is_double)
    return rn_affine::host<double>(
        (const double*)A, (const double*)b, (const double*)V, (double*)Ao,
        (double*)bo, (double*)Vo, (double*)tot, (double*)excl, N, n, chunk);
  return rn_affine::host<float>(
      (const float*)A, (const float*)b, (const float*)V, (float*)Ao,
      (float*)bo, (float*)Vo, (float*)tot, (float*)excl, N, n, chunk);
}

#endif  // __CUDACC__
