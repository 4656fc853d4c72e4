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
// Design, three passes over chunks of `chunk` elements (the JAX package's
// chunked scan, with the lanes on blocks): (1) a block per (chunk, lane)
// composes its chunk's elements, the latest innermost, into the chunk's
// total; (2) a block per lane composes the totals from the last chunk
// back, giving each chunk the composition of every later chunk (its
// carry); (3) a block per (chunk, lane) walks its chunk from the carry,
// last element first, storing each out[k]. A combine is D^3 FMAs for A
// and 2 D^3 for V: a block of AFFINE_THREADS threads shares them through
// shared memory, an entry a thread, three barriers a combine. Passes 1 and
// 2 compose A (the totals need it); pass 3 only where out A is asked for.
// Bound: operations, ~5 D^3 FMAs an element with V (2 D^3 without), or
// the bytes of the elements in and out. With n = 8191 and chunk 64 there
// are 128 chunks a lane, so pass 2's chain of 128 combines a lane is its
// critical path.

#include <stddef.h>
#include <stdlib.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define AF_HD __host__ __device__
#else
#define AF_HD
#endif

#ifndef RN_AFFINE_D
#error "define RN_AFFINE_D, the elements' size, before including affine_scan.cu"
#endif

namespace rn_affine {

constexpr int D = RN_AFFINE_D;
constexpr int AFFINE_THREADS = 128;
constexpr int SMEM = 5 * D * D + 2 * D;   // scalars a block

AF_HD inline void barrier() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// The combine state in shared memory: the composition so far (Ap, bp,
// Vp), the element being applied (Ak), scratch for the new A and b (An,
// bn) and for A_k Vp (M).
template <typename S>
struct State {
  S* Ak;
  S* Ap;
  S* An;
  S* Vp;
  S* M;
  S* bp;
  S* bn;
  AF_HD explicit State(S* sm)
      : Ak(sm), Ap(sm + D * D), An(sm + 2 * D * D), Vp(sm + 3 * D * D),
        M(sm + 4 * D * D), bp(sm + 5 * D * D), bn(sm + 5 * D * D + D) {}

  // (Ap, bp, Vp) := the identity map (or the given map, when A0 is not
  // null): A = I, b = 0, V = 0
  AF_HD void load(const S* A0, const S* b0, const S* V0, int tid, int nt) {
    for (int q = tid; q < D * D; q += nt) {
      Ap[q] = A0 ? A0[q] : (S)(q / D == q % D);
      Vp[q] = V0 ? V0[q] : (S)0;
    }
    for (int i = tid; i < D; i += nt) bp[i] = b0 ? b0[i] : (S)0;
    barrier();
  }

  AF_HD void store(S* A0, S* b0, S* V0, int tid, int nt) const {
    for (int q = tid; q < D * D; q += nt) {
      A0[q] = Ap[q];
      if (V0) V0[q] = Vp[q];
    }
    for (int i = tid; i < D; i += nt) b0[i] = bp[i];
  }

  // the element (Ag, bg, Vg) wraps the composition so far: A := A_k A,
  // b := A_k b + b_k, V := V_k + A_k V A_k^T (V only with Vg, A only
  // with want_A); the new b, V, A also stored to bo, Vo, Ao where given
  AF_HD void apply(const S* Ag, const S* bg, const S* Vg, bool want_A,
                   S* Ao, S* bo, S* Vo, int tid, int nt) {
    for (int q = tid; q < D * D; q += nt) Ak[q] = Ag[q];
    barrier();
    for (int i = tid; i < D; i += nt) {
      S s = 0;
      for (int j = 0; j < D; ++j) s += Ak[i * D + j] * bp[j];
      s += bg[i];
      bn[i] = s;
      if (bo) bo[i] = s;
    }
    for (int q = tid; q < D * D; q += nt) {
      const int i = q / D, j = q % D;
      if (want_A) {
        S s = 0;
        for (int l = 0; l < D; ++l) s += Ak[i * D + l] * Ap[l * D + j];
        An[q] = s;
        if (Ao) Ao[q] = s;
      }
      if (Vg) {
        S s = 0;
        for (int l = 0; l < D; ++l) s += Ak[i * D + l] * Vp[l * D + j];
        M[q] = s;
      }
    }
    barrier();
    if (Vg)
      for (int q = tid; q < D * D; q += nt) {
        const int i = q / D, j = q % D;
        S s = 0;
        for (int l = 0; l < D; ++l) s += M[i * D + l] * Ak[j * D + l];
        s += Vg[q];
        Vp[q] = s;
        if (Vo) Vo[q] = s;
      }
    S* t = bp; bp = bn; bn = t;
    if (want_A) { t = Ap; Ap = An; An = t; }
    barrier();
  }
};

constexpr size_t TOT = 2 * D * D + D;   // scalars of a stored map

// pass 1: chunk c of lane l composed into tot[l, c]
template <typename S>
AF_HD void totals_block(const S* A, const S* b, const S* V, S* tot, int n,
                        int chunk, int nc, int c, int l, S* sm, int tid,
                        int nt) {
  State<S> st(sm);
  st.load(nullptr, nullptr, nullptr, tid, nt);
  const int lo = c * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const size_t e0 = (size_t)l * n;
  for (int k = hi - 1; k >= lo; --k)
    st.apply(A + (e0 + k) * D * D, b + (e0 + k) * D,
             V ? V + (e0 + k) * D * D : nullptr, true, nullptr, nullptr,
             nullptr, tid, nt);
  S* t = tot + ((size_t)l * nc + c) * TOT;
  st.store(t, t + D * D, V ? t + D * D + D : nullptr, tid, nt);
}

// pass 2: excl[l, c] = tot[l, nc-1] o ... o tot[l, c+1] (the identity for
// the last chunk)
template <typename S>
AF_HD void carry_block(const S* tot, S* excl, bool has_v, int nc, int l,
                       S* sm, int tid, int nt) {
  State<S> st(sm);
  st.load(nullptr, nullptr, nullptr, tid, nt);
  const size_t l0 = (size_t)l * nc;
  for (int c = nc - 1; c >= 0; --c) {
    S* x = excl + (l0 + c) * TOT;
    st.store(x, x + D * D, has_v ? x + D * D + D : nullptr, tid, nt);
    if (c == 0) break;
    const S* t = tot + (l0 + c) * TOT;
    st.apply(t, t + D * D, has_v ? t + D * D + D : nullptr, true, nullptr,
             nullptr, nullptr, tid, nt);
  }
}

// pass 3: chunk c of lane l from its carry (excl null: the identity)
template <typename S>
AF_HD void apply_block(const S* A, const S* b, const S* V, const S* excl,
                       S* Ao, S* bo, S* Vo, int n, int chunk, int nc, int c,
                       int l, S* sm, int tid, int nt) {
  State<S> st(sm);
  if (excl) {
    const S* x = excl + ((size_t)l * nc + c) * TOT;
    st.load(x, x + D * D, V ? x + D * D + D : nullptr, tid, nt);
  } else {
    st.load(nullptr, nullptr, nullptr, tid, nt);
  }
  const int lo = c * chunk, hi = lo + chunk < n ? lo + chunk : n;
  const size_t e0 = (size_t)l * n;
  for (int k = hi - 1; k >= lo; --k) {
    const size_t e = e0 + k;
    st.apply(A + e * D * D, b + e * D, V ? V + e * D * D : nullptr,
             Ao != nullptr, Ao ? Ao + e * D * D : nullptr, bo + e * D,
             V ? Vo + e * D * D : nullptr, tid, nt);
  }
}

}  // namespace rn_affine

#ifdef __CUDACC__

namespace rn_affine {

template <typename S>
__global__ void totals_kernel(const S* A, const S* b, const S* V, S* tot,
                              int n, int chunk, int nc) {
  extern __shared__ __align__(16) unsigned char smem_[];
  totals_block<S>(A, b, V, tot, n, chunk, nc, blockIdx.x, blockIdx.y,
                  reinterpret_cast<S*>(smem_), threadIdx.x, blockDim.x);
}

template <typename S>
__global__ void carry_kernel(const S* tot, S* excl, int has_v, int nc) {
  extern __shared__ __align__(16) unsigned char smem_[];
  carry_block<S>(tot, excl, has_v != 0, nc, blockIdx.x,
                 reinterpret_cast<S*>(smem_), threadIdx.x, blockDim.x);
}

template <typename S>
__global__ void apply_kernel(const S* A, const S* b, const S* V,
                             const S* excl, S* Ao, S* bo, S* Vo, int n,
                             int chunk, int nc) {
  extern __shared__ __align__(16) unsigned char smem_[];
  apply_block<S>(A, b, V, excl, Ao, bo, Vo, n, chunk, nc, blockIdx.x,
                 blockIdx.y, reinterpret_cast<S*>(smem_), threadIdx.x,
                 blockDim.x);
}

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename S>
int launch(const void* A, const void* b, const void* V, void* Ao, void* bo,
           void* Vo, void* tot, void* excl, int N, int n, int chunk,
           cudaStream_t st) {
  const size_t smem = sizeof(S) * SMEM;
  const int nc = (n + chunk - 1) / chunk;
  cudaError_t err = allow_smem(totals_kernel<S>, smem);
  if (err == cudaSuccess) err = allow_smem(carry_kernel<S>, smem);
  if (err == cudaSuccess) err = allow_smem(apply_kernel<S>, smem);
  if (err != cudaSuccess) return (int)err;
  if (nc > 1) {
    totals_kernel<S><<<dim3(nc, N), AFFINE_THREADS, smem, st>>>(
        (const S*)A, (const S*)b, (const S*)V, (S*)tot, n, chunk, nc);
    carry_kernel<S><<<N, AFFINE_THREADS, smem, st>>>(
        (const S*)tot, (S*)excl, V != nullptr, nc);
  }
  apply_kernel<S><<<dim3(nc, N), AFFINE_THREADS, smem, st>>>(
      (const S*)A, (const S*)b, (const S*)V,
      nc > 1 ? (const S*)excl : nullptr, (S*)Ao, (S*)bo, (S*)Vo, n, chunk,
      nc);
  return (int)cudaGetLastError();
}

template <typename K>
int kernel_info(K kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, AFFINE_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = AFFINE_THREADS;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return 0;
}

template <typename S>
int info(int pass, int* out) {
  const size_t smem = sizeof(S) * SMEM;
  if (pass == 0) return kernel_info(totals_kernel<S>, smem, out);
  if (pass == 1) return kernel_info(carry_kernel<S>, smem, out);
  return kernel_info(apply_kernel<S>, smem, out);
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
  return is_double ? rn_affine::launch<double>(A, b, V, Ao, bo, Vo, tot,
                                               excl, N, n, chunk, st)
                   : rn_affine::launch<float>(A, b, V, Ao, bo, Vo, tot, excl,
                                              N, n, chunk, st);
}

// out (5 ints): threads a block, dynamic shared bytes, blocks an SM
// holds, registers, local bytes of pass 0 (totals), 1 (carry) or 2
// (apply)
extern "C" int rn_affine_scan_info(int pass, int is_double, int* out) {
  return is_double ? rn_affine::info<double>(pass, out)
                   : rn_affine::info<float>(pass, out);
}

#else  // the host build (tests): the same block functions, one thread each

namespace rn_affine {

template <typename S>
int host(const S* A, const S* b, const S* V, S* Ao, S* bo, S* Vo, S* tot,
         S* excl, int N, int n, int chunk) {
  const int nc = (n + chunk - 1) / chunk;
  S* sm = (S*)malloc(sizeof(S) * SMEM);
  if (nc > 1) {
    for (int l = 0; l < N; ++l)
      for (int c = 0; c < nc; ++c)
        totals_block<S>(A, b, V, tot, n, chunk, nc, c, l, sm, 0, 1);
    for (int l = 0; l < N; ++l)
      carry_block<S>(tot, excl, V != nullptr, nc, l, sm, 0, 1);
  }
  for (int l = 0; l < N; ++l)
    for (int c = 0; c < nc; ++c)
      apply_block<S>(A, b, V, nc > 1 ? excl : nullptr, Ao, bo, Vo, n, chunk,
                     nc, c, l, sm, 0, 1);
  free(sm);
  return 0;
}

}  // namespace rn_affine

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
