// Kernels 2 and 3: fused T-step scans of the live 23/22-dim ESKF bank.
//
// Kernel 2 (live_bank_scan_kernel) replaces the Pallas TPU kernel
// rednose_tpu/ops/pallas_live.py:_kernel (launched by live_bank_scan):
// every step is live_lane.live_step_slab, the block-sparse predict with
// diagonal Q and the ECEF_POS update.
// Kernel 3 (live_bank_scan_mixed_kernel) replaces
// rednose_tpu/ops/pallas_live.py:_mixed_kernel (launched by
// live_bank_scan_mixed): the same predict, then the closed-form update of
// the step's kind, any of the 8 live kinds (live_lane.LANE_KINDS), with a
// per-kind R or a streamed diagonal R (camera-odometry kinds).
// Plain versions and wrappers: rednose_tpu_torch/ops/live_lane.py and
// rednose_tpu_torch/ops/live_scan.py.
//
// Layout, bank-minor: x (23, B), P (22, 22, B), zs (T, 3, B). Element (i, j)
// of filter b's covariance is P[(i * 22 + j) * B + b], so 32 consecutive
// filters' values of every (i, j) are one coalesced 128-byte line.
//
// Design of both kernels (redesigned for the H100; csrc/live_mixed.cuh has
// the step): a block of 32 filters (lane = filter) and W warps (role =
// warp), live_mixed::POS_WARPS = 8 for kernel 2, live_mixed::WARPS = 4
// for kernel 3. P, x and 225 scratch values a filter stay in the
// block's shared memory for the whole T loop, 93,696 B a block, laid out
// [(value)][32] so a warp's 32 lanes touch 32 consecutive words (no bank
// conflict); they are loaded once, coalesced, from the bank-minor arrays
// and stored once. A step is five phases between barriers: the nominal
// predict of x and the 27 coefficients of dt A (one warp); M = (dt A) P
// rows 0:9 into the scratch (the warps split the columns); the P predict
// (the warps split the 45 entries of the 9 x 9 block and the columns of
// the coupling and the diagonal Q adds); the innovation of the step's kind
// (one warp, once a filter: h, H, HP, S, S^-1, the gate, K and the Joseph
// factor into the scratch, the error injection of x); the Joseph downdate
// (the warps split the 253 upper-triangle entries), beside the next step's
// nominal predict. The update is a template on the kind, so dz, the H
// blocks and their widths are constants, every loop unrolls and HP, S^-1,
// K and Tm live in registers or the scratch, never on the stack. Kernel 2's
// kind is the constant ECEF_POS (H an identity block, one R and threshold);
// kernel 3 switches on the step's kind, which is uniform across the bank,
// so no warp diverges, and reads a streamed or per-kind R. A lane past the
// bank (b >= B, the last block of a ragged bank) computes on a copy of
// filter B - 1, reaches every barrier, and stores nothing. Bound:
// operations, 0.04977 ms (kernel 2) and 0.05562 ms (kernel 3, the live
// 4-kind cycle) at B = 8192, T = 64, 67 TFLOP/s float32. The one-thread-a-
// filter kernels they replace, P in global memory through L2, ran 2.08 and
// 9.05 ms there. Each W is the fastest of 1, 2, 4 and 8 for its kernel
// (sweep_warps.py; PERF.md has the times and the ptxas reports).
//
// Numerics (IEEE f32, no fast-math: the gyro and accel kinds call sinf /
// cosf): P stays bitwise symmetric because every symmetric entry is
// computed once, for the upper triangle, and written to (i, j) and (j, i);
// with FMA contraction, computing (i, j) and (j, i) separately could give
// two values. The quaternion renorm uses rsqrtf (about 2 ulp), where the
// plain torch version uses torch.rsqrt. The gate `dist > thresh` is false
// for a NaN distance, so NaN does not gate. Kernels update x and P in
// place and allocate nothing.

#include <cuda_runtime.h>

#include "live_mixed.cuh"

namespace lm = live_mixed;

namespace {

// The block's tile: 32 filters' P, x and scratch, [(value)][32]; filter
// min(b, B - 1) of lane b, so a lane past the bank holds a copy.
struct Tile {
  float* P;
  float* x;
  float* sc;
  int lane, role, b, bc;
};

template <int W>
__device__ __forceinline__ Tile load_tile(float* smem, const float* xs,
                                          const float* Pg, int B) {
  Tile tl{smem, smem + lm::DE * lm::DE * 32,
          smem + (lm::DE * lm::DE + lm::DX) * 32, (int)threadIdx.x,
          (int)threadIdx.y, 0, 0};
  tl.b = blockIdx.x * 32 + tl.lane;
  tl.bc = tl.b < B ? tl.b : B - 1;
  for (int e = tl.role; e < lm::DE * lm::DE; e += W)
    tl.P[e * 32 + tl.lane] = Pg[(size_t)e * B + tl.bc];
  for (int i = tl.role; i < lm::DX; i += W)
    tl.x[i * 32 + tl.lane] = xs[(size_t)i * B + tl.bc];
  __syncthreads();
  return tl;
}

template <int W>
__device__ __forceinline__ void store_tile(const Tile& tl, float* xs,
                                           float* Pg, int B) {
  if (tl.b >= B) return;
  for (int e = tl.role; e < lm::DE * lm::DE; e += W)
    Pg[(size_t)e * B + tl.b] = tl.P[e * 32 + tl.lane];
  for (int i = tl.role; i < lm::DX; i += W)
    xs[(size_t)i * B + tl.b] = tl.x[i * 32 + tl.lane];
}

// Kernel 2: T x (predict + ECEF_POS update) on a block's tile (see above).
constexpr int W2 = lm::POS_WARPS;
__global__ void __launch_bounds__(32 * W2) live_bank_scan_kernel(
    float* __restrict__ xs, float* __restrict__ Pg,
    const float* __restrict__ zs, const float* __restrict__ dts,
    const float* __restrict__ q_diag, const float* __restrict__ Rg, int T,
    int B, int gate, float gate_thresh) {
  extern __shared__ float lm_tile[];
  const Tile tl = load_tile<W2>(lm_tile, xs, Pg, B);
  lm::scan<float, W2, lm::ECEF_POS>(
      lm::CardRoles{tl.role}, lm::Lane<float>{tl.x + tl.lane, 32},
      lm::Lane<float>{tl.P + tl.lane, 32}, lm::Lane<float>{tl.sc + tl.lane, 32},
      q_diag, T, gate != 0,
      lm::PosInput<float>{zs, dts, Rg, gate_thresh, B, tl.bc});
  store_tile<W2>(tl, xs, Pg, B);
}

// Kernel 3: T x (predict + update of kinds[kind_idx[t]]) on a block's tile.
// Per kind: R_by_kind (n_kinds, 3, 3), stream_flags (n_kinds,) -> R =
// diag(r_stream[t]) instead, gate_thresh (n_kinds,).
constexpr int W3 = lm::WARPS;
__global__ void __launch_bounds__(32 * W3) live_bank_scan_mixed_kernel(
    float* __restrict__ xs, float* __restrict__ Pg,
    const float* __restrict__ zs, const float* __restrict__ dts,
    const int* __restrict__ kind_idx, const int* __restrict__ kinds,
    const float* __restrict__ R_by_kind, const int* __restrict__ stream_flags,
    const float* __restrict__ gate_thresh, const float* __restrict__ r_stream,
    const float* __restrict__ q_diag, int T, int B, int gate) {
  extern __shared__ float lm_tile[];
  const Tile tl = load_tile<W3>(lm_tile, xs, Pg, B);
  lm::scan<float, W3, lm::ANY_KIND>(
      lm::CardRoles{tl.role}, lm::Lane<float>{tl.x + tl.lane, 32},
      lm::Lane<float>{tl.P + tl.lane, 32}, lm::Lane<float>{tl.sc + tl.lane, 32},
      q_diag, T, gate != 0,
      lm::MixedInput<float>{zs, dts, kind_idx, kinds, R_by_kind, stream_flags,
                            gate_thresh, r_stream, B, tl.bc});
  store_tile<W3>(tl, xs, Pg, B);
}

// both kernels' dynamic shared memory: 32 filters x (P, x, scratch),
// 93,696 B
constexpr int LM_SMEM = (int)sizeof(float) * 32 * lm::TILE;

template <typename K>
int set_smem(K kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LM_SMEM));
}

// A kernel's launch shape as the runtime reads it: out[0] warps a block,
// out[1] threads a block, out[2] dynamic shared memory bytes, out[3] blocks
// an SM holds at once, out[4] registers a thread, out[5] local memory
// (stack) bytes a thread.
template <int W, typename K>
int tile_info(K kernel, int* out) {
  int e = set_smem(kernel);
  if (e != 0) return e;
  int blocks = 0;
  e = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, 32 * W, LM_SMEM));
  if (e != 0) return e;
  cudaFuncAttributes attr;
  e = static_cast<int>(cudaFuncGetAttributes(&attr, kernel));
  if (e != 0) return e;
  out[0] = W;
  out[1] = 32 * W;
  out[2] = LM_SMEM;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

}  // namespace

extern "C" int live_bank_scan_launch(void* x, void* P, const void* zs,
                                     const void* dts, const void* q_diag,
                                     const void* R, int T, int B, int gate,
                                     float gate_thresh, void* stream) {
  const int e = set_smem(live_bank_scan_kernel);
  if (e != 0) return e;
  live_bank_scan_kernel<<<(B + 31) / 32, dim3(32, W2), LM_SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(P),
      static_cast<const float*>(zs), static_cast<const float*>(dts),
      static_cast<const float*>(q_diag), static_cast<const float*>(R), T, B,
      gate, gate_thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int live_bank_scan_mixed_launch(
    void* x, void* P, const void* zs, const void* dts, const void* kind_idx,
    const void* kinds, const void* R_by_kind, const void* stream_flags,
    const void* gate_thresh, const void* r_stream, const void* q_diag, int T,
    int B, int gate, void* stream) {
  // kind_idx is checked against the number of kinds by the wrapper
  const int e = set_smem(live_bank_scan_mixed_kernel);
  if (e != 0) return e;
  live_bank_scan_mixed_kernel<<<(B + 31) / 32, dim3(32, W3), LM_SMEM,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<float*>(P),
      static_cast<const float*>(zs), static_cast<const float*>(dts),
      static_cast<const int*>(kind_idx), static_cast<const int*>(kinds),
      static_cast<const float*>(R_by_kind),
      static_cast<const int*>(stream_flags),
      static_cast<const float*>(gate_thresh),
      static_cast<const float*>(r_stream), static_cast<const float*>(q_diag),
      T, B, gate);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int live_bank_scan_info(int* out) {
  return tile_info<W2>(live_bank_scan_kernel, out);
}

extern "C" int live_bank_scan_mixed_info(int* out) {
  return tile_info<W3>(live_bank_scan_mixed_kernel, out);
}
