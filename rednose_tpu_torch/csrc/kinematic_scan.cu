// Kernel 1: fused T-step scan of the 2-state kinematic EKF bank.
//
// Replaces the Pallas TPU kernel rednose_tpu/ops/pallas_step.py:_kernel
// (launched by kinematic_bank_scan). Plain version and wrapper:
// rednose_tpu_torch/ops/kinematic_scan.py.
//
// Design: one thread per filter, its 5 state floats (x0, x1, P00, P01,
// P11) in registers for the whole scan; the TPU's sequential grid axis
// over time becomes the loop over T inside the kernel. A block holds LANES
// filters and streams their measurements through a ring of STAGES stages
// in shared memory, each CHUNK steps x LANES filters of zs (a step's row
// is 4 * LANES contiguous bytes) with the chunk's dts and rs: before the
// block computes chunk k it issues the asynchronous copies (cp.async, 16 B
// a thread where the block's rows are whole and 16-B aligned, else one
// value a thread, a lane past the bank copying filter B - 1) of chunk
// k + STAGES - 1, so ~(STAGES - 1) chunks a block are in flight whatever
// the number of warps, and a step reads its z, dt and r from shared
// memory. A ragged last chunk (T not a multiple of CHUNK) copies and runs
// its rows only; lanes past the bank (B not a multiple of LANES) compute
// and store nothing.
//
// Bound: HBM reads of zs, T*B*4 bytes (268 MB at B=16384, T=4096: 0.080
// ms at 3.35 TB/s), against ~30 flops a step. The step is one dependent
// chain (predict, the IEEE reciprocal, the gate, Joseph) that the gate
// makes non-associative, so T times its latency is a floor no scan over
// time avoids (sweep_warps.py times it with the loads removed; PERF.md).
// The design before this one read z straight from global memory with an
// unrolled loop and left a DRAM round trip on every step (1.7042 ms on an
// H100 80GB HBM3 at 700 W; PERF.md). LANES, CHUNK and STAGES were chosen
// by measurement (sweep_warps.py; PERF.md).
//
// Numerics: IEEE f32 without fast-math, the step's arithmetic unchanged
// from the design before (the same output, bit for bit); the gate
// `y*y > thresh*s` is false for a NaN distance, so NaN does not gate (as
// in the Pallas kernel). The kernel reads state_in and writes state_out;
// it allocates nothing.

#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int LANES = 32;    // filters a block, one a thread
constexpr int CHUNK = 128;   // steps a ring stage holds
constexpr int STAGES = 3;    // ring stages
// floats of one stage: CHUNK rows of LANES measurements, CHUNK dts, CHUNK rs
constexpr int STAGE_FLOATS = CHUNK * LANES + 2 * CHUNK;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Steps t0 .. t0 + n - 1 of the block's filters b0 .. into one ring
// stage, asynchronously; the caller commits the group.
__device__ __forceinline__ void stage_chunk(
    float* stage, const float* __restrict__ zs, const float* __restrict__ dts,
    const float* __restrict__ rs, int t0, int n, int B, int b0, int tid,
    bool whole) {
  if (whole) {
    constexpr int PIECES = LANES / 4;  // 16-B copies a row
    for (int c = tid; c < n * PIECES; c += LANES) {
      const int row = c / PIECES, col = (c % PIECES) * 4;
      cp_async(stage + row * LANES + col,
               zs + (size_t)(t0 + row) * B + b0 + col, 16);
    }
  } else {
    for (int c = tid; c < n * LANES; c += LANES) {
      const int row = c / LANES, b = min(b0 + c % LANES, B - 1);
      cp_async(stage + c, zs + (size_t)(t0 + row) * B + b, 4);
    }
  }
  for (int j = tid; j < n; j += LANES) {
    cp_async(stage + CHUNK * LANES + j, dts + t0 + j, 4);
    cp_async(stage + CHUNK * LANES + CHUNK + j, rs + t0 + j, 4);
  }
}

__global__ void __launch_bounds__(LANES) kinematic_bank_scan_kernel(
    const float* __restrict__ state_in, float* __restrict__ state_out,
    const float* __restrict__ zs, const float* __restrict__ dts,
    const float* __restrict__ rs, const float* __restrict__ q, int T, int B,
    int maha, float maha_thresh) {
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * LANES, b = b0 + tid;
  const int bc = b < B ? b : B - 1;
  const bool whole = b0 + LANES <= B && B % 4 == 0 &&
                     reinterpret_cast<size_t>(zs) % 16 == 0;
  const int nchunks = (T + CHUNK - 1) / CHUNK;
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nchunks)
      stage_chunk(ring + k * STAGE_FLOATS, zs, dts, rs, k * CHUNK,
                  min(CHUNK, T - k * CHUNK), B, b0, tid, whole);
    cp_async_commit();  // empty past the last chunk: one group a chunk
  }
  float x0 = state_in[0 * B + bc];
  float x1 = state_in[1 * B + bc];
  float p00 = state_in[2 * B + bc];
  float p01 = state_in[3 * B + bc];
  float p11 = state_in[4 * B + bc];
  const float q00 = q[0], q01 = q[1], q11 = q[2];

  for (int k = 0; k < nchunks; ++k) {
    // chunk k + STAGES - 1 into the stage chunk k - 1 used, then wait for
    // chunk k (all groups but the STAGES - 1 newest)
    const int kn = k + STAGES - 1;
    if (kn < nchunks)
      stage_chunk(ring + (kn % STAGES) * STAGE_FLOATS, zs, dts, rs,
                  kn * CHUNK, min(CHUNK, T - kn * CHUNK), B, b0, tid, whole);
    cp_async_commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
    __syncthreads();
    const float* zr = ring + (k % STAGES) * STAGE_FLOATS;
    const float* dtr = zr + CHUNK * LANES;
    const float* rr = dtr + CHUNK;
    const int n = min(CHUNK, T - k * CHUNK);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float dt = dtr[j];
      const float r = rr[j];
      const float z = zr[j * LANES + tid];
      // predict: x <- F x, P <- F P F^T + dt*Q
      x0 = x0 + dt * x1;
      p00 = p00 + dt * (2.0f * p01 + dt * p11) + dt * q00;
      p01 = p01 + dt * p11 + dt * q01;
      p11 = p11 + dt * q11;
      // update with H = [1, 0]
      const float y = z - x0;
      const float s = p00 + r;
      const float inv_s = 1.0f / s;
      float k0 = p00 * inv_s;
      float k1 = p01 * inv_s;
      if (maha && (y * y > maha_thresh * s)) {  // zero-gain rejection
        k0 = 0.0f;
        k1 = 0.0f;
      }
      x0 = x0 + k0 * y;
      x1 = x1 + k1 * y;
      // Joseph form, scalar expansion
      const float a = 1.0f - k0;
      const float p00_n = a * a * p00 + k0 * k0 * r;
      const float p01_n = a * (p01 - k1 * p00) + k0 * k1 * r;
      const float p11_n = p11 - 2.0f * k1 * p01 + k1 * k1 * p00 + k1 * k1 * r;
      p00 = p00_n;
      p01 = p01_n;
      p11 = p11_n;
    }
    __syncthreads();  // every lane done with the stage refilled next
  }
  if (b < B) {
    state_out[0 * B + b] = x0;
    state_out[1 * B + b] = x1;
    state_out[2 * B + b] = p00;
    state_out[3 * B + b] = p01;
    state_out[4 * B + b] = p11;
  }
}

}  // namespace

extern "C" int kinematic_bank_scan_launch(
    const void* state_in, void* state_out, const void* zs, const void* dts,
    const void* rs, const void* q, int T, int B, int maha, float maha_thresh,
    void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kinematic_bank_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (B + LANES - 1) / LANES;
  kinematic_bank_scan_kernel<<<blocks, LANES, SMEM_BYTES,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state_in), static_cast<float*>(state_out),
      static_cast<const float*>(zs), static_cast<const float*>(dts),
      static_cast<const float*>(rs), static_cast<const float*>(q), T, B, maha,
      maha_thresh);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 1's launch shape as the runtime reads it: out[0] warps a block,
// out[1] threads a block, out[2] dynamic shared memory bytes, out[3] blocks
// an SM holds at once, out[4] registers a thread, out[5] local memory
// (stack) bytes a thread, out[6] steps a ring stage, out[7] ring stages.
extern "C" int kinematic_bank_scan_info(int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kinematic_bank_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kinematic_bank_scan_kernel, LANES, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kinematic_bank_scan_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = LANES / 32;
  out[1] = LANES;
  out[2] = SMEM_BYTES;
  out[3] = blocks;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  out[6] = CHUNK;
  out[7] = STAGES;
  return 0;
}
