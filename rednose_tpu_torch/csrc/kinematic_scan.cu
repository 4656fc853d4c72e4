// Kernel 1: fused T-step scan of the 2-state kinematic EKF bank.
//
// Replaces the Pallas TPU kernel rednose_tpu/ops/pallas_step.py:_kernel
// (launched by kinematic_bank_scan). Plain version and wrapper:
// rednose_tpu_torch/ops/kinematic_scan.py.
//
// Design: one thread per filter. Its 5 state floats (x0, x1, P00, P01, P11)
// live in registers for the whole scan; the TPU's sequential grid axis over
// time becomes the loop over T inside the kernel. Each step reads one
// measurement zs[t, b]: neighbouring threads read neighbouring addresses,
// so every warp load is one coalesced 128-byte line. dts[t] and rs[t] are
// the same address for every thread (broadcast through L1).
//
// Bound: HBM reads of zs, T*B*4 bytes (268 MB at B=16384, T=4096), against
// ~30 flops per step. The loads of step t+1..t+U are independent of the
// arithmetic of step t, so the unrolled loop keeps several in flight.
// No shared memory and no block-level synchronisation are needed.
// ptxas -v (CUDA 12.8, sm_90a): 36 registers, no stack, no spills.
//
// Numerics: IEEE f32 without fast-math; the gate `y*y > thresh*s` is false
// for a NaN distance, so NaN does not gate (as in the Pallas kernel).
// The kernel reads state_in and writes state_out; it allocates nothing.

#include <cuda_runtime.h>

namespace {

__global__ void kinematic_bank_scan_kernel(
    const float* __restrict__ state_in, float* __restrict__ state_out,
    const float* __restrict__ zs, const float* __restrict__ dts,
    const float* __restrict__ rs, const float* __restrict__ q, int T, int B,
    int maha, float maha_thresh) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float x0 = state_in[0 * B + b];
  float x1 = state_in[1 * B + b];
  float p00 = state_in[2 * B + b];
  float p01 = state_in[3 * B + b];
  float p11 = state_in[4 * B + b];
  const float q00 = q[0], q01 = q[1], q11 = q[2];

#pragma unroll 8
  for (int t = 0; t < T; ++t) {
    const float dt = __ldg(dts + t);
    const float r = __ldg(rs + t);
    const float z = __ldcs(zs + (size_t)t * B + b);  // streamed once
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
  state_out[0 * B + b] = x0;
  state_out[1 * B + b] = x1;
  state_out[2 * B + b] = p00;
  state_out[3 * B + b] = p01;
  state_out[4 * B + b] = p11;
}

}  // namespace

extern "C" int kinematic_bank_scan_launch(
    const void* state_in, void* state_out, const void* zs, const void* dts,
    const void* rs, const void* q, int T, int B, int maha, float maha_thresh,
    void* stream) {
  // 64 threads a block: B = 16384 filters give 256 blocks, so every one of
  // the 132 SMs holds work (256-thread blocks would leave half of them idle)
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  kinematic_bank_scan_kernel<<<blocks, threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state_in), static_cast<float*>(state_out),
      static_cast<const float*>(zs), static_cast<const float*>(dts),
      static_cast<const float*>(rs), static_cast<const float*>(q), T, B, maha,
      maha_thresh);
  return static_cast<int>(cudaGetLastError());
}
