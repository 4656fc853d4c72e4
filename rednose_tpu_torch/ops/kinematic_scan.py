"""Fused T-step scan of the 2-state kinematic EKF bank (kernel 1).

Replaces the Pallas TPU kernel rednose_tpu/ops/pallas_step.py:_kernel
(launched by pallas_step.kinematic_bank_scan). CUDA source:
csrc/kinematic_scan.cu.

Each step is the closed form of the generic core/step.py step for
F = [[1, dt], [0, 1]], H = [1, 0], Q = [[q00, q01], [q01, q11]] scaled by
dt, and a scalar R: predict, update, optional Mahalanobis gate by zero gain
(chi2(0.95, 1); a NaN distance does not gate), scalar Joseph form.

Layout (bank-minor, no TPU sublane fold): state (5, B) with rows
x0 (position), x1 (velocity), P00, P01, P11; zs (T, B); dts (T,); rs (T,);
q (3,) = [q00, q01, q11]. The JAX package's packed (40, B/8) state
reshapes to (5, B) exactly (rednose_tpu_torch/interop.py).

`kinematic_bank_scan` is the wrapper: for CPU tensors it runs
`kinematic_scan_reference`, the plain torch loop; for CUDA tensors it
launches the kernel or raises. `launch_shape` reads the kernel's launch
shape from the CUDA runtime.
"""

from __future__ import annotations

import ctypes

import torch

from rednose_tpu_torch import _build
from rednose_tpu_torch.utils.chi2 import chi2_ppf

# chi2.ppf(0.95, 1), the threshold the reference bakes for 1-dim gated
# kinds (ekf_sym.py:144-147)
MAHA_THRESH_1D = chi2_ppf(0.95, 1)

STATE_ROWS = 5  # x0, x1, P00, P01, P11


def pack_state(x, P):
  """(B, 2) state + (B, 2, 2) covariance -> (5, B) bank-minor state."""
  return torch.stack([x[:, 0], x[:, 1], P[:, 0, 0], P[:, 0, 1], P[:, 1, 1]])


def unpack_state(s):
  """(5, B) -> ((B, 2) state, (B, 2, 2) covariance)."""
  x0, x1, p00, p01, p11 = s
  x = torch.stack([x0, x1], dim=-1)
  P = torch.stack([torch.stack([p00, p01], dim=-1),
                   torch.stack([p01, p11], dim=-1)], dim=-2)
  return x, P


def kinematic_scan_reference(state, zs, dts, rs, q, maha: bool = False,
                             maha_thresh: float = MAHA_THRESH_1D):
  """Plain torch version of the kernel: T steps, one op per line of
  pallas_step._kernel's body. Returns the new (5, B) state."""
  x0, x1, p00, p01, p11 = state.unbind(0)
  q00, q01, q11 = q[0], q[1], q[2]
  for k in range(zs.shape[0]):
    dt, r, z = dts[k], rs[k], zs[k]
    # predict: x <- F x, P <- F P F^T + dt*Q (ekf_c.c:8-33 closed form)
    x0 = x0 + dt * x1
    p00 = p00 + dt * (2.0 * p01 + dt * p11) + dt * q00
    p01 = p01 + dt * p11 + dt * q01
    p11 = p11 + dt * q11
    # update with H = [1, 0], scalar innovation
    y = z - x0
    s = p00 + r
    inv_s = 1.0 / s
    k0 = p00 * inv_s
    k1 = p01 * inv_s
    if maha:
      gated = y * y > maha_thresh * s
      k0 = torch.where(gated, torch.zeros_like(k0), k0)
      k1 = torch.where(gated, torch.zeros_like(k1), k1)
    x0 = x0 + k0 * y
    x1 = x1 + k1 * y
    # Joseph form (ekf_c.c:115), scalar expansion
    a = 1.0 - k0
    p00_n = a * a * p00 + k0 * k0 * r
    p01_n = a * (p01 - k1 * p00) + k0 * k1 * r
    p11_n = p11 - 2.0 * k1 * p01 + k1 * k1 * p00 + k1 * k1 * r
    p00, p01, p11 = p00_n, p01_n, p11_n
  return torch.stack([x0, x1, p00, p01, p11])


def kinematic_bank_scan(state, zs, dts, rs, q, maha: bool = False,
                        maha_thresh: float = MAHA_THRESH_1D):
  """Run T fused predict+update steps over a B-wide kinematic bank.

  state (5, B); zs (T, B); dts (T,) and rs (T,) shared across the bank;
  q (3,) = [q00, q01, q11]. Returns the new (5, B) state (the input is not
  written). CPU tensors take the plain version; CUDA tensors (f32,
  contiguous) launch the kernel.
  """
  T, B = zs.shape
  if state.device.type == "cpu":
    return kinematic_scan_reference(state, zs, dts, rs, q, maha, maha_thresh)
  _build.check_tensor("state", state, (STATE_ROWS, B))
  _build.check_tensor("zs", zs, (T, B))
  _build.check_tensor("dts", dts, (T,))
  _build.check_tensor("rs", rs, (T,))
  _build.check_tensor("q", q, (3,))
  out = torch.empty_like(state)
  if T == 0:
    return out.copy_(state)
  lib = _build.library()
  code = lib.kinematic_bank_scan_launch(
      state.data_ptr(), out.data_ptr(), zs.data_ptr(), dts.data_ptr(),
      rs.data_ptr(), q.data_ptr(), T, B, int(maha), float(maha_thresh),
      torch.cuda.current_stream(state.device).cuda_stream)
  _build.check(code, "kinematic_bank_scan")
  kinematic_bank_scan.launches += 1
  return out


kinematic_bank_scan.launches = 0


def launch_shape() -> dict:
  """The kernel's launch shape as the CUDA runtime reads it (entry
  kinematic_bank_scan_info): warps and threads a block (a thread a
  filter), dynamic shared memory bytes, blocks an SM holds, registers and
  local (stack) bytes a thread, the steps a ring stage holds and the ring's
  stages (csrc/kinematic_scan.cu)."""
  out = (ctypes.c_int * 8)()
  _build.check(_build.library().kinematic_bank_scan_info(
      ctypes.addressof(out)), "kinematic_bank_scan_info")
  return dict(zip(("warps", "threads", "smem_bytes", "blocks_per_sm",
                   "registers", "local_bytes", "chunk_steps", "stages"), out))
