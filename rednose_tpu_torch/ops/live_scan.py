"""Fused T-step scans of the live ESKF bank (kernels 2 and 3).

`live_bank_scan` replaces the Pallas TPU kernel
rednose_tpu/ops/pallas_live.py:_kernel (launched by live_bank_scan);
`live_bank_scan_mixed` replaces pallas_live.py:_mixed_kernel (launched by
live_bank_scan_mixed). CUDA source: csrc/live_scan.cu.

Layout, bank-minor (no TPU sublane fold): x (23, B), P (22, 22, B),
zs (T, 3, B) with dz = 1 kinds reading row 0, dts (T,). Q enters as its
diagonal q_diag (22,) and R as small tensors, all on the bank's device.
The JAX package's folded (23, 8, B/8) / (22, 22, 8, B/8) arrays reshape
to this layout exactly (rednose_tpu_torch/interop.py).

Both wrappers return new (x, P) and never write their inputs: for CPU
tensors they run the plain version (the live_lane slab loop); for CUDA
tensors (f32, contiguous) they copy x and P once and launch the kernel,
which updates the copies in place, or raise.
"""

from __future__ import annotations

import torch

from rednose_tpu_torch import _build
from rednose_tpu_torch.ops import live_lane
from rednose_tpu_torch.utils.chi2 import chi2_ppf

DIM_X, DIM_E = 23, 22


def live_bank_scan_reference(x, P, zs, dts, q_diag, R, gate: bool = False):
  """Plain torch version of kernel 2: T x live_lane.live_step_slab."""
  for t in range(zs.shape[0]):
    x, P, _ = live_lane.live_step_slab(x, P, q_diag, dts[t], zs[t], R,
                                       gate=gate)
  return x, P


def live_bank_scan_mixed_reference(x, P, zs, dts, kind_idx, kinds, R_by_kind,
                                   q_diag, gate: bool = False, r_stream=None,
                                   stream_kinds=()):
  """Plain torch version of kernel 3: live_lane.live_mixed_scan on the
  bank-minor layout. R_by_kind is (K, 3, 3), the dz x dz top-left block
  read for each kind."""
  R_map = {k: R_by_kind[i, :live_lane.LANE_KINDS[k][0],
                        :live_lane.LANE_KINDS[k][0]]
           for i, k in enumerate(kinds)}
  x_lanes, P = live_lane.live_mixed_scan(
      x.T, P, q_diag, dts, kind_idx, zs.transpose(1, 2), R_map, tuple(kinds),
      gate, r_stream, tuple(stream_kinds))
  return x_lanes.T, P


def _check_state(x, P, zs, dts, q_diag):
  T, B = zs.shape[0], x.shape[-1]
  _build.check_tensor("x", x, (DIM_X, B))
  _build.check_tensor("P", P, (DIM_E, DIM_E, B))
  _build.check_tensor("zs", zs, (T, 3, B))
  _build.check_tensor("dts", dts, (T,))
  _build.check_tensor("q_diag", q_diag, (DIM_E,))
  return T, B


def live_bank_scan(x, P, zs, dts, q_diag, R, gate: bool = False):
  """T fused predict + ECEF_POS-update steps over a B-wide live bank.

  x (23, B), P (22, 22, B), zs (T, 3, B), dts (T,), q_diag (22,), R (3, 3).
  The gate, when on, uses chi2(0.95, 3). Returns the new (x, P)."""
  if x.device.type == "cpu":
    return live_bank_scan_reference(x, P, zs, dts, q_diag, R, gate)
  T, B = _check_state(x, P, zs, dts, q_diag)
  _build.check_tensor("R", R, (3, 3))
  x, P = x.clone(), P.clone()
  if T == 0:
    return x, P
  code = _build.library().live_bank_scan_launch(
      x.data_ptr(), P.data_ptr(), zs.data_ptr(), dts.data_ptr(),
      q_diag.data_ptr(), R.data_ptr(), T, B, int(gate),
      live_lane.MAHA_THRESH_3D,
      torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(code, "live_bank_scan")
  live_bank_scan.launches += 1
  return x, P


live_bank_scan.launches = 0


def live_bank_scan_mixed(x, P, zs, dts, kind_idx, kinds, R_by_kind, q_diag,
                         gate: bool = False, r_stream=None, stream_kinds=()):
  """T steps of a heterogeneous kind schedule over a B-wide live bank.

  kinds: tuple of live ObservationKind ids (each in live_lane.LANE_KINDS);
  kind_idx (T,) int32 indices into kinds, the same for the whole bank at a
  step; R_by_kind (K, 3, 3), each kind's dz x dz noise in its top-left
  block; kinds in `stream_kinds` take diag(r_stream[t]) (r_stream (T, 3))
  instead (the camera-odometry kinds, live_kf.py:325-337). The gate, when
  on, uses chi2(0.95, dz) of each kind. Returns the new (x, P)."""
  kinds = tuple(int(k) for k in kinds)
  stream_kinds = tuple(int(k) for k in stream_kinds)
  if not all(k in live_lane.LANE_KINDS for k in kinds):
    raise ValueError(f"kinds {kinds} are not all live lane kinds")
  if (r_stream is None) != (not stream_kinds):
    raise ValueError("r_stream and stream_kinds go together")
  if x.device.type == "cpu":
    return live_bank_scan_mixed_reference(x, P, zs, dts, kind_idx, kinds,
                                          R_by_kind, q_diag, gate, r_stream,
                                          stream_kinds)
  T, B = _check_state(x, P, zs, dts, q_diag)
  n = len(kinds)
  _build.check_tensor("kind_idx", kind_idx, (T,), torch.int32)
  if T and not 0 <= int(kind_idx.min()) <= int(kind_idx.max()) < n:
    raise ValueError(f"kind_idx outside [0, {n})")
  _build.check_tensor("R_by_kind", R_by_kind, (n, 3, 3))
  dev = x.device
  if r_stream is None:
    r_stream = torch.zeros((T, 3), dtype=torch.float32, device=dev)
  _build.check_tensor("r_stream", r_stream, (T, 3))
  kinds_t = torch.tensor(kinds, dtype=torch.int32, device=dev)
  flags = torch.tensor([int(k in stream_kinds) for k in kinds],
                       dtype=torch.int32, device=dev)
  thresh = torch.tensor([chi2_ppf(0.95, live_lane.LANE_KINDS[k][0])
                         for k in kinds], dtype=torch.float32, device=dev)
  x, P = x.clone(), P.clone()
  if T == 0:
    return x, P
  code = _build.library().live_bank_scan_mixed_launch(
      x.data_ptr(), P.data_ptr(), zs.data_ptr(), dts.data_ptr(),
      kind_idx.data_ptr(), kinds_t.data_ptr(), R_by_kind.data_ptr(),
      flags.data_ptr(), thresh.data_ptr(), r_stream.data_ptr(),
      q_diag.data_ptr(), T, B, int(gate),
      torch.cuda.current_stream(dev).cuda_stream)
  _build.check(code, "live_bank_scan_mixed")
  live_bank_scan_mixed.launches += 1
  return x, P


live_bank_scan_mixed.launches = 0
