"""Facade for wide live-ESKF banks.

Port of rednose_tpu/runtime/live_bank.py:

    bank = LiveKalmanBank(batch=8192)          # device="cuda", float32
    bank.run(dts, zs)                          # ECEF_POS stream
    bank.run_mixed(dts, kind_idx, zs, kinds)   # heterogeneous schedule
    bank.observe(t, kind, z)                   # one timestamped observation
    bank.run_epochs(dts, zs, slot_kinds)       # predict + K updates a step
    bank.x, bank.P                             # (B, 23), (B, 22, 22)

On a CUDA device `run` launches kernel 2 (ops/live_scan.live_bank_scan),
and `run_mixed` and `observe` launch kernel 3
(ops/live_scan.live_bank_scan_mixed; observe with T = 1); `run_epochs`
launches the generic epoch kernel 5 on the live spec. On the CPU the
same wrappers run their plain torch versions. The hand kernels carry Q as
its diagonal. With an off-diagonal Q, on CUDA `run` launches the generic
kernel 4 (generic_scan.generic_bank_scan) and `run_mixed` and `observe`
kernel 6 (generic_bank_scan_mixed) on the live spec, which take Q by its
nonzero pattern; kernel 6's variant takes every live lane kind
(LIVE_KINDS), so one build serves every schedule. Streamed R exists only
in the hand kernels: with a full Q it raises on CUDA. On the CPU a full Q
takes the plain full-Q slab path. Time is kept on the host in float64;
only dts reach the device.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Sequence

import numpy as np
import torch

from rednose_tpu_torch.models.live import (
    LiveKalman,
    ObservationKind,
    build_live_spec,
)
from rednose_tpu_torch.ops import generic_scan, live_lane, live_scan, sparsity
from rednose_tpu_torch.runtime.bank_facade import BankFacadeBase
from rednose_tpu_torch.runtime.rewind import BankRewindRing
from rednose_tpu_torch.utils.device import resolve_device


# the kind set of the full-Q run_mixed / observe variant (kernel 6)
LIVE_KINDS = tuple(live_lane.LANE_KINDS)


@functools.cache
def gated_live_spec():
  """The live spec with every kind's Mahalanobis gate on: kernel 6 gates a
  kind as its maha_test says, and the live bank's gate=True gates every
  kind at chi2(0.95, dz), as the hand kernels do."""
  spec = build_live_spec()
  return dataclasses.replace(spec, name="live_gated", obs={
      k: dataclasses.replace(om, maha_test=True)
      for k, om in spec.obs.items()})


def _pad3(R, dz):
  """(dz, dz) noise -> (3, 3) with R in the top-left block."""
  out = np.zeros((3, 3))
  out[:dz, :dz] = np.asarray(R, dtype=np.float64).reshape(dz, dz)
  return out


class LiveKalmanBank(BankFacadeBase):
  """B independent live 23/22 ESKFs stepped together."""

  def __init__(self, batch: int, x0=None, P_diag=None, Q=None,
               dtype=torch.float32, device="cuda", t0: float = 0.0,
               max_rewind_age: float = 1.0, ckpt_every: int = 16,
               ckpt_keep: int = 8, ckpt_bytes: int | None = None,
               logger=logging):
    self.batch = batch
    self.dtype = dtype
    self.device = resolve_device(device)
    x0 = LiveKalman.initial_x if x0 is None else np.asarray(x0)
    P_diag = (LiveKalman.initial_P_diag if P_diag is None
              else np.asarray(P_diag))
    # per-lane x0: diverged lanes re-seed from the bank's own first row
    self._x0_1d = x0 if x0.ndim == 1 else np.asarray(x0[0])
    self._P_diag0 = P_diag
    self._quaternion_idxs = (3,)
    Q = np.asarray(LiveKalman.Q if Q is None else Q, dtype=np.float64)
    self._q_is_diag = bool(np.all(Q == np.diag(np.diag(Q))))
    # an off-diagonal Q on the card: the generic kernels 4 and 6
    self._generic = not self._q_is_diag and self.device.type == "cuda"
    self._calls = {}
    self.Q = self._tensor(Q)
    self._q_diag = self._tensor(np.diag(Q))
    x0 = self._tensor(x0)
    self._x = (x0[:, None].expand(-1, batch) if x0.ndim == 1
               else x0.T).contiguous()
    self._P = self._tensor(np.diag(P_diag))[:, :, None].expand(
        -1, -1, batch).contiguous()
    self.t = float(t0)
    self.max_rewind_age = max_rewind_age
    self.logger = logger
    self._ring = BankRewindRing(ckpt_every=ckpt_every, ckpt_keep=ckpt_keep,
                                ckpt_bytes=ckpt_bytes)

  # spec / structure / params / _default_R power the shared run_epochs,
  # which runs the generic epoch kernel (kernel 5) on the live spec
  params: dict = {}

  @property
  def spec(self):
    return LiveKalman.build_spec()

  @property
  def structure(self):
    return sparsity.structure_for(self.spec, LiveKalman.initial_x)

  def _default_R(self, kind):
    R = LiveKalman.obs_noise.get(int(kind))
    if R is None:
      raise ValueError(
          f"kind {kind} carries per-measurement noise in the reference "
          "(no obs_noise default, live_kf.py:325-337); pass R_by_slot")
    return R

  def _generic_call(self, mode, kinds, R_list, gate):
    """Kernel 4's or 6's call for the full Q, made once per (mode, kinds,
    gate) and kept, as KalmanBank keeps its calls: a repeated call builds
    nothing, and a new R (a GNSS fix's own noise) rewrites only the kept
    device copy of R (KernelCall.set_R)."""
    key = (mode, kinds, gate)
    call = self._calls.get(key)
    if call is None:
      spec = gated_live_spec() if gate and mode == "mixed" else self.spec
      call = self._calls[key] = generic_scan.KernelCall(
          spec, mode, kinds, Q=self.Q, R_list=R_list, gate=gate,
          structure=sparsity.structure_for(spec, LiveKalman.initial_x))
    return call.set_R(R_list)

  def _zs(self, zs):
    """(T, B, 3) measurements -> the kernels' (T, 3, B) on the device."""
    zs = torch.as_tensor(zs, dtype=self.dtype, device=self.device)
    if zs.ndim != 3 or zs.shape[1:] != (self.batch, 3):
      raise ValueError(f"zs {tuple(zs.shape)}, expected (T, {self.batch}, 3)")
    return zs.permute(0, 2, 1).contiguous()

  def _scan_mixed(self, dts, kind_idx, zs, kinds, R_stack, gate, r_stream,
                  stream_kinds):
    """One mixed scan: dts (T,) and kind_idx (T,) on the host, zs
    (T, 3, B) on the device, R_stack (K, 3, 3) host, per kind of kinds."""
    if self._generic:
      if stream_kinds:
        raise ValueError(
            "streamed R (r_stream / stream_kinds) runs only in the live hand "
            "kernels, which take a diagonal Q; with an off-diagonal Q on "
            "CUDA pass each kind's R in R_by_kind")
      R_list = []
      for k in LIVE_KINDS:
        dz = live_lane.LANE_KINDS[k][0]
        R = (R_stack[kinds.index(k)] if k in kinds
             else _pad3(LiveKalman.obs_noise.get(k, np.eye(dz)), dz))
        R_list.append(np.ascontiguousarray(R[:dz, :dz]))
      idx = np.array([LIVE_KINDS.index(k) for k in kinds])[kind_idx]
      return generic_scan.generic_bank_scan_mixed(
          self._x, self._P, zs, self._tensor(dts),
          self._tensor(idx, torch.int32),
          call=self._generic_call("mixed", LIVE_KINDS, R_list, bool(gate)))
    args = (self._x, self._P, zs, self._tensor(dts),
            self._tensor(kind_idx, torch.int32), kinds,
            self._tensor(R_stack))
    if self._q_is_diag:
      return live_scan.live_bank_scan_mixed(
          *args, self._q_diag, gate=gate, r_stream=r_stream,
          stream_kinds=stream_kinds)
    return live_scan.live_bank_scan_mixed_reference(
        *args, self.Q, gate=gate, r_stream=r_stream,
        stream_kinds=stream_kinds)

  # --------------------------------------------------- per-observation API

  def observe(self, t, kind, z, R=None, gate: bool = False):
    """Apply ONE timestamped observation to the whole bank with
    driver-style out-of-order handling (ekf_sym.py:464-482): a late
    observation inside the rewind window rolls the bank back to the newest
    snapshot at-or-before t and replays around it; older than the window
    it is dropped (returns None). z is (B, dz) or (dz,) broadcast across
    lanes; R defaults to LiveKalman.obs_noise[kind]."""
    kind = int(kind)
    if kind not in live_lane.LANE_KINDS:
      raise ValueError(f"kind {kind} is not a live lane kind")
    if R is None:
      R = LiveKalman.obs_noise[kind]
    dz = live_lane.LANE_KINDS[kind][0]
    z = np.asarray(z, dtype=np.float64)
    if z.ndim == 1:
      z = np.tile(z, (self.batch, 1))
    if z.shape != (self.batch, dz):
      raise ValueError(f"z {z.shape}, expected ({self.batch}, {dz})")
    if dz < 3:
      z = np.concatenate([z, np.zeros((self.batch, 3 - dz))], axis=1)
    R = np.asarray(R, dtype=np.float64).reshape(dz, dz)
    return self._observe_ordered(t, (kind, z, R, gate))

  def _apply_one(self, t, kind, z, R, gate):
    dt = max(float(t) - self.t, 0.0)
    dz = live_lane.LANE_KINDS[kind][0]
    self._x, self._P = self._scan_mixed(
        np.array([dt]), np.zeros(1, np.int64), self._zs(z[None]), (kind,),
        _pad3(R, dz)[None], gate, None, ())
    self.t = float(t)
    self._ring.record(self.t, (self._x, self._P), (self.t, kind, z, R, gate))

  # ------------------------------------------------------------------- runs

  def run(self, dts, zs, R=None, gate: bool = False):
    """T fused predict + ECEF_POS-update steps: dts (T,), zs (T, B, 3),
    R (3, 3) shared (defaults to LiveKalman.obs_noise). Advances bank time
    by sum(dts) (host float64). Any T >= 1; T = 0 is a no-op."""
    dts = np.asarray(dts, np.float64)
    R = (LiveKalman.obs_noise[ObservationKind.ECEF_POS] if R is None
         else np.asarray(R))
    if dts.shape[0] == 0:
      return self
    if self._generic:
      self._x, self._P = generic_scan.generic_bank_scan(
          self._x, self._P, self._zs(zs), self._tensor(dts),
          call=self._generic_call("single", (ObservationKind.ECEF_POS,),
                                  (np.asarray(R, np.float64),), bool(gate)))
      self.t += float(dts.sum())
      self._ring.clear()  # bulk runs are not observation-addressable
      return self
    args = (self._x, self._P, self._zs(zs), self._tensor(dts))
    if self._q_is_diag:
      self._x, self._P = live_scan.live_bank_scan(
          *args, self._q_diag, self._tensor(R), gate=gate)
    else:
      self._x, self._P = live_scan.live_bank_scan_reference(
          *args, self.Q, self._tensor(R), gate=gate)
    self.t += float(dts.sum())
    self._ring.clear()  # bulk runs are not observation-addressable
    return self

  def run_mixed(self, dts, kind_idx, zs, kinds: Sequence[int],
                R_by_kind=None, gate: bool = False, r_stream=None,
                stream_kinds: Sequence[int] = ()):
    """T steps of a heterogeneous sensor schedule: kinds is the kind set,
    kind_idx (T,) indexes into it, zs (T, B, 3) rows padded to dz <= 3.
    Per-kind R defaults to LiveKalman.obs_noise; kinds in `stream_kinds`
    take per-step diagonal noise from r_stream (T, 3) instead (the
    camera-odometry kinds, live_kf.py:325-337)."""
    kinds = tuple(int(k) for k in kinds)
    stream_kinds = tuple(int(k) for k in stream_kinds)
    if not all(k in live_lane.LANE_KINDS for k in kinds):
      raise ValueError(f"kinds {kinds} are not all live lane kinds")
    if not set(stream_kinds) <= set(kinds):
      raise ValueError(f"stream_kinds {stream_kinds} not all in kinds {kinds}")
    if (r_stream is None) != (not stream_kinds):
      raise ValueError("r_stream and stream_kinds go together")
    eye = np.eye(3)  # placeholder where a kind's static R is never read
    if R_by_kind is None:
      missing = [k for k in kinds
                 if k not in LiveKalman.obs_noise and k not in stream_kinds]
      if missing:
        raise ValueError(
            f"kinds {missing} carry per-measurement noise in the reference "
            "(no obs_noise default, live_kf.py:325-337); pass R_by_kind or "
            "stream their variances via r_stream/stream_kinds")
      R_by_kind = {k: LiveKalman.obs_noise.get(k, eye) for k in kinds}
    else:
      R_by_kind = {k: (R_by_kind[k] if k not in stream_kinds
                       else R_by_kind.get(k, eye)) for k in kinds}
    dts = np.asarray(dts, np.float64)
    T = dts.shape[0]
    if T == 0:
      return self
    kind_idx = np.asarray(kind_idx)
    if kind_idx.shape != (T,) or kind_idx.min() < 0 or \
        kind_idx.max() >= len(kinds):
      raise ValueError(f"kind_idx must be (T,) indices into {len(kinds)} kinds")
    R_stack = np.stack([_pad3(R_by_kind[k], live_lane.LANE_KINDS[k][0])
                        for k in kinds])
    self._x, self._P = self._scan_mixed(
        dts, kind_idx, self._zs(zs), kinds, R_stack, gate,
        None if r_stream is None else self._tensor(r_stream), stream_kinds)
    self.t += float(dts.sum())
    self._ring.clear()  # bulk runs are not observation-addressable
    return self
