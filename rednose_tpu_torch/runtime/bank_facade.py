"""Shared machinery for the bank facades.

Port of rednose_tpu/runtime/bank_facade.py: a B-wide bank with a shared
host clock, out-of-order observe() on a sparse-snapshot rewind ring
(reference semantics: ekf_sym.py:464-482 / ekf_sym.cc:83-156), per-lane
divergence recovery, save/load, and `run_epochs` on the generic epoch
kernel (ops/generic_scan.generic_bank_scan_epoch, kernel 5) for every
facade's spec.

Subclasses provide `_apply_one(t, *payload)` (apply one observation and
record it on the ring), `_default_R(kind)` and the run paths, and set in
__init__: batch, dtype, device, _x (dim_x, B) and _P (de, de, B)
bank-minor, t (host f64 clock), _ring (BankRewindRing), max_rewind_age,
logger, _x0_1d, _P_diag0, _quaternion_idxs, and for run_epochs spec,
structure, params and Q.
"""

from __future__ import annotations

import numpy as np
import torch

from rednose_tpu_torch.ops import generic_scan, lane_bank
from rednose_tpu_torch.runtime.bank import BankState
from rednose_tpu_torch.runtime.checkpoint import load_bank, save_bank


class BankFacadeBase:
  """State/time/rewind/divergence/persistence core of a bank facade."""

  def _tensor(self, a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype or self.dtype,
                           device=self.device)

  def _stream(self, a, lead, width, name):
    """A user stream (*lead, B, width) -> the kernels' bank-minor
    (*lead, width, B) on the device."""
    if not torch.is_tensor(a):
      a = np.array(a, dtype=np.float64)
    a = torch.as_tensor(a, dtype=self.dtype, device=self.device)
    want = tuple(lead) + (self.batch, width)
    if tuple(a.shape) != want:
      raise ValueError(f"{name} {tuple(a.shape)}, expected {want}")
    return a.transpose(-1, -2).contiguous()

  def _call(self, mode, kinds, R_list, gate=None, ps_keys=()):
    """The generic kernels' KernelCall for these kinds and R, made once
    and kept: its checks, source lookup and device copies of params, Q
    and R then run once, not on every observe. Keyed by the R values; the
    facade's Q is fixed and set_global drops every kept call."""
    calls = self.__dict__.setdefault("_calls", {})
    key = (mode, kinds, gate, ps_keys, *(R.tobytes() for R in R_list))
    call = calls.get(key)
    if call is None:
      if len(calls) >= 64:   # a caller streaming new R values
        calls.clear()
      call = calls[key] = generic_scan.KernelCall(
          self.spec, mode, kinds, Q=self.Q, R_list=R_list,
          params=self.params, gate=gate, structure=self.structure,
          ps_keys=ps_keys)
    return call

  def _normalize_R(self, kind, R):
    """One R contract for every surface: scalar (dz = 1), (dz,) diagonal,
    or full (dz, dz) -> (dz, dz) float64."""
    dz = self.spec.obs[kind].dz
    R = np.asarray(R, dtype=np.float64)
    if R.ndim == 1 and dz > 1:
      if R.shape != (dz,):
        raise ValueError(f"R {R.shape} for kind {kind} with dz={dz}")
      return np.diag(R)
    return R.reshape(dz, dz)

  # ---------------------------------------------------------------- state

  @property
  def x(self):
    """(B, dim_x) nominal states (a view of the bank-minor state)."""
    return self._x.T

  @property
  def P(self):
    """(B, de, de) error-state covariances (a view)."""
    return lane_bank.from_lane(self._P)

  def state(self) -> BankState:
    # BankState.t is seconds since epoch and every lane steps with the
    # shared clock, so t = 0 with the f64 clock as epoch
    return BankState(x=self.x, P=self.P,
                     t=torch.zeros((self.batch,), dtype=self.dtype,
                                   device=self.device),
                     epoch=self.t)

  def diverged(self):
    """(B,) bool tensor: lanes whose state or covariance went non-finite, or
    whose quaternion norm left (0.1, 10) — the bank analog of the
    single-filter KalmanError guard (live_kf.py:299-306)."""
    ok = (torch.isfinite(self._x).all(dim=0)
          & torch.isfinite(self._P).all(dim=1).all(dim=0))
    for idx in self._quaternion_idxs:
      qn = torch.linalg.vector_norm(self._x[idx:idx + 4], dim=0)
      ok = ok & (qn > 0.1) & (qn < 10.0)
    return ~ok

  def reset_diverged(self, x0=None, P_diag=None):
    """Re-seed only the diverged lanes from the initial state (or the given
    one); returns how many were reset. Healthy lanes are untouched."""
    bad = self.diverged()
    x0 = torch.as_tensor(np.asarray(self._x0_1d if x0 is None else x0),
                         dtype=self.dtype, device=self.device)
    x0 = x0[:, None] if x0.ndim == 1 else x0.T
    P_diag = self._P_diag0 if P_diag is None else np.asarray(P_diag)
    P0 = torch.as_tensor(np.diag(P_diag), dtype=self.dtype,
                         device=self.device)
    self._x = torch.where(bad[None, :], x0.expand_as(self._x), self._x)
    self._P = torch.where(bad[None, None, :], P0[:, :, None], self._P)
    # a later rewind must never replay through a pre-reset snapshot
    self._ring.clear()
    return int(bad.sum())

  def save(self, path):
    save_bank(path, self.state())

  def load(self, path):
    st = load_bank(path, dtype=self.dtype, device=self.device)
    if tuple(st.x.shape) != (self.batch, self._x.shape[0]):
      raise ValueError(f"checkpoint x {tuple(st.x.shape)} does not fit a "
                       f"bank of {self.batch} x {self._x.shape[0]}")
    self._x = st.x.T.contiguous()
    self._P = lane_bank.to_lane(st.P).contiguous()
    self.t = st.epoch
    self._ring.clear()  # snapshots from before the load are another timeline
    return self

  # --------------------------------------------------------------- rewind

  def _observe_ordered(self, t, payload):
    """Driver-style out-of-order handling for one observation: a late one
    inside the rewind window rolls the bank back to the newest snapshot
    at-or-before t and replays the buffered observations around it, in
    time order; older than the window it is dropped (returns None)."""
    if t < self.t:
      if not self._ring.can_rewind(t, self.max_rewind_age):
        self.logger.error(
            f"bank observation too old at {t:.3f} with bank at "
            f"{self.t:.3f}, ignoring")
        return None
      t_restore, (x, P), replay = self._ring.rewind(t)
      self._x, self._P = x, P
      self.t = t_restore
      merged, inserted = [], False
      for obs in replay:
        if not inserted and obs[0] > t:
          merged.append((t, *payload))
          inserted = True
        merged.append(obs)
      if not inserted:
        merged.append((t, *payload))
      for obs in merged:
        self._apply_one(*obs)
      return self
    self._apply_one(t, *payload)
    return self

  # ----------------------------------------------------------------- runs

  def run_epochs(self, dts, zs, slot_kinds, R_by_slot=None, eas=None,
                 pss=None, ps_keys=()):
    """T epochs, each one predict + K updates (the reference's
    predict_and_update_batch, ekf_sym.py:484-531): slot_kinds is the epoch
    layout (repeat a kind for several same-kind measurements), zs
    (T, K, B, max_dz) rows padded to the largest dz, eas
    (T, K, B, max_ea_len) iff a slot kind takes extra args, per-slot R
    defaulting to its kind's noise, per-epoch params via ps_keys / pss
    (T, len(ps_keys)). Each slot gates on its kind's maha_test. Runs
    kernel 5 with all K updates inline on CUDA, the plain epoch scan on
    the CPU. Advances bank time by sum(dts) (host float64)."""
    slot_kinds = tuple(int(k) for k in slot_kinds)
    ps_keys = tuple(ps_keys)
    max_dz = max(self.spec.obs[k].dz for k in slot_kinds)
    max_ea = max(self.spec.obs[k].ea_len for k in slot_kinds)
    dts = np.asarray(dts, np.float64)
    T = dts.shape[0]
    if T == 0:
      return self
    if R_by_slot is None:
      R_by_slot = [self._default_R(k) for k in slot_kinds]
    if len(R_by_slot) != len(slot_kinds):
      raise ValueError("one R per slot")
    R_by_slot = [self._normalize_R(k, R)
                 for k, R in zip(slot_kinds, R_by_slot)]
    if (eas is None) != (max_ea == 0):
      raise ValueError("pass eas iff a slot kind takes extra args")
    K = len(slot_kinds)
    self._x, self._P = generic_scan.generic_bank_scan_epoch(
        self._x, self._P, self._stream(zs, (T, K), max_dz, "zs"),
        self._tensor(dts),
        eas=None if eas is None else self._stream(eas, (T, K), max_ea, "eas"),
        pss=None if pss is None else self._tensor(pss),
        call=self._call("epoch", slot_kinds, R_by_slot, ps_keys=ps_keys))
    self.t += float(dts.sum())
    self._ring.clear()  # bulk runs are not observation-addressable
    return self
