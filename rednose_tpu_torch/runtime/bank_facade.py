"""Shared machinery for the bank facades.

Port of rednose_tpu/runtime/bank_facade.py: a B-wide bank with a shared
host clock, out-of-order observe() on a sparse-snapshot rewind ring
(reference semantics: ekf_sym.py:464-482 / ekf_sym.cc:83-156), per-lane
divergence recovery, and save/load. `run_epochs` needs the generic epoch
kernel and comes with the port's generic-bank slice (ROADMAP).

Subclasses provide `_apply_one(t, *payload)` (apply one observation and
record it on the ring) and the run paths, and set in __init__: batch,
dtype, device, _x (dim_x, B) and _P (de, de, B) bank-minor, t (host f64
clock), _ring (BankRewindRing), max_rewind_age, logger, _x0_1d, _P_diag0,
and _quaternion_idxs.
"""

from __future__ import annotations

import numpy as np
import torch

from rednose_tpu_torch.runtime.bank import BankState
from rednose_tpu_torch.runtime.checkpoint import load_bank, save_bank


class BankFacadeBase:
  """State/time/rewind/divergence/persistence core of a bank facade."""

  # ---------------------------------------------------------------- state

  @property
  def x(self):
    """(B, dim_x) nominal states (a view of the bank-minor state)."""
    return self._x.T

  @property
  def P(self):
    """(B, de, de) error-state covariances (a view)."""
    return self._P.permute(2, 0, 1)

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
    self._P = st.P.permute(1, 2, 0).contiguous()
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
