"""Facade for wide MSCKF banks (additive or ESKF-composed).

Port of rednose_tpu/runtime/msckf_bank.py: B independent sliding-window
filters of one MSCKF FilterSpec (models/msckf_vo.py additive,
models/msckf_eskf.py quaternion-composed), the reference's
predict_and_update_batch(..., augment=True) flow (ekf_sym.py:525-526) at
bank scale:

    bank = MSCKFBank(MSCKFEskf, batch=4096)     # or MSCKFBank(spec=...)
    bank.run_frames(dts, zs, eas)          # T camera frames
    bank.observe_frame(t, z, ea)           # one frame, out-of-order OK
    bank.observe(t, kind, z)               # non-feature kinds (no augment)
    bank.run(dts, zs, kind)                # bulk non-feature stream
    bank.run_mixed(dts, kind_idx, zs, kinds, eas=eas)  # frames + sensors
    bank.x, bank.P                         # (B, dim_x), (B, de, de)

On a CUDA device every path runs a kernel, where the JAX facade sends six
of its paths to the lane code even on the TPU:
- run_frames launches kernel 7 (generic_scan.vo_bank_scan) for any T, and
  observe_frame kernel 7 with T = 1 (a replayed frame augments again);
- run_mixed launches kernel 6 (generic_scan.generic_bank_scan_mixed): a
  schedule that interleaves camera frames with other sensors, the
  reference's production flow (predict_and_observe per sensor,
  predict_and_update_batch(augment=True) per camera frame,
  ekf_sym.py:458-531); a feature step runs kernel 6's camera-frame
  branch, the same emitted unit as kernel 7's;
- observe and run of a non-feature kind launch kernel 4 with the block
  predict, run_epochs of non-feature slots kernel 5;
- Q enters on its nonzero pattern, so a full Q needs no lane path, and a
  spec whose structure cannot be detected gets the dense body of the same
  emitter.
A feature kind in an epoch slot raises, as in the JAX package: a camera
frame augments the window, an epoch slot does not. On the CPU the same
wrappers run the plain lane scans. State, time, the out-of-order rewind
ring, diverged / reset_diverged and save / load come from KalmanBank and
BankFacadeBase.
"""

from __future__ import annotations

import numpy as np

from rednose_tpu_torch.ops import generic_scan
from rednose_tpu_torch.runtime.generic_bank import KalmanBank


class MSCKFBank(KalmanBank):
  """B independent sliding-window MSCKF filters of one spec. Pass a model
  class (build_spec() plus initial_x / initial_P_diag / Q / obs_noise) or
  spec= with x0 / P_diag / Q; the spec must carry a clone window, and its
  first feature kind is the camera-frame kind. Keyword arguments as
  KalmanBank's (device defaults to "cuda")."""

  _msckf = True

  def __init__(self, model=None, batch: int = 1024, **kw):
    super().__init__(model, batch, **kw)
    feature = [k for k, om in sorted(self.spec.obs.items()) if om.is_feature]
    if not feature:
      raise ValueError(f"MSCKF spec {self.spec.name!r} has no feature kind")
    self.feature_kind = feature[0]

  def _lanes(self, a, width, name):
    """(width,) broadcast across the bank, or (B, width), as float64."""
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 1:
      a = np.broadcast_to(a, (self.batch, a.shape[0]))
    if a.shape != (self.batch, width):
      raise ValueError(f"{name} {a.shape}, expected ({self.batch}, {width})")
    return a

  # --------------------------------------------------- per-observation API

  def observe_frame(self, t, z, ea, R=None):
    """Apply ONE timestamped camera frame (predict + projected feature
    update + window augment) to the whole bank, with driver-style
    out-of-order handling (ekf_sym.py:464-482): a late frame inside the
    rewind window rolls the bank back and replays; older than the window
    it is dropped (returns None). z (B, dz) or (dz,); ea (B, ea_len) or
    (ea_len,) per-lane triangulated landmark positions."""
    kind = self.feature_kind
    om = self.spec.obs[kind]
    R = self._normalize_R(kind, self._default_R(kind) if R is None else R)
    return self._observe_ordered(
        t, (kind, self._lanes(z, om.dz, "z"), R,
            self._lanes(ea, om.ea_len, "ea"), True))

  def observe(self, t, kind, z, R=None, ea=None):
    """One timestamped NON-FEATURE observation (predict + update, clone
    window untouched) with the same out-of-order handling."""
    if self.spec.obs[int(kind)].is_feature:
      raise ValueError("camera frames: use observe_frame()")
    return super().observe(t, kind, z, R=R, ea=ea)

  def _apply_one(self, t, kind, z, R, ea, is_frame=False):
    if not is_frame:
      return super()._apply_one(t, kind, z, R, ea)
    dt = max(float(t) - self.t, 0.0)
    om = self.spec.obs[kind]
    self._x, self._P = generic_scan.vo_bank_scan(
        self._x, self._P, self._stream(z[None], (1,), om.dz, "z"),
        self._stream(ea[None], (1,), om.ea_len, "ea"), self._tensor([dt]),
        call=self._call("frame", (kind,), (R,)))
    self.t = float(t)
    self._ring.record(self.t, (self._x, self._P), (self.t, kind, z, R, ea,
                                                    True))

  # ------------------------------------------------------------------- runs

  def run_frames(self, dts, zs, eas, R=None):
    """T camera frames: dts (T,), zs (T, B, dz), eas (T, B, ea_len)
    per-frame per-lane landmark positions, R (dz, dz) shared (default: the
    feature kind's obs_noise). Gating follows the kind's maha_test
    (reference semantics). Kernel 7 on CUDA, the plain frame scan on the
    CPU. Advances bank time by sum(dts)."""
    kind = self.feature_kind
    om = self.spec.obs[kind]
    dts = np.asarray(dts, np.float64)
    T = dts.shape[0]
    if T == 0:
      return self
    R = self._normalize_R(kind, self._default_R(kind) if R is None else R)
    self._x, self._P = generic_scan.vo_bank_scan(
        self._x, self._P, self._stream(zs, (T,), om.dz, "zs"),
        self._stream(eas, (T,), om.ea_len, "eas"), self._tensor(dts),
        call=self._call("frame", (kind,), (R,)))
    self.t += float(dts.sum())
    self._ring.clear()  # bulk runs are not observation-addressable
    return self

  def run(self, dts, zs, kind, R=None, eas=None, pss=None, ps_keys=(),
          gate: bool | None = None):
    """T fused predict + update steps of one NON-FEATURE kind (clone
    window untouched; kernel 4 with the block predict)."""
    if self.spec.obs[int(kind)].is_feature:
      raise ValueError("camera frames: use run_frames()")
    return super().run(dts, zs, kind, R=R, eas=eas, pss=pss, ps_keys=ps_keys,
                       gate=gate)

  def run_mixed(self, dts, kind_idx, zs, kinds, R_by_kind=None, eas=None,
                pss=None, ps_keys=()):
    """T steps of a schedule that may interleave camera frames with other
    sensors (kernel 6 on CUDA, the plain mixed scan on the CPU): kinds is
    the kind set, kind_idx (T,) indexes into it; a step of the feature
    kind is a camera frame (predict, projected feature update, window
    augment), any other step a predict and its update. zs (T, B, max_dz)
    rows padded to the largest dz; eas (T, B, ea_len) the frames' landmark
    positions (read on feature steps only), required iff the schedule has
    the feature kind. Per-kind R defaults to obs_noise; each kind gates on
    its own maha_test. Advances bank time by sum(dts)."""
    kinds = tuple(int(k) for k in kinds)
    has_feature = any(self.spec.obs[k].is_feature for k in kinds)
    if (eas is None) == has_feature:
      raise ValueError("pass eas (T, B, ea_len) iff the schedule has the "
                       f"feature kind {self.feature_kind}")
    return super().run_mixed(dts, kind_idx, zs, kinds, R_by_kind=R_by_kind,
                             eas=eas, pss=pss, ps_keys=ps_keys)
