"""Sequential streaming filter engine with out-of-order observation handling.

Port of rednose_tpu/runtime/driver.py (the reference's EKF_sym /
EKFSym, rednose/helpers/ekf_sym.py:220-690, ekf_sym.{h,cc}). Time
bookkeeping and the rewind/replay ring live on the host; the step math is
core/step.py on tensors of the engine's device and dtype (float64 by
default, matching the reference's double-precision goldens).

Eager torch needs no power-of-two bucketing of the measurement count
(the JAX engine pads n to spare its jit cache, driver.py:205-219). A
checkpointed observation keeps its augment flag, and a checkpoint the
clone window's augment times, so a rewind replays an MSCKF camera frame
with its window augmentation (the JAX engine replays it without,
driver.py:183-184, and keeps the replayed times twice).
"""

from __future__ import annotations

import collections.abc
import logging

import numpy as np
import torch

from rednose_tpu_torch.core import step as step_ops
from rednose_tpu_torch.core.spec import FilterSpec, ParamsRoutine
from rednose_tpu_torch.ops.quaternion import normalize_slices
from rednose_tpu_torch.runtime.rewind import REWIND_TO_KEEP, RewindRing
from rednose_tpu_torch.utils.device import resolve_device


class KalmanError(Exception):
  """Filter divergence (mirrors rednose/helpers/__init__.py:34)."""


class Estimate(tuple):
  """9-tuple estimate (xk_km1, xk_k, Pk_km1, Pk_k, t, kind, y, z, extra_args),
  mirroring the reference's return (ekf_sym.py:531, ekf_sym.h:32-42)."""
  __slots__ = ()


class FilterEngine:
  """Functional equivalent of the reference's EKF_sym / EKFSym."""

  def __init__(self, spec: FilterSpec, Q, x_initial, P_initial,
               params=None, max_rewind_age: float = 1.0, logger=logging,
               device="cuda", dtype=torch.float64):
    self.spec = spec
    self.logger = logger
    self.max_rewind_age = max_rewind_age
    self.device = resolve_device(device)
    self.dtype = dtype

    x_initial = np.asarray(x_initial).reshape(-1)
    if (x_initial.shape[0] != spec.dim_x
        or np.shape(P_initial) != (spec.dim_err, spec.dim_err)
        or np.shape(Q) != (spec.dim_err, spec.dim_err)):
      raise ValueError(f"state/covariance shapes do not fit spec {spec.name!r}")
    self.Q = self._tensor(Q)
    self.params = params if params is not None else dict(spec.default_params)
    self.ring = RewindRing(REWIND_TO_KEEP)
    self.init_state(x_initial, P_initial, None)

  def _tensor(self, a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=self.dtype,
                           device=self.device)

  # ------------------------------------------------------------------ state

  def init_state(self, state, covs, filter_time):
    """Re-seed the filter (ekf_sym.py:351-358)."""
    self.x = self._tensor(np.asarray(state).reshape(-1))
    self.P = self._tensor(covs)
    self.filter_time = filter_time
    self.augment_times = [0.0] * self.spec.n_augment
    self.reset_rewind()

  def reset_rewind(self):
    self.ring.clear()

  def state(self):
    return self.x.detach().cpu().numpy().flatten()

  def covs(self):
    return self.P.detach().cpu().numpy()

  def get_filter_time(self):
    return self.filter_time

  def set_filter_time(self, t):
    self.filter_time = t

  def get_augment_times(self):
    return self.augment_times

  def normalize_quaternions(self):
    """Renormalize every quaternion block (ekf_sym.py:405-407)."""
    self.x = normalize_slices(self.x, self.spec.quaternion_idxs)

  def normalize_slice(self, slice_start, slice_end_ex):
    """Unit-normalize x[slice_start:slice_end_ex] (ekf_sym.py:409-410)."""
    seg = self.x[slice_start:slice_end_ex]
    self.x = torch.cat([self.x[:slice_start],
                        seg / torch.linalg.vector_norm(seg),
                        self.x[slice_end_ex:]])

  def get_extra_routine(self, name):
    """A spec-shipped auxiliary function (EKFSym::get_extra_routine,
    ekf_sym.cc:221-223). A ParamsRoutine receives the engine's params as
    they are at each CALL, so set_global updates reach it, as the
    reference's generated routines read the live C globals."""
    if name not in self.spec.extra_routines:
      raise KeyError(f"no extra routine {name!r}; available: "
                     f"{sorted(self.spec.extra_routines)}")
    fn = self.spec.extra_routines[name]
    if isinstance(fn, ParamsRoutine):
      return lambda *args: fn.fn(self.params, *args)
    return fn

  def set_global(self, name, val):
    """Runtime-tunable parameter update (ekf_sym.py:415-416)."""
    if not isinstance(self.params, collections.abc.Mapping):
      raise TypeError(
          f"set_global needs mapping params, got {type(self.params).__name__}")
    self.params = dict(self.params)
    self.params[name] = val

  # ------------------------------------------------------------------ rewind

  def rewind(self, t):
    """Roll state back to just before t; return observations to replay
    (ekf_sym.py:418-438)."""
    t_restore, state, replay = self.ring.rewind(t)
    self.filter_time = t_restore
    self.x, self.P, augment_times = state
    self.augment_times = list(augment_times)
    return replay

  def checkpoint(self, obs):
    self.ring.checkpoint(self.filter_time,
                         (self.x, self.P, tuple(self.augment_times)), obs)

  # ------------------------------------------------------------------- steps

  def predict(self, t):
    """Advance to time t with no measurement (ekf_sym.py:452-462)."""
    if self.filter_time is None:
      self.filter_time = t
    dt = t - self.filter_time
    if dt < 0:
      raise ValueError(f"predict to {t} before filter time {self.filter_time}")
    self.x, self.P = step_ops.predict(self.spec, self.params, self.x, self.P,
                                      self.Q, self._tensor(dt))
    self.filter_time = t

  def predict_and_update_batch(self, t, kind, z, R, extra_args=None,
                               augment=False):
    """Out-of-order-safe predict + batched update (ekf_sym.py:464-482):
    too-old observations are rejected (None), in-window late ones trigger
    rewind + replay. augment=True then clones the pose into the MSCKF
    window (ekf_sym.py:525-526)."""
    if self.filter_time is not None and t < self.filter_time:
      if not self.ring.can_rewind(t, self.max_rewind_age):
        self.logger.error(
            f"observation too old at {t:.3f} with filter at "
            f"{self.filter_time:.3f}, ignoring")
        return None
      replay = self.rewind(t)
    else:
      replay = []

    ret = self._predict_and_update_batch(t, kind, z, R, extra_args, augment)
    for r in replay:
      self._predict_and_update_batch(*r)
    return ret

  def _predict_and_update_batch(self, t, kind, z, R, extra_args,
                                augment=False):
    om = self.spec.obs[kind]
    z = np.asarray(z, dtype=np.float64).reshape(-1, om.dz)
    R = np.asarray(R, dtype=np.float64).reshape(-1, om.dz, om.dz)
    n = z.shape[0]
    if R.shape[0] != n:
      raise ValueError(f"{n} measurements but {R.shape[0]} noise matrices")
    if extra_args is None or (hasattr(extra_args, "__len__")
                              and len(extra_args) == 0):
      ea = np.zeros((n, max(om.ea_len, 1)))
    else:
      ea = np.asarray(extra_args, dtype=np.float64).reshape(n, -1)

    if self.filter_time is None:
      self.filter_time = t
    dt = t - self.filter_time
    if dt < 0:
      raise ValueError(f"update at {t} before filter time {self.filter_time}")

    x_pred, P_pred, x_post, P_post, y = step_ops.predict_and_update_batch(
        self.spec, kind, self.params, self.x, self.P, self.Q,
        self._tensor(dt), self._tensor(z), self._tensor(R), self._tensor(ea))
    self.x, self.P = x_post, P_post
    self.filter_time = t
    if augment:
      self.augment()
    self.checkpoint((t, kind, z, R, extra_args, augment))
    return Estimate((x_pred, x_post, P_pred, P_post, t, kind, y, z,
                     extra_args))

  def augment(self):
    """MSCKF pose-window augmentation (ekf_sym.py:365-391)."""
    self.x, self.P = step_ops.augment(self.spec, self.x, self.P)
    self.augment_times = self.augment_times[1:] + [self.filter_time]

  def maha_test(self, x, P, kind, z, R, extra_args=None, maha_thresh=0.95):
    """Standalone outlier test (ekf_sym.py:626-649)."""
    om = self.spec.obs[kind]
    ea = (np.zeros(max(om.ea_len, 1))
          if extra_args is None or len(extra_args) == 0
          else np.asarray(extra_args))
    ok = step_ops.maha_test(
        self.spec, kind, self.params,
        self._tensor(np.asarray(x).reshape(-1)), self._tensor(P),
        self._tensor(np.asarray(z).reshape(-1)), self._tensor(R),
        self._tensor(ea), maha_thresh=maha_thresh)
    return bool(ok)

  def rts_smooth(self, estimates, norm_quats=False, parallel=False,
                 refine=None, reference_seed=False):
    """Offline RTS smoothing of a list of Estimates (ekf_sym.py:651-690) on
    the engine's device and dtype: a list of smoothed (x, P) numpy pairs,
    oldest first. parallel=True takes the parallel-in-time form (`refine`:
    its Newton passes for ESKF specs); reference_seed=True (sequential
    only) seeds from the last predicted state, as the reference does (see
    smoothing/rts.py)."""
    from rednose_tpu_torch.smoothing.rts import smooth_estimates

    return smooth_estimates(self.spec, self.params, estimates,
                            norm_quats=norm_quats, parallel=parallel,
                            dtype=self.dtype, refine=refine,
                            reference_seed=reference_seed,
                            device=self.device)
