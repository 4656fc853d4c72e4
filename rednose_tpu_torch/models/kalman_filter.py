"""Declarative KalmanFilter facade.

Port of rednose_tpu/models/kalman_filter.py (the reference facade,
rednose/helpers/kalmanfilter.py:6-52): a subclass declares `build_spec`,
`initial_x`, `initial_P_diag`, `Q` and `obs_noise` (numpy constants, equal
to the JAX package's), and gets state properties, init_state, R tiling and
predict_and_observe on a FilterEngine of the chosen device and dtype.
"""

from __future__ import annotations

from typing import Any, ClassVar

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.runtime.driver import FilterEngine


class KalmanFilter:
  name: ClassVar[str] = "<name>"
  initial_x: np.ndarray = np.zeros(0)
  initial_P_diag: np.ndarray = np.zeros(0)
  Q: np.ndarray = np.zeros((0, 0))
  obs_noise: dict[int, Any] = {}

  @classmethod
  def build_spec(cls) -> FilterSpec:
    raise NotImplementedError

  def __init__(self, max_rewind_age: float = 1.0, params=None,
               device="cuda", dtype=torch.float64):
    self.spec = self.build_spec()
    self.filter = FilterEngine(
        self.spec, self.Q, self.initial_x, np.diag(self.initial_P_diag),
        params=params, max_rewind_age=max_rewind_age, device=device,
        dtype=dtype)

  @property
  def x(self):
    return self.filter.state()

  @property
  def t(self):
    return self.filter.get_filter_time()

  @property
  def P(self):
    return self.filter.covs()

  def init_state(self, state, covs_diag=None, covs=None, filter_time=None):
    """Re-seed the filter. An explicit diagonal wins over a full matrix;
    with neither, the current covariance is kept."""
    if covs_diag is not None:
      covs = np.diag(covs_diag)
    self.filter.init_state(
        state, self.filter.covs() if covs is None else covs, filter_time)

  def get_R(self, kind, n):
    """Tile the per-kind noise matrix to a batch (kalmanfilter.py:37-43)."""
    return np.tile(self.obs_noise[kind][None, :, :], (n, 1, 1))

  def predict_and_observe(self, t, kind, data, R=None):
    data = np.atleast_2d(data) if len(data) else data
    R = self.get_R(kind, len(data)) if R is None else R
    return self.filter.predict_and_update_batch(t, kind, data, R)
