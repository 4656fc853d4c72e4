"""2-state kinematic (position/velocity) Kalman filter.

Port of rednose_tpu/models/kinematic.py (the reference example,
examples/kinematic_kf.py:36-81), with torch model functions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel
from rednose_tpu_torch.models.kalman_filter import KalmanFilter
from rednose_tpu_torch.registry import register


class ObservationKind:
  UNKNOWN = 0
  NO_OBSERVATION = 1
  POSITION = 1

  names = ['Unknown', 'No observation', 'Position']

  @classmethod
  def to_string(cls, kind):
    return cls.names[kind]


class States:
  POSITION = slice(0, 1)
  VELOCITY = slice(1, 2)


def _f(params, x, dt):
  """x' = x + dt * [v, 0] (examples/kinematic_kf.py:60-63)."""
  del params
  return torch.stack([x[0] + dt * x[1], x[1]])


def _h_position(params, x, ea):
  del params, ea
  return x[0:1]


@functools.cache
def build_kinematic_spec() -> FilterSpec:
  """The kinematic spec, one object per process: the generic kernels' emitted
  sources and detected structures are cached per spec object."""
  return FilterSpec(
      name='kinematic',
      dim_x=2,
      dim_err=2,
      f=_f,
      obs={
          ObservationKind.POSITION: ObservationModel(
              kind=ObservationKind.POSITION, h=_h_position, dz=1),
      },
  )


@register
class KinematicKalman(KalmanFilter):
  name = 'kinematic'

  initial_x = np.array([0.5, 0.0])
  initial_P_diag = np.array([1.0**2, 1.0**2])
  Q = np.diag([0.1**2, 2.0**2])
  obs_noise = {ObservationKind.POSITION: np.atleast_2d(0.1**2)}

  @classmethod
  def build_spec(cls) -> FilterSpec:
    return build_kinematic_spec()
