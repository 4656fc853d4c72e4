"""Vehicle-dynamics parameter estimation filter (the paramsd pattern).

Port of rednose_tpu/models/car.py: a 5-state filter mixing slowly drifting
calibration parameters (steer ratio, tire-stiffness factor, steering-angle
offset) with the lateral velocity and yaw rate of the linear single-track
("bicycle") model. Forward speed and the commanded steering angle are
runtime params (`set_global`, or the per-step `ps_keys` / `pss` stream of
the bank scans), the torch counterpart of the reference's mutable C
globals (rednose/helpers/ekf_sym.py:129-132).

The params reach `_f` as python floats (FilterEngine) or as 0-d tensors
(the bank scans, and the CUDA emitter, which traces them as run-time
inputs so that no value is baked into a kernel); `_f` takes either.

Bicycle-model dynamics (Rajamani, "Vehicle Dynamics and Control", ch. 2):

  tire angle     sa  = (steer_angle - angle_offset) / sR
  front/rear     cF  = sf * cF0,   cR = sf * cR0   (stiffness_factor sf)
  lateral vel    vy' = -(cF+cR)/(m u) vy + ((aR cR - aF cF)/(m u) - u) r
                       + cF/m sa
  yaw rate       r'  = (aR cR - aF cF)/(J u) vy
                       - (aF^2 cF + aR^2 cR)/(J u) r + aF cF/J sa
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel
from rednose_tpu_torch.models.kalman_filter import KalmanFilter
from rednose_tpu_torch.registry import register


class ObservationKind:
  YAW_RATE = 1       # gyro yaw rate (rad/s)
  LATERAL_SLIP = 2   # small-slip pseudo-observation of lateral velocity

  names = {1: 'Yaw rate', 2: 'Lateral slip'}

  @classmethod
  def to_string(cls, kind):
    return cls.names[kind]


class States:
  STEER_RATIO = slice(0, 1)
  STIFFNESS = slice(1, 2)        # unitless factor on nominal stiffness
  ANGLE_OFFSET = slice(2, 3)     # degrees
  LATERAL_VELOCITY = slice(3, 4)  # m/s
  YAW_RATE = slice(4, 5)         # rad/s


DIM = 5

# nominal vehicle constants (generic mid-size sedan; tunable via params)
DEFAULT_PARAMS = {
    'mass': 1650.0,        # kg
    'rot_inertia': 2500.0,  # kg m^2
    'cF0': 1.2e5,          # N/rad nominal front cornering stiffness
    'cR0': 1.7e5,          # N/rad nominal rear
    'aF': 1.25,            # m, CG -> front axle
    'aR': 1.55,            # m, CG -> rear axle
    # runtime inputs, updated per tick:
    'u': 20.0,             # forward speed (m/s)
    'steer_angle_deg': 0.0,  # commanded steering-wheel angle (degrees)
}

# Speed floor of the dynamics: the equations divide by u and the explicit
# Euler step goes unstable once (cF+cR)/(m u) dt > 2; below this speed the
# model saturates u instead of NaN-poisoning the state at standstill.
MIN_SPEED = 5.0


def _f(params, x, dt):
  sR = x[0]
  sf = x[1]
  ao = x[2]
  vy = x[3]
  r = x[4]
  m, j = params['mass'], params['rot_inertia']
  cF, cR = sf * params['cF0'], sf * params['cR0']
  aF, aR = params['aF'], params['aR']
  u = torch.clamp(torch.as_tensor(params['u'], dtype=x.dtype), min=MIN_SPEED)
  # jnp.deg2rad is this product
  sa = (params['steer_angle_deg'] - ao) * (math.pi / 180.0) / sR

  vy_dot = (-(cF + cR) / (m * u) * vy
            + ((aR * cR - aF * cF) / (m * u) - u) * r + cF / m * sa)
  r_dot = ((aR * cR - aF * cF) / (j * u) * vy
           - (aF * aF * cF + aR * aR * cR) / (j * u) * r
           + aF * cF / j * sa)
  return torch.cat([
      x[0:3],                      # calibration states: random walk
      (vy + dt * vy_dot)[None],
      (r + dt * r_dot)[None],
  ])


def _h_yaw_rate(params, x, ea):
  del params, ea
  return x[4:5]


def _h_lateral_slip(params, x, ea):
  del params, ea
  return x[3:4]


@functools.cache
def build_car_spec() -> FilterSpec:
  """The car spec, one object per process: the generic kernels' emitted
  sources and detected structures are cached per spec object."""
  obs = {
      ObservationKind.YAW_RATE: ObservationModel(
          ObservationKind.YAW_RATE, _h_yaw_rate, 1, maha_test=True),
      ObservationKind.LATERAL_SLIP: ObservationModel(
          ObservationKind.LATERAL_SLIP, _h_lateral_slip, 1),
  }
  return FilterSpec(
      name='car', dim_x=DIM, dim_err=DIM, f=_f, obs=obs,
      default_params=dict(DEFAULT_PARAMS))


@register
class CarKalman(KalmanFilter):
  """Vehicle-model parameter estimator (paramsd-style)."""

  name = 'car'

  initial_x = np.array([15.0, 1.0, 0.0, 0.0, 0.0])
  initial_P_diag = np.array([5.0**2, 0.25**2, 2.0**2, 1.0**2, 1.0**2])
  # calibration states drift slowly; dynamics absorb model error faster
  Q = np.diag([0.005**2, 0.002**2, 0.01**2, 0.1**2, 0.05**2])
  obs_noise = {
      ObservationKind.YAW_RATE: np.atleast_2d(0.001**2),
      ObservationKind.LATERAL_SLIP: np.atleast_2d(0.3**2),
  }

  @classmethod
  def build_spec(cls) -> FilterSpec:
    return build_car_spec()

  def set_inputs(self, u: float, steer_angle_deg: float):
    """Per-tick control inputs as runtime params (the reference's set_<var>
    C-global pattern)."""
    self.filter.set_global('u', float(u))
    self.filter.set_global('steer_angle_deg', float(steer_angle_deg))
