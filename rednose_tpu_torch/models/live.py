"""live_kf: comma.ai openpilot's IMU+GNSS+odometry localization ESKF.

Port of rednose_tpu/models/live.py (the reference flagship filter,
examples/live_kf.py:94-342): a 23-dim nominal / 22-dim error-state filter
over ECEF position, attitude quaternion, ECEF velocity, device-frame angular
velocity, gyro bias, odometer scale, device-frame acceleration and IMU
mounting-angle offset. The dynamics and observation models are torch
functions built with torch.stack / torch.cat, and every Jacobian (F, H per
kind) comes from torch.func.jacfwd.

The closed-form lane-major F (`F_lane`, JAX live.py:281) comes with the
smoother slice of the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel
from rednose_tpu_torch.models.kalman_filter import KalmanFilter
from rednose_tpu_torch.ops.quaternion import (
    euler_to_rot,
    quat_matrix_r,
    quat_to_rot,
    skew,
)
from rednose_tpu_torch.registry import register
from rednose_tpu_torch.runtime.driver import KalmanError

EARTH_GM = 3.986005e14  # m^3/s^2 (gravitational constant * mass of earth)


class ObservationKind:
  """Observation-kind enumeration (mirrors examples/live_kf.py:17-70)."""
  UNKNOWN = 0
  NO_OBSERVATION = 1
  GPS_NED = 2
  ODOMETRIC_SPEED = 3
  PHONE_GYRO = 4
  GPS_VEL = 5
  PSEUDORANGE_GPS = 6
  PSEUDORANGE_RATE_GPS = 7
  SPEED = 8
  NO_ROT = 9
  PHONE_ACCEL = 10
  ORB_POINT = 11
  ECEF_POS = 12
  CAMERA_ODO_TRANSLATION = 13
  CAMERA_ODO_ROTATION = 14
  ORB_FEATURES = 15
  MSCKF_TEST = 16
  FEATURE_TRACK_TEST = 17
  LANE_PT = 18
  IMU_FRAME = 19
  PSEUDORANGE_GLONASS = 20
  PSEUDORANGE_RATE_GLONASS = 21
  PSEUDORANGE = 22
  PSEUDORANGE_RATE = 23

  names = [
      'Unknown', 'No observation', 'GPS NED', 'Odometric speed', 'Phone gyro',
      'GPS velocity', 'GPS pseudorange', 'GPS pseudorange rate', 'Speed',
      'No rotation', 'Phone acceleration', 'ORB point', 'ECEF pos',
      'camera odometric translation', 'camera odometric rotation',
      'ORB features', 'MSCKF test', 'Feature track test', 'Lane ecef point',
      'imu frame eulers', 'GLONASS pseudorange', 'GLONASS pseudorange rate',
      # The reference's own names list stops at 21 and IndexErrors for the
      # constellation-generic kinds (examples/live_kf.py:43-66 has 22 names
      # for 24 kinds); the rebuild fixes that latent bug.
      'pseudorange', 'pseudorange rate',
  ]

  @classmethod
  def to_string(cls, kind):
    return cls.names[kind]


class States:
  """Nominal- and error-state slices (mirrors examples/live_kf.py:73-91)."""
  ECEF_POS = slice(0, 3)
  ECEF_ORIENTATION = slice(3, 7)
  ECEF_VELOCITY = slice(7, 10)
  ANGULAR_VELOCITY = slice(10, 13)
  GYRO_BIAS = slice(13, 16)
  ODO_SCALE = slice(16, 17)
  ACCELERATION = slice(17, 20)
  IMU_OFFSET = slice(20, 23)

  ECEF_POS_ERR = slice(0, 3)
  ECEF_ORIENTATION_ERR = slice(3, 6)
  ECEF_VELOCITY_ERR = slice(6, 9)
  ANGULAR_VELOCITY_ERR = slice(9, 12)
  GYRO_BIAS_ERR = slice(12, 15)
  ODO_SCALE_ERR = slice(15, 16)
  ACCELERATION_ERR = slice(16, 19)
  IMU_OFFSET_ERR = slice(19, 22)


DIM_STATE = 23
DIM_STATE_ERR = 22

S = States  # local alias


def _omega_matrix(w):
  """0.5 * Omega(omega): quaternion-derivative matrix (live_kf.py:154-157)."""
  wr, wp, wy = w[0], w[1], w[2]
  zero = torch.zeros_like(wr)
  return 0.5 * torch.stack([
      torch.stack([zero, -wr, -wp, -wy]),
      torch.stack([wr, zero, wy, -wp]),
      torch.stack([wp, -wy, zero, wr]),
      torch.stack([wy, wp, -wr, zero]),
  ])


def _f(params, x, dt):
  """First-order integrator over the nominal state (live_kf.py:160-168)."""
  del params
  q = x[S.ECEF_ORIENTATION]
  v = x[S.ECEF_VELOCITY]
  omega = x[S.ANGULAR_VELOCITY]
  accel = x[S.ACCELERATION]
  return torch.cat([
      x[S.ECEF_POS] + dt * v,
      q + dt * (_omega_matrix(omega) @ q),
      v + dt * (quat_to_rot(q) @ accel),
      x[10:],
  ])


def _f_err(params, x, dx, dt):
  """Error-state dynamics (live_kf.py:177-184): the attitude error is an
  euler triple rotated through the nominal attitude; F is its jacfwd at
  dx = 0 (ekf_sym.py:76-80)."""
  del params
  q = x[S.ECEF_ORIENTATION]
  omega = x[S.ANGULAR_VELOCITY]
  accel = x[S.ACCELERATION]
  q_err = dx[S.ECEF_ORIENTATION_ERR]
  v_err = dx[S.ECEF_VELOCITY_ERR]
  omega_err = dx[S.ANGULAR_VELOCITY_ERR]
  accel_err = dx[S.ACCELERATION_ERR]
  err_rot = euler_to_rot(q_err)
  quat_rot = quat_to_rot(q)
  return torch.cat([
      dx[S.ECEF_POS_ERR] + dt * v_err,
      dx[S.ECEF_ORIENTATION_ERR] + dt * (err_rot @ quat_rot
                                         @ (omega + omega_err)),
      dx[S.ECEF_VELOCITY_ERR] + dt * (err_rot @ quat_rot
                                      @ (accel + accel_err)),
      dx[9:],
  ])


def _err(params, nom_x, dx):
  """true_x = err(nom_x, dx): additive except the quaternion, which composes
  with delta_quat = [1, 0.5*dtheta] via the right product matrix
  (live_kf.py:200-205)."""
  del params
  delta_quat = torch.cat(
      [torch.ones_like(dx[0:1]), 0.5 * dx[S.ECEF_ORIENTATION_ERR]])
  return torch.cat([
      nom_x[S.ECEF_POS] + dx[S.ECEF_POS_ERR],
      quat_matrix_r(nom_x[S.ECEF_ORIENTATION]) @ delta_quat,
      nom_x[7:] + dx[6:],
  ])


def _inv_err(params, nom_x, true_x):
  """dx = inv_err(nom_x, true_x) (live_kf.py:207-211)."""
  del params
  delta_quat = (quat_matrix_r(nom_x[S.ECEF_ORIENTATION]).T
                @ true_x[S.ECEF_ORIENTATION])
  return torch.cat([
      true_x[S.ECEF_POS] - nom_x[S.ECEF_POS],
      2.0 * delta_quat[1:],
      true_x[7:] - nom_x[7:],
  ])


def _H_mod(params, x):
  """Observation-matrix modifier from error state to nominal state
  (live_kf.py:187-190): identity blocks except the 4x3 quaternion block
  0.5 * quat_matrix_r(q)[:, 1:]. Block-concatenated, no in-place writes."""
  del params

  def z(r, c):
    return torch.zeros((r, c), dtype=x.dtype, device=x.device)

  def eye(n):
    return torch.eye(n, dtype=x.dtype, device=x.device)

  qr = 0.5 * quat_matrix_r(x[S.ECEF_ORIENTATION])[:, 1:]
  return torch.cat([
      torch.cat([eye(3), z(3, DIM_STATE_ERR - 3)], dim=1),
      torch.cat([z(4, 3), qr, z(4, DIM_STATE_ERR - 6)], dim=1),
      torch.cat([z(DIM_STATE - 7, 6), eye(DIM_STATE - 7)], dim=1),
  ])


# ---------------------------------------------------------------- observations

def _h_odo_speed(params, x, ea):
  """Odometer speed = |v| * odo_scale (live_kf.py:229-230)."""
  del params, ea
  v = x[S.ECEF_VELOCITY]
  return torch.sqrt(v[0]**2 + v[1]**2 + v[2]**2) * x[S.ODO_SCALE]


def _h_gyro(params, x, ea):
  """Gyro: (omega + bias) rotated by the IMU mounting offset (live_kf.py:219-222)."""
  del params, ea
  imu_rot = euler_to_rot(x[S.IMU_OFFSET])
  return imu_rot @ (x[S.ANGULAR_VELOCITY] + x[S.GYRO_BIAS])


def _h_phone_rot(params, x, ea):
  """Angular velocity directly (NO_ROT / CAMERA_ODO_ROTATION, live_kf.py:227)."""
  del params, ea
  return x[S.ANGULAR_VELOCITY]


def _h_acc(params, x, ea):
  """Accelerometer: device-frame gravity plus acceleration, through the IMU
  mounting offset (live_kf.py:224-226)."""
  del params, ea
  p = x[S.ECEF_POS]
  q = x[S.ECEF_ORIENTATION]
  imu_rot = euler_to_rot(x[S.IMU_OFFSET])
  r2 = p[0]**2 + p[1]**2 + p[2]**2
  gravity = quat_to_rot(q).T @ ((EARTH_GM / r2**1.5) * p)
  return imu_rot @ (gravity + x[S.ACCELERATION])


def _h_pos(params, x, ea):
  del params, ea
  return x[S.ECEF_POS]


def _h_relative_motion(params, x, ea):
  """Device-frame velocity R(q)^T v (CAMERA_ODO_TRANSLATION, live_kf.py:235)."""
  del params, ea
  return quat_to_rot(x[S.ECEF_ORIENTATION]).T @ x[S.ECEF_VELOCITY]


def _h_imu_frame(params, x, ea):
  del params, ea
  return x[S.IMU_OFFSET]


def _F_lane(params, x, dt):
  """Closed-form F = I + dt*A on a slab x (23, *b) -> (22, 22, *b).

  A is the error-dynamics Jacobian at dx = 0 (ekf_sym.py:76-80): five
  nonzero 3x3 blocks, A[pos, vel] = I, A[att, att] = -skew(R w),
  A[att, w] = R, A[vel, att] = -skew(R a), A[vel, acc] = R, with
  R = quat_to_rot(q). Equal to jacfwd of _f_err (tests/test_torch_rts_live.py).
  Assembled from blocks by concatenation: dt is a scalar or (*b)."""
  del params
  q, w, a = x[3:7], x[10:13], x[17:20]
  b = tuple(x.shape[1:])
  Rq = quat_to_rot(q)                                          # (3, 3, *b)

  def rot(v):
    return torch.stack([sum(Rq[i, j] * v[j] for j in range(3))
                        for i in range(3)])

  wd, ad = rot(w), rot(a)
  kw = dict(dtype=x.dtype, device=x.device)

  def z(r, c):
    return torch.zeros((r, c) + b, **kw)

  eye3 = torch.eye(3, **kw).reshape((3, 3) + (1,) * len(b)).expand(
      (3, 3) + b)
  n = DIM_STATE_ERR
  A = torch.cat([
      torch.cat([z(3, 6), eye3, z(3, n - 9)], dim=1),
      torch.cat([z(3, 3), -skew(wd), z(3, 3), Rq, z(3, n - 12)], dim=1),
      torch.cat([z(3, 3), -skew(ad), z(3, 10), Rq, z(3, n - 19)], dim=1),
      z(n - 9, n),
  ])
  dt = torch.as_tensor(dt, **kw)
  eye = torch.eye(n, **kw).reshape((n, n) + (1,) * len(b))
  return eye + dt * A


@functools.cache
def build_live_spec() -> FilterSpec:
  """The live spec, one object per process: the generic kernels' emitted
  sources and detected structures are cached per spec object."""
  K = ObservationKind
  obs = {
      K.ODOMETRIC_SPEED: ObservationModel(K.ODOMETRIC_SPEED, _h_odo_speed, 1),
      K.PHONE_GYRO: ObservationModel(K.PHONE_GYRO, _h_gyro, 3),
      K.NO_ROT: ObservationModel(K.NO_ROT, _h_phone_rot, 3),
      K.PHONE_ACCEL: ObservationModel(K.PHONE_ACCEL, _h_acc, 3),
      K.ECEF_POS: ObservationModel(K.ECEF_POS, _h_pos, 3),
      K.CAMERA_ODO_TRANSLATION: ObservationModel(
          K.CAMERA_ODO_TRANSLATION, _h_relative_motion, 3),
      K.CAMERA_ODO_ROTATION: ObservationModel(
          K.CAMERA_ODO_ROTATION, _h_phone_rot, 3),
      K.IMU_FRAME: ObservationModel(K.IMU_FRAME, _h_imu_frame, 3),
  }
  return FilterSpec(
      name='live',
      dim_x=DIM_STATE,
      dim_err=DIM_STATE_ERR,
      f=_f,
      obs=obs,
      err=_err,
      inv_err=_inv_err,
      H_mod=_H_mod,
      f_err=_f_err,
      quaternion_idxs=(3,),
      F_lane=_F_lane,
  )


@register
class LiveKalman(KalmanFilter):
  """Facade mirroring the reference LiveKalman runtime API
  (examples/live_kf.py:248-337). The numpy constants below equal the JAX
  package's LiveKalman constants (asserted in tests)."""

  name = 'live'

  initial_x = np.array([-2.7e6, 4.2e6, 3.8e6,
                        1, 0, 0, 0,
                        0, 0, 0,
                        0, 0, 0,
                        0, 0, 0,
                        1,
                        0, 0, 0,
                        0, 0, 0], dtype=np.float64)

  initial_P_diag = np.array([1e4**2, 1e4**2, 1e4**2,
                             10**2, 10**2, 10**2,
                             10**2, 10**2, 10**2,
                             1, 1, 1,
                             0.05**2, 0.05**2, 0.05**2,
                             0.02**2,
                             1, 1, 1,
                             0.01**2, 0.01**2, 0.01**2])

  Q = np.diag([0.03**2, 0.03**2, 0.03**2,
               0.0, 0.0, 0.0,
               0.0, 0.0, 0.0,
               0.1**2, 0.1**2, 0.1**2,
               (0.005 / 100)**2, (0.005 / 100)**2, (0.005 / 100)**2,
               (0.02 / 100)**2,
               3**2, 3**2, 3**2,
               (0.05 / 60)**2, (0.05 / 60)**2, (0.05 / 60)**2])

  obs_noise = {
      ObservationKind.ODOMETRIC_SPEED: np.atleast_2d(0.2**2),
      ObservationKind.PHONE_GYRO: np.diag([0.025**2] * 3),
      ObservationKind.PHONE_ACCEL: np.diag([0.5**2] * 3),
      ObservationKind.CAMERA_ODO_ROTATION: np.diag([0.05**2] * 3),
      ObservationKind.IMU_FRAME: np.diag([0.05**2] * 3),
      ObservationKind.NO_ROT: np.diag([0.00025**2] * 3),
      ObservationKind.ECEF_POS: np.diag([5**2] * 3),
  }

  @classmethod
  def build_spec(cls) -> FilterSpec:
    return build_live_spec()

  def rts_smooth(self, estimates, parallel=False):
    return self.filter.rts_smooth(estimates, norm_quats=True,
                                  parallel=parallel)

  def predict_and_observe(self, t, kind, data, R=None):
    """Per-kind dispatch: camera-odometry kinds carry their own measurement
    std devs in columns 3:6 (live_kf.py:287-297, 325-337); afterwards the
    quaternion norm is sanity-checked (live_kf.py:299-306)."""
    if len(data) > 0:
      data = np.atleast_2d(data)
    if R is None:
      if kind in (ObservationKind.CAMERA_ODO_TRANSLATION,
                  ObservationKind.CAMERA_ODO_ROTATION):
        z = data[:, :3]
        R = np.stack([np.diag(row[3:6]**2) for row in data])
        r = self.filter.predict_and_update_batch(t, kind, z, R)
      else:
        r = self.filter.predict_and_update_batch(
            t, kind, data, self.get_R(kind, len(data)))
    else:
      r = self.filter.predict_and_update_batch(t, kind, data, R)

    # Divergence guard (live_kf.py:299-306). The engine renormalizes the
    # quaternion inside every step (quaternion_idxs), so a wildly non-unit
    # norm before renormalization cannot be observed here; the check catches
    # NaN/inf blowup of the (already renormalized) state instead.
    quat = self.filter.state()[3:7]
    quat_norm = np.linalg.norm(quat)
    if not (0.1 < quat_norm < 10) or not np.isfinite(quat_norm):
      raise KalmanError("Kalman filter quaternions unstable")
    return r
