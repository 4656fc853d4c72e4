"""MSCKF composed with a quaternion ESKF: the reference's msckf_params and
eskf_params in one filter.

Port of rednose_tpu/models/msckf_eskf.py. The reference designs the two to
coexist (ekf_sym.py:57-66 augments dims beside the error-state machinery;
downstream openpilot's loc_kf uses both, with He = dh/dea for a full-pose
window, ekf_sym.py:86-87). One update runs augment + He nullspace
projection + H . H_mod + error injection (ekf_sym.py:365-391, 576-624).

State layout (nominal 41 / error 36):
  main nominal (13): ecef_pos(3) quat(4) vel(3) angular_vel(3)
  main error  (12): pos_err(3) att_err(3) vel_err(3) omega_err(3)
  4 clones: nominal pose (pos(3) quat(4)) = 7 each; error (3+3) = 6 each

The model functions are written with torch.cat / torch.stack (no in-place
writes), so jacfwd, vmap and the structural interpreter trace them.
"""

from __future__ import annotations

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel
from rednose_tpu_torch.models.kalman_filter import KalmanFilter
from rednose_tpu_torch.models.live import _omega_matrix
from rednose_tpu_torch.models.msckf_vo import frame_update
from rednose_tpu_torch.msckf.triangulation import compute_pos_batch
from rednose_tpu_torch.ops.quaternion import (
    euler_to_rot,
    quat_matrix_r,
    quat_to_rot,
)
from rednose_tpu_torch.registry import register


class ObservationKind:
  POSITION = 12        # direct ECEF position fix
  MSCKF_FEATURE = 16   # nullspace-projected feature track (live_kf.py:34)

  names = {12: 'Position', 16: 'MSCKF feature track'}

  @classmethod
  def to_string(cls, kind):
    return cls.names[kind]


N_AUGMENT = 4
DIM_MAIN, DIM_MAIN_ERR = 13, 12
DIM_AUG, DIM_AUG_ERR = 7, 6
DIM_X = DIM_MAIN + DIM_AUG * N_AUGMENT        # 41
DIM_ERR = DIM_MAIN_ERR + DIM_AUG_ERR * N_AUGMENT  # 36


def _clone_nom(a):
  """Nominal slices of clone a: (pos, quat)."""
  o = DIM_MAIN + DIM_AUG * a
  return slice(o, o + 3), slice(o + 3, o + 7)


def _clone_err(a):
  """Error slices of clone a: (pos_err, att_err)."""
  o = DIM_MAIN_ERR + DIM_AUG_ERR * a
  return slice(o, o + 3), slice(o + 3, o + 6)


def _f(params, x, dt):
  """Main-state kinematics (pos <- vel, quat <- omega); the clones are
  static (the block structure templates/ekf_c.c:8-33 exploits)."""
  del params
  q, v, w = x[3:7], x[7:10], x[10:13]
  return torch.cat([x[0:3] + dt * v, q + dt * (_omega_matrix(w) @ q),
                    x[7:]])


def _f_err(params, x, dx, dt):
  """Error dynamics at the nominal trajectory (live-style attitude error);
  the clone errors are static."""
  del params
  q, w = x[3:7], x[10:13]
  att_err, v_err, w_err = dx[3:6], dx[6:9], dx[9:12]
  return torch.cat([
      dx[0:3] + dt * v_err,
      att_err + dt * (euler_to_rot(att_err) @ quat_to_rot(q) @ (w + w_err)),
      dx[6:],
  ])


def _compose_quat(q, dtheta):
  """q_new = quat_matrix_r(q) @ [1, 0.5 dtheta] (live_kf.py:200-205)."""
  delta = torch.cat([torch.ones_like(dtheta[0:1]), 0.5 * dtheta])
  return quat_matrix_r(q) @ delta


def _err(params, nom_x, dx):
  """Error injection: additive except every quaternion (main and clones),
  which composes multiplicatively."""
  del params
  parts = [nom_x[0:3] + dx[0:3], _compose_quat(nom_x[3:7], dx[3:6]),
           nom_x[7:13] + dx[6:12]]
  for a in range(N_AUGMENT):
    pn, qn = _clone_nom(a)
    pe, ae = _clone_err(a)
    parts += [nom_x[pn] + dx[pe], _compose_quat(nom_x[qn], dx[ae])]
  return torch.cat(parts)


def _inv_err(params, nom_x, true_x):
  del params
  parts = [true_x[0:3] - nom_x[0:3],
           2.0 * (quat_matrix_r(nom_x[3:7]).T @ true_x[3:7])[1:],
           true_x[7:13] - nom_x[7:13]]
  for a in range(N_AUGMENT):
    pn, qn = _clone_nom(a)
    parts += [true_x[pn] - nom_x[pn],
              2.0 * (quat_matrix_r(nom_x[qn]).T @ true_x[qn])[1:]]
  return torch.cat(parts)


def _H_mod(params, x):
  """(41, 36) error -> nominal modifier: identity blocks plus a 4 x 3
  0.5 quat_matrix_r(q)[:, 1:] block per quaternion (main and clones)."""
  del params

  def z(r, c):
    return torch.zeros((r, c), dtype=x.dtype, device=x.device)

  def eye(n):
    return torch.eye(n, dtype=x.dtype, device=x.device)

  def qblock(q):
    return 0.5 * quat_matrix_r(q)[:, 1:]

  rows = [torch.cat([eye(3), z(3, DIM_ERR - 3)], dim=1),
          torch.cat([z(4, 3), qblock(x[3:7]), z(4, DIM_ERR - 6)], dim=1),
          torch.cat([z(6, 6), eye(6), z(6, DIM_ERR - 12)], dim=1)]
  for a in range(N_AUGMENT):
    o = DIM_MAIN_ERR + DIM_AUG_ERR * a
    qn = _clone_nom(a)[1]
    rows.append(torch.cat([z(3, o), eye(3), z(3, DIM_ERR - o - 3)], dim=1))
    rows.append(torch.cat([z(4, o + 3), qblock(x[qn]),
                           z(4, DIM_ERR - o - 6)], dim=1))
  return torch.cat(rows)


def _h_position(params, x, ea):
  del params, ea
  return x[0:3]


def _h_feature(params, x, ea):
  """Normalized image coordinates of landmark ea (3,) seen from every
  clone POSE: d_cam = R(q_a)^T (ea - p_a), h = d_xy / d_z; dz = 2 N_AUGMENT,
  the 3 landmark dims projected out at update time."""
  del params
  outs = []
  for a in range(N_AUGMENT):
    pn, qn = _clone_nom(a)
    d = quat_to_rot(x[qn]).T @ (ea - x[pn])
    outs.append(torch.stack([d[0] / d[2], d[1] / d[2]]))
  return torch.cat(outs)


def build_msckf_eskf_spec() -> FilterSpec:
  obs = {
      ObservationKind.POSITION: ObservationModel(
          kind=ObservationKind.POSITION, h=_h_position, dz=3),
      ObservationKind.MSCKF_FEATURE: ObservationModel(
          kind=ObservationKind.MSCKF_FEATURE, h=_h_feature,
          dz=2 * N_AUGMENT, ea_dim=3, maha_test=True),
  }
  return FilterSpec(
      name='msckf_eskf', dim_x=DIM_X, dim_err=DIM_ERR, f=_f, obs=obs,
      err=_err, inv_err=_inv_err, H_mod=_H_mod, f_err=_f_err,
      quaternion_idxs=tuple([3] + [DIM_MAIN + DIM_AUG * a + 3
                                   for a in range(N_AUGMENT)]),
      dim_main=DIM_MAIN, dim_main_err=DIM_MAIN_ERR,
      dim_augment=DIM_AUG, dim_augment_err=DIM_AUG_ERR,
      n_augment=N_AUGMENT,
      extra_routines={'compute_pos': compute_pos_batch})


def _initial_x():
  x = np.zeros(DIM_X)
  x[3] = 1.0  # main quat = identity
  for a in range(N_AUGMENT):
    x[DIM_MAIN + DIM_AUG * a + 3] = 1.0  # clone quats = identity
  return x


def window_poses(x):
  """(N_AUGMENT, 7) clone-window poses [pos, quat] of one nominal state x
  (numpy)."""
  return np.stack([np.concatenate([x[_clone_nom(a)[0]], x[_clone_nom(a)[1]]])
                   for a in range(N_AUGMENT)])


@register
class MSCKFEskf(KalmanFilter):
  """Facade for the MSCKF x ESKF visual-odometry localizer."""

  name = 'msckf_eskf'

  initial_x = _initial_x()
  initial_P_diag = np.concatenate([
      np.full(3, 1.0**2), np.full(3, 0.1**2), np.full(3, 1.0**2),
      np.full(3, 0.05**2),
      np.tile(np.concatenate([np.full(3, 1.0**2), np.full(3, 0.1**2)]),
              N_AUGMENT)])
  Q = np.diag(np.concatenate([
      np.full(3, 0.05**2), np.full(3, 0.001**2), np.full(3, 0.5**2),
      np.full(3, 0.05**2),
      np.full(DIM_AUG_ERR * N_AUGMENT, 1e-12)]))  # clones are static
  obs_noise = {
      ObservationKind.POSITION: np.diag([1.0**2] * 3),
      ObservationKind.MSCKF_FEATURE: np.diag([0.01**2] * (2 * N_AUGMENT)),
  }

  _spec_cache = None

  @classmethod
  def build_spec(cls) -> FilterSpec:
    if cls._spec_cache is None:
      cls._spec_cache = build_msckf_eskf_spec()
    return cls._spec_cache

  def observe_camera_frame(self, t, tracks_img):
    """One camera frame: triangulate each complete track from the clone
    POSES through the spec's compute_pos extra routine, apply the projected
    feature update, then augment (ekf_sym.py:525-526)."""
    return frame_update(self, t, tracks_img, ObservationKind.MSCKF_FEATURE,
                        self.filter.get_extra_routine('compute_pos'),
                        window_poses(self.filter.state()))
