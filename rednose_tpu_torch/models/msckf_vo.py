"""MSCKF visual odometry: a position / velocity filter with a sliding
window of position clones.

Port of rednose_tpu/models/msckf_vo.py. The reference ships the MSCKF
machinery (augmentation ekf_sym.py:365-391, He Jacobians and
nullspace-projected updates ekf_sym.py:86-87 / 576-591, Gauss-Newton
triangulation) but no in-repo filter that uses it; this model wires it
together: a camera frame triangulates its feature tracks
(msckf/triangulation.py), applies the projected feature updates across the
clone window (ObservationKind.MSCKF_TEST, live_kf.py:34), then clones the
current pose into the window (augment).

Camera model: normalized pinhole looking along +z of the identity-attitude
body frame; tracks observe static world landmarks. The model functions are
written with torch.cat / torch.stack (no in-place writes), so jacfwd,
vmap and the structural interpreter trace them.
"""

from __future__ import annotations

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel
from rednose_tpu_torch.models.kalman_filter import KalmanFilter
from rednose_tpu_torch.msckf.triangulation import compute_pos_batch
from rednose_tpu_torch.registry import register


class ObservationKind:
  POSITION = 12       # direct position fix (ECEF_POS analog)
  MSCKF_TEST = 16     # feature-track update (live_kf.py:34)

  names = {12: 'Position', 16: 'MSCKF feature track'}

  @classmethod
  def to_string(cls, kind):
    return cls.names[kind]


N_AUGMENT = 4     # sliding-window length (pose clones kept in state)
DIM_MAIN = 6      # position (3) + velocity (3)
DIM_AUG = 3       # each clone: position
DIM_X = DIM_MAIN + DIM_AUG * N_AUGMENT


def _f(params, x, dt):
  """Constant-velocity kinematics on the main state; the clones are static
  (the block structure of templates/ekf_c.c:8-33)."""
  del params
  return torch.cat([x[0:3] + dt * x[3:6], x[3:]])


def _h_position(params, x, ea):
  del params, ea
  return x[0:3]


def _h_feature(params, x, ea):
  """Normalized image coordinates of landmark ea (3,) from every clone of
  the window: dz = 2 * N_AUGMENT; the 3 landmark dims are projected out at
  update time (ea_dim = 3)."""
  del params
  outs = []
  for a in range(N_AUGMENT):
    d = ea - x[DIM_MAIN + DIM_AUG * a: DIM_MAIN + DIM_AUG * (a + 1)]
    outs.append(torch.stack([d[0] / d[2], d[1] / d[2]]))
  return torch.cat(outs)


def build_msckf_vo_spec() -> FilterSpec:
  obs = {
      ObservationKind.POSITION: ObservationModel(
          kind=ObservationKind.POSITION, h=_h_position, dz=3),
      # gate confidently wrong feature updates (bad triangulation), as the
      # reference gates feature kinds (maha_test_kinds, ekf_sym.py:144-152)
      ObservationKind.MSCKF_TEST: ObservationModel(
          kind=ObservationKind.MSCKF_TEST, h=_h_feature, dz=2 * N_AUGMENT,
          ea_dim=3, maha_test=True),
  }
  return FilterSpec(
      name='msckf_vo', dim_x=DIM_X, dim_err=DIM_X, f=_f, obs=obs,
      dim_main=DIM_MAIN, dim_main_err=DIM_MAIN,
      dim_augment=DIM_AUG, dim_augment_err=DIM_AUG, n_augment=N_AUGMENT)


def window_poses(x):
  """(N_AUGMENT, 7) clone-window camera poses [pos, identity quat] of one
  nominal state x (numpy)."""
  quat_id = np.array([1.0, 0.0, 0.0, 0.0])
  return np.stack([
      np.concatenate([x[DIM_MAIN + DIM_AUG * a: DIM_MAIN + DIM_AUG * (a + 1)],
                      quat_id]) for a in range(N_AUGMENT)])


def frame_update(kf, t, tracks_img, kind, triangulate, poses):
  """The camera-frame flow shared by the MSCKF facades: triangulate every
  complete track (tracks_img (n, N_AUGMENT, 2), row k seen from clone k,
  oldest first) from the window `poses` on the filter's device (kernel 8
  on the card), apply the projected feature update of the tracks that
  converged, then augment. With no usable track
  the filter still predicts to t and augments, so the window keeps the
  camera cadence (otherwise every later track is matched against stale
  clones)."""
  tracks_img = np.asarray(tracks_img, dtype=np.float64)
  if tracks_img.ndim == 2:
    tracks_img = tracks_img[None]
  if tracks_img.ndim != 3 or tracks_img.shape[1:] != (N_AUGMENT, 2):
    raise ValueError(f"tracks_img {tracks_img.shape}, expected "
                     f"(n, {N_AUGMENT}, 2)")
  n = tracks_img.shape[0]
  if n:
    # on the filter's device: kernel 8 triangulates on the card
    t64 = dict(dtype=torch.float64, device=kf.filter.device)
    poses_b = torch.as_tensor(poses, **t64).expand(n, *poses.shape)
    pos, ok = triangulate(torch.eye(3, **t64), poses_b,
                          torch.as_tensor(tracks_img, **t64))
    ok = ok.cpu().numpy()
    if ok.any():
      z = tracks_img[ok].reshape(int(ok.sum()), -1)
      return kf.filter.predict_and_update_batch(
          t, kind, z, kf.get_R(kind, int(ok.sum())),
          extra_args=pos.cpu().numpy()[ok], augment=True)
  return kf.filter.predict_and_update_batch(
      t, ObservationKind.POSITION, np.zeros((0, 3)), np.zeros((0, 3, 3)),
      augment=True)


@register
class MSCKFVisualOdometry(KalmanFilter):
  """Facade running the full MSCKF camera-frame pipeline."""

  name = 'msckf_vo'

  initial_x = np.zeros(DIM_X)
  initial_P_diag = np.concatenate([
      np.full(3, 1.0**2), np.full(3, 1.0**2),
      np.full(DIM_AUG * N_AUGMENT, 1.0**2)])
  Q = np.diag(np.concatenate([
      np.full(3, 0.05**2), np.full(3, 0.5**2),
      np.full(DIM_AUG * N_AUGMENT, 1e-12)]))  # clones are static
  obs_noise = {
      ObservationKind.POSITION: np.diag([1.0**2] * 3),
      ObservationKind.MSCKF_TEST: np.diag([0.01**2] * (2 * N_AUGMENT)),
  }

  _spec_cache = None

  @classmethod
  def build_spec(cls) -> FilterSpec:
    if cls._spec_cache is None:
      cls._spec_cache = build_msckf_vo_spec()
    return cls._spec_cache

  def observe_camera_frame(self, t, tracks_img):
    """One camera frame (predict_and_update_batch(..., augment=True),
    ekf_sym.py:525-526): tracks_img (n_tracks, N_AUGMENT, 2) normalized
    image observations, row k from clone k (oldest first)."""
    return frame_update(self, t, tracks_img, ObservationKind.MSCKF_TEST,
                        compute_pos_batch, window_poses(self.filter.state()))
