"""GNSS localizer: the downstream loc_kf family.

Port of rednose_tpu/models/loc.py: an 11-state ECEF position / velocity /
receiver-clock filter whose pseudorange and pseudorange-rate observations
take per-measurement satellite states through the non-feature extra-args
path (ObservationModel.ea_len > 0, ea_dim == 0; reference plumbing:
obs_eqs entries with extra args outside feature_track_kinds,
ekf_sym.py:84-89).

State (additive error state):
    [0:3]  ECEF position (m)
    [3:6]  ECEF velocity (m/s)
    [6]    receiver clock bias (m)
    [7]    receiver clock drift (m/s)
    [8:11] acceleration (m/s^2), random walk

Observation models:
    PSEUDORANGE(_GPS):      rho = |pos - sat_pos| + bias          ea = sat_pos (3,)
    PSEUDORANGE_RATE(_GPS): rho_dot = u.(vel - sat_vel) + drift   ea = [sat_pos, sat_vel] (6,)
    ECEF_POS:               direct position fix
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel
from rednose_tpu_torch.models.kalman_filter import KalmanFilter
from rednose_tpu_torch.models.live import ObservationKind
from rednose_tpu_torch.registry import register

DIM = 11

_EARTH_R = 6.371e6


def _f(params, x, dt):
  del params
  pos, vel = x[0:3], x[3:6]
  bias, drift = x[6], x[7]
  acc = x[8:11]
  return torch.cat([
      pos + dt * vel,
      vel + dt * acc,
      (bias + dt * drift)[None],
      drift[None],
      acc,
  ])


def _range(x, sat_pos):
  d = x[0:3] - sat_pos
  # clamped: a zero range makes the direction (and its Jacobian) undefined
  return d, torch.sqrt(torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2],
                                   min=1e-6))


def _h_pseudorange(params, x, ea):
  del params
  _, rho = _range(x, ea[0:3])
  return (rho + x[6])[None]


def _h_pseudorange_rate(params, x, ea):
  del params
  d, rho = _range(x, ea[0:3])
  u = d / rho
  return (u @ (x[3:6] - ea[3:6]) + x[7])[None]


def _h_ecef_pos(params, x, ea):
  del params, ea
  return x[0:3]


@functools.cache
def build_loc_spec() -> FilterSpec:
  """The loc spec, one object per process: the generic kernels' emitted
  sources and detected structures are cached per spec object."""
  obs = {}
  for kind in (ObservationKind.PSEUDORANGE_GPS, ObservationKind.PSEUDORANGE):
    obs[kind] = ObservationModel(
        kind=kind, h=_h_pseudorange, dz=1, ea_dim=0, ea_len=3,
        maha_test=True)
  for kind in (ObservationKind.PSEUDORANGE_RATE_GPS,
               ObservationKind.PSEUDORANGE_RATE):
    obs[kind] = ObservationModel(
        kind=kind, h=_h_pseudorange_rate, dz=1, ea_dim=0, ea_len=6,
        maha_test=True)
  obs[ObservationKind.ECEF_POS] = ObservationModel(
      kind=ObservationKind.ECEF_POS, h=_h_ecef_pos, dz=3)
  return FilterSpec(name="loc", dim_x=DIM, dim_err=DIM, f=_f, obs=obs)


@register
class LocKalman(KalmanFilter):
  """GNSS receiver filter facade (loc_kf-style)."""

  name = "loc"
  initial_x = np.concatenate([
      [_EARTH_R, 0.0, 0.0],     # somewhere on the sphere
      np.zeros(3),              # velocity
      [0.0, 0.0],               # clock bias / drift
      np.zeros(3),              # acceleration
  ])
  initial_P_diag = np.concatenate([
      1e8 * np.ones(3), 1e2 * np.ones(3), [1e6, 1e2], 1e1 * np.ones(3)])
  Q = np.diag(np.concatenate([
      0.03 * np.ones(3), 1e-4 * np.ones(3), [0.1, 0.01],
      0.005 * np.ones(3)]))
  obs_noise = {
      ObservationKind.PSEUDORANGE_GPS: np.atleast_2d(4.0),
      ObservationKind.PSEUDORANGE: np.atleast_2d(4.0),
      ObservationKind.PSEUDORANGE_RATE_GPS: np.atleast_2d(0.05**2),
      ObservationKind.PSEUDORANGE_RATE: np.atleast_2d(0.05**2),
      ObservationKind.ECEF_POS: np.diag([25.0] * 3),
  }

  @classmethod
  def build_spec(cls) -> FilterSpec:
    return build_loc_spec()
