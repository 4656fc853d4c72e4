"""Pure-functional EKF predict / update steps on torch tensors.

Port of rednose_tpu/core/step.py, the port's oracle. `predict` follows the
reference's generated C (rednose/templates/ekf_c.c:8-33) and `update`
follows ekf_c.c:38-121: innovation, ESKF H·H_mod, Mahalanobis gate by zero
gain, closed-form small solve, Joseph-form covariance, error injection.

An MSCKF feature kind projects its update onto the left null space of
He = dh/dea (complete QR, ekf_c.c:66-77), and `augment` clones the pose
into the sliding window (ekf_sym.py:365-391).

Every function takes one filter (x (dim_x,), P (dim_err, dim_err)) and
returns new tensors, so runtime/bank.py vmaps them over a bank axis
unchanged.
"""

from __future__ import annotations

import torch

from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops.quaternion import normalize_slices
from rednose_tpu_torch.utils.chi2 import chi2_ppf


def _symmetrize(P):
  """0.5 (P + P^T) after every covariance-modifying op: f32 roundoff
  asymmetry otherwise compounds until P goes indefinite."""
  return 0.5 * (P + P.T)


def _solve(a, b):
  """Small linear solve, closed form (adjugate) for d <= 3 (ekf_sym.py:14-18;
  the reference LU-solves with Eigen, ekf_c.c:101)."""
  d = a.shape[0]
  if d == 1:
    return b / a[0, 0]
  if d == 2:
    det = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    inv = torch.stack([
        torch.stack([a[1, 1], -a[0, 1]]),
        torch.stack([-a[1, 0], a[0, 0]]),
    ]) / det
    return inv @ b
  if d == 3:
    c00 = a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]
    c01 = a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]
    c02 = a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]
    c10 = a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]
    c11 = a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]
    c12 = a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]
    c20 = a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]
    c21 = a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]
    c22 = a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    det = a[0, 0] * c00 + a[0, 1] * c01 + a[0, 2] * c02
    inv = torch.stack([
        torch.stack([c00, c10, c20]),
        torch.stack([c01, c11, c21]),
        torch.stack([c02, c12, c22]),
    ]) / det
    return inv @ b
  return torch.linalg.solve(a, b)


def predict(spec: FilterSpec, params, x, P, Q, dt, normalize: bool = True,
            F=None):
  """x <- f(x, dt), P <- F P F^T (main block) + dt*Q (ekf_c.c:8-33). F, when
  given, is spec.F(params, x, dt) computed another way (a closed form)."""
  x_new = spec.f(params, x, dt)
  if F is None:
    F = spec.F(params, x, dt)
  m = spec.dim_main_err
  if m == spec.dim_err:
    P_new = F @ P @ F.T
  else:
    Fm = F[:m, :m]
    top = torch.cat([Fm @ P[:m, :m] @ Fm.T, Fm @ P[:m, m:]], dim=1)
    bottom = torch.cat([P[m:, :m] @ Fm.T, P[m:, m:]], dim=1)
    P_new = torch.cat([top, bottom])
  P_new = _symmetrize(P_new + dt * Q)
  if normalize:
    x_new = normalize_slices(x_new, spec.quaternion_idxs)
  return x_new, P_new


def update(spec: FilterSpec, kind: int, params, x, P, z, R, ea,
           normalize: bool = True):
  """One measurement update; returns (x, P, y) (ekf_c.c:38-121)."""
  om = spec.obs[kind]
  h = om.h(params, x, ea)
  H = spec.H(kind, params, x, ea)
  y = z - h
  if om.is_feature:
    # MSCKF: project the feature-position error out (ekf_c.c:66-77) on an
    # orthonormal basis A of the left null space of He; any basis gives
    # the same update, so a complete QR replaces the reference's LU
    He = spec.He(kind, params, x, ea)                   # (dz, ea_dim)
    q_full, _ = torch.linalg.qr(He, mode="complete")
    A = q_full[:, om.ea_dim:]                           # (dz, dz - ea_dim)
    y = A.T @ y
    H = A.T @ H
    R = A.T @ R @ A
  if spec.is_eskf:
    H = H @ spec.H_mod_at(params, x)  # ekf_c.c:83-85

  S = H @ P @ H.T + R
  K = _solve(S, H @ P.T).T  # ekf_c.c:100-101
  if om.maha_test:
    # zero gain: the exact R->inf limit of the reference's 1e16 R inflation
    # (ekf_c.c:88-94). A NaN distance compares False and does not gate.
    maha_dist = y @ _solve(S, y)
    K = torch.where(maha_dist > om.maha_thresh, torch.zeros_like(K), K)
  I_KH = torch.eye(spec.dim_err, dtype=P.dtype, device=P.device) - K @ H
  dx = K @ y
  x_new = spec.err(params, x, dx)  # error injection, ekf_c.c:108-112
  P_new = _symmetrize(I_KH @ P @ I_KH.T + K @ R @ K.T)  # Joseph, ekf_c.c:115
  if normalize:
    x_new = normalize_slices(x_new, spec.quaternion_idxs)
  return x_new, P_new, y


def update_batch(spec: FilterSpec, kind: int, params, x, P, z, R, ea,
                 valid=None):
  """Apply n measurements of one kind in order (ekf_sym.py:513-522). Rows
  with valid[i] False leave (x, P) unchanged."""
  ys = []
  for i in range(z.shape[0]):
    x_new, P_new, y = update(spec, kind, params, x, P, z[i], R[i], ea[i])
    if valid is None:
      x, P = x_new, P_new
    else:
      x = torch.where(valid[i], x_new, x)
      P = torch.where(valid[i], P_new, P)
    ys.append(y)
  if ys:
    return x, P, torch.stack(ys)
  return x, P, torch.zeros((0,), dtype=x.dtype, device=x.device)


def predict_and_update_batch(spec: FilterSpec, kind: int, params, x, P, Q,
                             dt, z, R, ea, valid=None):
  """Fused predict + batched update (ekf_sym.py:484-531). Returns
  (x_pred, P_pred, x_post, P_post, y)."""
  x_pred, P_pred = predict(spec, params, x, P, Q, dt)
  x_post, P_post, y = update_batch(spec, kind, params, x_pred, P_pred, z, R,
                                   ea, valid)
  return x_pred, P_pred, x_post, P_post, y


def maha_test(spec: FilterSpec, kind: int, params, x, P, z, R, ea,
              maha_thresh: float = 0.95):
  """Standalone Mahalanobis acceptance test (ekf_sym.py:626-649): a 0-d bool
  tensor, True when the measurement is NOT an outlier."""
  om = spec.obs[kind]
  h = om.h(params, x, ea)
  H = spec.H(kind, params, x, ea)
  y = z - h
  if spec.is_eskf:
    H = H @ spec.H_mod_at(params, x)
  S = H @ P @ H.T + R
  maha_dist = y @ _solve(S, y)
  return maha_dist <= chi2_ppf(maha_thresh, om.dz)


def augment(spec: FilterSpec, x, P):
  """MSCKF augmentation: clone the current pose into the newest window
  slot and drop the oldest (ekf_sym.py:365-391)."""
  if not spec.is_msckf:
    raise ValueError(f"spec {spec.name!r} has no clone window")
  d1, d2 = spec.dim_main, spec.dim_main_err
  d3, d4 = spec.dim_augment, spec.dim_augment_err
  de = spec.dim_err
  x_new = torch.cat([x[:d1], x[d1 + d3:], x[:d3]])
  keep = torch.cat([torch.arange(d2), torch.arange(d2 + d4, de)]).to(
      P.device)
  P_reduced = P[keep][:, keep]
  eye = torch.eye(de - d4, dtype=P.dtype, device=P.device)
  # to_mult (ekf_sym.py:381-388): identity, then the first d4 rows again
  to_mult = torch.cat([eye, eye[:d4]])
  return x_new, _symmetrize(to_mult @ P_reduced @ to_mult.T)
