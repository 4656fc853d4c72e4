"""Quaternion / rotation operations as pure torch functions.

Port of rednose_tpu/ops/quaternion.py. Every function is built with
torch.stack / torch.cat (no in-place writes), so torch.func.jacfwd and
torch.func.vmap trace them unchanged.

Quaternion convention: scalar-first [w, x, y, z], Hamilton product.
"""

from __future__ import annotations

import torch


def quat_to_rot(q):
  """Rotation matrix from a (4, ...) quaternion (body->reference frame).

  Matches the reference's quat_rotate(...).T convention
  (rednose/helpers/sympy_helpers.py:101-105): `quat_to_rot(q) @ v_body`
  rotates a body-frame vector into the reference frame. Trailing dims of q
  are carried through, so the slab code uses it on (4, *b) too.
  """
  q0, q1, q2, q3 = q[0], q[1], q[2], q[3]
  return torch.stack([
      torch.stack([q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3,
                   2 * (q1 * q2 - q0 * q3),
                   2 * (q1 * q3 + q0 * q2)]),
      torch.stack([2 * (q1 * q2 + q0 * q3),
                   q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3,
                   2 * (q2 * q3 - q0 * q1)]),
      torch.stack([2 * (q1 * q3 - q0 * q2),
                   2 * (q2 * q3 + q0 * q1),
                   q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3]),
  ])


def euler_to_rot(euler):
  """Rotation matrix from (roll, pitch, yaw), R = Rz(yaw) Ry(pitch) Rx(roll).

  Mirror of euler_rotate (rednose/helpers/sympy_helpers.py:87-98).
  """
  roll, pitch, yaw = euler[0], euler[1], euler[2]
  cr, sr = torch.cos(roll), torch.sin(roll)
  cp, sp_ = torch.cos(pitch), torch.sin(pitch)
  cy, sy = torch.cos(yaw), torch.sin(yaw)
  one = torch.ones_like(roll)
  zero = torch.zeros_like(roll)
  r_roll = torch.stack([
      torch.stack([one, zero, zero]),
      torch.stack([zero, cr, -sr]),
      torch.stack([zero, sr, cr]),
  ])
  r_pitch = torch.stack([
      torch.stack([cp, zero, sp_]),
      torch.stack([zero, one, zero]),
      torch.stack([-sp_, zero, cp]),
  ])
  r_yaw = torch.stack([
      torch.stack([cy, -sy, zero]),
      torch.stack([sy, cy, zero]),
      torch.stack([zero, zero, one]),
  ])
  return r_yaw @ r_pitch @ r_roll


def euler_to_quat(euler):
  """Scalar-first quaternion from (roll, pitch, yaw); w kept non-negative.

  Mirror of euler2quat (rednose/helpers/sympy_helpers.py:30-52).
  """
  gamma, theta, psi = euler[0] / 2.0, euler[1] / 2.0, euler[2] / 2.0
  cg, sg = torch.cos(gamma), torch.sin(gamma)
  ct, st = torch.cos(theta), torch.sin(theta)
  cp, sp_ = torch.cos(psi), torch.sin(psi)
  q = torch.stack([
      cg * ct * cp + sg * st * sp_,
      sg * ct * cp - cg * st * sp_,
      cg * st * cp + sg * ct * sp_,
      cg * ct * sp_ - sg * st * cp,
  ])
  return torch.where(q[0] < 0, -q, q)


def rot_to_euler(rot):
  """(roll, pitch, yaw) from a rotation matrix (sympy_helpers.py:70-74)."""
  gamma = torch.atan2(rot[2, 1], rot[2, 2])
  theta = torch.asin(-rot[2, 0])
  psi = torch.atan2(rot[1, 0], rot[0, 0])
  return torch.stack([gamma, theta, psi])


def quat_matrix_l(p):
  """Left product matrix: quat_matrix_l(p) @ q == p * q (sympy_helpers.py:108-112)."""
  p0, p1, p2, p3 = p[0], p[1], p[2], p[3]
  return torch.stack([
      torch.stack([p0, -p1, -p2, -p3]),
      torch.stack([p1, p0, -p3, p2]),
      torch.stack([p2, p3, p0, -p1]),
      torch.stack([p3, -p2, p1, p0]),
  ])


def quat_matrix_r(p):
  """Right product matrix: quat_matrix_r(p) @ q == q * p (sympy_helpers.py:115-119)."""
  p0, p1, p2, p3 = p[0], p[1], p[2], p[3]
  return torch.stack([
      torch.stack([p0, -p1, -p2, -p3]),
      torch.stack([p1, p0, p3, -p2]),
      torch.stack([p2, -p3, p0, p1]),
      torch.stack([p3, p2, -p1, p0]),
  ])


def quat_product(p, q):
  """Hamilton product p * q of two scalar-first quaternions."""
  return quat_matrix_l(p) @ q


def skew(v):
  """Skew-symmetric cross-product matrix (mirror of `cross`, sympy_helpers.py:62-67)."""
  zero = torch.zeros_like(v[0])
  return torch.stack([
      torch.stack([zero, -v[2], v[1]]),
      torch.stack([v[2], zero, -v[0]]),
      torch.stack([-v[1], v[0], zero]),
  ])


def quat_normalize(q):
  return q / torch.linalg.vector_norm(q)


def normalize_slices(x, quaternion_idxs):
  """Renormalize each quaternion at x[idx:idx+4] for idx in quaternion_idxs
  (EKF_sym.normalize_quaternions, rednose/helpers/ekf_sym.py:405-410).
  Built by concatenation, so the input is never written."""
  for idx in quaternion_idxs:
    q = x[idx:idx + 4]
    x = torch.cat([x[:idx], q / torch.linalg.vector_norm(q), x[idx + 4:]])
  return x
