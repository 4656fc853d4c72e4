"""Mirror of `rednose.helpers.sympy_helpers`: the rotation / quaternion
helpers reference filters build their symbolic models with (imported by
e.g. live_kf.py:9: euler_rotate, quat_matrix_r, quat_rotate).

Port of rednose_tpu/helpers/sympy_helpers.py. The numeric functions
delegate to the port's torch implementations (ops/quaternion.py), numpy in
and out with the reference's batch-shape conventions; the symbolic
builders assemble sympy Matrices from the same scalar expressions
(Hamilton product, scalar first). tests/test_torch_helpers_mirror.py
lambdifies every symbolic builder against its torch twin.

The reference's `sympy_into_c` (sympy_helpers.py:122-162) is absent: there
is no C to emit; frontend/sympy_spec.py lowers symbolic models to torch.
"""

from __future__ import annotations

import numpy as np
import sympy as sp
import torch

from rednose_tpu_torch.ops import quaternion as _q

# --------------------------------------------------------------- numeric

def _np_fn(fn, a):
  return fn(torch.as_tensor(np.asarray(a, dtype=np.float64))).numpy()


def _batched(fn, arr, in_rank):
  """Apply a single-item torch function over an optional leading batch
  dim, numpy in and out (the reference helpers are numpy in, numpy out)."""
  arr = np.asarray(arr, dtype=np.float64)
  if arr.ndim == in_rank:
    return _np_fn(fn, arr)
  return np.stack([_np_fn(fn, a) for a in arr])


def quat2rot(quats):
  """(4,) -> (3, 3) or (N, 4) -> (N, 3, 3) rotation matrices."""
  return _batched(_q.quat_to_rot, quats, 1)


rotations_from_quats = quat2rot


def euler2quat(eulers):
  """(3,) -> (4,) or (N, 3) -> (N, 4) scalar-first quats, w >= 0."""
  return _batched(_q.euler_to_quat, eulers, 1)


def euler2rot(eulers):
  return quat2rot(euler2quat(eulers))


def rot_matrix(roll, pitch, yaw):
  """Numeric R = Rz(yaw) Ry(pitch) Rx(roll) from scalar angles."""
  return _np_fn(_q.euler_to_rot, [roll, pitch, yaw])


# -------------------------------------------------------------- symbolic

def cross(x):
  """Skew-symmetric cross-product matrix of a symbolic 3-vector."""
  return sp.Matrix([[0, -x[2], x[1]],
                    [x[2], 0, -x[0]],
                    [-x[1], x[0], 0]])


def rot_to_euler(R):
  """(roll, pitch, yaw) from a symbolic rotation matrix (ZYX convention)."""
  gamma = sp.atan2(R[2, 1], R[2, 2])
  theta = sp.asin(-R[2, 0])
  psi = sp.atan2(R[1, 0], R[0, 0])
  return sp.Matrix([gamma, theta, psi])


def _axis_rot(angle, axis):
  """Elementary rotation about one coordinate axis: the rotated plane is
  the cyclic pair of the fixed axis."""
  c, s = sp.cos(angle), sp.sin(angle)
  i, j = [(1, 2), (2, 0), (0, 1)][axis]
  M = sp.eye(3)
  M[i, i], M[i, j] = c, -s
  M[j, i], M[j, j] = s, c
  return M


def euler_rotate(roll, pitch, yaw):
  """Symbolic R = Rz(yaw) Ry(pitch) Rx(roll)."""
  return _axis_rot(yaw, 2) * _axis_rot(pitch, 1) * _axis_rot(roll, 0)


def quat_rotate(q0, q1, q2, q3):
  """Symbolic body->reference rotation matrix from quaternion components
  (the reference's quat_rotate convention: equals ops/quaternion.quat_to_rot,
  see quat_to_rot's docstring on the transpose bookkeeping).

  Derived from the product-matrix identity rather than spelled out:
  v' = q (x) v (x) q*  =>  R = (L(q) R(q*))[1:, 1:]."""
  q = (q0, q1, q2, q3)
  conj = (q0, -q1, -q2, -q3)
  M = sp.expand(quat_matrix_l(q) * quat_matrix_r(conj))
  return M[1:, 1:]


def quat_matrix_l(p):
  """Left Hamilton product matrix: quat_matrix_l(p) @ q == p (x) q."""
  return sp.Matrix([[p[0], -p[1], -p[2], -p[3]],
                    [p[1], p[0], -p[3], p[2]],
                    [p[2], p[3], p[0], -p[1]],
                    [p[3], -p[2], p[1], p[0]]])


def quat_matrix_r(p):
  """Right Hamilton product matrix: quat_matrix_r(p) @ q == q (x) p."""
  return sp.Matrix([[p[0], -p[1], -p[2], -p[3]],
                    [p[1], p[0], p[3], -p[2]],
                    [p[2], -p[3], p[0], p[1]],
                    [p[3], p[2], -p[1], p[0]]])
