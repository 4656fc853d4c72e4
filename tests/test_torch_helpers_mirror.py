"""The port's `rednose.helpers` mirror (rednose_tpu_torch/helpers),
mirroring tests/test_helpers_mirror.py: the reference's import lines work
after the rename `rednose.` -> `rednose_tpu_torch.`; the numeric helpers
equal the port's torch quaternion ops and the JAX package's helpers
(rtol 1e-12, euler2rot 1e-10); every symbolic builder, lambdified, equals
its torch twin (rtol 1e-12); and a reference-style quaternion ESKF built
with the helpers through helpers.ekf_sym.gen_code converges, with
Jacobians nonzero where the JAX front end's are."""

import jax.numpy as jnp
import numpy as np
import sympy as sp
import torch

from rednose_tpu.helpers import sympy_helpers as jsh
from rednose_tpu_torch.helpers import KalmanError
from rednose_tpu_torch.helpers import sympy_helpers as sh
from rednose_tpu_torch.ops import quaternion as q_ops
from torch_parity import np_, t64


def test_import_surface():
  from rednose_tpu_torch.compat import EKF_sym_pyx as compat_pyx
  from rednose_tpu_torch.helpers.chi2_lookup import chi2_ppf
  from rednose_tpu_torch.helpers.ekf_sym import EKF_sym, gen_code
  from rednose_tpu_torch.helpers.ekf_sym_pyx import EKF_sym_pyx
  from rednose_tpu_torch.helpers.kalmanfilter import KalmanFilter
  from rednose_tpu_torch.helpers.sympy_helpers import (
      euler_rotate, quat_matrix_r, quat_rotate)
  from rednose_tpu_torch.models.kalman_filter import KalmanFilter as KF
  from rednose_tpu_torch.runtime.driver import FilterEngine

  assert issubclass(KalmanError, Exception)
  assert EKF_sym_pyx is EKF_sym is compat_pyx
  assert issubclass(EKF_sym, FilterEngine) and KalmanFilter is KF
  assert abs(chi2_ppf(0.95, 1) - 3.8414588) < 1e-5
  assert all(callable(f) for f in (gen_code, euler_rotate, quat_matrix_r,
                                   quat_rotate))


def _rand_quats(rng, n):
  q = rng.randn(n, 4)
  return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_numeric_helpers_match_torch_and_jax():
  rng = np.random.RandomState(0)
  quats = _rand_quats(rng, 5)
  R_b = sh.quat2rot(quats)
  assert R_b.shape == (5, 3, 3) and isinstance(R_b, np.ndarray)
  for i in range(5):
    np.testing.assert_allclose(R_b[i], np_(q_ops.quat_to_rot(t64(quats[i]))),
                               rtol=1e-12)
  np.testing.assert_allclose(sh.quat2rot(quats[0]), R_b[0], rtol=1e-12)
  np.testing.assert_allclose(R_b, jsh.quat2rot(quats), rtol=1e-12)
  assert sh.rotations_from_quats is sh.quat2rot

  eulers = 0.5 * rng.randn(4, 3)
  Q_b = sh.euler2quat(eulers)
  assert Q_b.shape == (4, 4) and (Q_b[:, 0] >= 0).all()
  np.testing.assert_allclose(Q_b, jsh.euler2quat(eulers), rtol=1e-12)
  np.testing.assert_allclose(sh.euler2rot(eulers[0]),
                             np_(q_ops.euler_to_rot(t64(eulers[0]))),
                             rtol=1e-10, atol=1e-12)
  np.testing.assert_allclose(sh.rot_matrix(0.1, -0.2, 0.3),
                             jsh.rot_matrix(0.1, -0.2, 0.3), rtol=1e-12)


def test_symbolic_builders_match_torch():
  """Every sympy builder, lambdified, equals its ops/quaternion twin."""
  rng = np.random.RandomState(1)
  qs, v, e = sp.symbols('q0:4'), sp.symbols('v0:3'), sp.symbols('e0:3')
  lam = {name: sp.lambdify(args, expr, 'numpy') for name, args, expr in (
      ("rot", qs, sh.quat_rotate(*qs)), ("cross", v, sh.cross(v)),
      ("euler", e, sh.euler_rotate(*e)), ("ml", qs, sh.quat_matrix_l(qs)),
      ("mr", qs, sh.quat_matrix_r(qs)))}
  for _ in range(3):
    quat, vec, eul = _rand_quats(rng, 1)[0], rng.randn(3), 0.5 * rng.randn(3)
    for name, arg, twin in (("rot", quat, q_ops.quat_to_rot),
                            ("cross", vec, q_ops.skew),
                            ("ml", quat, q_ops.quat_matrix_l),
                            ("mr", quat, q_ops.quat_matrix_r)):
      np.testing.assert_allclose(lam[name](*arg), np_(twin(t64(arg))),
                                 rtol=1e-12)
    np.testing.assert_allclose(lam["euler"](*eul),
                               np_(q_ops.euler_to_rot(t64(eul))),
                               rtol=1e-10, atol=1e-12)
  eul = np.array([0.3, -0.4, 0.5])
  R = sp.Matrix(np_(q_ops.euler_to_rot(t64(eul))))
  rec = np.array(sh.rot_to_euler(R), dtype=np.float64).ravel()
  np.testing.assert_allclose(rec, eul, rtol=1e-8)


def test_reference_style_eskf_through_helper_imports():
  """A miniature quaternion ESKF written the reference way: model from
  helpers.sympy_helpers, gen_code from helpers.ekf_sym, EKF_sym_pyx from
  helpers.ekf_sym_pyx; it converges on an attitude observation stream,
  and its F and H are nonzero where the JAX front end's are."""
  from rednose_tpu import compat as jcompat
  from rednose_tpu_torch.helpers.ekf_sym import gen_code
  from rednose_tpu_torch.helpers.ekf_sym_pyx import EKF_sym_pyx
  from rednose_tpu_torch.helpers.sympy_helpers import (
      euler_rotate, quat_matrix_r)

  xs = sp.symbols('ax0:4')
  dt = sp.Symbol('dt')
  dxs = sp.symbols('adx0:3')
  nom, delta, true = (sp.symbols('anom0:4'), sp.symbols('adelta0:3'),
                      sp.symbols('atrue0:4'))
  delta_quat = sp.Matrix([sp.Integer(1), delta[0] / 2, delta[1] / 2,
                          delta[2] / 2])
  err_expr = quat_matrix_r(nom) * delta_quat
  inv_expr = 2 * (quat_matrix_r(nom).T * sp.Matrix(true))[1:, 0]
  H_mod = sp.Rational(1, 2) * quat_matrix_r(xs)[:, 1:]
  # a small rotation of the error dynamics, so F is not the identity
  f_err_sym = euler_rotate(0, 0, dt) * sp.Matrix(dxs)
  Rt = sh.quat_rotate(*xs).T
  h_sym = sp.Matrix.vstack(Rt * sp.Matrix([0, 0, 1]),
                           Rt * sp.Matrix([1, 0, 0]))
  args = ('mini_eskf', sp.Matrix(xs), dt, xs, [[h_sym, 1, None]], 4, 3)
  kw = dict(eskf_params=([err_expr, nom, delta],
                         [sp.Matrix(inv_expr), nom, true], H_mod, f_err_sym,
                         dxs), quaternion_idxs=[0])
  ours = gen_code(None, *args, **kw)
  ref = jcompat.gen_code(None, *args, **kw)
  x = np.array([0.9, 0.1, -0.2, 0.3])
  x /= np.linalg.norm(x)
  for a, b in ((ours.F({}, t64(x), t64(0.01)), ref.F({}, jnp.asarray(x),
                                                     0.01)),
               (ours.H(1, {}, t64(x), t64([0.0])),
                ref.H(1, {}, jnp.asarray(x), jnp.zeros(1)))):
    np.testing.assert_array_equal(np_(a) != 0, np.asarray(b) != 0)
    np.testing.assert_allclose(np_(a), np.asarray(b), atol=1e-12)

  q_true = np_(q_ops.euler_to_quat(t64([0.2, -0.1, 0.3])))
  RT = np_(q_ops.quat_to_rot(t64(q_true))).T
  z_true = np.concatenate([RT @ np.array([0.0, 0.0, 1.0]),
                           RT @ np.array([1.0, 0.0, 0.0])])
  kf = EKF_sym_pyx(None, 'mini_eskf', np.eye(3) * 1e-4,
                   np.array([1.0, 0.0, 0.0, 0.0]), np.eye(3) * 0.5, 4, 3,
                   device="cpu")
  rng = np.random.RandomState(0)
  for i in range(60):
    kf.predict_and_update_batch(0.01 * (i + 1), 1,
                                [z_true + 0.01 * rng.randn(6)],
                                np.eye(6)[None] * 1e-4)
  dot = abs(float(np.dot(kf.state(), q_true)))
  assert dot > 0.9999, (kf.state(), q_true, dot)
  assert kf.x.dtype == torch.float64
