"""The port's migration surface (rednose_tpu_torch/compat.py,
frontend/sympy_spec.py), mirroring tests/test_compat_sympy.py on the CPU in
float64: the migrated kinematic filter reproduces the reference's golden
values (7 decimals), rewind / maha on the compat engine, the sympy live
ESKF against the port's native live model (f, err to 1e-10; F, H to 1e-10;
H_mod exact to 1e-12) and engine for engine over a trajectory with a late
observation (rtol 1e-8), global_vars reaching h and extra routines
(ParamsRoutine), extra args on a non-feature kind, and the MSCKF compat
engine against the native one (rtol 1e-9). Every F and H the front end
builds is held entry for entry against the JAX front end's on the same
sympy input (atol 1e-12), nonzero where JAX's is nonzero: sympy's torch
matrix printer builds torch.tensor(...), through which jacfwd gives zeros."""

import jax.numpy as jnp
import numpy as np
import pytest
import sympy as sp
import torch

from rednose_tpu import compat as jcompat
from rednose_tpu_torch import compat
from rednose_tpu_torch.models.kalman_filter import KalmanFilter
from rednose_tpu_torch.models.live import LiveKalman
from rednose_tpu_torch.runtime.driver import FilterEngine
from test_compat_sympy import _live_sympy_pieces
from torch_parity import np_, t64


class _Kind:
  POSITION = 1


class SympyKinematic(KalmanFilter):
  """The reference's kinematic example in its own build style
  (examples/kinematic_kf.py:36-76): sympy dynamics -> gen_code -> EKF_sym,
  with only the import changed."""

  name = 'kinematic_compat'
  initial_x = np.array([0.5, 0.0])
  initial_P_diag = np.array([1.0, 1.0])
  Q = np.diag([0.1**2, 2.0**2])
  obs_noise = {_Kind.POSITION: np.atleast_2d(0.1**2)}

  @staticmethod
  def generate_code(generated_dir):
    x_sym = sp.MatrixSymbol('x', 2, 1)
    xm = sp.Matrix(x_sym)
    dt = sp.Symbol('dt')
    f_sym = sp.Matrix([xm[0, 0] + dt * xm[1, 0], xm[1, 0]])
    obs_eqs = [[sp.Matrix([xm[0, 0]]), _Kind.POSITION, None]]
    compat.gen_code(generated_dir, SympyKinematic.name, f_sym, dt, x_sym,
                    obs_eqs, 2, 2)

  def __init__(self, generated_dir=None):
    self.generate_code(generated_dir)
    self.filter = compat.EKF_sym_pyx(
        generated_dir, self.name, self.Q, self.initial_x,
        np.diag(self.initial_P_diag), 2, 2, device="cpu")


def _state(rng, n=23):
  x = np.asarray(LiveKalman.initial_x, np.float64).copy()
  x *= 1.0 + 0.05 * rng.randn(n)
  x += 0.05 * rng.randn(n)
  x[3:7] /= np.linalg.norm(x[3:7])
  return x


def _both(name, *args, **kw):
  """The same gen_code input through the port's and JAX's front ends."""
  return (compat.gen_code(None, name, *args, **kw),
          jcompat.gen_code(None, name, *args, **kw))


def _jacobians_match(ours, ref, x, dt, eas=None):
  """F and every kind's H of two specs at x: equal to 1e-12 and nonzero
  exactly where JAX's are."""
  pairs = [(ours.F({}, t64(x), t64(dt)), ref.F({}, jnp.asarray(x), dt))]
  for kind, om in ref.obs.items():
    ea = (eas or {}).get(kind, np.zeros(max(om.ea_len, 1)))
    pairs.append((ours.H(kind, {}, t64(x), t64(ea)),
                  ref.H(kind, {}, jnp.asarray(x), jnp.asarray(ea))))
  for a, b in pairs:
    a, b = np_(a), np.asarray(b)
    np.testing.assert_array_equal(a != 0, b != 0)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
  assert all(np.count_nonzero(np.asarray(b)) for _, b in pairs)


def test_compat_kinematic_reproduces_reference_goldens():
  """The migration path hits the reference's published golden values
  (examples/test_kinematic_kf.py:52-55) to 7 decimals."""
  np.random.seed(0)
  kf = SympyKinematic()
  ts = np.arange(0, 5, step=0.01)
  x = 0.0
  for t, v in zip(ts, np.sin(ts * 5)):
    kf.predict_and_observe(t, _Kind.POSITION, [np.random.normal(x, 0.1)])
    x += v * 0.01
  state, std = kf.x, np.sqrt(kf.P)
  np.testing.assert_almost_equal(state[0], -0.010866289677966417)
  np.testing.assert_almost_equal(std[0, 0], 0.04477103863330089)
  np.testing.assert_almost_equal(state[1], -0.8553720537261753)
  np.testing.assert_almost_equal(std[1, 1], 0.6695762270974388)


def test_compat_rewind_maha_and_smoother_surface():
  np.random.seed(2)
  kf = SympyKinematic()
  estimates = [kf.predict_and_observe(t, _Kind.POSITION,
                                      [np.random.normal(0, 0.1)])
               for t in np.arange(0, 1.0, 0.01)]
  assert kf.predict_and_observe(0.5, _Kind.POSITION, [0.1]) is not None
  assert kf.t == 0.99
  assert kf.predict_and_observe(-5.0, _Kind.POSITION, [0.0]) is None
  ok = kf.filter.maha_test(kf.x, kf.P, _Kind.POSITION, [0.0],
                           kf.get_R(_Kind.POSITION, 1)[0])
  assert ok in (True, False)
  smoothed = kf.filter.rts_smooth(estimates)
  assert len(smoothed) == len(estimates)
  assert np.isfinite(np.stack([s[0] for s in smoothed])).all()
  with pytest.raises(KeyError, match="no generated filter"):
    compat.EKF_sym(None, "never_generated", np.eye(2), np.zeros(2),
                   np.eye(2), 2, 2, device="cpu")
  with pytest.raises(ValueError, match="dimensions"):
    compat.EKF_sym(None, SympyKinematic.name, np.eye(2), np.zeros(2),
                   np.eye(2), 3, 2, device="cpu")


def test_kinematic_and_live_jacobians_match_jax():
  """F and H of the front end, nonzero-for-nonzero and to 1e-12 against
  JAX's, for the kinematic filter and the sympy live ESKF."""
  x_sym = sp.MatrixSymbol('x', 2, 1)
  xm = sp.Matrix(x_sym)
  dt = sp.Symbol('dt')
  ours, ref = _both('kin_jac', sp.Matrix([xm[0, 0] + dt * xm[1, 0],
                                          xm[1, 0]]), dt, x_sym,
                    [[sp.Matrix([xm[0, 0]]), 1, None]], 2, 2)
  _jacobians_match(ours, ref, np.array([0.3, -1.2]), 0.01)

  f_sym, dt_sym, xs, obs_eqs, eskf = _live_sympy_pieces()
  ours, ref = _both('live_jac', f_sym, dt_sym, xs, obs_eqs, 23, 22,
                    eskf_params=eskf, quaternion_idxs=[3])
  rng = np.random.RandomState(0)
  for _ in range(2):
    _jacobians_match(ours, ref, _state(rng), 0.037)


def test_compat_eskf_matches_native_live_model():
  """The sympy live ESKF against the port's native live spec on f, F,
  err, inv_err, H_mod and h / H at random states."""
  f_sym, dt_sym, xs, obs_eqs, eskf = _live_sympy_pieces()
  sym = compat.gen_code(None, 'live_compat', f_sym, dt_sym, xs, obs_eqs, 23,
                        22, eskf_params=eskf, quaternion_idxs=[3])
  native = LiveKalman.build_spec()
  rng = np.random.RandomState(0)
  close = lambda a, b, **kw: np.testing.assert_allclose(  # noqa: E731
      np_(a), np_(b), **kw)
  for _ in range(3):
    x = t64(_state(rng))
    dt = t64(0.037)
    close(sym.f({}, x, dt), native.f({}, x, dt), rtol=1e-10, atol=1e-10)
    close(sym.F({}, x, dt), native.F({}, x, dt), rtol=1e-8, atol=1e-10)
    close(sym.H_mod_at({}, x), native.H_mod_at({}, x), rtol=1e-12, atol=0)
    dx = t64(0.01 * rng.randn(22))
    close(sym.err({}, x, dx), native.err({}, x, dx), rtol=1e-10, atol=1e-12)
    tru = native.err({}, x, dx)
    close(sym.inv_err({}, x, tru), native.inv_err({}, x, tru), rtol=1e-9,
          atol=1e-12)
    ea = t64(np.zeros(1))
    close(sym.obs[12].h({}, x, ea), native.obs[12].h({}, x, ea), rtol=1e-12)
    close(sym.H(12, {}, x, ea), native.H(12, {}, x, ea), rtol=1e-10,
          atol=1e-12)
  # the lowered functions follow the state's dtype
  x32 = x.float()
  assert sym.f({}, x32, 0.01).dtype == torch.float32
  assert sym.F({}, x32, torch.tensor(0.01)).dtype == torch.float32


def test_compat_eskf_trajectory_matches_native_engine():
  """Engine for engine (examples/test_compare.py:115-120): the sympy live
  spec and the native one through two FilterEngines over the same noisy
  stream with an out-of-order observation."""
  f_sym, dt_sym, xs, obs_eqs, eskf = _live_sympy_pieces()
  sym = compat.gen_code(None, 'live_compat_traj', f_sym, dt_sym, xs,
                        obs_eqs, 23, 22, eskf_params=eskf,
                        quaternion_idxs=[3])
  engines = [FilterEngine(s, LiveKalman.Q, LiveKalman.initial_x,
                          np.diag(LiveKalman.initial_P_diag), device="cpu")
             for s in (sym, LiveKalman.build_spec())]
  rng = np.random.RandomState(7)
  R = np.diag([25.0] * 3)
  t = 0.0
  for i in range(40):
    t += 0.01
    z = LiveKalman.initial_x[0:3] + 3.0 * rng.randn(3)
    for eng in engines:
      eng.predict_and_update_batch(t, 12, [z], R[None])
    if i == 30:
      z_late = LiveKalman.initial_x[0:3] + 3.0 * rng.randn(3)
      for eng in engines:
        assert eng.predict_and_update_batch(t - 0.15, 12, [z_late],
                                            R[None]) is not None
    np.testing.assert_allclose(engines[0].state(), engines[1].state(),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(engines[0].covs(), engines[1].covs(),
                               rtol=1e-7, atol=1e-9)


def test_global_vars_and_extra_routines():
  """global_vars are runtime params (the reference's set_<name> C globals,
  ekf_sym.py:129-132); extra routines are ParamsRoutines that read the
  engine's params at each call, also when fetched before set_global."""
  lever = sp.Symbol('lever_arm')
  x_sym = sp.MatrixSymbol('x', 2, 1)
  xm = sp.Matrix(x_sym)
  dt = sp.Symbol('dt')
  f_sym = sp.Matrix([xm[0, 0] + dt * xm[1, 0], xm[1, 0]])
  obs_eqs = [[sp.Matrix([xm[0, 0] + lever]), 1, None]]
  extra = [('double_vel', sp.Matrix([2 * xm[1, 0]]), [x_sym]),
           ('vel_plus_lever', sp.Matrix([xm[1, 0] + lever]), [x_sym])]
  compat.gen_code(None, 'glob_compat', f_sym, dt, x_sym, obs_eqs, 2, 2,
                  global_vars=[lever], extra_routines=extra)
  eng = compat.EKF_sym(None, 'glob_compat', np.eye(2) * 1e-4,
                       np.array([1.0, 0.0]), np.eye(2), 2, 2, device="cpu")
  x = t64([1.0, 0.0])
  np.testing.assert_allclose(np_(eng.spec.obs[1].h(eng.params, x, None)),
                             [1.0])
  live = eng.get_extra_routine('vel_plus_lever')
  np.testing.assert_allclose(np_(live(t64([0.0, 3.0]))), [3.0])
  eng.set_global('lever_arm', 0.25)
  np.testing.assert_allclose(np_(eng.spec.obs[1].h(eng.params, x, None)),
                             [1.25])
  np.testing.assert_allclose(np_(live(np.array([0.0, 3.0]))), [3.25])
  assert eng.predict_and_update_batch(0.0, 1, [[1.25]],
                                      np.atleast_3d([1e-6])) is not None
  np.testing.assert_allclose(eng.state()[0], 1.0, atol=1e-3)
  fn = eng.get_extra_routine('double_vel')
  np.testing.assert_allclose(np_(fn(t64([0.0, 3.0]))), [6.0])
  with pytest.raises(KeyError, match="no extra routine"):
    eng.get_extra_routine('missing')


def test_non_feature_kind_with_extra_args():
  """The loc_kf pseudorange family: extra args (sat_pos) on a kind that is
  not a feature kind (ekf_sym.py:84-89); ea_len sizes the placeholders and
  the engine threads the real extra args through the update. Its H is
  held against JAX's."""
  PSEUDORANGE = 6
  x_sym = sp.MatrixSymbol('x', 3, 1)
  xm = sp.Matrix(x_sym)
  sat = sp.MatrixSymbol('sat_pos', 3, 1)
  dt = sp.Symbol('dt')
  d = xm - sp.Matrix(sat)
  h_pr = sp.Matrix([sp.sqrt(d[0, 0]**2 + d[1, 0]**2 + d[2, 0]**2)])
  obs_eqs = [[h_pr, PSEUDORANGE, sat],
             [sp.Matrix([xm[0, 0], xm[1, 0], xm[2, 0]]), 1, None]]
  ours, ref = _both('pr_compat', sp.Matrix([xm[0, 0], xm[1, 0], xm[2, 0]]),
                    dt, x_sym, obs_eqs, 3, 3)
  sats = np.array([[100.0, 0.0, 0.0], [0.0, 100.0, 0.0], [0.0, 0.0, 100.0]])
  x0 = np.array([1.0, 2.0, 0.5])
  for kind in (PSEUDORANGE, 1):
    a = np_(ours.H(kind, {}, t64(x0), t64(sats[0])))
    b = np.asarray(ref.H(kind, {}, jnp.asarray(x0), jnp.asarray(sats[0])))
    np.testing.assert_array_equal(a != 0, b != 0)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
  eng = compat.EKF_sym(None, 'pr_compat', np.eye(3) * 1e-4, np.zeros(3),
                       np.eye(3) * 100.0, 3, 3, device="cpu")
  om = eng.spec.obs[PSEUDORANGE]
  assert om.ea_len == 3 and om.ea_dim == 0 and not om.is_feature
  truth = np.array([3.0, 4.0, 0.0])
  for it in range(25):
    for s in sats:
      assert eng.predict_and_update_batch(
          0.01 * (it + 1), PSEUDORANGE, [[np.linalg.norm(truth - s)]],
          np.atleast_3d([1e-4]), extra_args=[s]) is not None
  np.testing.assert_allclose(eng.state(), truth, atol=1e-2)


def test_compat_msckf_matches_native_engine():
  """msckf_params and a feature kind (ea_sym, He projection) through the
  compat path: the sympy MSCKF VO model against the port's native one
  engine for engine, through position updates with augmentation and a
  feature update; its F and H against JAX's front end."""
  from rednose_tpu_torch.models import msckf_vo as mv

  N, DM, DA, DIM = mv.N_AUGMENT, mv.DIM_MAIN, mv.DIM_AUG, mv.DIM_X
  xs = sp.symbols('mx0:%d' % DIM)
  x = sp.Matrix(xs)
  dt = sp.Symbol('dt')
  f_sym = x.copy()
  f_sym[0:3, 0] = x[0:3, 0] + dt * x[3:6, 0]
  ea = sp.MatrixSymbol('ea', 3, 1)
  rows = []
  for a in range(N):
    dd = sp.Matrix(ea) - x[DM + DA * a: DM + DA * (a + 1), 0]
    rows += [dd[0] / dd[2], dd[1] / dd[2]]
  POS, FEAT = mv.ObservationKind.POSITION, mv.ObservationKind.MSCKF_TEST
  obs_eqs = [[sp.Matrix(x[0:3, 0]), POS, None], [sp.Matrix(rows), FEAT, ea]]
  kw = dict(msckf_params=(DM, DA, DM, DA, N, [FEAT]),
            maha_test_kinds=[FEAT])
  ours, ref = _both('msckf_compat', f_sym, dt, xs, obs_eqs, DIM, DIM, **kw)
  assert (ours.dim_main, ours.dim_augment, ours.n_augment) == (DM, DA, N)
  assert ours.obs[FEAT].ea_dim == 3 and ours.obs[FEAT].maha_test
  model = mv.MSCKFVisualOdometry
  x0 = np.asarray(model.initial_x, np.float64) + 0.1 * np.arange(DIM) / DIM
  feat = np.array([0.5, -0.3, 8.0])
  _jacobians_match(ours, ref, x0, 0.1, eas={FEAT: feat})

  P0 = np.diag(model.initial_P_diag)
  eng_sym = compat.EKF_sym(None, 'msckf_compat', model.Q, model.initial_x,
                           P0, DM, DM, N=N, dim_augment=DA,
                           dim_augment_err=DA, device="cpu")
  eng_nat = FilterEngine(model.build_spec(), model.Q, model.initial_x, P0,
                         device="cpu")
  rng = np.random.RandomState(3)
  t = 0.0
  for _ in range(6):
    t += 0.1
    z = rng.randn(3) * 0.1
    for eng in (eng_sym, eng_nat):
      eng.predict_and_update_batch(t, POS, [z], model.obs_noise[POS][None],
                                   augment=True)
  zf = []
  x_now = eng_nat.state()
  for a in range(N):
    dd = feat - x_now[DM + DA * a: DM + DA * (a + 1)]
    zf += [dd[0] / dd[2], dd[1] / dd[2]]
  zf = np.asarray(zf) + 1e-3 * rng.randn(2 * N)
  for eng in (eng_sym, eng_nat):
    eng.predict_and_update_batch(t + 0.1, FEAT, [zf],
                                 model.obs_noise[FEAT][None],
                                 extra_args=[feat])
  np.testing.assert_allclose(eng_sym.state(), eng_nat.state(), rtol=1e-9,
                             atol=1e-12)
  np.testing.assert_allclose(eng_sym.covs(), eng_nat.covs(), rtol=1e-8,
                             atol=1e-12)
