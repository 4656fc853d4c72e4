"""Port parity: chi2, quaternion ops, spec Jacobians and the step oracle
(rednose_tpu_torch vs rednose_tpu, float64 on the CPU, rtol 1e-10 unless
stated)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.core import step as jstep
from rednose_tpu.models.kinematic import build_kinematic_spec as j_kin_spec
from rednose_tpu.models.live import LiveKalman as JLive
from rednose_tpu.models.live import build_live_spec as j_live_spec
from rednose_tpu.ops import quaternion as jq
from rednose_tpu.utils import chi2 as jchi2
from rednose_tpu_torch.core import step as tstep
from rednose_tpu_torch.models.kinematic import KinematicKalman
from rednose_tpu_torch.models.kinematic import ObservationKind as KK
from rednose_tpu_torch.models.kinematic import build_kinematic_spec as t_kin_spec
from rednose_tpu_torch.models.live import build_live_spec as t_live_spec
from rednose_tpu_torch.ops import quaternion as tq
from rednose_tpu_torch.utils import chi2 as tchi2
from torch_parity import np_, t64

LIVE_KINDS = sorted(j_live_spec().obs)
RTOL = 1e-10


def _live_state(rng):
  x = rng.randn(23)
  x[0:3] = JLive.initial_x[0:3] + 10.0 * rng.randn(3)
  x[3:7] /= np.linalg.norm(x[3:7])
  A = 0.1 * rng.randn(22, 22)
  return x, A @ A.T + 0.5 * np.eye(22)


def test_chi2_matches():
  for p in (0.01, 0.5, 0.95, 0.99):
    for dim in (1, 2, 3, 5, 15):
      assert tchi2.chi2_ppf(p, dim) == jchi2.chi2_ppf(p, dim)
  np.testing.assert_array_equal(tchi2.gen_chi2_ppf_lookup(8),
                                jchi2.gen_chi2_ppf_lookup(8))


@pytest.mark.parametrize("name", [
    "quat_to_rot", "euler_to_rot", "euler_to_quat", "rot_to_euler",
    "quat_matrix_l", "quat_matrix_r", "skew", "quat_normalize"])
def test_quaternion_ops(name):
  rng = np.random.RandomState(0)
  for _ in range(4):
    v = rng.randn(3 if name in ("euler_to_rot", "euler_to_quat", "skew")
                  else 4)
    if name == "rot_to_euler":
      v = np.asarray(jq.euler_to_rot(jnp.asarray(rng.randn(3))))
    a = np.asarray(getattr(jq, name)(jnp.asarray(v)))
    b = np_(getattr(tq, name)(t64(v)))
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-14)
  p, q = rng.randn(4), rng.randn(4)
  np.testing.assert_allclose(
      np_(tq.quat_product(t64(p), t64(q))),
      np.asarray(jq.quat_product(jnp.asarray(p), jnp.asarray(q))), rtol=RTOL)
  x = rng.randn(23)
  np.testing.assert_allclose(
      np_(tq.normalize_slices(t64(x), (3,))),
      np.asarray(jq.normalize_slices(jnp.asarray(x), (3,))), rtol=RTOL)


def test_spec_jacobians_kinematic():
  js, ts = j_kin_spec(), t_kin_spec()
  x = np.array([0.3, -1.2])
  np.testing.assert_allclose(np_(ts.F({}, t64(x), t64(0.05))),
                             np.asarray(js.F({}, jnp.asarray(x), 0.05)),
                             rtol=RTOL)
  np.testing.assert_allclose(
      np_(ts.H(KK.POSITION, {}, t64(x), t64(np.zeros(1)))),
      np.asarray(js.H(KK.POSITION, {}, jnp.asarray(x), jnp.zeros(1))),
      rtol=RTOL)
  np.testing.assert_array_equal(np_(ts.H_mod_at({}, t64(x))), np.eye(2))


def test_spec_feature_jacobian_He():
  """He = dh/dea on a small spec whose h reads its extra args."""
  from rednose_tpu.core.spec import FilterSpec as JSpec
  from rednose_tpu.core.spec import ObservationModel as JObs
  from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel

  def h(params, x, ea):
    return x[:2] * ea[0] + ea[1:] ** 2

  def f(params, x, dt):
    return x

  js = JSpec("fe", 3, 3, f, {7: JObs(7, h, 2, ea_dim=2, ea_len=3)})
  ts = FilterSpec("fe", 3, 3, f, {7: ObservationModel(7, h, 2, ea_dim=2,
                                                      ea_len=3)})
  x, ea = np.array([0.5, -1.0, 2.0]), np.array([1.5, 0.3, -0.7])
  np.testing.assert_allclose(
      np_(ts.He(7, {}, t64(x), t64(ea))),
      np.asarray(js.He(7, {}, jnp.asarray(x), jnp.asarray(ea))), rtol=RTOL)
  assert ts.obs[7].is_feature


@pytest.mark.parametrize("kind", LIVE_KINDS)
def test_spec_jacobians_live(kind):
  js, ts = j_live_spec(), t_live_spec()
  rng = np.random.RandomState(kind)
  x, _ = _live_state(rng)
  xj, xt, ea = jnp.asarray(x), t64(x), np.zeros(1)
  H_ref = np.asarray(js.H(kind, {}, xj, jnp.asarray(ea)))
  np.testing.assert_allclose(np_(ts.H(kind, {}, xt, t64(ea))), H_ref,
                             rtol=RTOL, atol=1e-12 * np.abs(H_ref).max())
  np.testing.assert_allclose(np_(ts.obs[kind].h({}, xt, t64(ea))),
                             np.asarray(js.obs[kind].h({}, xj, ea)),
                             rtol=RTOL)
  np.testing.assert_allclose(np_(ts.H_mod_at({}, xt)),
                             np.asarray(js.H_mod_at({}, xj)), rtol=RTOL)
  np.testing.assert_allclose(np_(ts.F({}, xt, t64(0.013))),
                             np.asarray(js.F({}, xj, 0.013)), rtol=RTOL,
                             atol=1e-14)
  assert ts.obs[kind].maha_thresh == js.obs[kind].maha_thresh


@pytest.mark.parametrize("gate", [False, True])
def test_step_live(gate):
  js, ts = j_live_spec(), t_live_spec()
  if gate:  # gate every kind; half the measurements are far outliers
    js = dataclasses.replace(js, obs={k: dataclasses.replace(
        o, maha_test=True) for k, o in js.obs.items()})
    ts = dataclasses.replace(ts, obs={k: dataclasses.replace(
        o, maha_test=True) for k, o in ts.obs.items()})
  rng = np.random.RandomState(1)
  Q = JLive.Q
  for i, kind in enumerate(LIVE_KINDS):
    x, P = _live_state(rng)
    xp_j, Pp_j = jstep.predict(js, {}, jnp.asarray(x), jnp.asarray(P),
                               jnp.asarray(Q), jnp.asarray(0.01))
    xp_t, Pp_t = tstep.predict(ts, {}, t64(x), t64(P), t64(Q), t64(0.01))
    np.testing.assert_allclose(np_(xp_t), np.asarray(xp_j), rtol=RTOL)
    np.testing.assert_allclose(np_(Pp_t), np.asarray(Pp_j), rtol=RTOL,
                               atol=1e-12)
    dz = js.obs[kind].dz
    h = np.asarray(js.obs[kind].h({}, xp_j, jnp.zeros(1)))
    z = h + (0.01 if i % 2 == 0 else 100.0) * rng.randn(dz)
    R = np.diag(1.0 + rng.rand(dz))
    ea = np.zeros(1)
    xu_j, Pu_j, y_j = jstep.update(js, kind, {}, xp_j, Pp_j, jnp.asarray(z),
                                   jnp.asarray(R), jnp.asarray(ea))
    xu_t, Pu_t, y_t = tstep.update(ts, kind, {}, xp_t, Pp_t, t64(z), t64(R),
                                   t64(ea))
    np.testing.assert_allclose(np_(xu_t), np.asarray(xu_j), rtol=RTOL)
    np.testing.assert_allclose(np_(Pu_t), np.asarray(Pu_j), rtol=1e-9,
                               atol=1e-10)
    np.testing.assert_allclose(np_(y_t), np.asarray(y_j), rtol=RTOL)
    ok_j = jstep.maha_test(js, kind, {}, xp_j, Pp_j, jnp.asarray(z),
                           jnp.asarray(R), jnp.asarray(ea))
    ok_t = tstep.maha_test(ts, kind, {}, xp_t, Pp_t, t64(z), t64(R), t64(ea))
    assert bool(ok_t) == bool(ok_j)


def test_update_batch_and_valid_mask():
  js, ts = j_kin_spec(), t_kin_spec()
  rng = np.random.RandomState(3)
  x, P = np.array([0.5, 0.1]), np.diag([1.0, 2.0])
  z = rng.randn(4, 1)
  R = np.tile(np.eye(1)[None] * 0.01, (4, 1, 1))
  ea = np.zeros((4, 1))
  valid = np.array([True, False, True, True])
  out_j = jstep.predict_and_update_batch(
      js, KK.POSITION, {}, jnp.asarray(x), jnp.asarray(P),
      jnp.asarray(KinematicKalman.Q), jnp.asarray(0.02), jnp.asarray(z),
      jnp.asarray(R), jnp.asarray(ea), jnp.asarray(valid))
  out_t = tstep.predict_and_update_batch(
      ts, KK.POSITION, {}, t64(x), t64(P), t64(KinematicKalman.Q), t64(0.02),
      t64(z), t64(R), t64(ea), torch.as_tensor(valid))
  for a, b in zip(out_j, out_t):
    np.testing.assert_allclose(np_(b), np.asarray(a), rtol=RTOL)


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_solve(d):
  rng = np.random.RandomState(d)
  A = rng.randn(d, d)
  a = A @ A.T + d * np.eye(d)
  b = rng.randn(d, 2)
  np.testing.assert_allclose(np_(tstep._solve(t64(a), t64(b))),
                             np.asarray(jstep._solve(jnp.asarray(a),
                                                     jnp.asarray(b))),
                             rtol=RTOL)


def test_gate_semantics():
  """Zero gain vs the reference's R x 1e16 inflation (templates/ekf_c.c:
  88-94), mirrored from tests/test_gate_semantics.py through the port's
  step: the same float64 numpy oracle and the same bounds; a NaN distance
  does not gate."""
  from test_gate_semantics import _reference_inflation_stream

  spec = t_kin_spec()
  spec = dataclasses.replace(spec, obs={KK.POSITION: dataclasses.replace(
      spec.obs[KK.POSITION], maha_test=True)})
  thresh = spec.obs[KK.POSITION].maha_thresh
  rng = np.random.RandomState(0)
  T = 500
  dts = np.full(T, 0.01)
  zs = 0.1 * rng.randn(T)
  outliers = rng.rand(T) < 0.2
  zs[outliers] += np.sign(rng.randn(outliers.sum())) * 1e3
  R = 0.01
  Q = np.asarray(KinematicKalman.Q, float)
  x0 = np.asarray(KinematicKalman.initial_x, float)
  P0 = np.diag(KinematicKalman.initial_P_diag).astype(float)
  x_ref, P_ref = _reference_inflation_stream(x0, P0, Q, dts, zs, R, thresh)

  x, P, gated = t64(x0), t64(P0), 0
  for dt, z in zip(dts, zs):
    x, P = tstep.predict(spec, {}, x, P, t64(Q), t64(dt))
    x_new, P_new, _ = tstep.update(spec, KK.POSITION, {}, x, P, t64([z]),
                                   t64([[R]]), t64([0.0]))
    gated += int(torch.equal(x_new, x))
    x, P = x_new, P_new
  assert gated >= int(outliers.sum())
  assert np.abs(np_(x) - x_ref).max() < 2e-10
  assert np.abs(np_(P) - P_ref).max() < 2e-12
  assert abs(float(x[0])) < 0.2 and float(P[0, 0]) < 0.01

  # a NaN innovation gives a NaN distance, which does not gate
  x_n, _, _ = tstep.update(spec, KK.POSITION, {}, x, P, t64([np.nan]),
                           t64([[R]]), t64([0.0]))
  assert torch.isnan(x_n).all()
