"""Port parity of the generic-bank slice's models and structure detection:
CarKalman and LocKalman f, h, F and H against the JAX package at float64
(rtol 1e-10) on seeded states, params and extra args; short FilterEngine
runs; and detect_structure, which must find the same f_rows, h_cols and
g_cols as the JAX package for car, loc, live and kinematic."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import car as jcar
from rednose_tpu.models import kinematic as jkin
from rednose_tpu.models import live as jlive
from rednose_tpu.models import loc as jloc
from rednose_tpu.ops import sparsity as jsparsity
from rednose_tpu_torch import interop, registry
from rednose_tpu_torch.models import car, kinematic, live, loc
from rednose_tpu_torch.models.live import ObservationKind as K
from rednose_tpu_torch.ops import sparsity
from torch_parity import np_, t64

RTOL = 1e-10
CAR_KINDS = (1, 2)
LOC_KINDS = (6, 7, 12, 22, 23)


def _car_point(rng):
  x = car.CarKalman.initial_x + np.array([2.0, 0.1, 1.0, 0.5, 0.2]) \
      * rng.randn(5)
  params = {k: v * (1.0 + 0.1 * rng.randn())
            for k, v in car.DEFAULT_PARAMS.items()}
  params["u"] = 3.0 + 20.0 * rng.rand()   # both sides of MIN_SPEED
  params["steer_angle_deg"] = 30.0 * rng.randn()
  return x, params, np.zeros(1)


def _loc_point(rng, kind):
  x = loc.LocKalman.initial_x + np.concatenate(
      [100.0 * rng.randn(3), 5.0 * rng.randn(3), 50.0 * rng.randn(2),
       rng.randn(3)])
  ea_len = jloc.build_loc_spec().obs[kind].ea_len
  ea = np.concatenate([loc.LocKalman.initial_x[:3] + 2e7 * rng.randn(3),
                       3e3 * rng.randn(3)])[:max(ea_len, 1)]
  return x, {}, ea


@pytest.mark.parametrize("model,kind", [("car", k) for k in CAR_KINDS]
                         + [("loc", k) for k in LOC_KINDS])
def test_f_h_F_H_match_jax(model, kind):
  jspec = {"car": jcar.build_car_spec, "loc": jloc.build_loc_spec}[model]()
  tspec = {"car": car.build_car_spec, "loc": loc.build_loc_spec}[model]()
  rng = np.random.RandomState(kind)
  for _ in range(3):
    x, params, ea = (_car_point(rng) if model == "car"
                     else _loc_point(rng, kind))
    tparams = interop.params_from_jax(params, torch.float64)
    dt = 0.05
    np.testing.assert_allclose(
        np_(tspec.f(tparams, t64(x), t64(dt))),
        np.asarray(jspec.f(params, jnp.asarray(x), dt)), rtol=RTOL)
    np.testing.assert_allclose(
        np_(tspec.F(tparams, t64(x), t64(dt))),
        np.asarray(jspec.F(params, jnp.asarray(x), dt)), rtol=RTOL,
        atol=1e-14)
    np.testing.assert_allclose(
        np_(tspec.obs[kind].h(tparams, t64(x), t64(ea))),
        np.asarray(jspec.obs[kind].h(params, jnp.asarray(x),
                                     jnp.asarray(ea))), rtol=RTOL)
    np.testing.assert_allclose(
        np_(tspec.H(kind, tparams, t64(x), t64(ea))),
        np.asarray(jspec.H(kind, params, jnp.asarray(x), jnp.asarray(ea))),
        rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("model", ["car", "loc"])
def test_model_constants_and_registry(model):
  ours, ref = {"car": (car.CarKalman, jcar.CarKalman),
               "loc": (loc.LocKalman, jloc.LocKalman)}[model]
  for name in ("initial_x", "initial_P_diag", "Q"):
    np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
  assert set(ours.obs_noise) == set(ref.obs_noise)
  for k in ref.obs_noise:
    np.testing.assert_array_equal(ours.obs_noise[k], ref.obs_noise[k])
  assert registry.lookup(model) is ours


def test_car_engine_with_set_global_matches_jax():
  """A short FilterEngine run of the car model with per-tick inputs set
  through set_global (the reference's set_<var>), float64."""
  rng = np.random.RandomState(3)
  ours = car.CarKalman(device="cpu")
  ref = jcar.CarKalman()
  for i in range(30):
    t = 0.05 * (i + 1)
    u, steer = 15.0 + 5.0 * rng.rand(), 20.0 * np.sin(0.3 * i)
    for kf in (ours, ref):
      kf.set_inputs(u, steer)
    kind = car.ObservationKind.YAW_RATE if i % 3 else \
        car.ObservationKind.LATERAL_SLIP
    z = [0.05 * rng.randn()]
    ours.predict_and_observe(t, kind, z)
    ref.predict_and_observe(t, kind, z)
  np.testing.assert_allclose(ours.x, np.asarray(ref.x), rtol=1e-9,
                             atol=1e-12)
  np.testing.assert_allclose(ours.P, np.asarray(ref.P), rtol=1e-9,
                             atol=1e-14)


def test_loc_engine_with_extra_args_matches_jax():
  """A short FilterEngine run of the GNSS model: pseudoranges and rates
  with per-measurement satellite states (the non-feature extra-args
  path), float64."""
  rng = np.random.RandomState(4)
  ours = loc.LocKalman(device="cpu")
  ref = jloc.LocKalman()
  truth = loc.LocKalman.initial_x[:3] + np.array([40.0, -30.0, 25.0])
  for i in range(12):
    t = 0.1 * (i + 1)
    sat = truth + 2.66e7 * rng.randn(4, 3) / np.sqrt(3)
    vel = 100.0 * rng.randn(4, 3)
    d = truth - sat
    rho = np.linalg.norm(d, axis=1) + 120.0
    u = d / np.linalg.norm(d, axis=1, keepdims=True)
    rate = np.sum(u * -vel, axis=1) + 0.8
    kind = jlive.ObservationKind.PSEUDORANGE_GPS if i % 2 == 0 else \
        jlive.ObservationKind.PSEUDORANGE_RATE_GPS
    z = (rho if i % 2 == 0 else rate)[:, None]
    ea = sat if i % 2 == 0 else np.concatenate([sat, vel], axis=1)
    R = np.tile(loc.LocKalman.obs_noise[kind][None], (4, 1, 1))
    ours.filter.predict_and_update_batch(t, kind, z, R, ea)
    ref.filter.predict_and_update_batch(t, kind, z, R, ea)
  np.testing.assert_allclose(ours.x, np.asarray(ref.x), rtol=1e-9,
                             atol=1e-6)
  np.testing.assert_allclose(ours.P, np.asarray(ref.P), rtol=1e-8,
                             atol=1e-8)


@pytest.mark.parametrize("model", ["car", "loc", "live", "kinematic"])
def test_detect_structure_matches_jax(model):
  jm, tm = {"car": (jcar.CarKalman, car.CarKalman),
            "loc": (jloc.LocKalman, loc.LocKalman),
            "live": (jlive.LiveKalman, live.LiveKalman),
            "kinematic": (jkin.KinematicKalman,
                          kinematic.KinematicKalman)}[model]
  a = jsparsity.detect_structure(jm.build_spec(), jm.initial_x)
  b = sparsity.detect_structure(tm.build_spec(), tm.initial_x)
  assert b.f_rows == a.f_rows
  assert b.h_cols == a.h_cols
  assert b.g_cols == a.g_cols


def test_jvp_columns_match_dense_jacobians():
  """composed_h_jvp and f_columns (one jvp per column) equal the columns of
  the dense jacfwd Jacobians H @ H_mod and F, on the live spec."""
  spec = live.build_live_spec()
  rng = np.random.RandomState(9)
  x = live.LiveKalman.initial_x + 0.1 * rng.randn(23)
  x[3:7] /= np.linalg.norm(x[3:7])
  cols = (0, 3, 4, 9, 16, 21)
  F = np_(spec.F({}, t64(x), t64(0.05)))
  fc = sparsity.f_columns(spec, {}, t64(x), t64(0.05), cols)
  for kind in (K.PHONE_ACCEL, K.CAMERA_ODO_TRANSLATION):
    Hd = np_(spec.H(kind, {}, t64(x), t64(np.zeros(1)))
             @ spec.H_mod_at({}, t64(x)))
    h, hc = sparsity.composed_h_jvp(spec, kind, {}, t64(x), cols)
    np.testing.assert_allclose(np_(h), np_(spec.obs[kind].h(
        {}, t64(x), t64(np.zeros(1)))), rtol=RTOL)
    for c, col in zip(cols, hc):
      np.testing.assert_allclose(np_(col), Hd[:, c], rtol=RTOL, atol=1e-14)
  for c in cols:
    np.testing.assert_allclose(np_(fc[c]), F[:, c], rtol=RTOL, atol=1e-14)


def test_inconsistent_h_mod_raises():
  """A spec whose H_mod disagrees with d err/d dx is refused, as in the
  JAX package (tests/test_sparsity.py), and KalmanBank then emits the
  dense body (structure None)."""
  from rednose_tpu_torch.runtime.generic_bank import KalmanBank

  spec = live.build_live_spec()
  bad = dataclasses.replace(
      spec, name="live_bad_hmod",
      H_mod=lambda params, x: 2.0 * spec.H_mod_at(params, x))
  with pytest.raises(sparsity.StructureError, match="H_mod"):
    sparsity.detect_structure(bad, live.LiveKalman.initial_x)
  bank = KalmanBank(spec=bad, x0=live.LiveKalman.initial_x,
                    P_diag=live.LiveKalman.initial_P_diag,
                    Q=live.LiveKalman.Q, batch=2, device="cpu")
  assert bank.structure is None


def test_param_dependent_structure_detected():
  """An entry that is zero at the given params but not after set_global is
  detected: the samples perturb the params, not only the state."""
  from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel

  def f(params, x, dt):
    return torch.stack([x[0] + dt * params["k"] * x[1], x[1]])

  spec = FilterSpec(
      name="param_gated", dim_x=2, dim_err=2, f=f,
      obs={1: ObservationModel(kind=1,
                               h=lambda p, x, ea: (p["k"] * x[1])[None],
                               dz=1)},
      default_params={"k": 0.0})
  st = sparsity.detect_structure(spec, np.array([1.0, 2.0]))
  assert 1 in st.f_rows[0]
  assert 1 in st.cols_for(1)
