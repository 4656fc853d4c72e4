"""Port parity of the plain versions of kernels 4-6 (ops/lane_bank.py):
lane_bank_scan, lane_mixed_bank_scan and lane_epoch_bank_scan against the
JAX package's lane scans (dense path), float64 on the CPU, rtol 1e-9, at
B = 16, T = 8: car with a per-step params stream, loc with satellite
extra args, the live spec, and the kinematic spec."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import car as jcar
from rednose_tpu.models import kinematic as jkin
from rednose_tpu.models import live as jlive
from rednose_tpu.models import loc as jloc
from rednose_tpu.ops import lane_bank as jlane
from rednose_tpu_torch import interop
from rednose_tpu_torch.models import car, kinematic, live, loc
from rednose_tpu_torch.models.live import ObservationKind as K
from rednose_tpu_torch.ops import lane_bank
from torch_parity import np_, t64

B, T = 16, 8
RTOL = 1e-9
# a pseudorange is ~2e7 m: float64 rounds each innovation by ~4e-9 m, and
# the gain carries that into the ~1 m/s velocities, whatever the op order
LOC_ATOL_X = 1e-7


def _close(ours, ref, atol_x=1e-9, atol_P=1e-10):
  np.testing.assert_allclose(np_(ours[0]), np.asarray(ref[0]), rtol=RTOL,
                             atol=atol_x)
  np.testing.assert_allclose(np_(ours[1]), np.asarray(ref[1]), rtol=RTOL,
                             atol=atol_P)


def _bank(model, rng, scale):
  x = np.tile(model.initial_x, (B, 1)) + scale * rng.randn(
      B, len(model.initial_x))
  for idx in model.build_spec().quaternion_idxs:
    x[:, idx:idx + 4] /= np.linalg.norm(x[:, idx:idx + 4], axis=1,
                                        keepdims=True)
  de = model.build_spec().dim_err
  A = 0.1 * rng.randn(B, de, de)
  P = np.einsum("bij,bkj->ikb", A, A) + np.diag(
      model.initial_P_diag)[:, :, None] * 0.01
  return x, P


def _loc_data(rng, x, kinds):
  """Satellite states and consistent measurements for a schedule of loc
  kinds: zs (T, B, max_dz) and eas (T, B, 6), each row padded."""
  sat = loc.LocKalman.initial_x[:3] + 2e7 * rng.randn(T, B, 3)
  vel = 3e3 * rng.randn(T, B, 3)
  d = x[None, :, :3] - sat
  rho = np.linalg.norm(d, axis=-1) + x[None, :, 6]
  u = d / np.linalg.norm(d, axis=-1, keepdims=True)
  rate = np.sum(u * (x[None, :, 3:6] - vel), axis=-1) + x[None, :, 7]
  zs = np.zeros((T, B, 3))
  for t, k in enumerate(kinds):
    if k == K.ECEF_POS:
      zs[t] = x[:, :3] + 5.0 * rng.randn(B, 3)
    else:
      zs[t, :, 0] = (rho[t] + 2.0 * rng.randn(B) if k == K.PSEUDORANGE_GPS
                     else rate[t] + 0.05 * rng.randn(B))
  return zs, np.concatenate([sat, vel], axis=-1)


def test_car_with_params_stream():
  rng = np.random.RandomState(0)
  x, P = _bank(car.CarKalman, rng, 0.05)
  zs = 0.1 * rng.randn(T, B, 1)
  dts = np.full(T, 0.05)
  pss = np.stack([15.0 + 5.0 * rng.rand(T),
                  30.0 * np.sin(np.linspace(0, 3, T))], axis=1)
  R = car.CarKalman.obs_noise[car.ObservationKind.YAW_RATE]
  keys = ("u", "steer_angle_deg")
  ours = lane_bank.lane_bank_scan(
      car.build_car_spec(), 1,
      interop.params_from_jax(jcar.DEFAULT_PARAMS, torch.float64),
      t64(x), t64(P), t64(car.CarKalman.Q), t64(dts), t64(zs), t64(R),
      ps_keys=keys, pss=t64(pss))
  ref = jlane.jit_lane_bank_scan(jcar.build_car_spec(), 1, None, keys)(
      dict(jcar.DEFAULT_PARAMS), jnp.asarray(x), jnp.asarray(P),
      jnp.asarray(jcar.CarKalman.Q), jnp.asarray(dts), jnp.asarray(zs),
      jnp.asarray(R), pss=jnp.asarray(pss))
  _close(ours, ref)


@pytest.mark.parametrize("kind", [K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS,
                                  K.ECEF_POS])
def test_loc_single_kind_with_extra_args(kind):
  rng = np.random.RandomState(kind)
  x, P = _bank(loc.LocKalman, rng, 1.0)
  zs, eas = _loc_data(rng, x, (kind,) * T)
  om = loc.build_loc_spec().obs[kind]
  zs, eas = zs[:, :, :om.dz], (eas[:, :, :om.ea_len] if om.ea_len else None)
  R = loc.LocKalman.obs_noise[kind]
  dts = np.full(T, 0.1)
  ours = lane_bank.lane_bank_scan(
      loc.build_loc_spec(), kind, {}, t64(x), t64(P), t64(loc.LocKalman.Q),
      t64(dts), t64(zs), t64(R), eas=None if eas is None else t64(eas))
  ref = jlane.jit_lane_bank_scan(jloc.build_loc_spec(), int(kind))(
      {}, jnp.asarray(x), jnp.asarray(P), jnp.asarray(jloc.LocKalman.Q),
      jnp.asarray(dts), jnp.asarray(zs), jnp.asarray(R),
      eas=None if eas is None else jnp.asarray(eas))
  _close(ours, ref, atol_x=LOC_ATOL_X)


def test_loc_mixed_schedule():
  rng = np.random.RandomState(5)
  x, P = _bank(loc.LocKalman, rng, 1.0)
  kinds = (K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS, K.ECEF_POS)
  kind_idx = np.arange(T) % 3
  zs, eas = _loc_data(rng, x, [kinds[i] for i in kind_idx])
  R_list = [loc.LocKalman.obs_noise[k] for k in kinds]
  dts = np.full(T, 0.1)
  ours = lane_bank.lane_mixed_bank_scan(
      loc.build_loc_spec(), kinds, {}, t64(x), t64(P),
      t64(loc.LocKalman.Q), t64(dts), torch.as_tensor(kind_idx), t64(zs),
      [t64(R) for R in R_list], eas=t64(eas))
  ref = jlane.jit_lane_mixed_bank_scan(jloc.build_loc_spec(),
                                       tuple(int(k) for k in kinds))(
      {}, jnp.asarray(x), jnp.asarray(P), jnp.asarray(jloc.LocKalman.Q),
      jnp.asarray(dts), jnp.asarray(kind_idx, jnp.int32), jnp.asarray(zs),
      tuple(jnp.asarray(R) for R in R_list), eas=jnp.asarray(eas))
  _close(ours, ref, atol_x=LOC_ATOL_X)


def test_loc_epochs():
  rng = np.random.RandomState(6)
  x, P = _bank(loc.LocKalman, rng, 1.0)
  slots = (K.PSEUDORANGE_GPS,) * 2 + (K.PSEUDORANGE_RATE_GPS,) * 2
  zs, eas = [], []
  for k in slots:
    z, e = _loc_data(rng, x, (k,) * T)
    zs.append(z[:, :, :1])
    eas.append(e)
  zs, eas = np.stack(zs, axis=1), np.stack(eas, axis=1)  # (T, K, B, .)
  zs[:, 1, ::4, 0] += 1e5          # one bad satellite: the per-slot gate
  R_list = [loc.LocKalman.obs_noise[k] for k in slots]
  dts = np.full(T, 0.1)
  ours = lane_bank.lane_epoch_bank_scan(
      loc.build_loc_spec(), slots, {}, t64(x), t64(P), t64(loc.LocKalman.Q),
      t64(dts), t64(zs), [t64(R) for R in R_list], eas=t64(eas))
  ref = jlane.jit_lane_epoch_bank_scan(jloc.build_loc_spec(),
                                       tuple(int(k) for k in slots))(
      {}, jnp.asarray(x), jnp.asarray(P), jnp.asarray(jloc.LocKalman.Q),
      jnp.asarray(dts), jnp.asarray(zs),
      tuple(jnp.asarray(R) for R in R_list), eas=jnp.asarray(eas))
  _close(ours, ref, atol_x=LOC_ATOL_X)


@pytest.mark.parametrize("kind", [K.ECEF_POS, K.PHONE_GYRO])
def test_live_spec(kind):
  rng = np.random.RandomState(kind)
  x, P = _bank(live.LiveKalman, rng, 0.01)
  zs = (x[None, :, :3] + 5.0 * rng.randn(T, B, 3) if kind == K.ECEF_POS
        else 0.05 * rng.randn(T, B, 3))
  R = live.LiveKalman.obs_noise[kind]
  dts = np.full(T, 0.01)
  ours = lane_bank.lane_bank_scan(
      live.build_live_spec(), kind, {}, t64(x), t64(P),
      t64(live.LiveKalman.Q), t64(dts), t64(zs), t64(R))
  ref = jlane.jit_lane_bank_scan(jlive.build_live_spec(), int(kind))(
      {}, jnp.asarray(x), jnp.asarray(P), jnp.asarray(jlive.LiveKalman.Q),
      jnp.asarray(dts), jnp.asarray(zs), jnp.asarray(R))
  _close(ours, ref, atol_x=1e-8)


def test_kinematic_spec_and_forced_gate():
  """The kinematic spec, and gate=True forcing the zero-gain gate on a
  kind without maha_test (the generic kernels' flag) equals the JAX lane
  scan of the same spec with maha_test set."""
  import dataclasses

  rng = np.random.RandomState(7)
  x, P = _bank(kinematic.KinematicKalman, rng, 0.5)
  zs = 0.5 * rng.randn(T, B, 1)
  zs[::3, ::2] += 30.0                 # outliers the gate rejects
  dts = np.full(T, 0.01)
  R = kinematic.KinematicKalman.obs_noise[1]
  tspec = kinematic.build_kinematic_spec()
  jspec = jkin.build_kinematic_spec()
  args = (t64(x), t64(P), t64(kinematic.KinematicKalman.Q), t64(dts),
          t64(zs), t64(R))
  jargs = ({}, jnp.asarray(x), jnp.asarray(P),
           jnp.asarray(jkin.KinematicKalman.Q), jnp.asarray(dts),
           jnp.asarray(zs), jnp.asarray(R))
  _close(lane_bank.lane_bank_scan(tspec, 1, {}, *args),
         jlane.jit_lane_bank_scan(jspec, 1)(*jargs))
  gated = dataclasses.replace(
      jspec, obs={1: dataclasses.replace(jspec.obs[1], maha_test=True)})
  _close(lane_bank.lane_bank_scan(tspec, 1, {}, *args, gate=True),
         jlane.jit_lane_bank_scan(gated, 1)(*jargs))
