"""The slice as a whole: the port's KalmanBank(device="cpu") against the JAX
KalmanBank (CPU lane path) on the same streams, float64, rtol 1e-9 unless
stated: run, run_mixed and run_epochs with satellite extra args, the car's
per-step params stream and set_global, out-of-order observe equal to the
sorted stream, save / load across the packages, reset_diverged, and
LiveKalmanBank.run_epochs (mirrors tests/test_generic_bank_facade.py and
tests/test_car_bank.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.runtime.generic_bank import KalmanBank as JBank
from rednose_tpu.runtime.live_bank import LiveKalmanBank as JLiveBank
from rednose_tpu_torch.models.car import CarKalman, ObservationKind as CK
from rednose_tpu_torch.models.kinematic import KinematicKalman
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.models.loc import LocKalman
from rednose_tpu_torch.ops import generic_scan
from rednose_tpu_torch.runtime.generic_bank import KalmanBank
from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank
from torch_parity import np_

B = 8
RTOL = 1e-9
PS_KEYS = ("u", "steer_angle_deg")
# see tests/test_torch_generic_emitter.py: ECEF-scale pseudoranges round by
# ~4e-9 m in float64, carried into the ~1 m/s states; and the 1e8 m^2
# position prior cancels to ~10 m^2 in P, 1e-8 m^2 of float64 rounding
LOC_ATOL = 1e-7


def _jmodel(model):
  """The JAX package's class of the same model."""
  import importlib
  mod = importlib.import_module(f"rednose_tpu.models.{model.name}")
  return getattr(mod, model.__name__)


def _pair(model, **kw):
  ours = KalmanBank(model, batch=B, dtype=torch.float64, device="cpu", **kw)
  ref = JBank(_jmodel(model), batch=B, dtype=jnp.float64, use_pallas=False,
              **kw)
  return ours, ref


def _close(ours, ref, atol=1e-9):
  np.testing.assert_allclose(np_(ours.x), np.asarray(ref.x), rtol=RTOL,
                             atol=atol)
  np.testing.assert_allclose(np_(ours.P), np.asarray(ref.P), rtol=RTOL,
                             atol=atol)
  assert ours.t == ref.t


def _sats(rng, x0, shape):
  """Satellite states (*shape, B, 6) and consistent pseudoranges / rates
  (*shape, B) for receivers at x0 (B, 11)."""
  sat = LocKalman.initial_x[:3] + 2e7 * rng.randn(*shape, B, 3)
  vel = 3e3 * rng.randn(*shape, B, 3)
  d = x0[:, :3] - sat
  u = d / np.linalg.norm(d, axis=-1, keepdims=True)
  rho = np.linalg.norm(d, axis=-1) + x0[:, 6] + 2.0 * rng.randn(*shape, B)
  rate = (np.sum(u * (x0[:, 3:6] - vel), axis=-1) + x0[:, 7]
          + 0.05 * rng.randn(*shape, B))
  return np.concatenate([sat, vel], axis=-1), rho, rate


def test_run_kinematic_and_car_params_stream():
  rng = np.random.RandomState(0)
  ours, ref = _pair(KinematicKalman, t0=3.0)
  dts, zs = np.full(8, 0.01), 0.5 * rng.randn(8, B, 1)
  for bank in (ours, ref):
    bank.run(dts, zs, 1)
  _close(ours, ref)

  x0 = np.tile(CarKalman.initial_x, (B, 1)) + 0.05 * rng.randn(B, 5)
  ours, ref = _pair(CarKalman, x0=x0)
  T = 8
  zs = 0.1 * rng.randn(T, B, 1)
  pss = np.stack([15.0 + 5.0 * rng.rand(T),
                  30.0 * np.sin(np.linspace(0, 3, T))], axis=1)
  for bank in (ours, ref):
    bank.run(np.full(T, 0.05), zs, CK.YAW_RATE, pss=pss, ps_keys=PS_KEYS)
  _close(ours, ref)


def test_set_global_reaches_observe():
  """set_global between observations changes the filter as in the JAX
  facade (the reference's mutable C globals), with no rebuild: params are
  run-time values of the kernels."""
  rng = np.random.RandomState(1)
  ours, ref = _pair(CarKalman)
  t = 0.0
  for i in range(6):
    t += 0.05
    z = 0.1 * rng.randn(B, 1)
    for bank in (ours, ref):
      bank.set_global("u", 15.0 + i)
      bank.set_global("steer_angle_deg", 5.0 * i)
      bank.observe(t, CK.YAW_RATE, z)
  _close(ours, ref)
  with pytest.raises(KeyError):
    ours.set_global("no_such_param", 1.0)


def test_run_mixed_and_run_epochs_loc():
  rng = np.random.RandomState(2)
  x0 = np.tile(LocKalman.initial_x, (B, 1)) + rng.randn(B, 11)
  ours, ref = _pair(LocKalman, x0=x0)
  T = 6
  kinds = (K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS, K.ECEF_POS)
  kind_idx = np.arange(T) % 3
  eas, rho, rate = _sats(rng, x0, (T,))
  zs = np.zeros((T, B, 3))
  zs[:, :, 0] = np.where((kind_idx == 0)[:, None], rho, rate)
  zs[kind_idx == 2] = x0[:, :3] + 5.0 * rng.randn(B, 3)
  for bank in (ours, ref):
    bank.run_mixed(np.full(T, 0.1), kind_idx, zs, kinds, eas=eas)
  _close(ours, ref, LOC_ATOL)

  slots = (K.PSEUDORANGE_GPS,) * 2 + (K.PSEUDORANGE_RATE_GPS,) * 2
  eas, rho, rate = _sats(rng, x0, (T, len(slots)))
  zs = np.where((np.arange(len(slots)) < 2)[None, :, None], rho,
                rate)[..., None]
  zs[:, 1, ::4, 0] += 1e5           # one bad satellite, gated per slot
  for bank in (ours, ref):
    bank.run_epochs(np.full(T, 0.1), zs, slots, eas=eas)
  _close(ours, ref, LOC_ATOL)


def test_live_bank_run_epochs():
  """LiveKalmanBank.run_epochs (the generic epoch path on the live spec)
  against the JAX LiveKalmanBank lane path: the all-sensors tick."""
  rng = np.random.RandomState(3)
  ours = LiveKalmanBank(batch=B, dtype=torch.float64, device="cpu")
  ref = JLiveBank(batch=B, dtype=jnp.float64, use_pallas=False)
  slots = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)
  T = 4
  zs = 0.05 * rng.randn(T, 4, B, 3)
  zs[:, 3] = LiveKalman.initial_x[:3] + 5.0 * rng.randn(T, B, 3)
  for bank in (ours, ref):
    bank.run_epochs(np.full(T, 0.01), zs, slots)
  np.testing.assert_allclose(np_(ours.x), np.asarray(ref.x), rtol=RTOL,
                             atol=1e-9)
  np.testing.assert_allclose(np_(ours.P), np.asarray(ref.P), rtol=RTOL,
                             atol=1e-9)


def _loc_stream(rng):
  obs = []
  for i in range(12):
    kind = (K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS)[i % 2]
    ea = LocKalman.initial_x[:3] + 2e7 * rng.randn(B, 3)
    if i % 2:
      ea = np.concatenate([ea, 3e3 * rng.randn(B, 3)], axis=1)
    z = 2.5e7 * np.ones((B, 1)) if i % 2 == 0 else rng.randn(B, 1)
    obs.append((0.1 * (i + 1), kind, z, ea))
  return obs


def test_observe_out_of_order_equals_sorted_and_jax():
  obs = _loc_stream(np.random.RandomState(4))

  def run(stream, cls=KalmanBank, **kw):
    bank = cls(LocKalman if cls is KalmanBank else _jmodel(LocKalman),
               batch=B, ckpt_every=2, max_rewind_age=10.0, **kw)
    for t, k, z, ea in stream:
      assert bank.observe(t, k, z, ea=ea) is not None
    return bank

  ours = run(obs, dtype=torch.float64, device="cpu")
  shuffled = list(obs)
  shuffled[4], shuffled[7] = shuffled[7], shuffled[4]   # late, in window
  late = run(shuffled, dtype=torch.float64, device="cpu")
  np.testing.assert_array_equal(np_(ours.x), np_(late.x))
  np.testing.assert_array_equal(np_(ours.P), np_(late.P))
  ref = run(obs, JBank, dtype=jnp.float64, use_pallas=False)
  _close(ours, ref, LOC_ATOL)

  tight = KalmanBank(LocKalman, batch=B, dtype=torch.float64, device="cpu",
                     max_rewind_age=0.05)
  t, k, z, ea = obs[0]
  tight.observe(t, k, z, ea=ea)
  assert tight.observe(t - 1.0, k, z, ea=ea) is None


def test_save_load_across_packages_and_reset_diverged(tmp_path):
  rng = np.random.RandomState(5)
  ours, ref = _pair(KinematicKalman)
  dts, zs = np.full(4, 0.01), 0.1 * rng.randn(4, B, 1)
  for bank in (ours, ref):
    bank.run(dts, zs, 1)
  ours.save(tmp_path / "ours.npz")
  ref.save(tmp_path / "ref.npz")
  a = KalmanBank(KinematicKalman, batch=B, dtype=torch.float64,
                 device="cpu").load(tmp_path / "ref.npz")
  b = JBank(_jmodel(KinematicKalman), batch=B, dtype=jnp.float64,
            use_pallas=False).load(tmp_path / "ours.npz")
  _close(a, b)

  x = a._x.clone()
  x[:, 3] = float("nan")
  a._x = x
  assert int(a.diverged().sum()) == 1
  assert a.reset_diverged() == 1
  assert int(a.diverged().sum()) == 0
  np.testing.assert_array_equal(np_(a.x)[3], KinematicKalman.initial_x)
  seeds = np.arange(B * 2, dtype=np.float64).reshape(B, 2)
  x = a._x.clone()
  x[:, 6] = float("nan")
  a._x = x
  assert a.reset_diverged(x0=seeds) == 1
  np.testing.assert_array_equal(np_(a.x)[6], seeds[6])


def test_cpu_facade_launches_no_kernel():
  """On the CPU every surface runs the plain scans: no launch counted."""
  before = (generic_scan.generic_bank_scan.launches,
            generic_scan.generic_bank_scan_mixed.launches,
            generic_scan.generic_bank_scan_epoch.launches)
  bank = KalmanBank(KinematicKalman, batch=4, device="cpu")
  bank.run(np.full(2, 0.01), np.zeros((2, 4, 1)), 1)
  bank.run_mixed(np.full(2, 0.01), np.zeros(2, np.int32),
                 np.zeros((2, 4, 1)), (1,))
  bank.run_epochs(np.full(2, 0.01), np.zeros((2, 1, 4, 1)), (1,))
  bank.observe(0.1, 1, np.zeros(1))
  assert (generic_scan.generic_bank_scan.launches,
          generic_scan.generic_bank_scan_mixed.launches,
          generic_scan.generic_bank_scan_epoch.launches) == before


def test_facade_keeps_one_checked_call_per_kind_and_R():
  """observe and run reuse the bank's KernelCall (checks, source lookup and
  device copies once); a new R gets a call of its own, set_global drops
  them, and the kept values follow the new param."""
  bank = KalmanBank(CarKalman, batch=4, dtype=torch.float64, device="cpu")
  R = CarKalman.obs_noise[CK.YAW_RATE]
  for i in range(3):
    bank.observe(0.05 * (i + 1), CK.YAW_RATE, np.zeros(1))
  bank.run(np.full(2, 0.05), np.zeros((2, 4, 1)), CK.YAW_RATE)
  assert len(bank._calls) == 1
  call = next(iter(bank._calls.values()))
  assert call.values(torch.float64, "cpu") is call.values(torch.float64,
                                                          "cpu")
  bank.observe(bank.t + 0.05, CK.YAW_RATE, np.zeros(1), R=2.0 * R)
  assert len(bank._calls) == 2
  bank.set_global("mass", 2000.0)
  assert not bank._calls
  bank.observe(bank.t + 0.05, CK.YAW_RATE, np.zeros(1))
  new = next(iter(bank._calls.values()))
  assert new is not call and new.params["mass"] == 2000.0
  prm = new.values(torch.float64, "cpu")[0]
  assert 2000.0 in prm.tolist() and 2000.0 not in call.values(
      torch.float64, "cpu")[0].tolist()
