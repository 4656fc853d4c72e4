"""The slice as a whole: the port's LiveKalmanBank(device="cpu") against the
JAX LiveKalmanBank(use_pallas=False) on the same streams, float64 (rtol
1e-9) unless stated: run, run_mixed with streamed kinds, observe with late
and too-old observations, diverged / reset_diverged, and checkpoints saved
by one package and loaded by the other."""

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax.numpy as jnp
  from rednose_tpu.runtime.live_bank import LiveKalmanBank as JBank
except ImportError:
  jnp = JBank = None
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank
from torch_parity import cuda_device, np_  # noqa: F401

B = 8
RTOL = 1e-9


def _pair(**kw):
  ours = LiveKalmanBank(batch=B, dtype=torch.float64, device="cpu", **kw)
  ref = JBank(batch=B, dtype=jnp.float64, use_pallas=False, **kw)
  return ours, ref


def _close(ours, ref, rtol=RTOL, atol=1e-9):
  np.testing.assert_allclose(np_(ours.x), np.asarray(ref.x), rtol=rtol,
                             atol=atol)
  np.testing.assert_allclose(np_(ours.P), np.asarray(ref.P), rtol=rtol,
                             atol=atol)
  assert ours.t == ref.t


def _pos_stream(T, seed):
  rng = np.random.RandomState(seed)
  return (np.full((T,), 0.01),
          LiveKalman.initial_x[0:3] + 5.0 * rng.randn(T, B, 3))


def test_run_and_run_mixed():
  ours, ref = _pair(t0=100.0)
  dts, zs = _pos_stream(12, 0)
  ours.run(dts, zs)
  ref.run(dts, zs)
  _close(ours, ref)
  rng = np.random.RandomState(1)
  kinds = (K.PHONE_GYRO, K.CAMERA_ODO_TRANSLATION, K.ECEF_POS)
  T = 9
  kind_idx = np.arange(T) % 3
  zs = np.where((kind_idx == 2)[:, None, None],
                LiveKalman.initial_x[0:3] + rng.randn(T, B, 3),
                0.05 * rng.randn(T, B, 3))
  r_stream = (0.05 + 0.1 * rng.rand(T, 3)) ** 2
  for bank in (ours, ref):
    bank.run_mixed(np.full(T, 0.01), kind_idx, zs, kinds, gate=True,
                   r_stream=r_stream,
                   stream_kinds=(K.CAMERA_ODO_TRANSLATION,))
  _close(ours, ref)
  # T = 0 is a no-op on both
  ours.run(np.zeros(0), np.zeros((0, B, 3)))
  ours.run_mixed(np.zeros(0), np.zeros(0, np.int32), np.zeros((0, B, 3)),
                 (K.ECEF_POS,))
  _close(ours, ref)


def test_float32_run_matches_jax_lane_scan():
  """The production dtype: float32 on both sides, the tolerances of
  tests/test_pallas_live.py for two float32 programs."""
  ours = LiveKalmanBank(batch=B, device="cpu")
  ref = JBank(batch=B, use_pallas=False)
  dts, zs = _pos_stream(8, 2)
  ours.run(dts, zs)
  ref.run(dts, zs)
  np.testing.assert_allclose(np_(ours.x), np.asarray(ref.x), rtol=1e-6,
                             atol=1e-5)
  np.testing.assert_allclose(np_(ours.P), np.asarray(ref.P), rtol=1e-5,
                             atol=1e-5)


def _obs_stream(T=40, seed=0):
  rng = np.random.RandomState(seed)
  obs = []
  for i in range(T):
    k = (K.ECEF_POS, K.PHONE_GYRO, K.NO_ROT)[i % 3]
    if k == K.ECEF_POS:
      z, R = LiveKalman.initial_x[:3] + rng.normal(0, 1.0, (B, 3)), None
    elif k == K.PHONE_GYRO:
      z = np.array([0.3, -0.2, 0.1]) + rng.normal(0, 0.01, (B, 3))
      R = np.diag([0.025**2] * 3)
    else:
      z, R = np.zeros(3), np.diag([0.25**2] * 3)
    obs.append((0.01 * (i + 1), int(k), z, R))
  return obs


def test_observe_out_of_order():
  """observe() with late observations inside the rewind window (rewind +
  replay across snapshots), a too-old one returning None, against the JAX
  bank fed the same shuffled stream, and against the port's own sorted run."""
  obs = _obs_stream()
  shuffled = list(obs)
  for a, b in ((20, 23), (33, 38), (5, 6)):
    shuffled[a], shuffled[b] = shuffled[b], shuffled[a]
  kw = dict(P_diag=np.ones(22) * 1e-2, max_rewind_age=10.0)
  ours, ref = _pair(**kw)
  for t, k, z, R in shuffled:
    assert ours.observe(t, k, z, R=R) is not None
    assert ref.observe(t, k, z, R=R) is not None
  _close(ours, ref)
  srt, _ = _pair(**kw)
  for t, k, z, R in obs:
    srt.observe(t, k, z, R=R)
  np.testing.assert_array_equal(np_(srt.x), np_(ours.x))
  np.testing.assert_array_equal(np_(srt.P), np_(ours.P))

  old, _ = _pair(P_diag=np.ones(22) * 1e-2, max_rewind_age=0.05)
  for t, k, z, R in obs:
    old.observe(t, k, z, R=R)
  x_before = np_(old.x).copy()
  assert old.observe(old.t - 0.2, K.ECEF_POS,
                     LiveKalman.initial_x[:3]) is None
  np.testing.assert_array_equal(np_(old.x), x_before)


def test_diverged_and_reset():
  ours, ref = _pair()
  dts, zs = _pos_stream(4, 3)
  ours.run(dts, zs)
  ref.run(dts, zs)
  for bank, lib in ((ours, torch), (ref, jnp)):
    x = np.array(bank.x)
    x[2, 0] = np.nan
    x[5, 3:7] *= 50.0   # quaternion norm outside (0.1, 10)
    if lib is torch:
      bank._x = torch.as_tensor(x.T.copy())
    else:
      bank._x = jnp.asarray(x)
  np.testing.assert_array_equal(np_(ours.diverged()),
                                np.asarray(ref.diverged()))
  assert np_(ours.diverged()).tolist() == [False, False, True, False, False,
                                           True, False, False]
  assert ours.reset_diverged() == ref.reset_diverged() == 2
  _close(ours, ref)
  assert not np_(ours.diverged()).any()


def test_checkpoint_shared_with_jax(tmp_path):
  from rednose_tpu_torch import interop

  ours, ref = _pair(t0=5.0)
  dts, zs = _pos_stream(6, 4)
  ours.run(dts, zs)
  ref.run(dts, zs)
  st = interop.bank_state_from_jax(ref.state(), dtype=torch.float64)
  np.testing.assert_allclose(np_(st.x), np_(ours.x), rtol=RTOL)
  np.testing.assert_allclose(np_(st.P), np_(ours.P), rtol=RTOL, atol=1e-9)
  assert st.epoch == ours.state().epoch == ours.t
  ours.save(tmp_path / "ours.npz")
  ref.load(tmp_path / "ours.npz")
  _close(ours, ref, rtol=0, atol=0)
  ref.run(dts, zs)
  ref.save(tmp_path / "ref.npz")
  ours.load(tmp_path / "ref.npz")
  _close(ours, ref, rtol=0, atol=0)


def test_off_diagonal_q_and_standstill_odometry():
  """Off-diagonal Q runs the plain full-Q path on the CPU, equal to the
  JAX lane path; an odometer update at standstill stays finite."""
  Q = np.asarray(LiveKalman.Q).copy()
  Q[0, 6] = Q[6, 0] = 1e-3
  ours, ref = _pair(Q=Q)
  dts, zs = _pos_stream(5, 5)
  ours.run(dts, zs)
  ref.run(dts, zs)
  _close(ours, ref)
  bank = LiveKalmanBank(batch=B, device="cpu")
  bank.run_mixed(np.full(2, 0.01), np.zeros(2, np.int32),
                 np.zeros((2, B, 3)), (K.ODOMETRIC_SPEED,))
  assert torch.isfinite(bank._x).all() and torch.isfinite(bank._P).all()
  with pytest.raises(ValueError, match="per-measurement noise"):
    bank.run_mixed(np.full(2, 0.01), np.zeros(2, np.int32),
                   np.zeros((2, B, 3)), (K.CAMERA_ODO_TRANSLATION,))


@pytest.mark.cuda
def test_bank_on_card_launches_kernels(cuda_device):
  """On the card, run, run_mixed and observe go through kernels 2 and 3
  and match the CPU bank (float32, in standard deviations)."""
  from rednose_tpu_torch.ops import live_scan
  from rednose_tpu_torch.utils.compare import live_sigma_err

  dts, zs = _pos_stream(16, 6)
  gpu = LiveKalmanBank(batch=B, device=cuda_device)
  cpu = LiveKalmanBank(batch=B, device="cpu")
  n2, n3 = live_scan.live_bank_scan.launches, \
      live_scan.live_bank_scan_mixed.launches
  for bank in (gpu, cpu):
    bank.run(dts, zs)
    for t, k, z, R in _obs_stream(6):
      bank.observe(bank.t + t, k, z, R=R)
  assert live_scan.live_bank_scan.launches == n2 + 1
  assert live_scan.live_bank_scan_mixed.launches == n3 + 6
  assert max(live_sigma_err(gpu._x.cpu(), gpu._P.cpu(), cpu._x,
                            cpu._P)) < 1e-3
  # an off-diagonal Q takes the generic kernels on the card
  # (tests/test_torch_live_full_q.py); streamed R stays with the hand ones
  Q = np.asarray(LiveKalman.Q).copy()
  Q[0, 6] = Q[6, 0] = 1e-3
  full = LiveKalmanBank(batch=B, Q=Q, device=cuda_device)
  with pytest.raises(ValueError, match="streamed R"):
    full.run_mixed(np.full(2, 0.01), np.zeros(2, np.int32),
                   np.zeros((2, B, 3)), (K.CAMERA_ODO_TRANSLATION,),
                   r_stream=np.ones((2, 3)),
                   stream_kinds=(K.CAMERA_ODO_TRANSLATION,))
