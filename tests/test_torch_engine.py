"""Port parity: FilterEngine and the model facades against the reference
goldens (tests/test_kinematic_golden.py, tests/test_reference_golden.py)
and the JAX engine, float64 on the CPU."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rednose_tpu.models.kinematic import KinematicKalman as JKin
from rednose_tpu.models.live import LiveKalman as JLive
from rednose_tpu_torch import registry
from rednose_tpu_torch.models.kinematic import (
    KinematicKalman,
    ObservationKind,
    States,
)
from rednose_tpu_torch.models.live import (
    KalmanError,
    LiveKalman,
    ObservationKind as LK,
    build_live_spec,
)
from rednose_tpu_torch.runtime.checkpoint import load_filter, save_filter
from rednose_tpu_torch.runtime.driver import FilterEngine
from torch_parity import np_  # noqa: F401  (sets torch to one thread)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CAM_KINDS = (13, 14)


def _load(name):
  return np.load(os.path.join(FIXTURES, name))


@pytest.mark.parametrize("model", ["kinematic", "live"])
def test_model_constants_match_jax(model):
  ours, ref = {"kinematic": (KinematicKalman, JKin),
               "live": (LiveKalman, JLive)}[model]
  for name in ("initial_x", "initial_P_diag", "Q"):
    np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
  assert set(ours.obs_noise) == set(ref.obs_noise)
  for k in ref.obs_noise:
    np.testing.assert_array_equal(ours.obs_noise[k], ref.obs_noise[k])
  assert registry.lookup(model) is ours


def test_kinematic_golden():
  """The reference's four golden values (examples/test_kinematic_kf.py:
  52-55) through the port's FilterEngine, to 7 decimals."""
  np.random.seed(0)
  kf = KinematicKalman(device="cpu")
  dt = 0.01
  ts = np.arange(0, 5, step=dt)
  vs = np.sin(ts * 5)
  x = 0.0
  for t, v in zip(ts, vs):
    kf.predict_and_observe(t, ObservationKind.POSITION,
                           [np.random.normal(x, 0.1)])
    x += v * dt
  state, std = kf.x, np.sqrt(kf.P)
  np.testing.assert_almost_equal(state[States.POSITION].item(),
                                 -0.010866289677966417)
  np.testing.assert_almost_equal(
      std[States.POSITION, States.POSITION].item(), 0.04477103863330089)
  np.testing.assert_almost_equal(state[States.VELOCITY].item(),
                                 -0.8553720537261753)
  np.testing.assert_almost_equal(
      std[States.VELOCITY, States.VELOCITY].item(), 0.6695762270974388)


def test_kinematic_trace_filter_engine():
  """ref_kinematic_trace.npz (the reference's compiled filter, including
  the index 20<->40 out-of-order swap) per delivery, atol 1e-12."""
  d = _load("ref_kinematic_trace.npz")
  kf = KinematicKalman(device="cpu")
  xs, Ps = [], []
  for t, z in zip(d["t"], d["z"]):
    assert kf.predict_and_observe(float(t), 1, [np.array([z])]) is not None
    xs.append(kf.x.copy())
    Ps.append(kf.P.copy())
  np.testing.assert_allclose(np.stack(xs), d["golden_x"], atol=1e-12)
  np.testing.assert_allclose(np.stack(Ps), d["golden_P"], atol=1e-12)


def _live_obs(d, j):
  kind = int(d["kind"][j])
  z = d["z"][j][: int(d["dz"][j])]
  if kind in CAM_KINDS:
    R = np.diag(d["stds"][j] ** 2)
  else:
    R = np.atleast_2d(np.asarray(LiveKalman.obs_noise[kind], dtype=float))
  return float(d["t"][j]), kind, z, R


def test_live_trace_filter_engine():
  """ref_live_trace.npz (300 observations of every kind, camera R from the
  measurement rows, out-of-order swaps) with the reference's normalization
  placement (test_reference_golden.py:11-19): relative state error <= 1e-9,
  covariance <= 1e-8 absolute, as the JAX test holds its engine, plus 4 ulp
  of the entry: the position variances start at 1e8, where one float64 ulp
  is 1.5e-8 and the port's op order may land one ulp from the reference."""
  d = _load("ref_live_trace.npz")
  spec = dataclasses.replace(build_live_spec(), name="live_refnorm",
                             quaternion_idxs=())
  eng = FilterEngine(spec, LiveKalman.Q, d["x0"], np.diag(d["P0_diag"]),
                     device="cpu")
  eng.init_state(d["x0"], np.diag(d["P0_diag"]), filter_time=0.0)
  scale = np.maximum(np.abs(d["golden_x"]).max(axis=0), 1.0)
  rel_x, abs_P = [], []
  for pos, j in enumerate(d["order"]):
    t, kind, z, R = _live_obs(d, j)
    assert eng.predict_and_update_batch(t, kind, z.reshape(1, -1),
                                        R[None]) is not None
    eng.normalize_slice(3, 7)  # facade-level renorm (live_kf.py:306)
    rel_x.append((np.abs(eng.state() - d["golden_x"][pos]) / scale).max())
    err = np.abs(eng.covs() - d["golden_P"][pos])
    abs_P.append((err - 4 * np.finfo(float).eps
                  * np.abs(d["golden_P"][pos])).max())
  assert max(rel_x) <= 1e-9, max(rel_x)
  assert max(abs_P) <= 1e-8, max(abs_P)


def test_too_old_rejected_and_rewind():
  kf = KinematicKalman(device="cpu", max_rewind_age=0.5)
  for t in np.arange(0, 1.0, 0.1):
    kf.predict_and_observe(t, 1, [0.1 * t])
  x_before = kf.x.copy()
  assert kf.predict_and_observe(0.2, 1, [0.0]) is None   # older than 0.5 s
  np.testing.assert_array_equal(kf.x, x_before)
  assert kf.predict_and_observe(0.85, 1, [0.05]) is not None  # rewinds
  assert kf.t == pytest.approx(0.9)


def test_live_facade_matches_jax():
  """LiveKalman.predict_and_observe (camera kinds' R from columns 3:6, the
  quaternion guard) against the JAX facade over a mixed stream."""
  rng = np.random.RandomState(4)
  ours, ref = LiveKalman(device="cpu"), JLive()
  stream = []
  for i in range(24):
    t = 0.01 * (i + 1)
    kind = (LK.ECEF_POS, LK.PHONE_GYRO, LK.CAMERA_ODO_ROTATION,
            LK.CAMERA_ODO_TRANSLATION)[i % 4]
    if kind == LK.ECEF_POS:
      data = [LiveKalman.initial_x[:3] + rng.randn(3)]
    elif kind in CAM_KINDS:
      data = [np.concatenate([0.01 * rng.randn(3), [0.05, 0.06, 0.07]])]
    else:
      data = [0.01 * rng.randn(3)]
    stream.append((t, kind, data))
  stream[10], stream[12] = stream[12], stream[10]   # one late delivery
  for t, kind, data in stream:
    ours.predict_and_observe(t, kind, np.asarray(data))
    ref.predict_and_observe(t, kind, np.asarray(data))
    np.testing.assert_allclose(ours.x, ref.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(ours.P, ref.P, rtol=1e-7, atol=1e-9)
  ours.filter.x = torch.full_like(ours.filter.x, float("nan"))
  with pytest.raises(KalmanError):
    ours.predict_and_observe(0.5, LK.ECEF_POS,
                             [LiveKalman.initial_x[:3]])


def test_filter_checkpoint_shared_with_jax(tmp_path):
  """save_filter in one package, load_filter in the other."""
  from rednose_tpu.runtime.checkpoint import load_filter as j_load
  from rednose_tpu.runtime.checkpoint import save_filter as j_save

  ours, ref = KinematicKalman(device="cpu"), JKin()
  for t in (0.0, 0.1, 0.2):
    ours.predict_and_observe(t, 1, [0.3])
  save_filter(tmp_path / "a.npz", ours.filter)
  j_load(tmp_path / "a.npz", ref.filter)
  np.testing.assert_array_equal(ref.x, ours.x)
  assert ref.t == ours.t
  ref.predict_and_observe(0.3, 1, [0.2])
  j_save(tmp_path / "b.npz", ref.filter)
  load_filter(tmp_path / "b.npz", ours.filter)
  np.testing.assert_array_equal(ours.P, ref.P)


def test_rts_smooth_not_ported():
  """rts_smooth is ported now (tests/test_torch_rts.py): on the engine's
  device it returns one smoothed (x, P) numpy pair per estimate."""
  kf = KinematicKalman(device="cpu")
  assert kf.filter.rts_smooth([]) == []
  ests = [kf.predict_and_observe(t, 1, [0.1 * t]) for t in (0.0, 0.01, 0.02)]
  out = kf.filter.rts_smooth(ests)
  assert len(out) == 3 and all(isinstance(x, np.ndarray) and x.shape == (2,)
                               and P.shape == (2, 2) for x, P in out)
