"""The port's MSCKF core against the JAX package, float64: core/step's
feature-kind update and augment, the Gauss-Newton triangulation, the
driver's augment / extra routine / replay, and the single-filter
observe_camera_frame of both MSCKF models.

The innovation bases differ by a rotation (a complete QR in both oracles,
but of He as each library factors it), so a projected innovation is
compared by its norm; x and P do not depend on the basis."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.core import step as jstep
from rednose_tpu.models import msckf_eskf as jes
from rednose_tpu.models import msckf_vo as jvo
from rednose_tpu.msckf import triangulation as jtri
from rednose_tpu_torch import interop
from rednose_tpu_torch.core import step as tstep
from rednose_tpu_torch.models import msckf_eskf as tes
from rednose_tpu_torch.models import msckf_vo as tvo
from rednose_tpu_torch.msckf import triangulation as ttri
from torch_parity import np_, t64

RTOL = 1e-10
MODELS = [(jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry),
          (jes.MSCKFEskf, tes.MSCKFEskf)]
IDS = ["msckf_vo", "msckf_eskf"]


def _state(model, rng):
  """A nominal state around the model's x0 with a spread clone window (so
  He has full column rank) and a full-rank covariance."""
  spec = model.build_spec()
  x = np.asarray(model.initial_x, np.float64) + 0.02 * rng.randn(spec.dim_x)
  for a in range(spec.n_augment):
    o = spec.dim_main + spec.dim_augment * a
    x[o:o + 3] += 0.5 * rng.randn(3)
  for idx in spec.quaternion_idxs:
    x[idx:idx + 4] /= np.linalg.norm(x[idx:idx + 4])
  A = 0.1 * rng.randn(spec.dim_err, spec.dim_err)
  P = A @ A.T + np.diag(model.initial_P_diag)
  return spec, x, P


@pytest.mark.parametrize("models", MODELS, ids=IDS)
def test_model_constants_match_jax(models):
  """The port's models carry the JAX models' constants (interop carries
  them across as tensors) and the same dims and kinds."""
  jm, tm = models
  ref = interop.model_constants_from_jax(jm, torch.float64)
  for name in ("initial_x", "initial_P_diag", "Q"):
    np.testing.assert_array_equal(getattr(tm, name), np_(ref[name]))
  assert sorted(tm.obs_noise) == sorted(ref["obs_noise"])
  for k, R in ref["obs_noise"].items():
    np.testing.assert_array_equal(tm.obs_noise[k], np_(R))
  js, ts = jm.build_spec(), tm.build_spec()
  for f in ("dim_x", "dim_err", "dim_main", "dim_main_err", "dim_augment",
            "dim_augment_err", "n_augment", "quaternion_idxs"):
    assert getattr(ts, f) == getattr(js, f), f
  assert {k: (o.dz, o.ea_dim, o.maha_test, o.maha_thresh)
          for k, o in ts.obs.items()} == {
              k: (o.dz, o.ea_dim, o.maha_test, o.maha_thresh)
              for k, o in js.obs.items()}


@pytest.mark.parametrize("models", MODELS, ids=IDS)
def test_feature_update_and_augment_match_jax(models):
  jm, tm = models
  rng = np.random.RandomState(0)
  jspec, x, P = _state(jm, rng)
  tspec = tm.build_spec()
  kind = 16
  om = jspec.obs[kind]
  ea = np.array([1.0, 0.5, 6.0]) + 0.1 * rng.randn(3)
  z = np.asarray(om.h({}, jnp.asarray(x), jnp.asarray(ea))) \
      + 0.005 * rng.randn(om.dz)
  R = np.diag(0.01**2 + 1e-5 * np.arange(om.dz))
  jx, jP, jy = jstep.update(jspec, kind, {}, jnp.asarray(x), jnp.asarray(P),
                            jnp.asarray(z), jnp.asarray(R), jnp.asarray(ea))
  tx, tP, ty = tstep.update(tspec, kind, {}, t64(x), t64(P), t64(z), t64(R),
                            t64(ea))
  np.testing.assert_allclose(np_(tx), np.asarray(jx), rtol=RTOL, atol=1e-12)
  np.testing.assert_allclose(np_(tP), np.asarray(jP), rtol=RTOL, atol=1e-13)
  assert ty.shape == (om.dz - om.ea_dim,)
  np.testing.assert_allclose(np.linalg.norm(np_(ty)),
                             np.linalg.norm(np.asarray(jy)), rtol=RTOL)

  jx, jP = jstep.augment(jspec, jx, jP)
  tx, tP = tstep.augment(tspec, tx, tP)
  np.testing.assert_allclose(np_(tx), np.asarray(jx), rtol=RTOL, atol=1e-12)
  np.testing.assert_allclose(np_(tP), np.asarray(jP), rtol=RTOL, atol=1e-13)
  d1, d3 = tspec.dim_main, tspec.dim_augment
  np.testing.assert_array_equal(np_(tx)[-d3:], np_(tx)[:d3])


@pytest.mark.parametrize("models", MODELS, ids=IDS)
def test_block_predict_matches_jax(models):
  """core/step.predict keeps the clone block static (ekf_c.c:17-29)."""
  jm, tm = models
  rng = np.random.RandomState(1)
  jspec, x, P = _state(jm, rng)
  tspec = tm.build_spec()
  jx, jP = jstep.predict(jspec, {}, jnp.asarray(x), jnp.asarray(P),
                         jnp.asarray(jm.Q), 0.05)
  tx, tP = tstep.predict(tspec, {}, t64(x), t64(P), t64(tm.Q), t64(0.05))
  np.testing.assert_allclose(np_(tx), np.asarray(jx), rtol=RTOL, atol=1e-13)
  np.testing.assert_allclose(np_(tP), np.asarray(jP), rtol=RTOL, atol=1e-13)
  m = tspec.dim_main_err
  np.testing.assert_allclose(np_(tP)[m:, m:], (P + 0.05 * tm.Q)[m:, m:],
                             rtol=1e-14)


def _eskf_tracks(rng, n):
  """Tracks of tests/test_msckf_eskf.py's kind: clones spread along x
  with small attitudes, landmarks ahead, observations with pixel noise;
  one track made of noise (it must not converge the same way by luck)."""
  poses = np.zeros((n, 4, 7))
  poses[:, :, 0] = np.arange(4) * 1.0
  poses[:, :, 1:3] = 0.1 * rng.randn(1, 4, 2)
  q = np.concatenate([np.ones((4, 1)), 0.02 * rng.randn(4, 3)], axis=1)
  poses[:, :, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
  lms = np.array([0.5, -0.3, 10.0]) + rng.randn(n, 3)
  obs = np.zeros((n, 4, 2))
  for i in range(n):
    for a in range(4):
      qa = poses[i, a, 3:7]
      Rq = np.asarray(jes.quat_to_rot(jnp.asarray(qa)))
      d = Rq.T @ (lms[i] - poses[i, a, :3])
      obs[i, a] = d[:2] / d[2] + 1e-3 * rng.randn(2)
  obs[0] = 3.0 * rng.randn(4, 2)
  return poses, obs


def test_triangulation_matches_jax():
  """compute_pos_batch: the same converged flags and positions at rtol
  1e-8."""
  poses, obs = _eskf_tracks(np.random.RandomState(2), 12)
  jpos, jok = jtri.compute_pos_batch(jnp.eye(3), jnp.asarray(poses),
                                     jnp.asarray(obs))
  tpos, tok = ttri.compute_pos_batch(torch.eye(3, dtype=torch.float64),
                                     t64(poses), t64(obs))
  np.testing.assert_array_equal(np_(tok), np.asarray(jok))
  assert np_(tok)[1:].all()
  ok = np_(tok)
  np.testing.assert_allclose(np_(tpos)[ok], np.asarray(jpos)[ok], rtol=1e-8,
                             atol=1e-10)


def test_single_track_compute_pos_matches_jax():
  """compute_pos, exported by the msckf package as the JAX package's is,
  on a converging track and on the noise track: the same converged flag
  as JAX's compute_pos and as the batch on that track, and where it
  converged the same position."""
  from rednose_tpu import msckf as jmsckf
  from rednose_tpu_torch import msckf as tmsckf

  poses, obs = _eskf_tracks(np.random.RandomState(2), 2)
  for i in (1, 0):
    jpos, jok = jmsckf.compute_pos(jnp.eye(3), jnp.asarray(poses[i]),
                                   jnp.asarray(obs[i]))
    tpos, tok = tmsckf.compute_pos(torch.eye(3, dtype=torch.float64),
                                   t64(poses[i]), t64(obs[i]))
    bpos, bok = tmsckf.compute_pos_batch(torch.eye(3, dtype=torch.float64),
                                         t64(poses[i:i + 1]),
                                         t64(obs[i:i + 1]))
    assert bool(tok) == bool(jok) == bool(bok[0])
    assert bool(tok) or i == 0
    if bool(tok):
      np.testing.assert_allclose(np_(tpos), np.asarray(jpos), rtol=1e-8,
                                 atol=1e-10)
      np.testing.assert_allclose(np_(tpos), np_(bpos[0]), rtol=1e-12)


def test_extra_routine_and_window():
  """get_extra_routine returns the spec's triangulator; an empty camera
  frame still predicts and augments (the window keeps the cadence)."""
  kf = tes.MSCKFEskf(device="cpu")
  fn = kf.filter.get_extra_routine("compute_pos")
  with pytest.raises(KeyError):
    kf.filter.get_extra_routine("nope")
  lm = np.array([0.5, -0.3, 10.0])
  poses = np.zeros((4, 7))
  poses[:, 0] = np.arange(4) * 1.0
  poses[:, 3] = 1.0
  obs = np.stack([(lm - poses[a, :3])[:2] / (lm - poses[a, :3])[2]
                  for a in range(4)])
  pos, ok = fn(torch.eye(3, dtype=torch.float64), t64(poses[None]),
               t64(obs[None]))
  assert bool(ok[0])
  np.testing.assert_allclose(np_(pos[0]), lm, rtol=1e-6, atol=1e-6)
  kv = tvo.MSCKFVisualOdometry(device="cpu")
  for k in range(3):
    kv.observe_camera_frame(0.1 * (k + 1), np.zeros((0, 4, 2)))
  np.testing.assert_allclose(kv.x[-3:], kv.x[0:3])
  assert kv.filter.get_augment_times()[-1] == pytest.approx(0.3)


def _frames(jm, n_frames, rng):
  """A constant-velocity camera over static landmarks (tests/
  test_msckf_vo.py:26 and test_msckf_eskf.py:289): per frame the tracks of
  every landmark from the last N_AUGMENT true positions."""
  v_true = np.array([1.0, 0.5, 0.2])
  landmarks = rng.uniform([-3, -3, 2.5], [3, 3, 8], size=(6, 3)) \
      + np.array([0.0, 0.0, 8.0])
  hist, pos, out = [], np.zeros(3), []
  for f in range(4 + n_frames):
    pos = pos + 0.2 * v_true
    hist.append(pos.copy())
    if f < 4:
      out.append(np.zeros((0, 4, 2)))
      continue
    window = np.stack(hist[-5:-1])
    out.append(np.stack([np.stack([(lm - window[k])[:2] / (lm - window[k])[2]
                                   + rng.normal(0, 2e-4, 2)
                                   for k in range(4)]) for lm in landmarks]))
  return v_true, out


@pytest.mark.parametrize("models", MODELS, ids=IDS)
def test_observe_camera_frame_matches_jax(models):
  """The single-filter camera-frame pipeline (triangulate, projected
  feature update, augment) of both models on the same frames."""
  jm, tm = models
  v_true, frames = _frames(jm, 3, np.random.RandomState(3))
  x0 = np.asarray(jm.initial_x, np.float64).copy()
  vel = slice(3, 6) if jm is jvo.MSCKFVisualOdometry else slice(7, 10)
  x0[vel] = v_true + np.array([0.4, -0.3, 0.15])
  jkf, tkf = jm(), tm(device="cpu")
  for kf in (jkf, tkf):
    kf.init_state(x0, covs_diag=jm.initial_P_diag)
  for f, tracks in enumerate(frames):
    t = 0.2 * (f + 1)
    je = jkf.observe_camera_frame(t, tracks)
    te = tkf.observe_camera_frame(t, tracks)
    assert te[5] == je[5]          # the same kind: the tracks converged
  np.testing.assert_allclose(tkf.x, np.asarray(jkf.x), rtol=1e-8, atol=1e-10)
  np.testing.assert_allclose(tkf.P, np.asarray(jkf.P), rtol=1e-8,
                             atol=1e-12)
  assert tkf.filter.get_augment_times() == pytest.approx(
      jkf.filter.get_augment_times())


def test_late_frame_replays_with_augment():
  """A camera frame that arrives late rewinds the engine and replays; the
  replayed frames augment again, so the result equals the sorted
  stream."""
  kf0 = tvo.MSCKFVisualOdometry(device="cpu")
  spec = kf0.spec
  rng = np.random.RandomState(4)
  _, x, P = _state(tvo.MSCKFVisualOdometry, rng)
  om = spec.obs[16]
  obs = []
  for f in range(4):
    ea = np.array([1.0, 0.5, 6.0]) + 0.1 * rng.randn(2, 3)
    z = np.stack([np_(om.h({}, t64(x), t64(e))) for e in ea]) \
        + 0.005 * rng.randn(2, om.dz)
    obs.append((0.05 * (f + 1), z, ea))
  R = kf0.get_R(16, 2)

  def run(order):
    kf = tvo.MSCKFVisualOdometry(device="cpu")
    kf.init_state(x, covs=P)
    for f in order:
      t, z, ea = obs[f]
      assert kf.filter.predict_and_update_batch(
          t, 16, z, R, extra_args=ea, augment=True) is not None
    return kf

  ref, late = run([0, 1, 2, 3]), run([0, 2, 3, 1])
  np.testing.assert_allclose(late.x, ref.x, rtol=1e-12, atol=1e-14)
  np.testing.assert_allclose(late.P, ref.P, rtol=1e-12, atol=1e-14)
  assert late.filter.get_augment_times() == ref.filter.get_augment_times()
