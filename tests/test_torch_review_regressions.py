"""tests/test_review_regressions.py mirrored on the port: the guards against
defects found in code review of the JAX package (float32 gate overflow,
feature kinds in heterogeneous streams, empty observation batches, epoch
timestamps, single-track input shape, registry completeness, full-track
feature drops, the clone window after failed triangulations, log order,
checkpointed augment times, bank time at epoch scale, mapping params),
each on the port's counterpart, on the CPU.

Twelve guards are mirrored whole. The thirteenth,
test_variable_batch_n_buckets_one_compile, is mirrored in part: its
results (variable measurement counts n against the per-row sequential
oracle) hold here as test_variable_batch_n_matches_per_row_oracle. Its
compile counts and pad rows do not apply: the JAX engine pads n to a
power-of-two bucket and counts jax.jit's cache, while the port's engine
runs eager torch on the n rows it is given, so nothing is compiled per
n and no row is padded.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rednose_tpu_torch import registry
from rednose_tpu_torch.core import step as step_ops
from rednose_tpu_torch.models.kinematic import KinematicKalman
from rednose_tpu_torch.models.kinematic import ObservationKind as KK
from rednose_tpu_torch.models.msckf_vo import (
    MSCKFVisualOdometry,
    N_AUGMENT,
    build_msckf_vo_spec,
)
from rednose_tpu_torch.models.msckf_vo import ObservationKind as MK
from rednose_tpu_torch.runtime.scan import build_scan_stream, pad_log

CPU = "cpu"


def _t(a, dtype=torch.float64):
  return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_gated_outlier_float32_no_nan():
  """A gated outlier with large R in float32 leaves state and covariance
  exactly unchanged and finite, for a 1-dim and a 3-dim kind."""
  spec = KinematicKalman.build_spec()
  om = spec.obs[KK.POSITION]
  spec = dataclasses.replace(
      spec, obs={KK.POSITION: dataclasses.replace(om, maha_test=True)})
  f32 = torch.float32
  x = _t([0.0, 0.0], f32)
  P = _t(np.diag([0.01, 0.01]), f32)
  R = _t([[1.0e4]], f32)    # 100 m GPS std
  z = _t([1.0e4], f32)      # wild outlier -> gated
  x2, P2, _ = step_ops.update(spec, KK.POSITION, {}, x, P, z, R,
                              torch.zeros(1, dtype=f32))
  assert torch.isfinite(x2).all()
  np.testing.assert_allclose(x2.numpy(), x.numpy())
  np.testing.assert_allclose(P2.numpy(), P.numpy())

  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.models.live import ObservationKind as LK
  lspec = LiveKalman.build_spec()
  lom = lspec.obs[LK.ECEF_POS]
  lspec = dataclasses.replace(
      lspec, obs={**dict(lspec.obs),
                  LK.ECEF_POS: dataclasses.replace(lom, maha_test=True)})
  xl = _t(LiveKalman.initial_x, f32)
  Pl = _t(np.diag(LiveKalman.initial_P_diag), f32)
  Rl = _t(np.diag([1e4] * 3), f32)
  zl = xl[0:3] + 1e6  # gross outlier
  x2, P2, _ = step_ops.update(lspec, LK.ECEF_POS, {}, xl, Pl, zl, Rl,
                              torch.zeros(1, dtype=f32))
  assert torch.isfinite(x2).all() and torch.isfinite(P2).all()


def test_scan_stream_with_feature_kind():
  """A stream mixing a plain kind with an MSCKF feature kind builds and
  runs."""
  spec = build_msckf_vo_spec()
  kinds = (MK.POSITION, MK.MSCKF_TEST)
  scan_fn, _ = build_scan_stream(spec, kinds)

  ea = np.array([1.0, 2.0, 10.0])
  x0 = np.zeros(spec.dim_x)
  h_feat = spec.obs[MK.MSCKF_TEST].h({}, _t(x0), _t(ea)).numpy()
  log = [
      (0.1, MK.POSITION, np.zeros(3), np.eye(3), None),
      (0.2, MK.MSCKF_TEST, h_feat, np.eye(2 * N_AUGMENT) * 1e-4, ea),
      (0.3, MK.POSITION, np.zeros(3), np.eye(3), None),
  ]
  dts, ki, zs, Rs, eas = pad_log(spec, kinds, log, t0=0.0)
  (x_f, P_f), _ = scan_fn(
      {}, _t(x0), _t(np.eye(spec.dim_err)), _t(np.eye(spec.dim_err) * 1e-4),
      _t(dts), torch.as_tensor(ki), _t(zs), _t(Rs), _t(eas))
  assert torch.isfinite(x_f).all() and torch.isfinite(P_f).all()


def test_empty_observation_batch_is_noop_update():
  """predict_and_observe with an empty batch predicts and checkpoints."""
  kf = KinematicKalman(device=CPU)
  kf.predict_and_observe(0.0, KK.POSITION, [[0.5]])
  est = kf.predict_and_observe(1.0, KK.POSITION, [])
  assert est is not None
  assert kf.t == 1.0
  assert len(est[6]) == 0  # no innovations


def test_epoch_timestamps_preserve_dt():
  """Unix-epoch timestamps keep dt: pad_log differences them in float64."""
  spec = KinematicKalman.build_spec()
  t0 = 1.7e9
  log = [(t0 + (i + 1) * 0.01, KK.POSITION, [0.0], np.atleast_2d(0.01), None)
         for i in range(10)]
  dts, ki, zs, Rs, eas = pad_log(spec, (KK.POSITION,), log, t0=t0)
  # float64 spacing at 1.7e9 is ~2.4e-7 s, so ~1e-8 error is inherent
  np.testing.assert_allclose(dts, 0.01, atol=1e-7)
  assert abs(float(_t(dts, torch.float32)[0]) - 0.01) < 1e-7


def test_single_track_shape_promotion():
  """A single 2-D track is one track, not N_AUGMENT tracks; a 3-D batch
  of one behaves the same (triangulating a zero-baseline track may fail,
  but must not crash or mis-shape)."""
  kf = MSCKFVisualOdometry(device=CPU)
  kf.observe_camera_frame(0.1, np.zeros((0, N_AUGMENT, 2)))
  one_track = np.full((N_AUGMENT, 2), 0.1)
  kf.observe_camera_frame(0.2, one_track)
  kf.observe_camera_frame(0.3, one_track[None])
  assert kf.t == 0.3


def test_registry_includes_all_shipped_models():
  names = set(registry.registered_filters())
  assert {"kinematic", "live", "msckf_vo"} <= names
  assert registry.lookup("msckf_vo") is MSCKFVisualOdometry


def test_full_track_features_are_dropped():
  """A feature matching a complete (count == K) track is dropped: it
  neither appends out of bounds nor burns an empty slot."""
  from rednose_tpu_torch.msckf import feature_handler as fh

  K, n_tracks = 3, 8
  tracks = np.zeros((n_tracks, K + 1, 5))
  tracks[2, 0] = [K, 2, 0, 1, 0]  # full track, id 2
  features = np.zeros((2, 5))
  features[0] = [0, 100, 0.1, 0.1, 2]   # matches the full track -> dropped
  features[1] = [0, 101, 0.2, 0.2, -1]  # padding
  empty = torch.as_tensor([0, 1, 3, 4], dtype=torch.int64)
  out, _ = fh.merge_features(_t(tracks), _t(features), empty)
  out = out.numpy()
  np.testing.assert_allclose(out[2, 0, 0], K)      # count unchanged
  assert np.all(out[[0, 1, 3, 4], 0, 0] == 0)      # no new track spawned


def test_all_failed_triangulation_still_advances_window():
  """A frame whose triangulations all fail still predicts and augments."""
  kf = MSCKFVisualOdometry(device=CPU)
  kf.observe_camera_frame(0.1, np.zeros((0, N_AUGMENT, 2)))
  t_before = list(kf.filter.get_augment_times())
  # zero-baseline clones -> degenerate geometry -> all triangulations fail
  kf.observe_camera_frame(0.2, np.full((2, N_AUGMENT, 2), 0.1))
  assert kf.t == 0.2
  t_after = kf.filter.get_augment_times()
  assert t_after != t_before and t_after[-1] == 0.2


def test_pad_log_rejects_out_of_order():
  spec = KinematicKalman.build_spec()
  log = [(0.2, KK.POSITION, [0.0], np.atleast_2d(0.01), None),
         (0.1, KK.POSITION, [0.0], np.atleast_2d(0.01), None)]
  with pytest.raises(ValueError, match="non-decreasing"):
    pad_log(spec, (KK.POSITION,), log, t0=0.0)


def test_checkpoint_roundtrips_augment_times(tmp_path):
  from rednose_tpu_torch.runtime.checkpoint import load_filter, save_filter

  kf = MSCKFVisualOdometry(device=CPU)
  for k in range(3):
    kf.observe_camera_frame(0.1 * (k + 1), np.zeros((0, N_AUGMENT, 2)))
  path = tmp_path / "msckf.npz"
  save_filter(path, kf.filter)
  kf2 = MSCKFVisualOdometry(device=CPU)
  load_filter(path, kf2.filter)
  assert kf2.filter.get_augment_times() == kf.filter.get_augment_times()


def test_bank_epoch_time_advances():
  """An epoch-scale t0 does not freeze bank time in float32 (t is kept
  relative to the epoch)."""
  from rednose_tpu_torch.runtime import bank as bank_ops

  spec = KinematicKalman.build_spec()
  f32 = torch.float32
  state = bank_ops.init_bank(
      spec, KinematicKalman.initial_x, np.diag(KinematicKalman.initial_P_diag),
      batch=4, t0=1.7e9, dtype=f32, device=CPU)
  z = torch.zeros((4, 1), dtype=f32)
  R = torch.full((4, 1, 1), 0.01, dtype=f32)
  ea = torch.zeros((4, 1), dtype=f32)
  Q = _t(KinematicKalman.Q, f32)
  state2, _ = bank_ops.bank_predict_and_update(
      spec, KK.POSITION, {}, state, Q, _t(0.01, f32), z, R, ea)
  np.testing.assert_allclose(np.asarray(state2.absolute_t()), 1.7e9 + 0.01)


def test_set_global_rejects_non_mapping_params():
  from rednose_tpu_torch.runtime.driver import FilterEngine

  spec = KinematicKalman.build_spec()
  eng = FilterEngine(spec, KinematicKalman.Q, KinematicKalman.initial_x,
                     np.diag(KinematicKalman.initial_P_diag),
                     params=(0.5, 0.2), device=CPU)
  with pytest.raises(TypeError, match="mapping"):
    eng.set_global("gain", 1.0)


def test_variable_batch_n_matches_per_row_oracle():
  """Variable measurement counts n through predict_and_update_batch equal
  a predict and the n updates one by one (core/step)."""
  kf = KinematicKalman(device=CPU)
  spec = kf.spec
  rng = np.random.RandomState(0)
  x_ref = _t(KinematicKalman.initial_x)
  P_ref = _t(np.diag(KinematicKalman.initial_P_diag))
  Q = _t(KinematicKalman.Q)
  t, first = 0.0, True
  for n in [1, 2, 3, 4, 5, 3, 1, 7]:
    t += 0.25  # exactly representable: dt = t - filter_time stays exact
    z = rng.randn(n, 1)
    R = np.tile(np.eye(1)[None] * 0.04, (n, 1, 1))
    est = kf.filter.predict_and_update_batch(t, KK.POSITION, z, R)
    assert len(est[6]) == n  # one innovation per real row
    # the first observation initializes filter_time: dt = 0
    x_ref, P_ref = step_ops.predict(spec, {}, x_ref, P_ref, Q,
                                    _t(0.0 if first else 0.25))
    first = False
    for i in range(n):
      x_ref, P_ref, _ = step_ops.update(spec, KK.POSITION, {}, x_ref, P_ref,
                                        _t(z[i]), _t(R[i]), torch.zeros(1))
    np.testing.assert_allclose(np.asarray(kf.filter.state()), x_ref.numpy(),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(np.asarray(kf.filter.covs()), P_ref.numpy(),
                               rtol=1e-12, atol=1e-15)
