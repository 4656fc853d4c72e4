"""The port's VisualOdometryPipeline (rednose_tpu_torch/msckf/pipeline.py)
on the port's MSCKFEskf(device="cpu") against the JAX package's pipeline
on the JAX MSCKFEskf, float64: the simulated tracker of
tests/test_vo_pipeline.py:18-67 (10 landmarks, a camera at 4 m/s) over
2K + 1 frames, with the same ids out of every frame and x and P equal at
rtol 1e-9; and the two bookkeeping scenarios of tests/test_vo_pipeline.py
(ids equal their slots, stale and duplicate ids re-issued, a full store
counted; a track harvested and its slot freed at the start of the next
frame), the stores equal exactly."""

import numpy as np
import pytest

from rednose_tpu.models.msckf_eskf import MSCKFEskf as JEskf
from rednose_tpu.msckf.pipeline import VisualOdometryPipeline as JPipeline
from rednose_tpu_torch import interop
from rednose_tpu_torch.models.msckf_eskf import N_AUGMENT, MSCKFEskf
from rednose_tpu_torch.msckf import feature_handler as fh
from rednose_tpu_torch.msckf.pipeline import VisualOdometryPipeline
import torch_parity  # noqa: F401  (one torch thread)

RTOL = 1e-9


def _pair(n_tracks, max_features, x0=None):
  jkf, tkf = JEskf(), MSCKFEskf(device="cpu")
  if x0 is not None:
    # filter_time 0: the first frame predicts a real dt
    for kf in (jkf, tkf):
      kf.init_state(x0, covs_diag=MSCKFEskf.initial_P_diag, filter_time=0.0)
  return (JPipeline(jkf, n_tracks=n_tracks, max_features=max_features),
          VisualOdometryPipeline(tkf, n_tracks=n_tracks,
                                 max_features=max_features))


def _same_store(jp, tp):
  np.testing.assert_array_equal(interop.tracks_to_jax(tp.tracks),
                                np.asarray(jp.tracks))
  assert tp.dropped_total == jp.dropped_total
  assert tp.live_track_count == jp.live_track_count


def _both(jp, tp, t, ids, uvs):
  jest, jids = jp.process_frame(t, ids, uvs)
  test, tids = tp.process_frame(t, ids, uvs)
  np.testing.assert_array_equal(tids, jids)
  _same_store(jp, tp)
  assert (jest is None) == (test is None)
  return test, tids


def test_pipeline_matches_jax_frame_by_frame():
  rng = np.random.RandomState(0)
  v0 = np.array([4.0, 0.0, 0.0])
  x0 = MSCKFEskf.initial_x.copy()
  x0[7:10] = v0
  jp, tp = _pair(64, 16, x0)
  landmarks = np.column_stack([rng.uniform(-4, 30, 10),
                               rng.uniform(-5, 5, 10),
                               rng.uniform(10, 18, 10)])
  ids = np.full(len(landmarks), -1, dtype=np.int64)
  t, n_updates = 0.0, 0
  for _ in range(2 * N_AUGMENT + 1):
    t += 0.1
    uvs = np.stack([(lm - v0 * t)[:2] / (lm - v0 * t)[2]
                    + rng.normal(0, 0.002, 2) for lm in landmarks])
    est, ids = _both(jp, tp, t, ids, uvs)
    if est is not None and len(est[7]):   # z nonempty: a feature update
      n_updates += 1
    np.testing.assert_allclose(tp.kf.x, jp.kf.x, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tp.kf.P, jp.kf.P, rtol=RTOL, atol=1e-14)
  assert n_updates >= 1
  assert tp.dropped_total == 0


def test_id_slot_invariant_and_reissue_match_jax():
  """Ids equal slots (slot 0 reserved); continuing ids append; a stale id
  and a duplicate id are re-issued; a 4-slot store counts its overflow."""
  jp, tp = _pair(16, 8)
  uv = np.array([[0.1, 0.2], [0.3, 0.4]])
  _, ids1 = _both(jp, tp, 0.1, [-1, -1], uv)
  assert np.all(ids1 > 0)
  hdr = interop.tracks_to_jax(tp.tracks)[:, 0]
  assert np.all(hdr[ids1, fh.H_COUNT] == 1)
  assert np.all(hdr[ids1, fh.H_LAST_ID] == ids1)
  _, ids2 = _both(jp, tp, 0.2, ids1, uv + 0.01)
  np.testing.assert_array_equal(ids2, ids1)
  _, ids3 = _both(jp, tp, 0.3, [9, ids1[1]], uv + 0.02)
  assert ids3[1] == ids1[1]
  _, ids4 = _both(jp, tp, 0.4, [ids1[1], ids1[1]], uv + 0.03)
  assert ids4[0] == ids1[1] and ids4[1] != ids1[1]

  jp, tp = _pair(4, 8)
  _, ids5 = _both(jp, tp, 0.1, [-1] * 5, np.zeros((5, 2)))
  assert (ids5 >= 0).sum() == 3 and tp.dropped_total == 2


def test_harvest_frees_the_slot_next_frame_as_jax():
  """A track completing at frame f is harvested, and its slot freed, at
  the start of frame f + 1, where a new detection takes it again."""
  jp, tp = _pair(8, 4)
  ids, t = np.array([-1]), 0.0
  for k in range(N_AUGMENT):
    t += 0.1
    _, ids = _both(jp, tp, t, ids,
                   np.array([[0.1 + 0.01 * k, 0.2 + 0.01 * k]]))
  assert interop.tracks_to_jax(tp.tracks)[ids[0], 0, fh.H_COMPLETE] == 1.0
  est, ids_new = _both(jp, tp, t + 0.1, [-1], np.array([[0.5, 0.5]]))
  assert ids_new[0] == ids[0] and est is not None
  assert tp.live_track_count == 1
  np.testing.assert_allclose(tp.kf.x, jp.kf.x, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("bad", ["uvs", "too_many"])
def test_process_frame_refuses_bad_input(bad):
  tp = VisualOdometryPipeline(MSCKFEskf(device="cpu"), n_tracks=8,
                              max_features=2)
  with pytest.raises(ValueError):
    if bad == "uvs":
      tp.process_frame(0.1, [-1, -1], np.zeros((3, 2)))
    else:
      tp.process_frame(0.1, [-1] * 3, np.zeros((3, 2)))
