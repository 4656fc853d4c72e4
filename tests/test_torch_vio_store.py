"""The port's MSCKF track store (rednose_tpu_torch/msckf/feature_handler.py)
against the JAX package's (rednose_tpu/msckf/feature_handler.py) on the
same numpy-seeded stores, float64 on the CPU, held exactly
(assert_array_equal): the cases of tests/test_msckf.py (a merge with
duplicate matches and a full track, overflow counted and not collided,
sentinel pads, sane, empty_slots, harvest_complete), the reference design
point (6000 tracks x 3000 features, two frames) and one frame of the JAX
bench's cohort tracker (harvest, reset_seen, empty_slots, merge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.msckf import feature_handler as jfh
from rednose_tpu_torch import interop
from rednose_tpu_torch.msckf import feature_handler as tfh
from chip_smoke import cohort_tracker
from torch_parity import np_


def _t(a, dtype=torch.float64):
  return torch.as_tensor(np.asarray(a), dtype=dtype)


def _merge_both(tracks, features, empty):
  """Merge on both stores; asserts the same store and drop count and
  returns the port's."""
  jt, jd = jfh.merge_features(jnp.asarray(tracks), jnp.asarray(features),
                              jnp.asarray(empty))
  tt, td = tfh.merge_features(interop.tracks_from_jax(tracks), _t(features),
                              _t(empty, torch.int64))
  np.testing.assert_array_equal(interop.tracks_to_jax(tt), np.asarray(jt))
  assert td.ndim == 0 and int(td) == int(jd)
  return tt, int(td)


def _seeded(K, n_tracks, states):
  """A store with track m at `count` observations for (m, count) in
  states, its rows distinct."""
  tracks = np.zeros((n_tracks, K + 1, 5))
  for m, count in states:
    tracks[m, 0] = [count, m, 0, 0, 0]
    for s in range(1, count + 1):
      tracks[m, s] = [0, m, 0.1 * s + 0.01 * m, 0.1 * s, m]
  return tracks


@pytest.mark.parametrize("full", [False, True], ids=["oracle", "full_track"])
def test_merge_with_duplicate_matches(full):
  """Appends to seeded tracks (a duplicate match: the first claims the
  track, the second starts a new one), a track completing, padding rows,
  new tracks; with `full` a match on a complete track, which is dropped."""
  K, n_tracks, nf = 4, 32, 12
  rng = np.random.RandomState(3)
  states = [(2, 1), (5, 2), (7, K - 1), (9, 3)] + ([(11, K)] if full else [])
  tracks = _seeded(K, n_tracks, states)
  match = [2, 5, 7, 9, 2, -1, 11, 12, 13, 14, 15, 16]
  features = np.column_stack([np.zeros(nf), 100 + np.arange(nf),
                              0.02 * rng.randn(nf), 0.02 * rng.randn(nf),
                              match])
  taken = {m for m, _ in states}
  empty = np.array(sorted(set(range(n_tracks)) - taken), np.int64)[:nf]
  out, dropped = _merge_both(tracks, features, empty)
  assert dropped == 0
  hdr = np_(out)[:, 0]
  assert hdr[7, tfh.H_COMPLETE] == 1.0 and hdr[2, tfh.H_COUNT] == 2.0


def test_overflow_is_counted_not_collided():
  """More new tracks than empty slots: the overflow is dropped and
  counted, the last slot holds one track; sentinel pads (>= n_tracks)
  count as dropped too."""
  K, n_tracks, nf = 3, 16, 6
  tracks = np.zeros((n_tracks, K + 1, 5))
  features = np.column_stack([np.zeros(nf), 100 + np.arange(nf),
                              0.1 * np.arange(nf), 0.2 * np.arange(nf),
                              5 + np.arange(nf)])
  out, dropped = _merge_both(tracks, features, np.array([3, 8]))
  assert dropped == 4
  np.testing.assert_array_equal(np_(out)[3, 1], features[0])
  out, dropped = _merge_both(tracks, features,
                             np.array([3, n_tracks, n_tracks]))
  assert dropped == 5


def test_sane_on_random_tracks():
  K = 6
  rng = np.random.RandomState(0)
  tracks = np.zeros((20, K + 1, 5))
  tracks[:, 1:, 2] = np.cumsum(0.05 * rng.randn(20, K), axis=1)
  tracks[:, 1:, 3] = np.cumsum(0.05 * rng.randn(20, K), axis=1)
  want = np.array([bool(jfh.sane(jnp.asarray(tr))) for tr in tracks])
  assert 0 < want.sum() < 20          # both outcomes occur
  np.testing.assert_array_equal(np_(tfh.sane(_t(tracks))), want)
  for tr, w in zip(tracks, want):
    assert bool(tfh.sane(_t(tr))) == w


def test_empty_slots_with_sentinel_pad():
  K, n_tracks = 3, 10
  tracks = np.zeros((n_tracks, K + 1, 5))
  tracks[[1, 4, 7], 0, 0] = 2
  for m in (5, 6):
    np.testing.assert_array_equal(
        np_(tfh.empty_slots(_t(tracks), m)),
        np.asarray(jfh.empty_slots(jnp.asarray(tracks), m)))
  tracks[:, 0, 0] = 2
  tracks[[3, 8], 0, 0] = 0.0
  got = np_(tfh.empty_slots(_t(tracks), 6))
  np.testing.assert_array_equal(
      got, np.asarray(jfh.empty_slots(jnp.asarray(tracks), 6)))
  np.testing.assert_array_equal(got, [3, 8] + [n_tracks] * 4)


def test_harvest_complete():
  """Complete and valid tracks come out ascending, padded with n_tracks,
  their rows oldest first; every complete row is cleared, the others are
  untouched."""
  K, n_tracks = 4, 12
  rng = np.random.RandomState(7)
  tracks = np.zeros((n_tracks, K + 1, 5))
  for m, (complete, valid) in [(9, (1, 1)), (2, (1, 0)), (5, (1, 1)),
                               (4, (0, 0))]:
    count = K if complete else 2
    tracks[m, 0] = [count, m, 0, complete, valid]
    tracks[m, 1:1 + count, 2:4] = 0.02 * rng.randn(count, 2)
  want = [np.asarray(a) for a in jfh.harvest_complete(jnp.asarray(tracks),
                                                      4)]
  got = [np_(a) for a in tfh.harvest_complete(_t(tracks), 4)]
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a, b)
  np.testing.assert_array_equal(got[0], [5, 9, n_tracks, n_tracks])


def test_store_at_the_reference_design_point():
  """6000 tracks x 3000 features (feature_handler.c:23-26): a frame of new
  tracks, then a frame extending every one of them."""
  K = 4
  nf = tfh.DEFAULT_N_FEATURES
  tracks = tfh.empty_tracks(K, device="cpu")
  assert tuple(tracks.shape) == (tfh.DEFAULT_N_TRACKS, K + 1, 5)
  uv = np.random.RandomState(0).rand(nf, 2)
  for frame, (du, match0) in enumerate(((0.0, nf), (0.01, 0))):
    feats = np.column_stack([np.zeros(nf), np.arange(nf), uv + du,
                             match0 + np.arange(nf)])
    host = interop.tracks_to_jax(tracks)
    if frame:
      host = np.asarray(jfh.reset_seen(jnp.asarray(host)))
      tracks = tfh.reset_seen(tracks)
      np.testing.assert_array_equal(interop.tracks_to_jax(tracks), host)
    empty = np_(tfh.empty_slots(tracks))
    np.testing.assert_array_equal(
        empty, np.asarray(jfh.empty_slots(jnp.asarray(host))))
    tracks, dropped = _merge_both(host, feats, empty)
    assert dropped == 0
  counts = np_(tracks)[:, 0, tfh.H_COUNT]
  assert (counts > 0).sum() == nf and (counts[counts > 0] == 2.0).all()


def test_one_frame_of_the_cohort_tracker():
  """The JAX bench's VIO store legs at a small size (K = 4, cohorts of
  16): harvest_complete, reset_seen, empty_slots, merge_features."""
  K, n_tracks, cohort = 4, 96, 16
  tracks0, feats, _, _ = cohort_tracker(K, n_tracks, cohort, 1)
  j = jnp.asarray(tracks0)
  jidx, juv, j = jfh.harvest_complete(j, cohort + 4)
  j = jfh.reset_seen(j)
  jempty = jfh.empty_slots(j, K * cohort)
  j, jd = jfh.merge_features(j, jnp.asarray(feats[0]), jempty)
  t = _t(tracks0)
  tidx, tuv, t = tfh.harvest_complete(t, cohort + 4)
  t = tfh.reset_seen(t)
  tempty = tfh.empty_slots(t, K * cohort)
  t, td = tfh.merge_features(t, _t(feats[0]), tempty)
  for a, b in ((tidx, jidx), (tuv, juv), (tempty, jempty), (t, j)):
    np.testing.assert_array_equal(np_(a), np.asarray(b))
  assert int(td) == int(jd) == 0
  assert int((tidx < n_tracks).sum()) == cohort
  assert int((t[:, 0, tfh.H_COUNT] > 0).sum()) == K * cohort
