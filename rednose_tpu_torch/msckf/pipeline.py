"""Frame-to-filter visual-odometry pipeline: the glue the reference leaves
to its downstream consumer (openpilot's locationd).

Port of rednose_tpu/msckf/pipeline.py. The reference ships a fixed-capacity
track store (feature_handler.c) and a triangulation kernel (compute_pos.c)
but no code that connects camera frames to filter updates; this is that
wiring on the port's equivalents:

  detections --(id bookkeeping)--> feature_handler.merge_features
             --(harvest complete and valid tracks)--> kf.observe_camera_frame
                                    (triangulation, projected MSCKF update,
                                     window augment)

Pose / observation alignment: the filter clones the pose of frame f into
its window after frame f's update (ekf_sym.py:525-526), so at frame f the
window holds the poses of frames f-K..f-1. A track harvested at the start
of frame f aligns exactly: it completed at frame f-1 with observations
from frames f-K..f-1. Harvesting after the merge of frame f would pair
every observation with a clone one frame old.

Id / slot contract (implied by the C lookup `track[match].last_id ==
match`, feature_handler.c:33): a track lives at the store slot equal to
its feature id and keeps that id for life. The pipeline keeps it by
allocating ids for new detections from the empty slots in rank order (the
order merge_features' cumsum consumes empty_idxs) and by validating
continuing ids on the host (a live track at that slot, no duplicate in the
frame). Slot 0 is reserved with count -1: an empty slot 0 would pass the
append check for id 0 and shift every later allocation.

The store lives on the filter's device in float64 (the JAX default); only
its (n_tracks, 5) header and the completed rows cross to the host. It runs
in plain torch, as its JAX counterpart runs in XLA with no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from rednose_tpu_torch.msckf import feature_handler as fh


class VisualOdometryPipeline:
  """Owns the track store of one camera feeding one MSCKF filter.

  `kf` is a facade with `observe_camera_frame(t, tracks_img)` whose window
  length is the complete-track size K (models/msckf_eskf.MSCKFEskf or
  models/msckf_vo.MSCKFVisualOdometry). `max_features` caps the detections
  of a frame; every frame is padded to it, so the merge keeps one shape."""

  def __init__(self, kf, n_tracks: int = fh.DEFAULT_N_TRACKS,
               max_features: int = 256):
    self.kf = kf
    self.K = kf.spec.n_augment
    self.n_tracks = n_tracks
    self.max_features = max_features
    self.device = kf.filter.device
    tracks = fh.empty_tracks(self.K, n_tracks, device=self.device)
    # reserve slot 0 (module docstring): count -1 is never empty and the
    # host-side continuing-id check (count > 0) never appends to it
    tracks[0, 0, fh.H_COUNT] = -1.0
    self.tracks = tracks
    self.dropped_total = 0  # detections lost to a full store

  def process_frame(self, t, ids, uvs):
    """Ingest one camera frame and run the filter.

    ids (n,) int persistent feature ids from the upstream tracker, -1 for
    a new detection (an id is allocated for it); an id whose track is gone
    is re-issued. uvs (n, 2) normalized image coordinates at time t.
    Returns (estimate, ids_out): the filter's Estimate (None if it dropped
    the frame as too old) and the (n,) ids the detections carry from now
    on (-1 where the store was full)."""
    ids = np.asarray(ids, dtype=np.int64)
    uvs = np.asarray(uvs, dtype=np.float64)
    n = ids.shape[0]
    if uvs.shape != (n, 2):
      raise ValueError(f"uvs {uvs.shape}, expected ({n}, 2)")
    if n > self.max_features:
      raise ValueError(f"{n} detections, max_features {self.max_features}")

    # ---- harvest first (pose / observation alignment)
    hdr = self.tracks[:, 0, :].cpu().numpy().copy()
    complete_rows = np.flatnonzero(hdr[:, fh.H_COMPLETE] == 1.0)
    if complete_rows.size:
      rows = torch.as_tensor(complete_rows, device=self.device)
      data = self.tracks[rows].cpu().numpy()
      valid = hdr[complete_rows, fh.H_VALID] == 1.0
      tracks_img = data[valid][:, 1:, 2:4]  # (m, K, 2), oldest first
      self.tracks = self.tracks.index_fill(0, rows, 0.0)
      hdr[complete_rows] = 0.0  # keep the host view of the header in step
    else:
      tracks_img = np.zeros((0, self.K, 2))

    # ---- classify detections on the host header: append to a live track
    # at slot == id (first claim wins), else a fresh id from the empty
    # slots in rank order, so the merge's cumsum lands it at slot == id
    empty = np.flatnonzero(hdr[:, fh.H_COUNT] == 0.0)
    ids_out = np.full(n, -1, dtype=np.int64)
    claimed: set[int] = set()
    alloc_slots: list[int] = []  # slots of the new rows, in row order
    rank = 0
    for row in range(n):
      i = int(ids[row])
      live = (0 < i < self.n_tracks and hdr[i, fh.H_COUNT] > 0
              and hdr[i, fh.H_LAST_ID] == i and i not in claimed)
      if live:
        ids_out[row] = i
        claimed.add(i)
      elif rank < empty.shape[0]:
        slot = int(empty[rank])
        ids_out[row] = slot
        alloc_slots.append(slot)
        rank += 1
      else:
        self.dropped_total += 1  # store full: the detection is lost

    # ---- merge, padded to max_features
    features = np.full((self.max_features, 5), -1.0)  # pad rows: match < 0
    features[:n, 0] = 0.0
    features[:n, 1] = ids_out  # next_id: the id the track keeps
    features[:n, 2:4] = uvs
    features[:n, 4] = ids_out  # match: continuing rows append, new rows miss
    empty_arg = np.full((self.max_features,), self.n_tracks, dtype=np.int64)
    empty_arg[:len(alloc_slots)] = alloc_slots
    self.tracks = fh.reset_seen(self.tracks)
    self.tracks, _ = fh.merge_features(
        self.tracks,
        torch.as_tensor(features, dtype=self.tracks.dtype,
                        device=self.device),
        torch.as_tensor(empty_arg, device=self.device))

    est = self.kf.observe_camera_frame(t, tracks_img)
    return est, ids_out

  @property
  def live_track_count(self) -> int:
    return int((self.tracks[:, 0, fh.H_COUNT] > 0).sum())
