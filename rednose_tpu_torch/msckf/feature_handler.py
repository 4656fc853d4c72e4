"""MSCKF feature-track bookkeeping: a fixed-capacity store, vectorized.

Port of rednose_tpu/msckf/feature_handler.py (the reference template
rednose/templates/feature_handler.c): a fixed store of n_tracks tracks x
(K+1) slots x 5 values on the device of its tensors, where slot 0 is a
header [count, last_feature_id, seen_this_frame, complete, valid] and slots
1..K hold raw feature rows [x, next_id, u, v, match_idx]. The reference's
sequential C loop (one feature at a time, a shared empty_idx counter)
becomes a data-parallel scatter: first-match detection by a scatter-min,
new-track slots by an exclusive cumsum into the caller's empty_idxs, with
the same results.

Semantics of merge_features (feature_handler.c:22-56):
  - a feature appends to track `match` iff that track's last_feature_id ==
    match and the track was not updated this frame yet; otherwise it
    starts a new track at the next empty slot;
  - where the C loop would append two features to one track, only the
    first (lowest index) appends and the later ones start new tracks;
  - a track reaching K observations is marked complete, and valid iff
    sane() accepts its motion (feature_handler.c:38-45).
One deliberate deviation, as in the JAX package: appends beyond K
observations are dropped (the C code would write out of bounds,
feature_handler.c:36-37).

Scatters: the JAX package writes with out-of-bounds sentinel rows that
`mode='drop'` discards. Here the store gets one extra sentinel row for the
duration of a merge, every dropped write goes there, and it is sliced off;
real targets are unique by construction (an append keeps the first claim
of a track, a new track takes the slot of its cumsum rank), so no write
depends on the order of duplicate indices. Plain torch ops; the JAX
package has no Pallas kernel here either.
"""

from __future__ import annotations

import torch

from rednose_tpu_torch.utils.device import resolve_device

# header column indices (slot 0)
H_COUNT, H_LAST_ID, H_SEEN, H_COMPLETE, H_VALID = 0, 1, 2, 3, 4

DEFAULT_N_TRACKS = 6000
DEFAULT_N_FEATURES = 3000


def empty_tracks(K: int, n_tracks: int = DEFAULT_N_TRACKS,
                 dtype=torch.float64, device="cuda"):
  """A store of n_tracks empty tracks of K observations, on the card unless
  the caller asks for another device."""
  return torch.zeros((n_tracks, K + 1, 5), dtype=dtype,
                     device=resolve_device(device))


def _sane_uv(u, v):
  """sane() on raw (..., K) u / v observation columns."""
  def bad(d):
    cur, prev = d[..., 1:], d[..., :-1]
    big = (cur > 0.05) | (prev > 0.05)
    ratio = (cur > 2.0 * prev) | (cur < 0.5 * prev)
    return (big & ratio).any(dim=-1)

  dx = (u[..., 1:] - u[..., :-1]).abs()
  dy = (v[..., 1:] - v[..., :-1]).abs()
  return ~(bad(dx) | bad(dy))


def sane(track):
  """Reject erratic inter-frame motion (feature_handler.c:1-20): adjacent
  |du| / |dv| ratios outside [0.5, 2] while either exceeds 0.05. track
  (..., K+1, 5) -> (...) bool."""
  return _sane_uv(track[..., 1:, 2], track[..., 1:, 3])


def reset_seen(tracks):
  """Clear the per-frame 'seen' header bit before merging a new frame
  (returns a new store)."""
  out = tracks.clone()
  out[:, 0, H_SEEN] = 0.0
  return out


def merge_features(tracks, features, empty_idxs):
  """Merge one frame of features into the track store.

  tracks (n_tracks, K+1, 5); features (n_features, 5) rows [x, next_id, u,
  v, match_idx], rows with match_idx < 0 are padding; empty_idxs integer
  indices of empty track slots, consumed in order by new tracks, entries
  >= n_tracks being sentinels for "no slot" (empty_slots pads with them).
  Returns (tracks, n_dropped): a new store and, as a 0-d tensor, the number
  of new tracks that could not start because the supplied slots ran out
  (counted and dropped, never collided on the last slot)."""
  n_tracks, K1, _ = tracks.shape
  K = K1 - 1
  nf = features.shape[0]
  dtype, dev = tracks.dtype, tracks.device
  features = features.to(dtype)

  match = features[:, 4].to(torch.int64)
  live = match >= 0
  match_c = match.clamp(0, n_tracks - 1)

  hdr = tracks[match_c, 0]                                       # (nf, 5)
  matched = ((hdr[:, H_LAST_ID] == match_c.to(dtype))
             & (hdr[:, H_SEEN] == 0.0) & live)
  appendable = matched & (hdr[:, H_COUNT] < K)
  # features matching an already complete track are dropped (the C loop
  # would write out of bounds, feature_handler.c:36-37; callers harvest
  # complete tracks before the next merge)
  dropped_full = matched & (hdr[:, H_COUNT] >= K)

  # the first feature index claiming each track (C loop order: lowest wins)
  order = torch.arange(nf, dtype=torch.int64, device=dev)
  claim = torch.where(appendable, match_c, n_tracks)  # others: overflow bin
  first = torch.full((n_tracks + 1,), nf, dtype=torch.int64,
                     device=dev).scatter_reduce(0, claim, order, "amin",
                                                include_self=True)
  is_append = appendable & (first[match_c] == order)

  # one sentinel row (index n_tracks) takes every dropped write
  st = torch.cat([tracks, tracks.new_zeros((1, K1, 5))])

  # ---- appends
  tgt = torch.where(is_append, match_c, n_tracks)
  new_count = hdr[:, H_COUNT] + 1.0
  slot = torch.where(is_append, new_count.to(torch.int64), 0)
  st[tgt, 0, H_COUNT] = new_count
  st[tgt, 0, H_LAST_ID] = features[:, 1]
  st[tgt, 0, H_SEEN] = 1.0
  st[tgt, slot] = features

  completed = is_append & (new_count == float(K))
  st[torch.where(completed, match_c, n_tracks), 0, H_COMPLETE] = 1.0
  # validity: sane() over the post-append track, where just completed
  sane_all = sane(st[match_c])
  st[torch.where(completed & sane_all, match_c, n_tracks), 0, H_VALID] = 1.0

  # ---- new tracks
  is_new = live & ~is_append & ~dropped_full
  rank = torch.cumsum(is_new.to(torch.int64), 0) - 1
  empty_idxs = empty_idxs.to(device=dev, dtype=torch.int64)
  n_slots = empty_idxs.shape[0]
  in_range = is_new & (rank < n_slots)
  slot_idx = empty_idxs[rank.clamp(0, n_slots - 1)]
  slot_idx = torch.where(in_range, slot_idx, n_tracks)
  # dropped: ran past the supplied slots, or landed on a sentinel entry
  n_dropped = (is_new & (slot_idx >= n_tracks)).sum()
  slot_idx = slot_idx.clamp(max=n_tracks)
  one, zero = torch.ones_like(features[:, 1]), torch.zeros_like(features[:, 1])
  st[slot_idx, 0] = torch.stack([one, features[:, 1], one, zero, zero], 1)
  st[slot_idx, 1] = features
  return st[:n_tracks], n_dropped


def _compact_indices(mask, m: int):
  """The first m indices where mask is True, ascending, padded with n =
  mask.numel(): the running count c = cumsum(mask) is nondecreasing, so
  the j-th set index is the first position where c reaches j + 1."""
  c = torch.cumsum(mask.to(torch.int64), 0)
  want = torch.arange(1, m + 1, dtype=torch.int64, device=mask.device)
  return torch.searchsorted(c, want, side="left")


def empty_slots(tracks, n_features: int = DEFAULT_N_FEATURES):
  """Indices of up to n_features empty track slots (count == 0), padded
  with n_tracks: the bookkeeping the reference leaves to the caller."""
  return _compact_indices(tracks[:, 0, H_COUNT] == 0.0, n_features)


def harvest_complete(tracks, max_out: int):
  """Pull up to max_out complete and valid tracks and clear every complete
  row (valid or not) from the store. Returns (idxs, uv, tracks): idxs
  (max_out,) ascending track indices padded with n_tracks, uv
  (max_out, K, 2) their observation rows, oldest first (padding rows read
  track 0; callers mask on idxs), and the cleared store (a mask-multiply,
  as in the JAX package)."""
  n_tracks = tracks.shape[0]
  hdr = tracks[:, 0]
  complete = hdr[:, H_COMPLETE] == 1.0
  done = complete & (hdr[:, H_VALID] == 1.0)
  idxs = _compact_indices(done, max_out)
  uv = tracks[idxs.clamp(0, n_tracks - 1), 1:, 2:4]
  tracks = tracks * (~complete)[:, None, None].to(tracks.dtype)
  return idxs, uv, tracks
