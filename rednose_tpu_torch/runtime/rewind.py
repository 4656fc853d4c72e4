"""Rewind/replay checkpoint rings (host bookkeeping).

Port of rednose_tpu/runtime/rewind.py: the pure-Python PyRewindRing (the
reference's C++ engine checkpoint machinery, rednose/helpers/ekf_sym.cc:
119-156) and the sparse-snapshot BankRewindRing. The JAX package's native
`_rewind.cc` ring is not ported yet (ROADMAP); `RewindRing` is the Python
ring. Torch tensors are snapshotted by reference: every path of the port
replaces (x, P) with new tensors instead of writing into them.
"""

from __future__ import annotations

from bisect import bisect_right

# Number of checkpoints retained, matching the reference's REWIND_TO_KEEP
# (ekf_sym.py:447, ekf_sym.h:18).
REWIND_TO_KEEP = 512


class PyRewindRing:
  """Pure-Python rewind ring (same API as the native RewindRing)."""

  def __init__(self, capacity: int = REWIND_TO_KEEP):
    if capacity <= 0:
      raise ValueError("capacity must be positive")
    self.capacity = capacity
    self._t: list[float] = []
    self._state: list = []
    self._obs: list = []

  def __len__(self):
    return len(self._t)

  def checkpoint(self, t: float, state, obs):
    if self._t and t < self._t[-1]:
      raise ValueError("checkpoint time must be non-decreasing")
    self._t.append(t)
    self._state.append(state)
    self._obs.append(obs)
    if len(self._t) > self.capacity:
      k = len(self._t) - self.capacity
      del self._t[:k], self._state[:k], self._obs[:k]

  def rewind(self, t: float):
    """Roll back to the newest checkpoint with time <= t. Returns
    (t_restore, state_restore, replay_obs_oldest_first); dropped entries'
    observations are the replay list (ekf_sym.py:418-438 semantics)."""
    idx = bisect_right(self._t, t)
    if idx == 0:
      raise ValueError("rewind target older than ring")
    replay = self._obs[idx:]
    del self._t[idx:], self._state[idx:], self._obs[idx:]
    return self._t[-1], self._state[-1], replay

  def can_rewind(self, t: float, max_rewind_age: float) -> bool:
    return (len(self._t) > 0 and t >= self._t[0]
            and t >= self._t[-1] - max_rewind_age)

  def clear(self):
    self._t.clear()
    self._state.clear()
    self._obs.clear()

  def first_t(self):
    return self._t[0] if self._t else None

  def last_t(self):
    return self._t[-1] if self._t else None


def _state_nbytes(state) -> int:
  """Bytes retained by one snapshot: sum of .nbytes over array leaves of a
  (possibly nested tuple/list/dict) state pytree. Non-array leaves count 0."""
  nb = getattr(state, "nbytes", None)
  if nb is not None:
    return int(nb)
  if isinstance(state, (tuple, list)):
    return sum(_state_nbytes(s) for s in state)
  if isinstance(state, dict):
    return sum(_state_nbytes(v) for v in state.values())
  return 0


class BankRewindRing:
  """Sparse-checkpoint rewind ring for WIDE filter banks.

  The single-filter ring snapshots (x, P) at every observation — free for
  a 23-dim state, prohibitive for a B-wide bank (a live bank state is
  ~2 MB per 1k lanes). This ring keeps the full observation buffer but
  snapshots the bank state only every `ckpt_every` observations: a rewind
  restores the newest snapshot at-or-before the target time and hands back
  every buffered observation after it (oldest first), so replay re-applies
  at most `ckpt_every - 1` extra observations instead of the ring storing
  hundreds of bank states. The facades never write into a snapshotted
  tensor, so snapshots are references, not copies. Rewind window:
  ckpt_keep * ckpt_every observations back, clamped by max_rewind_age at
  can_rewind time — mirror of ekf_sym.cc:119-156 semantics at bank scale.

  Device-memory retention: each retained snapshot pins its tensors — the
  default ckpt_keep=8 on a B=65k live bank (x (23,B) f32 + P (22,22,B) f32
  ≈ 127 MB) holds ~1 GB. Bound it with `ckpt_bytes`: when the retained snapshot
  bytes exceed the budget, the OLDEST snapshots (and their now-unreachable
  observations) are dropped first, shrinking the rewind window instead of
  OOMing the device. At least one snapshot is always kept. `retained_bytes()`
  reports the current footprint.
  """

  def __init__(self, ckpt_every: int = 16, ckpt_keep: int = 8,
               ckpt_bytes: int | None = None):
    if ckpt_every <= 0 or ckpt_keep <= 0:
      raise ValueError("ckpt_every and ckpt_keep must be positive")
    if ckpt_bytes is not None and ckpt_bytes <= 0:
      raise ValueError("ckpt_bytes must be positive when given")
    self.ckpt_every = ckpt_every
    self.ckpt_keep = ckpt_keep
    self.ckpt_bytes = ckpt_bytes
    self._since_ckpt = 0
    self._ckpt_t: list[float] = []
    self._ckpt_state: list = []
    self._ckpt_idx: list[int] = []  # obs-buffer position AFTER the snapshot obs
    self._obs_t: list[float] = []
    self._obs: list = []

  def __len__(self):
    return len(self._obs_t)

  def record(self, t: float, state, obs):
    """Record an observation applied at time t, with `state` the bank state
    AFTER applying it. Snapshots the state every ckpt_every records."""
    if self._obs_t and t < self._obs_t[-1]:
      raise ValueError("record time must be non-decreasing")
    self._obs_t.append(t)
    self._obs.append(obs)
    if self._since_ckpt == 0:
      self._ckpt_t.append(t)
      self._ckpt_state.append(state)
      self._ckpt_idx.append(len(self._obs_t))
      keep = self.ckpt_keep
      if self.ckpt_bytes is not None:
        per = _state_nbytes(state)
        if per > 0:
          keep = min(keep, max(1, self.ckpt_bytes // per))
      if len(self._ckpt_t) > keep:
        self._trim_to(keep)
    self._since_ckpt = (self._since_ckpt + 1) % self.ckpt_every

  def _trim_to(self, keep: int):
    # trim to the new oldest snapshot: the obs up to and including the
    # one that produced it are never replayed (rewinds restore AT it)
    drop = self._ckpt_idx[-keep]
    del self._ckpt_t[:-keep]
    del self._ckpt_state[:-keep]
    del self._ckpt_idx[:-keep]
    del self._obs_t[:drop], self._obs[:drop]
    self._ckpt_idx = [i - drop for i in self._ckpt_idx]

  def retained_bytes(self) -> int:
    """Device bytes pinned by the retained snapshots."""
    return sum(_state_nbytes(s) for s in self._ckpt_state)

  def rewind(self, t: float):
    """Roll back to the newest snapshot with time <= t. Returns
    (t_restore, state_restore, replay_obs_oldest_first). The replayed
    observations (and newer snapshots) are removed; the caller re-applies
    them through record() as in the driver (ekf_sym.py:418-438)."""
    i = bisect_right(self._ckpt_t, t) - 1
    if i < 0:
      raise ValueError("rewind target older than ring")
    t_restore = self._ckpt_t[i]
    state = self._ckpt_state[i]
    idx = self._ckpt_idx[i]
    del self._ckpt_t[i + 1:], self._ckpt_state[i + 1:], self._ckpt_idx[i + 1:]
    replay = self._obs[idx:]
    del self._obs_t[idx:], self._obs[idx:]
    # the restored snapshot covers the current state; reduce mod the
    # cadence so ckpt_every == 1 keeps snapshotting every record
    self._since_ckpt = 1 % self.ckpt_every
    return t_restore, state, replay

  def can_rewind(self, t: float, max_rewind_age: float) -> bool:
    return (len(self._ckpt_t) > 0 and t >= self._ckpt_t[0]
            and (not self._obs_t or t >= self._obs_t[-1] - max_rewind_age))

  def clear(self):
    self._since_ckpt = 0
    self._ckpt_t.clear()
    self._ckpt_state.clear()
    self._ckpt_idx.clear()
    self._obs_t.clear()
    self._obs.clear()


RewindRing = PyRewindRing
