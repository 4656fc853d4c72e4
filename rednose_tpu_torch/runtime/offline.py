"""Offline log replay and multi-pass smoothing.

Port of rednose_tpu/runtime/offline.py. The reference README describes
offline use as "multiple forward and backwards passes" over a log
(README.md:41-45) but ships no driver for it. A log is a time-ordered
list of Observation records; `replay_log` runs them through a filter
facade and collects the 9-tuple estimates; `multipass_smooth` alternates
forward filtering and RTS smoothing, each new forward pass starting from
the previous backward pass's smoothed first state (the iterated
fixed-interval smoother).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence


@dataclasses.dataclass
class Observation:
  t: float
  kind: int
  data: Any
  R: Any = None  # None -> the filter's declared obs_noise for this kind


def replay_log(kf, log: Sequence[Observation]):
  """Run a log through a KalmanFilter facade; returns the estimate list
  (rejected or too-old observations are dropped, as a reference caller
  would drop them)."""
  estimates = []
  for obs in log:
    est = kf.predict_and_observe(obs.t, obs.kind, obs.data, R=obs.R)
    if est is not None:
      estimates.append(est)
  return estimates


def multipass_smooth(kf, log: Sequence[Observation], passes: int = 2,
                     norm_quats: bool = False, parallel: bool = False):
  """Iterated forward filter / backward smoother over a fixed log.

  Each pass filters forward, then RTS-smooths backward; the next pass
  starts from the smoothed earliest state, with the covariance kept at
  the filter's initial prior so no information is counted twice.
  Returns (smoothed list of (x, P), the final forward pass's estimates)."""
  if passes < 1:
    raise ValueError(f"passes must be >= 1, got {passes}")
  smoothed = estimates = None
  P0 = kf.filter.covs()
  for _ in range(passes):
    estimates = replay_log(kf, log)
    smoothed = kf.filter.rts_smooth(estimates, norm_quats=norm_quats,
                                    parallel=parallel)
    kf.filter.init_state(smoothed[0][0], P0, None)
  return smoothed, estimates
