"""GNSS localizer demo (the downstream loc_kf pattern): a moving receiver
tracked from pseudoranges and pseudorange rates alone, the PSEUDORANGE
kinds the reference enumerates (live_kf.py:24-41), with per-measurement
satellite states through the extra-args path; then the same workload at
bank scale (`bank_demo`). Port of examples/run_loc.py.

    python -m rednose_tpu_torch.examples.run_loc [--device cpu]
"""

import numpy as np
import torch

from rednose_tpu_torch.examples import (
    cli,
    launch_counts,
    launched_since,
    route_text,
)
from rednose_tpu_torch.models.live import ObservationKind as K
from rednose_tpu_torch.models.loc import LocKalman

BANK_B, BANK_T = 64, 16


def main(device="cuda"):
  rng = np.random.RandomState(0)
  kf = LocKalman(device=device)
  eng = kf.filter

  truth_p0 = LocKalman.initial_x[:3] + np.array([120.0, -80.0, 45.0])
  truth_v = np.array([4.0, -2.5, 1.0])
  truth_bias, truth_drift = 230.0, 1.1
  sat_dirs = rng.randn(7, 3)
  sat_dirs /= np.linalg.norm(sat_dirs, axis=1, keepdims=True)
  sat_vels = 120.0 * rng.randn(7, 3)

  dt, T = 0.1, 250
  for i in range(T):
    t = dt * (i + 1)
    pos = truth_p0 + truth_v * t
    bias = truth_bias + truth_drift * t
    for s in range(7):
      sp = sat_dirs[s] * 2.66e7 + sat_vels[s] * t
      d = pos - sp
      u = d / np.linalg.norm(d)
      rho = np.linalg.norm(d) + bias + 2.0 * rng.randn()
      rate = u @ (truth_v - sat_vels[s]) + truth_drift + 0.05 * rng.randn()
      eng.predict_and_update_batch(t, int(K.PSEUDORANGE_GPS), [[rho]],
                                   [np.atleast_2d(4.0)], extra_args=[sp])
      eng.predict_and_update_batch(
          t, int(K.PSEUDORANGE_RATE_GPS), [[rate]],
          [np.atleast_2d(0.05**2)], extra_args=[np.concatenate([sp,
                                                                sat_vels[s]])])

  x = eng.state()
  pos_true = truth_p0 + truth_v * dt * T
  pos_err = float(np.linalg.norm(x[:3] - pos_true))
  vel_err = float(np.linalg.norm(x[3:6] - truth_v))
  bias_err = float(abs(x[6] - (truth_bias + truth_drift * dt * T)))
  drift_err = float(abs(x[7] - truth_drift))
  print(f"run_loc: after {T} epochs x 7 satellites — position error "
        f"{pos_err:.2f} m, velocity error {vel_err:.3f} m/s, clock bias "
        f"error {bias_err:.2f} m, drift error {drift_err:.3f} m/s")
  # Pseudoranges live at 2.66e7 m, where a float32 ulp is ~2 m: on a
  # float32 engine position and clock-bias accuracy is quantization-limited
  # (tens of metres); in float64 (the engine's default) position converges
  # to metres.
  f64 = eng.dtype == torch.float64
  pos_tol, bias_tol = (5.0, 5.0) if f64 else (80.0, 25.0)
  assert pos_err < pos_tol and bias_err < bias_tol
  assert vel_err < 0.5 and drift_err < 0.3

  out = {"pos_err": pos_err, "vel_err": vel_err, "bias_err": bias_err,
         "drift_err": drift_err}
  return out | bank_demo(device)


def bank_demo_data():
  """bank_demo's receivers and GNSS schedule: kinds, kind_idx (T,),
  zs (T, B, 1), eas (T, B, 6) satellite position and velocity, truth
  (B, 3)."""
  rng = np.random.RandomState(1)
  B, T = BANK_B, BANK_T
  kinds = (int(K.PSEUDORANGE_GPS), int(K.PSEUDORANGE_RATE_GPS))
  kind_idx = np.arange(T, dtype=np.int32) % 2
  truth = LocKalman.initial_x[:3] + 50.0 * rng.randn(B, 3)
  sat_pos = LocKalman.initial_x[:3][None, None] + 2.66e7 * rng.randn(T, B, 3)
  sat_vel = 3e3 * rng.randn(T, B, 3)
  eas = np.concatenate([sat_pos, sat_vel], axis=-1)
  d = truth[None] - sat_pos
  u = d / np.linalg.norm(d, axis=-1, keepdims=True)
  zs = np.where(
      (kind_idx % 2 == 0)[:, None],
      np.linalg.norm(d, axis=-1) + LocKalman.initial_x[6]
      + 2.0 * rng.randn(T, B),
      np.sum(u * (0.0 - sat_vel), axis=-1) + LocKalman.initial_x[7]
      + 0.05 * rng.randn(T, B))[..., None]
  return kinds, kind_idx, zs, eas, truth


def bank_demo(device="cuda"):
  """The same GNSS workload at bank scale: B independent receivers through
  KalmanBank's mixed schedule (kernel 6 on the card, float32),
  pseudorange and rate epochs interleaved with per-lane satellite
  states."""
  from rednose_tpu_torch.runtime.generic_bank import KalmanBank

  kinds, kind_idx, zs, eas, truth = bank_demo_data()
  B, T = BANK_B, BANK_T
  bank = KalmanBank(LocKalman, batch=B, device=device)
  before = launch_counts()
  bank.run_mixed(np.full(T, 0.1), kind_idx, zs, kinds, eas=eas)
  launched = launched_since(before)
  x = bank.x.double().cpu().numpy()
  assert np.isfinite(x).all()
  err0 = float(np.linalg.norm(LocKalman.initial_x[None, :3] - truth,
                              axis=1).mean())
  err1 = float(np.linalg.norm(x[:, :3] - truth, axis=1).mean())
  print(f"run_loc bank: {B} receivers x {T} mixed epochs "
        f"({route_text(launched)}) — mean position error "
        f"{err0:.1f} -> {err1:.1f} m")
  assert err1 < err0
  return {"bank_err0": err0, "bank_err1": err1, "launches": launched}


if __name__ == "__main__":
  cli(main, __doc__)
