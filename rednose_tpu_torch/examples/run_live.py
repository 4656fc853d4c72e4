"""live_kf demo: a static device with GNSS fixes and IMU, then offline RTS
smoothing (parallel-in-time). Port of examples/run_live.py.

    python -m rednose_tpu_torch.examples.run_live [--device cpu]
"""

import numpy as np

from rednose_tpu_torch.examples import cli
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K


def main(device="cuda"):
  rng = np.random.default_rng(0)
  kf = LiveKalman(device=device)
  pos0 = LiveKalman.initial_x[0:3]

  estimates = []
  t = 0.0
  for _ in range(100):
    t += 0.1
    estimates.append(kf.predict_and_observe(
        t, K.ECEF_POS, [pos0 + rng.normal(0, 1.0, 3)]))
    estimates.append(kf.predict_and_observe(t, K.NO_ROT, [np.zeros(3)]))

  pos_err = float(np.linalg.norm(kf.x[0:3] - pos0))
  quat_norm = float(np.linalg.norm(kf.x[3:7]))
  print(f"position error after 10 s: {pos_err:.3f} m, "
        f"quat norm {quat_norm:.6f}")

  smoothed = kf.rts_smooth(estimates, parallel=True)
  x0_smoothed = smoothed[0][0]
  smoothed_err = float(np.linalg.norm(x0_smoothed[0:3] - pos0))
  print(f"smoothed initial position error: {smoothed_err:.3f} m")
  return {"pos_err": pos_err, "quat_norm": quat_norm,
          "smoothed_err": smoothed_err}


if __name__ == "__main__":
  cli(main, __doc__)
