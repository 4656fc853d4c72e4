"""Full visual-odometry pipeline demo: a simulated feature tracker feeds
camera frames through the fixed-capacity track store into the MSCKF x
ESKF filter, detections in and pose estimates out. Port of
examples/run_vo_pipeline.py.

    python -m rednose_tpu_torch.examples.run_vo_pipeline [--device cpu]
"""

import numpy as np

from rednose_tpu_torch.examples import cli
from rednose_tpu_torch.models.msckf_eskf import N_AUGMENT, MSCKFEskf
from rednose_tpu_torch.msckf.pipeline import VisualOdometryPipeline


def main(device="cuda"):
  rng = np.random.default_rng(0)
  v0 = np.array([4.0, 0.5, 0.0])
  x0 = MSCKFEskf.initial_x.copy()
  x0[7:10] = v0

  kf = MSCKFEskf(device=device)
  kf.init_state(x0, covs_diag=MSCKFEskf.initial_P_diag, filter_time=0.0)
  pipe = VisualOdometryPipeline(kf, n_tracks=128, max_features=32)

  landmarks = np.column_stack([
      rng.uniform(-4, 40, 20), rng.uniform(-6, 6, 20),
      rng.uniform(10, 20, 20)])
  ids = np.full(len(landmarks), -1, dtype=np.int64)

  t, updates = 0.0, 0
  for frame in range(4 * N_AUGMENT):
    t += 0.1
    true_pos = v0 * t
    uvs = np.stack([(lm - true_pos)[:2] / (lm - true_pos)[2]
                    + rng.normal(0, 0.002, 2) for lm in landmarks])
    est, ids = pipe.process_frame(t, ids, uvs)
    if est is not None and len(est[7]):
      updates += 1

  err = float(np.linalg.norm(kf.x[0:3] - v0 * t))
  sigma = float(np.sqrt(np.diag(kf.P)[0:3]).max())
  print(f"{frame + 1} frames, {updates} feature updates, "
        f"{pipe.live_track_count} live tracks, dropped "
        f"{pipe.dropped_total}; position error vs truth {err:.3f} m "
        f"(sigma {sigma:.3f})")
  assert err < 0.3
  return {"frames": frame + 1, "updates": updates,
          "live_tracks": int(pipe.live_track_count),
          "dropped": int(pipe.dropped_total), "err": err, "sigma": sigma}


if __name__ == "__main__":
  cli(main, __doc__)
