"""MSCKF x ESKF visual-odometry demo: a camera tracks landmarks while the
filter clones full poses (position and attitude) into its sliding window,
triangulates each complete track with the spec's compute_pos extra
routine and applies nullspace-projected feature updates. Port of
examples/run_msckf.py.

    python -m rednose_tpu_torch.examples.run_msckf [--device cpu]
"""

import numpy as np

from rednose_tpu_torch.examples import cli
from rednose_tpu_torch.models.msckf_eskf import (
    DIM_AUG,
    DIM_MAIN,
    N_AUGMENT,
    MSCKFEskf,
)


def main(device="cuda"):
  rng = np.random.default_rng(0)
  kf = MSCKFEskf(device=device)
  x0 = MSCKFEskf.initial_x.copy()
  x0[7:10] = [4.0, 0.5, 0.0]  # cruise velocity: spreads the clone window
  kf.init_state(x0, covs_diag=MSCKFEskf.initial_P_diag)

  # landmarks scattered ahead of the trajectory
  landmarks = np.column_stack([
      rng.uniform(-5, 25, 12), rng.uniform(-6, 6, 12), rng.uniform(8, 20, 12)])

  t, frames = 0.0, 20
  for frame in range(frames):
    t += 0.1
    x = kf.x
    clone_poses = [(x[DIM_MAIN + DIM_AUG * a: DIM_MAIN + DIM_AUG * a + 3],
                    x[DIM_MAIN + DIM_AUG * a + 3: DIM_MAIN + DIM_AUG * a + 7])
                   for a in range(N_AUGMENT)]
    tracks = []
    for lm in landmarks:
      obs = []
      for p, _q in clone_poses:  # identity-ish attitude in this demo
        d = lm - p
        if d[2] < 2.0:  # behind / too close from some clone: skip track
          break
        obs.append(d[:2] / d[2] + rng.normal(0, 0.005, 2))
      else:
        tracks.append(obs)
    kf.observe_camera_frame(t, np.asarray(tracks) if tracks
                            else np.zeros((0, N_AUGMENT, 2)))

  pos = kf.x[0:3].copy()
  pos_sigma = np.sqrt(np.diag(kf.P)[0:3])
  window = [float(v) for v in kf.filter.get_augment_times()]
  print(f"after {frames} camera frames: pos={np.round(pos, 2)} "
        f"sigma={np.round(pos_sigma, 3)} "
        f"(window times {kf.filter.get_augment_times()})")
  assert np.all(np.isfinite(kf.x))
  return {"pos": pos.tolist(), "sigma": pos_sigma.tolist(),
          "window": window}


if __name__ == "__main__":
  cli(main, __doc__)
