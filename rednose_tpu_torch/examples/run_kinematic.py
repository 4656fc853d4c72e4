"""Kinematic filter demo: the reference's example scenario
(examples/test_kinematic_kf.py), 5 s of sinusoidal motion with noisy
position measurements. Port of examples/run_kinematic.py. Set PLOT=1 to
plot (the reference's PLOT switch).

    python -m rednose_tpu_torch.examples.run_kinematic [--device cpu]
"""

import os

import numpy as np

from rednose_tpu_torch.examples import cli
from rednose_tpu_torch.models.kinematic import (
    KinematicKalman,
    ObservationKind,
    States,
)


def main(device="cuda"):
  np.random.seed(0)
  kf = KinematicKalman(device=device)

  dt = 0.01
  ts = np.arange(0, 5, step=dt)
  vs = np.sin(ts * 5)

  x = 0.0
  xs, xs_kf, xs_std = [], [], []
  for t, v in zip(ts, vs):
    kf.predict_and_observe(t, ObservationKind.POSITION,
                           [np.random.normal(x, 0.1)])
    xs.append(x)
    xs_kf.append(float(kf.x[States.POSITION].item()))
    xs_std.append(float(np.sqrt(kf.P[0, 0])))
    x += v * dt

  print(f"final position: {xs_kf[-1]:+.6f} (truth {xs[-1]:+.6f}), "
        f"std {xs_std[-1]:.4f}")

  if os.environ.get("PLOT"):
    import matplotlib.pyplot as plt

    xs, xs_kf, xs_std = map(np.array, (xs, xs_kf, xs_std))
    plt.plot(ts, xs, label="truth")
    plt.plot(ts, xs_kf, label="filtered")
    plt.fill_between(ts, xs_kf - xs_std, xs_kf + xs_std, alpha=0.2)
    plt.legend()
    plt.savefig("kinematic_kf.png")
    print("wrote kinematic_kf.png")
  return {"position": xs_kf[-1], "truth": xs[-1], "std": xs_std[-1]}


if __name__ == "__main__":
  cli(main, __doc__)
