"""Vehicle parameter identification demo (the paramsd pattern): steer
ratio, tire-stiffness factor and steering-angle offset estimated online
from yaw-rate and small-slip observations, with speed and steering set
per tick through runtime params. Port of examples/run_car.py.

    python -m rednose_tpu_torch.examples.run_car [--device cpu]
"""

import numpy as np

from rednose_tpu_torch.examples import cli
from rednose_tpu_torch.models.car import (
    DEFAULT_PARAMS,
    CarKalman,
    ObservationKind,
)

TRUE_SR, TRUE_SF, TRUE_AO = 17.5, 0.82, 1.8


def _truth_step(vy, r, u, steer_deg, dt):
  """Independent ground-truth single-track integrator (finer substeps)."""
  p = DEFAULT_PARAMS
  m, j = p['mass'], p['rot_inertia']
  cF, cR = TRUE_SF * p['cF0'], TRUE_SF * p['cR0']
  aF, aR = p['aF'], p['aR']
  sa = np.deg2rad(steer_deg - TRUE_AO) / TRUE_SR
  for _ in range(10):
    vy_dot = (-(cF + cR) / (m * u) * vy
              + ((aR * cR - aF * cF) / (m * u) - u) * r + cF / m * sa)
    r_dot = ((aR * cR - aF * cF) / (j * u) * vy
             - (aF * aF * cF + aR * aR * cR) / (j * u) * r
             + aF * cF / j * sa)
    vy, r = vy + dt / 10 * vy_dot, r + dt / 10 * r_dot
  return vy, r


def main(device="cuda"):
  rng = np.random.RandomState(0)
  kf = CarKalman(device=device)
  dt = 0.05
  vy = r = 0.0
  t = 0.0
  for i in range(1200):
    t += dt
    steer = 45.0 * np.sin(0.25 * t) + 20.0 * np.sin(1.1 * t)
    u = 18.0 + 8.0 * np.sin(0.05 * t)
    vy, r = _truth_step(vy, r, u, steer, dt)
    kf.set_inputs(u, steer)
    kf.predict_and_observe(t, ObservationKind.YAW_RATE,
                           [r + rng.normal(0, 0.001)])
    if i % 5 == 0:
      kf.predict_and_observe(t + dt / 4, ObservationKind.LATERAL_SLIP,
                             [vy + rng.normal(0, 0.1)])
      t += dt / 4

  sR, sf, ao = (float(v) for v in kf.x[:3])
  std = np.sqrt(np.diag(kf.P))
  print(f"steer ratio      {sR:6.2f} +- {std[0]:.2f}  (true {TRUE_SR})")
  print(f"stiffness factor {sf:6.3f} +- {std[1]:.3f}  (true {TRUE_SF})")
  print(f"angle offset     {ao:6.2f} +- {std[2]:.2f}  (true {TRUE_AO})")
  return {"steer_ratio": sR, "steer_ratio_std": float(std[0]),
          "stiffness": sf, "stiffness_std": float(std[1]),
          "angle_offset": ao, "angle_offset_std": float(std[2])}


if __name__ == "__main__":
  cli(main, __doc__)
