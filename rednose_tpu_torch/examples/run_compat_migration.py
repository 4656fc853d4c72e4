"""Migration demo: a reference-style sympy filter, unchanged, on the card.

Port of examples/run_compat_migration.py. The filter is written the way a
commaai/rednose user writes one (examples/kinematic_kf.py:36-81): a
KalmanFilter subclass with class-attribute config, a `generate_code`
staticmethod that builds sympy dynamics and calls gen_code, and an
`__init__` that constructs EKF_sym_pyx. The only changes from the
reference pattern are the import lines and the device argument:
rednose_tpu_torch.compat lowers the same symbolic inputs to torch
(frontend/sympy_spec.py) and runs them on the port's engine.

    python -m rednose_tpu_torch.examples.run_compat_migration [--device cpu]
"""

import numpy as np
import sympy as sp

from rednose_tpu_torch.compat import EKF_sym_pyx, gen_code
from rednose_tpu_torch.examples import cli
from rednose_tpu_torch.models.kalman_filter import KalmanFilter

# the reference's published goldens (test_kinematic_kf.py:52-55)
GOLDEN = (-0.010866289677966417, -0.8553720537261753)


class ObservationKind:
  POSITION = 1


class States:
  POSITION = slice(0, 1)
  VELOCITY = slice(1, 2)


class MigratedKinematicKalman(KalmanFilter):
  name = 'kinematic_migrated'

  initial_x = np.array([0.5, 0.0])
  initial_P_diag = np.array([1.0**2, 1.0**2])
  Q = np.diag([0.1**2, 2.0**2])
  obs_noise = {ObservationKind.POSITION: np.atleast_2d(0.1**2)}

  @staticmethod
  def generate_code(generated_dir):
    dim_state = MigratedKinematicKalman.initial_x.shape[0]
    state_sym = sp.MatrixSymbol('state', dim_state, 1)
    state = sp.Matrix(state_sym)
    dt = sp.Symbol('dt')

    state_dot = sp.Matrix(np.zeros((dim_state, 1)))
    state_dot[States.POSITION.start, 0] = state[States.VELOCITY.start, 0]
    f_sym = state + dt * state_dot

    obs_eqs = [
        [sp.Matrix([state[States.POSITION.start, 0]]),
         ObservationKind.POSITION, None],
    ]
    gen_code(generated_dir, MigratedKinematicKalman.name, f_sym, dt,
             state_sym, obs_eqs, dim_state, dim_state)

  def __init__(self, generated_dir=None, device="cuda"):
    self.generate_code(generated_dir)
    dim_state = self.initial_x.shape[0]
    self.filter = EKF_sym_pyx(
        generated_dir, self.name, self.Q, self.initial_x,
        np.diag(self.initial_P_diag), dim_state, dim_state, device=device)


def main(device="cuda"):
  np.random.seed(0)
  kf = MigratedKinematicKalman(device=device)

  dt = 0.01
  ts = np.arange(0, 5, step=dt)
  vs = np.sin(ts * 5)
  x = 0.0
  for t, v in zip(ts, vs):
    kf.predict_and_observe(t, ObservationKind.POSITION,
                           [np.random.normal(x, 0.1)])
    x += v * dt

  state, std = kf.x, np.sqrt(np.diag(kf.P))
  print(f"final position {state[0]:+.6f} (true {x:+.6f}, std {std[0]:.4f})")
  print(f"final velocity {state[1]:+.6f} (std {std[1]:.4f})")
  # the engine runs in float64, so the 7-decimal check of the JAX
  # package's float64 run holds here too
  tol = 1e-7
  assert abs(state[0] - GOLDEN[0]) < tol
  assert abs(state[1] - GOLDEN[1]) < tol
  print(f"matches the reference's golden values to {tol:g} "
        "(test_kinematic_kf.py:52-55)")
  return {"position": float(state[0]), "truth": float(x),
          "position_std": float(std[0]), "velocity": float(state[1]),
          "velocity_std": float(std[1])}


if __name__ == "__main__":
  cli(main, __doc__)
