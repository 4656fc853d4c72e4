"""Filter-bank demo: 4096 independent kinematic EKFs stepped together by
the bank oracle (runtime/bank: the per-filter step vmapped over the bank),
then the bank RMSE against the truth. Port of examples/run_bank.py, on
one device: the JAX script shards the bank over every device
(parallel/sharding), which the port has not yet; on one device that is
the same bank and a local mean.

    python -m rednose_tpu_torch.examples.run_bank [--device cpu]
"""

import numpy as np
import torch

from rednose_tpu_torch.examples import cli
from rednose_tpu_torch.models.kinematic import KinematicKalman, ObservationKind
from rednose_tpu_torch.runtime import bank
from rednose_tpu_torch.utils.device import resolve_device


def bank_rmse(state, truth):
  """sqrt(mean((x - truth)^2)) over every lane and state entry."""
  return torch.sqrt(((state.x - truth)**2).sum() / state.x.numel())


def main(device="cuda"):
  dev = resolve_device(device)
  rng = np.random.default_rng(0)
  spec = KinematicKalman.build_spec()
  T, B = 500, 4096

  state = bank.init_bank(spec, KinematicKalman.initial_x,
                         np.diag(KinematicKalman.initial_P_diag), batch=B,
                         dtype=torch.float32, device=dev)
  dts = torch.full((T,), 0.01, dtype=torch.float32, device=dev)
  zs = torch.as_tensor(rng.normal(0, 0.5, (T, B, 1)), dtype=torch.float32,
                       device=dev)
  Rs = torch.full((T, B, 1, 1), 0.01, dtype=torch.float32, device=dev)
  Q = torch.as_tensor(KinematicKalman.Q, dtype=torch.float32, device=dev)

  final, _ = bank.run_bank(spec, ObservationKind.POSITION, {}, state, Q,
                           dts, zs, Rs)
  rmse = float(bank_rmse(final, torch.zeros(2, device=dev)))
  print(f"{B} filters x {T} steps on 1 device(s); "
        f"bank RMSE vs truth: {rmse:.4f}")
  return {"devices": 1, "rmse": rmse}


if __name__ == "__main__":
  cli(main, __doc__)
