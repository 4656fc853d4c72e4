"""Filter-bank demo: 4096 independent kinematic EKFs stepped together by
runtime/bank.run_bank (on the card one launch of kernel 15 for the T
steps, on the host the per-filter step vmapped over the bank), sharded
over every rank of the mesh (parallel/sharding), then the bank RMSE
against the truth as a collective. Port of examples/run_bank.py.
One process is a mesh of one rank; under torchrun each rank runs its
block of the bank on its own card:

    python -m rednose_tpu_torch.examples.run_bank [--device cpu]
    torchrun --nproc-per-node N -m rednose_tpu_torch.examples.run_bank
"""

import numpy as np
import torch

from rednose_tpu_torch.examples import cli
from rednose_tpu_torch.models.kinematic import KinematicKalman, ObservationKind
from rednose_tpu_torch.parallel import sharding
from rednose_tpu_torch.runtime import bank


def main(device="cuda"):
  rng = np.random.default_rng(0)
  spec = KinematicKalman.build_spec()
  T, B = 500, 4096

  state = bank.init_bank(spec, KinematicKalman.initial_x,
                         np.diag(KinematicKalman.initial_P_diag), batch=B,
                         dtype=torch.float32, device="cpu")
  dts = torch.full((T,), 0.01, dtype=torch.float32)
  zs = torch.as_tensor(rng.normal(0, 0.5, (T, B, 1)), dtype=torch.float32)
  Rs = torch.full((T, B, 1, 1), 0.01, dtype=torch.float32)
  Q = torch.as_tensor(KinematicKalman.Q, dtype=torch.float32)

  mesh = sharding.make_bank_mesh(device)
  final, _ = sharding.sharded_run_bank(
      spec, ObservationKind.POSITION, mesh, {}, state, Q, dts, zs, Rs)
  rmse = float(sharding.sharded_bank_rmse(mesh, final, np.zeros(2)))
  print(f"{B} filters x {T} steps on {mesh.size()} device(s); "
        f"bank RMSE vs truth: {rmse:.4f}")
  return {"devices": mesh.size(), "rmse": rmse}


if __name__ == "__main__":
  cli(main, __doc__)
