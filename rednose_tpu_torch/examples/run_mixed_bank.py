"""Heterogeneous sensor-fusion bank demo: independent live_kf ESKFs
stepping through a mixed gyro / accel / camera-rotation / position
schedule through the LiveKalmanBank facade; on the card it runs kernel 3
(ops/live_scan.live_bank_scan_mixed, a tile of 32 filters in shared
memory), on the host its plain torch version. Port of
examples/run_mixed_bank.py.

    python -m rednose_tpu_torch.examples.run_mixed_bank [--device cpu]
"""

import numpy as np
import torch

from rednose_tpu_torch.examples import (
    cli,
    launch_counts,
    launched_since,
    route_text,
)
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank

B, T = 512, 256
KINDS = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)


def data():
  """The schedule: kind_idx (T,), zs (T, B, 3)."""
  kind_idx = np.arange(T) % len(KINDS)
  rng = np.random.default_rng(0)
  noise = rng.normal(size=(T, B, 3))
  zs = np.where((kind_idx == 3)[:, None, None],
                LiveKalman.initial_x[0:3] + 5.0 * noise, 0.05 * noise)
  return kind_idx, zs


def main(device="cuda"):
  bank = LiveKalmanBank(batch=B, device=device)
  kind_idx, zs = data()
  before = launch_counts()
  bank.run_mixed(np.full((T,), 0.01), kind_idx, zs, KINDS)
  launched = launched_since(before)

  P_f = bank.P
  pos_var = float((P_f[:, 0, 0] + P_f[:, 1, 1] + P_f[:, 2, 2]).mean() / 3.0)
  quat_err = float((torch.linalg.vector_norm(bank.x[:, 3:7], dim=1)
                    - 1).abs().max())
  print(f"{B} filters x {T} mixed-kind steps ({route_text(launched)}): "
        f"mean position variance {pos_var:.3f} (prior 1e8), quat norms all "
        f"{quat_err:.1e} from unit, t={bank.t:.2f}s")
  assert bool(torch.isfinite(bank.x).all())
  return {"pos_var": pos_var, "quat_err": quat_err, "t": bank.t,
          "launches": launched}


if __name__ == "__main__":
  cli(main, __doc__)
