"""MSCKF bank demo: B parallel sliding-window visual-inertial localizers
of the ESKF x MSCKF composition (models/msckf_eskf: quaternion error
state and a full-pose clone window) stepped together by
runtime/msckf_bank.MSCKFBank, in float64. A camera frame is predict,
nullspace-projected feature update and window augment; position fixes
interleave in the same run_mixed scan (kernel 6 with its camera-frame
unit on the card); one late frame exercises the out-of-order rewind and
replay and one too-old frame is dropped (kernel 7 at T = 1). Port of
examples/run_msckf_bank.py.

    python -m rednose_tpu_torch.examples.run_msckf_bank [--device cpu]
"""

import numpy as np
import torch

from rednose_tpu_torch.examples import cli, launch_counts, launched_since
from rednose_tpu_torch.models.msckf_eskf import (
    DIM_MAIN,
    MSCKFEskf,
    ObservationKind,
)
from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank

B = 64          # bank width (hypotheses / parallel streams)
T = 24          # camera frames
DT = 0.1
TRUTH_V = np.array([0.6, -0.4, 0.2])
LANDMARK = np.array([2.0, 1.0, 8.0])


def frame_obs(spec, truth_pos):
  """Feature track of the landmark from the TRUE clone window."""
  zt = []
  for a in range(spec.n_augment):
    cp = truth_pos - TRUTH_V * DT * (spec.n_augment - a)
    d = LANDMARK - cp
    zt.append([d[0] / d[2], d[1] / d[2]])
  return np.concatenate(zt)


def data():
  """The bank's initial states and its mixed schedule, drawn in the JAX
  script's order: (rng, xs (B, dim_x), kinds, kind_idx (T,), zs
  (T, B, max_dz), eas (T, B, ea_len), the final truth position). The rng
  goes on to draw the out-of-order frames' landmarks."""
  rng = np.random.RandomState(0)
  spec = MSCKFEskf.build_spec()
  om = spec.obs[int(ObservationKind.MSCKF_FEATURE)]

  # ground truth: a receiver drifting at constant velocity; the clone
  # window starts spread along the trajectory so features triangulate
  x0 = np.asarray(MSCKFEskf.initial_x, np.float64).copy()
  for a in range(spec.n_augment):
    o = DIM_MAIN + spec.dim_augment * a
    x0[o:o + 3] = -TRUTH_V * DT * (spec.n_augment - a)
  xs = np.tile(x0, (B, 1))
  xs[:, :3] += 0.5 * rng.randn(B, 3)  # per-lane initial position error

  # mixed schedule: camera frame, camera frame, position fix, ...
  kinds = (int(ObservationKind.POSITION), int(ObservationKind.MSCKF_FEATURE))
  kind_idx = np.array([1, 1, 0] * (T // 3), np.int32)
  Tm = kind_idx.shape[0]
  max_dz = max(om.dz, 3)
  zs = np.zeros((Tm, B, max_dz))
  eas = np.zeros((Tm, B, om.ea_len))
  pos = np.zeros(3)
  for t in range(Tm):
    pos = pos + TRUTH_V * DT
    if kind_idx[t] == 1:
      zs[t, :, :om.dz] = frame_obs(spec, pos)[None] + 0.002 * rng.randn(
          B, om.dz)
      eas[t] = LANDMARK[None] + 0.02 * rng.randn(B, 3)
    else:
      zs[t, :, :3] = pos[None] + 0.5 * rng.randn(B, 3)
  return rng, xs, kinds, kind_idx, zs, eas, pos


def main(device="cuda"):
  spec = MSCKFEskf.build_spec()
  rng, xs, kinds, kind_idx, zs, eas, pos = data()
  Tm = kind_idx.shape[0]
  bank = MSCKFBank(MSCKFEskf, batch=B, dtype=torch.float64, x0=xs,
                   ckpt_every=1, device=device)  # snapshot every frame

  before = launch_counts()
  err0 = float(np.linalg.norm(bank.x.cpu().numpy()[:, :3], axis=1).mean())
  bank.run_mixed(np.full((Tm,), DT), kind_idx, zs, kinds, eas=eas)
  err1 = float(np.linalg.norm(bank.x.cpu().numpy()[:, :3] - pos[None],
                              axis=1).mean())

  # out-of-order: a late camera frame inside the rewind window (it needs a
  # snapshot at or before its timestamp; the bulk run clears the ring, so
  # two in-order frames seed it first)
  t_now = bank.t
  bank.observe_frame(t_now + DT, frame_obs(spec, pos + TRUTH_V * DT),
                     LANDMARK + 0.02 * rng.randn(3))
  bank.observe_frame(t_now + 2 * DT, frame_obs(spec, pos + 2 * TRUTH_V * DT),
                     LANDMARK + 0.02 * rng.randn(3))
  late = bank.observe_frame(t_now + 1.5 * DT,
                            frame_obs(spec, pos + 1.5 * TRUTH_V * DT),
                            LANDMARK + 0.02 * rng.randn(3))
  dropped = bank.observe_frame(-10.0, frame_obs(spec, pos), LANDMARK)
  launched = launched_since(before)

  print(f"MSCKFBank[{B}] ESKFxMSCKF: mean position "
        f"error {err0:.2f} m -> {err1:.2f} m over {Tm} mixed steps "
        f"(frames+fixes); late frame {'replayed' if late else 'FAILED'}, "
        f"too-old frame {'dropped' if dropped is None else 'FAILED'}")
  assert err1 < err0 and late is not None and dropped is None
  return {"err0": err0, "err1": err1, "steps": Tm,
          "late_replayed": late is not None, "too_old_dropped": dropped is None,
          "launches": launched}


if __name__ == "__main__":
  cli(main, __doc__)
