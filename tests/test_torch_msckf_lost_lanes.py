"""The msckf_eskf lanes that chip_smoke.py's MSCKF path loses on
consistent data (a few per thousand by 32-72 frames, in float64 too):
chip_smoke.msckf_frames' scenario rebuilt on the CPU in float64 (the
bench entry's bank, B = 2048, each lane's truth 0.3 sigma of P0 from its
estimate, the camera moving at 1 m/s, a landmark 6 m ahead every frame,
72 frames), run through the JAX package's MSCKFBank(use_pallas=False)
.run_frames and through the port's MSCKFBank on CPU tensors (its plain
version), and the lost lanes (beyond 10 sigma of their truth, or not
finite) compared. Both lose the same lanes, and the kept lanes agree to
rounding: the loss is the model's on this data, not the port's."""

import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke as cs
from rednose_tpu.models.msckf_eskf import MSCKFEskf as JEskf
from rednose_tpu.runtime.msckf_bank import MSCKFBank as JBank
from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank
from torch_parity import np_

B, T = 2048, 72


def test_msckf_eskf_loses_the_same_lanes_as_the_reference():
  spec, _, Q, R = cs.msckf_setup(MSCKFEskf)
  xs = cs.msckf_bank_x0(MSCKFEskf, cs.SEED, batch=B)
  gen = torch.Generator()
  gen.manual_seed(cs.SEED + 2)
  zs, eas, truths = cs.msckf_frames(torch, "cpu", gen, MSCKFEskf, xs, T, R)
  P_diag = np.full(spec.dim_err, cs.MSCKF_P0)
  dts = np.full(T, cs.MSCKF_DT)
  ours = MSCKFBank(MSCKFEskf, batch=B, x0=xs, P_diag=P_diag, Q=Q,
                   device="cpu", dtype=torch.float64)
  ours.run_frames(dts, zs, eas, R=R)
  ref = JBank(JEskf, batch=B, x0=xs, P_diag=P_diag, Q=Q, dtype=jnp.float64,
              use_pallas=False)
  ref.run_frames(dts, np_(zs), np_(eas), R=R)
  x_ref = torch.as_tensor(np.asarray(ref._x).T.copy())
  P_ref = torch.as_tensor(np.asarray(ref._P))
  lost = cs.msckf_lost_lanes(torch, spec, ours._x, ours._P, truths[-1])
  lost_ref = cs.msckf_lost_lanes(torch, spec, x_ref, P_ref, truths[-1])
  assert torch.equal(lost, lost_ref), (
      f"port loses lanes {lost.nonzero().flatten().tolist()}, the JAX "
      f"package {lost_ref.nonzero().flatten().tolist()}")
  # the scenario does lose lanes, as on the card, and few
  assert 0 < int(lost.sum()) <= cs.MSCKF_LOST_SHARE * B
  keep = ~lost
  np.testing.assert_allclose(np_(ours._x[:, keep]), np_(x_ref[:, keep]),
                             rtol=1e-6, atol=1e-7)
  np.testing.assert_allclose(np_(ours._P[:, :, keep]),
                             np_(P_ref[:, :, keep]), rtol=1e-6, atol=1e-9)
