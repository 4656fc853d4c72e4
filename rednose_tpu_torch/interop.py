"""Carry state between the JAX package and the port.

Numpy in, tensor out (and back). The JAX kernels keep their banks folded
as (..., 8, B/8) for the TPU's sublanes, with filter b at (b // (B/8),
b % (B/8)); a C-order reshape to (..., B) keeps that filter order exactly,
which is the port's bank-minor layout.
"""

from __future__ import annotations

import numpy as np
import torch

from rednose_tpu_torch.runtime.bank import BankState

SUBLANES = 8


def _tensor(a, dtype, device):
  return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def kinematic_state_from_jax(packed, dtype=torch.float32, device="cpu"):
  """pallas_step packed state (40, B/8) -> kinematic_scan state (5, B)."""
  packed = np.asarray(packed)
  return _tensor(packed.reshape(5, -1), dtype, device)


def kinematic_state_to_jax(state):
  """kinematic_scan state (5, B) -> pallas_step packed (40, B/8) numpy."""
  s = state.detach().cpu().numpy()
  return s.reshape(5 * SUBLANES, s.shape[1] // SUBLANES)


def live_state_from_jax(x_packed, P_packed, dtype=torch.float32,
                        device="cpu"):
  """pallas_live packed x (23, 8, B/8), P (22, 22, 8, B/8) ->
  live_scan x (23, B), P (22, 22, B)."""
  x_packed, P_packed = np.asarray(x_packed), np.asarray(P_packed)
  return (_tensor(x_packed.reshape(x_packed.shape[0], -1), dtype, device),
          _tensor(P_packed.reshape(P_packed.shape[:2] + (-1,)), dtype,
                  device))


def live_state_to_jax(x, P):
  """live_scan x (23, B), P (22, 22, B) -> pallas_live packed numpy."""
  x, P = x.detach().cpu().numpy(), P.detach().cpu().numpy()
  bsub = x.shape[1] // SUBLANES
  return (x.reshape(x.shape[0], SUBLANES, bsub),
          P.reshape(P.shape[:2] + (SUBLANES, bsub)))


def bank_state_from_jax(state, dtype=torch.float32, device="cpu"):
  """A JAX BankState (x (B, dx), P (B, de, de), t (B,), epoch) -> the
  port's BankState with the same fields."""
  return BankState(x=_tensor(state.x, dtype, device),
                   P=_tensor(state.P, dtype, device),
                   t=_tensor(state.t, dtype, device),
                   epoch=float(state.epoch))
