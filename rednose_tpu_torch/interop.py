"""Carry state between the JAX package and the port.

Numpy in, tensor out (and back). The JAX kernels keep their banks and
streams folded as (..., 8, B/8) for the TPU's sublanes, with filter b at
(b // (B/8), b % (B/8)); a C-order reshape to (..., B) keeps that filter
order exactly, which is the port's bank-minor layout.
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


def bank_from_jax(x_packed, P_packed, dtype=torch.float32, device="cpu"):
  """A folded bank of the JAX kernels (pallas_live / pallas_bank: x
  (dx, 8, B/8), P (de, de, 8, B/8)) -> the port's x (dx, B), P (de, de, B)."""
  return (stream_from_jax(x_packed, dtype, device),
          stream_from_jax(P_packed, dtype, device))


def bank_to_jax(x, P):
  """The port's x (dx, B), P (de, de, B) -> the JAX kernels' folded numpy
  x (dx, 8, B/8), P (de, de, 8, B/8)."""
  return stream_to_jax(x), stream_to_jax(P)


def stream_from_jax(packed, dtype=torch.float32, device="cpu"):
  """Any folded JAX array (..., 8, B/8) -> (..., B): measurement streams
  (T, dz, 8, B/8), epoch streams (T, K, d, 8, B/8), eas likewise."""
  packed = np.asarray(packed)
  return _tensor(packed.reshape(packed.shape[:-2] + (-1,)), dtype, device)


def stream_to_jax(t):
  """(..., B) -> the folded numpy (..., 8, B/8)."""
  a = t.detach().cpu().numpy()
  return a.reshape(a.shape[:-1] + (SUBLANES, a.shape[-1] // SUBLANES))


def lane_bank_from_jax(x, P, dtype=torch.float32, device="cpu"):
  """A JAX lane bank (the lane paths of MSCKFBank / KalmanBank: x
  (B, dim_x), P (de, de, B)) -> the port's x (dim_x, B), P (de, de, B)."""
  return (_tensor(np.asarray(x).T, dtype, device),
          _tensor(P, dtype, device))


def model_constants_from_jax(model, dtype=torch.float32, device="cpu"):
  """A JAX model class's constants (initial_x, initial_P_diag, Q,
  obs_noise by kind) as tensors, so a test feeds both packages the same
  model values."""
  return dict(
      initial_x=_tensor(model.initial_x, dtype, device),
      initial_P_diag=_tensor(model.initial_P_diag, dtype, device),
      Q=_tensor(model.Q, dtype, device),
      obs_noise={int(k): _tensor(v, dtype, device)
                 for k, v in model.obs_noise.items()})


def tracks_from_jax(tracks, dtype=torch.float64, device="cpu"):
  """A JAX MSCKF track store (msckf/feature_handler.py, (n_tracks, K+1, 5))
  -> the port's store, the same layout."""
  return _tensor(tracks, dtype, device)


def tracks_to_jax(tracks):
  """The port's track store -> numpy (n_tracks, K+1, 5), which the JAX
  store functions take as it is."""
  return tracks.detach().cpu().numpy().copy()


# the live kernels' banks fold the same way
live_state_from_jax = bank_from_jax
live_state_to_jax = bank_to_jax


def params_from_jax(params, dtype=torch.float32, device="cpu"):
  """A spec params dict of the JAX package (floats or jnp scalars) -> the
  port's params, 0-d tensors (the form the bank scans pass to a spec)."""
  return {k: _tensor(v, dtype, device) for k, v in params.items()}


def bank_state_from_jax(state, dtype=torch.float32, device="cpu"):
  """A JAX BankState (x (B, dx), P (B, de, de), t (B,), epoch) -> the
  port's BankState with the same fields."""
  return BankState(x=_tensor(state.x, dtype, device),
                   P=_tensor(state.P, dtype, device),
                   t=_tensor(state.t, dtype, device),
                   epoch=float(state.epoch))
