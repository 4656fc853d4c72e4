"""Kernel-vs-plain agreement measured in the filter's own uncertainty.

A raw difference says little for a bank whose state mixes metres at ECEF
scale (~4e6) with unit quaternions, and whose covariance spans 1e-8 to 1e8.
These helpers express a disagreement in standard deviations of the
reference result: a state difference as |dx_i| / sqrt(P_ii), a covariance
difference as |dP_ij| / sqrt(P_ii P_jj) (correlation units). Both read the
same for every component, so one stated tolerance covers them all. They
compute in float64.
"""

from __future__ import annotations

import torch
from torch.func import vmap

from rednose_tpu_torch.models.live import _inv_err


def _cov_err(P, P_ref):
  """max |P - P_ref| / sqrt(P_ref_ii P_ref_jj) over (de, de, B) banks."""
  d = torch.diagonal(P_ref, dim1=0, dim2=1).T.abs().sqrt()  # (de, B)
  return float(((P - P_ref).abs() / (d[:, None] * d[None, :])).max())


def kinematic_sigma_err(state, state_ref):
  """(state, cov) errors of two (5, B) kinematic bank states, in sigmas."""
  state, state_ref = state.double(), state_ref.double()
  sd = state_ref[2:5:2].abs().sqrt()                    # sqrt(P00), sqrt(P11)
  ex = float(((state[0:2] - state_ref[0:2]).abs() / sd).max())
  ep = float(((state[2:5] - state_ref[2:5]).abs()
              / torch.stack([sd[0] * sd[0], sd[0] * sd[1], sd[1] * sd[1]])
              ).max())
  return ex, ep


def live_sigma_err(x, P, x_ref, P_ref):
  """(state, cov) errors of two live banks x (23, B), P (22, 22, B), in
  sigmas; the state difference is the error state inv_err(x_ref, x)."""
  x, P, x_ref, P_ref = x.double(), P.double(), x_ref.double(), P_ref.double()
  dx = vmap(lambda n, t: _inv_err(None, n, t))(x_ref.T, x.T).T  # (22, B)
  sd = torch.diagonal(P_ref, dim1=0, dim2=1).T.abs().sqrt()
  return float((dx.abs() / sd).max()), _cov_err(P, P_ref)


def lane_sigma_errs(spec, x, P, x_ref, P_ref):
  """Per-lane (state, cov) errors, each (B,), of two banks of any spec, x
  (dim_x, B) and P (de, de, B), in sigmas of the reference; the state
  difference is the error state spec.inv_err(x_ref, x)."""
  x, P, x_ref, P_ref = x.double(), P.double(), x_ref.double(), P_ref.double()
  dx = vmap(lambda n, t: spec.inv_err({}, n, t))(x_ref.T, x.T).T
  sd = torch.diagonal(P_ref, dim1=0, dim2=1).T.abs().sqrt()   # (de, B)
  ex = (dx.abs() / sd).amax(dim=0)
  ep = ((P - P_ref).abs() / (sd[:, None] * sd[None, :])).amax(dim=(0, 1))
  return ex, ep
