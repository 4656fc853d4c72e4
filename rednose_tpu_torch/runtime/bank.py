"""Filter banks by vmap: the bank oracle.

Port of rednose_tpu/runtime/bank.py. The per-filter step from core/step.py
is vmapped over a leading bank axis with torch.func.vmap and looped over
time in Python (JAX scans it with lax.scan). This is the reference every
bank kernel is checked against, not a fast path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import vmap

from rednose_tpu_torch.core import step as step_ops
from rednose_tpu_torch.core.spec import FilterSpec


@dataclasses.dataclass
class BankState:
  """State of B independent filters: x (B, dim_x), P (B, dim_err, dim_err),
  t (B,) seconds SINCE `epoch` (a host float64, so epoch-scale absolute
  times keep their precision in f32 lanes). Absolute time = epoch + t."""
  x: torch.Tensor
  P: torch.Tensor
  t: torch.Tensor
  epoch: float = 0.0

  @property
  def batch(self) -> int:
    return self.x.shape[0]

  def absolute_t(self):
    return self.epoch + self.t.detach().cpu().numpy().astype(np.float64)


def init_bank(spec: FilterSpec, x0, P0, batch: int, t0=0.0,
              dtype=torch.float32, device="cuda") -> BankState:
  """Broadcast one initial (x0, P0) to a B-wide bank; t0 becomes the epoch."""
  x0 = torch.as_tensor(np.asarray(x0), dtype=dtype, device=device)
  P0 = torch.as_tensor(np.asarray(P0), dtype=dtype, device=device)
  if x0.shape != (spec.dim_x,) or P0.shape != (spec.dim_err, spec.dim_err):
    raise ValueError(f"x0 {tuple(x0.shape)} / P0 {tuple(P0.shape)} do not "
                     f"fit spec {spec.name!r}")
  return BankState(
      x=x0.expand(batch, spec.dim_x).clone(),
      P=P0.expand(batch, spec.dim_err, spec.dim_err).clone(),
      t=torch.zeros((batch,), dtype=dtype, device=device),
      epoch=float(t0),
  )


def bank_predict_and_update(spec: FilterSpec, kind: int, params,
                            state: BankState, Q, dt, z, R, ea):
  """One fused predict+update across the whole bank.

  dt (B,) or scalar; z (B, dz); R (B, dz, dz); ea (B, ea_dim).
  Returns (new_state, y (B, dz)).
  """
  x = state.x
  dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device).expand(state.batch)

  def one(x, P, dt_i, z_i, R_i, ea_i):
    x_p, P_p = step_ops.predict(spec, params, x, P, Q, dt_i)
    return step_ops.update(spec, kind, params, x_p, P_p, z_i, R_i, ea_i)

  x_new, P_new, y = vmap(one)(x, state.P, dt, z, R, ea)
  return BankState(x=x_new, P=P_new, t=state.t + dt, epoch=state.epoch), y


def run_bank(spec: FilterSpec, kind: int, params, state: BankState, Q,
             dts, zs, Rs, eas=None):
  """T steps over a B-wide bank. dts (T,), zs (T, B, dz),
  Rs (T, B, dz, dz) or (T, dz, dz) shared. Returns (final BankState,
  ys (T, B, dz))."""
  om = spec.obs[kind]
  T, B = zs.shape[0], state.batch
  if Rs.ndim == 3:
    Rs = Rs[:, None].expand(T, B, om.dz, om.dz)
  if eas is None:
    eas = torch.zeros((T, B, max(om.ea_len, 1)), dtype=state.x.dtype,
                      device=state.x.device)
  ys = []
  for k in range(T):
    state, y = bank_predict_and_update(spec, kind, params, state, Q, dts[k],
                                       zs[k], Rs[k], eas[k])
    ys.append(y)
  return state, torch.stack(ys)

