"""Disk checkpoint / resume for filters and banks.

Port of rednose_tpu/runtime/checkpoint.py, with the same `.npz` format, so
a bank or filter saved by one package loads in the other:
  bank:   x (B, dim_x), P (B, de, de), t (B,), epoch
  filter: x, P, filter_time (NaN for None), augment_times, n_params,
          param_<i>, param_keys (flat string-keyed params, sorted keys)
"""

from __future__ import annotations

import numpy as np
import torch

from rednose_tpu_torch.runtime.bank import BankState
from rednose_tpu_torch.utils.device import resolve_device


def _np(t):
  return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
      np.asarray(t)


def save_filter(path, engine):
  """Persist a FilterEngine's resumable state (x, P, filter_time, params).
  Params must be a flat mapping from str to array-like values."""
  params = engine.params
  if not (isinstance(params, dict) and all(isinstance(k, str)
                                           for k in params)):
    raise TypeError("save_filter stores flat str-keyed params only")
  keys = sorted(params)  # the JAX package's flatten order
  np.savez(
      path,
      x=_np(engine.x),
      P=_np(engine.P),
      filter_time=np.asarray(
          np.nan if engine.filter_time is None else engine.filter_time),
      augment_times=np.asarray(engine.augment_times, dtype=np.float64),
      n_params=np.asarray(len(keys)),
      **{f"param_{i}": _np(params[k]) for i, k in enumerate(keys)},
      param_keys=np.asarray(keys, dtype=np.str_),
  )


def load_filter(path, engine):
  """Restore a FilterEngine from a save_filter file (the rewind ring resets,
  as init_state does, ekf_sym.py:351-358)."""
  with np.load(path) as data:
    t = float(data["filter_time"])
    engine.init_state(data["x"], data["P"], None if np.isnan(t) else t)
    if "augment_times" in data:
      engine.augment_times = list(data["augment_times"])
    n = int(data["n_params"])
    if n:
      if "param_keys" not in data:
        raise ValueError(
            f"checkpoint carries {n} param leaves of a non-mapping pytree; "
            "the port restores flat str-keyed params only")
      keys = [str(k) for k in data["param_keys"]]
      engine.params = {k: np.asarray(data[f"param_{i}"])
                       for i, k in enumerate(keys)}
  return engine


def save_bank(path, state: BankState):
  np.savez(path, x=_np(state.x), P=_np(state.P), t=_np(state.t),
           epoch=np.asarray(state.epoch))


def load_bank(path, dtype=torch.float32, device="cuda") -> BankState:
  """A save_bank file on `device` (the card unless the caller asks for
  the CPU; without CUDA, device="cuda" raises)."""
  device = resolve_device(device)
  with np.load(path) as data:
    def tensor(key):
      return torch.as_tensor(data[key], dtype=dtype, device=device)

    return BankState(
        x=tensor("x"), P=tensor("P"), t=tensor("t"),
        epoch=float(data["epoch"]) if "epoch" in data else 0.0)
