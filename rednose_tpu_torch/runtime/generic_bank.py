"""Facade for wide banks of ANY (non-MSCKF) filter spec.

Port of rednose_tpu/runtime/generic_bank.py. LiveKalmanBank gives the live
model bank ergonomics on its hand-written kernels; KalmanBank gives the
same surface to an arbitrary FilterSpec on the generic kernels, whose CUDA
source is emitted per spec (ops/entry_slab.py) — the reference's promise
that every gen_code filter is a fast filter
(site_scons/site_tools/rednose_filter.py:40-48), at bank scale:

    bank = KalmanBank(MyModel, batch=8192)        # or KalmanBank(spec=...)
    bank.run(dts, zs, kind)                        # single-kind stream
    bank.run_mixed(dts, kind_idx, zs, kinds)       # heterogeneous schedule
    bank.run_epochs(dts, zs, slot_kinds)           # predict + K updates
    bank.observe(t, kind, z)                       # out-of-order tolerant
    bank.x, bank.P                                 # (B, dim_x), (B, de, de)

On a CUDA device `run` launches kernel 4 (generic_scan.generic_bank_scan),
`run_mixed` kernel 6, `run_epochs` kernel 5 and `observe` kernel 4 with
T = 1; on the CPU the same wrappers run the plain lane scans. Extra-args
kinds (the loc_kf pseudorange family) stream their satellite states
through ``eas=``; per-step runtime params through ps_keys / pss. Outlier
gating is a spec property (each kind's maha_test, ekf_sym.py:144-152);
`run(gate=True)` forces it, as the JAX kernel's flag does. Params, Q and
R reach the kernels as run-time values: set_global never rebuilds one.
The bank keeps one checked generic_scan.KernelCall per kind set, gate and
R, so an `observe` repeats no check and copies no value to the device;
change params through set_global, which drops the kept calls.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops import generic_scan, sparsity
from rednose_tpu_torch.runtime.bank_facade import BankFacadeBase
from rednose_tpu_torch.runtime.rewind import BankRewindRing
from rednose_tpu_torch.utils.device import resolve_device


class KalmanBank(BankFacadeBase):
  """B independent filters of one spec stepped together. Pass a model
  class (build_spec() plus initial_x / initial_P_diag / Q / obs_noise, like
  the shipped models) or spec= with x0 / P_diag / Q."""

  _msckf = False  # MSCKF specs: runtime/msckf_bank.MSCKFBank

  def __init__(self, model=None, batch: int = 1024, *, spec=None, x0=None,
               P_diag=None, Q=None, obs_noise=None, dtype=torch.float32,
               device="cuda", structure="auto", t0: float = 0.0,
               max_rewind_age: float = 1.0, ckpt_every: int = 16,
               ckpt_keep: int = 8, ckpt_bytes: int | None = None,
               logger=logging):
    if (model is None) == (spec is None):
      raise ValueError("pass a model class or spec=, not both")
    if model is not None:
      spec = model.build_spec()
      x0 = model.initial_x if x0 is None else x0
      P_diag = model.initial_P_diag if P_diag is None else P_diag
      Q = model.Q if Q is None else Q
      obs_noise = (getattr(model, "obs_noise", None) if obs_noise is None
                   else obs_noise)
    if not isinstance(spec, FilterSpec):
      raise TypeError(f"not a FilterSpec: {spec!r}")
    if spec.is_msckf != self._msckf:
      raise ValueError(
          f"spec {spec.name!r}: " + ("an MSCKF spec (clone window) runs in "
                                     "runtime/msckf_bank.MSCKFBank"
                                     if spec.is_msckf else
                                     "MSCKFBank needs a clone-window spec"))
    if x0 is None or P_diag is None or Q is None:
      raise ValueError("spec= needs explicit x0, P_diag and Q")
    self.spec = spec
    self.batch = batch
    self.dtype = dtype
    self.device = resolve_device(device)
    self._quaternion_idxs = tuple(spec.quaternion_idxs)
    self.obs_noise = dict(obs_noise or {})
    x0 = np.asarray(x0, dtype=np.float64)
    self._x0_1d = x0 if x0.ndim == 1 else x0[0]
    self._P_diag0 = np.asarray(P_diag, dtype=np.float64)
    self.Q = np.asarray(Q, dtype=np.float64)
    x = self._tensor(x0)
    self._x = (x[:, None].expand(-1, batch) if x.ndim == 1
               else x.T).contiguous()
    if tuple(self._x.shape) != (spec.dim_x, batch):
      raise ValueError(f"x0 {x0.shape} does not fit {batch} x {spec.dim_x}")
    self._P = self._tensor(np.diag(self._P_diag0))[:, :, None].expand(
        -1, -1, batch).contiguous()
    self.t = float(t0)
    self.logger = logger
    # structural sparsity, detected once per spec: the emitter writes only
    # the nonzero arithmetic; an undetectable spec gets the dense body
    if structure == "auto":
      try:
        structure = sparsity.structure_for(spec, self._x0_1d)
      except sparsity.StructureError as e:
        logger.warning(f"structure detection failed ({e}); the kernels "
                       "use the dense body")
        structure = None
    self.structure = structure
    self.max_rewind_age = max_rewind_age
    self._ring = BankRewindRing(ckpt_every=ckpt_every, ckpt_keep=ckpt_keep,
                                ckpt_bytes=ckpt_bytes)
    # runtime-tunable params (the reference's global_vars + set_<var>,
    # ekf_sym.py:129-132)
    self.params = dict(spec.default_params)
    self._calls = {}   # BankFacadeBase._call

  def set_global(self, key: str, value):
    """Update one runtime param (reference: set_<global_name>). The kernels
    take params as run-time values, so nothing is rebuilt; per-step
    variation streams through ps_keys / pss instead."""
    if key not in self.params:
      raise KeyError(f"{key!r} not in params {sorted(self.params)}")
    self.params[key] = value
    self._calls.clear()   # the kept kernel calls hold the old value

  def _default_R(self, kind):
    R = self.obs_noise.get(kind)
    if R is None:
      raise ValueError(
          f"kind {kind} has no default noise (obs_noise); pass R=")
    return R

  # --------------------------------------------------- per-observation API

  def observe(self, t, kind, z, R=None, ea=None):
    """Apply ONE timestamped observation to the whole bank with
    driver-style out-of-order handling (ekf_sym.py:464-482): a late
    observation inside the rewind window rolls the bank back to the newest
    snapshot at-or-before t and replays around it; older than the window
    it is dropped (returns None). z is (B, dz) or (dz,) broadcast across
    lanes; ea likewise ((B, ea_len) or (ea_len,)) for extra-args kinds."""
    kind = int(kind)
    om = self.spec.obs[kind]
    R = self._normalize_R(kind, self._default_R(kind) if R is None else R)
    z = np.asarray(z, dtype=np.float64)
    if z.ndim == 1:
      z = np.broadcast_to(z, (self.batch, z.shape[0]))
    if z.shape != (self.batch, om.dz):
      raise ValueError(f"z {z.shape}, expected ({self.batch}, {om.dz})")
    if om.ea_len:
      if ea is None:
        raise ValueError(f"kind {kind} takes {om.ea_len} extra args")
      ea = np.asarray(ea, dtype=np.float64)
      if ea.ndim == 1:
        ea = np.broadcast_to(ea, (self.batch, ea.shape[0]))
      if ea.shape != (self.batch, om.ea_len):
        raise ValueError(f"ea {ea.shape}, expected ({self.batch}, "
                         f"{om.ea_len})")
    elif ea is not None:
      raise ValueError(f"kind {kind} takes no extra args")
    return self._observe_ordered(t, (kind, z, R, ea))

  def _apply_one(self, t, kind, z, R, ea):
    dt = max(float(t) - self.t, 0.0)
    om = self.spec.obs[kind]
    self._x, self._P = generic_scan.generic_bank_scan(
        self._x, self._P, self._stream(z[None], (1,), om.dz, "z"),
        self._tensor([dt]),
        eas=None if ea is None else self._stream(ea[None], (1,), om.ea_len,
                                                 "ea"),
        call=self._call("single", (kind,), (R,)))
    self.t = float(t)
    self._ring.record(self.t, (self._x, self._P), (self.t, kind, z, R, ea))

  # ------------------------------------------------------------------- runs

  def run(self, dts, zs, kind, R=None, eas=None, pss=None, ps_keys=(),
          gate: bool | None = None):
    """T fused predict + update steps of one kind: dts (T,), zs (T, B, dz),
    R (dz, dz) shared (defaults to the model's obs_noise), eas
    (T, B, ea_len) for extra-args kinds, per-step params ps_keys / pss
    (T, len(ps_keys)); gate None gates as the kind's maha_test says, a
    bool forces it. Advances bank time by sum(dts) (host float64)."""
    kind = int(kind)
    om = self.spec.obs[kind]
    dts = np.asarray(dts, np.float64)
    T = dts.shape[0]
    if T == 0:
      return self
    R = self._normalize_R(kind, self._default_R(kind) if R is None else R)
    self._x, self._P = generic_scan.generic_bank_scan(
        self._x, self._P, self._stream(zs, (T,), om.dz, "zs"),
        self._tensor(dts),
        eas=None if eas is None else self._stream(eas, (T,), om.ea_len,
                                                  "eas"),
        pss=None if pss is None else self._tensor(pss),
        call=self._call("single", (kind,), (R,), gate, tuple(ps_keys)))
    self.t += float(dts.sum())
    self._ring.clear()  # bulk runs are not observation-addressable
    return self

  def run_mixed(self, dts, kind_idx, zs, kinds: Sequence[int],
                R_by_kind=None, eas=None, pss=None, ps_keys=()):
    """T steps of a heterogeneous sensor schedule: kinds is the kind set,
    kind_idx (T,) indexes into it, zs (T, B, max_dz) rows padded to the
    largest dz, eas (T, B, max_ea_len) likewise (iff a kind takes extra
    args). Per-kind R defaults to the model's obs_noise; each kind gates
    on its own maha_test. Per-step params via ps_keys / pss as in run()."""
    kinds = tuple(int(k) for k in kinds)
    max_dz = max(self.spec.obs[k].dz for k in kinds)
    max_ea = max(self.spec.obs[k].ea_len for k in kinds)
    dts = np.asarray(dts, np.float64)
    T = dts.shape[0]
    if T == 0:
      return self
    if R_by_kind is None:
      R_by_kind = {k: self._default_R(k) for k in kinds}
    R_list = [self._normalize_R(k, R_by_kind[k]) for k in kinds]
    kind_idx = np.asarray(kind_idx)
    if kind_idx.shape != (T,) or kind_idx.min() < 0 or \
        kind_idx.max() >= len(kinds):
      raise ValueError(f"kind_idx must be (T,) indices into {len(kinds)} "
                       "kinds")
    self._x, self._P = generic_scan.generic_bank_scan_mixed(
        self._x, self._P, self._stream(zs, (T,), max_dz, "zs"),
        self._tensor(dts), self._tensor(kind_idx, torch.int32),
        eas=None if eas is None else self._stream(eas, (T,), max_ea, "eas"),
        pss=None if pss is None else self._tensor(pss),
        call=self._call("mixed", kinds, R_list, ps_keys=tuple(ps_keys)))
    self.t += float(dts.sum())
    self._ring.clear()  # bulk runs are not observation-addressable
    return self
