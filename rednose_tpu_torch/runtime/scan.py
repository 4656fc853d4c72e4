"""Offline replay of a heterogeneous observation log in one call.

Port of rednose_tpu/runtime/scan.py. The host driver (runtime/driver.py)
takes one observation at a time, with its rewind bookkeeping; this module
runs a whole recorded, time-ordered log through core/step.py in one loop
over time and keeps every step's (predicted, posterior) pair: the
smoother's inputs (smoothing/rts.py).

Measurements of different sizes are padded to the largest dz; a padded
slot gets variance PAD_R, so it carries no information (the reference's
soft-nulling trick for Mahalanobis rejection, ekf_c.c:92). The padded rows
of H are exactly zero, so with PAD_R on the diagonal the padded slots
change neither the gain nor the covariance.

The kind dispatch is a host-side index into the per-kind branches: the
kind index stays on the host, and no step waits on the device for it. A
spec that ships a closed-form F (FilterSpec.F_lane, equal to jacfwd of its
dynamics) predicts with it: on an H100 the live spec's step, vmapped over
64 lanes, takes about half the time it takes with jacfwd (chip_smoke.py
times both).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from rednose_tpu_torch.core import step as step_ops
from rednose_tpu_torch.core.spec import FilterSpec

# Padded-slot variance: information-free (a leak of ~1e-12 relative), and
# small enough that float32 closed-form 3x3 solves of an S holding it
# (adjugate terms are products of three entries) cannot overflow.
PAD_R = 1.0e12


def _padded_spec(spec: FilterSpec, kind: int, max_dz: int) -> FilterSpec:
  """spec with kind's h padded by zero rows to max_dz (its dz and gate
  threshold otherwise kept)."""
  om = spec.obs[kind]
  pad = max_dz - om.dz

  def h_padded(params, x, ea):
    h = om.h(params, x, ea).reshape(-1)
    return torch.cat([h, h.new_zeros(pad)])

  om_pad = dataclasses.replace(om, h=h_padded, dz=max_dz,
                               maha_thresh=om.maha_thresh)
  return dataclasses.replace(spec, obs={**spec.obs, kind: om_pad})


def _padded_update(spec_pad: FilterSpec, kind: int, params, x, P, z_pad,
                   R_pad, ea):
  """One update of `kind` with z / R padded to max_dz, on the spec
  _padded_spec made: the kind's real h / H rows, zero rows and PAD_R for
  the padding. Returns (x, P)."""
  om = spec_pad.obs[kind]
  x_new, P_new, _ = step_ops.update(spec_pad, kind, params, x, P, z_pad,
                                    R_pad, ea[:max(om.ea_len, 1)])
  return x_new, P_new


def build_scan_stream(spec: FilterSpec, kinds: Sequence[int]):
  """(scan_fn, kind_index) for a log of the given observation kinds,
  cached on (spec, kinds): a repeated call returns the same function.

  scan_fn(params, x, P, Q, dts, kind_idx, zs, Rs, eas) ->
      ((x, P), (x_preds, P_preds, x_posts, P_posts)), stacked over T, with
    dts (T,) per-step time deltas: deltas, not absolute timestamps
      (pad_log differences them on the host in float64, where they are
      exact; an epoch-scale time cast to float32 would quantize them),
    kind_idx (T,) indices into `kinds`, read on the host,
    zs (T, max_dz) padded measurements,
    Rs (T, max_dz, max_dz) padded noise (PAD_R on the padded slots),
    eas (T, max_ea) padded extra args.
  kind_index maps each kind to its index."""
  return _build_scan_stream_cached(spec, tuple(int(k) for k in kinds))


@functools.lru_cache(maxsize=None)
def _build_scan_stream_cached(spec: FilterSpec, kinds: tuple):
  max_dz = max(spec.obs[k].dz for k in kinds)
  branches = tuple((_padded_spec(spec, k, max_dz), k) for k in kinds)

  def scan_fn(params, x, P, Q, dts, kind_idx, zs, Rs, eas):
    ki = np.asarray(kind_idx.cpu() if torch.is_tensor(kind_idx)
                    else kind_idx).tolist()
    outs = ([], [], [], [])
    for t, i in enumerate(ki):
      F = None if spec.F_lane is None else spec.F_lane(params, x, dts[t])
      x_pred, P_pred = step_ops.predict(spec, params, x, P, Q, dts[t], F=F)
      spec_pad, kind = branches[i]
      x, P = _padded_update(spec_pad, kind, params, x_pred, P_pred, zs[t],
                            Rs[t], eas[t])
      for out, v in zip(outs, (x_pred, P_pred, x, P)):
        out.append(v)
    if not ki:
      return (x, P), tuple(
          v.new_zeros((0,) + tuple(v.shape)) for v in (x, P, x, P))
    return (x, P), tuple(torch.stack(out) for out in outs)

  return scan_fn, {k: i for i, k in enumerate(kinds)}


def pad_log(spec: FilterSpec, kinds: Sequence[int], log, t0: float = 0.0,
            dtype=np.float64):
  """Host-side packing of a list of (t, kind, z, R[, ea]) records into the
  padded arrays scan_fn takes: (dts, kind_idx, zs, Rs, eas), numpy.
  Timestamps are differenced here, in float64, so absolute epochs survive
  a float32 device dtype. Every record carries its own R."""
  kinds = tuple(kinds)
  kind_to_idx = {k: i for i, k in enumerate(kinds)}
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(max(spec.obs[k].ea_len, 1) for k in kinds)
  T = len(log)
  dts = np.zeros((T,), dtype=dtype)
  ki = np.zeros((T,), dtype=np.int32)
  zs = np.zeros((T, max_dz), dtype=dtype)
  Rs = np.zeros((T, max_dz, max_dz), dtype=dtype)
  eas = np.zeros((T, max_ea), dtype=dtype)
  t_prev = np.float64(t0)
  for i, rec in enumerate(log):
    t, kind, z, R = rec[0], rec[1], np.asarray(rec[2]).reshape(-1), rec[3]
    ea = (np.asarray(rec[4]).reshape(-1)
          if len(rec) > 4 and rec[4] is not None else np.zeros(0))
    dz = spec.obs[kind].dz
    if z.shape[0] != dz:
      raise ValueError(f"record {i}: kind {kind} takes {dz} values, got "
                       f"{z.shape[0]}")
    if np.float64(t) < t_prev:
      raise ValueError(
          f"log timestamps must be non-decreasing (record {i}: {t} < "
          f"{t_prev}); out-of-order streams belong to the host driver's "
          "rewind/replay path, not the log scan")
    dts[i] = np.float64(t) - t_prev
    t_prev = np.float64(t)
    ki[i] = kind_to_idx[kind]
    zs[i, :dz] = z
    Rs[i] = np.eye(max_dz) * PAD_R
    Rs[i, :dz, :dz] = np.asarray(R).reshape(dz, dz)
    eas[i, :ea.shape[0]] = ea
  return dts, ki, zs, Rs, eas
