"""Per-body FLOP audit of the port's filter steps.

Port of tools/flops_report.py. For each body it prints three numbers a
lane for one step, on the port's plain torch versions (the functions the
kernels are held against), in float32 at one lane:
- FLOPs, from utils/profiling.cost_report (torch_flops: the JAX
  counter's rule, elementwise and compare ops count their output size,
  matrix products 2 * out * K);
- bytes, from utils/profiling.cost_report: every op's inputs and outputs,
  unfused, so an upper bound on what a fused kernel moves;
- operations of the matching emitted kernel body (utils/profiling.
  step_ops on generic_scan.KernelCall.counting_source(), the rule behind
  the kernels' bounds in chip_smoke.py).
With --times FILE (the JSON chip_smoke.py writes on the card, by default
build/chip_smoke_times.json) it adds each body's sustained rate on the
card: filter-steps a second of the kernel that runs the body, and the
FLOP/s and emitted operations/s they imply. It never reads the JAX
package's BENCH_r*.json, which holds TPU rates.

    python -m rednose_tpu_torch.tools.flops_report [--times FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np
import torch

from rednose_tpu_torch.utils.profiling import cost_report, step_ops

DEFAULT_TIMES = os.path.join("build", "chip_smoke_times.json")
F32 = dict(dtype=torch.float32, device="cpu")


def _t(a):
  return torch.as_tensor(np.asarray(a, dtype=np.float64), **F32)


def _live():
  """The live spec's bodies: the hand step, the entry (structural) step
  and the dense oracle step, predict + ECEF_POS update."""
  from rednose_tpu_torch.core import step
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs, live_lane, sparsity

  spec = LiveKalman.build_spec()
  kind = int(K.ECEF_POS)
  x = _t(LiveKalman.initial_x)[:, None]                  # (23, 1)
  P = _t(np.diag(LiveKalman.initial_P_diag))[..., None]  # (22, 22, 1)
  Q, R = _t(LiveKalman.Q), _t(np.diag([25.0] * 3))
  z = _t(LiveKalman.initial_x[:3])[:, None]              # (3, 1)
  dt = _t(0.01)
  dts = _t([0.01])
  st = sparsity.structure_for(spec, LiveKalman.initial_x)

  def call(structure):
    return gs.KernelCall(spec, "single", (kind,), Q=LiveKalman.Q,
                         R_list=(np.diag([25.0] * 3),), gate=False,
                         structure=structure)

  def entry(x, P, z):
    return gs.generic_bank_scan_reference(
        x, P, z[None], dts, spec=spec, kind=kind, Q=LiveKalman.Q,
        R=np.diag([25.0] * 3), gate=False, structure=st)

  def dense(x, P, z):
    xp, Pp = step.predict(spec, {}, x, P, Q, dt)
    return step.update(spec, kind, {}, xp, Pp, z, R, torch.zeros(1, **F32))

  ops = step_ops(call(st).counting_source(), (kind,))
  return [
      ("live hand step (live_lane.live_step_slab)",
       lambda x, P, z: live_lane.live_step_slab(x, P, Q, dt, z, R),
       (x, P, z), ops, ("live_bank_scan", "B=")),
      ("live entry step (generic_bank_scan_reference)", entry, (x, P, z),
       ops, ("generic_bank_scan", "live spec B=")),
      ("live dense oracle step (core/step)", dense,
       (x[:, 0], P[..., 0], z[:, 0]),
       step_ops(call(None).counting_source(), (kind,)), None),
  ]


def _frame(spec, kind, x0, Q, r_diag, tag):
  """A camera frame (block predict, projected feature update, window
  augment) of an MSCKF spec, one lane from x0."""
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  om = spec.obs[kind]
  x0 = np.asarray(x0, dtype=np.float64)
  R = r_diag * np.eye(om.dz)
  kw = dict(spec=spec, kind=kind, Q=Q, R=R, gate=True,
            structure=sparsity.structure_for(spec, x0))
  x = _t(x0)[:, None]
  P = _t(np.eye(spec.dim_err) * 0.1)[..., None]
  zs = torch.zeros((1, om.dz, 1), **F32)
  eas = _t([2.0, 1.5, 8.0])[None, :, None]
  dts = _t([0.05])

  def frame(x, P, zs, eas):
    return gs.vo_bank_scan_reference(x, P, zs, eas, dts, **kw)

  call = gs.KernelCall(spec, "frame", (kind,), Q=Q, R_list=(R,), gate=True,
                       structure=kw["structure"])
  return (f"{tag} frame (vo_bank_scan_reference)", frame, (x, P, zs, eas),
          step_ops(call.counting_source(), (kind,), "frame"),
          ("vo_bank_scan", f"{tag} B="))


def _gnss_epoch():
  """The GNSS epoch: one predict and 4 pseudoranges + 4 rates, LocKalman."""
  from rednose_tpu_torch.models.loc import LocKalman, ObservationKind as LK
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  spec = LocKalman.build_spec()
  slots = ([int(LK.PSEUDORANGE_GPS)] * 4
           + [int(LK.PSEUDORANGE_RATE_GPS)] * 4)
  kw = dict(spec=spec, slot_kinds=slots, Q=LocKalman.Q,
            R_list=[LocKalman.obs_noise[k] for k in slots],
            structure=sparsity.structure_for(spec, LocKalman.initial_x))
  max_dz = max(spec.obs[k].dz for k in slots)
  max_ea = max(spec.obs[k].ea_len for k in slots)
  x = _t(LocKalman.initial_x)[:, None]
  P = _t(np.diag(LocKalman.initial_P_diag))[..., None]
  zs = torch.zeros((1, len(slots), max_dz, 1), **F32)
  eas = torch.full((1, len(slots), max_ea, 1), 1e7, **F32)
  dts = _t([0.1])

  def epoch(x, P, zs, eas):
    return gs.generic_bank_scan_epoch_reference(x, P, zs, dts, eas=eas, **kw)

  call = gs.KernelCall(spec, "epoch", slots, Q=LocKalman.Q,
                       R_list=kw["R_list"], structure=kw["structure"])
  return ("loc GNSS epoch, 8 slots (generic_bank_scan_epoch_reference)",
          epoch, (x, P, zs, eas),
          step_ops(call.counting_source(), slots, "epoch"),
          ("generic_bank_scan_epoch", "loc B="))


def bodies():
  """[(name, fn, args, emitted operations a step, (kernel row name, shape
  prefix) of the chip times, or None)] of the six bodies."""
  from rednose_tpu_torch.models.msckf_eskf import (
      MSCKFEskf,
      ObservationKind as EK,
  )
  from rednose_tpu_torch.models.msckf_vo import (
      ObservationKind as VK,
      build_msckf_vo_spec,
  )

  vo = build_msckf_vo_spec()
  return [*_live(),
          _frame(vo, int(VK.MSCKF_TEST), np.zeros(vo.dim_x),
                 1e-6 * np.eye(vo.dim_err), 0.02**2, "msckf_vo"),
          _frame(MSCKFEskf.build_spec(), int(EK.MSCKF_FEATURE),
                 MSCKFEskf.initial_x, MSCKFEskf.Q, 0.01**2, "msckf_eskf"),
          _gnss_epoch()]


def chip_time(times, key):
  """(lane-steps a second, the row) of the first row of `times` whose
  name is key[0] and whose shape starts with key[1], or None."""
  if key is None:
    return None
  for row in times.get("rows", ()):
    if row["name"] == key[0] and row["shape"].startswith(key[1]):
      m = re.search(r"B=(\d+) T=(\d+)", row["shape"])
      return int(m.group(1)) * int(m.group(2)) / (row["ms"] * 1e-3), row
  return None


def report(times=None):
  """The table's rows: [(name, flops, bytes, emitted ops, chip)]."""
  out = []
  for name, fn, args, ops, key in bodies():
    cost = cost_report(fn, *args)
    out.append((name, cost["flops"], cost["bytes accessed"], ops,
                chip_time(times or {}, key)))
  return out


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  ap.add_argument("--times", default=DEFAULT_TIMES,
                  help="chip_smoke.py's JSON of kernel times on the card")
  args = ap.parse_args(argv)
  times = None
  if os.path.exists(args.times):
    with open(args.times) as f:
      times = json.load(f)
  rows = report(times)
  print(f"{'body (one lane, one step, float32)':62s} {'FLOPs':>9s} "
        f"{'bytes':>10s} {'emitted ops':>11s}")
  for name, flops, nbytes, ops, _ in rows:
    print(f"{name:62s} {flops:9,d} {nbytes:10,d} {ops:11,.0f}")
  print()
  if times is None:
    print(f"no chip times ({args.times}: run chip_smoke.py on the card)")
    return rows
  print(f"sustained on {times.get('card', 'the card')} (chip_smoke.py's "
        "wrapped kernel times): the kernel's rate in its own emitted "
        "operations, and the plain version's FLOPs at that rate (an "
        "overcount where the plain version computes what the emitted body "
        "folds away, as the entry step's dense Jacobians):")
  for name, flops, _, ops, chip in rows:
    if chip is None:
      continue
    rate, row = chip
    print(f"  {name}: {row['name']} [{row['shape']}] {row['ms']:.4f} ms, "
          f"{rate / 1e6:.1f} M filter-steps/s, {ops * rate / 1e12:.3f} T "
          f"emitted operations/s; plain-version FLOPs "
          f"{flops * rate / 1e12:.3f} TFLOP/s")
  return rows


if __name__ == "__main__":
  main()
