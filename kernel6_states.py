#!/usr/bin/env python3
"""Kernel 6 on the live spec from the two live states chip_smoke.py can
compare it from, on one card.

    python3 kernel6_states.py        # from the repository root

The states: the hand bank's after LiveKalmanBank.run_mixed over T = 1024
steps (kernel 3's comparison state) and the generic bank's after
KalmanBank.run_mixed over T = 512 (chip_smoke.py's main paths, the same
seeds). For each, the lanes whose velocity is beyond 3, 5 and 8 sigma of
rest and the attitude sigmas (the comparison data are measurements of a
bank at rest). Then compare_generic's kernel-6 inputs (the same draws)
through the tile (the emitted source as the port ships it), the global
form of the same variant (one thread a filter, P in global memory: the
design before the tile), kernel 3 with its gate off, and the plain
version in float32 and float64; for each pair the largest per-lane
difference in standard deviations (utils/compare.py), its lane, and the
median lane. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import sys
import time

import numpy as np

import chip_smoke as cs
from sweep_warps import k4_source


def health(torch, name, x, P):
  """Velocity against rest and attitude sigmas of a live bank."""
  sd = torch.diagonal(P.double(), dim1=0, dim2=1).sqrt()     # (B, 22)
  v = x[7:10].double().T
  over = (v.abs() / sd[:, 6:9]).max(dim=1).values
  att = sd[:, 3:6].max(dim=1).values
  cs.log(f"{name}: lanes with a velocity beyond 3 / 5 / 8 sigma of rest "
         + " / ".join(str(int((over > k).sum())) for k in (3.0, 5.0, 8.0))
         + f" of {x.shape[-1]}; attitude sigma median "
         f"{float(att.median()):.4g} rad, max {float(att.max()):.4g}; "
         f"|v| max {float(v.abs().max()):.4g} m/s")


def main():
  import torch

  if not torch.cuda.is_available():
    print("kernel6_states: no CUDA device", file=sys.stderr)
    return 1
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import generic_scan as gs, live_scan
  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  torch.backends.cuda.matmul.allow_tf32 = False
  cs.log(f"card: {cs.card_line()}")
  live_spec = cs.generic_models()[3]
  calls = cs.generic_calls(live_spec)
  call6 = calls["live run_mixed (kernel 6)"]
  src_global = k4_source(lambda: call6, global_form=True)
  t0 = time.perf_counter()
  _build.build_generated_many([c.source() for c in calls.values()]
                              + [src_global])
  _build.library()
  cs.log(f"built in {time.perf_counter() - t0:.1f} s")

  dev = torch.device("cuda", 0)
  gens = []
  for i in range(2):
    gens.append(torch.Generator(device=dev))
    gens[-1].manual_seed(cs.SEED + i)
  hand = cs.main_path(torch, dev, gens[0])["live_bank_scan_mixed"]
  generic = cs.generic_main_path(torch, dev, gens[1])["live_mixed"]
  health(torch, "hand bank after run_mixed T=1024", *hand[:2])
  health(torch, "generic bank after run_mixed T=512", *generic)

  # compare_generic's draws before its kernel-6 inputs: kernel 4's fixes
  gen, f32 = gens[1], dict(dtype=torch.float32, device=dev)
  torch.randn((cs.CMP_T, 3, cs.GEN_B), generator=gen, device=dev)
  kinds, kind_idx, zs = cs.mixed_schedule(torch, dev, gen, cs.CMP_T)
  zs = zs.permute(0, 2, 1).contiguous()
  ki = torch.as_tensor(kind_idx, dtype=torch.int32, device=dev)
  dts = torch.full((cs.CMP_T,), 0.01, **f32)
  R_list = [LiveKalman.obs_noise[k] for k in kinds]
  kw = dict(spec=live_spec, kinds=kinds, Q=LiveKalman.Q, R_list=R_list,
            structure=call6.structure)
  R_by_kind = torch.stack([torch.as_tensor(r, **f32) for r in R_list])
  q_diag = torch.as_tensor(np.diag(LiveKalman.Q).copy(), **f32)

  def err(a, b):
    ex, ep = lane_sigma_errs(live_spec, *[t.double() for t in a],
                             *[t.double() for t in b])
    e = torch.maximum(ex, ep)
    return (f"max {float(e.max()):.4g} sigma at lane {int(e.argmax())}, "
            f"median {float(e.median()):.4g}")

  for name, (x, P) in (("generic", generic), ("hand", hand[:2])):
    out = {
        "tile": gs.generic_bank_scan_mixed(x, P, zs, dts, ki, **kw),
        "global form": cs.generic_launch(src_global, call6, x, P, zs, dts,
                                         kind_idx=ki)(),
        "kernel 3": live_scan.live_bank_scan_mixed(
            x, P, zs, dts, ki, kinds, R_by_kind, q_diag, gate=False),
        "plain float32": gs.generic_bank_scan_mixed_reference(
            x, P, zs, dts, ki, **kw),
        "plain float64": gs.generic_bank_scan_mixed_reference(
            x.double(), P.double(), zs.double(), dts.double(), ki, **kw),
    }
    for a, b in (("tile", "plain float32"), ("global form", "plain float32"),
                 ("tile", "global form"), ("tile", "kernel 3"),
                 ("tile", "plain float64"), ("plain float32", "plain float64")):
      cs.log(f"from the {name} state, {a} vs {b}: {err(out[a], out[b])}")
  print(cs.card_line())
  return 0


if __name__ == "__main__":
  sys.exit(main())
