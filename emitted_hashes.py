#!/usr/bin/env python3
"""sha256 of the generic kernels' emitted sources, to show that a change to
the emitter leaves the text of the variants it does not target
byte-identical.

    python3 emitted_hashes.py OUT.json              # from a tree's root
    python3 emitted_hashes.py --compare A.json B.json

The variants are those chip_smoke.py and the CPU tests emit: every
variant of the main paths (car, loc epochs and observe, the live spec's
single and 4-kind mixed, both MSCKF models' frame and VIO mixed-with-
frames variants, msckf_eskf's position fix), the mixed and epoch
variants of live, car, loc and msckf_eskf that
tests/test_torch_generic_single_roles.py emits, msckf_vo's dense
mixed body with frames of tests/test_torch_vio_emitter.py, and the
user-spec path's variants (the random specs' and the op battery's,
models/user_specs.py), kernel 9's log-scan variants (mode "stream",
chip_smoke.stream_calls) and kernel 10's adjoint variants with the ML
tuning's log scan (mode "stream_adjoint", chip_smoke.adjoint_calls), kernel 15's
run_bank variants and kernels 9 and 10's lane forms (mode "bank",
chip_smoke.bank_calls, where the tree has them), each in float and
double, and the smoother's sources (mode "smooth": kernels
11, 12 and 14 of the live, kinematic and msckf_eskf specs, kernel 13 of
their main blocks; mode "smooth_adjoint": their adjoints; one source
serves both types). Runs on the CPU
(emission needs no card); imports nothing of JAX.
With --compare it prints, by mode, how many variants the two files share
unchanged, and names the ones that changed, are new in the second file
or are gone from it.
"""

from __future__ import annotations

import hashlib
import json
import sys


def variants():
  """name -> KernelCall of every variant listed above."""
  import numpy as np

  import chip_smoke as cs
  from rednose_tpu_torch.models import car, live, loc
  from rednose_tpu_torch.models.live import ObservationKind as K
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  calls = dict(cs.generic_calls(cs.generic_models()[3]))
  for model in cs.msckf_models():
    calls[f"{model.name} run_frames (kernel 7)"] = cs.msckf_call(model)
    calls[f"{model.name} run_mixed with frames (kernel 6)"] = \
        cs.vio_call(model)
  calls["msckf_eskf observe POSITION (kernel 4)"] = cs.msckf_position_call()
  for model, spec, kinds in (
      (live.LiveKalman, live.build_live_spec(), (K.PHONE_GYRO, K.ECEF_POS)),
      (car.CarKalman, car.CarKalman.build_spec(), (1, 2)),
      (loc.LocKalman, loc.LocKalman.build_spec(),
       (K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS)),
      (MSCKFEskf, MSCKFEskf.build_spec(), (12,))):
    st = sparsity.structure_for(spec, model.initial_x)
    for mode in ("mixed", "epoch"):
      calls[f"{spec.name} {mode} {tuple(int(k) for k in kinds)}"] = \
          gs.KernelCall(spec, mode, kinds, Q=model.Q,
                        R_list=[model.obs_noise[k] for k in kinds],
                        structure=st)
  espec = MSCKFEskf.build_spec()
  calls["msckf_eskf frame, R = 1e-4 I"] = gs.KernelCall(
      espec, "frame", (16,), Q=MSCKFEskf.Q, R_list=(1e-4 * np.eye(8),),
      structure=sparsity.structure_for(espec, MSCKFEskf.initial_x))
  calls |= {f"user spec {name}": call
            for name, call in cs.user_calls().items()}
  vo = cs.msckf_models()[0]
  calls["msckf_vo mixed with frames, dense body"] = gs.KernelCall(
      vo.build_spec(), "mixed", (12, 16), Q=vo.Q,
      R_list=(np.eye(3), 1e-4 * np.eye(8)))
  calls |= {name: call for name, (call, _) in cs.stream_calls().items()}
  calls |= {name: call for name, (call, _) in cs.adjoint_calls().items()}
  if hasattr(cs, "bank_calls"):
    calls |= {name: call for name, (call, _, _) in cs.bank_calls().items()}
  return calls


def smooth_variants():
  """name -> source of the smoother's kernels (mode "smooth", one source
  for float and double: kernels 11, 12 and 14 of the live, kinematic and
  msckf_eskf specs, kernel 13 of their main blocks; mode "smooth_adjoint":
  their adjoints 11', 12' and 14'), where the tree has them."""
  try:
    from rednose_tpu_torch.ops import smooth_scan as ss
  except ImportError:
    return {}
  from rednose_tpu_torch.models.kinematic import KinematicKalman
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf

  out = {}
  for model in (LiveKalman, KinematicKalman, MSCKFEskf):
    spec = model.build_spec()
    out[f"{spec.name} smoother"] = ss.smooth_source(spec, ())
    out[f"suffix scan d2 = {spec.dim_main_err}"] = ss.affine_source(
        spec.dim_main_err)
    if hasattr(ss, "smooth_adjoint_source"):
      out[f"{spec.name} smoother adjoint"] = ss.smooth_adjoint_source(
          spec, ())
  return out


def hashes():
  import torch

  out = {}
  for name, call in variants().items():
    for dtype in (torch.float32, torch.float64):
      key = f"{name} [{call.mode}, {str(dtype).split('.')[-1]}]"
      out[key] = hashlib.sha256(call.source(dtype).encode()).hexdigest()
      print(f"{out[key][:16]}  {key}", flush=True)
  for name, src in smooth_variants().items():
    mode = "smooth_adjoint" if name.endswith("adjoint") else "smooth"
    key = f"{name} [{mode}, float and double]"
    out[key] = hashlib.sha256(src.encode()).hexdigest()
    print(f"{out[key][:16]}  {key}", flush=True)
  return out


def compare(a, b):
  """By mode, the variants both files hold unchanged or changed, and those
  only the second (new) or only the first (gone) holds, each named."""
  modes = {}
  for key in sorted(set(a) | set(b)):
    mode = key.rsplit("[", 1)[1].split(",")[0]
    state = ("new" if key not in a else "gone" if key not in b
             else "unchanged" if a[key] == b[key] else "changed")
    counts = modes.setdefault(mode, dict.fromkeys(
        ("unchanged", "changed", "new", "gone"), 0))
    counts[state] += 1
    if state != "unchanged":
      print(f"{state}: {key}")
  for mode, counts in sorted(modes.items()):
    print(f"mode {mode}: " + ", ".join(f"{n} {state}"
                                       for state, n in counts.items()))


def main():
  if len(sys.argv) == 4 and sys.argv[1] == "--compare":
    a, b = (json.load(open(f)) for f in sys.argv[2:])
    compare(a, b)
    return 0
  if len(sys.argv) != 2:
    print("\n".join(__doc__.strip().splitlines()[4:6]), file=sys.stderr)
    return 2
  with open(sys.argv[1], "w") as f:
    json.dump(hashes(), f, indent=1)
  return 0


if __name__ == "__main__":
  sys.exit(main())
