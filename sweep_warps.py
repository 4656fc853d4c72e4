#!/usr/bin/env python3
"""Measure kernels 2, 3, 4 and 6 at W = 1, 2, 4 and 8 warps a block, and
kernels 7 and 6 with camera frames at W = 4, 8 and 16, on one card.

    python3 sweep_warps.py [--parent DIR] [--frames-only]   # repo root

W is a constant of each source: `POS_WARPS` and `WARPS` in
csrc/live_mixed.cuh (kernels 2 and 3, LiveKalmanBank.run and run_mixed;
each build sets both), `TILE_ROLES` in ops/entry_slab.py (kernel 4, mode
"single", and kernel 6, mode "mixed" without a camera-frame unit) and
`TILE_ROLES_FRAME` (kernel 7, mode "frame", and kernel 6 with a
camera-frame unit). This script builds each kernel at each W, all nvcc
processes at once: kernels 2 and 3 from a copy of csrc/ with the constant
replaced, kernels 4 and 6 by emitting the live spec's ECEF_POS variant
(gate on) and its 4-kind mixed variant with the emitter's constant set,
kernels 7 and 6 with frames by emitting both MSCKF models' frame and VIO
variants likewise. It also builds the global form of each emitted
variant (one thread a filter, P in global memory: the design before the
tile), and of the camera-frame tiles at the shipped W two timing aids
whose numbers are garbage: the tile without its innovation stages, and
without its serial ones. Given --parent (a checkout of an earlier commit
of this repository) it builds that commit's csrc/live_scan.cu, so the
earlier kernels 2 and 3 run in the same call, and times kernels 4 and 5
built with that commit's csrc/generic_scan.cuh and with this one's, in
turns (template_ab). --frames-only skips kernels 2, 3, 4 and 6 on the
live spec. Inputs are chip_smoke.py's: kernels 3 and 6 from the live bank
after run_mixed over T = 1024 steps of the 4-kind schedule (B = 8192;
kernel 3 with the gate on and the camera-rotation kind streaming its R),
kernels 2 and 4 from the bank after the ECEF_POS run (gate on), kernels 7
and 6 with frames from a fresh bank of B = 4096 on consistent frames
(kernel 7 T = 16, kernel 6 the VIO schedule at T = 64). For each build it
prints the time (CUDA events, mean of 5 launches after a warm-up) at that
T and at T = 1, the largest difference from the plain version in
standard deviations (utils/compare.py), ptxas (registers, stack, spill
bytes), the runtime's blocks per SM and, for the emitted kernels, the
emitted lines and nvcc seconds, and writes them all to
build/sweep_warps/sweep_warps.json. Needs a CUDA card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
SWEEP_DIR = ROOT / "build" / "sweep_warps"
WS = (1, 2, 4, 8)
FRAME_WS = (4, 8, 16)
REPS = 5


def build_k3(name, csrc, warps=None):
  """nvcc of csrc/live_scan.cu (WARPS replaced when given) into its own
  directory: (library path, ptxas lines of kernels 3 and 2, nvcc
  seconds)."""
  from rednose_tpu_torch import _build

  d = SWEEP_DIR / name
  shutil.rmtree(d, ignore_errors=True)
  d.mkdir(parents=True)
  for src in csrc.glob("*.cu*"):
    shutil.copy(src, d / src.name)
  if warps is not None:
    hdr = d / "live_mixed.cuh"
    text, n = re.subn(r"constexpr int (POS_)?WARPS = \d+;",
                      lambda m: f"constexpr int {m.group(1) or ''}WARPS = "
                      f"{warps};", hdr.read_text())
    if n != 2:
      raise RuntimeError("live_mixed.cuh: no WARPS and POS_WARPS constants "
                         "to replace")
    hdr.write_text(text)
  t0 = time.perf_counter()
  proc = subprocess.run(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
       str(d / "lib.so"), str(d / "live_scan.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  secs = time.perf_counter() - t0
  if proc.returncode:
    raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}")
  return d / "lib.so", {k: kernel_ptxas(proc.stdout, e) for k, e in (
      ("kernel 3", "live_bank_scan_mixed_kernel"),
      ("kernel 2", "live_bank_scan_kernel"))}, secs


def kernel_ptxas(report, kernel):
  """The ptxas -v lines of the entry function whose name holds `kernel`."""
  lines, keep = [], False
  for line in report.splitlines():
    if "Compiling entry function" in line:
      keep = kernel in line
    elif keep and ("registers" in line or "spill" in line
                   or "stack" in line):
      lines.append(line.split("info    :")[-1].strip())
  return lines


def load_k3(lib_path):
  from rednose_tpu_torch import _build

  lib = ctypes.CDLL(str(lib_path))
  for name in ("live_bank_scan_launch", "live_bank_scan_mixed_launch",
               "live_bank_scan_info", "live_bank_scan_mixed_info"):
    if hasattr(lib, name):
      getattr(lib, name).argtypes = list(_build.SIGNATURES[name])
      getattr(lib, name).restype = ctypes.c_int
  return lib


def k3_info(lib, entry):
  """Kernel 3's (or 2's) launch shape, None for a build without the entry
  point."""
  if not hasattr(lib, entry):
    return None
  return cs.hand_kernel_info(lib, entry)


def k4_source(call_fn, roles=None, global_form=False, **consts):
  """The source of a kernel-4, 6 or 7 call emitted with the emitter's
  constants set: roles into TILE_ROLES, consts (e.g. TILE_ROLES_FRAME) by
  name, no shared memory for a tile with global_form."""
  from rednose_tpu_torch.ops import entry_slab, generic_scan as gs

  if roles is not None:
    consts["TILE_ROLES"] = roles
  if global_form:
    consts["TILE_SMEM_MAX"] = 0
  saved = {k: getattr(entry_slab, k) for k in consts}
  try:
    for k, v in consts.items():
      setattr(entry_slab, k, v)
    gs._source.cache_clear()
    return call_fn().source()
  finally:
    for k, v in saved.items():
      setattr(entry_slab, k, v)
    gs._source.cache_clear()


def without_stages(src, serial_only=False):
  """A frame tile source that skips its camera frame's innovation stages
  (serial_only: only the serial ones, whose GEN_PHASE functions then
  return at once): the time of the rest of the step (its numbers are
  garbage)."""
  if serial_only:
    out, n = re.subn(r"(GEN_HD GEN_PHASE void \w+\(.*scalar_t\* s\) \{\n)",
                     r"\g<1>  return;\n", src)
  else:
    out, n = re.subn(r"(constexpr int gen_frame_\w+_NSTAGES = )\d+;",
                     r"\g<1>0;", src)
  if not n or out == src:
    raise ValueError("no camera-frame stages in the source")
  return out


def frame_cases(torch, dev, gen):
  """Kernel 7 (T = MSCKF_CMP_T) and kernel 6 with camera frames (the VIO
  schedule, T = CMP_T) for both MSCKF models, on chip_smoke.py's
  consistent frames from a fresh bank (P = P0 I): name -> (call, launch
  args, launch keywords, the model's spec)."""
  f32 = dict(dtype=torch.float32, device=dev)
  cases = {}
  for model in cs.msckf_models():
    spec, _, _, R = cs.msckf_setup(model)

    def bank(xs, spec=spec):
      return (torch.as_tensor(xs.T, **f32).contiguous(),
              (cs.MSCKF_P0 * torch.eye(spec.dim_err, **f32))[
                  :, :, None].repeat(1, 1, cs.MSCKF_B))

    T = cs.MSCKF_CMP_T
    xs = cs.msckf_bank_x0(model, cs.SEED + 3)
    zs, eas, _ = cs.msckf_frames(torch, dev, gen, model, xs, T, R)
    cases[f"kernel 7, {model.name}"] = (
        cs.msckf_call(model),
        (*bank(xs), zs.transpose(1, 2).to(**f32).contiguous(),
         torch.full((T,), cs.MSCKF_DT, **f32)),
        dict(eas=eas.transpose(1, 2).to(**f32).contiguous()), spec)
    T = cs.CMP_T
    ki = cs.vio_kind_idx(T)
    xs = cs.msckf_bank_x0(model, cs.SEED + 5)
    zs, eas, _ = cs.msckf_frames(torch, dev, gen, model, xs, T, R,
                                 frames=ki.astype(bool))
    cases[f"kernel 6 with frames, {model.name}"] = (
        cs.vio_call(model),
        (*bank(xs), zs.transpose(1, 2).to(**f32).contiguous(),
         torch.full((T,), cs.MSCKF_DT, **f32)),
        dict(eas=eas.transpose(1, 2).to(**f32).contiguous(),
             kind_idx=torch.as_tensor(ki, dtype=torch.int32, device=dev)),
        spec)
  return cases


def frame_sources(cases):
  """Each frame case's source at W = FRAME_WS, its global form and, at the
  shipped W, the tile without its innovation stages or without its serial
  ones."""
  from rednose_tpu_torch.ops import entry_slab

  w0 = entry_slab.TILE_ROLES_FRAME
  out = {}
  for name, (call, _, _, _) in cases.items():
    srcs = {f"W={w}": k4_source(lambda c=call: c, TILE_ROLES_FRAME=w)
            for w in FRAME_WS}
    srcs["global"] = call.source(tile=False)
    srcs[f"W={w0}, no innovation stages"] = without_stages(call.source())
    srcs[f"W={w0}, no serial stages"] = without_stages(call.source(), True)
    out[name] = srcs
  return out


def frame_sweep(torch, cases, sources):
  """Time each frame build at the case's T and at T = 1 (raw launches),
  its largest difference from the plain version in sigmas, ptxas and the
  runtime's launch shape."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import generic_scan as gs

  results = {}
  for name, (call, args, kw, spec) in cases.items():
    x, P, zs, dts = args
    T = dts.shape[0]
    plain = gs._plain(call, x, P, zs, dts, kw["eas"], None,
                      kw.get("kind_idx"))
    results[name] = {}
    for build, src in sources[name].items():
      def launch(n, src=src):
        return cs.generic_launch(src, call, x, P, zs[:n], dts[:n],
                                 **{k: v[:n] for k, v in kw.items()})

      out = launch(T)()
      ms, _ = cs.timed_run(launch(T), REPS)
      ms1, _ = cs.timed_run(launch(1), 20)
      err = float(cs.lane_errs(out, plain, spec).max())
      report = _build.generated_ptxas(src)
      ptx = kernel_ptxas(report, "rn_generic")
      nvcc = [ln for ln in report.splitlines() if "nvcc wall" in ln]
      info = _build.generated_info(src)
      results[name][build] = dict(T=T, ms=ms, ms_T1=ms1, sigma_err=err,
                                  ptxas=ptx, lines=len(src.splitlines()),
                                  nvcc=nvcc, info=info)
      cs.log(f"{name} {build}: T={T} {ms:.4f} ms, T=1 {ms1:.4f} ms, "
             f"{err:.4g} sigma from plain; {len(src.splitlines())} lines; "
             f"ptxas {ptx}; runtime {info}; {nvcc}")
  return results


def build_with_template(name, source, template):
  """nvcc of an emitted source beside the given template, in a directory
  of its own: its rn_generic_scan_launch."""
  from rednose_tpu_torch import _build

  d = SWEEP_DIR / name
  shutil.rmtree(d, ignore_errors=True)
  d.mkdir(parents=True)
  (d / "gen.cu").write_text(source)
  shutil.copy(template, d / "generic_scan.cuh")
  proc = subprocess.run(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
       str(d / "libgen.so"), str(d / "gen.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  if proc.returncode:
    raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}")
  fn = ctypes.CDLL(str(d / "libgen.so")).rn_generic_scan_launch
  fn.argtypes = list(_build.GEN_ARGTYPES)
  fn.restype = ctypes.c_int
  return fn


def template_ab(torch, dev, gen, parent_template):
  """Kernels 4 and 5 as chip_smoke.py compares them (the live spec's
  ECEF_POS tile, gate on, from the live x0 and P0; loc epochs in double),
  each emitted source built with this tree's template and with the
  parent's, timed in turns (parent, this, this, parent; raw launches, mean
  of REPS after a warm-up). Their emitted text is the same in both
  trees."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  live_spec = cs.generic_models()[3]
  LocKalman = cs.generic_models()[1]
  f32 = dict(dtype=torch.float32, device=dev)
  f64 = dict(dtype=torch.float64, device=dev)
  cases = {}
  call4 = gs.KernelCall(
      live_spec, "single", (K.ECEF_POS,), Q=LiveKalman.Q,
      R_list=(LiveKalman.obs_noise[K.ECEF_POS],), gate=True,
      structure=sparsity.structure_for(live_spec, LiveKalman.initial_x))
  x = torch.as_tensor(LiveKalman.initial_x, **f32)[:, None].repeat(
      1, cs.LIVE_B)
  P = torch.as_tensor(np.diag(LiveKalman.initial_P_diag), **f32)[
      :, :, None].repeat(1, 1, cs.LIVE_B)
  cases["kernel 4, live spec ECEF_POS, gate on"] = (
      call4, call4.source(),
      (x, P, (torch.as_tensor(LiveKalman.initial_x[0:3], **f32)[:, None]
              + 5.0 * torch.randn((cs.CMP_T, 3, cs.LIVE_B), generator=gen,
                                  device=dev)).contiguous(),
       torch.full((cs.CMP_T,), 0.01, **f32)), {})
  call5 = cs.loc_epoch_call()
  zs, eas = cs.loc_consistent_data(torch, dev, gen, cs.CMP_T,
                                   len(cs.loc_slots()))
  x = torch.as_tensor(LocKalman.initial_x, **f64)[:, None].repeat(
      1, cs.GEN_B)
  P = torch.as_tensor(np.diag(LocKalman.initial_P_diag), **f64)[
      :, :, None].repeat(1, 1, cs.GEN_B)
  cases["kernel 5, loc epochs, float64"] = (
      call5, call5.source(torch.float64),
      (x, P, zs.transpose(-1, -2).contiguous(),
       torch.full((cs.CMP_T,), 0.1, **f64)),
      dict(eas=eas.transpose(-1, -2).contiguous()))
  with ThreadPoolExecutor(2 * len(cases)) as pool:
    fns = {(name, which): pool.submit(
        build_with_template, f"ab_{i}_{which}", src,
        parent_template if which == "parent" else _build.TEMPLATE)
           for i, (name, (_, src, _, _)) in enumerate(cases.items())
           for which in ("parent", "this")}
    fns = {k: f.result() for k, f in fns.items()}
  out = {}
  for name, (call, src, args, kw) in cases.items():
    times = {"parent": [], "this": []}
    for which in ("parent", "this", "this", "parent"):
      ms, _ = cs.timed_run(cs.generic_launch(src, call, *args, **kw,
                                             fn=fns[(name, which)]), REPS)
      times[which].append(ms)
    out[name] = {k: sum(v) / len(v) for k, v in times.items()}
    cs.log(f"template A/B, {name}: parent's template "
           f"{times['parent']} ms, this tree's {times['this']} ms")
  return out


def main():
  import torch

  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--parent", type=pathlib.Path, default=None,
                  help="a checkout of an earlier commit: its kernels 2 and "
                       "3 run beside these")
  ap.add_argument("--frames-only", action="store_true",
                  help="only kernel 7 and kernel 6 with camera frames (and "
                       "the template A/B with --parent)")
  args = ap.parse_args()
  if not torch.cuda.is_available():
    print("sweep_warps: no CUDA device", file=sys.stderr)
    return 1
  from rednose_tpu_torch import _build

  torch.backends.cuda.matmul.allow_tf32 = False
  card = cs.card_line()
  cs.log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev)
  gen.manual_seed(cs.SEED)
  cases = frame_cases(torch, dev, gen)
  t0 = time.perf_counter()
  fsrc = frame_sources(cases)
  cs.log(f"frame variants emitted in {time.perf_counter() - t0:.1f} s")
  results = {"card": card}
  if not args.frames_only:
    results |= live_sweep(torch, args, fsrc)
  else:
    t0 = time.perf_counter()
    _build.build_generated_many([s for v in fsrc.values()
                                 for s in v.values()])
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
  results["frames"] = frame_sweep(torch, cases, fsrc)
  if args.parent is not None:
    results["template A/B"] = template_ab(
        torch, dev, gen, args.parent / "rednose_tpu_torch" / "csrc" /
        "generic_scan.cuh")
  SWEEP_DIR.mkdir(parents=True, exist_ok=True)
  (SWEEP_DIR / "sweep_warps.json").write_text(json.dumps(results, indent=1))
  print(card)
  return 0


def live_sweep(torch, args, frame_srcs):
  """Kernels 2, 3, 4 and 6 (the live spec) at every W, built in one go
  with frame_srcs and, with args.parent, the parent's kernels 2 and 3."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs, live_scan, sparsity
  from rednose_tpu_torch.utils.compare import lane_sigma_errs, live_sigma_err

  live_spec = cs.generic_models()[3]
  R4 = LiveKalman.obs_noise[K.ECEF_POS]
  st = sparsity.structure_for(live_spec, LiveKalman.initial_x)
  kinds6 = cs.mixed_kinds()
  R6 = [LiveKalman.obs_noise[k] for k in kinds6]

  def k4_call():
    return gs.KernelCall(live_spec, "single", (K.ECEF_POS,), Q=LiveKalman.Q,
                         R_list=(R4,), gate=True, structure=st)

  def k6_call():
    return gs.KernelCall(live_spec, "mixed", kinds6, Q=LiveKalman.Q,
                         R_list=R6, structure=st)

  gen_src = {}
  for kernel, fn in (("kernel 4", k4_call), ("kernel 6", k6_call)):
    gen_src[kernel] = {f"W={w}": k4_source(fn, roles=w) for w in WS}
    gen_src[kernel]["global"] = k4_source(fn, global_form=True)
  csrc = ROOT / "rednose_tpu_torch" / "csrc"
  jobs = {f"W={w}": (f"k3_w{w}", csrc, w) for w in WS}
  if args.parent is not None:
    jobs["parent"] = ("k3_parent", args.parent / "rednose_tpu_torch" / "csrc",
                      None)
  t0 = time.perf_counter()
  with ThreadPoolExecutor(len(jobs) + 2) as pool:
    static = pool.submit(_build.build)
    k3_jobs = {k: pool.submit(build_k3, *v) for k, v in jobs.items()}
    _build.build_generated_many([src for v in (gen_src | frame_srcs).values()
                                 for src in v.values()])
    static.result()
    k3_builds = {k: j.result() for k, j in k3_jobs.items()}
  cs.log(f"built in {time.perf_counter() - t0:.1f} s")

  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev)
  gen.manual_seed(cs.SEED)
  states = cs.main_path(torch, dev, gen)
  f32 = dict(dtype=torch.float32, device=dev)
  results = {"kernel 2": {}, "kernel 3": {}, "kernel 4": {}, "kernel 6": {}}

  # kernels 3 and 6: chip_smoke's comparison inputs of kernel 3
  x_m, P_m, q_diag = states["live_bank_scan_mixed"]
  kinds, kind_idx, zs_m = cs.mixed_schedule(torch, dev, gen, cs.CMP_T)
  R_by_kind = torch.stack([torch.as_tensor(LiveKalman.obs_noise[k], **f32)
                           for k in kinds])
  r_stream = (0.05 + 0.01 * torch.rand((cs.CMP_T, 3), generator=gen,
                                       device=dev)) ** 2
  zs3 = zs_m.permute(0, 2, 1).contiguous()
  dts = torch.full((cs.CMP_T,), 0.01, **f32)
  ki = torch.as_tensor(kind_idx, dtype=torch.int32, device=dev)
  stream_kinds = (K.CAMERA_ODO_ROTATION,)
  ref3 = live_scan.live_bank_scan_mixed_reference(
      x_m, P_m, zs3, dts, ki, kinds, R_by_kind, q_diag, gate=True,
      r_stream=r_stream, stream_kinds=stream_kinds)
  # kernels 2 and 4: chip_smoke's comparison inputs of kernel 2
  x, P = states["live_bank_scan"][:2]
  zs = (torch.as_tensor(LiveKalman.initial_x[0:3], **f32)[:, None]
        + 5.0 * torch.randn((cs.CMP_T, 3, cs.LIVE_B), generator=gen,
                            device=dev)).contiguous()
  R2 = torch.as_tensor(R4, **f32)
  ref2 = live_scan.live_bank_scan_reference(x, P, zs, dts, q_diag, R2,
                                            gate=True)
  for name, (path, ptx, secs) in k3_builds.items():
    lib = load_k3(path)

    def launch3(T, lib=lib):
      return cs.kernel3_launch(lib, x_m, P_m, zs3[:T], dts[:T], ki[:T],
                               kinds, R_by_kind, q_diag, True, r_stream[:T],
                               stream_kinds)

    def launch2(T, lib=lib):
      return cs.kernel2_launch(lib, x, P, zs[:T], dts[:T], q_diag, R2, True)

    for kernel, launch, ref, entry in (
        ("kernel 3", launch3, ref3, "live_bank_scan_mixed_info"),
        ("kernel 2", launch2, ref2, "live_bank_scan_info")):
      out = launch(cs.CMP_T)()
      ms, _ = cs.timed_run(launch(cs.CMP_T), REPS)
      ms1, _ = cs.timed_run(launch(1), REPS)
      err = max(live_sigma_err(*out, *ref))
      info = k3_info(lib, entry)
      results[kernel][name] = dict(ms_T64=ms, ms_T1=ms1, sigma_err=err,
                                   ptxas=ptx[kernel], nvcc_s=secs, info=info)
      cs.log(f"{kernel} {name}: T=64 {ms:.4f} ms, T=1 {ms1:.4f} ms, "
             f"{err:.4g} sigma from plain; ptxas {ptx[kernel]}; runtime "
             f"{info}; nvcc {secs:.1f} s")

  # kernel 4 on the live spec (ECEF_POS, gate on) and kernel 6 on its
  # 4-kind cycle, each at every W and in the global form
  call4, call6 = k4_call(), k6_call()
  ref4 = gs.generic_bank_scan_reference(x, P, zs, dts, spec=live_spec,
                                        kind=K.ECEF_POS, Q=LiveKalman.Q,
                                        R=R4, gate=True, structure=st)
  ref6 = gs.generic_bank_scan_mixed_reference(
      x_m, P_m, zs3, dts, ki, spec=live_spec, kinds=kinds6, Q=LiveKalman.Q,
      R_list=R6, structure=st)
  cases = {"kernel 4": (call4, (x, P, zs, dts), {}, ref4),
           "kernel 6": (call6, (x_m, P_m, zs3, dts), {"kind_idx": ki},
                        ref6)}
  for kernel, (call, args_, kw, ref) in cases.items():
    for name, src in gen_src[kernel].items():
      xx, PP, zz, dd = args_

      def launch(T, src=src):
        return cs.generic_launch(src, call, xx, PP, zz[:T], dd[:T],
                                 **{k: v[:T] for k, v in kw.items()})

      out = launch(cs.CMP_T)()
      ms, _ = cs.timed_run(launch(cs.CMP_T), REPS)
      ms1, _ = cs.timed_run(launch(1), REPS)
      err = float(torch.maximum(*lane_sigma_errs(live_spec, *out,
                                                 *ref)).max())
      report = _build.generated_ptxas(src)
      ptx = kernel_ptxas(report, "rn_generic")
      nvcc = [ln for ln in report.splitlines() if "nvcc wall" in ln]
      info = _build.generated_info(src)
      results[kernel][name] = dict(ms_T64=ms, ms_T1=ms1, sigma_err=err,
                                   ptxas=ptx, lines=len(src.splitlines()),
                                   nvcc=nvcc, info=info)
      cs.log(f"{kernel} {name}: T=64 {ms:.4f} ms, T=1 {ms1:.4f} ms, "
             f"{err:.4g} sigma from plain; {len(src.splitlines())} lines; "
             f"ptxas {ptx}; runtime {info}; {nvcc}")
  return results


if __name__ == "__main__":
  sys.exit(main())
