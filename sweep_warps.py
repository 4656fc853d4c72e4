#!/usr/bin/env python3
"""Measure the design constants of the port's tile kernels on one card:
kernels 2, 3, 4, 5 and 6 at W = 1, 2, 4 and 8 warps a block, kernels 7
and 6 with camera frames at W = 4, 8 and 16, kernel 9 (the log scan) and
kernel 10 (its adjoint) at W = 2, 4, 8, 16 and 32, kernel 1's ring,
kernel 8's block size, and kernel 15's ring, warps and unroll.

    python3 sweep_warps.py [--parent DIR] [--parts PART ...]   # repo root

PART is one of live (kernels 2, 3, 4 and 6 on the live spec), frames
(kernel 7 and kernel 6 with camera frames), kinematic (kernel 1), epoch
(kernel 5) and stream (kernel 9: chip_smoke.stream_calls' float32 live
log at B = 64 and float64 refinement log at B = 1, each timed at
T = 256 and T = 8192 beside its global form, its per-lane-store form
and three timing aids: without its stack stores, without its shared
functions, its stack stores only; stream_sweep) and triangulate (kernel
8 on the VIO store's frames 0 and 31 and on the long-tail batch at three
block sizes, a stride-0 window also as its contiguous copy, beside its
launch floor; with --parent the parent's kernel and wrapper in turns:
tri_sweep) and adjoint (kernel 10: chip_smoke.adjoint_calls' float32
live log adjoint at B = 64, T = 256 and 8192, at each W beside its
global form and timing aids; with --parent the parent's kernel 10 in
turns: adjoint_sweep) and smooth (kernels 11 and 12, the smoother's gains
and sequential pass, on chip_smoke.compare_smoother's 64 x 8192 live log:
kernel 12 at 2-16 covariance warps, 2-8 ring stages and its products'
tiles, kernel 11 at register tiles 2-4 and 4 or 8 items a block, with F
whole as the parent's, the timing aids of each and
the split they give; with --parent the parent's kernels 11 and 12 and its
kernel 11's aids, in turns, held bitwise: smooth_sweep) and affine (kernel
13, the parallel smoother's suffix scan, on compare_smoother's elements:
ring stages 2-4, the products' tiles, fused or apart, the launch
bounds, chunks of 32-256, the timing aids, each pass timed apart; with
--parent the parent's kernel 13 split apart and in turns, held bitwise:
affine_sweep) and bank (kernel 15, run_bank's bank scan: its ring's
steps a stage x stages x W on the kinematic 16384 x 4096 bank, W = 1
and 2 on the car, op battery and live specs, the chunk loop's unroll,
the timing aids; with --parent the parent's kernel 15 in turns:
bank_sweep) and smooth_adjoint (kernels 11' and 12', the smoother's
adjoint, on the thirteenth path's shapes: 12' on lane 0 at T = 8192, 11'
on the 64 x 8192 bank's elements, float32 and float64, with the timing
aids and 12''s passes apart; with --parent the parent's kernels, its
aids (its smooth_adjoint.cuh cut) and both in turns, held against each
other: smooth_adjoint_sweep); all eleven by default. W is a constant of
each source:
`POS_WARPS` and `WARPS` in csrc/live_mixed.cuh (kernels 2 and 3,
LiveKalmanBank.run and run_mixed; each build sets both), `TILE_ROLES` in
ops/entry_slab.py (kernel 4, mode "single", kernel 5, mode "epoch", and
kernel 6, mode "mixed" without a camera-frame unit) and
`TILE_ROLES_FRAME` (kernel 7, mode "frame", and kernel 6 with a
camera-frame unit), `TILE_ROLES_STREAM` (kernel 9, mode "stream"),
`TILE_ROLES_ADJOINT` (kernel 10, mode "stream_adjoint");
kernel 8's `BLOCK_THREADS` in csrc/triangulate.cu; kernels 11 and 12's
`RN_SM_*` in csrc/smooth.cuh; kernel 13's `RN_AF_*` in
csrc/affine_scan.cu.
Kernel 1's are `LANES`, `CHUNK` and `STAGES` in
csrc/kinematic_scan.cu (filters a block, steps a ring stage, stages).
This script builds each kernel at each value, nvcc processes in
parallel: kernels 1, 2 and 3 from a copy of their source with the
constant replaced, the generic kernels by emitting their variants with
the emitter's constant set (the live spec's ECEF_POS variant, gate on,
and its 4-kind mixed variant; loc's 8-slot epoch in float32 and double;
both MSCKF models' frame and VIO variants). It also builds the global
form of each emitted variant (one thread a filter, P in global memory:
the design before the tile), kernel 5's tile with its slot loop the
other way (unrolled), and the timing aids, whose numbers are garbage:
kernel 1 with
its loads taken out (its recurrence floor), kernel 5's float32 tile at
W = 1 and the shipped W without its shared functions, its update roles
or its predict, and, of the camera-frame tiles at the shipped W, the tile
without its innovation stages, and without its serial ones. Given --parent (a
checkout of an earlier commit of this repository) it builds that
commit's csrc/live_scan.cu and csrc/kinematic_scan.cu, so its kernels 1,
2 and 3 run in the same call (kernel 1 timed in turns with this one and
its output held bitwise against it), builds kernel 5's global form with
that commit's csrc/generic_scan.cuh and times it in turns with the tile,
and times kernels 4, 6 and 7 built with that template and with this one,
in turns (template_ab). Inputs are chip_smoke.py's: kernel 1 at
B = 16384, T = 4096, gate on; kernels 3 and 6 from the live bank after
run_mixed over T = 1024 steps of the 4-kind schedule (B = 8192; kernel 3
with the gate on and the camera-rotation kind streaming its R), kernels 2
and 4 from the bank after the ECEF_POS run (gate on), kernel 5 on loc's
local-scale case (loc_local_case, B = 8192, T = 64), kernels 7 and 6
with frames from a fresh bank of B = 4096 on consistent frames (kernel 7
T = 16, kernel 6 the VIO schedule at T = 64). For each build it prints
the time (CUDA events, mean of 5-10 launches after a warm-up) at that T
and at T = 1, the largest difference from the plain version in standard
deviations (utils/compare.py), ptxas (registers, stack, spill bytes), the
runtime's blocks per SM and, for the emitted kernels, the emitted lines
and nvcc seconds, and writes them all to build/sweep_warps/sweep_warps.json.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import statistics
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
PARTS = ("live", "frames", "kinematic", "epoch", "stream", "triangulate",
         "adjoint", "smooth", "affine", "bank", "smooth_adjoint")
STREAM_WS = (2, 4, 8, 16, 32)
STREAM_TS = (256, 8192)   # the wrapped hold's T and the offline path's


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


kernel_ptxas = cs.kernel_ptxas


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


def k4_source(call_fn, roles=None, global_form=False, dtype=None,
              **consts):
  """The source of a kernel-4, 5, 6 or 7 call emitted with the emitter's
  constants set: roles into TILE_ROLES, consts (e.g. TILE_ROLES_FRAME) by
  name, no shared memory for a tile with global_form; for a bank of dtype
  (float32 unless given)."""
  import torch

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
    return call_fn().source(dtype or torch.float32)
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


# ---------------------------------------------------------------- kernel 1
# LANES (filters a block), CHUNK (steps a ring stage) and STAGES (ring
# stages) of csrc/kinematic_scan.cu; a configuration is swept when the
# blocks an SM that B = 16384 gives fit the SM's 228 KB of shared memory
K1_LANES, K1_CHUNKS, K1_STAGES = (32, 64, 128), (32, 64, 128), (2, 3, 4)
SM_SMEM, SMS = 228 * 1024, 132


def k1_configs():
  """Every (LANES, CHUNK, STAGES) of the sweep that fits."""
  out = []
  for lanes in K1_LANES:
    per_sm = -(-cs.KIN_B // lanes // SMS)
    for chunk in K1_CHUNKS:
      for stages in K1_STAGES:
        smem = stages * (chunk * lanes + 2 * chunk) * 4
        if per_sm * smem <= SM_SMEM and smem <= 232_448:
          out.append((lanes, chunk, stages))
  return out


def recurrence_floor(text):
  """Kernel 1 with its loads taken out: no copies into the ring, z a value
  of the step index and dt, r the first step's, read once into registers:
  the time of the step's dependent chain alone (a timing aid; its numbers
  are garbage)."""
  text, n = re.subn(r"(\n\s*)stage_chunk\(ring", r"\1if (0) stage_chunk(ring",
                    text)
  reads = {"const float q00 = q[0], q01 = q[1], q11 = q[2];":
               "const float q00 = q[0], q01 = q[1], q11 = q[2];\n"
               "  const float dt0 = __ldg(dts), r0 = __ldg(rs);",
           "const float dt = dtr[j];": "const float dt = dt0;",
           "const float r = rr[j];": "const float r = r0;",
           "const float z = zr[j * LANES + tid];":
               "const float z = (float)(j & 7);"}
  if n != 2 or not all(k in text for k in reads):
    raise RuntimeError("kinematic_scan.cu: no ring copies and reads to take "
                       "out")
  for k, v in reads.items():
    text = text.replace(k, v)
  return text


def build_k1(name, source, consts=None, floor=False):
  """nvcc of a kinematic_scan.cu (its LANES, CHUNK, STAGES replaced when
  consts gives them; its loads taken out with floor) into a directory of
  its own: (library, ptxas lines, nvcc seconds)."""
  from rednose_tpu_torch import _build

  d = SWEEP_DIR / name
  shutil.rmtree(d, ignore_errors=True)
  d.mkdir(parents=True)
  text = source.read_text()
  for k, v in (consts or {}).items():
    text, n = re.subn(rf"constexpr int {k} = \d+;", f"constexpr int {k} = {v};",
                      text)
    if n != 1:
      raise RuntimeError(f"kinematic_scan.cu: no constant {k}")
  if floor:
    text = recurrence_floor(text)
  (d / "kinematic_scan.cu").write_text(text)
  t0 = time.perf_counter()
  proc = subprocess.run(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
       str(d / "kinematic_scan.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  secs = time.perf_counter() - t0
  if proc.returncode:
    raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}")
  lib = ctypes.CDLL(str(d / "lib.so"))
  for fn in ("kinematic_bank_scan_launch", "kinematic_bank_scan_info"):
    if hasattr(lib, fn):
      getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
      getattr(lib, fn).restype = ctypes.c_int
  return lib, kernel_ptxas(proc.stdout, "kinematic_bank_scan_kernel"), secs


def k1_info(lib):
  if not hasattr(lib, "kinematic_bank_scan_info"):
    return None
  out = (ctypes.c_int * 8)()
  from rednose_tpu_torch import _build
  _build.check(lib.kinematic_bank_scan_info(ctypes.addressof(out)), "info")
  return dict(zip(("warps", "threads", "smem_bytes", "blocks_per_sm",
                   "registers", "local_bytes", "chunk_steps", "stages"), out))


def k1_sweep(torch, dev, gen, parent=None):
  """Kernel 1 at B = 16384, T = 4096, gate on (chip_smoke's inputs) at
  every configuration of k1_configs, its recurrence floor at the shipped
  one and, with parent (a checkout), the parent commit's kernel 1, timed in
  turns with the shipped one (parent, this, this, parent) and its output
  held bitwise against it. Raw launches, mean of 10 after a warm-up."""
  from rednose_tpu_torch.ops import kinematic_scan
  from rednose_tpu_torch.utils.compare import kinematic_sigma_err

  src = ROOT / "rednose_tpu_torch" / "csrc" / "kinematic_scan.cu"
  jobs = {f"L={lanes} C={chunk} S={stages}": (
      f"k1_{lanes}_{chunk}_{stages}", src,
      dict(LANES=lanes, CHUNK=chunk, STAGES=stages))
      for lanes, chunk, stages in k1_configs()}
  jobs["shipped"] = ("k1_shipped", src, None)
  jobs["recurrence floor (timing aid)"] = ("k1_floor", src, None, True)
  if parent is not None:
    jobs["parent"] = ("k1_parent", parent / "rednose_tpu_torch" / "csrc" /
                      "kinematic_scan.cu", None)
  t0 = time.perf_counter()
  with ThreadPoolExecutor(8) as pool:
    builds = {k: pool.submit(build_k1, *v) for k, v in jobs.items()}
    builds = {k: b.result() for k, b in builds.items()}
  cs.log(f"kernel 1: {len(builds)} builds in {time.perf_counter() - t0:.1f} s")
  args = cs.kinematic_inputs(torch, dev, gen)
  ref = kinematic_scan.kinematic_scan_reference(*args, maha=True)

  def launch(lib, T=cs.KIN_T):
    state, zs, dts, rs, q = args
    return cs.kernel1_launch(lib, state, zs[:T], dts[:T], rs[:T], q)

  shipped = launch(builds["shipped"][0])().clone()
  results = {}
  for name, (lib, ptx, secs) in builds.items():
    out = launch(lib)()
    ms, _ = cs.timed_run(launch(lib), 10)
    ms1, _ = cs.timed_run(launch(lib, 1), 20)
    err = max(kinematic_sigma_err(out, ref))
    same = bool(torch.equal(out, shipped))
    results[name] = dict(ms=ms, ms_T1=ms1, sigma_err=err,
                         bitwise_as_shipped=same, ptxas=ptx, nvcc_s=secs,
                         info=k1_info(lib))
    cs.log(f"kernel 1 {name}: T={cs.KIN_T} {ms:.4f} ms, T=1 {ms1:.4f} ms, "
           f"{err:.4g} sigma from plain, bitwise as shipped {same}; ptxas "
           f"{ptx}; runtime {results[name]['info']}; nvcc {secs:.1f} s")
  if parent is not None:
    times = {"parent": [], "this": []}
    for which in ("parent", "this", "this", "parent"):
      lib = builds["parent" if which == "parent" else "shipped"][0]
      times[which].append(cs.timed_run(launch(lib), 10)[0])
    results["A/B"] = times
    cs.log(f"kernel 1 in turns: parent {times['parent']} ms, this "
           f"{times['this']} ms; output bitwise as the parent's "
           f"{results['parent']['bitwise_as_shipped']}")
  return results


# ---------------------------------------------------------------- kernel 5

def without_phase(src, phase):
  """An epoch tile source whose phase does nothing (a timing aid; its
  numbers are garbage): "shared" each unit's shared function, "update"
  each unit's role functions and their stores, "predict" the predict's
  role functions and their stores."""
  pattern = {"shared": r"gen_update_\w+_shared",
             "update": r"gen_update_\w+_r\d+(?:_store)?",
             "predict": r"gen_predict_r\d+(?:_store)?"}[phase]
  out, n = re.subn(rf"(GEN_HD GEN_INLINE void {pattern}\(.*\) \{{\n)",
                   r"\g<1>  return;\n", src)
  if not n:
    raise ValueError(f"no {phase} functions in the source")
  return out


SLOT_UNROLLED = "#pragma unroll\n    for (int k = 0; k < NSLOTS; ++k) {"
SLOT_ROLLED = "#pragma unroll 1\n    for (int k = 0; k < NSLOTS; ++k) {"


def toggle_slot_unroll(template):
  """(text, what it is): the template with its epoch loop over the slots
  unrolled if it is not, and not unrolled (one copy of each unit's code,
  switched on the slot's unit at run time) if it is."""
  if SLOT_UNROLLED in template:
    return template.replace(SLOT_UNROLLED, SLOT_ROLLED), "not unrolled"
  if SLOT_ROLLED in template:
    return template.replace(SLOT_ROLLED, SLOT_UNROLLED), "unrolled"
  raise RuntimeError("generic_scan.cuh: no epoch slot loop")


def epoch_sweep(torch, dev, gen, parent_template=None):
  """Kernel 5 on loc (8 slots) in float32 and double: the tile at W = WS
  and at W = 1, 2, 4 with its slot loop the other way (unrolled), the
  float32 tile at W = 1 and the shipped W without one of its phases
  (timing aids), and its global form (the design before, built with the parent's
  template when given), at T = CMP_T and T = 1 (raw launches) on
  chip_smoke's local-scale case (a converged bank, B = 8192), each against
  the plain version of its dtype in sigmas; the shipped tile and the
  global form also timed in turns (global, tile, tile, global)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import entry_slab, generic_scan as gs

  call = cs.loc_epoch_call()
  case64 = cs.loc_local_case(torch, dev, gen)
  srcs = {}
  for dt in (torch.float32, torch.float64):
    for w in WS:
      srcs[(dt, f"W={w}")] = k4_source(cs.loc_epoch_call, roles=w, dtype=dt)
    srcs[(dt, "global")] = call.source(dt, tile=False)
  for w in (1, entry_slab.TILE_ROLES):
    for phase in ("shared", "update", "predict"):
      srcs[(torch.float32, f"W={w} without its {phase} phase")] = \
          without_phase(k4_source(cs.loc_epoch_call, roles=w), phase)
  t0 = time.perf_counter()
  _build.build_generated_many(list(srcs.values()))
  fns = {k: _build.generated_launcher(v) for k, v in srcs.items()}
  # the slot loop the other way (unrolled or not), this tree's template
  other = SWEEP_DIR / "k5_template" / "generic_scan.cuh"
  other.parent.mkdir(parents=True, exist_ok=True)
  text, label = toggle_slot_unroll(_build.TEMPLATE.read_text())
  other.write_text(text)
  with ThreadPoolExecutor(8) as pool:
    jobs = {}
    for dt in (torch.float32, torch.float64):
      for w in WS[:3]:
        key = (dt, f"W={w}, slot loop {label}")
        srcs[key] = srcs[(dt, f"W={w}")]
        jobs[key] = pool.submit(build_with_template,
                                f"k5_{len(jobs)}_other", srcs[key], other)
    fns |= {k: j.result() for k, j in jobs.items()}
  if parent_template is not None:
    with ThreadPoolExecutor(2) as pool:
      jobs = {dt: pool.submit(build_with_template, f"k5_global_parent_{i}",
                              srcs[(dt, "global")], parent_template)
              for i, dt in enumerate((torch.float32, torch.float64))}
      for dt, j in jobs.items():
        fns[(dt, "global")] = j.result()
  cs.log(f"kernel 5: built in {time.perf_counter() - t0:.1f} s")
  results = {}
  for dt in (torch.float32, torch.float64):
    x, P, zs, eas, dts = (a.to(dt) for a in case64)
    ref = gs._plain(call, x, P, zs, dts, eas, None)
    name = str(dt).split(".")[-1]

    def launch(key, n=cs.CMP_T, x=x, P=P, zs=zs, eas=eas, dts=dts):
      return cs.generic_launch(srcs[key], call, x, P, zs[:n], dts[:n],
                               eas=eas[:n], fn=fns[key])

    for key in [k for k in srcs if k[0] == dt]:
      out = launch(key)()
      ms, _ = cs.timed_run(launch(key), REPS)
      ms1, _ = cs.timed_run(launch(key, 1), 20)
      err = float(cs.lane_errs(out, ref, call.spec).max())
      report = _build.generated_ptxas(srcs[key])
      info = _build.generated_info(srcs[key])
      results[f"{name} {key[1]}"] = dict(
          ms=ms, ms_T1=ms1, sigma_err=err, info=info,
          ptxas=kernel_ptxas(report, "rn_generic"),
          lines=len(srcs[key].splitlines()),
          nvcc=[ln for ln in report.splitlines() if "nvcc wall" in ln])
      cs.log(f"kernel 5 {name} {key[1]}: T={cs.CMP_T} {ms:.4f} ms, T=1 "
             f"{ms1:.4f} ms, {err:.4g} sigma from plain; "
             f"{results[f'{name} {key[1]}']}")
    tile = (dt, f"W={entry_slab.TILE_ROLES}")
    times = {"global": [], "tile": []}
    for which in ("global", "tile", "tile", "global"):
      key = (dt, "global") if which == "global" else tile
      times[which].append(cs.timed_run(launch(key), REPS)[0])
    results[f"{name} in turns"] = times
    cs.log(f"kernel 5 {name} in turns: global form {times['global']} ms, "
           f"tile {times['tile']} ms")
  return results


def build_with_template(name, source, template,
                        entry="rn_generic_scan_launch"):
  """nvcc of an emitted source beside the given template, in a directory
  of its own: its C entry (rn_generic_scan_launch unless named)."""
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
  fn = getattr(ctypes.CDLL(str(d / "libgen.so")), entry)
  fn.argtypes = list(_build.GEN_ENTRIES[entry])
  fn.restype = ctypes.c_int
  return fn


# ---------------------------------------------------------------- kernel 9

def without_stack_stores(template):
  """The template with its log-scan tile's stack stores taken out
  (rn_stream_store and rn_stream_store_tma return at once): a timing aid,
  its stacks garbage."""
  out, n = re.subn(
      r"(__device__ __forceinline__ void rn_stream_store(?:_tma)?\("
      r"[^)]*\) \{\n)", r"\g<1>  return;\n", template)
  if n != 2:
    raise RuntimeError("generic_scan.cuh: no rn_stream_store and "
                       "rn_stream_store_tma to take out")
  return out


def per_lane_stores(template):
  """The template with its log-scan tile's TMA stores turned off, so every
  lane stores its own values of the stacks' rows (the stores of a bank
  whose rows TMA cannot take): the design before the TMA stores."""
  old = "  const bool tma =\n"
  if old not in template:
    raise RuntimeError("generic_scan.cuh: no TMA condition in the launcher")
  return template.replace(old, "  const bool tma = false &&\n", 1)


def stream_cases(torch, dev, gen):
  """Kernel 9's two variants as the offline path runs them (chip_smoke.
  stream_calls), each with its inputs for max(STREAM_TS) steps in the
  bank-minor layout and its plain version's result on the first T_cmp:
  name -> (call, dtype, (x, P, zs, dts, kind_idx, Rs), T_cmp, reference,
  tolerance). The live log in float32 for RTS_B lanes from the state the
  shipped float64 tile reaches in SCAN_WARM steps from the prior (T_cmp =
  SCAN_CMP_T, within GEN_TOL); the cold refinement log in float64 for one
  lane from the prior (T_cmp = REFINE_T, within SCAN64_TOL)."""
  from torch.func import vmap

  from rednose_tpu_torch.runtime.scan import build_scan_stream_reference

  T = max(STREAM_TS)
  calls = cs.stream_calls()
  live, live_dt = calls["live log scan (kernel 9)"]
  ref_call, ref_dt = calls["refinement log scan (kernel 9), float64"]
  x0, P0, Q, dts, ki, zs, Rs, _ = cs.scan_log(
      torch, dev, gen, cs.SCAN_WARM + T, cs.RTS_B, torch.float64)
  bank = (x0.T.contiguous(), P0.permute(1, 2, 0).contiguous())
  zb = zs.transpose(1, 2).contiguous()
  W = cs.SCAN_WARM
  xw, Pw = cs.stream_launch(live.source(torch.float64), live, *bank,
                            zb[:W], dts[:W], ki[:W], Rs[:W])()[:2]
  f = lambda a: a.to(live_dt).contiguous()  # noqa: E731
  live_args = (f(xw), f(Pw), f(zb[W:]), f(dts[W:]), ki[W:], f(Rs[W:]))
  spec, args, _ = cs.refine_inputs(torch, dev, gen, T)
  x, P, _, dts_r, ki_r, zs_r, Rs_r, _ = args
  ref_args = (x[:, None].contiguous(), P[:, :, None].contiguous(),
              zs_r[:, :, None].contiguous(), dts_r, ki_r, Rs_r)
  out = {}
  for (name, (call, dt)), a, T_cmp, tol in zip(
      calls.items(), (live_args, ref_args), (cs.SCAN_CMP_T, cs.REFINE_T),
      (cs.GEN_TOL, cs.SCAN64_TOL)):
    plain, _ = build_scan_stream_reference(call.spec, call.kinds)
    xb, Pb, zz, dd, kk, RR = a
    Qd = torch.as_tensor(call.Q, dtype=dt, device=dev)
    eas = torch.zeros((T_cmp, 1), dtype=dt, device=dev)
    (xo, Po), (xp, Pp, xq, Pq) = vmap(
        lambda xl, Pl, zl: plain({}, xl, Pl, Qd, dd[:T_cmp], kk[:T_cmp], zl,
                                 RR[:T_cmp], eas),
        in_dims=(1, 2, 2))(xb, Pb, zz[:T_cmp])
    ref = (xo.T, Po.permute(1, 2, 0), xp.permute(1, 2, 0),
           Pp.permute(1, 2, 3, 0), xq.permute(1, 2, 0),
           Pq.permute(1, 2, 3, 0))
    out[name] = (call, dt, a, T_cmp, ref, tol)
  return out


def stream_sweep(torch, dev, gen):
  """Kernel 9 (chip_smoke.stream_calls: the live log in float32 at
  B = 64, the refinement log in float64 at B = 1) in tile form at W =
  STREAM_WS, in its global form (the design before) and, at the shipped
  W, with every lane storing its own stack values in place of the TMA
  stores (per_lane_stores; the refinement log's B = 1 takes no TMA
  either way), with three timing aids at the shipped W whose outputs are
  garbage: the tile without its stack stores, without its shared
  functions (role 0's serial part of the update), and with its stack
  stores only (every emitted phase returns at once: the floor that the
  stores of two blocks set). Each build against the plain version on stream_cases'
  inputs, then timed (raw launches, CUDA events, after a warm-up) at each
  T of STREAM_TS; the shipped tile and the global form also in turns
  (global, tile, tile, global) at the largest T."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import entry_slab

  w0 = entry_slab.TILE_ROLES_STREAM
  calls = cs.stream_calls()
  srcs = {}
  for name, (call, dt) in calls.items():
    srcs[name] = {f"W={w}": k4_source(lambda c=call: c, dtype=dt,
                                      TILE_ROLES_STREAM=w)
                  for w in STREAM_WS}
    srcs[name]["global"] = call.source(dt, tile=False)
    srcs[name][f"W={w0} without its shared functions"] = without_phase(
        call.source(dt), "shared")
    only = call.source(dt)
    for phase in ("shared", "update", "predict"):
      only = without_phase(only, phase)
    srcs[name][f"W={w0}, its stack stores only"] = only
  templates = {}
  for label, edit in ((f"W={w0} without its stack stores",
                       without_stack_stores),
                      (f"W={w0} with per-lane stack stores", per_lane_stores)):
    templates[label] = SWEEP_DIR / f"k9_{edit.__name__}" / "generic_scan.cuh"
    templates[label].parent.mkdir(parents=True, exist_ok=True)
    templates[label].write_text(edit(_build.TEMPLATE.read_text()))
  t0 = time.perf_counter()
  with ThreadPoolExecutor(2 * len(calls)) as pool:
    jobs = {(name, label): pool.submit(
        build_with_template, f"k9_{i}_{j}", call.source(dt), path,
        "rn_generic_stream_launch")
            for i, (name, (call, dt)) in enumerate(calls.items())
            for j, (label, path) in enumerate(templates.items())}
    # the live log's float64 tile too: stream_cases warms the state with it
    _build.build_generated_many(
        [s for v in srcs.values() for s in v.values()]
        + [calls["live log scan (kernel 9)"][0].source(torch.float64)])
    fns = {name: {b: _build.generated_launcher(s) for b, s in v.items()}
           for name, v in srcs.items()}
    for (name, label), j in jobs.items():
      fns[name][label] = j.result()
      srcs[name][label] = None
  cs.log(f"kernel 9: built in {time.perf_counter() - t0:.1f} s")
  cases = stream_cases(torch, dev, gen)
  results = {}
  for name, (call, dt, args, T_cmp, ref, tol) in cases.items():
    x, P, zs, dts, ki, Rs = args

    def launch(build, n):
      return cs.stream_launch(srcs[name][build] or "", call, x, P, zs[:n],
                              dts[:n], ki[:n], Rs[:n], fn=fns[name][build])

    key = f"{name}, B={x.shape[-1]}"
    results[key] = {}
    for build in srcs[name]:
      err = cs.stream_err(call.spec, launch(build, T_cmp)(), ref)
      torch.cuda.synchronize()
      row = dict(sigma_err=err, ms={})
      for n in STREAM_TS:
        row["ms"][n] = cs.timed_run(launch(build, n), REPS if n < 4096
                                    else 3)[0]
      if srcs[name][build] is not None:
        report = _build.generated_ptxas(srcs[name][build])
        row |= dict(ptxas=kernel_ptxas(report, "rn_generic"),
                    lines=len(srcs[name][build].splitlines()),
                    nvcc=[ln for ln in report.splitlines()
                          if "nvcc wall" in ln],
                    info=_build.generated_info(srcs[name][build]))
      results[key][build] = row
      aid = "without" in build or "only" in build   # its output garbage
      verdict = "" if aid else ", ok" if err <= tol else ", FAIL"
      cs.log(f"kernel 9 {key} {build}: " + ", ".join(
          f"T={n} {ms:.4f} ms ({ms / n * 1e3:.3f} us a step)"
          for n, ms in row["ms"].items())
          + f"; {err:.4g} sigma from plain at T={T_cmp} (tolerance {tol}"
          f"{verdict}); " + str({k: v for k, v in row.items()
                                 if k not in ("ms", "sigma_err")}))
    times = {"global": [], "tile": []}
    for which in ("global", "tile", "tile", "global"):
      build = "global" if which == "global" else f"W={w0}"
      times[which].append(cs.timed_run(launch(build, max(STREAM_TS)),
                                       3)[0])
    results[key]["in turns"] = times
    cs.log(f"kernel 9 {key} in turns at T={max(STREAM_TS)}: global form "
           f"{times['global']} ms, tile W={w0} {times['tile']} ms")
  return results


# --------------------------------------------------------------- kernel 10

ADJOINT_WS = (2, 4, 8, 16, 32)
ADJOINT_TS = (256, 8192)     # the smoke's hold and the tenth path's T
ADJ_FUNCS = {"stages": r"gen_adjt_\w+_s\d+_r\d+",
             "outputs": r"gen_adjt_\w+_f_r\d+",
             "stores": r"gen_adjt_\w+_w_r\d+"}


def adjoint_without(src, parts):
  """A kernel 10 tile source whose emitted functions of the given parts
  return at once (a timing aid; its numbers are garbage): "stages" each
  stage's role functions (the cut values), "outputs" each role's outputs,
  "stores" each role's stores."""
  out = src
  for part in parts:
    out, n = re.subn(rf"(GEN_HD GEN_INLINE void {ADJ_FUNCS[part]}\(.*\) "
                     r"\{\n)", r"\g<1>  return;\n", out)
    if not n:
      raise ValueError(f"no {part} functions in the source")
  return out


def without_adjoint_loads(header):
  """csrc/stream_adjoint.cuh with its tile's staged copies taken out
  (rn_adj_stage returns at once: each phase recomputes from the first
  step's state): a timing aid, its numbers garbage."""
  old = "    int B, int b0, int tid, bool whole) {\n"
  if header.count(old) != 1:
    raise RuntimeError("stream_adjoint.cuh: no rn_adj_stage to take out")
  return header.replace(old, old + "  return;\n")


def sass_instructions(lib):
  """The SASS instructions of a built library (cuobjdump -sass), or None
  where the toolkit has no cuobjdump: the code a launch may fetch."""
  from rednose_tpu_torch import _build

  tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
  if not tool.exists():
    return None
  out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                       text=True).stdout
  return len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+\S", out, re.M))


def build_adjoint(name, source, csrc):
  """nvcc of an emitted adjoint source beside the templates of the csrc
  directory given (generic_scan.cuh and stream_adjoint.cuh), in a
  directory of its own: its rn_generic_stream_adjoint_launch."""
  from rednose_tpu_torch import _build

  d = SWEEP_DIR / name
  shutil.rmtree(d, ignore_errors=True)
  d.mkdir(parents=True)
  (d / "gen.cu").write_text(source)
  for h in ("generic_scan.cuh", "stream_adjoint.cuh"):
    shutil.copy(pathlib.Path(csrc) / h, d / h)
  proc = subprocess.run(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
       str(d / "libgen.so"), str(d / "gen.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  if proc.returncode:
    raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}")
  (d / "libgen.ptxas.txt").write_text(proc.stdout)
  entry = "rn_generic_stream_adjoint_launch"
  fn = getattr(ctypes.CDLL(str(d / "libgen.so")), entry)
  fn.argtypes = list(_build.GEN_ENTRIES[entry])
  fn.restype = ctypes.c_int
  return fn, kernel_ptxas(proc.stdout, "rn_generic_stream_adjoint")


PARENT_ADJOINT = """
import sys
import torch
import chip_smoke as cs
call = cs.adjoint_calls()["live log adjoint (kernel 10)"][0]
open(sys.argv[1], "w").write(call.source(torch.float32))
"""


def adjoint_sweep(torch, dev, gen, parent=None):
  """Kernel 10 (chip_smoke.adjoint_calls' live log adjoint in float32,
  the tenth path's variant) in tile form at W = ADJOINT_WS and in its
  global form (the design before), with timing aids at the shipped W whose
  outputs are garbage: without the staged copies of the stacks (each
  phase recomputes from the first step's state), the cut stages only (no
  outputs, no stores), the outputs and stores only (no stages), the
  stores only, and nothing but the loop's barriers and copies. Each build
  on chip_smoke's inputs (the live log for RTS_B lanes from the prior,
  kernel 9's stacks, random cotangents), held against the global form at
  T = 256 (the largest relative difference over the outputs; not the
  aids), then timed (raw launches, CUDA events, after a warm-up) at each
  T of ADJOINT_TS (the global form at T = 256 only: ~2.1 s a launch at
  T = 8192). With parent (a checkout of the parent commit), the parent's
  kernel 10 (its emitter run in a subprocess there, built with its
  templates) in turns with the shipped tile (parent, tile, tile, parent)
  at T = 256. Each emitted build's SASS instruction count (cuobjdump,
  where the toolkit has it): the code a step fetches."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import entry_slab

  w0 = entry_slab.TILE_ROLES_ADJOINT
  call = cs.adjoint_calls()["live log adjoint (kernel 10)"][0]
  fwd = cs.stream_calls()["live log scan (kernel 9)"][0]
  t0 = time.perf_counter()
  srcs = {f"W={w}": k4_source(lambda: call, dtype=torch.float32,
                              TILE_ROLES_ADJOINT=w) for w in ADJOINT_WS}
  srcs["global"] = call.source(torch.float32, tile=False)
  tile = srcs[f"W={w0}"]
  aids = {f"W={w0}, the cut stages only": ("outputs", "stores"),
          f"W={w0}, outputs and stores only": ("stages",),
          f"W={w0}, stores only": ("stages", "outputs"),
          f"W={w0}, barriers and copies only": ("stages", "outputs",
                                                "stores")}
  for label, parts in aids.items():
    srcs[label] = adjoint_without(tile, parts)
  cs.log(f"kernel 10: emitted in {time.perf_counter() - t0:.1f} s: "
         + ", ".join(f"{k} {len(v.splitlines())} lines"
                     for k, v in srcs.items()))
  csrc = ROOT / "rednose_tpu_torch" / "csrc"
  noload = SWEEP_DIR / "k10_noload"
  noload.mkdir(parents=True, exist_ok=True)
  shutil.copy(csrc / "generic_scan.cuh", noload / "generic_scan.cuh")
  (noload / "stream_adjoint.cuh").write_text(
      without_adjoint_loads((csrc / "stream_adjoint.cuh").read_text()))
  extra = {f"W={w0} without the staged copies": (tile, noload),
           f"W={w0}, barriers only": (srcs[f"W={w0}, barriers and copies "
                                           "only"], noload)}
  if parent is not None:
    out = SWEEP_DIR / "k10_parent.cu"
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, "-c", PARENT_ADJOINT, str(out)],
                   cwd=parent, check=True)
    extra["parent"] = (out.read_text(),
                       pathlib.Path(parent) / "rednose_tpu_torch" / "csrc")
  t0 = time.perf_counter()
  with ThreadPoolExecutor(len(extra)) as pool:
    jobs = {k: pool.submit(build_adjoint, f"k10_{i}", src, d)
            for i, (k, (src, d)) in enumerate(extra.items())}
    _build.build_generated_many(list(srcs.values())
                                + [fwd.source(torch.float32)])
    fns = {k: _build.generated_launcher(v) for k, v in srcs.items()}
    reports = {k: kernel_ptxas(_build.generated_ptxas(v), "rn_generic")
               for k, v in srcs.items()}
    for k, j in jobs.items():
      fns[k], reports[k] = j.result()
  cs.log(f"kernel 10: built in {time.perf_counter() - t0:.1f} s")
  x0, P0, _, dts, ki, zs, Rs, _ = cs.scan_log(
      torch, dev, gen, max(ADJOINT_TS), cs.RTS_B, torch.float32)
  x0b, P0b = x0.T.contiguous(), P0.permute(1, 2, 0).contiguous()
  zsb = zs.transpose(1, 2).contiguous()
  cases = {}
  for n in ADJOINT_TS:
    stacks = cs.stream_launch(fwd.source(torch.float32), fwd, x0b, P0b,
                              zsb[:n], dts[:n], ki[:n], Rs[:n])()[2:]
    cots = [torch.randn(a.shape, generator=gen, device=dev)
            for a in (x0b, P0b, *stacks)]
    cases[n] = (stacks, cots)

  def launch(build, n):
    stacks, cots = cases[n]
    return cs.adjoint_launch(srcs.get(build, ""), call, x0b, P0b, zsb[:n],
                             dts[:n], ki[:n], Rs[:n], stacks, cots,
                             fn=fns[build])

  n0 = min(ADJOINT_TS)
  ref = [o.double() for o in launch("global", n0)()[:7]]
  results = {}
  for build in fns:
    row = {"ms": {}, "ptxas": reports[build]}
    if build in srcs:
      row["info"] = _build.generated_info(srcs[build])
      row["lines"] = len(srcs[build].splitlines())
      row["sass"] = sass_instructions(
          _build.generated_dir(srcs[build]) / "libgen.so")
    aid = "only" in build or "without" in build
    if not aid:
      got = launch(build, n0)()[:7]
      row["rel_err"] = max(
          float((g.double() - r).abs().max() / r.abs().max().clamp_min(1e-30))
          for g, r in zip(got[:6], ref[:6]))
    for n in ADJOINT_TS:
      if n > n0 and build in ("global", "parent"):
        continue
      ms, _ = cs.timed_run(launch(build, n), REPS if n == n0 else 2)
      row["ms"][n] = ms
    results[build] = row
    cs.log(f"kernel 10 {build}: " + ", ".join(
        f"T={n} {ms:.4f} ms ({ms / n * 1e3:.3f} us a step)"
        for n, ms in row["ms"].items())
        + (f"; {row['rel_err']:.3g} from the global form at T={n0}"
           if "rel_err" in row else " (aid: output garbage)")
        + f"; {row.get('info', '')} ptxas {row['ptxas']}; "
        f"{row.get('sass')} SASS instructions")
  if parent is not None:
    times = {"parent": [], "tile": []}
    for which in ("parent", "tile", "tile", "parent"):
      times[which].append(cs.timed_run(
          launch("parent" if which == "parent" else f"W={w0}", n0),
          REPS)[0])
    results["in turns"] = times
    cs.log(f"kernel 10 in turns at T={n0}: parent {times['parent']} ms, "
           f"tile W={w0} {times['tile']} ms")
  return results


# ------------------------------------------------------------ kernels 11-12
SMOOTH_WS = (2, 4, 8, 16)      # kernel 12's covariance warps
SMOOTH_STAGES = (2, 4, 8)      # its ring's stages
SMOOTH_TILES = (2, 3, 4)       # kernel 11's register tiles
SMOOTH_GAINS_WS = (4, 8)       # kernel 11's items a block
# kernel 12's (covariance warps, M1's tile, M's pair tile) beyond the
# least tiles that fit
SMOOTH_COV_TILES = ((8, 2, 1), (8, 2, 2), (8, 3, 2), (8, 3, 3), (4, 3, 2),
                    (4, 3, 3))

# timing aids (csrc/smooth.cuh RN_SM_AID bits; outputs garbage)
SMOOTH_AIDS_11 = {"F and u precomputed": 1, "factor and solve only": 1 | 2,
                  "products only": 1 | 4, "loads and stores only": 1 | 2 | 4}
SMOOTH_AIDS_12 = {"without the state chain": 8,
                  "without the covariance chain": 16,
                  "without the ring (direct loads)": 32,
                  "ring and rows only": 8 | 16}
# the parent's kernel 11 aids, its smooth.cuh patched as RN_SM_AID would
_LOOP = "    for (int k = 0; k < D2; ++k) s += "
PARENT_AID_CUTS = {
    1: ["  if (tid == 0) rn_gen::gen_sm_F<S>(xq0, dt, p, F);\n",
        "  if (tid == 0) rn_gen::gen_sm_inv_err<S>(xp1, xq1, p, u);\n"],
    2: [_LOOP + "F[i * D2 + k] * Pk[j * D2 + k];\n",
        _LOOP + "X[k * D2 + i] * u[k];\n",
        _LOOP + "X[k * D2 + i] * F[k * D2 + j];\n",
        _LOOP + "Pk[i * D2 + k] * X[k * D2 + j];\n"],
    4: ["  cholesky<S, BLOCK>(L, diag, tid, nt);"
        "   // syncs first: X is complete\n"
        "  cho_solve<S>(L, diag, X, tid, nt);\n"],
}
PARENT_SMOOTH = """
import sys
from rednose_tpu_torch.models.live import LiveKalman
from rednose_tpu_torch.ops import smooth_scan
open(sys.argv[1], "w").write(smooth_scan.smooth_source(
    LiveKalman.build_spec(), ()))
"""


def smooth_variant(src, **consts):
  """The live smoother's source with csrc/smooth.cuh's design constants
  (RN_SM_COV_WARPS, RN_SM_BACK_STAGES, RN_SM_TILE, RN_SM_GAINS_WARPS,
  RN_SM_AID) set by #defines ahead of it."""
  return "".join(f"#define RN_SM_{k} {v}\n" for k, v in consts.items()) + src


def parent_smooth_header(csrc, aid):
  """The parent's csrc/smooth.cuh with the cuts of aid's bits
  (PARENT_AID_CUTS) taken out: the factor's cut keeps a __syncwarp."""
  text = (pathlib.Path(csrc) / "smooth.cuh").read_text()
  for bit, cuts in PARENT_AID_CUTS.items():
    if aid & bit:
      for cut in cuts:
        if text.count(cut) != 1:
          raise RuntimeError(f"parent smooth.cuh: no {cut!r} to cut")
        text = text.replace(cut, "  sync_<BLOCK>();\n" if bit == 4 else "")
  return text


def build_smooth(name, source, csrc, header=None, adjoint_header=None):
  """nvcc of a smoother source beside the csrc directory's
  generic_scan.cuh, smooth.cuh (or the header text given) and
  smooth_adjoint.cuh (or adjoint_header), in a directory of its own: the
  library, its SMOOTH_ENTRIES declared, and its ptxas report."""
  from rednose_tpu_torch import _build

  d = SWEEP_DIR / name
  shutil.rmtree(d, ignore_errors=True)
  d.mkdir(parents=True)
  (d / "gen.cu").write_text(source)
  shutil.copy(pathlib.Path(csrc) / "generic_scan.cuh", d / "generic_scan.cuh")
  (d / "smooth.cuh").write_text(header if header is not None else (
      pathlib.Path(csrc) / "smooth.cuh").read_text())
  adj = pathlib.Path(csrc) / "smooth_adjoint.cuh"
  if adjoint_header is not None or adj.exists():
    (d / adj.name).write_text(adjoint_header if adjoint_header is not None
                              else adj.read_text())
  proc = subprocess.run(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
       str(d / "libgen.so"), str(d / "gen.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  if proc.returncode:
    raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}")
  lib = ctypes.CDLL(str(d / "libgen.so"))
  for entry, argtypes in _build.SMOOTH_ENTRIES.items():
    fn = getattr(lib, entry, None)
    if fn is not None:
      fn.argtypes = list(argtypes)
      fn.restype = ctypes.c_int
  return lib, proc.stdout


def with_whole_F(src, parent_src):
  """A shipped smoother source whose kernel 11 takes F from the parent's
  whole gen_sm_F (its stores moved to the row stride D2 | 1), defined as
  gen_sm_F_whole (RN_SM_F_WHOLE): F's parts against the whole function,
  operation for operation."""
  d2 = int(re.search(r"constexpr int D2 = (\d+);", src).group(1))
  ld = d2 | 1
  m = re.search(r"template <typename scalar_t>\nGEN_HD GEN_PHASE void "
                r"gen_sm_F\(.*?\n\}\n", parent_src, re.S)
  fn = m.group(0).replace("void gen_sm_F(", "void gen_sm_F_whole(")
  def moved(q):
    i, k = divmod(int(q.group(1)), d2)
    return f"  F[{i * ld + k}] ="

  fn = re.sub(r"  F\[(\d+)\] =", moved, fn)
  return "#define RN_SM_F_WHOLE 1\n" + src.replace(
      "}  // namespace rn_gen", fn + "\n}  // namespace rn_gen", 1)


def smooth_info_of(lib, which, double):
  out = (ctypes.c_int * 9)()
  rc = lib.rn_smooth_info(which, int(double), ctypes.addressof(out))
  return list(out) if rc == 0 else f"cudaError {rc}"


def smooth_stacks(torch, dev, gen):
  """chip_smoke.compare_smoother's inputs: the live log of RTS_B lanes x
  RTS_T steps through kernel 9 in float32 (and its float64 copy): {dtype:
  (x_pred, P_pred, x_post, P_post, dts)}."""
  from torch.func import vmap

  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.runtime.scan import build_scan_stream

  T, B = cs.RTS_T, cs.RTS_B
  x0, P0, Q, dts_t, ki, zs, Rs, eas = cs.scan_log(torch, dev, gen, T, B,
                                                  torch.float32)
  scan_fn, _ = build_scan_stream(LiveKalman.build_spec(), cs.SCAN_KINDS)
  _, stacks = vmap(lambda x, P, z: scan_fn({}, x, P, Q, dts_t, ki, z, Rs,
                                           eas), in_dims=(0, 0, 1))(x0, P0,
                                                                    zs)
  f32 = [a.contiguous() for a in stacks] + [
      torch.full((B, T - 1), 0.01, device=dev)]
  return {torch.float32: f32, torch.float64: [a.double() for a in f32]}


def smooth_sweep(torch, dev, gen, parent=None):
  """Kernels 11 and 12 of the live spec (the offline path's smoother)
  on chip_smoke.compare_smoother's log (RTS_B x RTS_T, float32; float64
  for the shipped design and the parent): kernel 12 on lane 0 at
  SMOOTH_WS covariance warps, SMOOTH_STAGES stages and SMOOTH_COV_TILES
  tiles (the shipped design otherwise), and on the bank; kernel 11 (gains
  and elements on the whole bank) at SMOOTH_TILES tiles and
  SMOOTH_GAINS_WS items a block; the timing aids SMOOTH_AIDS_11 and
  SMOOTH_AIDS_12 at the shipped design, whose outputs are garbage, and
  the split they give. With parent (a checkout of the parent commit): its
  kernels 11 and 12 (its emitter run in a subprocess there, built with
  its templates), its kernel 11's aids and the shipped kernel 11 with the
  parent's whole F (with_whole_F); each build's kernel 11 float32 outputs
  held bitwise against the parent's, and the shipped build timed in turns
  with the parent (parent, shipped, shipped, parent) in both types, held
  bitwise. Raw launches of the C entries on preallocated outputs, CUDA
  events after a warm-up."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import smooth_scan as ss

  spec = LiveKalman.build_spec()
  base = ss.smooth_source(spec, ())
  csrc = ROOT / "rednose_tpu_torch" / "csrc"
  srcs = {"shipped": base}
  for w in SMOOTH_WS:
    srcs[f"cov warps {w}"] = smooth_variant(base, COV_WARPS=w)
  for n in SMOOTH_STAGES:
    srcs[f"stages {n}"] = smooth_variant(base, BACK_STAGES=n)
  for t in SMOOTH_TILES:
    srcs[f"tile {t}"] = smooth_variant(base, TILE=t)
  for w in SMOOTH_GAINS_WS:
    srcs[f"gains warps {w}"] = smooth_variant(base, GAINS_WARPS=w)
  for w, t1, t2 in SMOOTH_COV_TILES:
    srcs[f"cov warps {w}, tiles {t1} / {t2}"] = smooth_variant(
        base, COV_WARPS=w, COV_T1=t1, COV_T2=t2)
  for label, aid in (SMOOTH_AIDS_11 | SMOOTH_AIDS_12).items():
    srcs[label] = smooth_variant(base, AID=aid)
  extra = {}
  if parent is not None:
    out = SWEEP_DIR / "smooth_parent.cu"
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, "-c", PARENT_SMOOTH, str(out)],
                   cwd=parent, check=True)
    pcsrc = pathlib.Path(parent) / "rednose_tpu_torch" / "csrc"
    psrc = out.read_text()
    extra["parent"] = (psrc, pcsrc, None)
    if "void gen_sm_F(" in psrc:    # a parent with F whole (first design)
      srcs["whole F (the parent's)"] = with_whole_F(base, psrc)
    # a parent with RN_SM_AID (the redesign and later) builds its aids so
    own_aids = "RN_SM_AID" in (pcsrc / "smooth.cuh").read_text()
    for label, aid in SMOOTH_AIDS_11.items():
      extra[f"parent, {label}"] = (
          (smooth_variant(psrc, AID=aid), pcsrc, None) if own_aids
          else (psrc, pcsrc, parent_smooth_header(pcsrc, aid)))
  t0 = time.perf_counter()
  with ThreadPoolExecutor(max(len(extra), 1)) as pool:
    jobs = {k: pool.submit(build_smooth, f"sm_{i}", src, d, hdr)
            for i, (k, (src, d, hdr)) in enumerate(extra.items())}
    _build.build_generated_many(list(srcs.values()))
    libs = {k: _build.generated_library(v) for k, v in srcs.items()}
    reports = {k: _build.generated_ptxas(v) for k, v in srcs.items()}
    for k, j in jobs.items():
      libs[k], reports[k] = j.result()
  cs.log(f"smoother: {len(libs)} builds in {time.perf_counter() - t0:.1f} s")
  st = smooth_stacks(torch, dev, gen)
  B, T, d2 = cs.RTS_B, cs.RTS_T, spec.dim_main_err
  n = T - 1
  stream = torch.cuda.current_stream().cuda_stream
  outs = {}

  def gains(lib, dt, key=None):
    xp, Pp, xq, Pq, dts = st[dt]
    if key is not None:     # one set of outputs a key at a time
      outs.pop(key, None)
    C, b, V = (xp.new_empty(s) for s in ((B, n, d2, d2), (B, n, d2),
                                         (B, n, d2, d2)))
    prm = torch.zeros(1, dtype=dt, device=dev)
    if key is not None:
      outs[key] = (C, b, V)
    return lambda: _build.check(lib.rn_smooth_gains_launch(
        *(a.data_ptr() for a in (xp, Pp, xq, Pq, dts, prm, C, b, V)), B, T,
        int(dt == torch.float64), stream), "gains")

  def backward(lib, dt, lanes, key=None):
    xp, Pp, xq, Pq, _ = (a[:lanes].contiguous() for a in st[dt])
    C = outs[("C", dt)][:lanes].contiguous()
    xs, Ps = torch.empty_like(xq), torch.empty_like(Pq)
    prm = torch.zeros(1, dtype=dt, device=dev)
    if key is not None:
      outs[key] = (xs, Ps)
    return lambda: _build.check(lib.rn_smooth_backward_launch(
        *(a.data_ptr() for a in (xp, Pp, xq, Pq, C, prm, xs, Ps)), lanes, T,
        1, 0, int(dt == torch.float64), stream), "backward")

  f32, f64 = torch.float32, torch.float64
  for dt in (f32, f64):   # the shipped gains, the input of every kernel 12
    gains(libs["shipped"], dt, ("ship11", dt))()
    outs[("C", dt)] = outs.pop(("ship11", dt))[0]
  torch.cuda.synchronize()
  results = {}
  if parent is not None:    # the parent's kernel 11 float32 outputs, kept
    gains(libs["parent"], f32, "parent 11")()

  def bitwise_parent(key):
    """kernel 11 float32 outputs of key bitwise the parent's (None
    without a parent); drops them."""
    got = outs.pop(key, None)
    if parent is None or got is None:
      return None
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(got, outs["parent 11"]))

  for label, lib in libs.items():
    row = {"ptxas": kernel_ptxas(reports[label], "gains_kernel")
           + kernel_ptxas(reports[label], "backward_kernel")}
    row["info"] = {k: smooth_info_of(lib, i, False)
                   for i, k in ((0, "gains"), (2, "backward"))}
    aid12 = label in SMOOTH_AIDS_12
    aid11 = any(label.endswith(k) for k in SMOOTH_AIDS_11)
    if not aid12:
      row["gains_ms"] = cs.timed_run(gains(lib, f32, (label, 11)), REPS)[0]
      if not aid11:
        row["gains_bitwise_parent"] = bitwise_parent((label, 11))
      outs.pop((label, 11), None)
    if not aid11:
      row["backward_ms"] = cs.timed_run(backward(lib, f32, 1), REPS)[0]
    results[label] = row
    cs.log(f"smoother {label}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in row.items() if k.endswith("_ms"))
        + f"; kernel 11 float32 bitwise the parent's: "
        f"{row.get('gains_bitwise_parent')}; info {row['info']}; ptxas "
        f"{row['ptxas']}")
  outs.pop("parent 11", None)
  ship = results["shipped"]
  ship["backward_bank_ms"] = cs.timed_run(
      backward(libs["shipped"], f32, B), 2)[0]
  for dt in (f64,):
    ship["gains_ms_double"] = cs.timed_run(gains(libs["shipped"], dt), REPS)[0]
    ship["backward_ms_double"] = cs.timed_run(
        backward(libs["shipped"], dt, 1, ("ship12", dt)), REPS)[0]
  split11 = {"spec functions": ship["gains_ms"]
             - results["F and u precomputed"]["gains_ms"],
             "products": results["F and u precomputed"]["gains_ms"]
             - results["factor and solve only"]["gains_ms"],
             "factor and solve": results["F and u precomputed"]["gains_ms"]
             - results["products only"]["gains_ms"],
             "loads and stores": results["loads and stores only"]["gains_ms"]}
  split12 = {k: results[k]["backward_ms"] for k in SMOOTH_AIDS_12}
  results["split 11"], results["split 12"] = split11, split12
  cs.log(f"kernel 11 split (shipped, ms): {split11}")
  cs.log(f"kernel 12 aids (shipped, B=1, ms): {split12}; shipped "
         f"{ship['backward_ms']:.4f} ms ({ship['backward_ms'] / n * 1e3:.4f} "
         f"us a step), bank {ship['backward_bank_ms']:.4f} ms")
  if parent is not None:
    plib = libs["parent"]
    p11 = {k: results[f"parent, {k}"]["gains_ms"] for k in SMOOTH_AIDS_11}
    full = results["parent"]["gains_ms"]
    results["parent split 11"] = {
        "spec functions": full - p11["F and u precomputed"],
        "products": p11["F and u precomputed"] - p11["factor and solve only"],
        "factor and solve": p11["F and u precomputed"]
        - p11["products only"],
        "loads and stores": p11["loads and stores only"]}
    cs.log(f"kernel 11 split (parent, ms): {results['parent split 11']}")
    turns = {}
    for dt in (f32, f64):
      name = str(dt).split(".")[-1]
      for kern, mk in (
          (11, lambda lib, k: gains(lib, dt, k)),
          (12, lambda lib, k: backward(lib, dt, 1, k))):
        times = {"parent": [], "shipped": []}
        for which in ("parent", "shipped", "shipped", "parent"):
          times[which].append(cs.timed_run(
              mk(libs[which], (which, kern, dt)), REPS)[0])
        a, b = outs.pop(("parent", kern, dt)), outs.pop(("shipped", kern, dt))
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        diff = max(float((x - y).abs().max()) for x, y in zip(a, b))
        del a, b
        turns[f"kernel {kern} {name}"] = dict(times=times, bitwise=same,
                                             max_abs_diff=diff)
        cs.log(f"kernel {kern} {name} in turns: parent {times['parent']} "
               f"ms, shipped {times['shipped']} ms; bitwise the parent's: "
               f"{same} (largest |difference| {diff:.3g})")
    results["in turns"] = turns
    results["parent info"] = {
        dt: {k: smooth_info_of(plib, i, dt == "float64")
             for i, k in ((0, "gains"), (2, "backward"))}
        for dt in ("float32", "float64")}
  return results


# ---------------------------------------------------------- kernels 11', 12'
# timing aids (csrc/smooth_adjoint.cuh RN_SMA_AID bits; outputs garbage);
# the parent's the same cuts made in its smooth_adjoint.cuh
# (SMA_PARENT_CUTS)
SMA_AIDS = {"12' without the state chain": 1,
            "12' without the covariance chain": 2,
            "12' without the emitted VJPs": 4,
            "12' loads and stores only": 1 | 2 | 4 | 8,
            "11' without F's VJP": 16,
            "11' without the factor and solve": 32,
            "11' without the products": 64}
# this tree's alone: kernel 12' a pass at a time (RN_SMA_AID bits 128,
# 256, 512 leave out the pass before the chain, the chain, the pass
# after it), 11' with the factor and solve over shared memory (1024)
SMA_THIS = {"12' chain and pass after (no pass before)": 128,
            "12' passes before and after (no chain)": 256,
            "12' pass before and chain (no pass after)": 512,
            "11' with smooth.cuh's factor and solve": 1024}
SMA_AIDS_12, SMA_AIDS_11 = 1 | 2 | 4 | 8 | 128 | 256 | 512, 16 | 32 | 64 | 1024
# the parent's (the first design's) statements each aid cuts, by
# prefixing "if (0) "
SMA_PARENT_CUTS = {
    1: ["ba_state<S>(a, k, norm != 0, sm, tid, 32);"],
    2: ["ba_cov<S, BA_TILE>(sm, tid - 32, BA_COV);"],
    4: ["rn_gen::gen_sm_inv_err<S>(xp1, xs1, a.p, dx);",
        "inject_vjp<S>(norm, a.xq + (size_t)k * DX, dxp,",
        "rn_gen::gen_sm_inv_err_vjp<S>(xp1, xs1, a.p, gdx2,"],
    16: ["rn_gen::gen_sm_F_vjp<S>(a.xq + r0 * DX,"],
    32: ["rn_sm::cholesky<S, NL>(L, sm + GA::DIAG, tid);",
          "rn_sm::cho_solve<S, NL>(L, sm + GA::DIAG, W1, tid);"],
    64: ["rn_sm::mm_tiles<S, SM_TILE>("],
}
PARENT_SMOOTH_ADJOINT = """
import sys
from rednose_tpu_torch.models.live import LiveKalman
from rednose_tpu_torch.ops import smooth_scan
open(sys.argv[1], "w").write(smooth_scan.smooth_adjoint_source(
    LiveKalman.build_spec(), ()))
"""
# kernel 12''s C entry in the parent: no scratch pointer
_VP, _VI = ctypes.c_void_p, ctypes.c_int
PARENT_BACK_ADJ_ARGS = (_VP,) * 16 + (_VI,) * 5 + (_VP,)


def parent_sma_header(csrc, aid):
  """The parent's csrc/smooth_adjoint.cuh with the statements of aid's
  bits (SMA_PARENT_CUTS) made dead."""
  text = (pathlib.Path(csrc) / "smooth_adjoint.cuh").read_text()
  for bit, cuts in SMA_PARENT_CUTS.items():
    if aid & bit:
      for cut in cuts:
        if cut not in text:
          raise RuntimeError(f"parent smooth_adjoint.cuh: no {cut!r}")
        text = text.replace(cut, "if (0) " + cut)
  return text


def sma_inputs(torch, dev, gen):
  """Kernels 11' and 12''s inputs on the thirteenth path's shapes, from
  smooth_stacks' live log through this tree's kernels 11-13 and 13' in
  each type: {dtype: dict(bank (the 64 x 8192 stacks, dts, C, lam, Lam,
  e, D: 11''s parallel form, as chip_smoke.compare_smooth_grad times
  it), lane (lane 0's stacks, its gains C1, kernel 12's xs1, Ps1 and the
  seeded cotangents gx1, gP1: 12''s))}."""
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import smooth_scan as ss

  spec = LiveKalman.build_spec()
  out = {}
  for dt, st in smooth_stacks(torch, dev, gen).items():
    xp, Pp, xq, Pq, dts = st
    C, b, V = ss.smooth_gains(spec, {}, xp, Pp, xq, Pq, dts)
    _, e, D = ss.affine_suffix_scan(C, b, V)
    lam, Lam = ss.affine_suffix_scan_adjoint(C, e, D)
    del b, V
    lane = [a[:1].contiguous() for a in (xp, Pp, xq, Pq)]
    C1 = ss.smooth_gains(spec, {}, *lane, dts[:1].contiguous(),
                         elements=False)
    xs1, Ps1 = ss.smooth_backward(spec, {}, *lane, C1, norm_quats=True)
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED + 25)
    gx1, gP1 = (torch.randn(a.shape, generator=g, device=dev,
                            dtype=torch.float64).to(dt)
                for a in lane[:2])
    out[dt] = dict(bank=(xp, Pp, xq, Pq, dts, C, lam, Lam, e, D),
                   lane=(*lane, C1, xs1, Ps1, gx1, gP1))
  return out


def smooth_adjoint_sweep(torch, dev, gen, parent=None):
  """Kernels 11' and 12' of the live spec on the thirteenth path's shapes
  (sma_inputs): 12' on lane 0 (B = 1, T = 8192), 11' on the bank's
  elements (64 x 8192, the parallel form), float32 and float64; this
  tree's timing aids SMA_AIDS and SMA_THIS, and with parent (a
  checkout of the parent commit) its kernels (its emitter run in a
  subprocess there, built with its templates) and its aids (its
  smooth_adjoint.cuh cut, SMA_PARENT_CUTS); then parent and this tree in
  turns (parent, this, this, parent) in both types, this tree's outputs
  held against the parent's (float64 within SMA_TOL64 and float32 within
  chip_smoke.SMOOTH_GRAD32_TOL of each output's largest entry, the
  covariances' by their symmetric parts). Raw launches of the C entries
  on preallocated outputs, CUDA events after a warm-up."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import smooth_scan as ss

  spec = LiveKalman.build_spec()
  base = ss.smooth_adjoint_source(spec, ())
  csrc = ROOT / "rednose_tpu_torch" / "csrc"
  srcs = {"this": base}
  if "RN_SMA_AID" in (csrc / "smooth_adjoint.cuh").read_text():
    for label, aid in (SMA_AIDS | SMA_THIS).items():
      srcs[label] = f"#define RN_SMA_AID {aid}\n" + base
  extra = {}
  if parent is not None:
    out = SWEEP_DIR / "smooth_adjoint_parent.cu"
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, "-c", PARENT_SMOOTH_ADJOINT, str(out)],
                   cwd=parent, check=True)
    pcsrc = pathlib.Path(parent) / "rednose_tpu_torch" / "csrc"
    extra["parent"] = (out.read_text(), pcsrc, None)
    for label, aid in SMA_AIDS.items():
      extra[f"parent, {label}"] = (out.read_text(), pcsrc,
                                   parent_sma_header(pcsrc, aid))
  t0 = time.perf_counter()
  with ThreadPoolExecutor(max(len(extra), 1)) as pool:
    jobs = {k: pool.submit(build_smooth, f"sma_{i}", src, d, None, hdr)
            for i, (k, (src, d, hdr)) in enumerate(extra.items())}
    _build.build_generated_many(list(srcs.values()))
    libs = {k: _build.generated_library(v) for k, v in srcs.items()}
    reports = {k: _build.generated_ptxas(v) for k, v in srcs.items()}
    for k, j in jobs.items():
      libs[k], reports[k] = j.result()
      libs[k].rn_smooth_backward_adjoint_launch.argtypes = list(
          PARENT_BACK_ADJ_ARGS)
  cs.log(f"smoother's adjoint: {len(libs)} builds in "
         f"{time.perf_counter() - t0:.1f} s")
  ins = sma_inputs(torch, dev, gen)
  B, T = ins[torch.float32]["bank"][0].shape[:2]
  n, d2, de, dx = T - 1, spec.dim_main_err, spec.dim_err, spec.dim_x
  stream = torch.cuda.current_stream().cuda_stream

  def gains(lib, dt):
    """(launch, outputs) of 11' on the bank's elements, outputs zeroed."""
    xp, Pp, xq, Pq, dts, C, lam, Lam, e, D = ins[dt]["bank"]
    z = lambda *s: torch.zeros(s, dtype=dt, device=dev)  # noqa: E731
    o = [z(B, n, dx), z(B, n, d2, d2), z(B, n, d2, d2), z(B, n), z(B, n, 1),
         z(B, n, dx), z(B, n, dx), z(B, n, d2, d2)]
    prm = z(1)
    return (lambda: _build.check(lib.rn_smooth_gains_adjoint_launch(
        *(None if a is None else a.data_ptr() for a in (
            xp, Pp, xq, Pq, dts, prm, C, None, lam, Lam, e, D, *o)), B, T,
        int(dt == torch.float64), stream), "11'")), o

  def backward(lib, dt, scratch):
    """(launch, outputs) of 12' on lane 0, outputs zeroed."""
    xp, Pp, xq, Pq, C1, xs1, Ps1, gx1, gP1 = ins[dt]["lane"]
    o = [torch.zeros_like(a) for a in (xp, Pp, xq, Pq, C1)] + [
        torch.zeros((1, n, 1), dtype=dt, device=dev)]
    prm = torch.zeros(1, dtype=dt, device=dev)
    s = ([ss.backward_adjoint_scratch(spec, (), 1, T, dt, dev, lib=lib)]
         if scratch else [])
    return (lambda: _build.check(lib.rn_smooth_backward_adjoint_launch(
        *(a.data_ptr() for a in (xp, Pp, xq, Pq, C1, prm, xs1, Ps1, gx1,
                                 gP1, *o, *s)), 1, T, 1, 0,
        int(dt == torch.float64), stream), "12'")), o

  def timed(label, kern, dt, reps=REPS):
    lib = libs[label]
    fn, _ = (gains(lib, dt) if kern == 11 else
             backward(lib, dt, label not in extra))
    return cs.timed_run(fn, reps)[0]

  results = {}
  f32, f64 = torch.float32, torch.float64
  for label in libs:
    row = {"ptxas": {k: kernel_ptxas(reports[label], k) for k in (
        "gains_adjoint", "backward_adjoint")}}
    aid = (SMA_AIDS | SMA_THIS).get(label.split("parent, ")[-1], 0)
    if not aid or aid & SMA_AIDS_12:
      row["backward_ms"] = timed(label, 12, f32)
    if not aid or aid & SMA_AIDS_11:
      row["gains_ms"] = timed(label, 11, f32)
    if label in ("this", "parent"):
      row["backward_ms_double"] = timed(label, 12, f64)
      row["gains_ms_double"] = timed(label, 11, f64)
      row["info"] = {dt: _sma_info(libs[label], dt == "float64",
                                   label in extra)
                     for dt in ("float32", "float64")}
    results[label] = row
    cs.log(f"smoother's adjoint {label}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in row.items() if k.endswith(
            ("_ms", "_double"))) + f"; info {row.get('info')}; ptxas "
        f"{row['ptxas']}")
  if parent is not None:
    turns = {}
    for dt in (f32, f64):
      name = str(dt).split(".")[-1]
      for kern in (11, 12):
        times = {"parent": [], "this": []}
        for which in ("parent", "this", "this", "parent"):
          times[which].append(timed(which, kern, dt))
        outs = {}
        for which in ("parent", "this"):
          fn, o = (gains(libs[which], dt) if kern == 11 else
                   backward(libs[which], dt, which == "this"))
          fn()
          torch.cuda.synchronize()
          outs[which] = o
        errs = [cs._sym_err(a, b.double()) for a, b in zip(
            outs["this"], outs["parent"])]
        tol = SMA_TOL64 if dt == f64 else cs.SMOOTH_GRAD32_TOL
        turns[f"kernel {kern}' {name}"] = dict(
            times=times, errs=errs, ok=max(errs) <= tol)
        cs.log(f"kernel {kern}' {name} in turns: parent {times['parent']} "
               f"ms, this {times['this']} ms; this against the parent "
               f"{[float(f'{x:.3g}') for x in errs]} (tolerance {tol}) -> "
               f"{'ok' if max(errs) <= tol else 'FAIL'}")
        del outs
    results["in turns"] = turns
  return results


# float64 outputs of this tree's 11' and 12' against the parent's
SMA_TOL64 = 1e-12


def _sma_info(lib, double, parent):
  """rn_smooth_adjoint_info of each kernel (the parent's: 11', 12', 14')."""
  out = (ctypes.c_int * 9)()
  res = {}
  names = ("11'", "12' chain", "14'", "12' pass before", "12' pass after")
  for i, k in enumerate(names[:3] if parent else names):
    rc = lib.rn_smooth_adjoint_info(i, int(double), ctypes.addressof(out))
    res[k] = list(out) if rc == 0 else f"cudaError {rc}"
  return res


# ---------------------------------------------------------------- kernel 13
AFFINE_STAGES = (2, 3, 4)    # ring stages (RN_AF_STAGES)
# tiles (rows, threads a row) of passes 1 and 3 in float (RN_AF_ROWS,
# RN_AF_SPLIT) and in double (RN_AF_ROWS64, RN_AF_SPLIT64), and of pass 2
# (RN_AF_CROWS, RN_AF_CSPLIT), the shipped ones first; each tile's first
# two products fused or apart (RN_AF_FUSE, RN_AF_FUSE64, RN_AF_CFUSE)
AFFINE_TILES = ((3, 4), (1, 1), (2, 2), (3, 3), (4, 5), (2, 4))
AFFINE_TILES64 = ((1, 4), (3, 4), (2, 4), (1, 8), (1, 1))
AFFINE_CARRY_TILES = ((1, 11), (3, 4), (1, 4), (1, 8), (2, 8), (1, 16))
AFFINE_CHUNKS = (32, 64, 128, 256)
# blocks an SM passes 1 and 3 are fit to (RN_AF_MINB; the double ones to
# half as many, RN_AF_MINB64)
AFFINE_MINB = (1, 10, 16)
# timing aids (csrc/affine_scan.cu RN_AF_AID bits; outputs garbage)
AFFINE_AIDS = {"products only (no copies, no stores)": 1 | 4,
               "copies only (no products, no stores)": 2 | 4,
               "copies and stores (no products)": 2,
               "without the stores": 4}
# a pass entry for a parent's kernel 13 that has none (the first design's
# affine_scan.cu): its three kernels launched one at a time, as
# rn_affine_scan_pass
PARENT_AFFINE_PASS = """
template <typename S>
static int rn_parent_pass(int pass, const void* A, const void* b,
                          const void* V, void* Ao, void* bo, void* Vo,
                          void* tot, void* excl, int N, int n, int chunk,
                          cudaStream_t st) {
  using namespace rn_affine;
  const size_t smem = sizeof(S) * SMEM;
  const int nc = (n + chunk - 1) / chunk;
  if (pass == 0 && nc > 1)
    totals_kernel<S><<<dim3(nc, N), AFFINE_THREADS, smem, st>>>(
        (const S*)A, (const S*)b, (const S*)V, (S*)tot, n, chunk, nc);
  if (pass == 1 && nc > 1)
    carry_kernel<S><<<N, AFFINE_THREADS, smem, st>>>(
        (const S*)tot, (S*)excl, V != nullptr, nc);
  if (pass == 2)
    apply_kernel<S><<<dim3(nc, N), AFFINE_THREADS, smem, st>>>(
        (const S*)A, (const S*)b, (const S*)V,
        nc > 1 ? (const S*)excl : nullptr, (S*)Ao, (S*)bo, (S*)Vo, n, chunk,
        nc);
  return (int)cudaGetLastError();
}

extern "C" int rn_affine_scan_pass(int pass, const void* A, const void* b,
                                   const void* V, void* Ao, void* bo,
                                   void* Vo, void* tot, void* excl, int N,
                                   int n, int chunk, int is_double,
                                   void* stream) {
  auto st = (cudaStream_t)stream;
  return is_double ? rn_parent_pass<double>(pass, A, b, V, Ao, bo, Vo, tot,
                                            excl, N, n, chunk, st)
                   : rn_parent_pass<float>(pass, A, b, V, Ao, bo, Vo, tot,
                                           excl, N, n, chunk, st);
}
"""


def affine_variant(d, **consts):
  """Kernel 13's source for d x d elements with csrc/affine_scan.cu's
  design constants (RN_AF_STAGES, the tiles' RN_AF_ROWS / SPLIT / FUSE,
  RN_AF_MINB, RN_AF_AID) set by #defines ahead of it."""
  from rednose_tpu_torch.ops import smooth_scan as ss

  return "".join(f"#define RN_AF_{k} {v}\n" for k, v in consts.items()) + \
      ss.affine_source(d)


def build_affine_parent(parent, d):
  """nvcc of the parent's csrc/affine_scan.cu for d x d elements with
  PARENT_AFFINE_PASS where it has no pass entry of its own, in a
  directory of its own: (library with SMOOTH_ENTRIES declared, ptxas
  report)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import smooth_scan as ss

  dst = SWEEP_DIR / "affine_parent"
  shutil.rmtree(dst, ignore_errors=True)
  dst.mkdir(parents=True)
  text = (pathlib.Path(parent) / "rednose_tpu_torch" / "csrc"
          / "affine_scan.cu").read_text()
  (dst / "affine_scan.cu").write_text(text)
  (dst / "gen.cu").write_text(ss.affine_source(d) + (
      "" if "rn_affine_scan_pass" in text else PARENT_AFFINE_PASS))
  proc = subprocess.run(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(dst), "-o",
       str(dst / "libgen.so"), str(dst / "gen.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  if proc.returncode:
    raise RuntimeError(f"parent kernel 13: nvcc failed:\n{proc.stdout}")
  lib = ctypes.CDLL(str(dst / "libgen.so"))
  for entry, argtypes in _build.SMOOTH_ENTRIES.items():
    fn = getattr(lib, entry, None)
    if fn is not None:
      fn.argtypes = list(argtypes)
      fn.restype = ctypes.c_int
  return lib, proc.stdout


def affine_cases(torch, dev, gen):
  """Kernel 13's inputs as chip_smoke.compare_smoother gives them: the
  shipped kernel 11's (C, b, V) of the 64 x 8192 live log in float32 and
  float64 ({dtype: (C, b, V)}), and the refine variant's (A, b) of the
  T = 600 cold log in float64."""
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import smooth_scan as ss

  spec = LiveKalman.build_spec()
  st = smooth_stacks(torch, dev, gen)
  cbv = {dt: ss.smooth_gains(spec, {}, *a) for dt, a in st.items()}
  del st
  rspec, stacks64, ts = cs.refine_log(torch, dev, gen)
  rs = [a[None].contiguous() for a in stacks64]
  rd = (ts[1:] - ts[:-1])[None].contiguous()
  Cr, br, Vr = ss.smooth_gains(rspec, {}, *rs, rd)
  _, er, _ = ss.affine_suffix_scan(Cr, br, Vr)
  ab = ss.smooth_gains(rspec, {}, rs[0], None, rs[2], None, None, C=Cr,
                       e=er, norm_quats=True)
  torch.cuda.synchronize()
  return cbv, ab


def affine_sweep(torch, dev, gen, parent=None):
  """Kernel 13 on chip_smoke.compare_smoother's elements (affine_cases):
  the shipped design and every candidate (ring stages AFFINE_STAGES, the
  tiles AFFINE_TILES, AFFINE_TILES64 and AFFINE_CARRY_TILES, the first two
  products fused or apart, the launch bounds' blocks an SM) and the
  timing aids AFFINE_AIDS at the shipped design, each raw on the 64 x 8192
  (C, b, V) in float32 and float64 and on the T = 600 (A, b) in float64,
  its passes timed apart (chip_smoke.affine_split), with its launch shape
  and ptxas and its outputs held bitwise against the shipped build's; the
  shipped build at AFFINE_CHUNKS chunks (not bitwise: the chunks set the
  order of the combines). With parent (a checkout of the
  parent commit): its kernel 13 (its own affine_scan.cu, with a pass
  entry) split apart too, and in turns with the shipped build (parent,
  shipped, shipped, parent) on the three inputs, held bitwise. Raw
  launches of the C entries on preallocated outputs, CUDA events after a
  warm-up."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import smooth_scan as ss

  d = 22
  srcs = {"shipped": ss.affine_source(d)}
  for k in AFFINE_STAGES:
    srcs[f"stages {k}"] = affine_variant(d, STAGES=k)
  for r, sp in AFFINE_TILES:
    srcs[f"float tile {r} x 1/{sp}"] = affine_variant(d, ROWS=r, SPLIT=sp)
  for r, sp in AFFINE_TILES64:
    srcs[f"double tile {r} x 1/{sp}"] = affine_variant(d, ROWS64=r,
                                                        SPLIT64=sp)
  for r, sp in AFFINE_CARRY_TILES:
    srcs[f"carry tile {r} x 1/{sp}"] = affine_variant(d, CROWS=r,
                                                       CSPLIT=sp)
  # the first two products in one loop or apart, against the shipped
  # choice of each tile
  srcs["float products fused"] = affine_variant(d, FUSE=1)
  srcs["double products apart"] = affine_variant(d, FUSE64=0)
  srcs["carry products apart"] = affine_variant(d, CFUSE=0)
  for k in AFFINE_MINB:
    srcs[f"float fit to {k} blocks an SM"] = affine_variant(d, MINB=k)
    srcs[f"double fit to {max(k // 2, 1)} blocks an SM"] = affine_variant(
        d, MINB64=max(k // 2, 1))
  for label, aid in AFFINE_AIDS.items():
    srcs[label] = affine_variant(d, AID=aid)
  t0 = time.perf_counter()
  with ThreadPoolExecutor(1) as pool:
    pj = None if parent is None else pool.submit(build_affine_parent,
                                                 parent, d)
    _build.build_generated_many(list(srcs.values()))
    libs = {k: _build.generated_library(v) for k, v in srcs.items()}
    reports = {k: _build.generated_ptxas(v) for k, v in srcs.items()}
    if pj is not None:
      libs["parent"], reports["parent"] = pj.result()
  cs.log(f"kernel 13: {len(libs)} builds in {time.perf_counter() - t0:.1f} s")
  cbv, ab = affine_cases(torch, dev, gen)
  f32, f64 = torch.float32, torch.float64
  stream = torch.cuda.current_stream().cuda_stream

  def args_of(el, chunk=ss.AFFINE_CHUNK):
    """(rn_affine_scan_launch's arguments, its outputs) on el (A, b[,
    V]), outputs and scratch preallocated."""
    A, b = el[0], el[1]
    V = el[2] if len(el) > 2 else None
    N, n = A.shape[:2]
    outs = (torch.empty_like(b), None if V is None else torch.empty_like(V))
    nc = -(-n // chunk)
    scratch = [A.new_empty((N, nc, 2 * d * d + d)) for _ in range(2)]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return (ptr(A), ptr(b), ptr(V), None, ptr(outs[0]), ptr(outs[1]),
            *(t.data_ptr() for t in scratch), N, n, chunk,
            int(A.dtype == f64), stream), (outs, scratch)

  def raw(lib, args):
    return cs.timed_run(lambda: _build.check(
        lib.rn_affine_scan_launch(*args), "affine_suffix_scan"), REPS)[0]

  def same(a, b):
    return all(x is None or torch.equal(x, y) for x, y in zip(a, b))

  results = {}
  cases = {"float32": cbv[f32], "float64": cbv[f64], "(A, b) float64": ab}
  ship_out = {}
  for case, el in cases.items():
    args, (ship_out[case], _) = args_of(el)
    raw(libs["shipped"], args)
  for label, lib in libs.items():
    row = {}
    for case, el in cases.items():
      args, (outs, _) = args_of(el)
      row[case] = {"raw_ms": raw(lib, args),
                   "passes_ms": cs.affine_split(torch, lib, args, REPS)}
      torch.cuda.synchronize()
      if label not in AFFINE_AIDS:
        row[case]["bitwise_shipped"] = same(outs, ship_out[case])
      del outs
    if label != "parent":
      row["info"] = {str(dt).split(".")[-1]: {
          k: list(v.values()) for k, v in ss.affine_info(
              d, dt, srcs[label]).items()} for dt in (f32, f64)}
    row["ptxas"] = {p: kernel_ptxas(reports[label], p + "_kernel")
                    for p in cs.AFFINE_PASSES}
    results[label] = row
    cs.log(f"kernel 13 {label}: " + "; ".join(
        f"{case} raw {r['raw_ms']:.4f} ms, passes "
        f"{ {k: round(v, 4) for k, v in r['passes_ms'].items()} }, bitwise "
        f"the shipped build {r.get('bitwise_shipped')}"
        for case, r in row.items() if case in cases)
        + f"; info {row.get('info')}; ptxas {row['ptxas']}")
  ship = results["shipped"]
  for chunk in AFFINE_CHUNKS:
    args, _ = args_of(cbv[f32], chunk)
    ship[f"chunk {chunk}"] = dict(
        raw_ms=raw(libs["shipped"], args),
        passes_ms=cs.affine_split(torch, libs["shipped"], args, REPS))
    cs.log(f"kernel 13 shipped, chunk {chunk}: {ship[f'chunk {chunk}']}")
  if parent is not None:
    turns = {}
    for label, el in (("(C, b, V) float32", cbv[f32]),
                      ("(C, b, V) float64", cbv[f64]),
                      ("(A, b) T=600 float64", ab)):
      times, outs = {"parent": [], "shipped": []}, {}
      for which in ("parent", "shipped", "shipped", "parent"):
        args, (o, _) = args_of(el)
        times[which].append(raw(libs[which], args))
        outs[which] = o
      torch.cuda.synchronize()
      bits = same(outs["parent"], outs["shipped"])
      diff = max(float((x - y).abs().max()) for x, y in zip(
          outs["parent"], outs["shipped"]) if x is not None)
      turns[label] = dict(times=times, bitwise=bits, max_abs_diff=diff)
      cs.log(f"kernel 13 {label} in turns: parent {times['parent']} ms, "
             f"shipped {times['shipped']} ms; bitwise the parent's: {bits} "
             f"(largest |difference| {diff:.3g})")
      del outs
    results["in turns"] = turns
  return results


# ---------------------------------------------------------------- kernel 8
TRI_SRC = ROOT / "rednose_tpu_torch" / "csrc" / "triangulate.cu"
TRI_CONSTS = ("BLOCK_THREADS",)
TRI_BLOCKS = (32, 64, 128)
# the wrapper's A/B, run in a fresh process in each tree: compute_pos_batch
# as the VIO path calls it on each case of the file argv[1], host clock
# after a synchronize (ms a call), and its host time a call queued behind
# a sleep; prints one JSON line
TRI_WRAP_SCRIPT = """
import json, sys, time, torch
from rednose_tpu_torch.msckf import triangulation as tri
out = {}
for label, (to_c, poses, uv) in torch.load(sys.argv[1]).items():
  to_c, poses, uv = to_c.cuda(), poses.cuda(), uv.cuda()
  if poses.dim() == 2:
    poses = poses.expand(uv.shape[0], -1, -1)
  f = lambda: tri.compute_pos_batch(to_c, poses, uv)
  f(); torch.cuda.synchronize()
  ts = []
  for _ in range(100):
    t0 = time.perf_counter(); f(); torch.cuda.synchronize()
    ts.append((time.perf_counter() - t0) * 1e3)
  torch.cuda._sleep(200_000_000)
  t0 = time.perf_counter()
  for _ in range(200):
    f()
  host = (time.perf_counter() - t0) * 1e3 / 200
  torch.cuda.synchronize()
  out[label] = dict(wrapped=sum(ts) / len(ts), wrapped_min=min(ts),
                    wrapped_max=max(ts), host=host)
print(json.dumps(out))
"""


def tri_source(consts=None, source=TRI_SRC):
  """csrc/triangulate.cu with its design constants replaced."""
  text = source.read_text()
  for k, v in (consts or {}).items():
    text, n = re.subn(rf"constexpr int {k} = \w+;",
                      f"constexpr int {k} = {v};", text)
    if n != 1:
      raise RuntimeError(f"triangulate.cu: no constant {k}")
  return text


def tri_shipped():
  """The shipped design constants of csrc/triangulate.cu."""
  text = TRI_SRC.read_text()
  return {k: re.search(rf"constexpr int {k} = (\w+);", text).group(1)
          for k in TRI_CONSTS}


def build_tri(name, text):
  """nvcc of one triangulate.cu text into its own directory: (library,
  ptxas lines of the float and double kernels at K = 4 and 8, nvcc
  seconds). The parent's kernel is not templated on K: its lines are
  those of its one kernel a type."""
  from rednose_tpu_torch import _build

  d = SWEEP_DIR / name
  shutil.rmtree(d, ignore_errors=True)
  d.mkdir(parents=True)
  (d / "triangulate.cu").write_text(text)
  t0 = time.perf_counter()
  proc = subprocess.run(
      [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
       str(d / "triangulate.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  secs = time.perf_counter() - t0
  if proc.returncode:
    raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}")
  lib = ctypes.CDLL(str(d / "lib.so"))
  for fn in ("triangulate_launch", "triangulate_floor_launch",
             "triangulate_info"):
    if hasattr(lib, fn):
      getattr(lib, fn).argtypes = list(_build.SIGNATURES[fn])
      getattr(lib, fn).restype = ctypes.c_int
  ptx = {}
  for t, tn in (("d", "double"), ("f", "float")):
    for K in (4, 8):
      lines = kernel_ptxas(proc.stdout, f"triangulate_kernelI{t}Li{K}E")
      ptx[f"{tn} K={K}"] = lines or kernel_ptxas(
          proc.stdout, f"triangulate_kernelI{t}E")
  return lib, ptx, secs


def tri_info(lib, K):
  if not hasattr(lib, "triangulate_info"):
    return None
  out = (ctypes.c_int * 5)()
  from rednose_tpu_torch import _build
  _build.check(lib.triangulate_info(K, 1, ctypes.addressof(out)), "info")
  return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                   "local_bytes"), out))


def tri_sweep(torch, dev, parent=None):
  """Kernel 8 on the VIO store's frames 0 and 31 (768 rows, K = 4,
  float64, the stride-0 window) and on the long-tail batch
  (chip_smoke.tri_tail_case: 768 tracks of the CPU tests' family at
  K = 8): the shipped build, on a stride-0 window also given its
  contiguous copy (each track sets up its own frames, not the block once);
  the other BLOCK_THREADS of TRI_BLOCKS; and, with parent (a checkout),
  the parent commit's kernel. Each run's outputs held bitwise against the
  shipped build's (and the parent's), then timed raw on the device
  (chip_smoke.queued_ms: launches queued behind a sleep, mean and spread
  over its batches), with its launch floor (an empty kernel on its grid)
  and the largest iteration count; ptxas of the float and double kernels
  at K = 4 and 8. Then, in turns (parent, this, this, parent), the
  parent's kernel and the shipped one raw, and the two trees' wrappers
  twice over (compute_pos_batch as the VIO path calls it, host clock
  after a synchronize; TRI_WRAP_SCRIPT in a fresh process in each tree);
  and the wrapper's steps one at a time (host us a call)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.msckf import triangulation as tri

  shipped = tri_shipped()
  jobs = {"shipped": tri_source()}
  for block in TRI_BLOCKS:
    if str(block) != shipped["BLOCK_THREADS"]:
      jobs[f"block={block}"] = tri_source({"BLOCK_THREADS": block})
  if parent is not None:
    jobs["parent"] = tri_source(
        source=parent / "rednose_tpu_torch" / "csrc" / "triangulate.cu")
  t0 = time.perf_counter()
  with ThreadPoolExecutor(len(jobs) + 2) as pool:
    static = pool.submit(_build.build)
    parent_static = None if parent is None else pool.submit(
        subprocess.run, [sys.executable, "-c", "from rednose_tpu_torch "
                         "import _build; _build.build()"], cwd=parent,
        check=True)
    builds = {k: pool.submit(build_tri, f"k8_{i}", v)
              for i, (k, v) in enumerate(jobs.items())}
    builds = {k: b.result() for k, b in builds.items()}
    static.result()
    if parent_static is not None:
      parent_static.result()
  cs.log(f"kernel 8: {len(builds)} builds in {time.perf_counter() - t0:.1f}"
         f" s; shipped {shipped}")
  _, _, store_cases = cs.vio_store_path(torch, dev)
  cases = {k: v[:3] for k, v in store_cases.items()}
  cases["long-tail batch"] = cs.tri_tail_case(torch, dev)
  results = {"shipped": shipped}
  for label, (to_c, poses, uv) in cases.items():
    N, K = poses.shape[:2]
    ref = [a.clone() for a in cs.kernel8_launch(builds["shipped"][0], to_c,
                                                poses, uv)()]
    par = None if parent is None else [
        a.clone() for a in cs.kernel8_launch(builds["parent"][0], to_c,
                                             poses, uv)()]

    def bits(out, other):
      return other is not None and all(
          torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
          for a, b in zip(out, other))

    results[label] = {}
    runs = [(name, b, poses) for name, b in builds.items()]
    if poses.stride(0) == 0:
      runs.insert(1, ("shipped, per-track setup (contiguous copy)",
                      builds["shipped"], poses.contiguous()))
    for name, (lib, ptx, secs), pp in runs:
      launch = cs.kernel8_launch(lib, to_c, pp, uv)
      out = launch()
      raw = cs.queued_ms(launch)
      floor_lib = lib if hasattr(lib, "triangulate_floor_launch") else \
          builds["block=64"][0]    # the parent's grid: 64 tracks a block
      floor = cs.queued_ms(cs.kernel8_floor(floor_lib, N, K))
      row = dict(raw=raw[:3], floor=floor[:3], queued=raw[4] and floor[4],
                 bitwise_shipped=bits(out, ref),
                 bitwise_parent=bits(out, par), max_iters=int(out[2].max()),
                 iterations=int(out[2].sum()), ptxas=ptx, nvcc_s=secs,
                 info=tri_info(lib, K))
      results[label][name] = row
      cs.log(f"kernel 8 {label} (N={N} K={K}) {name}: raw {raw[0]:.5f} ms "
             f"({raw[1]:.5f}-{raw[2]:.5f}), floor {floor[0]:.5f} ms "
             f"({floor[1]:.5f}-{floor[2]:.5f}), queued {row['queued']}; "
             f"bitwise as shipped {row['bitwise_shipped']}, as the parent "
             f"{row['bitwise_parent']}; iterations {row['iterations']}, "
             f"largest {row['max_iters']}; ptxas {ptx}; runtime "
             f"{row['info']}; nvcc {secs:.1f} s")
    if parent is not None:
      times = {"parent": [], "this": []}
      for which in ("parent", "this", "this", "parent"):
        lib = builds["parent" if which == "parent" else "shipped"][0]
        times[which].append(cs.queued_ms(cs.kernel8_launch(
            lib, to_c, poses, uv))[0])
      results[label]["in turns"] = times
      cs.log(f"kernel 8 {label} raw in turns: parent {times['parent']} ms, "
             f"this {times['this']} ms")
  # the wrappers, each tree's in a fresh process, in turns
  SWEEP_DIR.mkdir(parents=True, exist_ok=True)
  path = SWEEP_DIR / "k8_cases.pt"
  torch.save({label: (to_c.cpu(), poses[0].cpu() if poses.stride(0) == 0
                      else poses.cpu(), uv.cpu())
              for label, (to_c, poses, uv) in cases.items()}, path)
  trees = {"this": ROOT} | ({} if parent is None else {"parent": parent})
  wrapped = {which: [] for which in trees}
  for which in (("parent", "this", "this", "parent") * 2 if parent is not None
                else ("this", "this")):
    proc = subprocess.run([sys.executable, "-c", TRI_WRAP_SCRIPT, str(path)],
                          cwd=trees[which], capture_output=True, text=True,
                          check=True)
    wrapped[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
  results["wrapped in turns"] = wrapped
  for label in cases:
    cs.log(f"kernel 8 {label} wrapped in turns (host clock ms a call after "
           f"a synchronize; the wrapper's host ms a call): " + "; ".join(
               f"{which} " + ", ".join(
                   f"{r[label]['wrapped']:.5f} ({r[label]['wrapped_min']:.5f}"
                   f"-{r[label]['wrapped_max']:.5f}), host "
                   f"{r[label]['host']:.5f}" for r in runs)
               + " (host median "
               f"{statistics.median(r[label]['host'] for r in runs):.5f})"
               for which, runs in wrapped.items()))
  # the wrapper's steps, one at a time (host us a call, the card busy)
  to_c, poses, uv = cases[f"frame {cs.STORE_FRAMES - 1}"]
  N = poses.shape[0]
  steps = {
      "checks and to_c as it is (this wrapper)": lambda: tri._launch(
          to_c, poses, uv),
      "raw ctypes launch": cs.kernel8_launch(_build.library(), to_c, poses,
                                             uv),
      "torch.as_tensor(to_c).contiguous()": lambda: torch.as_tensor(
          to_c, dtype=poses.dtype, device=poses.device).contiguous(),
      "three torch.empty": lambda: (
          torch.empty((N, 3), dtype=poses.dtype, device=dev),
          torch.empty((N,), dtype=torch.bool, device=dev),
          torch.empty((N,), dtype=torch.int32, device=dev)),
      "torch.cuda.current_stream(dev).cuda_stream": lambda:
          torch.cuda.current_stream(dev).cuda_stream,
  }
  results["wrapper steps us"] = {}
  for name, fn in steps.items():
    us = cs.queued_ms(fn, reps=200, batches=3)[3] * 1e3
    results["wrapper steps us"][name] = us
    cs.log(f"kernel 8 wrapper step, {name}: {us:.2f} us a call (host)")
  return results


def template_ab(torch, dev, gen, parent_template):
  """Kernels 4, 5, 6 and 7, whose emitted text is the same in both trees,
  each built with this tree's template and with the parent's and timed in
  turns (parent, this, this, parent; raw launches, mean of REPS after a
  warm-up): kernel 4 on the live spec's ECEF_POS tile (gate on) and kernel
  6 on its 4-kind cycle, both from the live x0 and P0 at B = 8192,
  T = 64; kernel 7 on msckf_vo's frame tile as frame_cases gives it;
  kernel 5 on loc's float32 epoch tile on chip_smoke's local-scale case
  (B = 8192, T = 64)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  live_spec = cs.generic_models()[3]
  f32 = dict(dtype=torch.float32, device=dev)
  x = torch.as_tensor(LiveKalman.initial_x, **f32)[:, None].repeat(
      1, cs.LIVE_B)
  P = torch.as_tensor(np.diag(LiveKalman.initial_P_diag), **f32)[
      :, :, None].repeat(1, 1, cs.LIVE_B)
  dts = torch.full((cs.CMP_T,), 0.01, **f32)
  call4 = gs.KernelCall(
      live_spec, "single", (K.ECEF_POS,), Q=LiveKalman.Q,
      R_list=(LiveKalman.obs_noise[K.ECEF_POS],), gate=True,
      structure=sparsity.structure_for(live_spec, LiveKalman.initial_x))
  _, kind_idx, zs_m = cs.mixed_schedule(torch, dev, gen, cs.CMP_T)
  call6 = cs.live_mixed_call()
  k7 = frame_cases(torch, dev, gen)["kernel 7, msckf_vo"]
  x5, P5, zs5, eas5, dts5 = (a.to(torch.float32)
                             for a in cs.loc_local_case(torch, dev, gen))
  cases = {
      "kernel 4, live spec ECEF_POS, gate on": (
          call4, (x, P, (torch.as_tensor(LiveKalman.initial_x[0:3], **f32)[
              :, None] + 5.0 * torch.randn((cs.CMP_T, 3, cs.LIVE_B),
                                           generator=gen, device=dev)
                         ).contiguous(), dts), {}),
      "kernel 6, live spec 4-kind cycle": (
          call6, (x, P, zs_m.permute(0, 2, 1).contiguous(), dts),
          dict(kind_idx=torch.as_tensor(kind_idx, dtype=torch.int32,
                                        device=dev))),
      "kernel 7, msckf_vo frames": k7[:3],
      "kernel 5, loc 8-slot epoch, float32": (
          cs.loc_epoch_call(), (x5, P5, zs5, dts5), dict(eas=eas5))}
  with ThreadPoolExecutor(2 * len(cases)) as pool:
    fns = {(name, which): pool.submit(
        build_with_template, f"ab_{i}_{which}", call.source(),
        parent_template if which == "parent" else _build.TEMPLATE)
           for i, (name, (call, _, _)) in enumerate(cases.items())
           for which in ("parent", "this")}
    fns = {k: f.result() for k, f in fns.items()}
  out = {}
  for name, (call, args, kw) in cases.items():
    times = {"parent": [], "this": []}
    for which in ("parent", "this", "this", "parent"):
      ms, _ = cs.timed_run(cs.generic_launch(call.source(), call, *args, **kw,
                                             fn=fns[(name, which)]), REPS)
      times[which].append(ms)
    out[name] = {k: sum(v) / len(v) for k, v in times.items()}
    cs.log(f"template A/B, {name}: parent's template "
           f"{times['parent']} ms, this tree's {times['this']} ms")
  return out


# ---------------------------------------------------------------- kernel 15

BANK_GRID = {"chunk": (16, 32, 64, 128), "stages": (2, 3, 4), "W": (1, 2)}
BANK_UNROLLS = (1, 2, 4, 8)   # steps the chunk loop unrolls
# one warp (the lane's state in registers) or TILE_ROLES warps, whatever
# the lane's size
BANK_FORCE_W = {1: 10 ** 9, 2: 0}
PARENT_BANK = """
import sys
import torch
import chip_smoke as cs
calls = cs.bank_calls()
for name, out in zip(("kinematic", "car"), sys.argv[1:]):
  open(out, "w").write(
      calls[name + " run_bank (kernel 15)"][0].source(torch.float32))
"""


def bank_source(call, dtype, w=None, chunk=None, stages=None, aid=0,
                unroll=None):
  """Kernel 15's source of a call emitted with the emitter's constants set:
  W (1 or 2, else the emitter's choice), steps a ring stage and stages
  (the ring not cut to BANK_SMEM_TARGET when given), a timing aid's
  RN_BANK_AID bits and the steps its chunk loop unrolls (RN_BANK_UNROLL;
  csrc/generic_scan.cuh)."""
  from rednose_tpu_torch.ops import entry_slab

  consts = {}
  if w is not None:
    consts["BANK_ONE_WARP_VALS"] = BANK_FORCE_W[w]
  if chunk is not None:
    consts |= dict(BANK_CHUNK=chunk, BANK_SMEM_TARGET=entry_slab.TILE_SMEM_MAX)
  if stages is not None:
    consts["BANK_STAGES"] = stages
  src = k4_source(lambda: call, dtype=dtype, **consts)
  if unroll is not None:
    src = f"#define RN_BANK_UNROLL {unroll}\n" + src
  return f"#define RN_BANK_AID {aid}\n" + src if aid else src


def bank_fn_launch(fn, x, P, t, zs, dts, Rs, prm, Q, eas=None):
  """chip_smoke.bank_launch of a loaded entry (a parent's build)."""
  import torch

  x, P, t = x.clone(), P.clone(), t.clone()
  T, B = dts.shape[0], x.shape[-1]
  ys = x.new_empty((T, zs.shape[1], B))
  stream = torch.cuda.current_stream(x.device).cuda_stream

  def launch():
    from rednose_tpu_torch import _build

    _build.check(fn(x.data_ptr(), P.data_ptr(), t.data_ptr(), zs.data_ptr(),
                    None if eas is None else eas.data_ptr(), dts.data_ptr(),
                    Rs.data_ptr(), int(Rs.dim() == 4), prm.data_ptr(),
                    Q.data_ptr(), ys.data_ptr(), T, B, stream), "kernel 15")
    return x, P, t, ys

  return launch


def bank_cases(torch, dev, gen):
  """Kernel 15's timed shapes in its wrapper's layout, float32: the
  kinematic bank at kernel 1's width (KIN_B x KIN_T, R by lane and
  shared) and at T = 64 and 1, the car bank (GEN_B, its params) at
  T = 64, 1024 and 1, the live spec's ECEF_POS (B = GEN_B, T = 64, from
  the prior), the op battery's RANGE (B = GEN_B, T = 64, its anchors as
  extra args), and the example's 4096 x 500 (the gradient's bank, R by
  lane). Each: (spec name, x, P, t, zs, dts, Rs, prm, Q,
  eas)."""
  from rednose_tpu_torch.models import user_specs as us

  (_, km, kk, _), (_, cm, ck, cparams) = cs.bank_models()
  f32 = torch.float32

  def lay(state, Q, dts, zs, Rs, prm=None, eas=None):
    R = Rs.permute(0, 2, 3, 1).contiguous() if Rs.dim() == 4 else Rs
    return (state.x.T.contiguous(), state.P.permute(1, 2, 0).contiguous(),
            state.t.clone(), zs.permute(0, 2, 1).contiguous(), dts, R,
            torch.zeros(1, device=dev) if prm is None else prm, Q, eas)

  state, Q, dts, zs, Rs = cs.bank_inputs(torch, dev, gen, km, kk, cs.KIN_B,
                                         cs.KIN_T, f32, noise=5.0)
  kin = lay(state, Q, dts, zs, Rs)
  cases = {f"kinematic {cs.KIN_B}x{cs.KIN_T} R by lane": ("kinematic",
                                                         *kin)}
  cases[f"kinematic {cs.KIN_B}x{cs.KIN_T} R shared"] = (
      "kinematic", *kin[:5], Rs[:, 0].contiguous(), *kin[6:])
  for n in (64, 1):
    cases[f"kinematic {cs.KIN_B}x{n}"] = (
        "kinematic", *kin[:3], kin[3][:n], kin[4][:n], kin[5][:n], *kin[6:])
  cstate, cQ, cdts, czs, cRs = cs.bank_inputs(torch, dev, gen, cm, ck,
                                              cs.GEN_B, cs.BANK_CAR_T, f32)
  cprm = torch.as_tensor([float(cparams[k]) for k in sorted(cparams)],
                         dtype=f32, device=dev)
  car = lay(cstate, cQ, cdts, czs, cRs, cprm)
  for n in (64, cs.BANK_CAR_T, 1):
    cases[f"car {cs.GEN_B}x{n}"] = (
        "car", *car[:3], car[3][:n], car[4][:n], car[5][:n], *car[6:])
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K

  lstate, lQ, ldts, lzs, lRs = cs.bank_inputs(torch, dev, gen, LiveKalman,
                                              K.ECEF_POS, cs.GEN_B, cs.CMP_T,
                                              f32)
  cases[f"live {cs.GEN_B}x{cs.CMP_T}"] = ("live",
                                          *lay(lstate, lQ, ldts, lzs, lRs))
  gstate, gQ, gdts, gzs, gRs = cs.bank_grad_inputs(torch, dev, f32)[:5]
  cases[f"example {cs.BANK_GRAD_B}x{cs.BANK_GRAD_T}"] = (
      "kinematic", *lay(gstate, gQ, gdts, gzs, gRs))
  spec, rng = us.battery_spec(), np.random.RandomState(cs.SEED)
  B, T = cs.GEN_B, cs.CMP_T
  x0 = us.BATTERY_X0 + np.concatenate(
      [2.0 * rng.randn(B, 3), 0.1 * rng.randn(B, 5)], axis=1)
  truth = us.simulate(spec, x0, us.BATTERY_Q, T, 0.05, rng)
  eas = truth[1:, :, :3].numpy() + 50.0 * rng.randn(T, B, 3)
  bz = us.measure(spec, us.RANGE, truth[1:], us.BATTERY_R[us.RANGE], rng,
                  torch.as_tensor(eas)).numpy()
  t32 = lambda a: torch.as_tensor(  # noqa: E731
      np.ascontiguousarray(a), dtype=f32, device=dev)
  R0 = np.asarray(us.BATTERY_R[us.RANGE])
  cases[f"battery {B}x{T}"] = (
      "battery", t32(x0.T), t32(np.tile(np.diag(us.BATTERY_P_DIAG)[..., None],
                                        (1, 1, B))),
      torch.zeros(B, dtype=f32, device=dev), t32(bz.transpose(0, 2, 1)),
      t32(np.full(T, 0.05)),
      t32(np.broadcast_to(R0[None, :, :, None], (T,) + R0.shape + (B,))),
      torch.zeros(1, device=dev), t32(us.BATTERY_Q),
      t32(eas.transpose(0, 2, 1)))
  return cases


def bank_sweep(torch, dev, gen, parent=None):
  """Kernel 15 (run_bank's bank scan) at each point of BANK_GRID (steps a
  ring stage x stages x W) on the kinematic 16384 x 4096 bank, R by lane
  and shared, each point with its shared bytes, registers, blocks an SM
  and waves; the car, the op battery and the live spec at W = 1 and 2
  (the shipped ring), which set entry_slab.BANK_ONE_WARP_VALS; the
  kinematic and car variants at each unroll of BANK_UNROLLS
  (entry_slab.BANK_UNROLL_OPS); the shipped variants on every case of
  bank_cases; the timing aids (RN_BANK_AID: the ring and ys stores
  without the compute, the compute on each stage's first chunk, copied
  once) of the shipped kinematic variant. Each build (not the aids)
  held against the plain version
  (bank_run_scan_reference) at T = 64 in sigmas (chip_smoke.bank_errs),
  and the shipped W = 1 and W = 2 against each other. With parent (a
  checkout of the parent commit), the parent's kernel 15 (its emitter
  run there, built with its template) in turns with the shipped one on
  every kinematic and car case (parent, this, this, parent). Raw
  launches, CUDA events, REPS after a warm-up (4 x REPS at T <= 64)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models import user_specs as us
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs

  f32 = torch.float32
  calls = {n: cs.bank_calls()[f"{n} run_bank (kernel 15)"][0]
           for n in ("kinematic", "car")}
  calls["battery"] = gs.KernelCall(us.battery_spec(), "bank", (us.RANGE,),
                                   Q=us.BATTERY_Q)
  calls["live"] = gs.KernelCall(LiveKalman.build_spec(), "bank",
                                (K.ECEF_POS,), Q=LiveKalman.Q)
  t0 = time.perf_counter()
  srcs = {}
  for n, call in calls.items():
    srcs[(n, "shipped")] = call.source(f32)
    for w in BANK_GRID["W"]:
      srcs[(n, f"W={w}")] = bank_source(call, f32, w)
  for c in BANK_GRID["chunk"]:
    for s in BANK_GRID["stages"]:
      for w in BANK_GRID["W"]:
        srcs[("kinematic", f"W={w} {s}x{c}")] = bank_source(
            calls["kinematic"], f32, w, c, s)
  for n in ("kinematic", "car"):
    for u in BANK_UNROLLS:
      srcs[(n, f"unroll {u}")] = bank_source(calls[n], f32, unroll=u)

  aids = {"ring and ys stores only": 1, "compute only": 2}
  for label, bits in aids.items():
    srcs[("kinematic", label)] = bank_source(calls["kinematic"], f32,
                                             aid=bits)
  fns = {}
  if parent is not None:
    outs = [SWEEP_DIR / f"k15_parent_{n}.cu" for n in ("kinematic", "car")]
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([sys.executable, "-c", PARENT_BANK, *map(str, outs)],
                   cwd=parent, check=True)
    template = (pathlib.Path(parent) / "rednose_tpu_torch" / "csrc"
                / "generic_scan.cuh")
    with ThreadPoolExecutor(2) as pool:
      jobs = {n: pool.submit(build_with_template, f"k15_parent_{n}",
                             o.read_text(), template,
                             "rn_generic_bank_launch")
              for n, o in zip(("kinematic", "car"), outs)}
      _build.build_generated_many(list(srcs.values()))
      for n, j in jobs.items():
        fns[(n, "parent")] = j.result()
  else:
    _build.build_generated_many(list(srcs.values()))
  for k, src in srcs.items():
    fns[k] = _build.generated_launcher(src)
  cs.log(f"kernel 15: {len(fns)} builds in {time.perf_counter() - t0:.1f} s")
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  cases = bank_cases(torch, dev, gen)
  ref_case = {n: next(k for k, c in cases.items() if c[0] == n
                      and c[4].shape[0] == cs.CMP_T)
              for n in calls}
  refs = {}
  for n, k in ref_case.items():
    lay = cases[k][1:]
    refs[n] = gs.bank_run_scan_reference(calls[n], *lay[:6], lay[8],
                                         lay[6], lay[7])
  results = {}

  def launch(key, case):
    c = cases[case][1:]
    return bank_fn_launch(fns[key], *c[:6], c[6], c[7], c[8])

  def info_of(key):
    if key not in srcs:
      return {}
    info = _build.generated_info(srcs[key])
    blocks = -(-cs.KIN_B // 32)
    info["waves at B=16384"] = -(-blocks // max(info["blocks_per_sm"] * sms,
                                                1))
    info["ptxas"] = kernel_ptxas(_build.generated_ptxas(srcs[key]),
                                 "rn_generic")
    info["design line"] = next(ln for ln in srcs[key].splitlines()
                               if "// design" in ln)
    return info

  big = [k for k in cases if k.startswith(f"kinematic {cs.KIN_B}x"
                                          f"{cs.KIN_T}")]
  for key in fns:
    n, label = key
    row = {"info": info_of(key), "ms": {}}
    if "only" not in label:
      out = launch(key, ref_case[n])()
      row["sigma"] = cs.bank_errs(torch, calls[n].spec, out, refs[n])
    which = big if n == "kinematic" and " " in label else [
        k for k, c in cases.items() if c[0] == n]
    for case in which:
      short = cases[case][5].shape[0] <= cs.CMP_T
      row["ms"][case] = cs.timed_run(launch(key, case),
                                     4 * REPS if short else REPS)[0]
    results[f"{n} {label}"] = row
    cs.log(f"kernel 15 {n} {label}: " + ", ".join(
        f"{c} {ms:.4f} ms" for c, ms in row["ms"].items())
        + (f"; {row['sigma']} sigma from plain at T={cs.CMP_T}"
           if "sigma" in row else " (aid: outputs garbage)")
        + f"; {row['info']}")
  for n in ("kinematic", "car"):
    a = launch((n, "W=1"), ref_case[n])()
    b = launch((n, "W=2"), ref_case[n])()
    same = all(torch.equal(u, v) for u, v in zip(a, b))
    results[f"{n} W=1 bitwise W=2"] = same
    cs.log(f"kernel 15 {n}: W=1 {'bitwise' if same else 'not bitwise'} "
           f"W=2 at T={cs.CMP_T}; largest difference "
           f"{max(float((u - v).abs().max()) for u, v in zip(a, b)):.3g}")
  if parent is not None:
    for case, c in cases.items():
      if c[0] not in ("kinematic", "car"):
        continue
      times = {"parent": [], "this": []}
      for which in ("parent", "this", "this", "parent"):
        key = (c[0], "parent" if which == "parent" else "shipped")
        short = c[5].shape[0] <= cs.CMP_T
        times[which].append(cs.timed_run(launch(key, case),
                                         4 * REPS if short else REPS)[0])
      results[f"in turns {case}"] = times
      cs.log(f"kernel 15 in turns [{case}]: parent {times['parent']} ms, "
             f"this {times['this']} ms")
  return results


def main():
  import torch

  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--parent", type=pathlib.Path, default=None,
                  help="a checkout of an earlier commit: its kernels 1, "
                       "2, 3, 8, 10, 11, 12, 13, 15, 11' and 12' run "
                       "beside these")
  ap.add_argument("--parts", nargs="+", default=list(PARTS), choices=PARTS,
                  help="what to sweep (default all): kernels 2, 3, 4 and 6 "
                       "on the live spec, kernel 7 and kernel 6 with camera "
                       "frames, kernel 1, kernel 5, kernel 9, kernel 8, "
                       "kernel 10, kernels 11 and 12, kernel 13, kernel "
                       "15, kernels 11' and 12'")
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
  parent_template = None if args.parent is None else (
      args.parent / "rednose_tpu_torch" / "csrc" / "generic_scan.cuh")
  results = {"card": card}
  if "kinematic" in args.parts:
    results["kernel 1"] = k1_sweep(torch, dev, gen, args.parent)
  if "epoch" in args.parts:
    results["kernel 5"] = epoch_sweep(torch, dev, gen, parent_template)
  fsrc = {}
  if "frames" in args.parts:
    cases = frame_cases(torch, dev, gen)
    t0 = time.perf_counter()
    fsrc = frame_sources(cases)
    cs.log(f"frame variants emitted in {time.perf_counter() - t0:.1f} s")
  if "live" in args.parts:
    results |= live_sweep(torch, args, fsrc)
  elif fsrc:
    t0 = time.perf_counter()
    _build.build_generated_many([s for v in fsrc.values()
                                 for s in v.values()])
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
  if fsrc:
    results["frames"] = frame_sweep(torch, cases, fsrc)
  if "stream" in args.parts:
    results["kernel 9"] = stream_sweep(torch, dev, gen)
  if "triangulate" in args.parts:
    results["kernel 8"] = tri_sweep(torch, dev, args.parent)
  if "adjoint" in args.parts:
    results["kernel 10"] = adjoint_sweep(torch, dev, gen, args.parent)
  if "smooth" in args.parts:
    results["kernels 11-12"] = smooth_sweep(torch, dev, gen, args.parent)
  if "affine" in args.parts:
    results["kernel 13"] = affine_sweep(torch, dev, gen, args.parent)
  if "bank" in args.parts:
    results["kernel 15"] = bank_sweep(torch, dev, gen, args.parent)
  if "smooth_adjoint" in args.parts:
    results["kernels 11'-12'"] = smooth_adjoint_sweep(torch, dev, gen,
                                                      args.parent)
  if args.parent is not None and set(args.parts) - {
      "triangulate", "adjoint", "smooth", "affine", "bank",
      "smooth_adjoint"}:
    results["template A/B"] = template_ab(torch, dev, gen, parent_template)
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
