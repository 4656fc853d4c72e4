"""Build and load the port's hand-written CUDA kernels and its native ring.

Two entry points for the kernels. `library()`: all `csrc/*.cu` sources
(kernels 1-3 and kernel 8, csrc/triangulate.cu), compiled by nvcc at first
use into one shared library with a plain C interface.
`generated_launcher(source)`: one source emitted per spec variant by
ops/entry_slab.py around the template csrc/generic_scan.cuh (the generic
kernels 4-7 and kernel 9, the log scan; kernel 10, the log scan's
adjoint, by ops/adjoint.py around csrc/stream_adjoint.cuh too), each in a
directory of its own (see below).
Both use the same flags:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
       -Xcompiler -fPIC -Xptxas -v

The library lands in `build/rednose_tpu_torch/` beside the package (a
git-ignored directory), named by a hash of the sources and flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is. The
compiler's `ptxas -v` report (registers, spill bytes) is kept beside it.
It is loaded with ctypes; pointers and the CUDA stream pass as c_void_p.
Every C entry point returns the launch's cudaGetLastError(); `check`
raises on a non-zero code, and `check_tensor` refuses an argument the
kernels do not take. Nothing here falls back to another path.

`rewind_ring_type()`: the native rewind ring (csrc/rewind_ring.cc, a
CPython extension), compiled by the host C++ compiler at first use into
the same directory, keyed the same way, and loaded as the module
rednose_tpu_torch.runtime._rewind_ring.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "rednose_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every entry point in csrc/: name -> argtypes (all return
# int, the cudaError_t of the launch)
SIGNATURES = {
    # state_in, state_out, zs, dts, rs, q, T, B, maha, maha_thresh, stream
    "kinematic_bank_scan_launch":
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x, P, zs, dts, q_diag, R, T, B, gate, gate_thresh, stream
    "live_bank_scan_launch":
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x, P, zs, dts, kind_idx, kinds, R_by_kind, stream_flags, gate_thresh,
    # r_stream, q_diag, T, B, gate, stream
    "live_bank_scan_mixed_launch":
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # out (6 ints): warps, threads, shared memory bytes, blocks an SM
    # holds, registers, local bytes of kernel 2 / kernel 3; kernel 1's
    # (8 ints) adds the steps a ring stage holds and the stages
    "live_bank_scan_info": (_P,),
    "live_bank_scan_mixed_info": (_P,),
    "kinematic_bank_scan_info": (_P,),
    # to_c, poses, its 3 strides, uv, its 3 strides, pos, conv, iters, N,
    # K, is_double, stream (kernel 8, csrc/triangulate.cu)
    "triangulate_launch":
        (_P, _P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _P),
    # N, K, stream: an empty kernel on kernel 8's grid (the launch floor)
    "triangulate_floor_launch": (_I, _I, _P),
    # K, is_double, out (5 ints): threads a block, shared bytes, blocks an
    # SM holds, registers, local bytes
    "triangulate_info": (_I, _I, _P),
}


def _sources():
  # the generic kernels' templates are compiled with each emitted source
  return sorted(CSRC.glob("*.cu")) + sorted(
      s for s in CSRC.glob("*.cuh") if s.name not in (TEMPLATE.name,
                                                      ADJOINT.name))


def _nvcc() -> str:
  for cand in (os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
               shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
    if cand and os.path.isfile(cand):
      return cand
  raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
  h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for src in _sources():
    h.update(src.name.encode())
    h.update(src.read_bytes())
  return BUILD_DIR / f"librednose_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
  """Compile csrc/*.cu unless the library for these sources exists."""
  lib = library_path()
  if lib.exists():
    return lib
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  cu = [str(s) for s in _sources() if s.suffix == ".cu"]
  with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so",
                                   delete=False) as tmp:
    tmp_path = tmp.name
  try:
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp_path, *cu],
        capture_output=True, text=True)
    if proc.returncode != 0:
      raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n"
                         f"{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp_path, lib)
  finally:
    if os.path.exists(tmp_path):
      os.unlink(tmp_path)
  return lib


def ptxas_report() -> str:
  """The ptxas -v output of the current build (registers, spills)."""
  return build().with_suffix(".ptxas.txt").read_text()


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
  """Build if needed, load once, and declare every entry point's types."""
  lib = ctypes.CDLL(str(build()))
  for name, argtypes in SIGNATURES.items():
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
  return lib


# --------------------------------------------------- generated kernel sources
# The generic kernels (ops/generic_scan.py) compile a source emitted per
# spec variant by ops/entry_slab.py around the template
# csrc/generic_scan.cuh. Each source goes with a copy of the template into
# its own directory build/rednose_tpu_torch/gen/gen_<hash>/, keyed by a
# hash of the source text, the template and the flags, and is compiled with
# the same nvcc flags into libgen.so (ptxas report beside it).

GEN_DIR = BUILD_DIR / "gen"
TEMPLATE = CSRC / "generic_scan.cuh"
# kernel 10's loop, which an emitted adjoint source includes after the
# template's prelude
ADJOINT = CSRC / "stream_adjoint.cuh"
# C entry of each emitted source -> argtypes (all return the launch's
# cudaError_t): kernels 4-7 take xs, Ps, zs, eas, dts, kind_idx, pss, prm,
# Q, R, T, B, stream; kernel 9 (mode "stream") xs, Ps, zs, eas, dts,
# kind_idx, Rs, prm, Q, xp, Pp, xq, Pq, T, B, stream; kernel 10 (mode
# "stream_adjoint") x0, P0, zs, eas, dts, kind_idx, Rs, prm, Q, xp, Pp, xq,
# Pq, gx, gP, gxp, gPp, gxq, gPq, dx0, dP0, dzs, dRs, ddts, deas, dQ, dprm,
# flips, T, B, stream
GEN_ENTRIES = {"rn_generic_scan_launch": (_P,) * 10 + (_I, _I, _P),
               "rn_generic_stream_launch": (_P,) * 13 + (_I, _I, _P),
               "rn_generic_stream_adjoint_launch": (_P,) * 28 + (_I, _I, _P)}


def _headers(source: str) -> list:
  """The templates an emitted source is compiled with: generic_scan.cuh,
  and stream_adjoint.cuh where the source includes it."""
  return [TEMPLATE] + ([ADJOINT] if f'#include "{ADJOINT.name}"' in source
                       else [])


def generated_dir(source: str) -> pathlib.Path:
  h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for header in _headers(source):
    h.update(header.read_bytes())
  h.update(source.encode())
  return GEN_DIR / f"gen_{h.hexdigest()[:16]}"


def _nvcc_generated(d: pathlib.Path, tmp: pathlib.Path):
  """One nvcc of d/gen.cu into tmp: (return code, output, wall seconds)."""
  t0 = time.perf_counter()
  proc = subprocess.run(
      [_nvcc(), *NVCC_FLAGS, "-I", str(d), "-o", str(tmp), str(d / "gen.cu")],
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
  return proc.returncode, proc.stdout, time.perf_counter() - t0


def write_generated(d: pathlib.Path, source: str):
  """Put the emitted source and a copy of its templates into d, each written
  to a name of this process's own and renamed into place, so a process
  building the same variant beside this one never reads a half-written
  file (both write the same text: the directory is keyed by it)."""
  d.mkdir(parents=True, exist_ok=True)
  tmp = f".{os.getpid()}.tmp"
  (d / ("gen.cu" + tmp)).write_text(source)
  os.replace(d / ("gen.cu" + tmp), d / "gen.cu")
  for header in _headers(source):
    shutil.copyfile(header, d / (header.name + tmp))
    os.replace(d / (header.name + tmp), d / header.name)


def build_generated_many(sources) -> list:
  """Compile every source not built yet, all nvcc processes at once (one
  each); returns the libraries' paths in order. Raises if one fails. Each
  ptxas report ends with the wall time of its nvcc (run beside the
  others)."""
  jobs, libs = {}, []
  for src in sources:
    d = generated_dir(src)
    lib = d / "libgen.so"
    libs.append(lib)
    if lib.exists() or lib in jobs:
      continue
    write_generated(d, src)
    jobs[lib] = d / f"libgen.{os.getpid()}.tmp.so"
  failed = []
  with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
    runs = {lib: pool.submit(_nvcc_generated, lib.parent, tmp)
            for lib, tmp in jobs.items()}
    for lib, run in runs.items():
      code, out, secs = run.result()
      if code != 0:
        failed.append(f"{lib.parent.name}: nvcc failed ({code}):\n{out}")
        continue
      lib.with_suffix(".ptxas.txt").write_text(
          f"{out}nvcc wall time {secs:.1f} s\n")
      os.replace(jobs[lib], lib)
  if failed:
    raise RuntimeError("\n".join(failed))
  return libs


@functools.lru_cache(maxsize=None)
def generated_launcher(source: str):
  """Build if needed, load, and return the C entry (GEN_ENTRIES) of one
  emitted source: rn_generic_stream_adjoint_launch for mode
  "stream_adjoint" (its source defines REDNOSE_GENERIC_STREAM_ADJOINT),
  rn_generic_stream_launch for mode "stream" (REDNOSE_GENERIC_SCAN_STREAM),
  else rn_generic_scan_launch."""
  entry = ("rn_generic_stream_adjoint_launch"
           if "#define REDNOSE_GENERIC_STREAM_ADJOINT" in source
           else "rn_generic_stream_launch"
           if "#define REDNOSE_GENERIC_SCAN_STREAM" in source
           else "rn_generic_scan_launch")
  lib = ctypes.CDLL(str(build_generated_many([source])[0]))
  fn = getattr(lib, entry)
  fn.argtypes = list(GEN_ENTRIES[entry])
  fn.restype = ctypes.c_int
  return fn


def generated_info(source: str) -> dict:
  """The launch shape of one emitted source's kernel, as the CUDA runtime
  reads it (rn_generic_scan_info, csrc/generic_scan.cuh)."""
  fn = ctypes.CDLL(str(build_generated_many([source])[0])).rn_generic_scan_info
  fn.argtypes = [ctypes.c_void_p]
  fn.restype = ctypes.c_int
  out = (ctypes.c_int * 7)()
  check(fn(ctypes.addressof(out)), "rn_generic_scan_info")
  return dict(zip(("design", "warps", "threads", "smem_bytes",
                   "blocks_per_sm", "registers", "local_bytes"), out))


def generated_ptxas(source: str) -> str:
  """The ptxas -v output of one emitted source's build."""
  return (generated_dir(source) / "libgen.ptxas.txt").read_text()


def check(code: int, name: str):
  if code != 0:
    raise RuntimeError(f"CUDA launch of {name} failed with cudaError {code}")


def check_tensor(name: str, t, shape, dtype=torch.float32):
  """Refuse what a kernel does not take: anything but a contiguous CUDA
  tensor of this dtype and shape."""
  if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
    raise ValueError(f"{name}: need a contiguous CUDA {dtype} tensor, got "
                     f"{t.device} {t.dtype} contiguous={t.is_contiguous()}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


# ------------------------------------------------------- the native ring
# csrc/rewind_ring.cc is a CPython extension of the host, not a kernel:
# the host C++ compiler builds it against this interpreter's headers.

RING_SOURCE = CSRC / "rewind_ring.cc"
RING_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
RING_MODULE = "rednose_tpu_torch.runtime._rewind_ring"


def _cxx() -> str:
  cxx = shutil.which("c++") or shutil.which("g++")
  if cxx is None:
    raise RuntimeError("no host C++ compiler (c++ or g++) on PATH; the "
                       "native rewind ring cannot be built")
  return cxx


def ring_path() -> pathlib.Path:
  h = hashlib.sha256(" ".join(RING_FLAGS).encode())
  h.update(sys.version.encode())
  h.update(RING_SOURCE.read_bytes())
  suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
  return BUILD_DIR / f"rewind_ring_{h.hexdigest()[:16]}{suffix}"


def build_ring() -> pathlib.Path:
  """Compile csrc/rewind_ring.cc unless the module for this source and
  interpreter exists; written to a temporary name and renamed into
  place. Raises if the compiler fails."""
  lib = ring_path()
  if lib.exists():
    return lib
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  with tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so",
                                   delete=False) as tmp:
    tmp_path = tmp.name
  try:
    proc = subprocess.run(
        [_cxx(), *RING_FLAGS, "-I", sysconfig.get_paths()["include"],
         "-o", tmp_path, str(RING_SOURCE)],
        capture_output=True, text=True)
    if proc.returncode != 0:
      raise RuntimeError(f"the native rewind ring failed to build "
                         f"({proc.returncode}):\n{proc.stdout}\n"
                         f"{proc.stderr}")
    os.replace(tmp_path, lib)
  finally:
    if os.path.exists(tmp_path):
      os.unlink(tmp_path)
  return lib


@functools.lru_cache(maxsize=1)
def rewind_ring_type() -> type:
  """Build if needed, load once, and return the native RewindRing type."""
  loader = importlib.machinery.ExtensionFileLoader(RING_MODULE,
                                                   str(build_ring()))
  module = importlib.util.module_from_spec(
      importlib.util.spec_from_loader(RING_MODULE, loader))
  loader.exec_module(module)
  return module.RewindRing
