"""Build and load the port's hand-written CUDA kernels.

All `csrc/*.cu` sources are compiled by nvcc, at first use, into one shared
library with a plain C interface:

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
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

PKG_DIR = pathlib.Path(__file__).resolve().parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "rednose_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
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
}


def _sources():
  return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


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
