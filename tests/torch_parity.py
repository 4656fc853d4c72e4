"""Shared setup of the port's parity tests (tests/test_torch_*.py).

Each test feeds the same numpy-seeded inputs to the JAX package
(rednose_tpu, the reference) and to the port (rednose_tpu_torch) in one
process on the CPU, float64 unless a test says otherwise. Torch is held
to one intra-op thread: the suite runs under several pytest-xdist workers.

Tests that need the card take the `cuda_device` fixture and carry the
`cuda` marker; they skip where torch.cuda.is_available() is False and run
on the card with `python -m pytest tests -k torch -m cuda`.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def t64(a):
  return torch.as_tensor(np.array(a), dtype=torch.float64)


def t32(a):
  return torch.as_tensor(np.array(a), dtype=torch.float32)


def np_(t):
  return t.detach().cpu().numpy()


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")


def vio_schedule(model, T, B, seed):
  """A VIO schedule for a bank of B filters of an MSCKF model of the port
  (its own h, float64, no JAX): lanes around the model's x0 with a spread
  clone window, and T steps alternating camera frame (kind_idx 1, first)
  and position fix (kind_idx 0) over kinds (POSITION 12, feature 16).
  Frame rows: z = h(lane, landmark) + noise in zs[t, :, :dz] and the
  landmark, about 6 m ahead, in eas[t]; fix rows: the lane position +
  noise in zs[t, :, :3]; the rest 0. Returns (xs (B, dim_x), zs
  (T, B, dz), eas (T, B, 3), kind_idx (T,) int32)."""
  spec = model.build_spec()
  om = spec.obs[16]
  rng = np.random.RandomState(seed)
  xs = np.tile(model.initial_x, (B, 1)) + 0.02 * rng.randn(B, spec.dim_x)
  for a in range(spec.n_augment):
    o = spec.dim_main + spec.dim_augment * a
    xs[:, o:o + 3] += 0.5 * rng.randn(3)[None]
  for idx in spec.quaternion_idxs:
    xs[:, idx:idx + 4] /= np.linalg.norm(xs[:, idx:idx + 4], axis=1,
                                         keepdims=True)
  kind_idx = np.array([1 - t % 2 for t in range(T)], np.int32)
  h = torch.func.vmap(lambda x, e: om.h({}, x, e))
  zs = np.zeros((T, B, om.dz))
  eas = np.zeros((T, B, om.ea_len))
  for t in range(T):
    if kind_idx[t]:
      eas[t] = np.array([1.0, 0.5, 6.0]) + 0.1 * rng.randn(B, 3)
      zs[t] = h(t64(xs), t64(eas[t])).numpy() + 0.005 * rng.randn(B, om.dz)
    else:
      zs[t, :, :3] = xs[:, 0:3] + 0.1 * rng.randn(B, 3)
  return xs, zs, eas, kind_idx


# ------------------------------------------------ host builds of emitted code
# The generic kernels' emitted source (ops/entry_slab.py) is plain C++ over a
# scalar_t typedef: the tests compile the text nvcc builds for a float64
# bank (scalar_t = double) with the host compiler and run it over a small
# bank through the template's host loop (csrc/generic_scan.cuh), once per
# source and session.

_HOST_LIBS = {}
_HOST_DIR = []


def host_compiler():
  import shutil
  return shutil.which("g++") or shutil.which("c++")


def host_launcher(source):
  """rn_generic_scan_host of `source` built as double with the host C++
  compiler (cached per source for the session)."""
  import ctypes
  import pathlib
  import subprocess
  import tempfile

  if source in _HOST_LIBS:
    return _HOST_LIBS[source]
  if not _HOST_DIR:
    _HOST_DIR.append(pathlib.Path(tempfile.mkdtemp(prefix="rn_gen_host_")))
  csrc = pathlib.Path(__file__).resolve().parents[1] / \
      "rednose_tpu_torch" / "csrc"
  n = len(_HOST_LIBS)
  src = _HOST_DIR[0] / f"gen{n}.cu"
  lib = _HOST_DIR[0] / f"libgen{n}.so"
  src.write_text(source)
  proc = subprocess.run(
      [host_compiler(), "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
       "-I", str(csrc), "-o", str(lib), str(src)],
      capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-4000:]
  fn = ctypes.CDLL(str(lib)).rn_generic_scan_host
  fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2
  fn.restype = ctypes.c_int
  _HOST_LIBS[source] = fn
  return fn


def run_host(mode, spec, kinds, x, P, zs, dts, *, Q, R_list, params=None,
             gate=None, structure=None, eas=None, pss=None, ps_keys=(),
             kind_idx=None, tile=True):
  """The emitted variant of a generic wrapper call, built and run on the
  host in float64: x (dim_x, B), P (de, de, B), zs / eas in the wrappers'
  bank-minor layout, all CPU float64; tile=False runs its global form.
  Returns the new (x, P)."""
  from rednose_tpu_torch.ops import generic_scan

  call = generic_scan.KernelCall(
      spec, mode, kinds, Q=Q, R_list=R_list, params=params, gate=gate,
      structure=structure, ps_keys=ps_keys)
  source = call.source(torch.float64, tile=tile)
  prm, Qd, R_flat = call.values(torch.float64, "cpu")
  c = lambda t, dt=torch.float64: None if t is None else \
      torch.as_tensor(t, dtype=dt).contiguous()  # noqa: E731
  x, P = c(x).clone(), c(P).clone()
  zs, dts, eas, pss = c(zs), c(dts), c(eas), c(pss)
  ki = c(kind_idx, torch.int32)
  ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
  rc = host_launcher(source)(
      x.data_ptr(), P.data_ptr(), zs.data_ptr(), ptr(eas), dts.data_ptr(),
      ptr(ki), ptr(pss), prm.data_ptr(), Qd.data_ptr(), R_flat.data_ptr(),
      int(dts.shape[0]), int(x.shape[1]))
  assert rc == 0
  return x, P
