"""The step arithmetic of kernels 2 and 3 (csrc/live_mixed.cuh), run on the
host: the header the card builds as float is compiled with the host C++
compiler as double (its live_mixed_host and live_scan_host entry points,
which run the kernels' step loop with the kernels' number of roles, the
phases in barrier order) and held, float64, at rtol 1e-9, against the JAX
package: kernel 3's against live_lane.live_mixed_scan over all 8 live lane
kinds, with the gate off and on and one kind streaming its diagonal R;
kernel 2's against live_lane.live_lane_scan (ECEF_POS every step), gate off
and on. Skips, with the reason, where no C++ compiler is on PATH."""

import ctypes
import pathlib
import subprocess
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.ops import live_lane as jll
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.ops import live_lane
from rednose_tpu_torch.utils.chi2 import chi2_ppf
from torch_parity import host_compiler, np_, t64

CSRC = pathlib.Path(__file__).resolve().parents[1] / "rednose_tpu_torch" / \
    "csrc"
ALL_KINDS = tuple(sorted(live_lane.LANE_KINDS))
STREAMED = (K.CAMERA_ODO_ROTATION,)
_LIB = []


@pytest.fixture(autouse=True)
def _needs_compiler():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build "
                "csrc/live_mixed.cuh")


def _lib():
  """The header's host build, once per test run."""
  if not _LIB:
    d = pathlib.Path(tempfile.mkdtemp(prefix="rn_live_mixed_host_"))
    lib = d / "liblive_mixed.so"
    proc = subprocess.run(
        [host_compiler(), "-x", "c++", "-std=c++17", "-O1", "-shared",
         "-fPIC", "-DREDNOSE_LIVE_MIXED_HOST", "-o", str(lib),
         str(CSRC / "live_mixed.cuh")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    _LIB.append(ctypes.CDLL(str(lib)))
  return _LIB[0]


def _host():
  """live_mixed_host (kernel 3's step loop)."""
  fn = _lib().live_mixed_host
  fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
  fn.restype = ctypes.c_int
  return fn


def _inputs(T, B, seed):
  """Lanes near the live x0 with a random well-conditioned P, each step's
  measurement the kind's h at the lane's state plus noise of 0.05 (every
  fourth lane far off, so the gate has work), R per kind."""
  rng = np.random.RandomState(seed)
  x = np.tile(LiveKalman.initial_x, (B, 1)) + 0.05 * rng.randn(B, 23)
  x[:, 7:10] += rng.randn(B, 3)           # moving: the speed kind is defined
  x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
  A = 0.1 * rng.randn(B, 22, 22)
  P = (A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(22)).transpose(1, 2, 0).copy()
  kind_idx = (np.arange(T) % len(ALL_KINDS)).astype(np.int32)
  far = np.where(np.arange(B) % 4 == 0, 20.0, 0.05)[:, None]
  zs = np.zeros((T, B, 3))
  for t in range(T):
    k = ALL_KINDS[kind_idx[t]]
    dz = live_lane.LANE_KINDS[k][0]
    h, _ = live_lane.LANE_KINDS[k][1](t64(x.T))
    zs[t, :, :dz] = np_(h).T + far * rng.randn(B, dz)
  R_by_kind = {k: np.diag(0.5 + rng.rand(live_lane.LANE_KINDS[k][0]))
               for k in ALL_KINDS}
  r_stream = (0.05 + 0.1 * rng.rand(T, 3)) ** 2
  dts = 0.009 + 0.002 * rng.rand(T)
  return x, P, dts, kind_idx, zs, R_by_kind, r_stream


def _run_host(x, P, dts, kind_idx, zs, R_by_kind, r_stream, gate):
  n = len(ALL_KINDS)
  R = np.zeros((n, 3, 3))
  for i, k in enumerate(ALL_KINDS):
    dz = live_lane.LANE_KINDS[k][0]
    R[i, :dz, :dz] = R_by_kind[k]
  # copies: the host build writes x and P in place, and the caller's P
  # may still be read by a JAX call dispatched before (jnp.asarray of a
  # numpy array on the CPU reads it asynchronously)
  c = lambda a, dt=np.float64: np.array(a, dtype=dt, order="C")  # noqa
  xs, Ps = c(x.T), c(P)
  args = [xs, Ps, c(zs.transpose(0, 2, 1)), c(dts), c(kind_idx, np.int32),
          c(ALL_KINDS, np.int32), c(R),
          c([int(k in STREAMED) for k in ALL_KINDS], np.int32),
          c([chi2_ppf(0.95, live_lane.LANE_KINDS[k][0]) for k in ALL_KINDS]),
          c(r_stream), c(np.diag(LiveKalman.Q))]
  rc = _host()(*[a.ctypes.data for a in args], len(dts), x.shape[0],
               int(gate))
  assert rc == 0
  return xs, Ps


@pytest.mark.parametrize("gate", [False, True])
def test_live_mixed_host_matches_jax(gate):
  """16 steps cycling twice through the 8 kinds over B = 13 lanes (not a
  multiple of the 32-lane block: the host runs filter by filter), against
  JAX live_mixed_scan at rtol 1e-9; with the gate on, some lanes gate."""
  T, B = 16, 13
  x, P, dts, kind_idx, zs, R_by_kind, r_stream = _inputs(T, B, 11)
  xj, Pj = jll.live_mixed_scan(
      jnp.asarray(x), jnp.asarray(P), jnp.asarray(LiveKalman.Q),
      jnp.asarray(dts), jnp.asarray(kind_idx), jnp.asarray(zs),
      {k: jnp.asarray(v) for k, v in R_by_kind.items()}, ALL_KINDS,
      gate=gate, r_stream=jnp.asarray(r_stream), stream_kinds=STREAMED)
  xh, Ph = _run_host(x, P, dts, kind_idx, zs, R_by_kind, r_stream, gate)
  np.testing.assert_allclose(xh, np.asarray(xj).T, rtol=1e-9, atol=1e-9)
  np.testing.assert_allclose(Ph, np.asarray(Pj), rtol=1e-9, atol=1e-9)
  np.testing.assert_array_equal(Ph, Ph.transpose(1, 0, 2))
  if gate:   # the gate had work: the far lanes end elsewhere than ungated
    xu, _ = _run_host(x, P, dts, kind_idx, zs, R_by_kind, r_stream, False)
    assert not np.allclose(xu[:, 0::4], xh[:, 0::4])


def test_live_mixed_host_matches_plain_torch():
  """The same host build against the port's plain version of kernel 3
  (ops/live_scan.live_bank_scan_mixed on CPU tensors), gate on."""
  from rednose_tpu_torch.ops import live_scan

  T, B = 9, 5
  x, P, dts, kind_idx, zs, R_by_kind, r_stream = _inputs(T, B, 12)
  R = np.zeros((len(ALL_KINDS), 3, 3))
  for i, k in enumerate(ALL_KINDS):
    dz = live_lane.LANE_KINDS[k][0]
    R[i, :dz, :dz] = R_by_kind[k]
  xt, Pt = live_scan.live_bank_scan_mixed(
      t64(x.T), t64(P), t64(zs.transpose(0, 2, 1)), t64(dts),
      torch.as_tensor(kind_idx), ALL_KINDS, t64(R),
      t64(np.diag(LiveKalman.Q)), gate=True, r_stream=t64(r_stream),
      stream_kinds=STREAMED)
  xh, Ph = _run_host(x, P, dts, kind_idx, zs, R_by_kind, r_stream, True)
  np.testing.assert_allclose(xh, np_(xt), rtol=1e-9, atol=1e-9)
  np.testing.assert_allclose(Ph, np_(Pt), rtol=1e-9, atol=1e-9)


def _run_scan_host(x, P, dts, zs, R, gate):
  """live_scan_host (kernel 2's step loop): x (B, 23), P (22, 22, B),
  zs (T, B, 3), R (3, 3); returns the new (x (23, B), P)."""
  fn = _lib().live_scan_host
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_double]
  fn.restype = ctypes.c_int
  c = lambda a: np.array(a, dtype=np.float64, order="C")  # noqa: E731
  xs, Ps = c(x.T), c(P)   # copies, as in _run_host
  args = [xs, Ps, c(zs.transpose(0, 2, 1)), c(dts), c(np.diag(LiveKalman.Q)),
          c(R)]
  rc = fn(*[a.ctypes.data for a in args], len(dts), x.shape[0], int(gate),
          live_lane.MAHA_THRESH_3D)
  assert rc == 0
  return xs, Ps


@pytest.mark.parametrize("gate", [False, True])
def test_live_scan_host_matches_jax(gate):
  """Kernel 2's step loop (ECEF_POS, the one R and threshold) over 16
  steps of B = 13 lanes, against JAX live_lane_scan at rtol 1e-9; every
  fourth lane's fixes are 20 m off, so with the gate on some gate."""
  T, B = 16, 13
  x, P, dts, _, _, _, _ = _inputs(T, B, 13)
  rng = np.random.RandomState(14)
  far = np.where(np.arange(B) % 4 == 0, 20.0, 0.5)[:, None]
  zs = x[None, :, 0:3] + far * rng.randn(T, B, 3)
  R = np.diag(0.5 + rng.rand(3))
  xj, Pj = jll.live_lane_scan(
      jnp.asarray(x), jnp.asarray(P), jnp.asarray(LiveKalman.Q),
      jnp.asarray(dts), jnp.asarray(zs), jnp.asarray(R), gate=gate)
  xh, Ph = _run_scan_host(x, P, dts, zs, R, gate)
  np.testing.assert_allclose(xh, np.asarray(xj).T, rtol=1e-9, atol=1e-9)
  np.testing.assert_allclose(Ph, np.asarray(Pj), rtol=1e-9, atol=1e-9)
  np.testing.assert_array_equal(Ph, Ph.transpose(1, 0, 2))
  if gate:   # the gate had work: the far lanes end elsewhere than ungated
    xu, _ = _run_scan_host(x, P, dts, zs, R, False)
    assert not np.allclose(xu[:, 0::4], xh[:, 0::4])
