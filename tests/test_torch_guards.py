"""Guards of the port: it imports no JAX, and a device asked for is the
device used (no silent CPU fallback)."""

import dataclasses
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import sympy as sp
import torch

from rednose_tpu_torch import compat
from rednose_tpu_torch.models.car import CarKalman
from rednose_tpu_torch.models.kinematic import KinematicKalman
from rednose_tpu_torch.models.live import LiveKalman
from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
from rednose_tpu_torch.msckf import feature_handler
from rednose_tpu_torch.ops import generic_scan, lane_bank, live_scan
from rednose_tpu_torch.runtime.bank import BankState
from rednose_tpu_torch.runtime.checkpoint import load_bank, save_bank
from rednose_tpu_torch.runtime.generic_bank import KalmanBank
from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank
from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank
from rednose_tpu_torch.smoothing import rts
import torch_parity  # noqa: F401  (one torch thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import importlib, pkgutil, sys
import rednose_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    rednose_tpu_torch.__path__, "rednose_tpu_torch.")]
for name in names:
  importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "rednose_tpu.")))
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
  out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  assert int(out.stdout.split()[-1]) >= 30   # every module was imported


def _full_q():
  Q = np.asarray(LiveKalman.Q).copy()
  Q[0, 6] = Q[6, 0] = 1e-3
  return Q


def _compat_engine():
  x = sp.MatrixSymbol("x", 2, 1)
  dt = sp.Symbol("dt")
  compat.gen_code(None, "guard_kinematic",
                  sp.Matrix([x[0, 0] + dt * x[1, 0], x[1, 0]]), dt, x,
                  [[sp.Matrix([x[0, 0]]), 1, None]], 2, 2)
  return compat.EKF_sym(None, "guard_kinematic", np.eye(2), np.zeros(2),
                        np.eye(2), 2, 2)


def _smoothed_numpy(device=None):
  """smooth_estimates on numpy 9-tuples (the reference's format) with no
  device asked for: the tensor returned lies where the spec's dynamics
  saw the state."""
  spec = KinematicKalman(device="cpu").spec
  seen = []

  def f(params, x, dt):
    seen.append(torch.empty(0, device=x.device))
    return spec.f(params, x, dt)

  est = [(np.zeros(2), np.full(2, 0.1 * k), np.eye(2), 0.5 * np.eye(2),
          0.01 * k, 0, None, None, None) for k in range(3)]
  out = rts.smooth_estimates(dataclasses.replace(spec, f=f, F_lane=None), {},
                             est, device=device)
  assert len(out) == 3 and np.isfinite(out[0][1]).all()
  return types.SimpleNamespace(x=seen[0])


def test_smoothed_numpy_runs_where_asked():
  assert _smoothed_numpy(device="cpu").x.device.type == "cpu"


@pytest.mark.parametrize("make", [
    lambda: LiveKalmanBank(batch=8, device="cuda"),
    lambda: LiveKalmanBank(batch=8, Q=_full_q(), device="cuda"),
    _compat_engine,
    _smoothed_numpy,
    lambda: KinematicKalman(device="cuda"),
    lambda: KalmanBank(CarKalman, batch=8, device="cuda"),
    lambda: MSCKFBank(MSCKFEskf, batch=8),
])
def test_cuda_request_never_runs_on_cpu(make):
  if torch.cuda.is_available():
    obj = make()
    tensor = (obj._x if hasattr(obj, "_x") else
              obj.filter.x if hasattr(obj, "filter") else obj.x)
    assert tensor.is_cuda
  else:
    with pytest.raises(RuntimeError, match="cuda"):
      make()


def test_track_store_defaults_to_the_card():
  """empty_tracks places the store on the card unless the caller asks for
  the CPU."""
  if torch.cuda.is_available():
    assert feature_handler.empty_tracks(4, 8).is_cuda
  else:
    with pytest.raises(RuntimeError, match="cuda"):
      feature_handler.empty_tracks(4, 8)
  tracks = feature_handler.empty_tracks(4, 8, device="cpu")
  assert tracks.device.type == "cpu" and tracks.dtype == torch.float64
  assert tuple(tracks.shape) == (8, 5, 5)


def test_load_bank_defaults_to_the_card(tmp_path):
  """load_bank places the bank on the card unless the caller asks for the
  CPU: without CUDA the default raises, device="cpu" loads on the host."""
  path = tmp_path / "bank.npz"
  save_bank(path, BankState(x=torch.ones((4, 3)), P=torch.ones((4, 2, 2)),
                            t=torch.zeros(4), epoch=1.5))
  if torch.cuda.is_available():
    assert load_bank(path).x.is_cuda
  else:
    with pytest.raises(RuntimeError, match="cuda"):
      load_bank(path)
  st = load_bank(path, device="cpu")
  assert st.x.device.type == "cpu" and st.epoch == 1.5
  assert torch.equal(st.P, torch.ones((4, 2, 2)))


def test_live_wrappers_refuse_non_cuda_devices():
  """The wrappers run the plain version for CPU tensors only; anything
  else must be a contiguous float32 CUDA tensor or is refused."""
  m = dict(device="meta")
  x, P = torch.empty((23, 8), **m), torch.empty((22, 22, 8), **m)
  zs, dts = torch.empty((2, 3, 8), **m), torch.empty(2, **m)
  q, R = torch.empty(22, **m), torch.empty((3, 3), **m)
  with pytest.raises(ValueError, match="CUDA"):
    live_scan.live_bank_scan(x, P, zs, dts, q, R)
  with pytest.raises(ValueError, match="CUDA"):
    live_scan.live_bank_scan_mixed(
        x, P, zs, dts, torch.zeros(2, dtype=torch.int32, **m),
        (12,), torch.empty((1, 3, 3), **m), q)
  before = (live_scan.live_bank_scan.launches,
            live_scan.live_bank_scan_mixed.launches)
  bank = LiveKalmanBank(batch=4, device="cpu")
  bank.run(np.full(2, 0.01), np.zeros((2, 4, 3)))
  bank.observe(0.05, 12, np.zeros(3))
  assert (live_scan.live_bank_scan.launches,
          live_scan.live_bank_scan_mixed.launches) == before


def test_generic_wrappers_never_run_the_plain_scans_off_the_cpu(
    monkeypatch):
  """For a tensor that is not on the CPU the generic wrappers check it and
  launch or raise: the plain lane scans are never their fallback."""
  def forbidden(*a, **k):
    raise AssertionError("plain scan called for a non-CPU tensor")

  for name in ("lane_bank_scan", "lane_mixed_bank_scan",
               "lane_epoch_bank_scan", "lane_frame_bank_scan"):
    monkeypatch.setattr(lane_bank, name, forbidden)
  for name in ("generic_bank_scan_reference",
               "generic_bank_scan_mixed_reference",
               "generic_bank_scan_epoch_reference",
               "vo_bank_scan_reference"):
    monkeypatch.setattr(generic_scan, name, forbidden)
  spec = CarKalman.build_spec()
  m = dict(device="meta")
  x, P = torch.empty((5, 8), **m), torch.empty((5, 5, 8), **m)
  zs, dts = torch.empty((2, 1, 8), **m), torch.empty(2, **m)
  Rs = [CarKalman.obs_noise[1], CarKalman.obs_noise[2]]
  with pytest.raises(ValueError, match="CUDA"):
    generic_scan.generic_bank_scan(x, P, zs, dts, spec=spec, kind=1,
                                   Q=CarKalman.Q, R=Rs[0])
  with pytest.raises(ValueError, match="CUDA"):
    generic_scan.generic_bank_scan_mixed(
        x, P, zs, dts, torch.zeros(2, dtype=torch.int32, **m), spec=spec,
        kinds=(1, 2), Q=CarKalman.Q, R_list=Rs)
  with pytest.raises(ValueError, match="CUDA"):
    generic_scan.generic_bank_scan_epoch(
        x, P, torch.empty((2, 2, 1, 8), **m), dts, spec=spec,
        slot_kinds=(1, 2), Q=CarKalman.Q, R_list=Rs)
  vo = MSCKFEskf.build_spec()
  xv, Pv = torch.empty((41, 8), **m), torch.empty((36, 36, 8), **m)
  zv, eav = torch.empty((2, 8, 8), **m), torch.empty((2, 3, 8), **m)
  with pytest.raises(ValueError, match="CUDA"):
    generic_scan.vo_bank_scan(
        xv, Pv, zv, eav, dts, spec=vo, kind=16, Q=MSCKFEskf.Q,
        R=MSCKFEskf.obs_noise[16])
  # a mixed schedule with camera frames (kernel 6's camera-frame branch)
  with pytest.raises(ValueError, match="CUDA"):
    generic_scan.generic_bank_scan_mixed(
        xv, Pv, zv, dts, torch.zeros(2, dtype=torch.int32, **m), spec=vo,
        kinds=(12, 16), Q=MSCKFEskf.Q,
        R_list=[MSCKFEskf.obs_noise[12], MSCKFEskf.obs_noise[16]], eas=eav)
