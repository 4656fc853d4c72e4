"""The multi-rank dry run of the sharded bank, and its rank worker.

Port of __graft_entry__.py's dryrun_multichip (:66-420): every sharded
path of parallel/sharding.py on a mesh of n ranks, each held against the
unsharded call on the same inputs: the bank step (on the 1-D and the 2-D
mesh), sharded_run_bank (kernel 15, runtime/bank.run_bank, on the card)
with the staged RMSE (1-D and multislice), the lane bank, kernel 2 (the fused live scan, on the 1-D and the 2-D mesh),
kernel 4 (the live spec's ECEF_POS with the gate on; car with its params
stream), kernel 6 (the live spec's 4-kind cycle; msckf_eskf's VIO
schedule, camera frames among position fixes), kernel 5 (loc's GNSS
epochs) and kernel 7 (msckf_eskf's camera frames), and the time-sharded
parallel smoother.

    python -m rednose_tpu_torch.parallel.dryrun [N] [--device cpu]

spawns N ranks (default 2) with torch.multiprocessing (the spawn start
method), each a Gloo rank of a group started from a file store in a
temporary directory, on the card (all on cuda:0 where it has one card)
or on the host. The tests and chip_smoke.py spawn the same worker; it
lives here so that a spawned rank imports the package and nothing else.

Every case's whole-bank inputs are made with numpy from a seed of its
own, the same on every rank and in the parent. Two sizes: "small" (the
CPU tests; B = 64, float64) and "full" (the card; the widths of
PERF.md's cells, float32 banks, the smoother in float64). A kernel case
on the card launches its kernel once a rank, on B/n lanes; its result,
gathered, equals the unsharded launch bitwise (each filter's arithmetic
does not depend on its block). On the CPU every case runs the kernels'
plain versions, and equals the unsharded plain version bitwise too. The
RMSE is held at RMSE_TOL relative in float64 (float32: RMSE_TOL32) and
the smoother at SMOOTH_TOL relative.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rednose_tpu_torch import _build
from rednose_tpu_torch.examples import launch_counts, launched_since
from rednose_tpu_torch.ops import (
    generic_scan,
    lane_bank,
    live_scan,
    smooth_scan,
    sparsity,
)
from rednose_tpu_torch.parallel import sharding
from rednose_tpu_torch.runtime import bank as bank_ops, scan
from rednose_tpu_torch.smoothing import rts

# the RMSE: two sums of the same squares in another grouping, float64
RMSE_TOL = 1e-12
# float32: the sums of B dx entries in float32 in two groupings part by
# ulps of the sum (measured 1.09e-07 relative at B = 4096 on an H100)
RMSE_TOL32 = 1e-5
# the smoother: the suffix scan associated another way, float64
SMOOTH_TOL = 1e-10



@dataclasses.dataclass(frozen=True)
class Size:
  """The (B, T) of each case, and the banks' dtype."""
  dtype: torch.dtype
  kin: tuple            # the kinematic bank: run_bank, the RMSE, the step
  lane_T: int           # the lane bank (kinematic, B of kin)
  live: tuple           # kernel 2
  generic_live: tuple   # kernel 4, the live spec
  car: tuple            # kernel 4, car with its params stream
  mixed_live: tuple     # kernel 6, the live 4-kind cycle
  vio: tuple            # kernel 6, msckf_eskf camera frames + fixes
  epoch: tuple          # kernel 5, loc, 8 slots an epoch
  vo: tuple             # kernel 7, msckf_eskf
  smooth_T: int         # the smoother's log, float64


SIZES = {
    "small": Size(torch.float64, kin=(64, 32), lane_T=16, live=(64, 8),
                  generic_live=(64, 4), car=(64, 4), mixed_live=(64, 4),
                  vio=(64, 4), epoch=(64, 4), vo=(64, 4), smooth_T=256),
    "full": Size(torch.float32, kin=(4096, 500), lane_T=64,
                 live=(8192, 1024), generic_live=(8192, 512),
                 car=(8192, 1024), mixed_live=(8192, 512), vio=(4096, 64),
                 epoch=(8192, 512), vo=(4096, 64), smooth_T=4096),
}


def _np_dtype(size):
  return np.float32 if size.dtype == torch.float32 else np.float64


# ----------------------------------------------------------- the models

@functools.lru_cache(maxsize=1)
def _models():
  from rednose_tpu_torch.models.car import CarKalman
  from rednose_tpu_torch.models.kinematic import KinematicKalman
  from rednose_tpu_torch.models.live import LiveKalman, build_live_spec
  from rednose_tpu_torch.models.loc import LocKalman
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf

  return dict(kin=KinematicKalman, car=CarKalman, live=LiveKalman,
              live_spec=build_live_spec(), loc=LocKalman, eskf=MSCKFEskf)


# the kinds, by the ids of models/kinematic.py, live.py (loc's too),
# car.py and msckf_eskf.py: the kinematic position; the live ECEF
# position and the bench's 4-kind cycle (gyro, accel, camera rotation,
# position); loc's epoch of 4 pseudoranges and 4 range rates; car's yaw
# rate with its speed / steering stream; msckf_eskf's position fix and
# camera frame (R = FEATURE_R I)
POSITION = 1
ECEF_POS = 12
MIXED_KINDS = (4, 10, 14, 12)
LOC_SLOTS = (6,) * 4 + (7,) * 4
YAW_RATE = 1
PS_KEYS = ("u", "steer_angle_deg")
ESKF_POS, ESKF_FEATURE = 12, 16
FEATURE_R = 0.01**2


@functools.lru_cache(maxsize=None)
def bank_call() -> generic_scan.KernelCall:
  """Kernel 15's call of the "bank" case, as runtime/bank.run_bank makes
  it for the kinematic bank (its Q pattern, no params)."""
  m = _models()["kin"]
  return scan._kernel_call(scan._handle(m.build_spec(), (POSITION,), ()),
                           scan._q_pattern(torch.as_tensor(m.Q)), "bank")


@functools.lru_cache(maxsize=None)
def kernel_call(name: str) -> generic_scan.KernelCall:
  """The generic kernel call of a case, as the facades make it (the same
  emitted variant as KalmanBank / MSCKFBank on the same model)."""
  m = _models()

  def call(model, spec, mode, kinds, R_list=None, **kw):
    return generic_scan.KernelCall(
        spec, mode, kinds, Q=model.Q,
        R_list=(R_list if R_list is not None
                else [model.obs_noise[k] for k in kinds]),
        structure=sparsity.structure_for(spec, model.initial_x), **kw)

  eskf = m["eskf"].build_spec()
  r_feat = FEATURE_R * np.eye(eskf.obs[ESKF_FEATURE].dz)
  return {
      "generic_live": lambda: call(m["live"], m["live_spec"], "single",
                                   (ECEF_POS,), gate=True),
      "car": lambda: call(m["car"], m["car"].build_spec(), "single",
                          (YAW_RATE,), ps_keys=PS_KEYS),
      "mixed_live": lambda: call(m["live"], m["live_spec"], "mixed",
                                 MIXED_KINDS),
      "vio": lambda: call(m["eskf"], eskf, "mixed",
                          (ESKF_POS, ESKF_FEATURE),
                          R_list=(np.eye(3), r_feat)),
      "epoch": lambda: call(m["loc"], m["loc"].build_spec(), "epoch",
                            LOC_SLOTS),
      "vo": lambda: call(m["eskf"], eskf, "frame", (ESKF_FEATURE,),
                         R_list=(r_feat,)),
  }[name]()


# ------------------------------------------------------------- the inputs

def kinematic_log(T: int, seed: int = 0):
  """A kinematic forward pass in float64 (numpy), the log of
  tests/test_precision.py:46: from KinematicKalman's prior at t = 0, T
  position fixes at t = 0.01 (k + 1), z ~ N(0, 0.3), R = 0.01; the
  predict x <- F x, P <- F P F^T + dt Q and the Joseph-form update of
  core/step.py. Returns x_pred (T, 2), P_pred (T, 2, 2), x_post, P_post,
  t (T,)."""
  m = _models()["kin"]
  rng = np.random.default_rng(seed)
  x, P = np.asarray(m.initial_x, np.float64), np.diag(m.initial_P_diag)
  H, R, dt = np.array([[1.0, 0.0]]), 0.01, 0.01
  F = np.array([[1.0, dt], [0.0, 1.0]])
  out = {k: [] for k in ("x_pred", "P_pred", "x_post", "P_post")}
  for _ in range(T):
    x, P = F @ x, F @ P @ F.T + dt * m.Q
    P = 0.5 * (P + P.T)
    out["x_pred"].append(x)
    out["P_pred"].append(P)
    z = rng.normal(0, 0.3)
    S = (H @ P @ H.T)[0, 0] + R
    K = (P @ H.T)[:, 0] / S
    x = x + K * (z - x[0])
    A = np.eye(2) - np.outer(K, H[0])
    P = A @ P @ A.T + R * np.outer(K, K)
    P = 0.5 * (P + P.T)
    out["x_post"].append(x)
    out["P_post"].append(P)
  log = {k: np.stack(v) for k, v in out.items()}
  log["t"] = 0.01 * (1.0 + np.arange(T))
  return log


def _kinematic_bank(size, B, T, seed):
  m = _models()["kin"]
  rng = np.random.default_rng(seed)
  return dict(x0=np.tile(m.initial_x, (B, 1)),
              P0=np.tile(np.diag(m.initial_P_diag), (B, 1, 1)),
              t0=np.zeros(B), Q=np.asarray(m.Q), dts=np.full(T, 0.01),
              zs=rng.normal(0, 0.5, (T, B, 1)),
              Rs=np.full((T, B, 1, 1), 0.1**2))


def _prior(model, cap):
  """The model's prior covariance with each variance capped at `cap`: a
  bank that has had its first fixes (from the 1e8 m^2 position prior a
  first fix cancels 7 digits, so two float64 programs part by 1e-9)."""
  return np.diag(np.minimum(model.initial_P_diag, cap))


def _live_bank(B):
  m = _models()["live"]
  return dict(x=np.tile(m.initial_x[:, None], (1, B)),
              P=np.tile(_prior(m, 1.0)[:, :, None], (1, 1, B)))


def _live_fixes(size, B, T, seed):
  """A live bank at its prior and T ECEF position fixes of 5 m noise
  (R = 25 I): x (23, B), P (22, 22, B), zs (T, 3, B), dts (T,)."""
  m = _models()["live"]
  rng = np.random.default_rng(seed)
  zs = m.initial_x[None, :3, None] + 5.0 * rng.standard_normal(
      (T, 3, B), dtype=_np_dtype(size))
  return dict(_live_bank(B), zs=zs, dts=np.full(T, 0.01),
              q_diag=np.diag(m.Q), R=np.diag([25.0] * 3))


def _live_mixed(size, B, T, seed):
  """The bench's 4-kind cycle for a bank at rest at the live prior: each
  measurement the kind's h at the prior plus noise at its scale."""
  m = _models()
  spec = m["live_spec"]
  x0 = torch.as_tensor(m["live"].initial_x, dtype=torch.float64)
  h0 = torch.stack([spec.obs[k].h({}, x0, None)
                    for k in MIXED_KINDS]).numpy()          # (4, 3)
  scale = np.array([0.025, 0.5, 0.05, 5.0])
  kind_idx = (np.arange(T) % len(MIXED_KINDS)).astype(np.int32)
  rng = np.random.default_rng(seed)
  zs = h0[kind_idx][:, :, None] + scale[kind_idx][:, None, None] * \
      rng.standard_normal((T, 3, B), dtype=_np_dtype(size))
  return dict(_live_bank(B), zs=zs, dts=np.full(T, 0.01),
              kind_idx=kind_idx)


def _car(size, B, T, seed):
  """bench.py's car_params_stream: yaw-rate noise, forward speed in
  [18, 24] m/s and a sinusoidal steering input, dt = 0.05 s."""
  m = _models()["car"]
  rng = np.random.default_rng(seed)
  return dict(x=(m.initial_x[:, None] + 0.05 * rng.standard_normal((5, B))),
              P=np.tile(np.diag(m.initial_P_diag)[:, :, None], (1, 1, B)),
              zs=0.05 * rng.standard_normal((T, 1, B)),
              dts=np.full(T, 0.05),
              pss=np.stack([18.0 + 6.0 * rng.random(T),
                            25.0 * np.sin(np.linspace(0, 20, T))], axis=1))


def _loc_epochs(size, B, T, seed):
  """bench.py's generic_epoch: per-lane satellites on ~2e7 m shells moving
  at ~3 km/s; the receiver at rest at loc's x0 with a zero clock, its
  variances capped at 100; pseudoranges in the first 4 slots, range rates
  in the last 4, both as the receiver sees them: zs (T, 8, 1, B), eas
  (T, 8, 6, B)."""
  m = _models()["loc"]
  dt = _np_dtype(size)
  rng = np.random.default_rng(seed)
  K = len(LOC_SLOTS)
  pos = m.initial_x[:3].astype(dt)[None, None, :, None]
  sat = pos + dt(2.0e7) * rng.standard_normal((T, K, 3, B), dtype=dt)
  vel = dt(3e3) * rng.standard_normal((T, K, 3, B), dtype=dt)
  rho = np.linalg.norm(sat - pos, axis=2)
  rate = ((sat - pos) / rho[:, :, None] * vel).sum(axis=2)
  zs = np.where((np.arange(K) < K // 2)[None, :, None], rho, rate)
  return dict(x=np.tile(m.initial_x[:, None], (1, B)),
              P=np.tile(_prior(m, 100.0)[:, :, None], (1, 1, B)),
              zs=zs[:, :, None], eas=np.concatenate([sat, vel], axis=2),
              dts=np.full(T, 0.1))


def _eskf_bank(B, rng):
  """msckf_eskf lanes around the model's x0 with the clone window spread
  0.5 m and 0.02 of noise, quaternions renormalized: (B, dim_x)."""
  m = _models()["eskf"]
  spec = m.build_spec()
  xs = np.tile(m.initial_x, (B, 1)) + 0.02 * rng.standard_normal(
      (B, spec.dim_x))
  for a in range(spec.n_augment):
    o = spec.dim_main + spec.dim_augment * a
    xs[:, o:o + 3] += 0.5 * rng.standard_normal(3)[None]
  for idx in spec.quaternion_idxs:
    xs[:, idx:idx + 4] /= np.linalg.norm(xs[:, idx:idx + 4], axis=1,
                                         keepdims=True)
  return xs


def _eskf_frames(size, B, T, seed, frames):
  """Camera frames (frames[t]) and position fixes for an msckf_eskf bank:
  a frame's landmark ~6 m ahead of the lane, z = h(lane, landmark) plus
  noise at R's sigma; a fix the lane's position plus 0.1 m of noise, the
  rest of its row 0. x (dim_x, B), P = 0.1 I, zs (T, dz, B), eas
  (T, 3, B) (0 on fix steps), dts (T,)."""
  spec = _models()["eskf"].build_spec()
  om = spec.obs[ESKF_FEATURE]
  rng = np.random.default_rng(seed)
  xs = _eskf_bank(B, rng)
  h = torch.func.vmap(lambda x, e: om.h({}, x, e))
  zs, eas = np.zeros((T, om.dz, B)), np.zeros((T, 3, B))
  for t in range(T):
    if frames[t]:
      ea = np.array([1.0, 0.5, 6.0]) + 0.1 * rng.standard_normal((B, 3))
      z = h(torch.as_tensor(xs), torch.as_tensor(ea)).numpy()
      zs[t] = (z + FEATURE_R**0.5 * rng.standard_normal(z.shape)).T
      eas[t] = ea.T
    else:
      zs[t, :3] = (xs[:, :3] + 0.1 * rng.standard_normal((B, 3))).T
  return dict(x=xs.T.copy(),
              P=np.tile(0.1 * np.eye(spec.dim_err)[:, :, None], (1, 1, B)),
              zs=zs, eas=eas, dts=np.full(T, 0.05))


def _vio(size, B, T, seed):
  kind_idx = np.array([1 - t % 2 for t in range(T)], np.int32)
  return dict(_eskf_frames(size, B, T, seed, kind_idx.astype(bool)),
              kind_idx=kind_idx)


def case_inputs(name: str, size_name: str) -> dict:
  """The whole-bank inputs of a case as numpy arrays (float, or int32 for
  a kind schedule), from the case's own seed."""
  return _inputs(CASES[name].inputs, CASES[name].seed, size_name)


@functools.lru_cache(maxsize=None)
def _inputs(base: str, seed: int, size_name: str) -> dict:
  size = SIZES[size_name]
  if base == "smoother":
    return kinematic_log(size.smooth_T, seed)
  shape = {"bank": size.kin, "step": (size.kin[0], 1),
           "lane": (size.kin[0], size.lane_T), "live": size.live,
           "generic_live": size.generic_live, "car": size.car,
           "mixed_live": size.mixed_live, "vio": size.vio,
           "epoch": size.epoch, "vo": size.vo}[base]
  return INPUTS[base](size, *shape, seed=seed)


INPUTS = {
    "bank": _kinematic_bank,
    "step": _kinematic_bank,
    "lane": _kinematic_bank,
    "live": _live_fixes,
    "generic_live": _live_fixes,
    "car": _car,
    "mixed_live": _live_mixed,
    "vio": _vio,
    "epoch": _loc_epochs,
    "vo": lambda size, B, T, seed: _eskf_frames(size, B, T, seed,
                                                np.ones(T, bool)),
}


def _tensors(inp: dict, dtype, device) -> dict:
  # a model's constant arrays are read-only: torch takes a copy of those
  return {k: torch.as_tensor(v if v.flags.writeable else v.copy(),
                             device=device,
                             dtype=torch.int32 if v.dtype.kind == "i"
                             else dtype).contiguous()
          for k, v in inp.items()}


# -------------------------------------------------------------- the cases
# Each case: sharded(mesh, mesh2, tin) -> {output: (local tensor, the
# bank dim to gather along or None for a replicated value, the mesh)};
# unsharded(tin) -> {output: whole tensor}.

def _kin_state(tin):
  return bank_ops.BankState(x=tin["x0"], P=tin["P0"], t=tin["t0"])


def _bank_sharded(mesh, mesh2, tin):
  spec = _models()["kin"].build_spec()
  final, ys = sharding.sharded_run_bank(
      spec, POSITION, mesh, {}, _kin_state(tin), tin["Q"], tin["dts"],
      tin["zs"], tin["Rs"])
  truth = np.zeros(2)
  B = tin["zs"].shape[1]
  whole = sharding.gather_bank(mesh, final.x, 0)
  x2 = sharding.multislice_sharding(mesh2).local(whole, 0, B)

  def rmse(m, x, staged):
    return staged(m, bank_ops.BankState(x=x, P=None, t=None), truth)

  return {"x": (final.x, 0, mesh), "P": (final.P, 0, mesh),
          "t": (final.t, 0, mesh), "ys": (ys, 1, mesh),
          "rmse": (rmse(mesh, final.x, sharding.sharded_bank_rmse),
                   None, mesh),
          "rmse64": (rmse(mesh, final.x.double(),
                          sharding.sharded_bank_rmse), None, mesh),
          "rmse_2d": (rmse(mesh2, x2, sharding.multislice_bank_rmse),
                      None, mesh2),
          "rmse_2d64": (rmse(mesh2, x2.double(),
                             sharding.multislice_bank_rmse), None, mesh2)}


def _bank_unsharded(tin):
  spec = _models()["kin"].build_spec()
  final, ys = bank_ops.run_bank(spec, POSITION, {}, _kin_state(tin),
                                tin["Q"], tin["dts"], tin["zs"], tin["Rs"])
  truth = np.zeros(2)
  r = bank_ops.bank_rmse(final, truth)
  r64 = bank_ops.bank_rmse(
      bank_ops.BankState(x=final.x.double(), P=None, t=None), truth)
  return {"x": final.x, "P": final.P, "t": final.t, "ys": ys, "rmse": r,
          "rmse64": r64, "rmse_2d": r, "rmse_2d64": r64}


def _step_args(tin):
  B = tin["x0"].shape[0]
  return ({}, _kin_state(tin), tin["Q"], 0.01, tin["zs"][0], tin["Rs"][0],
          torch.zeros((B, 1), dtype=tin["zs"].dtype,
                      device=tin["zs"].device))


def _step_sharded(mesh, mesh2, tin, two_d=False):
  spec = _models()["kin"].build_spec()
  m = mesh2 if two_d else mesh
  step = sharding.jit_sharded_step(
      spec, POSITION, m,
      sharding=sharding.multislice_sharding(mesh2) if two_d else None)
  st, y = step(*_step_args(tin))
  return {"x": (st.x, 0, m), "P": (st.P, 0, m), "t": (st.t, 0, m),
          "y": (y, 0, m)}


def _step_unsharded(tin):
  spec = _models()["kin"].build_spec()
  st, y = bank_ops.bank_predict_and_update(spec, POSITION, *_step_args(tin))
  return {"x": st.x, "P": st.P, "t": st.t, "y": y}


def _lane_args(tin):
  return (tin["x0"], tin["P0"].permute(1, 2, 0), tin["Q"], tin["dts"],
          tin["zs"], tin["Rs"][0, 0])


def _lane_sharded(mesh, mesh2, tin):
  spec = _models()["kin"].build_spec()
  sh, B = sharding.bank_sharding(mesh), tin["zs"].shape[1]
  x, P, Q, dts, zs, R = _lane_args(tin)
  xo, Po = lane_bank.lane_bank_scan(
      spec, POSITION, {}, sh.local(x, 0, B), sh.local(P, -1, B), Q, dts,
      sh.local(zs, 1, B), R)
  return {"x": (xo, 0, mesh), "P": (Po, -1, mesh)}


def _lane_unsharded(tin):
  spec = _models()["kin"].build_spec()
  x, P, Q, dts, zs, R = _lane_args(tin)
  xo, Po = lane_bank.lane_bank_scan(spec, POSITION, {}, x, P, Q, dts, zs, R)
  return {"x": xo, "P": Po}


def _xP(x, P, mesh):
  return {"x": (x, -1, mesh), "P": (P, -1, mesh)}


def _live_sharded(mesh, mesh2, tin, two_d=False):
  m = mesh2 if two_d else mesh
  axis = (sharding.SLICE_AXIS, sharding.BANK_AXIS) if two_d \
      else sharding.BANK_AXIS
  return _xP(*sharding.sharded_live_bank_scan(
      m, tin["x"], tin["P"], tin["zs"], tin["dts"], tin["q_diag"],
      tin["R"], gate=True, axis=axis), m)


def _live_unsharded(tin):
  x, P = live_scan.live_bank_scan(tin["x"], tin["P"], tin["zs"], tin["dts"],
                                  tin["q_diag"], tin["R"], gate=True)
  return {"x": x, "P": P}


def _generic(name):
  """(sharded, unsharded) of a generic kernel case: the sharded wrapper of
  sharding.py and the wrapper it splits, on the case's KernelCall."""
  fn = {"generic_live": ("sharded_generic_bank_scan", "generic_bank_scan"),
        "car": ("sharded_generic_bank_scan", "generic_bank_scan"),
        "mixed_live": ("sharded_generic_bank_scan_mixed",
                       "generic_bank_scan_mixed"),
        "vio": ("sharded_generic_bank_scan_mixed", "generic_bank_scan_mixed"),
        "epoch": ("sharded_generic_bank_scan_epoch",
                  "generic_bank_scan_epoch"),
        "vo": ("sharded_vo_bank_scan", "vo_bank_scan")}[name]

  def args(tin):
    if name == "vo":
      return (tin["x"], tin["P"], tin["zs"], tin["eas"], tin["dts"]), {}
    lead = (tin["x"], tin["P"], tin["zs"], tin["dts"])
    if "kind_idx" in tin:
      lead += (tin["kind_idx"],)
    return lead, {k: tin[k] for k in ("eas", "pss") if k in tin}

  def sharded(mesh, mesh2, tin):
    a, kw = args(tin)
    return _xP(*getattr(sharding, fn[0])(mesh, *a, call=kernel_call(name),
                                          **kw), mesh)

  def unsharded(tin):
    a, kw = args(tin)
    x, P = getattr(generic_scan, fn[1])(*a, call=kernel_call(name), **kw)
    return {"x": x, "P": P}

  return sharded, unsharded


def _smoother_sharded(mesh, mesh2, tin):
  spec = _models()["kin"].build_spec()
  xs, Ps = sharding.sharded_rts_smooth_parallel(
      mesh, spec, {}, tin["x_pred"], tin["P_pred"], tin["x_post"],
      tin["P_post"], tin["t"], refine=2)
  return {"x": (xs, 0, mesh), "P": (Ps, 0, mesh)}


def _smoother_unsharded(tin):
  spec = _models()["kin"].build_spec()
  xs, Ps = rts.rts_smooth_parallel(
      spec, {}, tin["x_pred"], tin["P_pred"], tin["x_post"], tin["P_post"],
      tin["t"], refine=2)
  return {"x": xs, "P": Ps}


@dataclasses.dataclass(frozen=True)
class Case:
  inputs: str                 # its inputs (INPUTS) and their shape
  seed: int
  sharded: object
  unsharded: object
  kernel: object = None       # the wrapper launched once on the card
  # or, for a case of several kernels, (wrapper name, launches) a rank
  card_counts: tuple = ()
  tols: tuple = ()            # (output, relative tolerance); others exact
  dtype: torch.dtype | None = None   # None: the size's


CASES = {
    "step": Case("step", 1, _step_sharded, _step_unsharded),
    "step_2d": Case("step", 1,
                    functools.partial(_step_sharded, two_d=True),
                    _step_unsharded),
    "bank": Case("bank", 0, _bank_sharded, _bank_unsharded,
                 generic_scan.bank_run_scan, tols=(("rmse64", RMSE_TOL), ("rmse_2d64", RMSE_TOL))),
    "lane": Case("lane", 2, _lane_sharded, _lane_unsharded),
    "live": Case("live", 3, _live_sharded, _live_unsharded,
                 live_scan.live_bank_scan),
    "live_2d": Case("live", 3, functools.partial(_live_sharded, two_d=True),
                    _live_unsharded, live_scan.live_bank_scan),
    "generic_live": Case("generic_live", 4, *_generic("generic_live"),
                         generic_scan.generic_bank_scan),
    "car": Case("car", 5, *_generic("car"), generic_scan.generic_bank_scan),
    "mixed_live": Case("mixed_live", 6, *_generic("mixed_live"),
                       generic_scan.generic_bank_scan_mixed),
    "vio": Case("vio", 7, *_generic("vio"),
                generic_scan.generic_bank_scan_mixed),
    "epoch": Case("epoch", 8, *_generic("epoch"),
                  generic_scan.generic_bank_scan_epoch),
    "vo": Case("vo", 9, *_generic("vo"), generic_scan.vo_bank_scan),
    # kernels 11 (gains and elements, and 2 refine passes), 13 and 14
    "smoother": Case("smoother", 0, _smoother_sharded, _smoother_unsharded,
                     tols=(("x", SMOOTH_TOL), ("P", SMOOTH_TOL)),
                     dtype=torch.float64,
                     card_counts=(("smooth_gains", 3),
                                  ("affine_suffix_scan", 3),
                                  ("smooth_inject", 1))),
}


def _tol(case, size, output):
  """0.0 for an exact output; the RMSE in the banks' dtype by that dtype."""
  if output in ("rmse", "rmse_2d"):
    return RMSE_TOL if size.dtype == torch.float64 else RMSE_TOL32
  return dict(case.tols).get(output, 0.0)


# -------------------------------------------------------------- the worker

def _inputs_on(name, size_name, device):
  size = SIZES[size_name]
  return _tensors(case_inputs(name, size_name),
                  CASES[name].dtype or size.dtype, device)


_GENERIC = ("generic_live", "car", "mixed_live", "vio", "epoch", "vo")


def _case_call(name):
  """The KernelCall of a case whose kernel is emitted (kernel 15 for
  "bank", the generic kernels' cases), or None."""
  if name == "bank":
    return bank_call()
  return kernel_call(name) if CASES[name].inputs in _GENERIC else None


def case_sources(names, size_name) -> dict:
  """name -> the emitted source of each case's kernel at the size's dtype,
  for spawn_ranks to hand to the ranks (each would emit it again)."""
  dtype = SIZES[size_name].dtype
  return {n: _case_call(n).source(dtype) for n in names
          if _case_call(n) is not None}


def require_built(names, size_name):
  """Raise unless every kernel the cases launch on the card is built: the
  ranks load what the parent built and never run a compiler."""
  dtype = SIZES[size_name].dtype
  missing = [] if _build.library_path().exists() else ["csrc/*.cu"]
  for name in names:
    if _case_call(name) is not None:
      d = _build.generated_dir(_case_call(name).source(dtype))
      if not (d / "libgen.so").exists():
        missing.append(f"{name}: {d.name}")
    if name == "smoother":
      spec = _models()["kin"].build_spec()
      for src in (smooth_scan.smooth_source(spec, ()),
                  smooth_scan.affine_source(spec.dim_main_err)):
        d = _build.generated_dir(src)
        if not (d / "libgen.so").exists():
          missing.append(f"{name}: {d.name}")
  if missing:
    raise RuntimeError(f"kernels not built before the ranks started: "
                       f"{missing}")


def run_cases(mesh, mesh2, size_name: str, names, keep_outputs: bool,
              timing: bool = False) -> dict:
  """Run each case's sharded call on this rank: its launch counts (the
  difference around the call), its lanes, its wall time, with timing a
  second call's CUDA-event time (not counted), and with keep_outputs the
  gathered outputs on the host."""
  dev = sharding.mesh_device(mesh)
  out = {}
  for name in names:
    case = CASES[name]
    t0 = time.perf_counter()
    tin = _inputs_on(name, size_name, dev)
    inputs_s = time.perf_counter() - t0
    before = launch_counts()
    t0 = time.perf_counter()
    res = case.sharded(mesh, mesh2, tin)
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    rec = {"counts": launched_since(before),
           "lanes": int(res["x"][0].shape[res["x"][1]]), "wall_s": wall,
           "inputs_s": inputs_s, "ms": None}
    if timing and dev.type == "cuda" and case.kernel is not None:
      ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
      ev[0].record()
      case.sharded(mesh, mesh2, tin)
      ev[1].record()
      torch.cuda.synchronize(dev)
      rec["ms"] = ev[0].elapsed_time(ev[1])
    whole = {k: (sharding.gather_bank(m, t, d) if d is not None else t)
             for k, (t, d, m) in res.items()}
    rec["batch"] = int(whole["x"].shape[res["x"][1]])
    if keep_outputs:
      rec["outputs"] = {k: t.detach().cpu() for k, t in whole.items()}
    out[name] = rec
  return out


def multislice_rows(n: int) -> int:
  """The slices of the dry run's 2-D mesh: 2 where n splits in pairs of
  at least two ranks, else 1."""
  return 2 if n >= 4 and n % 2 == 0 else 1


def _rank_main(rank, n, workdir, device, size_name, names, sources=None):
  t0 = time.perf_counter()
  dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                          rank=rank, world_size=n)
  dtype = SIZES[size_name].dtype
  for name, text in (sources or {}).items():
    _case_call(name).prime(text, dtype)
  try:
    if device == "cpu":
      torch.set_num_threads(1)
    mesh = sharding.make_bank_mesh(device)
    mesh2 = sharding.make_multislice_mesh(multislice_rows(n), device)
    cuda = sharding.mesh_device(mesh).type == "cuda"
    if cuda:
      require_built(names, size_name)
    setup_s = time.perf_counter() - t0
    res = run_cases(mesh, mesh2, size_name, names, keep_outputs=rank == 0,
                    timing=cuda)
    res["rank"] = rank
    res["setup_s"] = setup_s     # the group, the meshes, any emission
    res["device"] = str(sharding.mesh_device(mesh))
    torch.save(res, os.path.join(workdir, f"rank{rank}.pt"))
  finally:
    dist.destroy_process_group()


def spawn_ranks(n: int, device="cuda", size_name: str = "small",
                names=None, workdir=None, sources=None) -> list:
  """Spawn n Gloo ranks (a file store in workdir, else a temporary
  directory), each running every case of `names` (default all) through
  run_cases; returns each rank's record, rank 0's with the gathered
  outputs. sources (case_sources): the cases' emitted kernels, which the
  ranks take instead of emitting them. A rank that fails raises here."""
  names = tuple(CASES) if names is None else tuple(names)
  with tempfile.TemporaryDirectory(dir=workdir) as d:
    mp.spawn(_rank_main, args=(n, d, device, size_name, names, sources),
             nprocs=n, join=True)
    return [torch.load(pathlib.Path(d) / f"rank{r}.pt", weights_only=True)
            for r in range(n)]


# ------------------------------------------------------------ the checks

def unsharded_outputs(size_name: str, device, names=None) -> dict:
  """Each case's unsharded call on `device`, its outputs on the host."""
  names = tuple(CASES) if names is None else tuple(names)
  dev = torch.device(device)
  out = {}
  for name in names:
    res = CASES[name].unsharded(_inputs_on(name, size_name, dev))
    out[name] = {k: t.detach().cpu() for k, t in res.items()}
  return out


def same(a, b) -> bool:
  """Bitwise equal, NaN where the other is NaN (a lane lost the same way
  in both)."""
  if a.shape != b.shape or a.dtype != b.dtype:
    return False
  nan = torch.isnan(a)
  return bool(torch.equal(nan, torch.isnan(b))
              and torch.equal(a[~nan], b[~nan]))


def rel_err(a, b) -> float:
  """max |a - b| / max |b| over the finite entries of b."""
  a, b = a.double(), b.double()
  ok = torch.isfinite(b)
  scale = float(b[ok].abs().max()) if bool(ok.any()) else 0.0
  return float((a[ok] - b[ok]).abs().max()) / scale if scale else 0.0


def verify(results: list, size_name: str, refs: dict, device) -> list:
  """Hold each rank's launch counts and lanes, and rank 0's gathered
  outputs against the unsharded ones (refs): exact, or within the case's
  tolerance. Returns one row a case; raises on the first failure."""
  size = SIZES[size_name]
  n = len(results)
  cuda = torch.device(device).type == "cuda"
  rows = []
  for name, ref in refs.items():
    case = CASES[name]
    want = ({} if not cuda else dict(case.card_counts) if case.card_counts
            else {case.kernel.__name__: 1} if case.kernel else {})
    B = results[0][name]["batch"]
    for r in results:
      if r[name]["counts"] != want:
        raise AssertionError(f"{name}: rank {r['rank']} launched "
                             f"{r[name]['counts']}, expected {want}")
      if r[name]["lanes"] * n != B:
        raise AssertionError(f"{name}: rank {r['rank']} ran "
                             f"{r[name]['lanes']} of {B} lanes on {n}")
    errs = {}
    for k, w in ref.items():
      got = results[0][name]["outputs"][k]
      if got.shape != w.shape:
        raise AssertionError(f"{name}/{k}: shape {tuple(got.shape)}, "
                             f"unsharded {tuple(w.shape)}")
      tol = _tol(case, size, k)
      if tol == 0.0:
        if not same(got, w):
          raise AssertionError(f"{name}/{k}: sharded != unsharded (max "
                               f"abs diff {float((got - w).abs().max())})")
        errs[k] = 0.0
      else:
        errs[k] = rel_err(got, w)
        if not errs[k] <= tol:
          raise AssertionError(f"{name}/{k}: relative error {errs[k]:.3e} "
                               f"over {tol:.0e}")
    rows.append({"case": name, "errs": errs,
                 "ms": [r[name]["ms"] for r in results],
                 "wall_s": [r[name]["wall_s"] for r in results],
                 "lanes": results[0][name]["lanes"], "batch": B,
                 "kernel": case.kernel.__name__ if case.kernel else None})
  return rows


def dryrun_multichip(n: int, device="cuda", size_name: str = "small",
                     workdir=None) -> list:
  """Spawn n ranks on `device` ("cuda": all on the card's cuda:0 where
  it has one; "cpu": the host), run every case sharded over them, and
  hold each against the unsharded call in this process. Returns
  verify's rows."""
  results = spawn_ranks(n, device, size_name, workdir=workdir)
  rows = verify(results, size_name, unsharded_outputs(size_name, device),
                device)
  rmse = float(results[0]["bank"]["outputs"]["rmse64"])
  print(f"dryrun_multichip({n}, {device!r}): ok, bank step (1-D and 2-D "
        f"mesh) + run_bank + lane bank + kernel 2 (1-D and 2-D mesh) + "
        f"kernel 4 (live spec, car params stream) + kernel 6 (live 4-kind "
        f"cycle, VIO frames) + kernel 5 (loc epochs) + kernel 7 "
        f"(msckf_eskf frames) sharded over {n} ranks, each equal to the "
        f"unsharded call; staged rmse={rmse:.4f} (1-D and multislice "
        f"{multislice_rows(n)} x {n // multislice_rows(n)}); time-sharded "
        f"parallel smoother within {SMOOTH_TOL:.0e} of the unsharded one "
        f"over {SIZES[size_name].smooth_T} steps")
  return rows


if __name__ == "__main__":
  import argparse

  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("n", nargs="?", type=int, default=2)
  ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
  ap.add_argument("--size", default="small", choices=tuple(SIZES))
  a = ap.parse_args()
  dryrun_multichip(a.n, a.device, a.size)
