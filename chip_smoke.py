#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one H100

Builds the port's CUDA kernels from csrc/ (rednose_tpu_torch/_build.py),
then:
  1. main path, with every kernel's launch count set to 0 first:
     KinematicKalman(device="cuda") on a 100-observation stream (P shrinks,
     a late observation rewinds and replays, a too-old one returns None);
     the kinematic bank scan at B = 16384, T = 4096 with the gate on;
     LiveKalmanBank(batch=8192, device="cuda"): run_mixed over T = 1024
     steps of the gyro / accel / camera rotation / position schedule, run
     over T = 1024 ECEF_POS steps, 8 observe calls with one late; all
     finite, P exactly symmetric, no diverged lane, every position within
     8 sigma + 5 m of the truth. Every kernel must have launched at least
     once.
  2. each kernel against its plain torch version on the card (kinematic at
     B = 16384, T = 4096; live at B = 8192, T = 64, from the main path's
     final bank state), the difference in standard deviations of the plain
     result (utils/compare.py), and both timed with CUDA events.
Prints the card's name and power limit, a JSON line of the kernels, and
last `{"ok": true, "device": {...}}`. Any failure raises (non-zero exit).
It needs a CUDA card and the repository; without either it exits non-zero
and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
KIN_B, KIN_T = 16384, 4096
LIVE_B, LIVE_T = 8192, 1024
CMP_T = 64
# kernel vs plain version, in standard deviations of the plain result
# (utils/compare.py): both float32, differing in rounding only (FMA
# contraction and rsqrtf in the kernel, torch's separate elementwise ops)
KIN_TOL = 1e-3
LIVE_TOL = 1e-3


def log(msg):
  print(msg, flush=True)


def require(ok, what):
  """Fail the run when a check does not hold (unlike assert, kept under
  python -O)."""
  if not ok:
    raise RuntimeError(f"check failed: {what}")


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
  """Mean device time of fn() over reps calls after one warm-up call."""
  import torch

  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def kinematic_inputs(torch, dev, gen):
  from rednose_tpu_torch.models.kinematic import KinematicKalman
  from rednose_tpu_torch.ops import kinematic_scan

  x0 = torch.as_tensor(KinematicKalman.initial_x, dtype=torch.float32,
                       device=dev).expand(KIN_B, 2)
  P0 = torch.as_tensor(np.diag(KinematicKalman.initial_P_diag),
                       dtype=torch.float32, device=dev).expand(KIN_B, 2, 2)
  state = kinematic_scan.pack_state(x0, P0).contiguous()
  zs = 0.5 * torch.randn((KIN_T, KIN_B), generator=gen, device=dev)
  dts = torch.full((KIN_T,), 0.01, device=dev)
  rs = torch.full((KIN_T,), 0.1**2, device=dev)
  Q = KinematicKalman.Q
  q = torch.tensor([Q[0, 0], Q[0, 1], Q[1, 1]], dtype=torch.float32,
                   device=dev)
  return state, zs, dts, rs, q


def mixed_schedule(torch, dev, gen, T):
  """The 4-kind sensor cycle of the bench (gyro, accel, camera rotation,
  position) for a bank at rest at LiveKalman.initial_x: each measurement
  is the model's h at that state plus noise of the kind's scale, so the
  filters stay consistent and keep tracking."""
  from rednose_tpu_torch.models.live import (
      LiveKalman,
      ObservationKind as K,
      build_live_spec,
  )

  kinds = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)
  spec = build_live_spec()
  x0 = torch.as_tensor(LiveKalman.initial_x, dtype=torch.float64)
  h0 = torch.stack([spec.obs[k].h({}, x0, None) for k in kinds]).to(
      device=dev, dtype=torch.float32)                      # (4, 3)
  scale = torch.tensor([0.025, 0.5, 0.05, 5.0], device=dev)  # obs_noise std
  kind_idx = np.arange(T) % len(kinds)
  ki = torch.as_tensor(kind_idx, device=dev)
  zs = h0[ki][:, None, :] + scale[ki][:, None, None] * torch.randn(
      (T, LIVE_B, 3), generator=gen, device=dev)
  return kinds, kind_idx, zs


def main_path(torch, dev, gen):
  """Phase 1: the port's entry points, as a user calls them."""
  from rednose_tpu_torch.models.kinematic import KinematicKalman
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import kinematic_scan
  from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank

  rng = np.random.RandomState(SEED)
  kf = KinematicKalman(device=dev)
  for t in np.arange(0, 1.0, 0.01):
    kf.predict_and_observe(t, 1, [rng.normal(0, 0.1)])
  require(np.all(np.diag(kf.P) < KinematicKalman.initial_P_diag),
          f"single-filter P shrinks: {kf.P}")
  require(kf.predict_and_observe(0.5, 1, [1.0]) is not None,
          "a late observation rewinds and replays")
  require(kf.t > 0.98, "the replay ends at the newest observation")
  require(kf.predict_and_observe(-5.0, 1, [0.0]) is None,
          "a too-old observation is dropped")
  log(f"single filter: x={kf.x.tolist()} diag(P)={np.diag(kf.P).tolist()}")

  state, zs, dts, rs, q = kinematic_inputs(torch, dev, gen)
  out = kinematic_scan.kinematic_bank_scan(state, zs, dts, rs, q, maha=True)
  torch.cuda.synchronize()
  require(bool(torch.isfinite(out).all()), "kinematic bank finite")
  # the measurements scatter 5x wider than R, so the gate rejects many and
  # P may grow between accepted ones: check it stays positive definite
  require(bool((out[2] > 0).all() and (out[2] * out[4] > out[3] * out[3]).all()),
          "kinematic bank P positive definite")
  log(f"kinematic bank B={KIN_B} T={KIN_T}: mean P00 "
      f"{float(out[2].mean()):.6g}")

  bank = LiveKalmanBank(batch=LIVE_B, device=dev)
  pos = torch.as_tensor(LiveKalman.initial_x[0:3], dtype=torch.float32,
                        device=dev)
  zs = pos + 5.0 * torch.randn((LIVE_T, LIVE_B, 3), generator=gen,
                               device=dev)
  # run_mixed first: its measurements are made for a bank at rest, which a
  # fresh bank is; after ECEF_POS-only steps the unobserved attitude and
  # acceleration have wandered and the accelerometer rows would disagree
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, LIVE_T)
  t0 = time.perf_counter()
  bank.run_mixed(np.full(LIVE_T, 0.01), kind_idx, zs_m, kinds)
  torch.cuda.synchronize()
  t_mixed = time.perf_counter() - t0
  after_mixed = (bank._x, bank._P)  # new tensors every call: a snapshot
  t0 = time.perf_counter()
  bank.run(np.full(LIVE_T, 0.01), zs)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  t_base = bank.t
  for i in (1, 2, 3, 5, 6, 4, 7, 8):  # the 4th call arrives late
    z = LiveKalman.initial_x[0:3] + rng.normal(0, 5.0, (LIVE_B, 3))
    require(bank.observe(t_base + 0.01 * i, K.ECEF_POS, z) is not None,
            f"observe {i} applied")
  require(abs(bank.t - (t_base + 0.08)) < 1e-9, "bank time after observe")
  require(bank.observe(t_base - 5.0, K.ECEF_POS, z) is None,
          "a too-old bank observation is dropped")
  torch.cuda.synchronize()
  require(bool(torch.isfinite(bank._x).all()
               and torch.isfinite(bank._P).all()), "live bank finite")
  require(torch.equal(bank._P, bank._P.transpose(0, 1)), "P symmetric")
  require(int(bank.diverged().sum()) == 0, "no diverged lane")
  sd = torch.diagonal(bank._P, dim1=0, dim2=1)[:, 0:3].sqrt()
  err = (bank._x[0:3] - pos[:, None]).abs().T
  require(bool((err < 8.0 * sd + 5.0).all()), "live bank keeps the position")
  log(f"live bank B={LIVE_B}: run_mixed T={LIVE_T} {t_mixed * 1e3:.3f} ms, "
      f"run T={LIVE_T} {t_run * 1e3:.3f} ms (host clock, first calls), "
      f"position sigma {float(sd.mean()):.4g} m, max error "
      f"{float(err.max()):.4g} m")
  return {"live_bank_scan": (bank._x, bank._P, bank._q_diag),
          "live_bank_scan_mixed": after_mixed + (bank._q_diag,)}


def compare(name, source, replaces, kernel, plain, args, kw, err, tol, reps,
            shape):
  """Run the kernel and its plain version on the same inputs; the kernel
  passes when their difference, in standard deviations of the plain
  result (utils/compare.py), is at most tol."""
  out_k = kernel(*args, **kw)
  out_p = plain(*args, **kw)
  flat = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
  e = err(out_k, out_p)
  row = dict(
      name=name, route="cuda", source=source, replaces=replaces,
      max_abs_err=max(float((a - b).abs().max())
                      for a, b in zip(flat(out_k), flat(out_p))),
      sigma_err=e, ok=e <= tol,
      ms=cuda_ms(lambda: kernel(*args, **kw), reps),
      plain_ms=cuda_ms(lambda: plain(*args, **kw), 1), shape=shape)
  log(f"{name} [{shape}]: kernel {row['ms']:.4f} ms, plain "
      f"{row['plain_ms']:.4f} ms; max |kernel - plain| "
      f"{row['max_abs_err']:.4g} = {e:.4g} sigma (tolerance {tol}) -> "
      f"{'ok' if row['ok'] else 'FAIL'}")
  return row


def compare_kernels(torch, dev, gen, live_states):
  """Phase 2: each kernel against its plain version on the same inputs.
  The live kernels start from bank states of the main path whose attitude
  has converged and that fit the measurements that follow: kernel 2 from
  the final state (ECEF_POS data), kernel 3 from the state after
  run_mixed (data of a bank at rest). From the 10-rad attitude prior,
  float32 itself cancels P = 100 to ~1e-3 in the first accelerometer
  update; and where the data disagree with the state, many measurements
  sit at the gate, where a rounding difference flips the decision. Either
  way two float32 programs part by whole sigmas whatever their quality."""
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import kinematic_scan, live_scan
  from rednose_tpu_torch.utils.compare import (
      kinematic_sigma_err,
      live_sigma_err,
  )

  def kin_err(a, ref):
    return max(kinematic_sigma_err(a, ref))

  def live_err(a, ref):
    return max(live_sigma_err(*a, *ref))

  rows = [compare(
      "kinematic_bank_scan", "rednose_tpu_torch/csrc/kinematic_scan.cu",
      "rednose_tpu/ops/pallas_step.py:69", kinematic_scan.kinematic_bank_scan,
      kinematic_scan.kinematic_scan_reference,
      kinematic_inputs(torch, dev, gen), dict(maha=True), kin_err, KIN_TOL,
      10, f"B={KIN_B} T={KIN_T} gate on")]

  x0, P0, q_diag = live_states["live_bank_scan"]
  dts = torch.full((CMP_T,), 0.01, device=dev)
  zs = (torch.as_tensor(LiveKalman.initial_x[0:3], dtype=torch.float32,
                        device=dev)[:, None]
        + 5.0 * torch.randn((CMP_T, 3, LIVE_B), generator=gen,
                            device=dev)).contiguous()
  R = torch.as_tensor(LiveKalman.obs_noise[K.ECEF_POS], dtype=torch.float32,
                      device=dev)
  rows.append(compare(
      "live_bank_scan", "rednose_tpu_torch/csrc/live_scan.cu",
      "rednose_tpu/ops/pallas_live.py:62", live_scan.live_bank_scan,
      live_scan.live_bank_scan_reference, (x0, P0, zs, dts, q_diag, R),
      dict(gate=True), live_err, LIVE_TOL, 5,
      f"B={LIVE_B} T={CMP_T} gate on"))

  x_m, P_m, q_diag = live_states["live_bank_scan_mixed"]
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, CMP_T)
  R_by_kind = torch.stack([
      torch.as_tensor(LiveKalman.obs_noise[k], dtype=torch.float32,
                      device=dev) for k in kinds])
  # the camera-rotation kind streams its per-step variances (live_kf.py:
  # 325-337), so the streamed-R branch is compared too
  r_stream = (0.05 + 0.01 * torch.rand((CMP_T, 3), generator=gen,
                                       device=dev)) ** 2
  rows.append(compare(
      "live_bank_scan_mixed", "rednose_tpu_torch/csrc/live_scan.cu",
      "rednose_tpu/ops/pallas_live.py:154", live_scan.live_bank_scan_mixed,
      live_scan.live_bank_scan_mixed_reference,
      (x_m, P_m, zs_m.permute(0, 2, 1).contiguous(), dts,
       torch.as_tensor(kind_idx, dtype=torch.int32, device=dev), kinds,
       R_by_kind, q_diag),
      dict(gate=True, r_stream=r_stream,
           stream_kinds=(K.CAMERA_ODO_ROTATION,)),
      live_err, LIVE_TOL, 5,
      f"B={LIVE_B} T={CMP_T} gate on, 4 kinds, 1 streamed"))

  bad = [r["name"] for r in rows if not r["ok"]]
  require(not bad, f"kernels agree with their plain versions: {bad}")
  return rows


def main():
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
          file=sys.stderr)
    return 1
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import kinematic_scan, live_scan

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
  t0 = time.perf_counter()
  lib = _build.build()
  log(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib.name}")
  for line in _build.ptxas_report().splitlines():
    if "registers" in line or "spill" in line or "Compiling" in line:
      log(f"  ptxas: {line.strip()}")

  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev)
  gen.manual_seed(SEED)
  wrappers = (kinematic_scan.kinematic_bank_scan, live_scan.live_bank_scan,
              live_scan.live_bank_scan_mixed)
  for w in wrappers:
    w.launches = 0
  live_states = main_path(torch, dev, gen)
  launches = {w.__name__: w.launches for w in wrappers}
  log(f"main-path launches: {launches}")
  require(all(n > 0 for n in launches.values()),
          f"every kernel launched on the main path: {launches}")

  rows = compare_kernels(torch, dev, gen, live_states)
  print(json.dumps({"kernels": [
      {k: r[k] for k in ("name", "route", "source", "replaces")}
      | {"launches": launches[r["name"]], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"]} for r in rows]}))
  print(card_line())
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
