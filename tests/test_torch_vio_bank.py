"""Camera frames in a mixed schedule on the CPU, float64, B = 8, against the
JAX package: the plain version of kernel 6 (ops/lane_bank.
lane_mixed_bank_scan, whose feature steps augment) against the JAX lane
twin, and MSCKFBank(device="cpu").run_mixed against the JAX
MSCKFBank(use_pallas=False).run_mixed, each at rtol 1e-9 for msckf_vo and
msckf_eskf over camera frame / position fix / frame / fix (the schedule of
tests/test_msckf_bank.py:185-225), the banks then driven on through
observe_frame and observe."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import msckf_eskf as jes
from rednose_tpu.models import msckf_vo as jvo
from rednose_tpu.ops import lane_bank as jl
from rednose_tpu.ops import sparsity as jsparsity
from rednose_tpu.runtime.msckf_bank import MSCKFBank as JBank
from rednose_tpu_torch import interop
from rednose_tpu_torch.models import msckf_eskf as tes
from rednose_tpu_torch.models import msckf_vo as tvo
from rednose_tpu_torch.ops import generic_scan, lane_bank
from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank
from torch_parity import np_, t64, vio_schedule

B, T = 8, 4
KIND, POS = 16, 12
KINDS = (POS, KIND)
DT = 0.05
MODELS = pytest.mark.parametrize("models", [
    (jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry),
    (jes.MSCKFEskf, tes.MSCKFEskf)], ids=["msckf_vo", "msckf_eskf"])


def _close(ours, ref, rtol=1e-9):
  np.testing.assert_allclose(np_(ours[0]), np_(ref[0]), rtol=rtol,
                             atol=1e-12)
  np.testing.assert_allclose(np_(ours[1]), np_(ref[1]), rtol=rtol,
                             atol=1e-13)


@MODELS
def test_plain_mixed_scan_with_frames_matches_jax_lane(models):
  """The plain kernel 6: a feature step is a predict, the projected update
  and the window augment, as in JAX lane_bank.py:600-614."""
  jm, tm = models
  xs, zs, eas, kind_idx = vio_schedule(tm, T, B, seed=0)
  P = np.tile(np.diag(tm.initial_P_diag)[:, :, None], (1, 1, B))
  R_list = (np.eye(3), 0.01**2 * np.eye(8))
  dts = np.full(T, DT)
  jspec = jm.build_spec()
  x, Pj = jl.jit_lane_mixed_bank_scan(
      jspec, KINDS, jsparsity.structure_for(jspec, jm.initial_x))(
          {}, jnp.asarray(xs), jnp.asarray(P), jnp.asarray(jm.Q),
          jnp.asarray(dts), jnp.asarray(kind_idx), jnp.asarray(zs),
          tuple(jnp.asarray(R) for R in R_list), eas=jnp.asarray(eas))
  ours = lane_bank.lane_mixed_bank_scan(
      tm.build_spec(), KINDS, {}, t64(xs), t64(P), t64(tm.Q), t64(dts),
      kind_idx, t64(zs), [t64(R) for R in R_list], eas=t64(eas))
  _close((ours[0].T, ours[1]),
         interop.lane_bank_from_jax(x, Pj, torch.float64))


@MODELS
def test_run_mixed_with_frames_matches_jax_bank(models):
  """MSCKFBank.run_mixed with camera frames (the kernel-6 wrapper's plain
  route on the CPU), then a frame through observe_frame and a position fix
  through observe, against the JAX bank's lane path."""
  jm, tm = models
  xs, zs, eas, kind_idx = vio_schedule(tm, T + 1, B, seed=1)
  R_by_kind = {POS: np.eye(3), KIND: 0.01**2 * np.eye(8)}
  jb = JBank(jm, batch=B, dtype=jnp.float64, x0=xs, use_pallas=False)
  tb = MSCKFBank(tm, batch=B, dtype=torch.float64, x0=xs, device="cpu")
  n = generic_scan.generic_bank_scan_mixed.launches
  for b in (jb, tb):
    b.run_mixed(np.full(T, DT), kind_idx[:T], zs[:T], KINDS,
                R_by_kind=R_by_kind, eas=eas[:T])
  assert generic_scan.generic_bank_scan_mixed.launches == n  # CPU: plain
  _close((tb._x, tb._P), interop.lane_bank_from_jax(jb.x, jb._P,
                                                     torch.float64))
  for b in (jb, tb):
    b.observe_frame(b.t + DT, zs[T], eas[T])
    b.observe(b.t + DT, POS, xs[:, 0:3] + 0.05)
  _close((tb._x, tb._P), interop.lane_bank_from_jax(jb.x, jb._P,
                                                     torch.float64))
  assert tb.t == pytest.approx(jb.t, abs=1e-12)


def test_run_mixed_takes_eas_iff_the_schedule_has_frames():
  tm = tvo.MSCKFVisualOdometry
  xs, zs, eas, kind_idx = vio_schedule(tm, T, B, seed=2)
  bank = MSCKFBank(tm, batch=B, dtype=torch.float64, x0=xs, device="cpu")
  with pytest.raises(ValueError, match="eas"):
    bank.run_mixed(np.full(T, DT), kind_idx, zs, KINDS)
  with pytest.raises(ValueError, match="eas"):
    bank.run_mixed(np.full(2, DT), np.zeros(2, np.int32), zs[:2, :, :3],
                   (POS,), eas=eas[:2])
  with pytest.raises(ValueError, match="eas"):
    bank.run_mixed(np.full(T, DT), kind_idx, zs, KINDS, eas=eas[:, :, :2])
  bank.run_mixed(np.full(T, DT), kind_idx, zs, KINDS, eas=eas)
  assert int(bank.diverged().sum()) == 0
  assert bank.t == pytest.approx(T * DT)


def test_a_schedule_of_frames_alone_equals_run_frames():
  """run_mixed over the feature kind alone (kernel 6's plain route) and
  run_frames (kernel 7's) compute the same frames, exactly."""
  tm = tvo.MSCKFVisualOdometry
  xs, zs, eas, _ = vio_schedule(tm, 2 * T, B, seed=3)
  zs, eas = zs[0::2], eas[0::2]           # the camera frames
  a, b = (MSCKFBank(tm, batch=B, dtype=torch.float64, x0=xs, device="cpu")
          for _ in range(2))
  a.run_frames(np.full(T, DT), zs, eas)
  b.run_mixed(np.full(T, DT), np.zeros(T, np.int32), zs, (KIND,), eas=eas)
  assert torch.equal(a._x, b._x) and torch.equal(a._P, b._P)
