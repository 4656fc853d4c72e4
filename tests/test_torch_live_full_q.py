"""The live bank with an off-diagonal Q: on the card it runs the generic
kernels 4 (`run`) and 6 (`run_mixed`, `observe`) on the live spec, whose
plain versions are ops/lane_bank. On the CPU these tests hold those plain
versions, and the bank's whole generic route, against the live full-Q slab
path (live_scan.*_reference) and against the JAX reference, rednose_tpu's
LiveKalmanBank(use_pallas=False), in float64: the function the card runs
with a full Q is the function the CPU and JAX run. Tolerance: 1e-6
standard deviations of the reference in every state and covariance entry
(utils/compare.py; the float64 limit chip_smoke.py holds the live spec's
kernels to): they compute the same algebra in another order, from a 1e8
m^2 prior. The tests marked cuda need the card."""

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax.numpy as jnp
  from rednose_tpu.runtime.live_bank import LiveKalmanBank as JBank
except ImportError:
  jnp = JBank = None

from rednose_tpu_torch.models.live import (
    LiveKalman,
    ObservationKind as K,
    build_live_spec,
)
from rednose_tpu_torch.ops import generic_scan, live_lane, live_scan
from rednose_tpu_torch.runtime.live_bank import (
    LIVE_KINDS,
    LiveKalmanBank,
    _pad3,
    gated_live_spec,
)
from rednose_tpu_torch.utils.compare import lane_sigma_errs
from torch_parity import cuda_device  # noqa: F401

B, T = 6, 32
KINDS = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS,
         K.ODOMETRIC_SPEED, K.NO_ROT)


def full_q():
  """LiveKalman.Q with velocity noise and a symmetric velocity-acceleration
  coupling; its velocity-acceleration block is positive definite."""
  Q = np.asarray(LiveKalman.Q).copy()
  Q[6:9, 6:9] += 0.1**2 * np.eye(3)
  for i in range(3):
    Q[6 + i, 16 + i] = Q[16 + i, 6 + i] = 0.15
  blk = Q[np.ix_([*range(6, 9), *range(16, 19)], [*range(6, 9),
                                                  *range(16, 19)])]
  assert np.linalg.eigvalsh(blk).min() > 0
  return Q


def _dz(kind):
  return live_lane.LANE_KINDS[kind][0]


def _x0():
  # moving at ~1.7 m/s: at standstill the hand model's clamped odometer
  # Jacobian and the autodiff one part ways (a model difference)
  x0 = LiveKalman.initial_x.copy()
  x0[7:10] = [1.0, 1.0, 1.0]
  return x0


def _schedule(seed, T=T, kinds=KINDS):
  rng = np.random.RandomState(seed)
  ki = np.arange(T) % len(kinds)
  zs = 0.05 * rng.randn(T, B, 3)
  for i, k in enumerate(kinds):
    rows = ki == i
    if k == K.ECEF_POS:
      zs[rows] = LiveKalman.initial_x[:3] + rng.randn(rows.sum(), B, 3)
    elif k == K.ODOMETRIC_SPEED:
      zs[rows, :, 0] = np.sqrt(3.0) + 0.1 * rng.randn(rows.sum(), B)
  return ki, zs


def _close(x, P, x_ref, P_ref, tol=1e-6):
  ex, ep = lane_sigma_errs(build_live_spec(), x, P, x_ref, P_ref)
  assert float(ex.max()) < tol and float(ep.max()) < tol, (ex, ep)


def _jax_bank(x0):
  """The JAX reference bank with the full Q, float64, its plain lane path."""
  return JBank(batch=B, x0=x0, Q=full_q(), dtype=jnp.float64,
               use_pallas=False)


def _close_jax(x, P, jbank):
  """x (23, B), P (22, 22, B) against the JAX bank's state."""
  _close(x, P, torch.as_tensor(np.array(jbank._x)).T,
         torch.as_tensor(np.array(jbank._P)))


def _bank_state(seed):
  rng = np.random.RandomState(seed)
  x = torch.as_tensor(np.tile(_x0(), (B, 1)).T
                      + 0.01 * rng.randn(23, B))
  x[3:7] /= x[3:7].norm(dim=0)
  P = torch.as_tensor(np.diag(LiveKalman.initial_P_diag))[:, :, None]
  return x, P.repeat(1, 1, B).contiguous()


@pytest.mark.parametrize("gate", [False, True])
def test_generic_plain_versions_equal_full_q_slab(gate):
  """generic_bank_scan_mixed_reference / generic_bank_scan_reference on the
  live spec with a full Q against live_scan's full-Q slab references and
  the JAX bank's run_mixed / run from the same state."""
  Q = torch.as_tensor(full_q())
  x, P = _bank_state(0)
  ki, zs = _schedule(1)
  zs_b = torch.as_tensor(zs).permute(0, 2, 1).contiguous()
  dts = torch.full((T,), 0.01, dtype=torch.float64)
  R_stack = np.stack([_pad3(LiveKalman.obs_noise[k], _dz(k)) for k in KINDS])
  kidx = torch.as_tensor(ki, dtype=torch.int32)
  ref = live_scan.live_bank_scan_mixed_reference(
      x, P, zs_b, dts, kidx, KINDS, torch.as_tensor(R_stack), Q, gate=gate)
  spec = gated_live_spec() if gate else build_live_spec()
  out = generic_scan.generic_bank_scan_mixed_reference(
      x, P, zs_b, dts, kidx, spec=spec, kinds=KINDS, Q=full_q(),
      R_list=[LiveKalman.obs_noise[k] for k in KINDS], gate=gate)
  _close(*out, *ref)
  jbank = _jax_bank(x.T.numpy())
  jbank.run_mixed(dts.numpy(), ki, zs, KINDS, gate=gate)
  _close_jax(*out, jbank)

  R = LiveKalman.obs_noise[K.ECEF_POS]
  zp = torch.as_tensor(LiveKalman.initial_x[:3][None, :, None]
                       + np.random.RandomState(2).randn(T, 3, B))
  ref = live_scan.live_bank_scan_reference(x, P, zp, dts, Q,
                                           torch.as_tensor(R), gate=gate)
  out = generic_scan.generic_bank_scan_reference(
      x, P, zp, dts, spec=build_live_spec(), kind=K.ECEF_POS, Q=full_q(),
      R=R, gate=gate)
  _close(*out, *ref)
  jbank = _jax_bank(x.T.numpy())
  jbank.run(dts.numpy(), zp.permute(0, 2, 1).numpy(), gate=gate)
  _close_jax(*out, jbank)


@pytest.mark.parametrize("gate", [False, True])
def test_bank_generic_route_equals_slab_route(gate):
  """The bank's full-Q generic route (the one CUDA takes: kernel 6's kind
  set LIVE_KINDS with kind_idx remapped, kept KernelCalls, the gated spec
  for gate=True) run on CPU tensors, where the wrappers run their plain
  versions, against the bank's CPU slab route: run_mixed, run and observe
  with a late observation; and both against the JAX bank on the same
  calls."""
  banks = [LiveKalmanBank(batch=B, x0=_x0(), Q=full_q(), dtype=torch.float64,
                          device="cpu") for _ in range(2)]
  jbank = _jax_bank(_x0())
  banks[1]._generic = True
  ki, zs = _schedule(3)
  zp = LiveKalman.initial_x[:3] + np.random.RandomState(4).randn(8, B, 3)
  n4, n6 = (generic_scan.generic_bank_scan.launches,
            generic_scan.generic_bank_scan_mixed.launches)
  for bank in (*banks, jbank):
    bank.run_mixed(np.full(T, 0.01), ki, zs, KINDS, gate=gate)
    bank.run(np.full(8, 0.01), zp, gate=gate)
    t0 = bank.t
    for i in (1, 2, 4, 3):   # the last one is late: rewind and replay
      z = LiveKalman.initial_x[:3] + 0.5 * i
      assert bank.observe(t0 + 0.01 * i, K.ECEF_POS, z, gate=gate) is not None
  _close(banks[1]._x, banks[1]._P, banks[0]._x, banks[0]._P)
  for bank in banks:
    _close_jax(bank._x, bank._P, jbank)
  assert banks[1].t == jbank.t
  # the generic call of each (mode, kinds, gate) is made once and kept:
  # run_mixed and observe share kernel 6's
  assert len(banks[1]._calls) == 2
  assert {c.kinds for c in banks[1]._calls.values()} == {
      LIVE_KINDS, (K.ECEF_POS,)}
  # an observe with its own R rewrites the kept call's R in place
  call = banks[1]._calls[("mixed", LIVE_KINDS, gate)]
  R_dev = call.values(torch.float64, torch.device("cpu"))[2]
  R = 2.0 * LiveKalman.obs_noise[K.ECEF_POS]
  z = LiveKalman.initial_x[:3] + 2.5
  for bank in (*banks, jbank):
    bank.observe(bank.t + 0.01, K.ECEF_POS, z, R=R, gate=gate)
  assert len(banks[1]._calls) == 2
  assert call.values(torch.float64, torch.device("cpu"))[2] is R_dev
  o = sum(live_lane.LANE_KINDS[k][0] ** 2
              for k in LIVE_KINDS[:LIVE_KINDS.index(K.ECEF_POS)])
  assert torch.equal(R_dev[o:o + 9].reshape(3, 3), torch.as_tensor(R))
  for bank in banks:
    _close_jax(bank._x, bank._P, jbank)
  assert (generic_scan.generic_bank_scan.launches,
          generic_scan.generic_bank_scan_mixed.launches) == (n4, n6)


def test_streamed_kinds_refused_on_the_generic_route():
  bank = LiveKalmanBank(batch=B, Q=full_q(), dtype=torch.float64,
                        device="cpu")
  bank._generic = True
  with pytest.raises(ValueError, match="streamed R"):
    bank.run_mixed(np.full(3, 0.01), np.zeros(3, np.int32),
                   np.zeros((3, B, 3)), (K.CAMERA_ODO_TRANSLATION,),
                   r_stream=np.ones((3, 3)),
                   stream_kinds=(K.CAMERA_ODO_TRANSLATION,))


@pytest.mark.cuda
def test_full_q_bank_on_card_launches_kernels_4_and_6(cuda_device):
  """On the card a full-Q bank runs kernel 4 on run and kernel 6 on
  run_mixed / observe, never the hand kernels, and matches the CPU bank on
  the same route (its plain versions) in float64 to 1e-6 sigma; streamed
  R raises."""
  gpu = LiveKalmanBank(batch=B, x0=_x0(), Q=full_q(), dtype=torch.float64,
                       device=cuda_device)
  cpu = LiveKalmanBank(batch=B, x0=_x0(), Q=full_q(), dtype=torch.float64,
                       device="cpu")
  cpu._generic = True
  before = {w: w.launches for w in (
      generic_scan.generic_bank_scan, generic_scan.generic_bank_scan_mixed,
      live_scan.live_bank_scan, live_scan.live_bank_scan_mixed)}
  ki, zs = _schedule(5, T=16)
  zp = LiveKalman.initial_x[:3] + np.random.RandomState(6).randn(16, B, 3)
  for bank in (gpu, cpu):
    bank.run_mixed(np.full(16, 0.01), ki, zs, KINDS)
    bank.run(np.full(16, 0.01), zp)
    for i in (1, 2, 3):
      bank.observe(bank.t + 0.01, K.ECEF_POS, LiveKalman.initial_x[:3] + i)
  after = {w: w.launches - n for w, n in before.items()}
  assert after[generic_scan.generic_bank_scan] == 1
  assert after[generic_scan.generic_bank_scan_mixed] == 1 + 3
  assert after[live_scan.live_bank_scan] == 0
  assert after[live_scan.live_bank_scan_mixed] == 0
  _close(gpu._x.cpu(), gpu._P.cpu(), cpu._x, cpu._P)
  with pytest.raises(ValueError, match="streamed R"):
    gpu.run_mixed(np.full(3, 0.01), np.zeros(3, np.int32),
                  np.zeros((3, B, 3)), (K.CAMERA_ODO_TRANSLATION,),
                  r_stream=np.ones((3, 3)),
                  stream_kinds=(K.CAMERA_ODO_TRANSLATION,))


@pytest.mark.cuda
@pytest.mark.parametrize("gate", [False, True])
def test_full_q_kernels_match_plain_versions(cuda_device, gate):
  """Kernels 4 and 6 with the full Q (the variants the bank builds, gate
  off and on) against their plain versions on the card, in double;
  kernel 6 over all 8 live kinds, the camera translation with an explicit
  R, as run_mixed's R_by_kind gives it."""
  x, P = (a.to(cuda_device) for a in _bank_state(7))
  ki, zs = _schedule(8, T=16, kinds=LIVE_KINDS)
  zs_b = torch.as_tensor(zs, device=cuda_device).permute(0, 2, 1).contiguous()
  dts = torch.full((16,), 0.01, dtype=torch.float64, device=cuda_device)
  bank = LiveKalmanBank(batch=B, Q=full_q(), device=cuda_device,
                        dtype=torch.float64)
  R_list = [0.1**2 * np.eye(3) if k == K.CAMERA_ODO_TRANSLATION
            else np.atleast_2d(LiveKalman.obs_noise[k]) for k in LIVE_KINDS]
  call = bank._generic_call("mixed", LIVE_KINDS, R_list, gate)
  kidx = torch.as_tensor(ki, dtype=torch.int32, device=cuda_device)
  out = generic_scan.generic_bank_scan_mixed(x, P, zs_b, dts, kidx,
                                             call=call)
  ref = generic_scan._plain(call, x, P, zs_b, dts, None, None, kidx)
  _close(*(a.cpu() for a in out), *(a.cpu() for a in ref))
  call = bank._generic_call("single", (K.ECEF_POS,),
                            (LiveKalman.obs_noise[K.ECEF_POS],), gate)
  zp = torch.as_tensor(LiveKalman.initial_x[:3][None, :, None]
                       + np.random.RandomState(9).randn(16, 3, B),
                       device=cuda_device)
  out = generic_scan.generic_bank_scan(x, P, zp, dts, call=call)
  ref = generic_scan._plain(call, x, P, zp, dts, None, None)
  _close(*(a.cpu() for a in out), *(a.cpu() for a in ref))
