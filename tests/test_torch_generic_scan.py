"""Card-only tests of the generic kernels 4-6 (ops/generic_scan.py): each
kernel against its plain version (ops/lane_bank.py) on a small bank of
the car model, float32 on the card (kernel 4 in float64 too), and the
wrappers' refusal of what the kernels do not take. They skip without a
CUDA card; on the card:
`python -m pytest tests/test_torch_generic_scan.py -m cuda --noconftest`.
This file imports nothing of JAX (the card's machine has none)."""

import numpy as np
import pytest
import torch

from rednose_tpu_torch.models.car import CarKalman, ObservationKind as CK
from rednose_tpu_torch.ops import generic_scan, sparsity
from rednose_tpu_torch.runtime.generic_bank import KalmanBank
from torch_parity import cuda_device  # noqa: F401

B, T = 256, 16
PS_KEYS = ("u", "steer_angle_deg")
# two float32 programs of a well-conditioned 5-state filter: the kernel
# contracts products into FMAs and sums in another order
RTOL, ATOL = 1e-4, 1e-5


def _inputs(dev, K=None):
  rng = np.random.RandomState(0)
  x = np.tile(CarKalman.initial_x, (B, 1)) + 0.05 * rng.randn(B, 5)
  P = np.tile(np.diag(CarKalman.initial_P_diag)[:, :, None], (1, 1, B))
  zs = 0.05 * rng.randn(*((T, K, 1, B) if K else (T, 1, B)))
  pss = np.stack([18.0 + 6.0 * rng.rand(T),
                  25.0 * np.sin(np.linspace(0, 20, T))], axis=1)

  def f32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                           device=dev)

  return (f32(x.T), f32(P), f32(zs), f32(np.full(T, 0.05))), f32(pss)


def _both(fn, args, kw, pss):
  out = fn(*args, pss=pss, **kw)
  torch.cuda.synchronize()
  ref = fn(*[a.cpu() for a in args], pss=pss.cpu(), **kw)
  return out, ref


def _check(out, ref):
  for a, b in zip(out, ref):
    assert a.is_cuda and torch.isfinite(a).all()
    np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=RTOL,
                               atol=ATOL)
  assert torch.equal(out[1], out[1].transpose(0, 1))


@pytest.mark.cuda
def test_kernel4_matches_plain(cuda_device):
  spec = CarKalman.build_spec()
  args, pss = _inputs(cuda_device)
  n = generic_scan.generic_bank_scan.launches
  out, ref = _both(generic_scan.generic_bank_scan, args, dict(
      spec=spec, kind=CK.YAW_RATE, Q=CarKalman.Q,
      R=CarKalman.obs_noise[CK.YAW_RATE], gate=True, ps_keys=PS_KEYS,
      structure=sparsity.structure_for(spec, CarKalman.initial_x)), pss)
  assert generic_scan.generic_bank_scan.launches == n + 1
  _check(out, ref)


@pytest.mark.cuda
def test_kernel6_matches_plain(cuda_device):
  spec = CarKalman.build_spec()
  args, pss = _inputs(cuda_device)
  kinds = (CK.YAW_RATE, CK.LATERAL_SLIP)
  ki = torch.as_tensor(np.arange(T) % 2, dtype=torch.int32,
                       device=cuda_device)
  out = generic_scan.generic_bank_scan_mixed(
      *args, ki, spec=spec, kinds=kinds, Q=CarKalman.Q,
      R_list=[CarKalman.obs_noise[k] for k in kinds], ps_keys=PS_KEYS,
      pss=pss, structure=sparsity.structure_for(spec, CarKalman.initial_x))
  ref = generic_scan.generic_bank_scan_mixed(
      *[a.cpu() for a in args], ki.cpu(), spec=spec, kinds=kinds,
      Q=CarKalman.Q, R_list=[CarKalman.obs_noise[k] for k in kinds],
      ps_keys=PS_KEYS, pss=pss.cpu())
  _check(out, ref)


@pytest.mark.cuda
def test_kernel5_matches_plain(cuda_device):
  spec = CarKalman.build_spec()
  slots = (CK.YAW_RATE, CK.LATERAL_SLIP)
  args, pss = _inputs(cuda_device, K=2)
  out, ref = _both(generic_scan.generic_bank_scan_epoch, args, dict(
      spec=spec, slot_kinds=slots, Q=CarKalman.Q,
      R_list=[CarKalman.obs_noise[k] for k in slots], ps_keys=PS_KEYS,
      structure=sparsity.structure_for(spec, CarKalman.initial_x)), pss)
  _check(out, ref)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
  spec = CarKalman.build_spec()
  (x, P, zs, dts), pss = _inputs(cuda_device)
  kw = dict(spec=spec, kind=CK.YAW_RATE, Q=CarKalman.Q,
            R=CarKalman.obs_noise[CK.YAW_RATE], ps_keys=PS_KEYS, pss=pss)
  n = generic_scan.generic_bank_scan.launches
  with pytest.raises(ValueError, match="contiguous"):
    generic_scan.generic_bank_scan(x.T.contiguous().T, P, zs, dts, **kw)
  with pytest.raises(ValueError, match="float64 tensor, got .*float32"):
    generic_scan.generic_bank_scan(x.double(), P, zs, dts, **kw)
  with pytest.raises(ValueError, match="float32 tensor, got .*float16"):
    generic_scan.generic_bank_scan(x.half(), P, zs, dts, **kw)
  with pytest.raises(ValueError, match="shape"):
    generic_scan.generic_bank_scan(x, P, zs[:, :, :-1].contiguous(), dts,
                                   **kw)
  # T = 0 launches nothing and counts nothing
  out = generic_scan.generic_bank_scan(x, P, zs[:0], dts[:0], **kw | dict(
      pss=pss[:0]))
  assert torch.equal(out[0], x) and torch.equal(out[1], P)
  assert generic_scan.generic_bank_scan.launches == n


@pytest.mark.cuda
def test_kernel4_in_double_matches_plain(cuda_device):
  """A float64 bank runs the double build of the same body: it agrees
  with the float64 plain version to rounding."""
  spec = CarKalman.build_spec()
  args, pss = _inputs(cuda_device)
  args, pss = tuple(a.double() for a in args), pss.double()
  n = generic_scan.generic_bank_scan.launches
  out, ref = _both(generic_scan.generic_bank_scan, args, dict(
      spec=spec, kind=CK.YAW_RATE, Q=CarKalman.Q,
      R=CarKalman.obs_noise[CK.YAW_RATE], gate=True, ps_keys=PS_KEYS,
      structure=sparsity.structure_for(spec, CarKalman.initial_x)), pss)
  assert generic_scan.generic_bank_scan.launches == n + 1
  for a, b in zip(out, ref):
    assert a.dtype == torch.float64
    np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-10,
                               atol=1e-12)
  assert torch.equal(out[1], out[1].transpose(0, 1))


@pytest.mark.cuda
def test_facade_launches_the_kernels(cuda_device):
  bank = KalmanBank(CarKalman, batch=64, device=cuda_device)
  counts = lambda: (generic_scan.generic_bank_scan.launches,  # noqa: E731
                    generic_scan.generic_bank_scan_mixed.launches,
                    generic_scan.generic_bank_scan_epoch.launches)
  before = counts()
  zs = np.zeros((4, 64, 1))
  bank.run(np.full(4, 0.05), zs, CK.YAW_RATE)
  bank.run_mixed(np.full(4, 0.05), np.arange(4) % 2, zs,
                 (CK.YAW_RATE, CK.LATERAL_SLIP))
  bank.run_epochs(np.full(4, 0.05), np.zeros((4, 2, 64, 1)),
                  (CK.YAW_RATE, CK.LATERAL_SLIP))
  bank.observe(bank.t + 0.05, CK.YAW_RATE, np.zeros(1))
  assert tuple(a - b for a, b in zip(counts(), before)) == (2, 1, 1)
  assert int(bank.diverged().sum()) == 0


def _loc_local_epochs(rng, T, B, far):
  """GNSS epochs of 4 pseudoranges + 4 rates for loc receivers at rest at
  the origin (zero clock), satellites 2 km away moving at ~30 m/s, noise at
  0.3 of R's sigma (no distance near the gate's threshold, where two
  float32 programs take a decision apart); with far, slot 1 of every 16th
  lane 100 m off (rejected by a converged bank's gate): zs (T, 8, 1, B),
  eas (T, 8, 6, B)."""
  u = rng.randn(T, 8, B, 3)
  sat = 2e3 * u / np.linalg.norm(u, axis=-1, keepdims=True)
  vel = 30.0 * rng.randn(T, 8, B, 3)
  rho = np.linalg.norm(sat, axis=-1)
  rate = np.sum(sat / rho[..., None] * vel, axis=-1)
  noise = 0.3 * rng.randn(T, 8, B)
  zs = np.where(np.arange(8)[None, :, None] < 4, rho + 2.0 * noise,
                rate + 0.05 * noise)
  if far:
    zs[:, 1, ::16] += 100.0
  return (np.ascontiguousarray(zs[:, :, None, :]),
          np.ascontiguousarray(np.concatenate([sat, vel], -1).swapaxes(-1,
                                                                       -2)))


@pytest.mark.cuda
def test_kernel5_tile_on_loc_ragged_bank(cuda_device):
  """Kernel 5's tile on loc's 8-slot epoch at a ragged bank (B = 8192 + 5:
  a last block of 5 filters, rows not 16-B aligned, so the inputs are
  staged a value a thread), from a bank the float64 plain version
  converged: float32 within 1e-3 sigma of the float32 plain version, the
  double build within 1e-6 sigma of the float64 one (utils/compare.py)."""
  from rednose_tpu_torch.models.loc import LocKalman
  from rednose_tpu_torch.models.live import ObservationKind as K
  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  spec, B, T = LocKalman.build_spec(), 8192 + 5, 16
  slots = (K.PSEUDORANGE_GPS,) * 4 + (K.PSEUDORANGE_RATE_GPS,) * 4
  kw = dict(spec=spec, slot_kinds=slots, Q=LocKalman.Q,
            R_list=[LocKalman.obs_noise[k] for k in slots],
            structure=sparsity.structure_for(spec, LocKalman.initial_x))
  call = generic_scan.KernelCall(spec, "epoch", slots, Q=kw["Q"],
                                 R_list=kw["R_list"],
                                 structure=kw["structure"])
  assert "// design: tile" in call.source(torch.float32)
  assert "// design: tile" in call.source(torch.float64)
  rng = np.random.RandomState(7)
  f64 = dict(dtype=torch.float64, device=cuda_device)
  x = torch.zeros((spec.dim_x, B), **f64)
  P = torch.as_tensor(np.diag(LocKalman.initial_P_diag), **f64)[
      :, :, None].repeat(1, 1, B)
  dts = torch.full((T,), 0.1, **f64)
  zs, eas = (torch.as_tensor(a, **f64) for a in _loc_local_epochs(
      rng, 2 * T, B, False))
  x, P = generic_scan.generic_bank_scan_epoch_reference(
      x, P, zs, torch.full((2 * T,), 0.1, **f64), eas=eas, **kw)
  zs, eas = (torch.as_tensor(a, **f64) for a in _loc_local_epochs(
      rng, T, B, True))
  for dtype, tol in ((torch.float32, 1e-3), (torch.float64, 1e-6)):
    args = tuple(a.to(dtype) for a in (x, P, zs, dts))
    n = generic_scan.generic_bank_scan_epoch.launches
    out = generic_scan.generic_bank_scan_epoch(*args, eas=eas.to(dtype), **kw)
    assert generic_scan.generic_bank_scan_epoch.launches == n + 1
    ref = generic_scan.generic_bank_scan_epoch_reference(
        *args, eas=eas.to(dtype), **kw)
    assert out[0].dtype == dtype and torch.isfinite(out[1]).all()
    assert torch.equal(out[1], out[1].transpose(0, 1))
    ex, ep = lane_sigma_errs(spec, *out, *ref)
    assert float(torch.maximum(ex, ep).max()) <= tol, dtype


def _live_inputs(dev, T, B, seed):
  """A live-spec bank near the model's x0 with a well-conditioned P and
  ECEF_POS fixes 0.5 m around each lane's position, float32 on dev."""
  from rednose_tpu_torch.models.live import LiveKalman

  rng = np.random.RandomState(seed)
  x = np.tile(LiveKalman.initial_x, (B, 1))
  x[:, 0:3] += 10.0 * rng.randn(B, 3)
  x[:, 3:] += 0.05 * rng.randn(B, 20)
  x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
  A = 0.1 * rng.randn(B, 22, 22)
  P = (A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(22)).transpose(1, 2, 0)
  zs = x.T[None, 0:3] + 0.5 * rng.randn(T, 3, B)
  f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                  dtype=torch.float32, device=dev)
  return f32(x.T), f32(P), f32(zs), f32(np.full(T, 0.01))


@pytest.mark.cuda
def test_kernel4_tile_ragged_bank_and_short_scans(cuda_device):
  """Kernel 4's tile form (the live spec's ECEF_POS variant, gate on) on a
  bank that is not a multiple of 32 (B = 8192 + 5), at T = 4 and T = 1,
  within 1e-3 sigma of the plain version (utils/compare.py); T = 0
  launches and counts nothing."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.models.live import build_live_spec
  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  spec = build_live_spec()
  call = generic_scan.KernelCall(
      spec, "single", (K.ECEF_POS,), Q=LiveKalman.Q,
      R_list=(LiveKalman.obs_noise[K.ECEF_POS],), gate=True,
      structure=sparsity.structure_for(spec, LiveKalman.initial_x))
  assert _build.generated_info(call.source())["design"] == 1
  x, P, zs, dts = _live_inputs(cuda_device, 4, 8192 + 5, 1)
  for n in (4, 1):
    count = generic_scan.generic_bank_scan.launches
    out = generic_scan.generic_bank_scan(x, P, zs[:n], dts[:n], call=call)
    assert generic_scan.generic_bank_scan.launches == count + 1
    ref = generic_scan.generic_bank_scan_reference(
        x, P, zs[:n], dts[:n], spec=spec, kind=K.ECEF_POS, Q=LiveKalman.Q,
        R=LiveKalman.obs_noise[K.ECEF_POS], gate=True)
    ex, ep = lane_sigma_errs(spec, *out, *ref)
    assert float(torch.maximum(ex, ep).max()) < 1e-3
    assert torch.equal(out[1], out[1].transpose(0, 1))
    assert not torch.equal(out[1][:, :, -1], P[:, :, -1])   # the last lane
  count = generic_scan.generic_bank_scan.launches
  out = generic_scan.generic_bank_scan(x, P, zs[:0], dts[:0], call=call)
  assert torch.equal(out[0], x) and torch.equal(out[1], P)
  assert generic_scan.generic_bank_scan.launches == count


@pytest.mark.cuda
def test_kernel4_global_form_when_the_tile_does_not_fit(cuda_device):
  """msckf_eskf's POSITION variant in double: its tile (32 filters of a
  36 x 36 P in double) exceeds what a block may use, so the source keeps
  the global form (one thread a filter); on a ragged bank it agrees with
  the float64 plain version to rounding. The float variant is a tile."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf

  spec = MSCKFEskf.build_spec()
  call = generic_scan.KernelCall(
      spec, "single", (12,), Q=MSCKFEskf.Q, R_list=(MSCKFEskf.obs_noise[12],),
      structure=sparsity.structure_for(spec, MSCKFEskf.initial_x))
  assert "// design: global" in call.source(torch.float64)
  assert _build.generated_info(call.source(torch.float64))["design"] == 0
  assert _build.generated_info(call.source(torch.float32))["design"] == 1
  rng = np.random.RandomState(2)
  Bn, Tn = 4096 + 5, 2
  x = np.tile(MSCKFEskf.initial_x, (Bn, 1)) + 0.02 * rng.randn(Bn, 41)
  for idx in spec.quaternion_idxs:
    x[:, idx:idx + 4] /= np.linalg.norm(x[:, idx:idx + 4], axis=1,
                                        keepdims=True)
  d64 = dict(dtype=torch.float64, device=cuda_device)
  xt = torch.as_tensor(x.T.copy(), **d64)
  Pt = (0.1 * torch.eye(36, **d64))[:, :, None].repeat(1, 1, Bn)
  zs = torch.as_tensor(x.T[None, 0:3] + rng.randn(Tn, 3, Bn), **d64)
  dts = torch.full((Tn,), 0.05, **d64)
  count = generic_scan.generic_bank_scan.launches
  out = generic_scan.generic_bank_scan(xt, Pt, zs, dts, call=call)
  assert generic_scan.generic_bank_scan.launches == count + 1
  ref = generic_scan.generic_bank_scan_reference(
      xt, Pt, zs, dts, spec=spec, kind=12, Q=MSCKFEskf.Q,
      R=MSCKFEskf.obs_noise[12])
  for a, b in zip(out, ref):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-10,
                               atol=1e-12)
  assert torch.equal(out[1], out[1].transpose(0, 1))


def _mixed_live_call():
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K

  spec = _live_spec()
  kinds = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)
  return generic_scan.KernelCall(
      spec, "mixed", kinds, Q=LiveKalman.Q,
      R_list=[LiveKalman.obs_noise[k] for k in kinds],
      structure=sparsity.structure_for(spec, LiveKalman.initial_x))


def _live_spec():
  from rednose_tpu_torch.models.live import build_live_spec

  return build_live_spec()


@pytest.mark.cuda
def test_kernel6_tile_ragged_bank_and_short_scans(cuda_device):
  """Kernel 6's tile (the live spec's 4-kind mixed variant, float32) on a
  bank that is not a multiple of 32 (B = 8192 + 5: the last block has 27
  lanes past the bank, which reach every barrier and store nothing), at
  T = 1 with each kind in turn, against the plain version; T = 0 launches
  and counts nothing."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  call = _mixed_live_call()
  spec = call.spec
  assert _build.generated_info(call.source())["design"] == 1
  x, P, zs, dts = _live_inputs(cuda_device, 1, 8192 + 5, 3)
  h = [torch.func.vmap(lambda xx, k=k: spec.obs[k].h({}, xx, None))(
      x.double().T) for k in call.kinds]
  for u in range(len(call.kinds)):
    zu = (h[u].T[None] + (0.5 if u == 3 else 0.05) * torch.randn_like(
        h[u].T[None])).float().contiguous()
    ki = torch.tensor([u], dtype=torch.int32, device=cuda_device)
    count = generic_scan.generic_bank_scan_mixed.launches
    out = generic_scan.generic_bank_scan_mixed(x, P, zu, dts, ki, call=call)
    assert generic_scan.generic_bank_scan_mixed.launches == count + 1
    ref = generic_scan.generic_bank_scan_mixed_reference(
        x, P, zu, dts, ki, spec=spec, kinds=call.kinds, Q=call.Q,
        R_list=call.R_list)
    ex, ep = lane_sigma_errs(spec, *out, *ref)
    assert float(torch.maximum(ex, ep).max()) < 1e-3
    assert torch.equal(out[1], out[1].transpose(0, 1))
    assert not torch.equal(out[1][:, :, -1], P[:, :, -1])   # the last lane
  count = generic_scan.generic_bank_scan_mixed.launches
  ki = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
  out = generic_scan.generic_bank_scan_mixed(x, P, zs[:0], dts[:0], ki,
                                             call=call)
  assert torch.equal(out[0], x) and torch.equal(out[1], P)
  assert generic_scan.generic_bank_scan_mixed.launches == count


@pytest.mark.cuda
def test_kernel6_global_form_when_the_tile_does_not_fit(cuda_device):
  """msckf_eskf's mixed variant without a camera frame (POSITION fixes)
  in double: its tile (32 filters of a 36 x 36 P in double) exceeds what
  a block may use, so the source keeps the global form; on a ragged bank
  it agrees with the float64 plain version to rounding. The float
  variant is a tile."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf

  spec = MSCKFEskf.build_spec()
  call = generic_scan.KernelCall(
      spec, "mixed", (12,), Q=MSCKFEskf.Q, R_list=(MSCKFEskf.obs_noise[12],),
      structure=sparsity.structure_for(spec, MSCKFEskf.initial_x))
  assert "// design: global" in call.source(torch.float64)
  assert _build.generated_info(call.source(torch.float64))["design"] == 0
  assert _build.generated_info(call.source(torch.float32))["design"] == 1
  rng = np.random.RandomState(4)
  Bn, Tn = 4096 + 5, 2
  x = np.tile(MSCKFEskf.initial_x, (Bn, 1)) + 0.02 * rng.randn(Bn, 41)
  for idx in spec.quaternion_idxs:
    x[:, idx:idx + 4] /= np.linalg.norm(x[:, idx:idx + 4], axis=1,
                                        keepdims=True)
  d64 = dict(dtype=torch.float64, device=cuda_device)
  xt = torch.as_tensor(x.T.copy(), **d64)
  Pt = (0.1 * torch.eye(36, **d64))[:, :, None].repeat(1, 1, Bn)
  zs = torch.as_tensor(x.T[None, 0:3] + rng.randn(Tn, 3, Bn), **d64)
  dts = torch.full((Tn,), 0.05, **d64)
  ki = torch.zeros((Tn,), dtype=torch.int32, device=cuda_device)
  count = generic_scan.generic_bank_scan_mixed.launches
  out = generic_scan.generic_bank_scan_mixed(xt, Pt, zs, dts, ki, call=call)
  assert generic_scan.generic_bank_scan_mixed.launches == count + 1
  ref = generic_scan.generic_bank_scan_mixed_reference(
      xt, Pt, zs, dts, ki, spec=spec, kinds=(12,), Q=MSCKFEskf.Q,
      R_list=(MSCKFEskf.obs_noise[12],))
  for a, b in zip(out, ref):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-10,
                               atol=1e-12)
  assert torch.equal(out[1], out[1].transpose(0, 1))
