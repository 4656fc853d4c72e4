"""Card-only tests of the camera-frame kernels: kernel 7
(ops/generic_scan.vo_bank_scan) and kernel 6 with its camera-frame branch
(generic_bank_scan_mixed over frames and position fixes), the double
builds of both MSCKF models' bodies against the float64 plain versions
(ops/lane_bank.py) at rtol 1e-10; the launch counts of MSCKFBank's paths;
and the track store (msckf/feature_handler.py) on the card against the
same functions on the CPU, exactly. They skip without a CUDA card; on the
card: `python -m pytest tests/test_torch_msckf_scan.py -m cuda
--noconftest`. This file imports nothing of JAX (the card's machine has
none)."""

import numpy as np
import pytest
import torch

from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
from rednose_tpu_torch.models.msckf_vo import MSCKFVisualOdometry
from rednose_tpu_torch.msckf import feature_handler as fh
from rednose_tpu_torch.ops import generic_scan, sparsity
from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank
from chip_smoke import cohort_tracker
from torch_parity import vio_schedule
from torch_parity import cuda_device  # noqa: F401

B, T = 256, 8
KIND, POS = 16, 12


def _inputs(model, dev, dtype):
  """A bank around x0 with a spread window, frames consistent with it (the
  plain torch h, float64), bank-minor on the card."""
  spec = model.build_spec()
  om = spec.obs[KIND]
  rng = np.random.RandomState(0)
  xs = np.tile(model.initial_x, (B, 1)) + 0.02 * rng.randn(B, spec.dim_x)
  for a in range(spec.n_augment):
    o = spec.dim_main + spec.dim_augment * a
    xs[:, o:o + 3] += 0.5 * rng.randn(B, 3)
  for idx in spec.quaternion_idxs:
    xs[:, idx:idx + 4] /= np.linalg.norm(xs[:, idx:idx + 4], axis=1,
                                         keepdims=True)
  eas = np.array([1.0, 0.5, 6.0]) + 0.1 * rng.randn(T, B, 3)
  h = torch.func.vmap(lambda x, e: om.h({}, x, e))
  zs = np.stack([h(torch.as_tensor(xs), torch.as_tensor(eas[t])).numpy()
                 for t in range(T)]) + 0.005 * rng.randn(T, B, om.dz)
  P = np.tile(np.diag(model.initial_P_diag)[:, :, None], (1, 1, B))

  def dv(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

  return spec, (dv(xs.T), dv(P), dv(np.swapaxes(zs, 1, 2)),
                dv(np.swapaxes(eas, 1, 2)), dv(np.full(T, 0.05)))


@pytest.mark.cuda
@pytest.mark.parametrize("model", [MSCKFVisualOdometry, MSCKFEskf],
                         ids=["msckf_vo", "msckf_eskf"])
def test_kernel7_in_double_matches_plain(cuda_device, model):
  spec, args = _inputs(model, cuda_device, torch.float64)
  kw = dict(spec=spec, kind=KIND, Q=model.Q, R=model.obs_noise[KIND],
            structure=sparsity.structure_for(spec, model.initial_x))
  n = generic_scan.vo_bank_scan.launches
  out = generic_scan.vo_bank_scan(*args, **kw)
  torch.cuda.synchronize()
  assert generic_scan.vo_bank_scan.launches == n + 1
  ref = generic_scan.vo_bank_scan_reference(*args, **kw)
  for a, b in zip(out, ref):
    assert a.dtype == torch.float64 and torch.isfinite(a).all()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-10,
                               atol=1e-12)
  assert torch.equal(out[1], out[1].transpose(0, 1))


@pytest.mark.cuda
def test_msckf_bank_launches(cuda_device):
  """run_frames and observe_frame launch kernel 7 once each (a late frame
  once per replayed frame), observe / run of the position kind kernel 4;
  T = 0 launches and counts nothing."""
  spec, (x, P, zs, eas, dts) = _inputs(MSCKFVisualOdometry, cuda_device,
                                       torch.float32)
  bank = MSCKFBank(MSCKFVisualOdometry, batch=B, x0=x.T.cpu().numpy(),
                   device=cuda_device, ckpt_every=1)

  def counts():
    return (generic_scan.vo_bank_scan.launches,
            generic_scan.generic_bank_scan.launches)

  zs_l, eas_l = zs.permute(0, 2, 1), eas.permute(0, 2, 1)
  before = counts()
  bank.run_frames(np.zeros(0), zs_l[:0], eas_l[:0])
  assert counts() == before
  bank.run_frames(np.full(4, 0.05), zs_l[:4], eas_l[:4])
  assert counts() == (before[0] + 1, before[1])
  t = bank.t
  bank.observe_frame(t + 0.05, zs_l[4].cpu().numpy(), eas_l[4].cpu().numpy())
  bank.observe(t + 0.10, POS, x[0:3].T.cpu().numpy())
  bank.observe_frame(t + 0.20, zs_l[6].cpu().numpy(), eas_l[6].cpu().numpy())
  bank.observe_frame(t + 0.15, zs_l[5].cpu().numpy(), eas_l[5].cpu().numpy())
  # 3 frames in order, then the late one and the replayed one at t + 0.20
  assert counts() == (before[0] + 1 + 4, before[1] + 1)
  bank.run(np.full(2, 0.1), x[0:3].T[None].expand(2, -1, -1), POS)
  assert counts() == (before[0] + 5, before[1] + 2)
  assert int(bank.diverged().sum()) == 0


def _mixed_inputs(model, dev, dtype):
  xs, zs, eas, kind_idx = vio_schedule(model, T, B, seed=1)
  P = np.tile(np.diag(model.initial_P_diag)[:, :, None], (1, 1, B))

  def dv(a, dt=dtype):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

  return xs, zs, eas, kind_idx, (
      dv(xs.T), dv(P), dv(np.swapaxes(zs, 1, 2)), dv(np.full(T, 0.05)),
      dv(kind_idx, torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("model", [MSCKFVisualOdometry, MSCKFEskf],
                         ids=["msckf_vo", "msckf_eskf"])
def test_kernel6_with_frames_in_double_matches_plain(cuda_device, model):
  spec = model.build_spec()
  _, _, eas, _, args = _mixed_inputs(model, cuda_device, torch.float64)
  kw = dict(spec=spec, kinds=(POS, KIND), Q=model.Q,
            R_list=(np.eye(3), model.obs_noise[KIND]),
            structure=sparsity.structure_for(spec, model.initial_x),
            eas=torch.as_tensor(np.swapaxes(eas, 1, 2).copy(),
                                device=cuda_device))
  n = generic_scan.generic_bank_scan_mixed.launches
  out = generic_scan.generic_bank_scan_mixed(*args, **kw)
  torch.cuda.synchronize()
  assert generic_scan.generic_bank_scan_mixed.launches == n + 1
  ref = generic_scan.generic_bank_scan_mixed_reference(*args, **kw)
  for a, b in zip(out, ref):
    assert a.dtype == torch.float64 and torch.isfinite(a).all()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-10,
                               atol=1e-12)
  assert torch.equal(out[1], out[1].transpose(0, 1))


@pytest.mark.cuda
def test_run_mixed_with_frames_launches(cuda_device):
  """run_mixed with camera frames launches kernel 6 once a call, and no
  other kernel; T = 0 launches and counts nothing."""
  xs, zs, eas, kind_idx, _ = _mixed_inputs(MSCKFEskf, cuda_device,
                                           torch.float32)
  bank = MSCKFBank(MSCKFEskf, batch=B, x0=xs, device=cuda_device)

  def counts():
    return (generic_scan.generic_bank_scan_mixed.launches,
            generic_scan.vo_bank_scan.launches,
            generic_scan.generic_bank_scan.launches)

  before = counts()
  bank.run_mixed(np.zeros(0), kind_idx[:0], zs[:0], (POS, KIND), eas=eas[:0])
  assert counts() == before
  for k in (1, 2):
    bank.run_mixed(np.full(T, 0.05), kind_idx, zs, (POS, KIND), eas=eas)
    assert counts() == (before[0] + k, before[1], before[2])
  assert int(bank.diverged().sum()) == 0


@pytest.mark.cuda
def test_track_store_on_the_card_equals_the_cpu(cuda_device):
  """Two frames of the cohort tracker through harvest_complete,
  reset_seen, empty_slots and merge_features, float64 on the card and on
  the CPU: every output equal."""
  K, n_tracks, cohort = 4, 600, 100
  tracks0, feats, _, _ = cohort_tracker(K, n_tracks, cohort, 2)
  outs = {}
  for dev in ("cpu", cuda_device):
    tr = torch.as_tensor(tracks0, device=dev)
    got = []
    for t in range(2):
      idxs, uv, tr = fh.harvest_complete(tr, cohort + 8)
      tr = fh.reset_seen(tr)
      empty = fh.empty_slots(tr, K * cohort)
      tr, dropped = fh.merge_features(
          tr, torch.as_tensor(feats[t], device=dev), empty)
      got += [idxs, uv, empty, tr, dropped, fh.sane(tr)]
    outs[str(dev)] = [g.cpu() for g in got]
  for a, b in zip(*outs.values()):
    assert torch.equal(a, b)
