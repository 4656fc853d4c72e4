"""MSCKFBank(device="cpu") against the JAX MSCKFBank(use_pallas=False),
float64, B = 8: camera frames in bulk (run_frames) and one by one
(observe_frame, out of order), position fixes (run / observe), save /
load, and the surfaces a feature kind does not take (an epoch slot, a
single-kind observe or run), which raise. Camera frames in a mixed
schedule: tests/test_torch_vio_bank.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import msckf_eskf as jes
from rednose_tpu.models import msckf_vo as jvo
from rednose_tpu.runtime.msckf_bank import MSCKFBank as JBank
from rednose_tpu_torch import interop
from rednose_tpu_torch.models import msckf_eskf as tes
from rednose_tpu_torch.models import msckf_vo as tvo
from rednose_tpu_torch.ops import generic_scan
from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank
from torch_parity import np_

B = 8
KIND, POS = 16, 12


def _frames(jm, T, seed):
  """T frames of (z, ea) consistent with a bank around the model x0
  (tests/test_msckf_bank.py:_frame_data)."""
  spec = jm.build_spec()
  om = spec.obs[KIND]
  rng = np.random.RandomState(seed)
  xs = np.tile(jm.initial_x, (B, 1)) + 0.02 * rng.randn(B, spec.dim_x)
  for a in range(spec.n_augment):
    o = spec.dim_main + spec.dim_augment * a
    xs[:, o:o + 3] += 0.5 * rng.randn(3)[None]
  for idx in spec.quaternion_idxs:
    xs[:, idx:idx + 4] /= np.linalg.norm(xs[:, idx:idx + 4], axis=1,
                                         keepdims=True)
  eas = np.array([1.0, 0.5, 6.0]) + 0.1 * rng.randn(T, B, 3)
  zs = np.stack([np.stack([
      np.asarray(om.h({}, jnp.asarray(xs[i]), jnp.asarray(eas[t, i])))
      for i in range(B)]) for t in range(T)]) \
      + 0.005 * rng.randn(T, B, om.dz)
  zpos = xs[:, 0:3] + 0.1 * rng.randn(B, 3)
  return xs, eas, zs, zpos


def _same(ours, ref, rtol=1e-9):
  x, P = interop.lane_bank_from_jax(ref.x, ref._P, torch.float64)
  np.testing.assert_allclose(np_(ours._x), np_(x), rtol=rtol, atol=1e-12)
  np.testing.assert_allclose(np_(ours._P), np_(P), rtol=rtol, atol=1e-13)
  assert ours.t == pytest.approx(ref.t, abs=1e-12)


def _pair(jm, tm, xs, **kw):
  return (JBank(jm, batch=B, dtype=jnp.float64, x0=xs, use_pallas=False,
                **kw),
          MSCKFBank(tm, batch=B, dtype=torch.float64, x0=xs, device="cpu",
                    **kw))


@pytest.mark.parametrize("models", [
    (jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry),
    (jes.MSCKFEskf, tes.MSCKFEskf)], ids=["msckf_vo", "msckf_eskf"])
def test_frames_and_position_fixes_match_jax(models):
  """run_frames (T = 3), then a position fix through observe and a camera
  frame through observe_frame, then run of the position kind (T = 2)."""
  jm, tm = models
  xs, eas, zs, zpos = _frames(jm, 4, seed=0)
  jb, tb = _pair(jm, tm, xs)
  for b in (jb, tb):
    b.run_frames(np.full(3, 0.05), zs[:3], eas[:3])
  _same(tb, jb)
  for b in (jb, tb):
    b.observe(b.t + 0.1, POS, zpos)
    b.observe_frame(b.t + 0.05, zs[3], eas[3])
    b.run(np.full(2, 0.1), np.stack([zpos, zpos + 0.05]), POS,
          R=np.eye(3) * 0.5)
  _same(tb, jb)


def test_late_frame_and_save_load(tmp_path):
  """A late camera frame rewinds and replays (each replayed frame augments
  again), as the JAX bank does; a too-old one is dropped; save / load
  round-trips the bank."""
  jm, tm = jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry
  xs, eas, zs, zpos = _frames(jm, 4, seed=1)
  jb, tb = _pair(jm, tm, xs, ckpt_every=1)
  for b in (jb, tb):
    b.observe_frame(0.05, zs[0], eas[0])
    b.observe(0.10, POS, zpos)
    b.observe_frame(0.20, zs[2], eas[2])
    b.observe_frame(0.15, zs[1], eas[1])          # late: rewind + replay
  _same(tb, jb, rtol=1e-9)
  x_before = tb._x.clone()
  assert tb.observe_frame(-5.0, zs[0], eas[0]) is None
  assert torch.equal(tb._x, x_before)

  sorted_bank = MSCKFBank(tm, batch=B, dtype=torch.float64, x0=xs,
                          device="cpu")
  sorted_bank.observe_frame(0.05, zs[0], eas[0])
  sorted_bank.observe(0.10, POS, zpos)
  sorted_bank.observe_frame(0.15, zs[1], eas[1])
  sorted_bank.observe_frame(0.20, zs[2], eas[2])
  np.testing.assert_allclose(np_(tb._x), np_(sorted_bank._x), rtol=1e-12,
                             atol=1e-14)

  tb.save(tmp_path / "msckf_bank.npz")
  other = MSCKFBank(tm, batch=B, dtype=torch.float64, device="cpu")
  other.load(tmp_path / "msckf_bank.npz")
  assert torch.equal(other._x, tb._x) and torch.equal(other._P, tb._P)
  assert other.t == tb.t


def test_feature_kind_surfaces_raise():
  """A feature kind in an epoch slot, or through observe / run, raises and
  names what to use; a schedule without the feature kind runs (kernel 6),
  as do epochs of position fixes (kernel 5)."""
  tm = tes.MSCKFEskf
  xs, eas, zs, zpos = _frames(jes.MSCKFEskf, 2, seed=2)
  bank = MSCKFBank(tm, batch=B, dtype=torch.float64, x0=xs, device="cpu")
  with pytest.raises(ValueError, match="feature kind"):
    bank.run_epochs(np.full(1, 0.05), np.zeros((1, 1, B, 8)), (KIND,),
                    eas=np.zeros((1, 1, B, 3)))
  with pytest.raises(ValueError, match="observe_frame"):
    bank.observe(0.1, KIND, zs[0])
  with pytest.raises(ValueError, match="run_frames"):
    bank.run(np.full(1, 0.05), zs[:1], KIND)
  bank.run_mixed(np.full(2, 0.05), np.array([0, 0]),
                 np.stack([zpos, zpos]), (POS,))
  bank.run_epochs(np.full(1, 0.05), np.stack([zpos, zpos])[None], (POS, POS))
  assert int(bank.diverged().sum()) == 0
  assert generic_scan.vo_bank_scan.launches == 0   # CPU tensors: plain
