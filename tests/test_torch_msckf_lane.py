"""The MSCKF part of the port's lane banks (ops/lane_bank.py, the plain
version of kernel 7) against the JAX package's lane_bank, float64: the
block predict, the lane Cholesky and its solve, the Householder
reflectors and their application, the feature-kind lane_update (gate on
and off, anisotropic R), augment_slab and the camera-frame scan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import msckf_eskf as jes
from rednose_tpu.models import msckf_vo as jvo
from rednose_tpu.ops import lane_bank as jl
from rednose_tpu_torch.models import msckf_eskf as tes
from rednose_tpu_torch.models import msckf_vo as tvo
from rednose_tpu_torch.ops import lane_bank as tl
from torch_parity import np_, t64

B = 8
RTOL = 1e-10
MODELS = [(jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry),
          (jes.MSCKFEskf, tes.MSCKFEskf)]
IDS = ["msckf_vo", "msckf_eskf"]


def _bank(jm, rng, T=1):
  """(spec, x (B, dim_x), P (de, de, B), eas (T, B, 3), zs (T, B, dz)):
  states around x0 with a spread clone window, full-rank covariances, and
  feature observations consistent with them."""
  spec = jm.build_spec()
  om = spec.obs[16]
  xs = np.tile(jm.initial_x, (B, 1)) + 0.02 * rng.randn(B, spec.dim_x)
  for a in range(spec.n_augment):
    o = spec.dim_main + spec.dim_augment * a
    xs[:, o:o + 3] += 0.5 * rng.randn(B, 3)
  for idx in spec.quaternion_idxs:
    xs[:, idx:idx + 4] /= np.linalg.norm(xs[:, idx:idx + 4], axis=1,
                                         keepdims=True)
  A = 0.1 * rng.randn(B, spec.dim_err, spec.dim_err)
  P = np.einsum("bij,bkj->ikb", A, A) \
      + np.diag(jm.initial_P_diag)[:, :, None]
  eas = np.array([1.0, 0.5, 6.0]) + 0.1 * rng.randn(T, B, 3)
  zs = np.stack([np.stack([
      np.asarray(om.h({}, jnp.asarray(xs[i]), jnp.asarray(eas[t, i])))
      for i in range(B)]) for t in range(T)]) + 0.005 * rng.randn(T, B, om.dz)
  return spec, xs, P, eas, zs


def _close(ours, ref, rtol=RTOL, atol=1e-12):
  np.testing.assert_allclose(np_(ours), np.asarray(ref), rtol=rtol, atol=atol)


@pytest.mark.parametrize("models", MODELS, ids=IDS)
def test_block_predict_matches_jax(models):
  jm, tm = models
  _, xs, P, _, _ = _bank(jm, np.random.RandomState(0))
  jx, jP = jl.lane_predict(jm.build_spec(), {}, jnp.asarray(xs),
                           jnp.asarray(P), jnp.asarray(jm.Q), 0.05)
  tx, tP = tl.lane_predict(tm.build_spec(), {}, t64(xs), t64(P), t64(tm.Q),
                           t64(0.05))
  _close(tx, jx)
  _close(tP, jP)
  m = tm.build_spec().dim_main_err
  np.testing.assert_array_equal(np_(tP)[m:, m:],
                                P[m:, m:] + 0.05 * tm.Q[m:, m:, None])


def test_cholesky_and_solve_match_jax():
  rng = np.random.RandomState(1)
  A = rng.randn(B, 5, 5)
  S = np.einsum("bij,bkj->ikb", A, A) + 0.5 * np.eye(5)[:, :, None]
  rhs = rng.randn(5, 7, B)
  jc = jl.cholesky_lane(jnp.asarray(S))
  tc = tl.cholesky_lane(t64(S))
  for a, b in zip(tc, jc):
    _close(a, b)
  _close(tl.cho_solve_lane(tc, t64(rhs)),
         jl.cho_solve_lane(jc, jnp.asarray(rhs)))
  np.testing.assert_allclose(
      np.einsum("ijb,jmb->imb", S, np_(tl.cho_solve_lane(tc, t64(rhs)))),
      rhs, rtol=1e-9, atol=1e-10)


def test_householder_matches_jax():
  """The reflectors of He and their application; a zero column of He
  reflects by the identity (beta = 0) on both."""
  rng = np.random.RandomState(2)
  He = rng.randn(8, 3, B)
  He[:, 2, 0] = 0.0
  M = rng.randn(8, 6, B)
  jr, tr = jl._householder_qt(jnp.asarray(He)), tl._householder_qt(t64(He))
  for (jj, jv, jb, _), (tj, tv, tb, _) in zip(jr, tr):
    assert jj == tj
    _close(tv, jv)
    _close(tb, jb)
  assert float(tr[2][2][0]) == 0.0
  _close(tl._apply_qt(tr, t64(M)), jl._apply_qt(jr, jnp.asarray(M)))
  # Q^T He is upper triangular on the columns of full rank
  QtHe = np_(tl._apply_qt(tr, t64(He)))
  np.testing.assert_allclose(QtHe[3:, :, 1:], 0.0, atol=1e-12)


@pytest.mark.parametrize("gate", [True, False], ids=["gate_on", "gate_off"])
@pytest.mark.parametrize("models", MODELS, ids=IDS)
def test_feature_update_matches_jax(models, gate):
  """lane_update of the feature kind, anisotropic R; with the gate on,
  a third of the lanes see an outlier frame and take zero gain. The JAX
  lane update gates as the kind says (maha_test=True): gate off compares
  against a copy of its spec with maha_test off."""
  import dataclasses

  jm, tm = models
  rng = np.random.RandomState(3)
  jspec, xs, P, eas, zs = _bank(jm, rng)
  z = zs[0].copy()
  z[::3] += 5.0 * rng.randn(*z[::3].shape)
  om = jspec.obs[16]
  R = np.diag(0.01**2 + 1e-5 * np.arange(om.dz))
  R[0, 1] = R[1, 0] = 2e-6
  if not gate:
    jspec = dataclasses.replace(jspec, obs={
        **jspec.obs, 16: dataclasses.replace(om, maha_test=False)})
  jx, jP, jy = jl.lane_update(jspec, 16, {}, jnp.asarray(xs), jnp.asarray(P),
                              jnp.asarray(z), jnp.asarray(R),
                              ea=jnp.asarray(eas[0]))
  tx, tP, ty = tl.lane_update(tm.build_spec(), 16, {}, t64(xs), t64(P),
                              t64(z), t64(R), ea=t64(eas[0]), gate=gate)
  _close(tx, jx)
  _close(tP, jP)
  _close(ty, jy)
  unchanged = np.all(np_(tP) == P, axis=(0, 1))
  assert unchanged[::3].all() == gate and not unchanged[1::3].any()


@pytest.mark.parametrize("models", MODELS, ids=IDS)
def test_augment_slab_matches_jax(models):
  jm, tm = models
  _, xs, P, _, _ = _bank(jm, np.random.RandomState(4))
  jx, jP = jl.lane_augment(jm.build_spec(), jnp.asarray(xs), jnp.asarray(P))
  tx, tP = tl.lane_augment(tm.build_spec(), t64(xs), t64(P))
  np.testing.assert_array_equal(np_(tx), np.asarray(jx))
  np.testing.assert_array_equal(np_(tP), np.asarray(jP))


@pytest.mark.parametrize("models", MODELS, ids=IDS)
def test_frame_scan_matches_jax(models):
  """lane_frame_bank_scan (T frames of predict + feature update + augment)
  against the JAX lane frame steps."""
  jm, tm = models
  T = 3
  jspec, xs, P, eas, zs = _bank(jm, np.random.RandomState(5), T)
  R = jm.obs_noise[16]
  jx, jP = jnp.asarray(xs), jnp.asarray(P)
  for t in range(T):
    jx, jP = jl.lane_predict(jspec, {}, jx, jP, jnp.asarray(jm.Q), 0.05)
    jx, jP, _ = jl.lane_update(jspec, 16, {}, jx, jP, jnp.asarray(zs[t]),
                               jnp.asarray(R), ea=jnp.asarray(eas[t]))
    jx, jP = jl.lane_augment(jspec, jx, jP)
  tx, tP = tl.lane_frame_bank_scan(
      tm.build_spec(), 16, {}, t64(xs), t64(P), t64(tm.Q),
      t64(np.full(T, 0.05)), t64(zs), t64(eas), t64(R))
  _close(tx, jx)
  _close(tP, jP)
  with pytest.raises(ValueError, match="not an MSCKF feature kind"):
    tl.lane_frame_bank_scan(tm.build_spec(), 12, {}, t64(xs), t64(P),
                            t64(tm.Q), t64(np.full(T, 0.05)), t64(zs),
                            t64(eas), t64(R))
