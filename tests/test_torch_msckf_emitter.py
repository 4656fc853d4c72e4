"""Kernel 7's emitted body (ops/entry_slab.py, mode "frame"), run on the
host: the text nvcc builds, compiled with the host C++ compiler as
scalar_t = double and run over a small bank (tests/torch_parity.py).

Held, float64, against the JAX package's pallas_bank.vo_bank_scan in
interpret mode, flat form, at B = 8, T = 8 for msckf_vo and msckf_eskf
(rtol 1e-9); against the JAX slab functions for an anisotropic R (the
general Q^T R Q projection); and, with a distinct value in every P entry,
for the load-before-store rule of the augmented covariance store, whose
new value at nearly every location reads another location's old one.
Also kernel 4's body on an MSCKF spec (the block predict) against the JAX
lane scan. Skips, with the reason, where no C++ compiler is on PATH."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import msckf_eskf as jes
from rednose_tpu.models import msckf_vo as jvo
from rednose_tpu.ops import entry_slab as jentry
from rednose_tpu.ops import lane_bank as jl
from rednose_tpu.ops import pallas_bank
from rednose_tpu.ops import sparsity as jsparsity
from rednose_tpu_torch import interop
from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel
from rednose_tpu_torch.models import msckf_eskf as tes
from rednose_tpu_torch.models import msckf_vo as tvo
from rednose_tpu_torch.ops import entry_slab, generic_scan, sparsity
from torch_parity import host_compiler, np_, run_host, t64

B, T = 8, 8
RTOL = 1e-9
KIND = 16


@pytest.fixture(autouse=True)
def _needs_compiler():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted source")


def _bank(jm, rng, T_=T, P_diag=None):
  """States around x0 with a spread clone window, (T, B, dz) feature
  observations consistent with them (every third lane of frame 3 an
  outlier the gate rejects) and (T, B, 3) landmarks."""
  spec = jm.build_spec()
  om = spec.obs[KIND]
  xs = np.tile(jm.initial_x, (B, 1)) + 0.02 * rng.randn(B, spec.dim_x)
  for a in range(spec.n_augment):
    o = spec.dim_main + spec.dim_augment * a
    xs[:, o:o + 3] += 0.5 * rng.randn(3)[None]
  for idx in spec.quaternion_idxs:
    xs[:, idx:idx + 4] /= np.linalg.norm(xs[:, idx:idx + 4], axis=1,
                                         keepdims=True)
  eas = np.array([1.0, 0.5, 6.0]) + 0.1 * rng.randn(T_, B, 3)
  zs = np.stack([np.stack([
      np.asarray(om.h({}, jnp.asarray(xs[i]), jnp.asarray(eas[t, i])))
      for i in range(B)]) for t in range(T_)]) \
      + 0.005 * rng.randn(T_, B, om.dz)
  if T_ > 3:
    zs[3, ::3] += 5.0 * rng.randn(*zs[3, ::3].shape)
  P_diag = jm.initial_P_diag if P_diag is None else P_diag
  P = np.tile(np.diag(P_diag)[:, :, None], (1, 1, B))
  return spec, xs, P, eas, zs


def _host(tm, xs, P, zs, eas, dts, R, Q=None, gate=None):
  spec = tm.build_spec()
  return run_host(
      "frame", spec, (KIND,), xs.T, P, np.swapaxes(zs, 1, 2), dts,
      Q=tm.Q if Q is None else Q, R_list=(R,), gate=gate,
      structure=sparsity.structure_for(spec, tm.initial_x),
      eas=np.swapaxes(eas, 1, 2))


@pytest.mark.parametrize("models", [
    (jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry),
    (jes.MSCKFEskf, tes.MSCKFEskf)], ids=["msckf_vo", "msckf_eskf"])
def test_frame_body_matches_jax_vo_kernel(models):
  """T frames of block predict + projected feature update (gate on) +
  window augment: the emitted body against the JAX kernel itself."""
  jm, tm = models
  jspec, xs, P, eas, zs = _bank(jm, np.random.RandomState(0))
  R = np.eye(jspec.obs[KIND].dz) * 0.01**2
  dts = np.full(T, 0.05)
  xp, Pp = pallas_bank.pack_bank(jnp.asarray(xs), jnp.asarray(P))
  xo, Po = pallas_bank.vo_bank_scan(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      pallas_bank.pack_bank_measurements(jnp.asarray(eas)),
      jnp.asarray(dts), spec=jspec, kind=KIND,
      q_diag=tuple(np.diag(jm.Q)), r_mat=tuple(tuple(r) for r in R),
      gate=True, t_chunk=4, tile_b=8, interpret=True,
      structure=jsparsity.structure_for(jspec, jm.initial_x),
      phase_mode="flat")
  xr, Pr = interop.bank_from_jax(xo, Po, torch.float64)
  x, Pn = _host(tm, xs, P, zs, eas, dts, R)
  np.testing.assert_allclose(np_(x), np_(xr), rtol=RTOL, atol=1e-12)
  np.testing.assert_allclose(np_(Pn), np_(Pr), rtol=RTOL, atol=1e-13)
  assert torch.equal(Pn, Pn.transpose(0, 1))


def test_anisotropic_R_matches_jax_slab():
  """An anisotropic R takes the general Q^T R Q on its nonzero pattern
  (JAX entry_slab.py:488-496; tests/test_entry_slab.py:294): one frame
  against JAX entry_predict_slab + entry_feature_update_slab +
  augment_slab."""
  jm, tm = jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry
  jspec, xs, P, eas, zs = _bank(jm, np.random.RandomState(1), T_=1)
  dz = jspec.obs[KIND].dz
  R = np.diag(0.01 + 0.005 * np.arange(dz))
  R[0, 3] = R[3, 0] = 0.002
  st = jsparsity.structure_for(jspec, jm.initial_x)
  x, Pj = jentry.entry_predict_slab(
      jspec, {}, jnp.asarray(xs.T), jnp.asarray(P), tuple(np.diag(jm.Q)),
      jnp.asarray(0.05), st)
  x, Pj, _ = jentry.entry_feature_update_slab(
      jspec, KIND, {}, x, Pj, jnp.asarray(zs[0].T),
      tuple(tuple(r) for r in R), True, jnp.asarray(eas[0].T), structure=st)
  x, Pj = jl.augment_slab(jspec, x, Pj)
  call = generic_scan.KernelCall(tm.build_spec(), "frame", (KIND,), Q=tm.Q,
                                 R_list=(R,))
  assert "R [(0, 0), (0, 3)," in call.source(torch.float64)
  ours = _host(tm, xs, P, zs, eas, np.full(1, 0.05), R)
  np.testing.assert_allclose(np_(ours[0]), np.asarray(x), rtol=RTOL,
                             atol=1e-12)
  np.testing.assert_allclose(np_(ours[1]), np.asarray(Pj), rtol=RTOL,
                             atol=1e-13)


def _distinct_P(de, rng):
  """An SPD P (de, de, B) whose upper-triangle entries are all distinct."""
  A = rng.randn(B, de, de)
  P = np.einsum("bij,bkj->ikb", A, A) / de + np.eye(de)[:, :, None]
  iu = np.triu_indices(de)
  assert len(np.unique(P[iu[0], iu[1], 0])) == len(iu[0])
  return P


def test_augmented_store_loads_before_it_stores():
  """With a distinct value in every P entry: (a) a rejected frame at
  dt = 0 and Q = 0 leaves exactly the window roll of P, entry for entry;
  (b) an accepted frame equals the plain version at rtol 1e-10."""
  tm = tvo.MSCKFVisualOdometry
  spec = tm.build_spec()
  rng = np.random.RandomState(2)
  _, xs, _, eas, zs = _bank(jvo.MSCKFVisualOdometry, rng, T_=1)
  P = _distinct_P(spec.dim_err, rng)
  R = tm.obs_noise[KIND]
  x, Pn = _host(tm, xs, P, zs + 5.0 * rng.randn(*zs.shape), eas,
                np.zeros(1), R, Q=np.zeros_like(tm.Q))
  d2, d4, de = spec.dim_main_err, spec.dim_augment_err, spec.dim_err
  old = [i if i < d2 else i + d4 if i < de - d4 else i - (de - d4)
         for i in range(de)]
  np.testing.assert_array_equal(np_(Pn), P[np.ix_(old, old)])
  np.testing.assert_array_equal(np_(x)[:spec.dim_main], xs.T[:spec.dim_main])

  x, Pn = _host(tm, xs, P, zs, eas, np.full(1, 0.05), R)
  xr, Pr = generic_scan.vo_bank_scan(
      t64(xs.T), t64(P), t64(np.swapaxes(zs, 1, 2)),
      t64(np.swapaxes(eas, 1, 2)), t64([0.05]), spec=spec, kind=KIND,
      Q=tm.Q, R=R)
  np.testing.assert_allclose(np_(x), np_(xr), rtol=1e-10, atol=1e-13)
  np.testing.assert_allclose(np_(Pn), np_(Pr), rtol=1e-10, atol=1e-13)


def test_frame_calls_and_variants():
  """A feature kind runs in mode 'frame' or in a mixed schedule, never as
  a single-kind or epoch update, and mode 'frame' takes only a feature
  kind. R's isotropy is part of the variant, its value is not."""
  spec = tvo.MSCKFVisualOdometry.build_spec()
  Q = tvo.MSCKFVisualOdometry.Q
  R = tvo.MSCKFVisualOdometry.obs_noise[KIND]
  for mode in ("single", "epoch"):
    with pytest.raises(ValueError, match="run_mixed"):
      generic_scan.KernelCall(spec, mode, (KIND,), Q=Q, R_list=(R,))
  mixed = generic_scan.KernelCall(spec, "mixed", (12, KIND), Q=Q,
                                  R_list=(np.eye(3), R))
  assert "GEN_PHASE void gen_frame_k16_g_s0(" in mixed.source()
  assert "GEN_PHASE void gen_frame_k16_g(" in mixed.source(tile=False)
  with pytest.raises(ValueError, match="mode 'frame' takes an MSCKF"):
    generic_scan.KernelCall(spec, "frame", (12,), Q=Q, R_list=(np.eye(3),))
  with pytest.raises(ValueError, match="takes one kind"):
    generic_scan.KernelCall(spec, "frame", (KIND, KIND), Q=Q, R_list=(R, R))
  assert generic_scan.r_pattern_of(R) == "iso"
  assert generic_scan.r_pattern_of(np.diag([1.0, 2.0])) == ((0, 0), (1, 1))
  src = [generic_scan.KernelCall(spec, "frame", (KIND,), Q=Q,
                                 R_list=(r,)).source()
         for r in (R, 4.0 * R, R + np.diag(np.arange(8.0)))]
  assert src[0] == src[1] != src[2]
  assert "gen_frame_k16_g_r0(" in src[0]
  gated_off = generic_scan.KernelCall(spec, "frame", (KIND,), Q=Q,
                                      R_list=(R,), gate=False)
  assert "gen_frame_k16_r0(" in gated_off.source()
  assert "gen_frame_k16(" in gated_off.source(tile=False)


def test_msckf_structure_keeps_G_in_the_main_block():
  """dense_structure confines G to the main block of an MSCKF spec, the
  predict refuses a structure that leaves it, and detection refuses a
  spec whose clone states move."""
  spec = tvo.MSCKFVisualOdometry.build_spec()
  assert sparsity.dense_structure(spec).g_cols == tuple(range(6))
  st = sparsity.structure_for(spec, tvo.MSCKFVisualOdometry.initial_x)
  assert st.g_cols == (3, 4, 5) and st.cols_for(KIND) == tuple(range(6, 18))
  bad = sparsity.SpecStructure(f_rows=st.f_rows, h_cols=st.h_cols,
                               g_cols=(3, 4, 5, 7))
  with pytest.raises(ValueError, match="leave the main block"):
    entry_slab.predict_phase(spec, bad, (), ())

  def f(params, x, dt):
    del params
    return torch.cat([x[0:1] + dt * x[1:2], x[1:2], x[2:3] + dt * x[0:1]])

  moving = FilterSpec(
      name="moving_clone", dim_x=3, dim_err=3, f=f,
      obs={1: ObservationModel(kind=1, h=lambda p, x, ea: x[0:1], dz=1)},
      dim_main=2, dim_main_err=2, dim_augment=1, dim_augment_err=1,
      n_augment=1)
  with pytest.raises(sparsity.StructureError, match="outside the main"):
    sparsity.detect_structure(moving, np.ones(3))


def test_position_body_on_the_msckf_spec_matches_jax_lane():
  """Kernel 4's body on an MSCKF spec (MSCKFBank.observe / run of the
  position kind): the block predict keeps the clone block static and the
  update leaves the window untouched; against the JAX lane scan."""
  jm, tm = jes.MSCKFEskf, tes.MSCKFEskf
  jspec, xs, _, _, _ = _bank(jm, np.random.RandomState(3), T_=1)
  rng = np.random.RandomState(4)
  A = 0.1 * rng.randn(B, jspec.dim_err, jspec.dim_err)
  P = np.einsum("bij,bkj->ikb", A, A) + np.eye(jspec.dim_err)[:, :, None]
  T_ = 2
  zs = xs[None, :, 0:3] + rng.randn(T_, B, 3)
  dts = np.full(T_, 0.05)
  R = jm.obs_noise[12]
  xr, Pr = jl.jit_lane_bank_scan(
      jspec, 12, jsparsity.structure_for(jspec, jm.initial_x))(
          {}, jnp.asarray(xs), jnp.asarray(P), jnp.asarray(jm.Q),
          jnp.asarray(dts), jnp.asarray(zs), jnp.asarray(R))
  spec = tm.build_spec()
  x, Pn = run_host("single", spec, (12,), xs.T, P, np.swapaxes(zs, 1, 2),
                   dts, Q=tm.Q, R_list=(R,),
                   structure=sparsity.structure_for(spec, tm.initial_x))
  np.testing.assert_allclose(np_(x), np.asarray(xr).T, rtol=RTOL, atol=1e-12)
  np.testing.assert_allclose(np_(Pn), np.asarray(Pr), rtol=RTOL, atol=1e-13)
