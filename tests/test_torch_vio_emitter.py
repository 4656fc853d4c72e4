"""Kernel 6's camera-frame branch (ops/entry_slab.py, mode "mixed" with a
feature unit), run on the host: the text nvcc builds, compiled with the
host C++ compiler as scalar_t = double and run over a small bank
(tests/torch_parity.py).

Held, float64, at rtol 1e-9: against the JAX package's
pallas_bank.generic_bank_scan_mixed in interpret mode at B = 8, T = 4 for
msckf_vo (camera frame / position fix / frame / fix; msckf_eskf in
tests/test_torch_vio_eskf_emitter.py, a file of its own so that the two
long builds run on two test workers); and against the JAX lane twin
(lane_bank.lane_mixed_bank_scan) for an anisotropic feature R and for a
schedule with two feature units of other R patterns. Also: a variant
without a feature unit emits no frame unit and no GEN_PHASE call, and
the emitter refuses misplaced R patterns. Skips, with the reason, where
no C++ compiler is on PATH."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import msckf_vo as jvo
from rednose_tpu.ops import lane_bank as jl
from rednose_tpu.ops import pallas_bank
from rednose_tpu.ops import sparsity as jsparsity
from rednose_tpu_torch import interop
from rednose_tpu_torch.models import msckf_vo as tvo
from rednose_tpu_torch.models.live import (
    LiveKalman,
    ObservationKind as LK,
    build_live_spec,
)
from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
from rednose_tpu_torch.ops import generic_scan, sparsity
from torch_parity import host_compiler, np_, run_host, vio_schedule

B, T = 8, 4
RTOL = 1e-9
KINDS = (12, 16)
DT = 0.05


@pytest.fixture(autouse=True)
def _needs_compiler():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted source")


def _bank(tm, seed):
  xs, zs, eas, kind_idx = vio_schedule(tm, T, B, seed)
  P = np.tile(np.diag(tm.initial_P_diag)[:, :, None], (1, 1, B))
  return xs, P, zs, eas, kind_idx


def _host(tm, kinds, R_list, xs, P, zs, eas, kind_idx):
  spec = tm.build_spec()
  return run_host(
      "mixed", spec, kinds, xs.T, P, np.swapaxes(zs, 1, 2), np.full(T, DT),
      Q=tm.Q, R_list=R_list,
      structure=sparsity.structure_for(spec, tm.initial_x),
      eas=np.swapaxes(eas, 1, 2), kind_idx=kind_idx)


def _jax_lane(jm, kinds, R_list, xs, P, zs, eas, kind_idx):
  jspec = jm.build_spec()
  fn = jl.jit_lane_mixed_bank_scan(
      jspec, kinds, jsparsity.structure_for(jspec, jm.initial_x))
  x, Pj = fn({}, jnp.asarray(xs), jnp.asarray(P), jnp.asarray(jm.Q),
             jnp.asarray(np.full(T, DT)), jnp.asarray(kind_idx),
             jnp.asarray(zs), tuple(jnp.asarray(R) for R in R_list),
             eas=jnp.asarray(eas))
  return interop.lane_bank_from_jax(x, Pj, torch.float64)


def _same(ours, ref):
  np.testing.assert_allclose(np_(ours[0]), np_(ref[0]), rtol=RTOL,
                             atol=1e-12)
  np.testing.assert_allclose(np_(ours[1]), np_(ref[1]), rtol=RTOL,
                             atol=1e-13)
  assert torch.equal(ours[1], ours[1].transpose(0, 1))


def check_mixed_against_jax_kernel(jm, tm):
  """Camera frame / position fix / frame / fix, each a predict and its
  update, a frame's with the window augment and the gate: the emitted
  body against the JAX mixed kernel itself (its camera-frame branch)."""
  xs, P, zs, eas, kind_idx = _bank(tm, seed=0)
  R_list = (np.eye(3), 0.01**2 * np.eye(8))
  jspec = jm.build_spec()
  xp, Pp = pallas_bank.pack_bank(jnp.asarray(xs), jnp.asarray(P))
  xo, Po = pallas_bank.generic_bank_scan_mixed(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      jnp.asarray(np.full(T, DT)), jnp.asarray(kind_idx),
      pallas_bank.pack_bank_measurements(jnp.asarray(eas)), spec=jspec,
      kinds=KINDS, q_diag=tuple(np.diag(jm.Q)),
      r_mats=tuple(tuple(tuple(r) for r in R) for R in R_list), gate=True,
      t_chunk=T, tile_b=B, interpret=True,
      structure=jsparsity.structure_for(jspec, jm.initial_x))
  _same(_host(tm, KINDS, R_list, xs, P, zs, eas, kind_idx),
        interop.bank_from_jax(xo, Po, torch.float64))


def test_mixed_body_with_frame_unit_matches_jax_kernel():
  check_mixed_against_jax_kernel(jvo.MSCKFVisualOdometry,
                                 tvo.MSCKFVisualOdometry)


def _anisotropic(dz, scale=1.0):
  R = np.diag(1e-4 * scale * (1.0 + 0.5 * np.arange(dz)))
  R[0, 3] = R[3, 0] = 2e-5 * scale
  return R


def test_anisotropic_feature_R_matches_jax_lane():
  """An anisotropic feature R takes the general Q^T R Q on its nonzero
  pattern inside the mixed switch."""
  jm, tm = jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry
  xs, P, zs, eas, kind_idx = _bank(tm, seed=1)
  R_list = (np.eye(3), _anisotropic(8))
  _same(_host(tm, KINDS, R_list, xs, P, zs, eas, kind_idx),
        _jax_lane(jm, KINDS, R_list, xs, P, zs, eas, kind_idx))


def test_two_feature_units_of_other_R_patterns():
  """Two units of the feature kind, one with R = s^2 I and one anisotropic:
  two frame functions, each reading its own R, against the JAX lane twin
  over frame (iso) / fix / frame (anisotropic) / fix."""
  jm, tm = jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry
  xs, P, zs, eas, kind_idx = _bank(tm, seed=2)
  kind_idx = np.array([1, 0, 2, 0], np.int32)
  kinds = (12, 16, 16)
  R_list = (np.eye(3), 0.01**2 * np.eye(8), _anisotropic(8))
  spec = tm.build_spec()
  src = generic_scan.KernelCall(spec, "mixed", kinds, Q=tm.Q,
                                R_list=R_list).source()
  assert "GEN_PHASE void gen_frame_k16_g_s0(" in src
  assert "GEN_PHASE void gen_frame_k16_g_r1_s0(" in src
  assert "R unit 1 iso; unit 2 [(0, 0), (0, 3)," in src
  _same(_host(tm, kinds, R_list, xs, P, zs, eas, kind_idx),
        _jax_lane(jm, kinds, R_list, xs, P, zs, eas, kind_idx))


def test_variants_without_a_feature_unit_have_no_frame_code():
  """Kernel 6 without a feature unit keeps every unit inline (no frame
  unit, no GEN_PHASE call); with one, only the frame unit's serial stages
  (the innovation, and S with its Cholesky factor and the gate) are
  GEN_PHASE in the tile form, and only the predict and the frame unit in
  the global form. A new R value of the same pattern is the same
  variant."""
  live = build_live_spec()
  kinds = (LK.PHONE_GYRO, LK.ECEF_POS)
  no_frame = [
      generic_scan.KernelCall(
          live, "mixed", kinds, Q=LiveKalman.Q,
          R_list=[LiveKalman.obs_noise[k] for k in kinds]).source()]
  for tm in (tvo.MSCKFVisualOdometry, MSCKFEskf):
    spec = tm.build_spec()
    no_frame.append(generic_scan.KernelCall(
        spec, "mixed", (12,), Q=tm.Q, R_list=(np.eye(3),)).source())
  for src in no_frame:
    assert "GEN_PHASE" not in src and "gen_frame" not in src
  tm = tvo.MSCKFVisualOdometry
  spec = tm.build_spec()
  calls = [generic_scan.KernelCall(spec, "mixed", KINDS, Q=tm.Q,
                                   R_list=(np.eye(3), R))
           for R in (1e-4 * np.eye(8), 4e-4 * np.eye(8), _anisotropic(8),
                     _anisotropic(8, 3.0))]
  src = [c.source() for c in calls]
  assert src[0] == src[1] != src[2] == src[3]
  phases = [line for line in src[0].splitlines() if "GEN_PHASE" in line]
  assert len(phases) == 2 and "gen_frame_k16_g_s0(" in phases[0] \
      and "gen_frame_k16_g_s4(" in phases[1]
  assert "GEN_INLINE void gen_update_k12_s0(" in src[0]
  glob = calls[0].source(tile=False)
  phases = [line for line in glob.splitlines() if "GEN_PHASE" in line]
  assert len(phases) == 2 and "gen_predict" in phases[0] \
      and "gen_frame_k16_g" in phases[1]
  assert "GEN_INLINE void gen_update_k12(" in glob


@pytest.mark.parametrize("case", ["frame_without_pattern",
                                  "pattern_on_a_plain_unit",
                                  "feature_unit_in_single",
                                  "plain_unit_in_frame"])
def test_emit_source_refuses_misplaced_R_patterns(case):
  """An R pattern goes with each feature unit and only with it; 'single'
  and 'epoch' take no feature unit, 'frame' nothing else."""
  from rednose_tpu_torch.ops import entry_slab

  tm = tvo.MSCKFVisualOdometry
  spec = tm.build_spec()
  st = sparsity.structure_for(spec, tm.initial_x)
  mode, units, rps = {
      "frame_without_pattern": ("mixed", ((12, False), (16, True)), None),
      "pattern_on_a_plain_unit": ("mixed", ((12, False), (16, True)),
                                  ("iso", "iso")),
      "feature_unit_in_single": ("single", ((16, True),), ("iso",)),
      "plain_unit_in_frame": ("frame", ((12, False),), None),
  }[case]
  with pytest.raises(ValueError):
    entry_slab.emit_source(spec, mode, units, st, (), (), (), "float", rps)
