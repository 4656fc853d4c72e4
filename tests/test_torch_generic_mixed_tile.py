"""Kernel 6's tile form (mode "mixed" without a camera-frame unit,
ops/entry_slab.py): the emitted text of the live spec's 4-kind variant
(gyro, accel, camera rotation, ECEF_POS), built with the host C++ compiler
as double (tests/torch_parity.run_host: the template's host loop runs, for
each filter and step, every role's predict, then the step's unit: its
shared values, every role's compute, every role's store), held at rtol
1e-9 against the JAX package's lane_bank.lane_mixed_bank_scan, B = 16,
T = 8, gate off and on (every fourth lane's measurements far off, so the
gate has work); and the same variant's tile against its global form on
the host. Skips the host builds, with the reason, where no C++ compiler
is on PATH."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import live as jlive
from rednose_tpu.ops import lane_bank as jlane
from rednose_tpu_torch.models import live
from rednose_tpu_torch.models.live import ObservationKind as K
from rednose_tpu_torch.ops import entry_slab, generic_scan, sparsity
from torch_parity import host_compiler, np_, run_host, t64

B, T = 16, 8
RTOL = 1e-9
KINDS = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)


@pytest.fixture(autouse=True)
def _needs_compiler():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted source")


def _gated(spec, gate):
  """The spec with every kind of the schedule gated or not (the live kinds
  are not gated by default; a mixed call gates a kind as its maha_test
  says)."""
  obs = dict(spec.obs)
  for k in KINDS:
    obs[int(k)] = dataclasses.replace(obs[int(k)], maha_test=gate)
  return dataclasses.replace(spec, obs=obs)


def _inputs(seed):
  """Lanes near the live x0 with a random well-conditioned P; each step's
  measurement is its kind's h at the lane's initial state plus noise
  (every fourth lane 1 km or 20 units off); R per kind."""
  rng = np.random.RandomState(seed)
  x = np.tile(jlive.LiveKalman.initial_x, (B, 1)) + 0.01 * rng.randn(B, 23)
  x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
  A = 0.1 * rng.randn(B, 22, 22)
  P = np.einsum("bij,bkj->ikb", A, A) + 0.01 * np.diag(
      jlive.LiveKalman.initial_P_diag)[:, :, None]
  spec = live.build_live_spec()
  kind_idx = (np.arange(T) % len(KINDS)).astype(np.int32)
  far = np.arange(B) % 4 == 0
  zs = np.zeros((T, B, 3))
  for t in range(T):
    k = KINDS[kind_idx[t]]
    h = torch.func.vmap(lambda xx, k=k: spec.obs[k].h({}, xx, None))(
        t64(x)).numpy()
    scale = 5.0 if k == K.ECEF_POS else 0.05
    off = 1e3 if k == K.ECEF_POS else 20.0
    zs[t] = h + np.where(far[:, None], off, scale) * rng.randn(B, 3)
  R_list = [live.LiveKalman.obs_noise[k] for k in KINDS]
  return x, P, np.full(T, 0.01), kind_idx, zs, R_list


def _close(ours, ref_x, ref_P):
  np.testing.assert_allclose(np_(ours[0]), ref_x, rtol=RTOL, atol=1e-8)
  np.testing.assert_allclose(np_(ours[1]), ref_P, rtol=RTOL, atol=1e-9)
  np.testing.assert_array_equal(np_(ours[1]),
                                np_(ours[1]).transpose(1, 0, 2))


@pytest.mark.parametrize("gate", [False, True])
def test_live_mixed_tile_matches_jax_lane(gate):
  """The unmodified live spec's 4-kind tile against the JAX lane path."""
  x, P, dts, kind_idx, zs, R_list = _inputs(40)
  jspec = _gated(jlive.LiveKalman.build_spec(), gate)
  tspec = _gated(live.LiveKalman.build_spec(), gate)
  st = sparsity.structure_for(tspec, live.LiveKalman.initial_x)
  src = generic_scan.KernelCall(tspec, "mixed", KINDS, Q=live.LiveKalman.Q,
                                R_list=R_list, structure=st).source(
                                    torch.float64)
  assert "// design: tile" in src and "REDNOSE_GENERIC_SCAN_TILE_KINDS" in src
  xr, Pr = jlane.lane_mixed_bank_scan(
      jspec, tuple(int(k) for k in KINDS), {}, jnp.asarray(x),
      jnp.asarray(P), jnp.asarray(jlive.LiveKalman.Q), jnp.asarray(dts),
      jnp.asarray(kind_idx), jnp.asarray(zs),
      tuple(jnp.asarray(r) for r in R_list))
  ours = run_host("mixed", tspec, KINDS, x.T, P, np.swapaxes(zs, 1, 2), dts,
                  Q=live.LiveKalman.Q, R_list=R_list, structure=st,
                  kind_idx=kind_idx)
  _close(ours, np.asarray(xr).T, np.asarray(Pr))
  if gate:   # the gate had work: the far lanes end elsewhere than ungated
    free = _gated(live.LiveKalman.build_spec(), False)
    xu, _ = run_host("mixed", free, KINDS, x.T, P, np.swapaxes(zs, 1, 2),
                     dts, Q=live.LiveKalman.Q, R_list=R_list, structure=st,
                     kind_idx=kind_idx)
    assert not np.allclose(np_(xu)[:, 0::4], np_(ours[0])[:, 0::4])


def test_live_mixed_tile_matches_its_global_form(monkeypatch):
  """The same variant printed as a tile and, with no shared memory to
  spare, in the global form (one function a phase, P stored as soon as
  computed): both built as double on the host agree to rounding, over a
  schedule that visits the kinds out of order."""
  x, P, dts, kind_idx, zs, R_list = _inputs(41)
  kind_idx = np.array([3, 1, 1, 0, 2, 3, 0, 2], np.int32)
  tspec = live.LiveKalman.build_spec()
  st = sparsity.structure_for(tspec, live.LiveKalman.initial_x)
  kw = dict(Q=live.LiveKalman.Q, R_list=R_list, structure=st,
            kind_idx=kind_idx)
  zsb = np.swapaxes(zs, 1, 2)
  tile = run_host("mixed", tspec, KINDS, x.T, P, zsb, dts, **kw)
  monkeypatch.setattr(entry_slab, "TILE_SMEM_MAX", 0)
  generic_scan._source.cache_clear()
  try:
    src = generic_scan.KernelCall(tspec, "mixed", KINDS, Q=live.LiveKalman.Q,
                                  R_list=R_list, structure=st).source(
                                      torch.float64)
    assert "// design: global" in src and "gen_tile_" not in src
    glob = run_host("mixed", tspec, KINDS, x.T, P, zsb, dts, **kw)
  finally:
    generic_scan._source.cache_clear()
  np.testing.assert_allclose(np_(tile[0]), np_(glob[0]), rtol=1e-12,
                             atol=1e-12)
  np.testing.assert_allclose(np_(tile[1]), np_(glob[1]), rtol=1e-12,
                             atol=1e-12)
