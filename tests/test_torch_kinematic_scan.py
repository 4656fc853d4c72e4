"""Port parity for kernel 1 (ops/kinematic_scan.py): its plain version
against the JAX Pallas kernel in interpret mode and the bank oracle, the
interop round trip, and (on a card) the CUDA kernel against the plain
version."""

import dataclasses

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax.numpy as jnp
  from rednose_tpu.models.kinematic import KinematicKalman as JKin
  from rednose_tpu.models.kinematic import build_kinematic_spec as j_kin_spec
  from rednose_tpu.ops import pallas_step
  from rednose_tpu.runtime import bank as jbank
except ImportError:
  jnp = JKin = j_kin_spec = pallas_step = jbank = None
from rednose_tpu_torch import interop
from rednose_tpu_torch.models.kinematic import KinematicKalman
from rednose_tpu_torch.models.kinematic import ObservationKind as KK
from rednose_tpu_torch.models.kinematic import build_kinematic_spec
from rednose_tpu_torch.ops import kinematic_scan
from rednose_tpu_torch.runtime import bank as tbank
from rednose_tpu_torch.utils.compare import kinematic_sigma_err
from torch_parity import cuda_device, np_, t64  # noqa: F401

Q = KinematicKalman.Q
QV = np.array([Q[0, 0], Q[0, 1], Q[1, 1]])


def _sim(T, B, seed, spread=0.5, r=0.1**2):
  rng = np.random.default_rng(seed)
  return (np.full((T,), 0.01), rng.normal(0.0, spread, size=(T, B)),
          np.full((T,), r))


def _x0P0(B):
  return (np.tile(KinematicKalman.initial_x, (B, 1)),
          np.tile(np.diag(KinematicKalman.initial_P_diag), (B, 1, 1)))


@pytest.mark.parametrize("maha", [False, True])
def test_plain_matches_pallas_interpret(maha):
  """T = 64, B = 256; rtol 1e-10 gate off and 1e-8 gate on, the tolerances
  tests/test_bank_pallas.py holds the Pallas kernel to."""
  T, B = 64, 256
  dts, zs, rs = _sim(T, B, 3) if not maha else _sim(T, B, 9, 3.0, 0.05**2)
  x0, P0 = _x0P0(B)
  out_j = pallas_step.kinematic_bank_scan(
      pallas_step.pack_state(jnp.asarray(x0), jnp.asarray(P0)),
      jnp.asarray(zs), jnp.asarray(dts), jnp.asarray(rs),
      q00=float(Q[0, 0]), q11=float(Q[1, 1]), maha=maha, t_chunk=8,
      tile_b=128, interpret=True)
  state = kinematic_scan.pack_state(t64(x0), t64(P0))
  out_t = kinematic_scan.kinematic_bank_scan(state, t64(zs), t64(dts),
                                             t64(rs), t64(QV), maha=maha)
  rtol = 1e-8 if maha else 1e-10
  ref = interop.kinematic_state_from_jax(out_j, dtype=torch.float64)
  np.testing.assert_allclose(np_(out_t), np_(ref), rtol=rtol, atol=1e-12)
  assert not np.shares_memory(np_(state), np_(out_t))


def test_plain_matches_bank_oracle():
  """The plain scan (gate on) against the vmapped step oracle of the port,
  which is itself held to the JAX bank oracle."""
  T, B = 24, 6
  dts, zs, rs = _sim(T, B, 5, 3.0, 0.05**2)
  spec = build_kinematic_spec()
  spec = dataclasses.replace(spec, obs={KK.POSITION: dataclasses.replace(
      spec.obs[KK.POSITION], maha_test=True,
      maha_thresh=kinematic_scan.MAHA_THRESH_1D)})
  x0, P0 = _x0P0(B)
  st = tbank.init_bank(spec, KinematicKalman.initial_x,
                       np.diag(KinematicKalman.initial_P_diag), B,
                       dtype=torch.float64, device="cpu")
  Rs = t64(rs)[:, None, None, None].expand(T, B, 1, 1)
  final, ys = tbank.run_bank(spec, KK.POSITION, {}, st, t64(Q), t64(dts),
                             t64(zs)[..., None], Rs)
  assert ys.shape == (T, B, 1)
  out = kinematic_scan.kinematic_bank_scan(
      kinematic_scan.pack_state(t64(x0), t64(P0)), t64(zs), t64(dts),
      t64(rs), t64(QV), maha=True)
  x, P = kinematic_scan.unpack_state(out)
  np.testing.assert_allclose(np_(x), np_(final.x), rtol=1e-8, atol=1e-10)
  np.testing.assert_allclose(np_(P), np_(final.P), rtol=1e-8, atol=1e-10)

  j_spec = j_kin_spec()
  j_spec = dataclasses.replace(j_spec, obs={KK.POSITION: dataclasses.replace(
      j_spec.obs[KK.POSITION], maha_test=True,
      maha_thresh=kinematic_scan.MAHA_THRESH_1D)})
  j_st = jbank.init_bank(j_spec, JKin.initial_x,
                         np.diag(JKin.initial_P_diag), B, dtype=jnp.float64)
  j_final, _ = jbank.run_bank(
      j_spec, KK.POSITION, {}, j_st, jnp.asarray(Q), jnp.asarray(dts),
      jnp.asarray(zs)[..., None],
      jnp.broadcast_to(jnp.asarray(rs)[:, None, None, None], (T, B, 1, 1)))
  np.testing.assert_allclose(np_(final.x), np.asarray(j_final.x), rtol=1e-10)
  np.testing.assert_allclose(np_(final.P), np.asarray(j_final.P), rtol=1e-10)


def test_interop_roundtrip():
  rng = np.random.default_rng(0)
  x = rng.normal(size=(32, 2))
  off = rng.normal(size=32)
  P = np.stack([np.array([[2.0, o], [o, 3.0]]) for o in off])
  packed = np.asarray(pallas_step.pack_state(jnp.asarray(x), jnp.asarray(P)))
  state = interop.kinematic_state_from_jax(packed, dtype=torch.float64)
  np.testing.assert_array_equal(
      np_(state), np_(kinematic_scan.pack_state(t64(x), t64(P))))
  np.testing.assert_array_equal(interop.kinematic_state_to_jax(state), packed)
  x2, P2 = kinematic_scan.unpack_state(state)
  np.testing.assert_array_equal(np_(x2), x)
  np.testing.assert_array_equal(np_(P2), P)


@pytest.mark.cuda
def test_kernel_matches_plain(cuda_device):
  """The CUDA kernel against its plain version on the card, f32, in
  standard deviations of the plain result (utils/compare.py)."""
  for maha, T, B in ((False, 37, 1000), (True, 256, 4096)):
    dts, zs, rs = _sim(T, B, 11, 3.0 if maha else 0.5)
    x0, P0 = _x0P0(B)
    dev = dict(dtype=torch.float32, device=cuda_device)
    state = kinematic_scan.pack_state(torch.as_tensor(x0, **dev),
                                      torch.as_tensor(P0, **dev))
    args = (state, torch.as_tensor(zs, **dev), torch.as_tensor(dts, **dev),
            torch.as_tensor(rs, **dev), torch.as_tensor(QV, **dev))
    n = kinematic_scan.kinematic_bank_scan.launches
    out = kinematic_scan.kinematic_bank_scan(*args, maha=maha)
    assert kinematic_scan.kinematic_bank_scan.launches == n + 1
    ref = kinematic_scan.kinematic_scan_reference(*args, maha=maha)
    assert max(kinematic_sigma_err(out, ref)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("maha", [False, True])
def test_kernel_ragged_shapes_match_plain(cuda_device, maha):
  """The kernel against its plain version where the ring's chunks and the
  blocks are ragged: T of 1, a chunk less one, a chunk and one, three
  chunks and five; B of 1, 33, a block and 7 (B not a multiple of 4: the
  copies go a value a thread) and two blocks and 4 (whole blocks copied
  16 B a thread, the last block a value a thread)."""
  shape = kinematic_scan.launch_shape()
  C, L = shape["chunk_steps"], shape["threads"]
  dev = dict(dtype=torch.float32, device=cuda_device)
  for T in (1, C - 1, C + 1, 3 * C + 5):
    for B in (1, 33, L + 7, 2 * L + 4):
      dts, zs, rs = _sim(T, B, 12, 3.0 if maha else 0.5)
      x0, P0 = _x0P0(B)
      state = kinematic_scan.pack_state(torch.as_tensor(x0, **dev),
                                        torch.as_tensor(P0, **dev))
      args = (state, torch.as_tensor(zs, **dev), torch.as_tensor(dts, **dev),
              torch.as_tensor(rs, **dev), torch.as_tensor(QV, **dev))
      out = kinematic_scan.kinematic_bank_scan(*args, maha=maha)
      ref = kinematic_scan.kinematic_scan_reference(*args, maha=maha)
      assert max(kinematic_sigma_err(out, ref)) < 1e-3, (T, B)


def test_wrapper_refuses_non_cpu_non_cuda():
  """No silent fallback: a tensor on neither the CPU nor a CUDA card is
  refused instead of run through the plain version."""
  meta = torch.empty((5, 8), device="meta")
  with pytest.raises(ValueError, match="CUDA"):
    kinematic_scan.kinematic_bank_scan(
        meta, torch.empty((4, 8), device="meta"),
        torch.empty(4, device="meta"), torch.empty(4, device="meta"),
        torch.empty(3, device="meta"))
