"""Port parity for kernels 2 and 3 (ops/live_scan.py) and their plain
versions (ops/live_lane.py): every kind's slab update and the slab predict
against JAX live_lane (float64), the plain scan against the JAX Pallas
kernel in interpret mode (float32), the plain mixed scan against JAX
live_mixed_scan with streamed kinds (float64), the interop round trip, and
(on a card) the CUDA kernels against the plain versions."""

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax.numpy as jnp
  from rednose_tpu.ops import live_lane as jll
  from rednose_tpu.ops import pallas_live
except ImportError:
  jnp = jll = pallas_live = None
from rednose_tpu_torch import interop
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.ops import live_lane, live_scan
from rednose_tpu_torch.utils.compare import live_sigma_err
from torch_parity import cuda_device, np_, t32, t64  # noqa: F401

ALL_KINDS = sorted(live_lane.LANE_KINDS)
MIXED_KINDS = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION,
               K.ECEF_POS, K.CAMERA_ODO_TRANSLATION, K.ODOMETRIC_SPEED)


def _random_states(rng, B):
  x = rng.randn(B, 23)
  x[:, 0:3] = LiveKalman.initial_x[0:3] + 10.0 * rng.randn(B, 3)
  x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
  A = 0.1 * rng.randn(B, 22, 22)
  return x.T.copy(), (A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(22)).transpose(
      1, 2, 0).copy()


def test_predict_slab_matches_jax():
  rng = np.random.RandomState(1)
  x, P = _random_states(rng, 16)
  xj, Pj = jll.live_predict_slab(jnp.asarray(x), jnp.asarray(P),
                                 jnp.asarray(LiveKalman.Q), 0.013)
  for Q in (t64(LiveKalman.Q), t64(np.diag(LiveKalman.Q))):  # full, diagonal
    xt, Pt = live_lane.live_predict_slab(t64(x), t64(P), Q, 0.013)
    np.testing.assert_allclose(np_(xt), np.asarray(xj), rtol=1e-12)
    np.testing.assert_allclose(np_(Pt), np.asarray(Pj), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_array_equal(np_(Pt), np_(Pt).transpose(1, 0, 2))


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_update_slab_matches_jax(kind):
  """live_update_slab for each of the 8 kinds, gate off and on (half the
  lanes far outliers), rtol 1e-10."""
  rng = np.random.RandomState(20 + kind)
  B = 8
  x, P = _random_states(rng, B)
  dz = live_lane.LANE_KINDS[kind][0]
  h, _ = live_lane.LANE_KINDS[kind][1](t64(x))
  far = np.where(np.arange(B) % 2 == 0, 0.01, 100.0)
  z = np_(h) + far * rng.randn(dz, B)
  R = np.diag(1.0 + rng.rand(dz))
  for gate in (False, True):
    out_j = jll.live_update_slab(kind, jnp.asarray(x), jnp.asarray(P),
                                 jnp.asarray(z), jnp.asarray(R), gate=gate)
    out_t = live_lane.live_update_slab(kind, t64(x), t64(P), t64(z), t64(R),
                                       gate=gate)
    for a, b in zip(out_j, out_t):
      np.testing.assert_allclose(np_(b), np.asarray(a), rtol=1e-10,
                                 atol=1e-12)
    np.testing.assert_array_equal(np_(out_t[1]),
                                  np_(out_t[1]).transpose(1, 0, 2))


def _workload(B, T, seed=0):
  rng = np.random.RandomState(seed)
  x = np.tile(LiveKalman.initial_x, (B, 1))
  x[:, 0:3] += rng.randn(B, 3)
  P = np.tile(np.diag(LiveKalman.initial_P_diag), (B, 1, 1)).transpose(1, 2, 0)
  dts = 0.01 + 0.001 * rng.rand(T)
  zs = LiveKalman.initial_x[0:3] + 5.0 * rng.randn(T, B, 3)
  return x, P, dts, zs, np.diag([25.0, 16.0, 9.0])


@pytest.mark.parametrize("gate", [False, True])
def test_plain_scan_matches_pallas_interpret(gate):
  """The plain kernel-2 scan against pallas_live.live_bank_scan in interpret
  mode at B = 32, T = 8, float32, with the tolerances of
  tests/test_pallas_live.py:55-58."""
  B, T = 32, 8
  x, P, dts, zs, R = _workload(B, T)
  if gate:
    zs[:, ::2, :] += 1e4
  f32 = np.float32
  xp, Pp = pallas_live.pack_live_state(jnp.asarray(x, f32),
                                       jnp.asarray(P, f32))
  xo, Po = pallas_live.live_bank_scan(
      xp, Pp, pallas_live.pack_measurements(jnp.asarray(zs, f32)),
      jnp.asarray(dts, f32), q_diag=tuple(np.diag(LiveKalman.Q).tolist()),
      r_mat=tuple(tuple(r) for r in R.tolist()), gate=gate, t_chunk=4,
      tile_b=16, interpret=True)
  x_ref, P_ref = interop.live_state_from_jax(xo, Po)
  xt, Pt = live_scan.live_bank_scan(
      t32(x.T), t32(P), t32(zs.transpose(0, 2, 1)), t32(dts),
      t32(np.diag(LiveKalman.Q)), t32(R), gate=gate)
  np.testing.assert_allclose(np_(xt), np_(x_ref), rtol=1e-6, atol=1e-5)
  np.testing.assert_allclose(np_(Pt), np_(P_ref), rtol=1e-5, atol=1e-5)
  # the lane-major entry point runs the same ops in the same order
  xl, Pl = live_lane.live_lane_scan(t32(x), t32(P), t32(LiveKalman.Q),
                                    t32(dts), t32(zs), t32(R), gate=gate)
  np.testing.assert_array_equal(np_(xl).T, np_(xt))
  np.testing.assert_array_equal(np_(Pl), np_(Pt))


def _mixed_inputs(T, B, seed):
  rng = np.random.RandomState(seed)
  x, P = _random_states(rng, B)
  kind_idx = (np.arange(T) % len(MIXED_KINDS)).astype(np.int32)
  zs = np.zeros((T, B, 3))
  for t in range(T):
    k = MIXED_KINDS[kind_idx[t]]
    dz = live_lane.LANE_KINDS[k][0]
    h, _ = live_lane.LANE_KINDS[k][1](t64(x))
    zs[t, :, :dz] = np_(h).T + 0.01 * rng.randn(B, dz)
  R_by_kind = {k: np.diag(0.5 + rng.rand(live_lane.LANE_KINDS[k][0]))
               for k in MIXED_KINDS}
  r_stream = (0.05 + 0.1 * rng.rand(T, 3)) ** 2
  return x, P, 0.009 + 0.002 * rng.rand(T), kind_idx, zs, R_by_kind, r_stream


@pytest.mark.parametrize("gate", [False, True])
def test_plain_mixed_scan_matches_jax(gate):
  """The plain kernel-3 scan (and live_mixed_scan) against JAX
  live_lane.live_mixed_scan, with both camera-odometry kinds streaming
  their diagonal R, float64, rtol 1e-9."""
  T, B = 12, 6
  x, P, dts, kind_idx, zs, R_by_kind, r_stream = _mixed_inputs(T, B, 7)
  stream = (K.CAMERA_ODO_ROTATION, K.CAMERA_ODO_TRANSLATION)
  xj, Pj = jll.live_mixed_scan(
      jnp.asarray(x.T), jnp.asarray(P), jnp.asarray(LiveKalman.Q),
      jnp.asarray(dts), jnp.asarray(kind_idx), jnp.asarray(zs),
      {k: jnp.asarray(v) for k, v in R_by_kind.items()}, MIXED_KINDS,
      gate=gate, r_stream=jnp.asarray(r_stream), stream_kinds=stream)
  xl, Pl = live_lane.live_mixed_scan(
      t64(x.T), t64(P), t64(LiveKalman.Q), t64(dts), kind_idx, t64(zs),
      {k: t64(v) for k, v in R_by_kind.items()}, MIXED_KINDS, gate=gate,
      r_stream=t64(r_stream), stream_kinds=stream)
  R_stack = np.zeros((len(MIXED_KINDS), 3, 3))
  for i, k in enumerate(MIXED_KINDS):
    dz = live_lane.LANE_KINDS[k][0]
    R_stack[i, :dz, :dz] = R_by_kind[k]
  xs, Ps = live_scan.live_bank_scan_mixed(
      t64(x), t64(P), t64(zs.transpose(0, 2, 1)), t64(dts),
      torch.as_tensor(kind_idx), MIXED_KINDS, t64(R_stack),
      t64(np.diag(LiveKalman.Q)), gate=gate, r_stream=t64(r_stream),
      stream_kinds=stream)
  for xo, Po in ((np_(xl).T, np_(Pl)), (np_(xs), np_(Ps))):
    np.testing.assert_allclose(xo, np.asarray(xj).T, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(Po, np.asarray(Pj), rtol=1e-9, atol=1e-9)


def test_interop_live_roundtrip():
  rng = np.random.RandomState(0)
  x, P = _random_states(rng, 24)
  xp, Pp = pallas_live.pack_live_state(jnp.asarray(x.T), jnp.asarray(P))
  xt, Pt = interop.live_state_from_jax(xp, Pp, dtype=torch.float64)
  np.testing.assert_array_equal(np_(xt), x)
  np.testing.assert_array_equal(np_(Pt), P)
  xb, Pb = interop.live_state_to_jax(xt, Pt)
  np.testing.assert_array_equal(xb, np.asarray(xp))
  np.testing.assert_array_equal(Pb, np.asarray(Pp))


def test_mixed_wrapper_validates():
  x, P = t64(np.zeros((23, 4))), t64(np.zeros((22, 22, 4)))
  with pytest.raises(ValueError, match="live lane kinds"):
    live_scan.live_bank_scan_mixed(x, P, None, None, None, (K.GPS_NED,),
                                   None, None)
  with pytest.raises(ValueError, match="go together"):
    live_scan.live_bank_scan_mixed(x, P, None, None, None, (K.ECEF_POS,),
                                   None, None, stream_kinds=(K.ECEF_POS,))


@pytest.mark.cuda
def test_kernels_match_plain(cuda_device):
  """Kernels 2 and 3 against their plain versions on the card (float32),
  from well-conditioned random states with measurements near each lane's
  own h; differences in standard deviations of the plain result."""
  dev = dict(dtype=torch.float32, device=cuda_device)
  T, B = 24, 2048
  x, P, dts, kind_idx, zs, R_by_kind, r_stream = _mixed_inputs(T, B, 5)
  x, P = torch.as_tensor(x, **dev), torch.as_tensor(P, **dev)
  q = torch.as_tensor(np.diag(LiveKalman.Q), **dev)
  zs_pos = torch.as_tensor(zs, **dev).permute(0, 2, 1).contiguous()
  zs_pos[:] = x[0:3] + 0.5 * torch.randn_like(zs_pos)
  R = torch.as_tensor(np.diag([4.0, 5.0, 6.0]), **dev)
  dts_t = torch.as_tensor(dts, **dev)
  for gate in (False, True):
    n = live_scan.live_bank_scan.launches
    out_k = live_scan.live_bank_scan(x, P, zs_pos, dts_t, q, R, gate=gate)
    assert live_scan.live_bank_scan.launches == n + 1
    out_p = live_scan.live_bank_scan_reference(x, P, zs_pos, dts_t, q, R,
                                               gate=gate)
    assert max(live_sigma_err(*out_k, *out_p)) < 1e-3
    assert torch.equal(out_k[1], out_k[1].transpose(0, 1))

  R_stack = np.zeros((len(MIXED_KINDS), 3, 3))
  for i, k in enumerate(MIXED_KINDS):
    dz = live_lane.LANE_KINDS[k][0]
    R_stack[i, :dz, :dz] = R_by_kind[k]
  args = (x, P, torch.as_tensor(zs, **dev).permute(0, 2, 1).contiguous(),
          dts_t, torch.as_tensor(kind_idx, device=cuda_device), MIXED_KINDS,
          torch.as_tensor(R_stack, **dev), q)
  kw = dict(r_stream=torch.as_tensor(r_stream, **dev),
            stream_kinds=(K.CAMERA_ODO_TRANSLATION,))
  for gate in (False, True):
    n = live_scan.live_bank_scan_mixed.launches
    out_k = live_scan.live_bank_scan_mixed(*args, gate=gate, **kw)
    assert live_scan.live_bank_scan_mixed.launches == n + 1
    out_p = live_scan.live_bank_scan_mixed_reference(*args, gate=gate, **kw)
    assert max(live_sigma_err(*out_k, *out_p)) < 1e-3
    assert torch.equal(out_k[1], out_k[1].transpose(0, 1))


@pytest.mark.cuda
def test_kernel3_ragged_bank_and_short_scans(cuda_device):
  """Kernel 3's tile of 32 filters on a bank that is not a multiple of 32
  (B = 8192 + 5: the last block has 27 lanes past the bank, which reach
  every barrier and store nothing), at T = 8 (all 6 mixed kinds, one
  streamed) and T = 1, against the plain version; T = 0 launches and
  counts nothing."""
  dev = dict(dtype=torch.float32, device=cuda_device)
  T, B = 8, 8192 + 5
  x, P, dts, kind_idx, zs, R_by_kind, r_stream = _mixed_inputs(T, B, 9)
  R_stack = np.zeros((len(MIXED_KINDS), 3, 3))
  for i, k in enumerate(MIXED_KINDS):
    dz = live_lane.LANE_KINDS[k][0]
    R_stack[i, :dz, :dz] = R_by_kind[k]
  x, P = torch.as_tensor(x, **dev), torch.as_tensor(P, **dev)
  zs = torch.as_tensor(zs, **dev).permute(0, 2, 1).contiguous()
  rest = (MIXED_KINDS, torch.as_tensor(R_stack, **dev),
          torch.as_tensor(np.diag(LiveKalman.Q), **dev))
  dts = torch.as_tensor(dts, **dev)
  ki = torch.as_tensor(kind_idx, device=cuda_device)
  r_stream = torch.as_tensor(r_stream, **dev)
  for n in (T, 1):
    args = (x, P, zs[:n], dts[:n], ki[:n]) + rest
    kw = dict(gate=True, r_stream=r_stream[:n],
              stream_kinds=(K.CAMERA_ODO_ROTATION,))
    count = live_scan.live_bank_scan_mixed.launches
    out_k = live_scan.live_bank_scan_mixed(*args, **kw)
    assert live_scan.live_bank_scan_mixed.launches == count + 1
    out_p = live_scan.live_bank_scan_mixed_reference(*args, **kw)
    assert max(live_sigma_err(*out_k, *out_p)) < 1e-3
    assert torch.equal(out_k[1], out_k[1].transpose(0, 1))
    assert not torch.equal(out_k[1][:, :, -1], P[:, :, -1])  # the last lane
  count = live_scan.live_bank_scan_mixed.launches
  out = live_scan.live_bank_scan_mixed(
      x, P, zs[:0], dts[:0], ki[:0], *rest, gate=True, r_stream=r_stream[:0],
      stream_kinds=(K.CAMERA_ODO_ROTATION,))
  assert torch.equal(out[0], x) and torch.equal(out[1], P)
  assert live_scan.live_bank_scan_mixed.launches == count


@pytest.mark.cuda
def test_kernel2_ragged_bank_and_short_scans(cuda_device):
  """Kernel 2's tile of 32 filters on a bank that is not a multiple of 32
  (B = 8192 + 5: the last block has 27 lanes past the bank, which reach
  every barrier and store nothing), at T = 8 and T = 1 with the gate on,
  against the plain version; T = 0 launches and counts nothing."""
  dev = dict(dtype=torch.float32, device=cuda_device)
  T, B = 8, 8192 + 5
  x, P, dts, _, _, _, _ = _mixed_inputs(T, B, 10)
  x, P = torch.as_tensor(x, **dev), torch.as_tensor(P, **dev)
  gen = torch.Generator(device=cuda_device)
  gen.manual_seed(10)
  zs = (x[None, 0:3] + 0.5 * torch.randn((T, 3, B), generator=gen,
                                         **dev)).contiguous()
  q = torch.as_tensor(np.diag(LiveKalman.Q), **dev)
  R = torch.as_tensor(np.diag([4.0, 5.0, 6.0]), **dev)
  dts = torch.as_tensor(dts, **dev)
  for n in (T, 1):
    count = live_scan.live_bank_scan.launches
    out_k = live_scan.live_bank_scan(x, P, zs[:n], dts[:n], q, R, gate=True)
    assert live_scan.live_bank_scan.launches == count + 1
    out_p = live_scan.live_bank_scan_reference(x, P, zs[:n], dts[:n], q, R,
                                               gate=True)
    assert max(live_sigma_err(*out_k, *out_p)) < 1e-3
    assert torch.equal(out_k[1], out_k[1].transpose(0, 1))
    assert not torch.equal(out_k[1][:, :, -1], P[:, :, -1])  # the last lane
  count = live_scan.live_bank_scan.launches
  out = live_scan.live_bank_scan(x, P, zs[:0], dts[:0], q, R, gate=True)
  assert torch.equal(out[0], x) and torch.equal(out[1], P)
  assert live_scan.live_bank_scan.launches == count
