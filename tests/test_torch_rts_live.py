"""The port's parallel smoother on the live ESKF, mirroring
tests/test_rts_live.py: the T = 600 dynamic-rotation log of its _live_log
(gyro schedule, ECEF position and NO_ROT updates, cold initial P), float64,
through the port's scan stream (runtime/scan.py) and JAX's. Tolerances:
the two forward passes rtol 1e-9 (atol 1e-9 in x, 1e-9 of P's scale);
_F_lane against jacfwd of f_err 1e-12; refine = 8 against the sequential
smoother 1e-6 in x and 1e-10 in P (the JAX test's limits); the port's
refine = 2 against JAX's refine = 2 to 1e-8."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rednose_tpu.models.live import LiveKalman as JLive
from rednose_tpu.runtime.scan import build_scan_stream as jbuild
from rednose_tpu.smoothing import rts as jrts
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.runtime.scan import build_scan_stream
from rednose_tpu_torch.smoothing import rts
from torch_parity import np_, t64

T = 600
KINDS = (K.ECEF_POS, K.PHONE_GYRO, K.NO_ROT)


def _inputs():
  """tests/test_rts_live.py's _live_log inputs, as numpy arrays."""
  ts = (1 + np.arange(T)) * 0.01
  ki = (np.arange(T) % 3).astype(np.int32)
  omega = np.stack([0.4 * np.sin(0.5 * ts), 0.3 * np.cos(0.8 * ts),
                    0.2 * np.ones_like(ts)], axis=1)
  n0 = np.asarray(jax.random.normal(jax.random.key(0), (T, 3), jnp.float64))
  n1 = np.asarray(jax.random.normal(jax.random.key(1), (T, 3), jnp.float64))
  zs = np.zeros((T, 3))
  zs = np.where((ki == 0)[:, None], LiveKalman.initial_x[0:3] + n0, zs)
  zs = np.where((ki == 1)[:, None], omega + 0.01 * n1, zs)
  Rs = np.stack([np.diag([25.0] * 3), np.diag([0.025**2] * 3),
                 np.diag([0.25**2] * 3)])[ki]
  return ts, np.full(T, 0.01), ki, zs, Rs, np.zeros((T, 1))


@pytest.fixture(scope="module")
def logs():
  ts, dts, ki, zs, Rs, eas = _inputs()
  P0 = np.diag(LiveKalman.initial_P_diag)
  scan_fn, _ = build_scan_stream(LiveKalman.build_spec(), KINDS)
  _, ours = scan_fn({}, t64(LiveKalman.initial_x), t64(P0), t64(LiveKalman.Q),
                    t64(dts), ki, t64(zs), t64(Rs), t64(eas))
  jscan, _ = jbuild(JLive.build_spec(), KINDS)
  _, ref = jscan({}, jnp.asarray(JLive.initial_x), jnp.asarray(P0),
                 jnp.asarray(JLive.Q), jnp.asarray(dts), jnp.asarray(ki),
                 jnp.asarray(zs), jnp.asarray(Rs), jnp.asarray(eas))
  q = np_(ours[2][:, 3:7])
  assert (q.max(0) - q.min(0)).max() > 0.3, "the trajectory must rotate"
  return ts, ours, tuple(np.asarray(a) for a in ref)


def test_scan_stream_matches_jax(logs):
  _, ours, ref = logs
  for a, b in zip(ours, ref):
    np.testing.assert_allclose(np_(a), b, rtol=1e-9,
                               atol=1e-9 * max(1.0, np.abs(b).max()))


def test_F_lane_matches_jacfwd(logs):
  spec = LiveKalman.build_spec()
  x = logs[1][2][::37]                                    # (17, 23)
  dts = t64(0.01 + 0.003 * np.arange(x.shape[0]))
  F = spec.F_lane({}, x.T, dts)
  for i in range(x.shape[0]):
    np.testing.assert_allclose(np_(F[:, :, i]),
                               np_(spec.F({}, x[i], dts[i])),
                               rtol=0, atol=1e-12)
  assert spec.F_lane({}, x[0], dts[0]).shape == (22, 22)


def test_refined_parallel_converges_to_sequential(logs):
  ts, (x_pred, P_pred, x_post, P_post), _ = logs
  spec = LiveKalman.build_spec()
  args = (x_pred, P_pred, x_post, P_post, t64(ts))
  xs_s, Ps_s = rts.rts_smooth(spec, {}, *args, norm_quats=True)
  xs_p, Ps_p = rts.rts_smooth_parallel(spec, {}, *args, norm_quats=True,
                                       refine=8)
  assert float((xs_s - xs_p).abs().max()) < 1e-6
  assert float((Ps_s - Ps_p).abs().max()) < 1e-10


def test_default_refine_matches_jax(logs):
  """refine defaults to 2 for an ESKF spec in float64, in both packages;
  the port's result equals JAX's on the same stacks."""
  ts, _, ref = logs
  xs, Ps = rts.rts_smooth_parallel(LiveKalman.build_spec(), {},
                                   *(t64(a) for a in ref), t64(ts),
                                   norm_quats=True)
  jfn = jax.jit(functools.partial(jrts.rts_smooth_parallel,
                                  JLive.build_spec(), norm_quats=True,
                                  refine=2))
  jxs, jPs = jfn({}, *(jnp.asarray(a) for a in ref), jnp.asarray(ts))
  np.testing.assert_allclose(np_(xs), np.asarray(jxs), rtol=1e-8,
                             atol=1e-8)
  np.testing.assert_allclose(np_(Ps), np.asarray(jPs), rtol=1e-8,
                             atol=1e-8 * np.abs(np.asarray(jPs)).max())
