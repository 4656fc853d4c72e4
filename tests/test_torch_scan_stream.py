"""The port's log scan (rednose_tpu_torch/runtime/scan.py), mirroring
tests/test_scan_stream.py in float64: a live stream mixing dz = 1 and
dz = 3 kinds against the port's host driver (x rtol 1e-8, P rtol 1e-6 /
atol 1e-9) and against JAX's scan on the same padded log (rtol 1e-9), a
single-kind kinematic stream against the driver (rtol 1e-10), the scan's
stacks feeding the smoother (rtol 1e-8, atol 1e-10), and pad_log bitwise
equal to JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest

from rednose_tpu.models.live import LiveKalman as JLive
from rednose_tpu.runtime import scan as jscan
from rednose_tpu_torch.models.kinematic import (
    KinematicKalman,
    ObservationKind as KK,
)
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.runtime import scan
from rednose_tpu_torch.smoothing.rts import rts_smooth_parallel
from torch_parity import np_, t64

KINDS = (K.ECEF_POS, K.NO_ROT, K.ODOMETRIC_SPEED)


def _live_log():
  rng = np.random.default_rng(0)
  log = []
  for i in range(24):
    kind = KINDS[i % 3]
    if kind == K.ECEF_POS:
      z = LiveKalman.initial_x[0:3] + rng.normal(0, 1, 3)
    elif kind == K.NO_ROT:
      z = rng.normal(0, 1e-4, 3)
    else:
      z = np.array([rng.normal(2.0, 0.1)])  # nonzero speed (|v| smooth)
    log.append(((i + 1) * 0.05, kind, z, LiveKalman.obs_noise[kind], None))
  return log


def _run(spec, kinds, x0, P0, Q, log):
  fn, _ = scan.build_scan_stream(spec, kinds)
  dts, ki, zs, Rs, eas = scan.pad_log(spec, kinds, log, t0=0.0)
  return fn({}, t64(x0), t64(P0), t64(Q), t64(dts), ki, t64(zs), t64(Rs),
            t64(eas))


def test_scan_stream_matches_driver_and_jax_mixed_kinds():
  log = _live_log()
  x0 = LiveKalman.initial_x.copy()
  x0[7:10] = [1.0, 1.0, 1.0]   # the speed Jacobian is finite off standstill
  P0 = np.diag(LiveKalman.initial_P_diag)
  kf = LiveKalman(device="cpu")
  kf.init_state(x0, covs=P0, filter_time=0.0)
  for t, kind, z, R, _ in log:
    kf.filter.predict_and_update_batch(t, kind, np.atleast_2d(z),
                                       R[None, :, :])
  spec = LiveKalman.build_spec()
  (x_f, P_f), stacks = _run(spec, KINDS, x0, P0, LiveKalman.Q, log)
  np.testing.assert_allclose(np_(x_f), kf.x, rtol=1e-8, atol=1e-10)
  np.testing.assert_allclose(np_(P_f), kf.P, rtol=1e-6, atol=1e-9)
  assert stacks[2].shape == (len(log), spec.dim_x)

  jspec = JLive.build_spec()
  jfn, _ = jscan.build_scan_stream(jspec, KINDS)
  padded = jscan.pad_log(jspec, KINDS, log, t0=0.0)
  _, jstacks = jfn({}, jnp.asarray(x0), jnp.asarray(P0),
                   jnp.asarray(JLive.Q), *(jnp.asarray(a) for a in padded))
  for a, b in zip(stacks, jstacks):
    b = np.asarray(b)
    np.testing.assert_allclose(np_(a), b, rtol=1e-9,
                               atol=1e-9 * max(1.0, np.abs(b).max()))


def _kinematic_log(T, seed):
  rng = np.random.default_rng(seed)
  return [((i + 1) * 0.01, KK.POSITION, [rng.normal(0, 0.3)],
           np.atleast_2d(0.01), None) for i in range(T)]


def test_scan_stream_single_kind_matches_driver():
  log = _kinematic_log(100, 1)
  kf = KinematicKalman(device="cpu")
  kf.filter.set_filter_time(0.0)
  for t, kind, z, R, _ in log:
    kf.filter.predict_and_update_batch(t, kind, np.atleast_2d(z), R[None])
  (x_f, P_f), _ = _run(KinematicKalman.build_spec(), (KK.POSITION,),
                       KinematicKalman.initial_x,
                       np.diag(KinematicKalman.initial_P_diag),
                       KinematicKalman.Q, log)
  np.testing.assert_allclose(np_(x_f), kf.x, rtol=1e-10)
  np.testing.assert_allclose(np_(P_f), kf.P, rtol=1e-10)


def test_scan_stream_feeds_smoother():
  """Scan the log, smooth the stacks: equal to smoothing the host driver's
  estimate list."""
  log = _kinematic_log(64, 2)
  spec = KinematicKalman.build_spec()
  kf = KinematicKalman(device="cpu")
  kf.filter.set_filter_time(0.0)
  estimates = [kf.filter.predict_and_update_batch(t, kind, np.atleast_2d(z),
                                                  R[None])
               for t, kind, z, R, _ in log]
  ref_x = np.stack([s[0] for s in kf.filter.rts_smooth(estimates,
                                                       parallel=True)])
  _, stacks = _run(spec, (KK.POSITION,), KinematicKalman.initial_x,
                   np.diag(KinematicKalman.initial_P_diag),
                   KinematicKalman.Q, log)
  dts = scan.pad_log(spec, (KK.POSITION,), log)[0]
  xs, _ = rts_smooth_parallel(spec, {}, *stacks, t64(np.cumsum(dts)),
                              dts=t64(dts[1:]))
  np.testing.assert_allclose(np_(xs), ref_x, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pad_log_bitwise_equal_to_jax(dtype):
  log = _live_log()
  ours = scan.pad_log(LiveKalman.build_spec(), KINDS, log, t0=0.01,
                      dtype=dtype)
  ref = jscan.pad_log(JLive.build_spec(), KINDS, log, t0=0.01, dtype=dtype)
  for a, b in zip(ours, ref):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
  assert scan.PAD_R == jscan.PAD_R
  with pytest.raises(ValueError, match="non-decreasing"):
    scan.pad_log(LiveKalman.build_spec(), KINDS, log[::-1])
  fn, index = scan.build_scan_stream(LiveKalman.build_spec(), list(KINDS))
  assert scan.build_scan_stream(LiveKalman.build_spec(), KINDS)[0] is fn
  assert index == {k: i for i, k in enumerate(KINDS)}
