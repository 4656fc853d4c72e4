"""Full-scope live acceptance stream on the port: tests/test_acceptance_live.py
(the reference's examples/test_compare.py:104-120 pattern) through the
port's engines, on the CPU in float64.

ONE randomized stream over all 8 live_kf observation kinds, with (a)
out-of-order swaps inside the rewind window, (b) camera-odometry rows
whose R comes from the measurement (live_kf.py:325-337), and (c) a
mid-stream divergence with a per-lane reset, is driven through:

  1. FilterEngine through the LiveKalman facade (host rewind / replay),
  2. LiveKalmanBank.observe (the bank's out-of-order ring),
  3. LiveKalmanBank.run_mixed over the sorted stream, the camera kinds'
     noise streamed per step (r_stream),
  4. a LiveKalmanBank with an off-diagonal Q on the route the card takes
     (`_generic = True`: observe on kernel 6's plain version, run_mixed
     with streamed R on the plain full-Q slab), against the oracle run
     with that Q,

and every engine is held against the independent sympy / numpy oracle
(tests/live_oracle.py) at the synchronization points where the delivered
set equals the sorted prefix, at the JAX test's tolerances (1e-5 relative
with 1e-7 absolute on x, 1e-8 on P).
"""

import numpy as np
import torch

from live_oracle import NumpyLiveEKF, SympyLiveOracle
from test_torch_live_full_q import full_q

from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank

KIND_TO_ORACLE = {
    K.ODOMETRIC_SPEED: 'odo_speed',
    K.PHONE_GYRO: 'gyro',
    K.NO_ROT: 'phone_rot',
    K.PHONE_ACCEL: 'acc',
    K.ECEF_POS: 'pos',
    K.CAMERA_ODO_TRANSLATION: 'rel_motion',
    K.CAMERA_ODO_ROTATION: 'phone_rot',
    K.IMU_FRAME: 'imu_frame',
}
CAMERA_KINDS = (K.CAMERA_ODO_TRANSLATION, K.CAMERA_ODO_ROTATION)
ALL_KINDS = tuple(KIND_TO_ORACLE)

# measurement noise added on top of h(x0), and the std-dev range of the
# camera kinds' measurement-supplied noise rows (the JAX test's)
NOISE = {
    K.ODOMETRIC_SPEED: 0.1,
    K.PHONE_GYRO: 0.01,
    K.NO_ROT: 1e-4,
    K.PHONE_ACCEL: 0.05,
    K.ECEF_POS: 2.0,
    K.CAMERA_ODO_TRANSLATION: 0.05,
    K.CAMERA_ODO_ROTATION: 0.02,
    K.IMU_FRAME: 0.005,
}
STD_RANGE = {
    K.CAMERA_ODO_TRANSLATION: (0.05, 0.3),
    K.CAMERA_ODO_ROTATION: (0.01, 0.1),
}

N_OBS = 200
DT = 0.01
SWAP_REGIONS = ((30, 90), (150, 190))
SYNC_POINTS = (100, 140, N_OBS)
RESET_AT = 140   # divergence and per-lane reset (outside the swap regions)
B = 4


def _initial_state():
  """Nonzero velocity and rates, so every kind's Jacobian is smooth (|v|
  has a kink at v = 0)."""
  x0 = np.array(LiveKalman.initial_x, dtype=float)
  x0[7:10] = [5.0, 1.0, 0.5]
  x0[10:13] = [0.02, -0.01, 0.03]
  x0[13:16] = [0.01, -0.02, 0.005]
  x0[17:20] = [0.1, -0.05, 0.2]
  return x0


def _build_stream(oracle, x0, rng):
  """The sorted stream: dicts of t, kind, z, stds (camera kinds), R."""
  obs = []
  for i in range(N_OBS):
    kind = ALL_KINDS[int(rng.integers(len(ALL_KINDS)))] if i >= 8 \
        else ALL_KINDS[i]  # the first 8: one of each kind
    h0 = np.asarray(oracle.h[KIND_TO_ORACLE[kind]](x0),
                    dtype=float).reshape(-1)
    z = h0 + NOISE[kind] * rng.standard_normal(h0.shape[0])
    if kind in CAMERA_KINDS:
      lo, hi = STD_RANGE[kind]
      stds = rng.uniform(lo, hi, 3)
      R = np.diag(stds**2)
    else:
      stds = None
      R = np.atleast_2d(np.asarray(LiveKalman.obs_noise[kind], dtype=float))
    obs.append({'i': i, 't': (i + 1) * DT, 'kind': kind, 'z': z,
                'stds': stds, 'R': R})
  return obs


def _delivery_order(rng):
  """Identity order with swaps (j, j + k), k in [3, 15], confined to
  SWAP_REGIONS: well inside the 1 s rewind window."""
  order = list(range(N_OBS))
  for lo, hi in SWAP_REGIONS:
    j = lo
    while j < hi - 15:
      if rng.random() < 0.35:
        k = int(rng.integers(3, 16))
        order[j], order[j + k] = order[j + k], order[j]
        j += k + 1
      else:
        j += 1
  return order


def _oracle_states(x0, P_diag, Q, stream):
  ref = NumpyLiveEKF(x0, np.diag(P_diag), Q)
  ref.t = 0.0
  at = {}
  for ob in stream:
    ref.predict_and_observe(ob['t'], KIND_TO_ORACLE[ob['kind']], ob['z'],
                            ob['R'])
    if ob['i'] + 1 in SYNC_POINTS:
      at[ob['i'] + 1] = (ref.x.copy(), ref.P.copy())
  return at


def _bank(batch, x0, Q=None):
  return LiveKalmanBank(batch=batch, x0=np.tile(x0, (batch, 1)), Q=Q,
                        dtype=torch.float64, device="cpu")


def _close(x, P, ox, oP, what):
  np.testing.assert_allclose(x, ox, rtol=1e-5, atol=1e-7,
                             err_msg=f"{what}: x")
  if P is not None:
    np.testing.assert_allclose(P, oP, rtol=1e-5, atol=1e-8,
                               err_msg=f"{what}: P")


def _run_mixed(bank, stream):
  """The sorted stream in one run_mixed, the camera kinds' noise
  streamed per step."""
  kinds = tuple(int(k) for k in ALL_KINDS)
  kind_idx = np.array([kinds.index(int(ob['kind'])) for ob in stream],
                      dtype=np.int32)
  zs = np.zeros((N_OBS, bank.batch, 3))
  r_stream = np.zeros((N_OBS, 3))
  for ob in stream:
    zs[ob['i'], :, :ob['z'].shape[0]] = ob['z']
    if ob['stds'] is not None:
      r_stream[ob['i']] = ob['stds']**2
  bank.run_mixed(np.full((N_OBS,), DT), kind_idx, zs, kinds,
                 stream_kinds=tuple(int(k) for k in CAMERA_KINDS),
                 r_stream=r_stream)


def test_full_scope_acceptance_stream():
  oracle_model = SympyLiveOracle()
  x0 = _initial_state()
  P_diag = np.array(LiveKalman.initial_P_diag, dtype=float)
  rng = np.random.default_rng(12345)
  stream = _build_stream(oracle_model, x0, rng)
  order = _delivery_order(rng)
  assert order != list(range(N_OBS)), "the stream must contain swaps"
  oracle_at = _oracle_states(x0, P_diag, LiveKalman.Q, stream)
  oracle_fq = _oracle_states(x0, P_diag, full_q(), stream)

  # engine 1: FilterEngine (rewind / replay), delivered out of order
  kf = LiveKalman(device="cpu")
  kf.init_state(x0, covs_diag=P_diag, filter_time=0.0)
  # engine 2: LiveKalmanBank.observe, delivered out of order
  bank = _bank(B, x0)
  # engine 4: the full-Q bank on the card's route, delivered out of order
  fq = _bank(B, x0, Q=full_q())
  fq._generic = True

  delivered = 0
  for j in order:
    ob = stream[j]
    data = [np.concatenate([ob['z'], ob['stds']])
            if ob['kind'] in CAMERA_KINDS else ob['z']]
    kf.predict_and_observe(ob['t'], ob['kind'], data)
    for b in (bank, fq):
      assert b.observe(ob['t'], int(ob['kind']), ob['z'],
                       R=ob['R']) is not None
    delivered += 1

    if delivered == RESET_AT:
      # fault injection: collapse lane 2's quaternion; detection flags
      # exactly that lane, the reset leaves the healthy lanes bitwise
      xb = bank.x.clone()
      xb[2, 3:7] = 1e-3
      bank._x = xb.T.contiguous()
      bad = bank.diverged()
      assert bool(bad[2]) and int(bad.sum()) == 1
      healthy = [i for i in range(B) if i != 2]
      hx = bank.x[healthy].clone()
      assert bank.reset_diverged(x0=np.tile(x0, (B, 1))) == 1
      assert torch.equal(bank.x[healthy], hx)

    if delivered in SYNC_POINTS:
      ox, oP = oracle_at[delivered]
      _close(kf.x, None, ox, oP, f"FilterEngine at obs {delivered}")
      _close(bank.x[0].numpy(), None, ox, oP,
             f"bank.observe at obs {delivered}")
      _close(fq.x[0].numpy(), None, *oracle_fq[delivered],
             f"full-Q bank.observe at obs {delivered}")
      if delivered < RESET_AT:
        # before the reset every lane saw the same inputs
        assert torch.equal(bank.x[1], bank.x[0])

  ox, oP = oracle_at[N_OBS]
  _close(kf.x, kf.P, ox, oP, "FilterEngine, final")
  _close(bank.x[0].numpy(), bank.P[0].numpy(), ox, oP, "bank.observe, final")
  _close(fq.x[0].numpy(), fq.P[0].numpy(), *oracle_fq[N_OBS],
         "full-Q bank.observe, final")
  # the reset lane: re-seeded mid-stream, healthy
  assert not bool(bank.diverged()[2])
  assert bool(torch.isfinite(bank.x[2]).all())

  # engine 3: run_mixed over the sorted stream, the camera noise streamed
  bank3 = _bank(2, x0)
  _run_mixed(bank3, stream)
  _close(bank3.x[0].numpy(), bank3.P[0].numpy(), ox, oP, "run_mixed")
  # engine 4 again: the full-Q bank's run_mixed with streamed R on the
  # card's route (the plain full-Q slab), against the full-Q oracle
  fq3 = _bank(2, x0, Q=full_q())
  fq3._generic = True
  _run_mixed(fq3, stream)
  assert not fq3._calls   # no generic kernel call was made
  _close(fq3.x[0].numpy(), fq3.P[0].numpy(), *oracle_fq[N_OBS],
         "full-Q run_mixed")
