"""The port's RTS smoother (rednose_tpu_torch/smoothing/rts.py), mirroring
tests/test_rts.py on the kinematic filter in float64: the independent numpy
oracle (rtol 1e-9, atol 1e-12), parallel against sequential (rtol 1e-8,
atol 1e-10), the reference's own recorded smoother output
(tests/fixtures/ref_kinematic_smooth.npz, atol 1e-12), lower RMSE than the
filter, short inputs, the bank against per-trajectory smoothing (rtol
1e-10, atol 1e-12), the suffix scan against a sequential fold (rtol 1e-9,
atol 1e-11), the port against JAX's smoothers on the same stacks (rtol
1e-10, atol 1e-12), and the offline multipass driver against JAX's."""

import os

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; only the cuda test runs there
  import jax.numpy as jnp
  from rednose_tpu.models.kinematic import KinematicKalman as JKinematic
  from rednose_tpu.runtime import offline as joffline
  from rednose_tpu.smoothing import rts as jrts
except ImportError:
  jnp = JKinematic = joffline = jrts = None
from rednose_tpu_torch.models.kinematic import KinematicKalman, ObservationKind
from rednose_tpu_torch.runtime import offline
from rednose_tpu_torch.smoothing import rts
from torch_parity import cuda_device, np_, t64  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _run_filter(T=300, seed=0):
  np.random.seed(seed)
  kf = KinematicKalman(device="cpu")
  dt = 0.01
  ts = np.arange(0, T * dt, step=dt)
  x = 0.0
  estimates, truth = [], []
  for t, v in zip(ts, np.sin(ts * 5)):
    est = kf.predict_and_observe(t, ObservationKind.POSITION,
                                 [np.random.normal(x, 0.1)])
    estimates.append(est)
    truth.append(x)
    x += v * dt
  return kf, estimates, np.array(truth)


def _stacks(estimates):
  return (np.stack([np_(e[0]).reshape(-1) for e in estimates]),
          np.stack([np_(e[2]) for e in estimates]),
          np.stack([np_(e[1]).reshape(-1) for e in estimates]),
          np.stack([np_(e[3]) for e in estimates]),
          np.array([e[4] for e in estimates], dtype=np.float64))


def _numpy_rts(estimates, reference_seed=False):
  """Textbook RTS written independently in numpy; reference_seed seeds from
  the last predicted state, as the reference does (ekf_sym.py:651-690)."""
  x_pred, P_pred, x_post, P_post, t = _stacks(estimates)
  T = len(estimates)
  xs, Ps = x_post.copy(), P_post.copy()
  if reference_seed:
    xs[T - 1], Ps[T - 1] = x_pred[T - 1], P_pred[T - 1]
  for k in range(T - 2, -1, -1):
    F = np.array([[1.0, t[k + 1] - t[k]], [0.0, 1.0]])
    C = P_post[k] @ F.T @ np.linalg.inv(P_pred[k + 1])
    xs[k] = x_post[k] + C @ (xs[k + 1] - x_pred[k + 1])
    Ps[k] = P_post[k] + C @ (Ps[k + 1] - P_pred[k + 1]) @ C.T
  return xs, Ps


def _unzip(smoothed):
  return (np.stack([s[0] for s in smoothed]),
          np.stack([s[1] for s in smoothed]))


@pytest.mark.parametrize("reference_seed", [False, True])
def test_rts_matches_numpy_oracle(reference_seed):
  kf, estimates, _ = _run_filter()
  xs, Ps = _unzip(kf.filter.rts_smooth(estimates,
                                       reference_seed=reference_seed))
  xs_np, Ps_np = _numpy_rts(estimates, reference_seed)
  np.testing.assert_allclose(xs, xs_np, rtol=1e-9, atol=1e-12)
  np.testing.assert_allclose(Ps, Ps_np, rtol=1e-9, atol=1e-12)
  if reference_seed:   # the default seed keeps the final measurement
    default = kf.filter.rts_smooth(estimates)
    assert not np.allclose(default[-1][0], xs[-1])
    np.testing.assert_allclose(default[-1][0], np_(estimates[-1][1]))


def test_parallel_rts_matches_sequential():
  kf, estimates, _ = _run_filter(T=600)
  xs_seq, Ps_seq = _unzip(kf.filter.rts_smooth(estimates))
  xs_par, Ps_par = _unzip(kf.filter.rts_smooth(estimates, parallel=True))
  # additive error state: the affine form is exact (roundoff only)
  np.testing.assert_allclose(xs_par, xs_seq, rtol=1e-8, atol=1e-10)
  np.testing.assert_allclose(Ps_par, Ps_seq, rtol=1e-8, atol=1e-10)


def test_reference_seed_matches_reference_golden():
  """rts_smooth(reference_seed=True) reproduces the reference's own
  rts_smooth output recorded over its compiled filter
  (tests/test_reference_golden.py:109-124)."""
  s = np.load(os.path.join(FIXTURES, "ref_kinematic_smooth.npz"))
  spec = KinematicKalman.build_spec()
  args = [t64(s[k]) for k in ("x_pred", "P_pred", "x_post", "P_post", "t")]
  xs, Ps = rts.rts_smooth(spec, {}, *args, reference_seed=True)
  np.testing.assert_allclose(np_(xs), s["smooth_x"], atol=1e-12)
  np.testing.assert_allclose(np_(Ps), s["smooth_P"], atol=1e-12)
  xs0, _ = rts.rts_smooth(spec, {}, *args)
  assert np.abs(np_(xs0)[-1] - s["smooth_x"][-1]).max() > 1e-6


def test_smoothing_reduces_rmse():
  kf, estimates, truth = _run_filter()
  xs, _ = _unzip(kf.filter.rts_smooth(estimates))
  filtered = np.array([np_(e[1]).reshape(-1)[0] for e in estimates])
  rmse = lambda a: np.sqrt(np.mean((a - truth) ** 2))  # noqa: E731
  assert rmse(xs[:, 0]) < rmse(filtered)


def test_smooth_estimates_short_inputs():
  kf, estimates, _ = _run_filter(T=1)
  out = rts.smooth_estimates(kf.spec, {}, estimates)
  assert len(out) == 1
  np.testing.assert_allclose(out[0][0], np_(estimates[0][1]))
  assert rts.smooth_estimates(kf.spec, {}, []) == []
  _, two, _ = _run_filter(T=2)
  for parallel in (False, True):
    xs, _ = _unzip(kf.filter.rts_smooth(two, parallel=parallel))
    np.testing.assert_allclose(xs, _numpy_rts(two)[0], rtol=1e-9,
                               atol=1e-12)


def test_bank_smoothing_matches_per_trajectory():
  from rednose_tpu_torch.core import step

  spec = KinematicKalman.build_spec()
  rng = np.random.RandomState(0)
  B, T = 3, 20
  Q = t64(KinematicKalman.Q)
  st = {k: np.zeros((B, T) + s) for k, s in
        (("xp", (2,)), ("Pp", (2, 2)), ("xf", (2,)), ("Pf", (2, 2)))}
  ts = np.tile(0.01 * (1 + np.arange(T)), (B, 1))
  for b in range(B):
    x, P = t64(KinematicKalman.initial_x), t64(
        np.diag(KinematicKalman.initial_P_diag))
    for k in range(T):
      x1, P1 = step.predict(spec, {}, x, P, Q, t64(0.01))
      x, P, _ = step.update(spec, ObservationKind.POSITION, {}, x1, P1,
                            t64([0.1 * rng.randn()]), t64([[0.01]]),
                            t64(np.zeros(1)))
      for key, v in (("xp", x1), ("Pp", P1), ("xf", x), ("Pf", P)):
        st[key][b, k] = np_(v)
  args = [t64(st[k]) for k in ("xp", "Pp", "xf", "Pf")] + [t64(ts)]
  xs_bank, Ps_bank = rts.rts_smooth_parallel_bank(spec, {}, *args)
  for b in range(B):
    xs, Ps = rts.rts_smooth_parallel(spec, {}, *(a[b] for a in args))
    np.testing.assert_allclose(np_(xs_bank[b]), np_(xs), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np_(Ps_bank[b]), np_(Ps), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("T", [700, 1024])
@pytest.mark.parametrize("with_V", [True, False])
def test_suffix_scan_matches_sequential_fold(T, with_V):
  """_suffix_scan_lane == the sequential fold out[k] = x[k] wrapping
  out[k+1] (the combine's semantics), at a length that is and one that is
  not a power of two."""
  rng = np.random.RandomState(T)
  d = 5
  A = t64(0.1 * rng.randn(d, d, T) + 0.9 * np.eye(d)[:, :, None])
  b = t64(0.1 * rng.randn(d, 1, T))
  V = t64(0.01 * rng.randn(d, d, T))
  elems = (A, b, V) if with_V else (A, b)
  combine = rts._affine_combine_lane if with_V else rts._affine_combine_ab
  out = rts._suffix_scan_lane(*elems)
  acc = tuple(e[..., T - 1:] for e in elems)
  folded = [acc]
  for k in range(T - 2, -1, -1):
    acc = combine(acc, tuple(e[..., k:k + 1] for e in elems))
    folded.append(acc)
  for i, o in enumerate(out):
    ref = torch.cat([f[i] for f in folded[::-1]], dim=-1)
    np.testing.assert_allclose(np_(o), np_(ref), rtol=1e-9, atol=1e-11)


def test_port_matches_jax_smoothers():
  """rts_smooth / rts_smooth_parallel of the port and of the JAX package on
  the same stacks (the port's forward pass)."""
  _, estimates, _ = _run_filter(T=600, seed=3)
  stacks = _stacks(estimates)
  jspec, spec = JKinematic.build_spec(), KinematicKalman.build_spec()
  for name, kw in (("rts_smooth", {}),
                   ("rts_smooth", dict(reference_seed=True)),
                   ("rts_smooth_parallel", {})):
    xs, Ps = getattr(rts, name)(spec, {}, *(t64(a) for a in stacks), **kw)
    jxs, jPs = getattr(jrts, name)(jspec, {}, *(jnp.asarray(a)
                                                for a in stacks), **kw)
    np.testing.assert_allclose(np_(xs), np.asarray(jxs), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(np_(Ps), np.asarray(jPs), rtol=1e-10,
                               atol=1e-12)


def _make_log(mod, T=200, seed=0):
  rng = np.random.default_rng(seed)
  x, truth, log = 0.0, [], []
  for i in range(T):
    t = (i + 1) * 0.01
    truth.append(x)
    log.append(mod.Observation(t=t, kind=ObservationKind.POSITION,
                               data=[rng.normal(x, 0.1)]))
    x += np.sin(t * 5) * 0.01
  return log, np.array(truth)


def test_multipass_smooth_matches_jax():
  """runtime/offline.multipass_smooth of the port against the JAX
  package's (test_aux_subsystems.py's log), and the second pass no worse
  than the first."""
  log, truth = _make_log(offline)
  jlog, _ = _make_log(joffline)
  s1, estimates = offline.multipass_smooth(KinematicKalman(device="cpu"),
                                           log, passes=1)
  s2, _ = offline.multipass_smooth(KinematicKalman(device="cpu"), log,
                                   passes=2)
  j2, _ = joffline.multipass_smooth(JKinematic(), jlog, passes=2)
  np.testing.assert_allclose(_unzip(s2)[0], _unzip(j2)[0], rtol=1e-9,
                             atol=1e-12)
  np.testing.assert_allclose(_unzip(s2)[1], _unzip(j2)[1], rtol=1e-9,
                             atol=1e-12)
  filt = np.array([np_(e[1])[0] for e in estimates])
  rmse = lambda a: np.sqrt(np.mean((a - truth) ** 2))  # noqa: E731
  assert rmse(_unzip(s1)[0][:, 0]) < rmse(filt)
  assert rmse(_unzip(s2)[0][:, 0]) <= rmse(_unzip(s1)[0][:, 0]) * 1.05


def _live_log(T, seed, device):
  """A cold live log (tests/test_rts_live.py's kinds and gyro schedule,
  noise from a torch generator) through the port's scan stream, float64
  on `device`: (stacks, ts)."""
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.runtime.scan import build_scan_stream

  g = torch.Generator().manual_seed(seed)
  ts = (1 + torch.arange(T, dtype=torch.float64)) * 0.01
  ki = np.arange(T) % 3
  kt = torch.as_tensor(ki)
  omega = torch.stack([0.4 * torch.sin(0.5 * ts), 0.3 * torch.cos(0.8 * ts),
                       0.2 * torch.ones_like(ts)], dim=1)
  noise = torch.randn((T, 3), generator=g, dtype=torch.float64)
  zs = torch.where((kt == 0)[:, None],
                   t64(LiveKalman.initial_x[0:3]) + noise,
                   torch.where((kt == 1)[:, None], omega + 0.01 * noise,
                               torch.zeros(()).double()))
  Rs = torch.stack([torch.diag(t64([v] * 3))
                    for v in (25.0, 0.025**2, 0.25**2)])[kt]
  fn, _ = build_scan_stream(LiveKalman.build_spec(),
                            (K.ECEF_POS, K.PHONE_GYRO, K.NO_ROT))
  def d(a):
    return torch.as_tensor(a, dtype=torch.float64, device=device)

  _, stacks = fn({}, d(LiveKalman.initial_x),
                 d(np.diag(LiveKalman.initial_P_diag)), d(LiveKalman.Q),
                 d(np.full(T, 0.01)), ki, d(zs), d(Rs), d(np.zeros((T, 1))))
  return stacks, d(ts)


@pytest.mark.cuda
def test_smoothers_on_card_match_cpu(cuda_device):
  """The scan stream and the sequential, parallel (refine = 8) and bank
  smoothers on the card against themselves on the CPU, float64, on a
  T = 300 cold live log (rtol 1e-9, atol 1e-9 of each array's scale)."""
  from rednose_tpu_torch.models.live import LiveKalman

  spec = LiveKalman.build_spec()
  cpu_args = _live_log(300, 0, "cpu")
  gpu_args = _live_log(300, 0, cuda_device)
  runs = (lambda *a: a,
          lambda *a: rts.rts_smooth(spec, {}, *a, norm_quats=True),
          lambda *a: rts.rts_smooth_parallel(spec, {}, *a, norm_quats=True,
                                             refine=8),
          lambda *a: rts.rts_smooth_parallel_bank(
              spec, {}, *(v[None].expand(2, *v.shape) for v in a)))
  for run in runs:
    for c, g in zip(run(*cpu_args[0], cpu_args[1]),
                    run(*gpu_args[0], gpu_args[1])):
      assert g.is_cuda
      np.testing.assert_allclose(np_(g), np_(c), rtol=1e-9,
                                 atol=1e-9 * float(c.abs().max()))
