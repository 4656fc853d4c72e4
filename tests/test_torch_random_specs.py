"""Random and user-written specs through the port's generic paths.

Mirrors tests/test_random_specs.py on the port: the same random specs
(models/user_specs.random_spec draws them from the same numpy seeds) through
the port's FilterEngine, lane_bank.lane_bank_scan, sparsity.
detect_structure and lane path, and in place of JAX's entry_step_slab the
emitted kernel body, built on the host as double (tests/torch_parity.
run_host, tile and global form), each against the textbook numpy EKF at
the JAX test's tolerances.

Then the ops the emitter takes beyond the shipped models (user_specs.OPS):
one 4-state spec per op, its host build in float64 within RTOL of the
port's plain version, of JAX's lane path and of JAX's entry_step_slab
(where JAX's emitter is right: see J_ENTRY_F_ONLY); norm and hypot at a
zero argument, where their jvp divides by zero, against the plain
version (eager torch); the op battery (user_specs.battery_spec) in modes
"mixed" and "epoch" against JAX's pallas_bank kernels in interpret mode;
and an op without a rule (torch.prod), which still raises
(tests/test_torch_profiling.py counts the battery's operations). Skips
the host builds, with the reason, where no C++ compiler is on PATH.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.core.spec import FilterSpec as JSpec
from rednose_tpu.core.spec import ObservationModel as JObs
from rednose_tpu.ops import entry_slab as jentry
from rednose_tpu.ops import lane_bank as jlane
from rednose_tpu.ops import pallas_bank
from rednose_tpu.ops import sparsity as jsparsity
from rednose_tpu_torch import interop
from rednose_tpu_torch.core import step as tstep
from rednose_tpu_torch.models import user_specs as us
from rednose_tpu_torch.ops import entry_slab, generic_scan, lane_bank
from rednose_tpu_torch.ops import sparsity
from rednose_tpu_torch.runtime.driver import FilterEngine
from torch_parity import host_compiler, np_, run_host, t64

RTOL = 1e-9

needs_compiler = pytest.mark.skipif(
    host_compiler() is None,
    reason="no host C++ compiler (g++ / c++) on PATH to build the emitted "
           "source")


def _numpy_ekf(spec, x0, P0, Q, stream):
  """tests/test_random_specs.py's textbook EKF in numpy, its Jacobians
  from the port spec's jacfwd surface."""
  x = np.asarray(x0, np.float64).copy()
  P = np.asarray(P0, np.float64).copy()
  Q = np.asarray(Q, np.float64)
  om = spec.obs[1]
  for dt, z, R in stream:
    F = np_(spec.F({}, t64(x), t64(dt)))
    x = np_(spec.f({}, t64(x), t64(dt)))
    P = F @ P @ F.T + dt * Q
    P = 0.5 * (P + P.T)
    hx = np_(om.h({}, t64(x), None))
    H = np_(spec.H(1, {}, t64(x), t64(np.zeros(1))))
    y = z - hx
    S = H @ P @ H.T + R
    if om.maha_test and float(y @ np.linalg.solve(S, y)) > om.maha_thresh:
      K = np.zeros((x.shape[0], z.shape[0]))  # zero-gain soft reject
    else:
      K = np.linalg.solve(S, H @ P).T
    x = x + K @ y
    IKH = np.eye(x.shape[0]) - K @ H
    P = IKH @ P @ IKH.T + K @ R @ K.T
    P = 0.5 * (P + P.T)
  return x, P


# ---------------------------------------- mirror of tests/test_random_specs

@pytest.mark.parametrize("seed,dim,dz", [(0, 3, 1), (1, 5, 2), (2, 7, 3),
                                         (3, 11, 2)])
def test_engine_matches_numpy_ekf(seed, dim, dz):
  spec, rng = us.random_spec(seed, dim, dz)
  x0 = rng.randn(dim)
  P0 = np.eye(dim)
  Q = np.diag(0.01 + 0.1 * rng.rand(dim))
  eng = FilterEngine(spec, Q, x0, P0, device="cpu")

  stream = []
  t = 0.0
  for i in range(40):
    t += 0.05
    z = rng.randn(dz) * (10.0 if i % 9 == 5 else 1.0)  # occasional outlier
    R = np.diag(0.5 + rng.rand(dz))
    stream.append((0.05 if i else 0.0, z, R))
    eng.predict_and_update_batch(t, 1, [z], R[None])

  x_ref, P_ref = _numpy_ekf(spec, x0, P0, Q, stream)
  np.testing.assert_allclose(np.asarray(eng.state()), x_ref, rtol=1e-8,
                             atol=1e-10)
  np.testing.assert_allclose(np.asarray(eng.covs()), P_ref, rtol=1e-7,
                             atol=1e-10)


@pytest.mark.parametrize("seed,dim,dz", [(4, 4, 2), (5, 6, 3)])
def test_lane_bank_matches_numpy_ekf_per_lane(seed, dim, dz):
  spec, rng = us.random_spec(seed, dim, dz)
  B, T = 5, 12
  x0 = rng.randn(B, dim)
  P0 = np.tile(np.eye(dim), (B, 1, 1))
  Q = np.diag(0.01 + 0.1 * rng.rand(dim))
  dts = np.full((T,), 0.05)
  zs = rng.randn(T, B, dz)
  R = np.diag(0.5 + rng.rand(dz))

  xb, Pb = lane_bank.lane_bank_scan(
      spec, 1, {}, t64(x0), t64(P0.transpose(1, 2, 0)), t64(Q), t64(dts),
      t64(zs), t64(R))
  xb, Pb = np_(xb), np_(Pb).transpose(2, 0, 1)
  for lane in range(B):
    stream = [(0.05, zs[t, lane], R) for t in range(T)]
    x_ref, P_ref = _numpy_ekf(spec, x0[lane], P0[lane], Q, stream)
    np.testing.assert_allclose(xb[lane], x_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(Pb[lane], P_ref, rtol=1e-7, atol=1e-10)


@needs_compiler
@pytest.mark.parametrize("seed,dim", [(6, 5), (7, 9)])
def test_structure_detection_on_random_sparsity(seed, dim):
  """detect_structure recovers the random mask of A (F = I + dt A
  diag(tanh'(x)) shares A's pattern plus the diagonal), and the body
  emitted with it reproduces the dense lane path (the port keeps no
  masked lane path: the structure drives the emitter)."""
  spec, rng = us.random_spec(seed, dim, 2)
  x0 = rng.randn(dim)
  st = sparsity.detect_structure(spec, x0)
  F = np_(spec.F({}, t64(rng.randn(dim)), t64(0.07)))
  detected = np.zeros((dim, dim), bool)
  for i, cols in enumerate(st.f_rows):
    detected[i, list(cols)] = True
  assert ((F != 0) <= detected).all()  # no nonzero outside the pattern

  B, T = 4, 6
  xb0 = rng.randn(B, dim)
  P0 = np.tile(np.eye(dim), (B, 1, 1)).transpose(1, 2, 0)
  Q = np.diag(0.01 + 0.1 * rng.rand(dim))
  dts = np.full((T,), 0.05)
  zs = rng.randn(T, B, 2)
  R = np.diag(0.5 + rng.rand(2))
  xd, Pd = lane_bank.lane_bank_scan(spec, 1, {}, t64(xb0), t64(P0), t64(Q),
                                    t64(dts), t64(zs), t64(R))
  xs_, Ps_ = run_host("single", spec, (1,), xb0.T, P0, np.swapaxes(zs, 1, 2),
                      dts, Q=Q, R_list=(R,), structure=st)
  np.testing.assert_allclose(np_(xs_).T, np_(xd), rtol=1e-9, atol=1e-11)
  np.testing.assert_allclose(np_(Ps_), np_(Pd), rtol=1e-8, atol=1e-11)


@needs_compiler
@pytest.mark.parametrize("seed,dim,dz", [(6, 3, 1), (7, 5, 2), (8, 9, 3),
                                         (9, 14, 2)])
def test_entry_slab_matches_numpy_ekf(seed, dim, dz):
  """The emitted body (kernels 4-7's, in its tile and its global form)
  vs the textbook numpy EKF, at dims no shipped model has."""
  spec, rng = us.random_spec(seed, dim, dz)
  st = sparsity.detect_structure(spec, rng.randn(dim))
  B, T = 4, 10
  x0 = rng.randn(B, dim)
  P0 = np.tile(np.eye(dim), (B, 1, 1))
  q = 0.01 + 0.1 * rng.rand(dim)
  R = np.diag(0.5 + rng.rand(dz))
  zs = rng.randn(T, B, dz)
  for tile in (True, False):
    x, P = run_host("single", spec, (1,), x0.T, P0.transpose(1, 2, 0),
                    np.swapaxes(zs, 1, 2), np.full(T, 0.05), Q=np.diag(q),
                    R_list=(R,), structure=st, tile=tile)
    for lane in range(B):
      stream = [(0.05, zs[t, lane], R) for t in range(T)]
      x_ref, P_ref = _numpy_ekf(spec, x0[lane], P0[lane], np.diag(q), stream)
      np.testing.assert_allclose(np_(x)[:, lane], x_ref, rtol=1e-7,
                                 atol=1e-9)
      np.testing.assert_allclose(np_(P)[:, :, lane], P_ref, rtol=1e-6,
                                 atol=1e-9)


def test_lane_bank_pseudorange_extra_args():
  """A non-feature kind with per-lane extra args through the lane bank's
  update, against core/step.update lane by lane."""
  from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel

  def h_pr(params, x, ea):
    del params
    return torch.linalg.norm(x[:3] - ea)[None]

  spec = FilterSpec(
      name="pr_lane", dim_x=3, dim_err=3, f=lambda p, x, dt: x,
      obs={5: ObservationModel(kind=5, h=h_pr, dz=1, ea_dim=0, ea_len=3)})
  rng = np.random.RandomState(0)
  B = 6
  x0 = t64(rng.randn(B, 3))
  P0 = t64(np.tile(np.eye(3) * 4.0, (B, 1, 1)).transpose(1, 2, 0))
  sats = t64(100.0 * rng.randn(B, 3))
  z = t64(rng.rand(B, 1) * 100.0)
  R = t64([[1e-2]])

  xl, Pl, yl = lane_bank.lane_update(spec, 5, {}, x0, P0, z, R, ea=sats)
  for i in range(B):
    xo, Po, yo = tstep.update(spec, 5, {}, x0[i], P0[:, :, i], z[i], R,
                              sats[i])
    np.testing.assert_allclose(np_(xl[i]), np_(xo), rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np_(Pl[:, :, i]), np_(Po), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(np_(yl[i]), np_(yo), rtol=1e-9, atol=1e-10)


# ------------------------------------------------- the ops, one spec each

J_OPS = {
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "softplus": jax.nn.softplus,
    "abs": jnp.abs,
    "norm": lambda x: jnp.linalg.norm(x[:3]) * jnp.ones_like(x),
    "cross": lambda x: jnp.concatenate([jnp.cross(x[:3], x[1:]), x[3:]]),
    "remainder": lambda x: jnp.remainder(x, 2.0 * math.pi),
    "fmod": lambda x: jnp.fmod(x, 2.0),
    "hypot": lambda x: jnp.hypot(x, jnp.flip(x, 0)),
    "cumsum": lambda x: jnp.cumsum(x, 0),
    "flip": lambda x: jnp.flip(x, 0),
    "roll": lambda x: jnp.roll(x, 1),
    "mean": lambda x: jnp.mean(x) * jnp.ones_like(x),
}


# JAX's emitter (rednose_tpu/ops/structural.py) is itself off on some of
# these ops. Its structure detection raises for hypot and remainder in h
# (a select whose predicate is a structural zero is materialized as a
# float 0.0: structural.py:383-391), so those two are held against its
# entry slab with the op in f only. It evaluates lax.rem, which jnp.fmod
# is, as jnp.remainder (structural.py:93, floor-mod), so its fmod is off
# wherever the operands' signs differ. Run eagerly, outside jit, its entry
# slab also gives wrong values for abs and softplus (under jit, as its
# kernels run it, they are right), so it is run under jit here; its
# structure detection, which runs eagerly, once raised a StructureError
# on abs in a run of this file beside others, so JAX's entry slab and
# kernels take the port's detected structure (_jax_structure), the same
# pattern. Every op is also held, in f and h, against JAX's lane path
# (jacfwd), which has none of these faults.
J_ENTRY_F_ONLY = ("hypot", "remainder")
J_ENTRY_OFF = ("fmod",)


def _j_op_spec(name, in_h=True):
  """The JAX twin of user_specs.op_spec(name, in_h)."""
  op = J_OPS[name]
  return JSpec(name=f"op_{name}", dim_x=4, dim_err=4,
               f=lambda params, x, dt: x + dt * op(x),
               obs={1: JObs(kind=1, h=lambda params, x, ea:
                            x[:2] + 0.1 * op(x)[:2] if in_h else x[:2],
                            dz=2)})


def _op_case(seed, B=8, T=10):
  rng = np.random.RandomState(seed)
  x0 = us.OP_X0 + 0.1 * rng.randn(B, 4)
  A = 0.3 * rng.randn(B, 4, 4)
  P0 = np.einsum("bij,bkj->ikb", A, A) + 0.5 * np.eye(4)[:, :, None]
  q = 0.01 + 0.05 * rng.rand(4)
  R = np.diag(0.2 + 0.1 * rng.rand(2))
  zs = us.OP_X0[None, None, :2] + 0.3 * rng.randn(T, B, 2)
  return x0, P0, q, R, zs, np.full(T, 0.05)


def _close(ours, ref_x, ref_P):
  np.testing.assert_allclose(np_(ours[0]), ref_x, rtol=RTOL, atol=1e-12)
  np.testing.assert_allclose(np_(ours[1]), ref_P, rtol=RTOL, atol=1e-12)


def _jax_structure(spec, x0):
  """The port's detected structure of spec as the JAX package's
  SpecStructure."""
  st = sparsity.detect_structure(spec, x0)
  return jsparsity.SpecStructure(f_rows=st.f_rows, h_cols=st.h_cols,
                                 g_cols=st.g_cols)


def _j_entry(jspec, st, x0, P0, q, R, zs, dts):
  """JAX's entry_step_slab under jit over the steps, with the structure
  st: (x (4, B), P)."""
  step = jax.jit(lambda x, P, z, dt: jentry.entry_step_slab(
      jspec, 1, {}, x, P, z, tuple(float(v) for v in q),
      tuple(tuple(float(v) for v in row) for row in R), dt, st)[:2])
  x, P = jnp.asarray(x0.T), jnp.asarray(P0)
  for t in range(len(dts)):
    x, P = step(x, P, jnp.asarray(zs[t].T), jnp.asarray(dts[t]))
  return np.asarray(x), np.asarray(P)


@needs_compiler
@pytest.mark.parametrize("name", sorted(us.OPS))
def test_op_matches_jax_entry_slab_and_plain(name):
  """Kernel 4's body of a spec using the op, emitted and built as double,
  T = 10 steps of a bank of 8: against the port's plain version and JAX's
  lane path with the op in f and h, and against JAX's entry_step_slab
  (its twin) as far as JAX's emitter runs it right."""
  x0, P0, q, R, zs, dts = _op_case(sorted(us.OPS).index(name))

  def host(spec):
    return run_host("single", spec, (1,), x0.T, P0, np.swapaxes(zs, 1, 2),
                    dts, Q=np.diag(q), R_list=(R,),
                    structure=sparsity.detect_structure(spec, us.OP_X0))

  spec = us.op_spec(name)
  ours = host(spec)
  plain = generic_scan.generic_bank_scan(
      t64(x0.T), t64(P0), t64(np.swapaxes(zs, 1, 2)), t64(dts), spec=spec,
      kind=1, Q=np.diag(q), R=R)
  _close(ours, np_(plain[0]), np_(plain[1]))
  xl, Pl = jlane.lane_bank_scan(
      _j_op_spec(name), 1, {}, jnp.asarray(x0), jnp.asarray(P0),
      jnp.asarray(np.diag(q)), jnp.asarray(dts), jnp.asarray(zs),
      jnp.asarray(R))
  _close(ours, np.asarray(xl).T, np.asarray(Pl))

  in_h = name not in J_ENTRY_F_ONLY
  if not in_h:
    ours = host(us.op_spec(name, in_h=False))
  xj, Pj = _j_entry(_j_op_spec(name, in_h),
                    _jax_structure(us.op_spec(name, in_h), us.OP_X0), x0,
                    P0, q, R, zs, dts)
  if name in J_ENTRY_OFF:   # JAX's fault, not the port's: see above
    assert np.abs(xj - np_(ours[0])).max() > 1e-3
  else:
    _close(ours, xj, Pj)


@needs_compiler
@pytest.mark.parametrize("name,zero", [("norm", [0, 1, 2]),
                                       ("hypot", [0, 1, 2, 3])])
def test_op_at_a_zero_argument_matches_eager(name, zero):
  """Where a structural zero meets a division: norm's jvp at a zero vector
  (aten masks it to 0) and hypot's at (0, 0) (0/0, NaN) give what eager
  torch gives, on every lane whose argument is zero at the first step."""
  spec = us.op_spec(name)
  x0, P0, q, R, zs, dts = _op_case(1, T=1)
  x0[::2][:, zero] = 0.0
  st = sparsity.detect_structure(spec, us.OP_X0)
  ours = run_host("single", spec, (1,), x0.T, P0, np.swapaxes(zs, 1, 2),
                  dts, Q=np.diag(q), R_list=(R,), structure=st)
  plain = generic_scan.generic_bank_scan(
      t64(x0.T), t64(P0), t64(np.swapaxes(zs, 1, 2)), t64(dts), spec=spec,
      kind=1, Q=np.diag(q), R=R)
  assert np.isnan(np_(plain[1])).any() == (name == "hypot")
  _close(ours, np_(plain[0]), np_(plain[1]))


def test_op_without_a_rule_still_raises():
  """No fallback evaluates the real op: torch.prod in a spec raises at
  emission and names the op."""
  spec = us.op_spec("mean")
  bad = type(spec)(name="op_prod", dim_x=4, dim_err=4,
                   f=lambda params, x, dt: x + dt * torch.prod(x),
                   obs=spec.obs)
  with pytest.raises(NotImplementedError, match="prod"):
    entry_slab.emit_source(bad, "single", ((1, False),),
                           sparsity.dense_structure(bad), (), (), ())


# ----------------------------------------------------------- the battery

def _jheading(x):
  return jnp.stack([jnp.cos(x[3]), jnp.sin(x[3]), jnp.tanh(x[5]) / 10])


def _j_battery_spec():
  """The JAX twin of user_specs.battery_spec()."""

  def f(params, x, dt):
    p, psi, v, w = x[0:3], x[3], x[4], x[5:8]
    p = p + dt * v * _jheading(x)
    psi = jnp.remainder(psi + dt * w[1], 2.0 * math.pi)
    drag = 0.05 * jnp.abs(v) * jax.nn.sigmoid(w[2])
    v = v + dt * (jax.nn.softplus(w[0]) - math.log(2.0) - drag)
    dw = (-0.7 * w + 0.5 * jnp.mean(w) + 0.05 * jnp.flip(w, 0)
          + 0.02 * jnp.cumsum(jnp.roll(w, 1), 0))
    return jnp.concatenate([p, psi[None], v[None], w + dt * dw])

  def h_range(params, x, ea):
    return jnp.linalg.norm(x[0:3] - ea)[None]

  def h_bearing(params, x, ea):
    # hypot written out: JAX's structure detection raises on jnp.hypot in
    # h; and its fmod is right only where rel >= 0, which the tests'
    # battery data hold (_battery_step_data)
    rel = jnp.arctan2(x[1], x[0]) - x[3]
    return jnp.stack([jnp.fmod(rel, 2.0 * math.pi),
                      jnp.sqrt(x[0] * x[0] + x[1] * x[1])])

  def h_cross(params, x, ea):
    return jnp.cross(0.1 * x[0:3], _jheading(x))

  return JSpec(name="battery", dim_x=8, dim_err=8, f=f, obs={
      us.RANGE: JObs(kind=us.RANGE, h=h_range, dz=1, ea_dim=0, ea_len=3,
                     maha_test=True),
      us.BEARING: JObs(kind=us.BEARING, h=h_bearing, dz=2),
      us.CROSS: JObs(kind=us.CROSS, h=h_cross, dz=3)})


B_BAT, T_BAT = 16, 8


def _battery_bank(rng):
  x0 = us.BATTERY_X0 + np.concatenate(
      [2.0 * rng.randn(B_BAT, 3), 0.1 * rng.randn(B_BAT, 5)], axis=1)
  P0 = np.tile(np.diag(us.BATTERY_P_DIAG)[:, :, None], (1, 1, B_BAT))
  return x0, P0


def _battery_step_data(rng, truth, kind):
  """(z (B, dz), ea (B, 3)) of one step of `kind`: an anchor about 50 m
  from each lane for a range (every 4th lane's range 30 m off, for the
  gate). The bearing's argument stays positive (see h_bearing)."""
  assert (torch.atan2(truth[:, 1], truth[:, 0]) > truth[:, 3]).all()
  ea = truth[:, :3] + torch.as_tensor(50.0 * rng.randn(B_BAT, 3))
  z = us.measure(us.battery_spec(), kind, truth, us.BATTERY_R[kind], rng,
                 ea if kind == us.RANGE else None)
  if kind == us.RANGE:
    z[::4] += 30.0
  return z.numpy(), ea.numpy()


@needs_compiler
def test_battery_mixed_matches_jax_kernel():
  """Kernel 6's body over the battery's three kinds (range gated, with
  its per-lane anchor in the ea stream) against JAX's
  generic_bank_scan_mixed in interpret mode."""
  rng = np.random.RandomState(31)
  x0, P0 = _battery_bank(rng)
  truth = us.simulate(us.battery_spec(), x0, us.BATTERY_Q, T_BAT, 0.05, rng)
  kinds = us.BATTERY_KINDS
  kind_idx = np.arange(T_BAT) % 3
  zs, eas = np.zeros((T_BAT, B_BAT, 3)), np.zeros((T_BAT, B_BAT, 3))
  for t in range(T_BAT):
    z, ea = _battery_step_data(rng, truth[t + 1], kinds[kind_idx[t]])
    zs[t, :, :z.shape[1]] = z
    eas[t] = ea
  dts = np.full(T_BAT, 0.05)
  R_list = [us.BATTERY_R[k] for k in kinds]
  jspec = _j_battery_spec()
  xp, Pp = pallas_bank.pack_bank(jnp.asarray(x0), jnp.asarray(P0))
  xo, Po = pallas_bank.generic_bank_scan_mixed(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      jnp.asarray(dts), jnp.asarray(kind_idx, jnp.int32),
      pallas_bank.pack_bank_measurements(jnp.asarray(eas)), spec=jspec,
      kinds=kinds, q_diag=tuple(np.diag(us.BATTERY_Q)),
      r_mats=tuple(tuple(tuple(r) for r in R) for R in R_list), t_chunk=4,
      tile_b=8, interpret=True,
      structure=_jax_structure(us.battery_spec(), us.BATTERY_X0))
  spec = us.battery_spec()
  ours = run_host(
      "mixed", spec, kinds, x0.T, P0, np.swapaxes(zs, 1, 2), dts,
      Q=us.BATTERY_Q, R_list=R_list,
      structure=sparsity.structure_for(spec, us.BATTERY_X0),
      eas=np.swapaxes(eas, 1, 2), kind_idx=kind_idx)
  x, P = interop.bank_from_jax(xo, Po, torch.float64)
  _close(ours, np_(x), np_(P))


@needs_compiler
def test_battery_epoch_matches_jax_kernel():
  """Kernel 5's body: epochs of 2 ranges (gated, each slot with its own
  anchor), a bearing and a cross, against JAX's generic_bank_scan_epoch
  in interpret mode."""
  rng = np.random.RandomState(32)
  x0, P0 = _battery_bank(rng)
  truth = us.simulate(us.battery_spec(), x0, us.BATTERY_Q, T_BAT, 0.05, rng)
  slots = (us.RANGE, us.RANGE, us.BEARING, us.CROSS)
  zs = np.zeros((T_BAT, len(slots), B_BAT, 3))
  eas = np.zeros((T_BAT, len(slots), B_BAT, 3))
  for t in range(T_BAT):
    for k, kind in enumerate(slots):
      z, ea = _battery_step_data(rng, truth[t + 1], kind)
      zs[t, k, :, :z.shape[1]] = z
      eas[t, k] = ea
  dts = np.full(T_BAT, 0.05)
  R_list = [us.BATTERY_R[k] for k in slots]
  jspec = _j_battery_spec()
  xp, Pp = pallas_bank.pack_bank(jnp.asarray(x0), jnp.asarray(P0))
  zs_p = pallas_bank.pack_bank_epochs(jnp.asarray(zs))
  eas_p = pallas_bank.pack_bank_epochs(jnp.asarray(eas))
  xo, Po = pallas_bank.generic_bank_scan_epoch(
      xp, Pp, zs_p, jnp.asarray(dts), eas_p, spec=jspec, slot_kinds=slots,
      q_diag=tuple(np.diag(us.BATTERY_Q)),
      r_mats=tuple(tuple(tuple(r) for r in R) for R in R_list), t_chunk=4,
      tile_b=8, interpret=True, slot_mode="unroll",
      structure=_jax_structure(us.battery_spec(), us.BATTERY_X0))
  spec = us.battery_spec()
  ours = run_host(
      "epoch", spec, slots, x0.T, P0,
      interop.stream_from_jax(zs_p, torch.float64), dts, Q=us.BATTERY_Q,
      R_list=R_list, structure=sparsity.structure_for(spec, us.BATTERY_X0),
      eas=interop.stream_from_jax(eas_p, torch.float64))
  x, P = interop.bank_from_jax(xo, Po, torch.float64)
  _close(ours, np_(x), np_(P))
