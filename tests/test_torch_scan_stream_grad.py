"""Gradients through the offline log scan (runtime/scan.py scan_fn): the
port's against jax.grad of the JAX package's scan_fn, and kernel 10 (the
adjoint of kernel 9, emitted mode "stream_adjoint", ops/adjoint.py around
csrc/stream_adjoint.cuh) against both.

Six logs, float64, B <= 8 lanes, T <= 32 steps, inputs from a numpy seed:
the live spec's ECEF_POS / NO_ROT log; the same with every kind's gate on
and every fourth lane's positions 100 m off (the gate rejects them); the
two-kind live log of dz 3 and dz 1 (ECEF_POS and ODOMETRIC_SPEED: padded
slots); the kinematic one-kind log; the car spec's two kinds with its
params (their gradients too); and the op battery of models/user_specs.py
(a gated range to a per-step anchor in the extra args, a bearing, a cross
product; remainder, atan2, fmod, hypot, tanh, sigmoid, softplus, abs in
its f and h), against its JAX twin in tests/test_torch_random_specs.py.
The live logs start from the state the plain version reaches in WARM steps
of the same log. The loss is a seeded random weighting of all six outputs
(final x and P, every step's predicted and posterior x and P), the
gradients those of x0, P0, Q, dts, zs, Rs, eas and the params.

(a) autograd through the port's scan_fn on CPU tensors (the plain loop)
equals jax.grad to rtol 1e-8. (b) kernel 10's host build (the emitted
adjoint built by the host C++ compiler as double, entry
rn_generic_stream_adjoint_host, on the plain loop's stacks; the design
the card builds in double: the tile form for the kinematic, car and
battery logs, whose tile fits a block, the global form for the live
ones; tests/test_torch_scan_stream_adjoint_tile.py holds both forms of
every log) matches
jax.grad and the plain loop within ADJ_TOL of each gradient's largest
entry. (c) the card's route (the custom op rednose::scan_stream, its vmap
rule and its autograd rule, the op rednose::scan_stream_backward) on CPU
tensors, the launchers replaced by CPU stand-ins (the plain scan for
kernel 9, the host build for kernel 10): one backward launch for a
vmapped bank of 4 logs, its shared inputs' gradients the sums of the
per-log ones, and create_graph=True and torch.func.jvp raise by name.

P, Q and R are read as symmetric matrices by the kernels (upper entries),
so the port's gradients of them are symmetric and JAX's (of a function
that reads every entry) are not: on symmetric directions the two agree,
so the tests compare symmetric parts, G + G^T. The kernel reads R only
in each kind's leading dz x dz block: its gradient is exactly 0 on the
padded slots, where JAX's is ~1e-24 (PAD_R); held there to an absolute
bound. This file imports JAX only in a try."""

import ctypes
import dataclasses
import functools
import pathlib
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.func import vmap

try:  # the card's machine has no JAX
  import jax
  import jax.numpy as jnp
  from rednose_tpu.models.car import CarKalman as JCar
  from rednose_tpu.models.kinematic import KinematicKalman as JKinematic
  from rednose_tpu.models.live import LiveKalman as JLive
  from rednose_tpu.runtime import scan as jscan
except ImportError:
  jax = jnp = JCar = JKinematic = JLive = jscan = None
from rednose_tpu_torch.models import user_specs as us
from rednose_tpu_torch.models.car import CarKalman
from rednose_tpu_torch.models.kinematic import (
    KinematicKalman,
    ObservationKind as KK,
)
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.ops import generic_scan
from rednose_tpu_torch.runtime import scan
from rednose_tpu_torch.runtime.live_bank import gated_live_spec
from torch_parity import host_compiler

CSRC = pathlib.Path(__file__).resolve().parents[1] / "rednose_tpu_torch" / \
    "csrc"
# kernel 10's host build against jax.grad and the plain loop, relative to
# each gradient's largest entry: measured at most 1.7e-13 (the car log's
# dts and P0; the live logs 6.8e-14, the kinematic 4.3e-15)
ADJ_TOL = 1e-7
# the plain loop against jax.grad: rtol 1e-8, and an absolute floor of
# 1e-12 of the gradient's largest entry for entries that cancel to ~0
# (measured at most 1e-13 of the largest entry)
RTOL, FLOOR = 1e-8, 1e-12
# JAX's gradient of R on the padded slots, where the kernel's is 0:
# measured 5.8e-27
PAD_ABS = 1e-15
# the card's route: a bank's shared-input gradients against the sums of
# its logs' own, relative to the largest entry (summation order only)
SUM_TOL = 1e-12
WARM = 32
FAMILIES = ("live", "gated_outliers", "dz3_and_dz1", "kinematic", "car",
            "battery")
NAMES = ("x0", "P0", "Q", "dts", "zs", "Rs", "eas", "params")
SYMMETRIC = ("P0", "Q", "Rs")


def _gated(spec):
  return dataclasses.replace(spec, obs={
      k: dataclasses.replace(om, maha_test=True)
      for k, om in spec.obs.items()})


def _live_log(kinds, T, B, seed):
  """tests/test_torch_scan_stream_kernel.live_log: the live log from the
  prior, x0 moving at 1 m/s on each axis."""
  from test_torch_scan_stream_kernel import live_log

  return live_log(kinds, T, B, seed)


def _warm(spec, kinds, Q, log, far=False):
  """The log after WARM steps of the plain version, which it starts from;
  with far, every fourth lane's positions 100 m off in the kept steps."""
  x0, P0, dts, ki, zs, Rs, eas = log
  if far:
    zs = zs.copy()
    zs[WARM::2, ::4] += 100.0
  plain, _ = scan.build_scan_stream_reference(spec, kinds)
  t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
  (x, P), _ = vmap(lambda xl, Pl, zl: plain(
      {}, xl, Pl, t(Q), t(dts[:WARM]), ki[:WARM], zl, t(Rs[:WARM]),
      t(eas[:WARM])), in_dims=(0, 0, 1))(t(x0), t(P0), t(zs[:WARM]))
  return (x.numpy(), P.numpy(), dts[WARM:], ki[WARM:], zs[WARM:], Rs[WARM:],
          eas[WARM:])


def _battery_log(T, B, seed):
  """The battery's three kinds in turn from a bank around its x0, on data
  measured from a truth simulated from each lane's estimate; the range's
  anchor (the step's extra args, shared by the lanes) ~50 m away, every
  fourth lane's range 30 m off (the gate). The bearing's argument stays
  positive (see tests/test_torch_random_specs.py h_bearing)."""
  rng = np.random.RandomState(seed)
  spec = us.battery_spec()
  x0 = us.BATTERY_X0 + np.concatenate(
      [2.0 * rng.randn(B, 3), 0.1 * rng.randn(B, 5)], axis=1)
  P0 = np.tile(np.diag(us.BATTERY_P_DIAG), (B, 1, 1))
  truth = us.simulate(spec, x0, us.BATTERY_Q, T, 0.05, rng)
  ki = (np.arange(T) % 3).astype(np.int32)
  zs, Rs, eas = np.zeros((T, B, 3)), np.zeros((T, 3, 3)), np.zeros((T, 3))
  for t in range(T):
    k = us.BATTERY_KINDS[ki[t]]
    tr = truth[t + 1]
    assert (torch.atan2(tr[:, 1], tr[:, 0]) > tr[:, 3]).all()
    eas[t] = tr[0, :3].numpy() + 50.0 * rng.randn(3)
    ea = torch.as_tensor(np.tile(eas[t], (B, 1)))
    z = us.measure(spec, k, tr, us.BATTERY_R[k], rng,
                   ea if k == us.RANGE else None).numpy()
    if k == us.RANGE:
      z[::4] += 30.0
    zs[t, :, :z.shape[1]] = z
    dz = z.shape[1]
    Rs[t] = scan.PAD_R * np.eye(3)
    Rs[t, :dz, :dz] = us.BATTERY_R[k]
  return x0, P0, np.full(T, 0.05), ki, zs, Rs, eas


@functools.lru_cache(maxsize=None)
def family(name):
  """(spec, JAX spec, kinds, Q, params, log (x0 (B, dx), P0 (B, de, de),
  dts, kind_idx, zs (T, B, max_dz), Rs (T, max_dz, max_dz), eas))."""
  if name in ("live", "gated_outliers", "dz3_and_dz1"):
    kinds = ((K.ECEF_POS, K.ODOMETRIC_SPEED) if name == "dz3_and_dz1"
             else (K.ECEF_POS, K.NO_ROT))
    spec, jspec = LiveKalman.build_spec(), JLive.build_spec()
    if name == "gated_outliers":
      spec, jspec = gated_live_spec(), _gated(jspec)
    log = _warm(spec, kinds, LiveKalman.Q, _live_log(kinds, WARM + 16, 4, 3),
                far=name == "gated_outliers")
    return spec, jspec, kinds, LiveKalman.Q, {}, log
  if name == "kinematic":
    rng = np.random.RandomState(4)
    T, B = 32, 6
    x0 = np.tile(KinematicKalman.initial_x, (B, 1))
    P0 = np.tile(np.diag(KinematicKalman.initial_P_diag), (B, 1, 1))
    log = (x0, P0, 0.005 + 0.01 * rng.rand(T), np.zeros(T, np.int32),
           0.3 * rng.randn(T, B, 1),
           np.tile(KinematicKalman.obs_noise[KK.POSITION], (T, 1, 1)),
           np.zeros((T, 1)))
    return (KinematicKalman.build_spec(), JKinematic.build_spec(),
            (KK.POSITION,), KinematicKalman.Q, {}, log)
  if name == "car":
    rng = np.random.RandomState(6)
    T, B = 24, 4
    kinds = tuple(sorted(CarKalman.obs_noise))
    x0 = CarKalman.initial_x + 0.1 * rng.randn(B, 5)
    P0 = np.tile(np.diag(CarKalman.initial_P_diag), (B, 1, 1))
    ki = (np.arange(T) % 2).astype(np.int32)
    zs = 0.05 * rng.randn(T, B, 1)
    zs[::2, ::4] += 3.0     # a yaw rate the gate rejects
    Rs = np.stack([CarKalman.obs_noise[kinds[i]] for i in ki])
    params = {k: float(v) + 0.01 * rng.randn() * abs(float(v))
              for k, v in CarKalman.build_spec().default_params.items()}
    log = (x0, P0, np.full(T, 0.01), ki, zs, Rs, np.zeros((T, 1)))
    return (CarKalman.build_spec(), JCar.build_spec(), kinds, CarKalman.Q,
            params, log)
  from test_torch_random_specs import _j_battery_spec

  return (us.battery_spec(), _j_battery_spec(), us.BATTERY_KINDS,
          us.BATTERY_Q, {}, _battery_log(24, 4, 31))


def _weights(spec, log, seed=11):
  """A random weighting of the six outputs, in scan_fn's vmapped layout:
  x (B, dx), P (B, de, de), x_preds (B, T, dx), P_preds (B, T, de, de),
  x_posts, P_posts."""
  x0, dts = log[0], log[2]
  B, T, dx, de = x0.shape[0], len(dts), spec.dim_x, spec.dim_err
  rng = np.random.RandomState(seed)
  return [rng.randn(*s) for s in ((B, dx), (B, de, de), (B, T, dx),
                                  (B, T, de, de), (B, T, dx),
                                  (B, T, de, de))]


def plain_grads(name):
  """Autograd through the port's scan_fn on CPU tensors (the plain loop),
  vmapped over the lanes. Returns (grads by NAMES, the six outputs)."""
  spec, _, kinds, Q, params, log = family(name)
  x0, P0, dts, ki, zs, Rs, eas = log
  t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
  ins = [t(a).requires_grad_() for a in (x0, P0, Q, dts, zs, Rs, eas)]
  prm = {k: t(v).requires_grad_() for k, v in params.items()}
  fn, _ = scan.build_scan_stream(spec, kinds)
  X0, PP0, QQ, DT, ZS, RR, EA = ins
  (x, P), stacks = vmap(lambda xl, Pl, zl: fn(prm, xl, Pl, QQ, DT, ki, zl,
                                              RR, EA),
                        in_dims=(0, 0, 1))(X0, PP0, ZS)
  outs = (x, P, *stacks)
  loss = sum((o * t(w)).sum() for o, w in zip(outs, _weights(spec, log)))
  keys = sorted(prm)
  g = torch.autograd.grad(loss, ins + [prm[k] for k in keys],
                          allow_unused=True)
  g = [torch.zeros_like(a) if d is None else d
       for d, a in zip(g, ins + [prm[k] for k in keys])]
  grads = dict(zip(NAMES[:7], (d.numpy() for d in g[:7])))
  grads["params"] = np.array([float(d) for d in g[7:]])
  return grads, [o.detach().numpy() for o in outs]


def jax_grads(name):
  spec, jspec, kinds, Q, params, log = family(name)
  x0, P0, dts, ki, zs, Rs, eas = log
  jfn, _ = jscan.build_scan_stream(jspec, kinds)
  W = [jnp.asarray(w) for w in _weights(spec, log)]
  keys = sorted(params)

  def loss(x0, P0, Q, dts, zs, Rs, eas, pv):
    prm = dict(zip(keys, pv))
    (x, P), stacks = jax.vmap(
        lambda xl, Pl, zl: jfn(prm, xl, Pl, Q, dts, jnp.asarray(ki), zl, Rs,
                               eas), in_axes=(0, 0, 1),
        out_axes=((0, 0), (0, 0, 0, 0)))(x0, P0, zs)
    return sum(jnp.sum(o * w) for o, w in zip((x, P, *stacks), W))

  a = jnp.asarray
  g = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(
      a(x0), a(P0), a(Q), a(dts), a(zs), a(Rs), a(eas),
      [a(params[k]) for k in keys])
  grads = {n: np.asarray(v) for n, v in zip(NAMES[:7], g[:7])}
  grads["params"] = np.array([float(v) for v in g[7]])
  return grads


# ------------------------------------------------- kernel 10's host build

def _build(source):
  d = pathlib.Path(tempfile.mkdtemp(prefix="rn_adjoint_host_"))
  (d / "gen.cu").write_text(source)
  proc = subprocess.run(
      [host_compiler(), "-x", "c++", "-std=c++17", "-O0", "-shared", "-fPIC",
       "-I", str(CSRC), "-o", str(d / "lib.so"), str(d / "gen.cu")],
      capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-4000:]
  fn = ctypes.CDLL(str(d / "lib.so")).rn_generic_stream_adjoint_host
  fn.argtypes = [ctypes.c_void_p] * 28 + [ctypes.c_int] * 2
  fn.restype = ctypes.c_int
  return fn


def _adjoint_call(spec, kinds, Q, params):
  """The 'stream_adjoint' KernelCall that the custom op's backward takes
  for this log (runtime/scan._kernel_call)."""
  from rednose_tpu_torch.ops import entry_slab

  return scan._kernel_call(scan._handle(spec, kinds, tuple(sorted(params))),
                           entry_slab.q_pattern_of(Q), "stream_adjoint")


_LIBS = {}


def host_adjoint(call, source=None):
  """rn_generic_stream_adjoint_host of a 'stream_adjoint' call (or of the
  source given), built once as double (every family's at once, in
  parallel, at the first call)."""
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted adjoint")
  if not _LIBS:
    calls = [_adjoint_call(f[0], f[2], f[3], f[4])
             for f in map(family, FAMILIES)]
    srcs = list(dict.fromkeys(c.source(torch.float64) for c in calls))
    with ThreadPoolExecutor(len(srcs)) as pool:
      _LIBS.update(zip(srcs, pool.map(_build, srcs)))
  src = call.source(torch.float64) if source is None else source
  if src not in _LIBS:
    _LIBS[src] = _build(src)
  return _LIBS[src]


def launch_host(call, x0, P0, zs, dts, kind_idx, Rs, eas, prm, Q, xp, Pp,
                xq, Pq, gx, gP, gxp, gPp, gxq, gPq, source=None):
  """ops/generic_scan.stream_bank_scan_adjoint's work on CPU tensors
  (float64, the launcher's layouts) through the host build (of the call's
  float64 source, or of the source given): the launcher's outputs, and the
  per-lane gate-flip counts."""
  spec, kinds = call.spec, call.kinds
  T, B = dts.shape[0], x0.shape[-1]
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  dx, de = spec.dim_x, spec.dim_err
  new = lambda *s: torch.zeros(s, dtype=torch.float64)  # noqa: E731
  out = (new(dx, B), new(de, de, B), new(T, max_dz, B),
         new(T, max_dz, max_dz, B), new(T, B),
         new(T, max_ea, B) if max_ea else None, new(de, de, B),
         new(prm.shape[0], B))
  flips = torch.zeros(B, dtype=torch.int32)
  ins = [a.contiguous() if a is not None else None
         for a in (x0, P0, zs, eas, dts, kind_idx.to(torch.int32), Rs, prm,
                   Q, xp, Pp, xq, Pq, gx, gP, gxp, gPp, gxq, gPq)]
  ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
  assert host_adjoint(call, source)(*(ptr(a) for a in (*ins, *out, flips)),
                                    T, B) == 0
  return out, flips


def _sym(a):
  return (a + np.swapaxes(a, -1, -2)) / 2


def kernel_grads(name, source=None):
  """Kernel 10's host build (of the family's float64 source, or of the
  source given) on the plain loop's stacks of the family's log: the
  gradients by NAMES (the launcher's per-lane outputs summed over the
  lanes and symmetrized, as the custom op's backward does) and the
  gate-flip count."""
  spec, _, kinds, Q, params, log = family(name)
  x0, P0, dts, ki, zs, Rs, eas = log
  _, outs = plain_grads(name)
  W = _weights(spec, log)
  keys = tuple(sorted(params))
  call = _adjoint_call(spec, kinds, Q, params)
  t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa
  bm = lambda a: t(a).permute(*range(1, a.ndim), 0).contiguous()  # noqa
  T, B = len(dts), x0.shape[0]
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  eas_b = (t(eas)[:, :max_ea, None].expand(T, max_ea, B)
           if max_ea else None)
  prm = t([params[k] for k in keys] or [0.0])
  (dx0, dP0, dzs, dRs, ddts, deas, dQ, dprm), flips = launch_host(
      call, bm(x0), bm(P0), t(zs).transpose(1, 2), t(dts),
      torch.as_tensor(ki), t(Rs), eas_b, prm, t(Q), *(bm(o) for o in outs[2:]),
      *(bm(w) for w in W), source=source)
  g_eas = np.zeros_like(eas)
  if deas is not None:
    g_eas[:, :max_ea] = deas.sum(-1).numpy()
  grads = {"x0": dx0.T.numpy(), "P0": _sym(dP0.permute(2, 0, 1).numpy()),
           "Q": _sym(dQ.sum(-1).numpy()), "dts": ddts.sum(-1).numpy(),
           "zs": dzs.transpose(1, 2).numpy(), "Rs": _sym(dRs.sum(-1).numpy()),
           "eas": g_eas, "params": dprm.sum(-1).numpy()[:len(keys)]}
  return grads, int(flips.sum())


@functools.lru_cache(maxsize=None)
def results(name):
  return plain_grads(name)[0], jax_grads(name), kernel_grads(name)


def _block_mask(name):
  """Per step, True on the kind's leading dz x dz block of Rs and its dz
  rows of zs: the entries the kernels read."""
  spec, _, kinds, _, _, log = family(name)
  ki, Rs = log[3], log[5]
  rmask, zmask = np.zeros(Rs.shape, bool), np.zeros(
      (len(ki), log[4].shape[2]), bool)
  for t, i in enumerate(ki):
    dz = spec.obs[kinds[i]].dz
    rmask[t, :dz, :dz] = True
    zmask[t, :dz] = True
  return rmask, zmask


def _compared(name, grads):
  """The gradients as compared: P0's, Q's and Rs's symmetric parts."""
  return {k: (v + np.swapaxes(v, -1, -2) if k in SYMMETRIC else v)
          for k, v in grads.items()}


def rel_errs(name, a, b):
  """max |a - b| over max |b|, per gradient, on the entries the kernels
  read (Rs on each step's block, zs on its rows)."""
  rmask, zmask = _block_mask(name)
  a, b = _compared(name, a), _compared(name, b)
  out = {}
  for k in NAMES:
    u, v = a[k], b[k]
    if k == "Rs":
      u, v = u[rmask], v[rmask]
    if k == "zs":
      m = np.broadcast_to(zmask[:, None, :], u.shape)
      u, v = u[m], v[m]
    if v.size == 0 or not np.abs(v).max():
      out[k] = float(np.abs(u).max()) if u.size else 0.0
      continue
    out[k] = float(np.abs(u - v).max() / np.abs(v).max())
  return out


@pytest.mark.parametrize("name", FAMILIES)
def test_plain_gradient_equals_jax(name):
  """(a) Autograd through the port's scan_fn on CPU tensors (the plain
  loop) against jax.grad of the JAX package's scan_fn, every floating
  input, rtol 1e-8 (P, Q, R: symmetric parts)."""
  plain, jx, _ = results(name)
  plain, jx = _compared(name, plain), _compared(name, jx)
  for k in NAMES:
    np.testing.assert_allclose(
        plain[k], jx[k], rtol=RTOL,
        atol=FLOOR * float(np.abs(jx[k]).max(initial=0.0)), err_msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_kernel10_host_build_matches_jax_and_plain(name):
  """(b) Kernel 10's host build against jax.grad and the plain loop on
  the family's log, within ADJ_TOL of each gradient's largest entry; Rs
  off each kind's block exactly 0, and JAX's there within PAD_ABS; no
  gate flip (the recomputed decisions are the stored ones)."""
  plain, jx, (kern, flips) = results(name)
  for ref in (jx, plain):
    errs = rel_errs(name, kern, ref)
    assert max(errs.values()) <= ADJ_TOL, errs
  rmask, zmask = _block_mask(name)
  assert not kern["Rs"][~rmask].any()
  assert not np.abs(_sym(jx["Rs"])[~rmask]).max(initial=0.0) > PAD_ABS
  assert not kern["zs"][np.broadcast_to(~zmask[:, None, :],
                                        kern["zs"].shape)].any()
  assert flips == 0
  if name in ("gated_outliers", "car", "battery"):
    # the gate rejected some steps (P left exactly as predicted): their
    # adjoint passes through the update
    _, outs = plain_grads(name)
    diag = lambda a: np.diagonal(a, axis1=-2, axis2=-1)  # noqa: E731
    assert (diag(outs[3]) == diag(outs[5])).all(axis=-1).any()


# ------------------------------------------- the card's route, on the CPU

def _route(monkeypatch):
  """The launchers of kernels 9 and 10 replaced by CPU stand-ins (the
  plain scan, tests/test_torch_scan_stream_kernel._stand_in; kernel 10's
  host build): returns the lists of the bank widths they were called on."""
  from test_torch_scan_stream_kernel import _stand_in

  fwd, adj = [], []

  def adjoint(call, *args):
    adj.append(args[0].shape[-1])
    out, adjoint.gate_flips = launch_host(call, *args)
    return out

  monkeypatch.setattr(generic_scan, "stream_bank_scan", _stand_in(fwd))
  monkeypatch.setattr(generic_scan, "stream_bank_scan_adjoint", adjoint)
  return fwd, adj


def _op_inputs(name="live"):
  spec, _, kinds, Q, _, log = family(name)
  t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
  x0, P0, dts, ki, zs, Rs, eas = log
  ins = [t(a).requires_grad_() for a in (x0, P0, Q, dts, zs, Rs, eas)]
  return spec, kinds, ki, ins, [t(w) for w in _weights(spec, log)]


def test_card_route_backward_is_one_launch_for_a_bank(monkeypatch):
  """(c) The custom op's autograd rule on CPU tensors: a vmapped bank of 4
  logs is one launch of kernel 9 and one of kernel 10 (the host build);
  its gradients equal the plain loop's within ADJ_TOL, and the shared
  inputs' (Q, dts, Rs, eas) equal the sums of the 4 logs' own, each log
  through the op alone, within SUM_TOL."""
  fwd, adj = _route(monkeypatch)
  spec, kinds, ki, ins, W = _op_inputs()
  X0, PP0, QQ, DT, ZS, RR, EA = ins
  (x, P), st = vmap(lambda xl, Pl, zl: scan._kernel_scan(
      spec, kinds, {}, xl, Pl, QQ, DT, ki, zl, RR, EA),
      in_dims=(0, 0, 1))(X0, PP0, ZS)
  loss = sum((o * w).sum() for o, w in zip((x, P, *st), W))
  bank = [g.numpy() for g in torch.autograd.grad(loss, ins)]
  B = X0.shape[0]
  assert fwd == [(spec.dim_x, B)] and adj == [B]
  plain, _ = plain_grads("live")
  errs = rel_errs("live", dict(zip(NAMES, bank + [np.zeros(0)])),
                  dict(plain, params=np.zeros(0)))
  assert max(errs.values()) <= ADJ_TOL, errs
  alone = []
  for b in range(B):
    (x, P), st = scan._kernel_scan(spec, kinds, {}, X0[b], PP0[b], QQ, DT, ki,
                                   ZS[:, b], RR, EA)
    loss = sum((o * w[b]).sum() for o, w in zip((x, P, *st), W))
    alone.append([g.numpy() for g in torch.autograd.grad(loss, ins)])
  assert adj == [B] + [1] * B
  for i, name in enumerate(NAMES[:7]):
    total = sum(a[i] for a in alone)
    scale = np.abs(total).max()
    assert np.abs(bank[i] - total).max() <= SUM_TOL * scale, name


def test_card_route_warns_on_a_gate_flip(monkeypatch):
  """(c) The backward op warns, naming the count, where kernel 10 reports
  lane-steps whose recomputed gate decision differs from the forward's
  (here planted: the host build's counts plus one on lane 0), and is
  silent where it reports none."""
  import warnings

  _route(monkeypatch)
  host = generic_scan.stream_bank_scan_adjoint

  def flipped(call, *args):
    out = host(call, *args)
    flipped.gate_flips = host.gate_flips.clone()
    flipped.gate_flips[0] += 1
    return out

  spec, kinds, ki, ins, _ = _op_inputs("gated_outliers")
  X0, PP0, QQ, DT, ZS, RR, EA = ins

  def grad():
    (x, _), _ = vmap(lambda xl, Pl, zl: scan._kernel_scan(
        spec, kinds, {}, xl, Pl, QQ, DT, ki, zl, RR, EA),
        in_dims=(0, 0, 1))(X0, PP0, ZS)
    return torch.autograd.grad(x.sum(), X0)

  with warnings.catch_warnings():
    warnings.filterwarnings("error", "scan_fn on the card", RuntimeWarning)
    grad()
  monkeypatch.setattr(generic_scan, "stream_bank_scan_adjoint", flipped)
  with pytest.warns(RuntimeWarning, match="at 1 lane-steps kernel 10"):
    grad()


def test_card_route_refuses_higher_order_and_forward_mode(monkeypatch):
  """(c) create_graph=True, a gradient of the backward op
  (rednose::scan_stream_backward), torch.func.jvp, forward-mode AD and
  torch.func.grad raise on the card's route, each naming what it
  lacks."""
  from torch.autograd import forward_ad

  _, adj = _route(monkeypatch)
  spec, kinds, ki, ins, _ = _op_inputs()
  X0, PP0, QQ, DT, ZS, RR, EA = ins

  def run(x):
    return scan._kernel_scan(spec, kinds, {}, x, PP0[0], QQ, DT, ki, ZS[:, 0],
                             RR, EA)

  (x, _), _ = run(X0[0])
  with pytest.raises(NotImplementedError, match="create_graph"):
    torch.autograd.grad(x.sum(), X0, create_graph=True)
  assert adj == []
  # the backward op itself, on one log's inputs and stacks in the op's
  # layout, with an input that requires grad
  handle = scan._handle(spec, kinds, ())
  prm = torch.zeros(1, dtype=torch.float64)
  ki32 = torch.as_tensor(ki, dtype=torch.int32)
  shared = (DT.detach(), ki32, RR.detach(), EA.detach(), QQ.detach(), prm)
  out = torch.ops.rednose.scan_stream(X0[:1].detach(), PP0[:1].detach(),
                                      ZS[:, :1].detach(), *shared, handle)
  xd = X0[:1].detach().clone().requires_grad_()
  grads = torch.ops.rednose.scan_stream_backward(
      xd, PP0[:1].detach(), ZS[:, :1].detach(), *shared, *out[2:],
      *(torch.ones_like(a) for a in out), handle)
  with pytest.raises(NotImplementedError, match="a gradient of kernel 10"):
    grads[0].sum().backward()
  tangent = torch.ones_like(X0[0])
  with pytest.raises(NotImplementedError, match="forward mode"):
    torch.func.jvp(lambda v: run(v)[0][0], (X0[0].detach(),), (tangent,))
  with forward_ad.dual_level():
    with pytest.raises(NotImplementedError, match="forward mode"):
      run(forward_ad.make_dual(X0[0].detach(), tangent))
  with pytest.raises(NotImplementedError, match="torch.autograd.grad"):
    torch.func.grad(lambda v: run(v)[0][0].sum())(X0[0].detach())
