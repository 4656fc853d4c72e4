"""Kernel 9, the offline log scan (emitted mode "stream" around
csrc/generic_scan.cuh's REDNOSE_GENERIC_SCAN_STREAM section; wrappers
ops/generic_scan.stream_bank_scan and runtime/scan.build_scan_stream).

On the CPU the stream variant's emitted text in the global form (one
thread a lane; tests/test_torch_scan_stream_tile.py holds the tile form
the port ships) is built with the host C++ compiler as double (entry
rn_generic_stream_host, the kernel's own loop lane by lane) and held,
float64, against the JAX package's
build_scan_stream (one jitted lax.scan, vmapped over the lanes) and the
port's plain scan_fn on the same padded logs: the live spec's ECEF_POS /
NO_ROT log, the same with every kind's gate on and every fourth lane's
positions 100 m off (the gate rejects them), and a two-kind live log of
dz 3 and dz 1 (ECEF_POS and ODOMETRIC_SPEED: the padded R slots and zero
rows), each from the state the plain version reaches in 32 steps of it;
the kinematic spec's one-kind log from its prior. Every step's predicted
and posterior x and P, in standard deviations of the plain result
(utils/compare.py), within 1e-9. From the live prior itself (1e8 m^2 of
position, 10 rad of attitude) the kernel's factored covariance algebra
and the plain scan's dense Joseph form part by ~1e-8 sigma: held there
within 1e-7, the measured values stated in that test.

The card's route through the custom op rednose::scan_stream and its vmap
rule runs here on CPU tensors too, with a stand-in for the launcher
stream_bank_scan (the plain scan in the launcher's bank-minor layout):
under vmap over x, P and zs it equals the plain scan_fn bitwise; a
batched Rs and an input that requires grad raise; the public scan_fn on
CPU tensors runs the plain loop and launches nothing, and the launcher
refuses CPU tensors.

Card-only cases (marked cuda) launch kernel 9 against the plain version;
this file imports JAX only in a try (the card's machine has none):
`python -m pytest tests/test_torch_scan_stream_kernel.py -m cuda
--noconftest`."""

import ctypes
import dataclasses
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest
import torch
from torch.func import vmap

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax
  import jax.numpy as jnp
  from rednose_tpu.models.kinematic import KinematicKalman as JKinematic
  from rednose_tpu.models.live import LiveKalman as JLive
  from rednose_tpu.runtime import scan as jscan
except ImportError:
  jax = jnp = JKinematic = JLive = jscan = None
from rednose_tpu_torch.models.kinematic import (
    KinematicKalman,
    ObservationKind as KK,
)
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.ops import generic_scan
from rednose_tpu_torch.runtime import scan
from rednose_tpu_torch.runtime.live_bank import gated_live_spec
from rednose_tpu_torch.utils.compare import lane_sigma_errs
from torch_parity import cuda_device, host_compiler  # noqa: F401

CSRC = pathlib.Path(__file__).resolve().parents[1] / "rednose_tpu_torch" / \
    "csrc"
TOL = 1e-9
# from the live prior: the covariance algebras part by ~1e-8 sigma (see
# test_host_build_from_the_prior_within_the_covariance_algebra)
PRIOR_TOL = 1e-7
WARM = 32   # steps of the plain version before the held window
_LIBS = {}


def _gated(spec):
  """spec with every kind's Mahalanobis gate on (JAX's or the port's)."""
  return dataclasses.replace(spec, obs={
      k: dataclasses.replace(om, maha_test=True)
      for k, om in spec.obs.items()})


def host_stream(source):
  """rn_generic_stream_host of an emitted float64 source, built once."""
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted stream variant")
  if source not in _LIBS:
    d = pathlib.Path(tempfile.mkdtemp(prefix="rn_stream_host_"))
    (d / "gen.cu").write_text(source)
    proc = subprocess.run(
        [host_compiler(), "-x", "c++", "-std=c++17", "-O1", "-shared",
         "-fPIC", "-I", str(CSRC), "-o", str(d / "lib.so"),
         str(d / "gen.cu")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(d / "lib.so")).rn_generic_stream_host
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    _LIBS[source] = fn
  return _LIBS[source]


def run_host(spec, kinds, Q, x0, P0, dts, ki, zs, Rs, tile=False):
  """The stream variant's host build (its global form, or with tile its
  tile form) on lanes x0 (B, dim_x), P0 (B, de, de), zs (T, B, max_dz),
  the rest shared: (x, P, x_preds, P_preds, x_posts, P_posts) in the
  wrapper's bank-minor layout."""
  call = generic_scan.KernelCall(spec, "stream", kinds, Q=Q)
  fn = host_stream(call.source(torch.float64, tile=tile))
  # copies: the host build writes x and P in place, and at B = 1 the
  # transposes of x0 and P0 are contiguous views of the caller's arrays,
  # which a JAX call dispatched before may still be reading (jnp.asarray
  # of a numpy array on the CPU reads it asynchronously)
  c = lambda a, dt=np.float64: np.array(a, dtype=dt, order="C")  # noqa
  prm = c([float(call.params[k]) for k in call._pnames] or [0.0])
  T, B = len(dts), x0.shape[0]
  x, P = c(x0.T), c(np.transpose(P0, (1, 2, 0)))
  xp, xq = np.zeros((T, spec.dim_x, B)), np.zeros((T, spec.dim_x, B))
  Pp = np.zeros((T, spec.dim_err, spec.dim_err, B))
  Pq = np.zeros_like(Pp)
  args = [x, P, c(np.transpose(zs, (0, 2, 1))), None, c(dts),
          c(ki, np.int32), c(Rs), prm, c(Q), xp, Pp, xq, Pq]
  rc = fn(*[a.ctypes.data if isinstance(a, np.ndarray) else a
            for a in args], T, B)
  assert rc == 0
  return tuple(torch.as_tensor(a) for a in (x, P, xp, Pp, xq, Pq))


def run_plain(fn, Q, x0, P0, dts, ki, zs, Rs, eas):
  """A scan_fn vmapped over the lanes, in the bank-minor layout."""
  t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
  (x, P), (xp, Pp, xq, Pq) = vmap(
      lambda xl, Pl, zl: fn({}, xl, Pl, t(Q), t(dts), ki, zl, t(Rs), t(eas)),
      in_dims=(0, 0, 1))(t(x0), t(P0), t(zs))
  return (x.T, P.permute(1, 2, 0), xp.permute(1, 2, 0),
          Pp.permute(1, 2, 3, 0), xq.permute(1, 2, 0),
          Pq.permute(1, 2, 3, 0))


def run_jax(jspec, kinds, Q, x0, P0, dts, ki, zs, Rs, eas):
  jfn, _ = jscan.build_scan_stream(jspec, kinds)
  a = jnp.asarray
  (x, P), (xp, Pp, xq, Pq) = jax.vmap(
      lambda xl, Pl, zl: jfn({}, xl, Pl, a(Q), a(dts), a(ki), zl, a(Rs),
                             a(eas)))(a(x0), a(P0), a(np.swapaxes(zs, 0, 1)))
  t = lambda v, *perm: torch.as_tensor(np.asarray(v)).permute(*perm)  # noqa
  return (t(x, 1, 0), t(P, 1, 2, 0), t(xp, 1, 2, 0), t(Pp, 1, 2, 3, 0),
          t(xq, 1, 2, 0), t(Pq, 1, 2, 3, 0))


def sigma_err(spec, out, ref):
  """The largest difference of out from ref over the final state and every
  step's predicted and posterior state, in sigmas of ref (state: error
  state over sqrt(P_ii); covariance: correlation units)."""
  pairs = [(out[0], out[1], ref[0], ref[1])]
  for s in (2, 4):
    pairs += [(out[s][t], out[s + 1][t], ref[s][t], ref[s + 1][t])
              for t in range(out[s].shape[0])]
  return max(float(torch.maximum(*lane_sigma_errs(spec, *p)).max())
             for p in pairs)


def live_log(kinds, T, B, seed):
  """A padded live log over `kinds` in turn, B lanes from the prior (x0
  moving at 1 m/s on each axis, so the speed kind is defined): ECEF_POS
  at the start position with noise of 1 m, NO_ROT 1e-4, ODOMETRIC_SPEED
  sqrt(3) + 0.1 noise; each kind's default R. Returns (x0, P0, dts, ki,
  zs (T, B, 3), Rs, eas)."""
  rng = np.random.RandomState(seed)
  x0 = np.tile(LiveKalman.initial_x, (B, 1))
  x0[:, 7:10] = 1.0
  P0 = np.tile(np.diag(LiveKalman.initial_P_diag), (B, 1, 1))
  ki = (np.arange(T) % len(kinds)).astype(np.int32)
  zs, Rs = np.zeros((T, B, 3)), np.zeros((T, 3, 3))
  for t in range(T):
    k = kinds[ki[t]]
    dz = LiveKalman.obs_noise[k].shape[0]
    if k == K.ECEF_POS:
      zs[t] = LiveKalman.initial_x[:3] + rng.randn(B, 3)
    elif k == K.NO_ROT:
      zs[t] = 1e-4 * rng.randn(B, 3)
    else:
      zs[t, :, 0] = np.sqrt(3.0) + 0.1 * rng.randn(B)
    Rs[t] = scan.PAD_R * np.eye(3)
    Rs[t, :dz, :dz] = LiveKalman.obs_noise[k]
  return x0, P0, np.full(T, 0.01), ki, zs, Rs, np.zeros((T, 1))


def _three_ways(spec, jspec, kinds, Q, x0, P0, dts, ki, zs, Rs, eas):
  hk = run_host(spec, kinds, Q, x0, P0, dts, ki, zs, Rs)
  fn, _ = scan.build_scan_stream(spec, kinds)
  pl = run_plain(fn, Q, x0, P0, dts, ki, zs, Rs, eas)
  jx = run_jax(jspec, kinds, Q, x0, P0, dts, ki, zs, Rs, eas)
  return hk, pl, jx


@pytest.mark.parametrize("case", ["ecef_pos_no_rot", "gated_outliers",
                                  "dz3_and_dz1"])
def test_host_build_matches_jax_and_plain_live(case):
  """The live spec's stream variant against JAX's scan and the port's
  plain scan_fn, float64, over 24 steps from the state the plain version
  reaches in WARM steps of the same log from the prior: every stacked
  state within 1e-9 sigma (measured 1e-13). With the gate on, every
  fourth lane's positions are 100 m off in the compared steps, and the
  gate rejects them."""
  kinds = ((K.ECEF_POS, K.ODOMETRIC_SPEED) if case == "dz3_and_dz1"
           else (K.ECEF_POS, K.NO_ROT))
  spec, jspec = LiveKalman.build_spec(), JLive.build_spec()
  if case == "gated_outliers":
    spec, jspec = gated_live_spec(), _gated(jspec)
  x0, P0, dts, ki, zs, Rs, eas = live_log(kinds, WARM + 24, 8, seed=3)
  if case == "gated_outliers":
    zs[WARM::2, ::4] += 100.0
  plain, _ = scan.build_scan_stream_reference(spec, kinds)
  warm = run_plain(plain, LiveKalman.Q, x0, P0, dts[:WARM], ki[:WARM],
                   zs[:WARM], Rs[:WARM], eas[:WARM])
  log = (warm[0].T.numpy(), warm[1].permute(2, 0, 1).numpy(), dts[WARM:],
         ki[WARM:], zs[WARM:], Rs[WARM:], eas[WARM:])
  hk, pl, jx = _three_ways(spec, jspec, kinds, LiveKalman.Q, *log)
  assert sigma_err(spec, hk, pl) <= TOL
  assert sigma_err(spec, hk, jx) <= TOL
  if case == "gated_outliers":
    # the far lanes' positions are rejected: their posterior is their
    # prediction; the near lanes' are not
    xp, xq = hk[2], hk[4]
    assert torch.equal(xp[-2, :, 0], xq[-2, :, 0])
    assert not torch.equal(xp[-2, :, 1], xq[-2, :, 1])


def test_host_build_from_the_prior_within_the_covariance_algebra():
  """From the live prior (1e8 m^2 of position, 10 rad of attitude) the
  emitted factored covariance algebra (P + V + V^T, the factored Joseph)
  and the plain scan's dense Joseph form part by rounding amplified by
  the prior's conditioning: measured 3.1e-9 sigma on this log (and up to
  9.9e-9 on the dz 3 / dz 1 log), against 1e-16 between JAX and the
  plain version, which share the dense form. Held within PRIOR_TOL."""
  kinds = (K.ECEF_POS, K.NO_ROT)
  log = live_log(kinds, 24, 8, seed=3)
  hk, pl, jx = _three_ways(LiveKalman.build_spec(), JLive.build_spec(),
                           kinds, LiveKalman.Q, *log)
  spec = LiveKalman.build_spec()
  assert sigma_err(spec, hk, pl) <= PRIOR_TOL
  assert sigma_err(spec, hk, jx) <= PRIOR_TOL
  assert sigma_err(spec, pl, jx) <= 1e-12


def test_host_build_matches_jax_and_plain_kinematic():
  """The kinematic spec's one-kind log (POSITION, dz 1), float64."""
  spec, jspec = KinematicKalman.build_spec(), JKinematic.build_spec()
  kinds, T, B = (KK.POSITION,), 32, 6
  rng = np.random.RandomState(4)
  x0 = np.tile(KinematicKalman.initial_x, (B, 1))
  P0 = np.tile(np.diag(KinematicKalman.initial_P_diag), (B, 1, 1))
  zs = 0.3 * rng.randn(T, B, 1)
  Rs = np.tile(KinematicKalman.obs_noise[KK.POSITION], (T, 1, 1))
  log = (x0, P0, 0.005 + 0.01 * rng.rand(T), np.zeros(T, np.int32), zs, Rs,
         np.zeros((T, 1)))
  hk, pl, jx = _three_ways(spec, jspec, kinds, KinematicKalman.Q, *log)
  assert sigma_err(spec, hk, pl) <= TOL
  assert sigma_err(spec, hk, jx) <= TOL


def test_stream_variant_refuses_what_it_does_not_take():
  """Mode 'stream' takes R with each step, each kind's own gate and no
  param stream; a camera frame is refused."""
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf

  spec = LiveKalman.build_spec()
  with pytest.raises(ValueError):
    generic_scan.KernelCall(spec, "stream", (K.ECEF_POS,), Q=LiveKalman.Q,
                            R_list=(np.eye(3),))
  with pytest.raises(ValueError):
    generic_scan.KernelCall(spec, "stream", (K.ECEF_POS,), Q=LiveKalman.Q,
                            gate=False)
  with pytest.raises(ValueError):
    generic_scan.KernelCall(MSCKFEskf.build_spec(), "stream", (16,),
                            Q=MSCKFEskf.Q).source()
  call = generic_scan.KernelCall(spec, "stream", (K.ECEF_POS, K.NO_ROT),
                                 Q=LiveKalman.Q)
  src, glob = call.source(), call.source(tile=False)
  assert "#define REDNOSE_GENERIC_SCAN_STREAM" in src
  assert "#define REDNOSE_GENERIC_SCAN_STREAM" in glob
  assert "gen_tile_shared" in src and "gen_step" not in src
  assert "gen_stream_update" in glob and "gen_step" not in glob
  # the launcher takes CUDA tensors only: no plain fallback behind it
  _, _, x0, P0, Q, dts, ki, zs, Rs, _ = _op_case(B=2, T=3)
  with pytest.raises(ValueError, match="CUDA"):
    generic_scan.stream_bank_scan(
        call, x0.T.contiguous(), P0.permute(1, 2, 0).contiguous(),
        zs.transpose(1, 2).contiguous(), dts, torch.as_tensor(ki), Rs, None,
        torch.zeros(1, dtype=torch.float64), Q)


def _op_case(B=4, T=12):
  kinds = (K.ECEF_POS, K.NO_ROT)
  x0, P0, dts, ki, zs, Rs, eas = live_log(kinds, T, B, seed=5)
  t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
  return (LiveKalman.build_spec(), kinds, t(x0), t(P0), t(LiveKalman.Q),
          t(dts), ki, t(zs), t(Rs), t(eas))


def _flat(out):
  (x, P), stacks = out
  return (x, P, *stacks)


def _stand_in(calls):
  """A CPU stand-in for the launcher stream_bank_scan: the plain scan in
  its bank-minor layout, x and P advanced in place; records x's shape."""
  def launch(call, x, P, zs, dts, kind_idx, Rs, eas, prm, Q):
    calls.append(tuple(x.shape))
    plain, _ = scan.build_scan_stream_reference(call.spec, call.kinds)
    params = dict(zip(call._pnames, prm.tolist()))
    T, B = dts.shape[0], x.shape[-1]
    eas = x.new_zeros((T, 1, B)) if eas is None else eas
    (xo, Po), (xp, Pp, xq, Pq) = vmap(
        lambda xl, Pl, zl, el: plain(params, xl, Pl, Q, dts, kind_idx, zl,
                                     Rs, el),
        in_dims=(1, 2, 2, 2))(x, P, zs, eas)
    x.copy_(xo.T)
    P.copy_(Po.permute(1, 2, 0))
    return (xp.permute(1, 2, 0), Pp.permute(1, 2, 3, 0),
            xq.permute(1, 2, 0), Pq.permute(1, 2, 3, 0))

  return launch


def test_card_route_runs_on_cpu_tensors_and_vmaps():
  """The card's route (the custom op and its vmap rule, the launcher
  stream_bank_scan replaced by a CPU stand-in) on CPU tensors: under vmap
  over x, P and zs, and on one log, equal to the plain scan_fn bitwise,
  with one launch for the whole bank; the caller's x and P stay as they
  were."""
  spec, kinds, x0, P0, Q, dts, ki, zs, Rs, eas = _op_case()
  fn, _ = scan.build_scan_stream(spec, kinds)
  ref = vmap(lambda x, P, z: fn({}, x, P, Q, dts, ki, z, Rs, eas),
             in_dims=(0, 0, 1))(x0, P0, zs)
  x_in, P_in = x0.clone(), P0.clone()
  calls = []
  real = generic_scan.stream_bank_scan
  generic_scan.stream_bank_scan = _stand_in(calls)
  try:
    out = vmap(lambda x, P, z: scan._kernel_scan(
        spec, kinds, {}, x, P, Q, dts, ki, z, Rs, eas),
        in_dims=(0, 0, 1))(x0, P0, zs)
    one = scan._kernel_scan(spec, kinds, {}, x0[1], P0[1], Q, dts, ki,
                            zs[:, 1], Rs, eas)
  finally:
    generic_scan.stream_bank_scan = real
  assert calls == [(spec.dim_x, 4), (spec.dim_x, 1)]
  for a, b, c in zip(_flat(out), _flat(ref), _flat(one)):
    assert torch.equal(a, b) and torch.equal(c, b[1])
  assert torch.equal(x0, x_in) and torch.equal(P0, P_in)


def test_card_route_refuses_batched_shared_inputs_and_grad():
  """On the card's route a batched Rs, dts or kind_idx (or eas, Q, a
  param) raises, naming it, and so does an input that requires grad, naming the plain
  loop; the public scan_fn on CPU tensors runs the plain loop (autograd
  through it) and launches nothing."""
  spec, kinds, x0, P0, Q, dts, ki, zs, Rs, eas = _op_case()
  with pytest.raises(ValueError, match="Rs is batched"):
    vmap(lambda x, P, z, R: scan._kernel_scan(
        spec, kinds, {}, x, P, Q, dts, ki, z, R, eas),
        in_dims=(0, 0, 1, 0))(x0, P0, zs, Rs.expand(4, -1, -1, -1))
  with pytest.raises(ValueError, match="dts is batched"):
    vmap(lambda x, d: scan._kernel_scan(
        spec, kinds, {}, x, P0[0], Q, d, ki, zs[:, 0], Rs, eas),
        in_dims=(0, 0))(x0, dts.expand(4, -1))
  with pytest.raises(ValueError, match="kind_idx is batched"):
    vmap(lambda x, k: scan._kernel_scan(
        spec, kinds, {}, x, P0[0], Q, dts, k, zs[:, 0], Rs, eas),
        in_dims=(0, 0))(x0, torch.as_tensor(ki).expand(4, -1))
  xg = x0[0].clone().requires_grad_()
  with pytest.raises(RuntimeError, match="build_scan_stream_reference"):
    scan._kernel_scan(spec, kinds, {}, xg, P0[0], Q, dts, ki, zs[:, 0], Rs,
                      eas)
  fn, _ = scan.build_scan_stream(spec, kinds)
  n = generic_scan.stream_bank_scan.launches
  r = scan.build_scan_stream_reference.launches
  (x, _), _ = fn({}, xg, P0[0], Q, dts, ki, zs[:, 0], Rs, eas)
  x.sum().backward()
  assert xg.grad is not None and torch.isfinite(xg.grad).all()
  assert generic_scan.stream_bank_scan.launches == n
  assert scan.build_scan_stream_reference.launches == r + 1


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_kernel9_matches_plain_on_the_card(cuda_device):
  """scan_fn vmapped over 16 live logs on the card: one launch of kernel
  9, no run of the plain version, every stacked state within 1e-6 sigma
  of the plain version's (float64 from the prior; the card contracts
  products into FMAs, so the limit is the smoke's double hold, LIVE64_TOL,
  not the host build's 1e-9)."""
  spec, kinds, x0, P0, Q, dts, ki, zs, Rs, eas = _op_case(B=16, T=32)
  d = lambda a: a.to(cuda_device)  # noqa: E731
  fn, _ = scan.build_scan_stream(spec, kinds)
  plain, _ = scan.build_scan_stream_reference(spec, kinds)
  n = generic_scan.stream_bank_scan.launches
  r = scan.build_scan_stream_reference.launches
  out = vmap(lambda x, P, z: fn({}, x, P, d(Q), d(dts), ki, z, d(Rs),
                                d(eas)), in_dims=(0, 0, 1))(
      d(x0), d(P0), d(zs))
  torch.cuda.synchronize()
  assert generic_scan.stream_bank_scan.launches == n + 1
  assert scan.build_scan_stream_reference.launches == r
  ref = vmap(lambda x, P, z: plain({}, x, P, d(Q), d(dts), ki, z, d(Rs),
                                   d(eas)), in_dims=(0, 0, 1))(
      d(x0), d(P0), d(zs))
  bank = lambda o: (o[0].T, o[1].permute(1, 2, 0), o[2].permute(1, 2, 0),  # noqa
                    o[3].permute(1, 2, 3, 0), o[4].permute(1, 2, 0),
                    o[5].permute(1, 2, 3, 0))
  out, ref = bank([a.cpu() for a in _flat(out)]), bank(
      [a.cpu() for a in _flat(ref)])
  assert sigma_err(spec, out, ref) <= 1e-6


@pytest.mark.cuda
def test_kernel9_refuses_on_the_card(cuda_device):
  """On the card a batched Rs and an input that requires grad raise."""
  spec, kinds, x0, P0, Q, dts, ki, zs, Rs, eas = _op_case()
  d = lambda a: a.to(cuda_device)  # noqa: E731
  fn, _ = scan.build_scan_stream(spec, kinds)
  with pytest.raises(ValueError, match="Rs is batched"):
    vmap(lambda x, P, z, R: fn({}, x, P, d(Q), d(dts), ki, z, R, d(eas)),
         in_dims=(0, 0, 1, 0))(d(x0), d(P0), d(zs),
                               d(Rs).expand(4, -1, -1, -1))
  with pytest.raises(RuntimeError, match="build_scan_stream_reference"):
    fn({}, d(x0[0]).requires_grad_(), d(P0[0]), d(Q), d(dts), ki,
       d(zs[:, 0]), d(Rs), d(eas))
