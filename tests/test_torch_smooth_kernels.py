"""Kernels 11-14, the offline RTS smoother on the card
(rednose_tpu_torch/ops/smooth_scan.py: the gains, elements and refine
elements, kernel 11; the sequential backward pass, kernel 12; the suffix
scan of affine maps, kernel 13; the inject, kernel 14), and their route
behind smoothing/rts.py.

On the CPU each kernel's source is built with the host C++ compiler (the
emitted mode "smooth" source of a spec around csrc/smooth.cuh, entries
rn_smooth_*_host; csrc/affine_scan.cu for a size, rn_affine_scan_host):
the kernels' own item, lane and block functions, one thread each
(kernel 12's roles a step in order: its ring's stage as a plain copy,
the state chain, the covariance chain, the rows out). Held
against the JAX package (rednose_tpu/smoothing/rts.py: rts_smooth,
rts_smooth_parallel with refine 0 and 2, _smoother_gain,
_suffix_scan_lane with and without V) on the same seeded inputs, for the
live spec (a warm ECEF_POS / NO_ROT log through the port's plain scan),
the kinematic spec (its POSITION log) and msckf_eskf (random stacks with
four clones, which pass through): float64 within 1e-9 of each
component's scale; float32 with its error against the float64 oracle at
most 3x the plain float32 smoother's own, plus 1e-6. Also: logs of T =
1, 2 and 7 steps (7: not a multiple of kernel 12's ring), msckf_eskf's
clone rows through kernel 12 bitwise, kernel 13 against JAX's
_suffix_scan_lane at each main-block size D = 2, 5, 6, 22 and n from one
element to three chunks and a ragged fourth, and kernels 11 and 13's host
builds bitwise what their first designs' per-entry sum orders give
(PARENT_GAINS, PARENT_AFFINE).

The card route (the custom ops rednose::rts_smooth and
rednose::rts_smooth_parallel) runs here on CPU tensors with the
launchers replaced by stand-ins that call the host builds and count: a
vmapped bank and rts_smooth_parallel_bank are one launch of each kernel,
and what of the gradients is not ported raises by name (refine > 0 with
an input that requires grad, torch.func.grad, torch.func.jvp,
create_graph=True; the adjoint itself: tests/test_torch_smooth_grad.py).

Card-only cases (marked cuda) hold each kernel against its plain version
on the card, float32 and float64, on 1, 2, 37 and 64 lanes, kernels 11
and 12 on logs of 1, 2 and 7 steps, each lane of kernel 12 bitwise that
lane alone, and kernel 13 at each D and n of its CPU cases (in chunks of
AFFINE_CHUNK), with and without V and out A, its float64 raw launches
bitwise the wrapped call; the adjoints 12' and 11' on the logs of 1, 2
and 7 steps (fewer steps than 12''s ring has stages, and more). This file imports JAX
only in a try (the card's machine has none): `python -m pytest
tests/test_torch_smooth_kernels.py -m cuda --noconftest`."""

import ctypes
import functools
import pathlib
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.func import vmap

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax
  import jax.numpy as jnp
  from rednose_tpu.models.kinematic import KinematicKalman as JKinematic
  from rednose_tpu.models.live import LiveKalman as JLive
  from rednose_tpu.models.msckf_eskf import MSCKFEskf as JMSCKF
  from rednose_tpu.smoothing import rts as jrts
except ImportError:
  jax = jnp = JKinematic = JLive = JMSCKF = jrts = None
from rednose_tpu_torch.models.kinematic import (
    KinematicKalman,
    ObservationKind as KK,
)
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
from rednose_tpu_torch import _build
from rednose_tpu_torch.ops import smooth_scan
from rednose_tpu_torch.runtime import scan
from rednose_tpu_torch.smoothing import rts
from torch_parity import cuda_device, host_compiler  # noqa: F401

CSRC = pathlib.Path(rts.__file__).resolve().parents[1] / "csrc"
FAMILIES = ("live", "kinematic", "msckf")
TOL64 = 1e-9
T_LOG, B_LOG = 12, 2
# kernel 13's host chunk: small, so that the logs here take all three passes
HOST_CHUNK = 4


# ------------------------------------------------------------ the inputs

def _scan_stacks(spec, kinds, Q, x0, P0, dts, ki, zs, Rs, keep):
  """The plain scan's stacks of B lanes (float64), the last `keep` steps:
  (x_pred, P_pred, x_post, P_post) each (B, keep, ...)."""
  fn, _ = scan.build_scan_stream_reference(spec, kinds)
  t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa
  eas = torch.zeros((len(dts), 1), dtype=torch.float64)
  _, st = vmap(lambda x, P, z: fn({}, x, P, t(Q), t(dts), ki, z, t(Rs), eas),
               in_dims=(0, 0, 1))(t(x0), t(P0), t(zs))
  return tuple(a[:, -keep:].numpy() for a in st)


def _spd(rng, n, B, T, scale):
  A = rng.randn(B, T, n, n)
  return scale * (A @ np.swapaxes(A, -1, -2) / n + 0.5 * np.eye(n))


@functools.lru_cache(maxsize=None)
def family(name):
  """(spec, JAX spec, stacks (x_pred, P_pred, x_post, P_post) each (B, T,
  ...), dts (B, T - 1)), float64 numpy."""
  if name == "live":
    from test_torch_scan_stream_kernel import live_log

    kinds = (K.ECEF_POS, K.NO_ROT)
    x0, P0, dts, ki, zs, Rs, _ = live_log(kinds, 64, B_LOG, 11)
    stacks = _scan_stacks(LiveKalman.build_spec(), kinds, LiveKalman.Q, x0,
                          P0, dts, ki, zs, Rs, T_LOG)
    return (LiveKalman.build_spec(), JLive.build_spec() if JLive else None,
            stacks, np.tile(dts[-T_LOG + 1:], (B_LOG, 1)))
  if name == "kinematic":
    rng = np.random.RandomState(4)
    T0 = 48
    dts = 0.005 + 0.01 * rng.rand(T0)
    x0 = np.tile(KinematicKalman.initial_x, (B_LOG, 1))
    P0 = np.tile(np.diag(KinematicKalman.initial_P_diag), (B_LOG, 1, 1))
    stacks = _scan_stacks(
        KinematicKalman.build_spec(), (KK.POSITION,), KinematicKalman.Q, x0,
        P0, dts, np.zeros(T0, np.int32), 0.3 * rng.randn(T0, B_LOG, 1),
        np.tile(KinematicKalman.obs_noise[KK.POSITION], (T0, 1, 1)), T_LOG)
    return (KinematicKalman.build_spec(),
            JKinematic.build_spec() if JKinematic else None, stacks,
            np.tile(dts[-T_LOG + 1:], (B_LOG, 1)))
  # msckf_eskf: random stacks around its x0, four clones
  spec = MSCKFEskf.build_spec()
  rng = np.random.RandomState(7)
  T, B, dx, de = T_LOG, B_LOG, spec.dim_x, spec.dim_err
  x0 = np.asarray(MSCKFEskf.initial_x, np.float64)
  xs = []
  for _ in range(2):
    x = x0 + 0.1 * rng.randn(B, T, dx)
    for q in spec.quaternion_idxs:
      x[..., q:q + 4] /= np.linalg.norm(x[..., q:q + 4], axis=-1,
                                        keepdims=True)
    xs.append(x)
  P_post = _spd(rng, de, B, T, 0.01)
  P_pred = P_post + _spd(rng, de, B, T, 0.005)
  return (spec, JMSCKF.build_spec() if JMSCKF else None,
          (xs[0], P_pred, xs[1], P_post), 0.01 + 0.01 * rng.rand(B, T - 1))


def family_T(name, T):
  """family(name) cut to its last T steps (T <= T_LOG)."""
  spec, jspec, st, dts = family(name)
  return spec, jspec, tuple(a[:, -T:] for a in st), dts[:, T_LOG - T:]


def _t(a, dtype=torch.float64):
  return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _ts(dts):
  """Timestamps whose differences are dts (B, T - 1): (B, T)."""
  return np.concatenate([np.zeros((dts.shape[0], 1)),
                         np.cumsum(dts, axis=1)], axis=1)


# ------------------------------------------------------- the host builds

_LIBS = {}
_HOST_ENTRIES = {
    "rn_smooth_gains_host": (ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 3,
    "rn_smooth_refine_host": (ctypes.c_void_p,) * 4 + (ctypes.c_int,)
                             + (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4,
    "rn_smooth_backward_host": (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5,
    "rn_smooth_inject_host": (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5,
    "rn_affine_scan_host": (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 4,
}


def _compile(source):
  d = pathlib.Path(tempfile.mkdtemp(prefix="rn_smooth_host_"))
  (d / "gen.cu").write_text(source)
  proc = subprocess.run(
      [host_compiler(), "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
       "-I", str(CSRC), "-o", str(d / "lib.so"), str(d / "gen.cu")],
      capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-4000:]
  lib = ctypes.CDLL(str(d / "lib.so"))
  for name, argtypes in _HOST_ENTRIES.items():
    fn = getattr(lib, name, None)
    if fn is not None:
      fn.argtypes = list(argtypes)
      fn.restype = ctypes.c_int
  return lib


def host_lib(source):
  """The host build of a smoother source (every family's at once, in
  parallel, at the first call)."""
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "smoother's kernels")
  if not _LIBS:
    specs = [family(f)[0] for f in FAMILIES]
    srcs = [smooth_scan.smooth_source(s, ()) for s in specs] + [
        smooth_scan.affine_source(s.dim_main_err) for s in specs]
    with ThreadPoolExecutor(len(srcs)) as pool:
      _LIBS.update(zip(srcs, pool.map(_compile, srcs)))
  if source not in _LIBS:
    _LIBS[source] = _compile(source)
  return _LIBS[source]


def _p(t):
  return None if t is None else t.data_ptr()


class Host:
  """The four launchers on CPU tensors through the host builds, in the
  launchers' signatures, counting their calls."""

  def __init__(self):
    self.counts = dict.fromkeys(("smooth_gains", "smooth_backward",
                                 "affine_suffix_scan", "smooth_inject"), 0)
    self.lanes = []

  def _lib(self, spec, params):
    return host_lib(smooth_scan.smooth_source(
        spec, smooth_scan.pnames_of(params)))

  def _prm(self, params, x):
    return smooth_scan._prm(params, smooth_scan.pnames_of(params), x.dtype,
                            x.device)

  def smooth_gains(self, spec, params, x_pred, P_pred, x_post, P_post, dts,
                   *, elements=True, C=None, e=None, norm_quats=False):
    self.counts["smooth_gains"] += 1
    B, T = x_post.shape[:2]
    self.lanes.append(B)
    n, d2, dbl = T - 1, spec.dim_main_err, x_post.dtype == torch.float64
    lib, prm = self._lib(spec, params), self._prm(params, x_post)
    new = x_post.new_zeros
    if C is None:
      out = (new((B, n, d2, d2)), new((B, n, d2)), new((B, n, d2, d2)))
      out = out if elements else out[:1]
      assert lib.rn_smooth_gains_host(
          _p(x_pred), _p(P_pred), _p(x_post), _p(P_post), _p(dts), _p(prm),
          *(_p(a) for a in (out + (None, None))[:3]), B, T, dbl) == 0
      return out if elements else out[0]
    A, b = new((B, n, d2, d2)), new((B, n, d2))
    assert lib.rn_smooth_refine_host(
        _p(x_pred), _p(x_post), _p(C), _p(e), e.shape[1], _p(prm), _p(A),
        _p(b), B, T, bool(norm_quats), dbl) == 0
    return A, b

  def smooth_backward(self, spec, params, x_pred, P_pred, x_post, P_post, C,
                      *, norm_quats=False, reference_seed=False):
    self.counts["smooth_backward"] += 1
    B, T = x_post.shape[:2]
    self.lanes.append(B)
    xs, Ps = torch.zeros_like(x_post), torch.zeros_like(P_post)
    assert self._lib(spec, params).rn_smooth_backward_host(
        _p(x_pred), _p(P_pred), _p(x_post), _p(P_post), _p(C),
        _p(self._prm(params, x_post)), _p(xs), _p(Ps), B, T,
        bool(norm_quats), bool(reference_seed),
        x_post.dtype == torch.float64) == 0
    return xs, Ps

  def affine_suffix_scan(self, A, b, V=None, *, want_A=False,
                         chunk=HOST_CHUNK):
    self.counts["affine_suffix_scan"] += 1
    N, n, d = A.shape[:3]
    self.lanes.append(N)
    new = A.new_zeros
    Ao = new((N, n, d, d)) if want_A else None
    bo, Vo = new((N, n, d)), None if V is None else new((N, n, d, d))
    nc = -(-n // chunk)
    tot, excl = new((N, nc, 2 * d * d + d)), new((N, nc, 2 * d * d + d))
    assert host_lib(smooth_scan.affine_source(d)).rn_affine_scan_host(
        _p(A), _p(b), _p(V), _p(Ao), _p(bo), _p(Vo), _p(tot), _p(excl), N,
        n, chunk, A.dtype == torch.float64) == 0
    return Ao, bo, Vo

  def smooth_inject(self, spec, params, x_post, P_post, e, D, *,
                    norm_quats=False):
    self.counts["smooth_inject"] += 1
    B, T = x_post.shape[:2]
    self.lanes.append(B)
    xs, Ps = torch.zeros_like(x_post), torch.zeros_like(P_post)
    assert self._lib(spec, params).rn_smooth_inject_host(
        _p(x_post), _p(P_post), _p(e), _p(D),
        _p(self._prm(params, x_post)), _p(xs), _p(Ps), B, T, e.shape[1],
        bool(norm_quats), x_post.dtype == torch.float64) == 0
    return xs, Ps


def _route(monkeypatch):
  """The card route's launchers replaced by the host builds: returns the
  Host whose counts they keep."""
  host = Host()
  for name in host.counts:
    monkeypatch.setattr(smooth_scan, name, getattr(host, name))
  return host


def host_sequential(name, dtype=torch.float64, reference_seed=False,
                    T=T_LOG):
  """Kernels 11 and 12 (host builds) on the family's last T steps."""
  spec, _, st, dts = family_T(name, T)
  h = Host()
  a = [_t(s, dtype) for s in st]
  C = h.smooth_gains(spec, {}, *a, _t(dts, dtype), elements=False)
  return h.smooth_backward(spec, {}, *a, C, norm_quats=True,
                           reference_seed=reference_seed)


def host_parallel(name, refine, dtype=torch.float64, T=T_LOG):
  """Kernels 11, 13 and 14 (host builds) on the family's last T steps,
  with `refine` Newton passes."""
  spec, _, st, dts = family_T(name, T)
  h = Host()
  xp, Pp, xq, Pq = (_t(s, dtype) for s in st)
  C, b, V = h.smooth_gains(spec, {}, xp, Pp, xq, Pq, _t(dts, dtype))
  _, e, D = h.affine_suffix_scan(C, b, V)
  for _ in range(refine):
    A, br = h.smooth_gains(spec, {}, xp, None, xq, None, None, C=C, e=e,
                           norm_quats=True)
    _, e, _ = h.affine_suffix_scan(A, br)
  return h.smooth_inject(spec, {}, xq, Pq, e, D, norm_quats=True)


# ------------------------------------------------------------ the JAX side

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (the oracle)")


def jax_smooth(name, parallel, refine=0, reference_seed=False, T=T_LOG):
  """JAX's rts_smooth / rts_smooth_parallel, float64, jitted and vmapped
  over the lanes (each once), on the family's last T steps."""
  return _jax_smooth(name, parallel, refine, reference_seed, T)


@functools.lru_cache(maxsize=None)
def _jax_smooth(name, parallel, refine, reference_seed, T):
  _, jspec, st, dts = family_T(name, T)
  if parallel:
    def one(xp, Pp, xq, Pq, t, d):
      return jrts.rts_smooth_parallel(jspec, {}, xp, Pp, xq, Pq, t,
                                      norm_quats=True, dts=d, refine=refine)
  else:
    def one(xp, Pp, xq, Pq, t, d):
      return jrts.rts_smooth(jspec, {}, xp, Pp, xq, Pq, t, norm_quats=True,
                             dts=d, reference_seed=reference_seed)
  x, P = jax.jit(jax.vmap(one))(*(jnp.asarray(a) for a in (
      *st, _ts(dts), dts)))
  return np.asarray(x), np.asarray(P)


def scaled_err(a, b):
  """max |a - b| over each component's scale (its largest |b| over time,
  at least 1), over the lanes."""
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  scale = np.maximum(np.abs(b).max(axis=-2, keepdims=True), 1.0)
  return float((np.abs(a - b) / scale).max())


def cov_err(a, b):
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module", autouse=True)
def _jax_x64():
  if jax is None:
    yield
    return
  prev = jax.config.read("jax_enable_x64")
  jax.config.update("jax_enable_x64", True)
  yield
  jax.config.update("jax_enable_x64", prev)


# ------------------------------------------------------------------ tests

@needs_jax
@pytest.mark.parametrize("name", FAMILIES)
def test_gains_and_elements_match_jax(name):
  """Kernel 11 (host build): the gains against JAX's _smoother_gain and
  the elements b = C u, V = C dP C^T formed from them in JAX, float64,
  within TOL64 of each one's largest entry."""
  spec, jspec, st, dts = family(name)
  xp, Pp, xq, Pq = st
  d2 = spec.dim_main_err
  C, b, V = (a.numpy() for a in Host().smooth_gains(
      spec, {}, *(_t(s) for s in st), _t(dts)))
  gain = jax.jit(jax.vmap(jax.vmap(lambda x, P, P1, dt: jrts._smoother_gain(
      jspec, {}, x, P, P1, dt))))
  Cj = np.asarray(gain(xq[:, :-1], Pq[:, :-1], Pp[:, 1:], dts))
  u = np.asarray(jax.jit(jax.vmap(jax.vmap(
      lambda a, c: jspec.inv_err({}, a, c))))(xp[:, 1:], xq[:, 1:]))[..., :d2]
  dP = Pq[:, 1:, :d2, :d2] - Pp[:, 1:, :d2, :d2]
  bj = np.einsum("btij,btj->bti", Cj, u)
  Vj = Cj @ dP @ np.swapaxes(Cj, -1, -2)
  for got, want in ((C, Cj), (b, bj), (V, Vj)):
    assert cov_err(got, want) <= TOL64


@needs_jax
@pytest.mark.parametrize("reference_seed", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_sequential_matches_jax(name, reference_seed):
  """Kernels 11 and 12 (host builds) against JAX's rts_smooth, float64,
  norm_quats: states within TOL64 of each component's scale, covariances
  of the largest entry; msckf_eskf's clone slots pass through bitwise."""
  xs, Ps = host_sequential(name, reference_seed=reference_seed)
  xj, Pj = jax_smooth(name, False, reference_seed=reference_seed)
  assert scaled_err(xs.numpy(), xj) <= TOL64
  assert cov_err(Ps.numpy(), Pj) <= TOL64
  spec, _, st, _ = family(name)
  d1 = spec.dim_main
  if d1 < spec.dim_x and not reference_seed:
    clones = [q for q in spec.quaternion_idxs if q >= d1]
    keep = [i for i in range(d1, spec.dim_x)
            if not any(q <= i < q + 4 for q in clones)]
    np.testing.assert_array_equal(xs.numpy()[..., keep], st[2][..., keep])


@needs_jax
@pytest.mark.parametrize("name,refine", [("live", 0), ("live", 2),
                                         ("kinematic", 0), ("kinematic", 2),
                                         ("msckf", 0)])
def test_parallel_matches_jax(name, refine):
  """Kernels 11, 13 and 14, with refine Newton passes through kernel 11's
  refine variant and kernel 13 (host builds, kernel 13 in chunks of
  HOST_CHUNK), against JAX's rts_smooth_parallel, float64, norm_quats,
  within TOL64."""
  xs, Ps = host_parallel(name, refine)
  xj, Pj = jax_smooth(name, True, refine=refine)
  assert scaled_err(xs.numpy(), xj) <= TOL64
  assert cov_err(Ps.numpy(), Pj) <= TOL64


def test_parallel_refine_matches_plain_msckf():
  """msckf_eskf's refine passes (host builds) against the port's plain
  rts_smooth_parallel_reference with refine = 2, float64, within TOL64
  (JAX's side of the refine variant: test_parallel_matches_jax)."""
  spec, _, st, dts = family("msckf")
  xs, Ps = host_parallel("msckf", 2)
  ts = _t(_ts(dts))
  for i in range(B_LOG):
    xr, Pr = rts.rts_smooth_parallel_reference(
        spec, {}, *(_t(s[i]) for s in st), ts[i], norm_quats=True,
        dts=_t(dts[i]), refine=2)
    assert scaled_err(xs[i].numpy(), xr.numpy()) <= TOL64
    assert cov_err(Ps[i].numpy(), Pr.numpy()) <= TOL64


@needs_jax
@pytest.mark.parametrize("T", [1, 2, 7])
@pytest.mark.parametrize("name", FAMILIES)
def test_short_and_ragged_logs_match_jax(name, T):
  """Kernels 11 and 12 (host builds) on the family's last T steps against
  JAX's rts_smooth, float64 within TOL64: T = 1 (the seed row alone), T =
  2 (one step) and T = 7 (six steps, not a multiple of kernel 12's ring
  of SM_BACK_STAGES = 4); and kernels 11, 13 and 14 against
  rts_smooth_parallel at T = 2 and 7."""
  xs, Ps = host_sequential(name, T=T)
  xj, Pj = jax_smooth(name, False, T=T)
  assert xs.shape[1] == T
  assert scaled_err(xs.numpy(), xj) <= TOL64
  assert cov_err(Ps.numpy(), Pj) <= TOL64
  if T > 1:
    xs, Ps = host_parallel(name, 0, T=T)
    xj, Pj = jax_smooth(name, True, T=T)
    assert scaled_err(xs.numpy(), xj) <= TOL64
    assert cov_err(Ps.numpy(), Pj) <= TOL64


def test_clone_rows_pass_through():
  """msckf_eskf (four clones past its 12-entry main block): kernel 12's
  host build keeps x_{k|k}'s clone slots bitwise, and P_s past the main
  block is sym(P_{k|k}) there bitwise, at T = 7 and T_LOG."""
  spec, _, _, _ = family("msckf")
  d1, d2 = spec.dim_main, spec.dim_main_err
  clones = [q for q in spec.quaternion_idxs if q >= d1]
  keep = [i for i in range(d1, spec.dim_x)
          if not any(q <= i < q + 4 for q in clones)]
  for T in (7, T_LOG):
    _, _, st, _ = family_T("msckf", T)
    xs, Ps = (a.numpy() for a in host_sequential("msckf", T=T))
    np.testing.assert_array_equal(xs[..., keep], st[2][..., keep])
    sym = 0.5 * (st[3] + np.swapaxes(st[3], -1, -2))
    np.testing.assert_array_equal(Ps[:, :-1, d2:, :], sym[:, :-1, d2:, :])
    np.testing.assert_array_equal(Ps[:, :-1, :, d2:], sym[:, :-1, :, d2:])
    np.testing.assert_array_equal(Ps[:, -1], st[3][:, -1])


# kernel 11's first design's item (one warp an item, matrices at row
# stride D2, each product entry one sum in ascending k), around an
# emitted source's F parts: the parent algorithm's order, for the bitwise
# case below
PARENT_GAINS = r"""
namespace rn_parent {
using namespace rn_gen;
template <typename S>
void gains_item(const S* xq0, const S* Pq0, const S* xp1, const S* Pp1,
                const S* xq1, const S* Pq1, S dt, const S* p, S* C, S* b,
                S* V, S* sm) {
  S* L = sm;
  S* F = L + D2 * D2;
  S* Pk = F + D2 * D2;
  S* X = Pk + D2 * D2;
  S* diag = X + D2 * D2;
  S* u = diag + D2;
  for (int r = 0; r < SM_PARTS; ++r) gen_sm_F_part<S>(xq0, dt, p, F, D2, r);
  for (int e = 0; e < D2 * D2; ++e) {
    const int i = e / D2, j = e % D2;
    L[e] = Pp1[i * DE + j];
    Pk[e] = Pq0[i * DE + j];
  }
  for (int e = 0; e < D2 * D2; ++e) {
    const int i = e / D2, j = e % D2;
    S s = 0;
    for (int k = 0; k < D2; ++k) s += F[i * D2 + k] * Pk[j * D2 + k];
    X[e] = s;
  }
  for (int j = 0; j < D2; ++j) {
    for (int i = j; i < D2; ++i) {
      S s = L[i * D2 + j];
      for (int k = 0; k < j; ++k) s -= L[i * D2 + k] * L[j * D2 + k];
      L[i * D2 + j] = s;
    }
    const S d = g_sqrt(L[j * D2 + j]);
    for (int i = j + 1; i < D2; ++i) L[i * D2 + j] /= d;
    diag[j] = d;
  }
  for (int c = 0; c < D2; ++c) {
    for (int i = 0; i < D2; ++i) {
      S s = X[i * D2 + c];
      for (int k = 0; k < i; ++k) s -= L[i * D2 + k] * X[k * D2 + c];
      X[i * D2 + c] = s / diag[i];
    }
    for (int i = D2 - 1; i >= 0; --i) {
      S s = X[i * D2 + c];
      for (int k = i + 1; k < D2; ++k) s -= L[k * D2 + i] * X[k * D2 + c];
      X[i * D2 + c] = s / diag[i];
    }
  }
  for (int e = 0; e < D2 * D2; ++e) C[e] = X[(e % D2) * D2 + e / D2];
  gen_sm_inv_err<S>(xp1, xq1, p, u);
  for (int e = 0; e < D2 * D2; ++e) {
    const int i = e / D2, j = e % D2;
    F[e] = Pq1[i * DE + j] - Pp1[i * DE + j];
  }
  for (int i = 0; i < D2; ++i) {
    S s = 0;
    for (int k = 0; k < D2; ++k) s += X[k * D2 + i] * u[k];
    b[i] = s;
  }
  for (int e = 0; e < D2 * D2; ++e) {
    const int i = e / D2, j = e % D2;
    S s = 0;
    for (int k = 0; k < D2; ++k) s += X[k * D2 + i] * F[k * D2 + j];
    Pk[e] = s;
  }
  for (int e = 0; e < D2 * D2; ++e) {
    const int i = e / D2, j = e % D2;
    S s = 0;
    for (int k = 0; k < D2; ++k) s += Pk[i * D2 + k] * X[k * D2 + j];
    V[e] = s;
  }
}
}  // namespace rn_parent

extern "C" int rn_parent_gains(const double* xp, const double* Pp,
                               const double* xq, const double* Pq,
                               const double* dts, const double* p, double* C,
                               double* b, double* V, int B, int T) {
  const long long n = T - 1;
  static double sm[4 * rn_gen::D2 * rn_gen::D2 + rn_gen::D2 + rn_gen::DE];
  const size_t rx = rn_gen::DX, rp = (size_t)rn_gen::DE * rn_gen::DE;
  const size_t rc = (size_t)rn_gen::D2 * rn_gen::D2;
  for (long long it = 0; it < (long long)B * n; ++it) {
    const size_t r0 = (size_t)((it / n) * T + it % n), r1 = r0 + 1;
    rn_parent::gains_item<double>(xq + r0 * rx, Pq + r0 * rp, xp + r1 * rx,
                                  Pp + r1 * rp, xq + r1 * rx, Pq + r1 * rp,
                                  dts[it], p, C + it * rc, b + it * rn_gen::D2,
                                  V + it * rc, sm);
  }
  return 0;
}
"""


@pytest.mark.parametrize("name", FAMILIES)
def test_gains_bitwise_the_parent_order(name):
  """Kernel 11's host build (register tiles, row stride LD, F in parts)
  gives bitwise what its first design's order gives (PARENT_GAINS: the
  same F parts, each entry's sum in ascending k at row stride D2) on the
  family's stacks in float64, the kinematic spec's D2 = 2 in one tile;
  and it holds against smooth_gains_reference within 1e-12 of each
  output's largest entry."""
  spec, _, st, dts = family(name)
  a = [_t(x) for x in st] + [_t(dts)]
  got = Host().smooth_gains(spec, {}, *a)
  src = smooth_scan.smooth_source(spec, ()) + PARENT_GAINS
  lib = host_lib(src)
  B, T, d2 = st[0].shape[0], st[0].shape[1], spec.dim_main_err
  want = (torch.zeros(B, T - 1, d2, d2), torch.zeros(B, T - 1, d2),
          torch.zeros(B, T - 1, d2, d2))
  want = tuple(w.double() for w in want)
  prm = torch.zeros(1, dtype=torch.float64)
  fn = lib.rn_parent_gains
  fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2
  assert fn(*(_p(x) for x in (*a, prm, *want)), B, T) == 0
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), w.numpy())
  ref = smooth_scan.smooth_gains_reference(spec, {}, *a)
  for g, r in zip(got, ref):
    assert cov_err(g.numpy(), r.numpy()) <= 1e-12


@needs_jax
@pytest.mark.parametrize("want_A", [False, True])
@pytest.mark.parametrize("with_V", [True, False])
def test_suffix_scan_matches_jax(with_V, want_A):
  """Kernel 13 (host build, chunks of HOST_CHUNK: all three passes, a
  ragged last chunk) against JAX's _suffix_scan_lane (jitted, vmapped over
  the lanes) on 3 lanes of 37 random contracting 6 x 6 elements, float64:
  out b, V and A within TOL64 of each one's largest entry."""
  (A, b, V), out = _scan_case(with_V)
  Ao, bo, Vo = Host().affine_suffix_scan(_t(A), _t(b),
                                         None if V is None else _t(V),
                                         want_A=want_A)
  assert cov_err(bo.numpy(), out[1][..., 0]) <= TOL64
  if with_V:
    assert cov_err(Vo.numpy(), out[2]) <= TOL64
  if want_A:
    assert cov_err(Ao.numpy(), out[0]) <= TOL64
  else:
    assert Ao is None


@functools.lru_cache(maxsize=None)
def _scan_case(with_V):
  """Random elements (A, b, V or None), each (3, 37, ...), and JAX's
  suffix scan of them in the same layout."""
  rng = np.random.RandomState(5)
  N, n, d = 3, 37, 6
  A = 0.9 * rng.randn(N, n, d, d) / np.sqrt(d)
  b = rng.randn(N, n, d)
  V = _spd(rng, d, N, n, 1.0) if with_V else None
  lm = lambda a: jnp.moveaxis(a, 1, -1)  # noqa: E731
  elems = (lm(A), lm(b[:, :, :, None])) + (() if V is None else (lm(V),))
  out = jax.jit(jax.vmap(jrts._suffix_scan_lane))(*elems)
  return (A, b, V), [np.moveaxis(np.asarray(a), -1, 1) for a in out]


# the D and n cases of kernel 13: the main blocks of the kinematic (2) and
# car (5) specs, a 6, the live spec's 22; n = 1, a chunk less one, one
# chunk, one more, three and a ragged fourth (in chunks of `chunk`)
SCAN_DS = (2, 5, 6, 22)


def scan_ns(chunk):
  return (1, chunk - 1, chunk, chunk + 1, 3 * chunk + 5)


def _scan_elems(d, n, with_V, dtype=np.float64, chunk=HOST_CHUNK, seed=0):
  """The last n of max(scan_ns(chunk)) random contracting elements (A, b,
  V or None) of 3 lanes, numpy."""
  rng = np.random.RandomState(seed + 101 * d)
  N, m = 3, scan_ns(chunk)[-1]
  A = (0.9 * rng.randn(N, m, d, d) / np.sqrt(d)).astype(dtype)
  b = rng.randn(N, m, d).astype(dtype)
  V = _spd(rng, d, N, m, 1.0).astype(dtype) if with_V else None
  return tuple(None if a is None else np.ascontiguousarray(a[:, m - n:])
               for a in (A, b, V))


@functools.lru_cache(maxsize=None)
def _jax_scan(d, with_V):
  """JAX's _suffix_scan_lane, jitted and vmapped over the lanes, of all
  the elements _scan_elems(d, n, with_V) cuts from, in the (N, n, ...)
  layout: the scan of the last n is the last n of it."""
  A, b, V = _scan_elems(d, scan_ns(HOST_CHUNK)[-1], with_V)
  lm = lambda a: jnp.moveaxis(a, 1, -1)  # noqa: E731
  elems = (lm(A), lm(b[:, :, :, None])) + (() if V is None else (lm(V),))
  out = jax.jit(jax.vmap(jrts._suffix_scan_lane))(*elems)
  return [np.moveaxis(np.asarray(a), -1, 1) for a in out]


@needs_jax
@pytest.mark.parametrize("want_A", [False, True])
@pytest.mark.parametrize("with_V", [True, False])
@pytest.mark.parametrize("n", scan_ns(HOST_CHUNK))
@pytest.mark.parametrize("d", SCAN_DS)
def test_suffix_scan_sizes_match_jax(d, n, with_V, want_A):
  """Kernel 13's host build (chunks of HOST_CHUNK: n = 1 one chunk, a
  chunk less one, one whole chunk, one more element, three chunks and a
  ragged fourth) against JAX's _suffix_scan_lane (jitted, vmapped over 3
  lanes) at each main-block size, with V and without, out A asked for or
  not; float64, each output within TOL64 of its largest entry."""
  A, b, V = _scan_elems(d, n, with_V)
  want = [a[:, a.shape[1] - n:] for a in _jax_scan(d, with_V)]
  Ao, bo, Vo = Host().affine_suffix_scan(
      _t(A), _t(b), None if V is None else _t(V), want_A=want_A)
  assert cov_err(bo.numpy(), want[1][..., 0]) <= TOL64
  if with_V:
    assert cov_err(Vo.numpy(), want[2]) <= TOL64
  else:
    assert Vo is None
  if want_A:
    assert cov_err(Ao.numpy(), want[0]) <= TOL64
  else:
    assert Ao is None


# kernel 13's first design (a thread an output entry, its sum in
# ascending l with b_k / V_k added after it, the three passes over
# chunks), one thread: the parent order, for the bitwise case below
PARENT_AFFINE = r"""
namespace rn_parent {
constexpr int D = RN_AFFINE_D;
constexpr size_t TOT = 2 * D * D + D;
template <typename S>
struct State {
  S sm[5 * D * D + 2 * D];
  S *Ak = sm, *Ap = sm + D * D, *An = sm + 2 * D * D, *Vp = sm + 3 * D * D,
    *M = sm + 4 * D * D, *bp = sm + 5 * D * D, *bn = sm + 5 * D * D + D;
  void load(const S* A0, const S* b0, const S* V0) {
    for (int q = 0; q < D * D; ++q) {
      Ap[q] = A0 ? A0[q] : (S)(q / D == q % D);
      Vp[q] = V0 ? V0[q] : (S)0;
    }
    for (int i = 0; i < D; ++i) bp[i] = b0 ? b0[i] : (S)0;
  }
  void store(S* A0, S* b0, S* V0) const {
    for (int q = 0; q < D * D; ++q) {
      A0[q] = Ap[q];
      if (V0) V0[q] = Vp[q];
    }
    for (int i = 0; i < D; ++i) b0[i] = bp[i];
  }
  void apply(const S* Ag, const S* bg, const S* Vg, bool want_A, S* Ao,
             S* bo, S* Vo) {
    for (int q = 0; q < D * D; ++q) Ak[q] = Ag[q];
    for (int i = 0; i < D; ++i) {
      S s = 0;
      for (int j = 0; j < D; ++j) s += Ak[i * D + j] * bp[j];
      s += bg[i];
      bn[i] = s;
      if (bo) bo[i] = s;
    }
    for (int q = 0; q < D * D; ++q) {
      const int i = q / D, j = q % D;
      if (want_A) {
        S s = 0;
        for (int l = 0; l < D; ++l) s += Ak[i * D + l] * Ap[l * D + j];
        An[q] = s;
        if (Ao) Ao[q] = s;
      }
      if (Vg) {
        S s = 0;
        for (int l = 0; l < D; ++l) s += Ak[i * D + l] * Vp[l * D + j];
        M[q] = s;
      }
    }
    if (Vg)
      for (int q = 0; q < D * D; ++q) {
        const int i = q / D, j = q % D;
        S s = 0;
        for (int l = 0; l < D; ++l) s += M[i * D + l] * Ak[j * D + l];
        s += Vg[q];
        Vp[q] = s;
        if (Vo) Vo[q] = s;
      }
    S* t = bp; bp = bn; bn = t;
    if (want_A) { t = Ap; Ap = An; An = t; }
  }
};

template <typename S>
void scan(const S* A, const S* b, const S* V, S* Ao, S* bo, S* Vo, S* tot,
          S* excl, int N, int n, int chunk) {
  const int nc = (n + chunk - 1) / chunk;
  State<S> st;
  for (int l = 0; l < N && nc > 1; ++l) {
    for (int c = 0; c < nc; ++c) {
      st.load(nullptr, nullptr, nullptr);
      const int lo = c * chunk, hi = lo + chunk < n ? lo + chunk : n;
      for (int k = hi - 1; k >= lo; --k) {
        const size_t e = (size_t)l * n + k;
        st.apply(A + e * D * D, b + e * D, V ? V + e * D * D : nullptr, true,
                 nullptr, nullptr, nullptr);
      }
      S* t = tot + ((size_t)l * nc + c) * TOT;
      st.store(t, t + D * D, V ? t + D * D + D : nullptr);
    }
    st.load(nullptr, nullptr, nullptr);
    for (int c = nc - 1; c >= 0; --c) {
      S* x = excl + ((size_t)l * nc + c) * TOT;
      st.store(x, x + D * D, V ? x + D * D + D : nullptr);
      if (c == 0) break;
      const S* t = tot + ((size_t)l * nc + c) * TOT;
      st.apply(t, t + D * D, V ? t + D * D + D : nullptr, true, nullptr,
               nullptr, nullptr);
    }
  }
  for (int l = 0; l < N; ++l)
    for (int c = 0; c < nc; ++c) {
      const S* x = excl + ((size_t)l * nc + c) * TOT;
      if (nc > 1) st.load(x, x + D * D, V ? x + D * D + D : nullptr);
      else st.load(nullptr, nullptr, nullptr);
      const int lo = c * chunk, hi = lo + chunk < n ? lo + chunk : n;
      for (int k = hi - 1; k >= lo; --k) {
        const size_t e = (size_t)l * n + k;
        st.apply(A + e * D * D, b + e * D, V ? V + e * D * D : nullptr,
                 Ao != nullptr, Ao ? Ao + e * D * D : nullptr, bo + e * D,
                 V ? Vo + e * D * D : nullptr);
      }
    }
}
}  // namespace rn_parent

extern "C" int rn_parent_affine(const void* A, const void* b, const void* V,
                                void* Ao, void* bo, void* Vo, void* tot,
                                void* excl, int N, int n, int chunk,
                                int is_double) {
  if (is_double)
    rn_parent::scan<double>((const double*)A, (const double*)b,
                            (const double*)V, (double*)Ao, (double*)bo,
                            (double*)Vo, (double*)tot, (double*)excl, N, n,
                            chunk);
  else
    rn_parent::scan<float>((const float*)A, (const float*)b, (const float*)V,
                           (float*)Ao, (float*)bo, (float*)Vo, (float*)tot,
                           (float*)excl, N, n, chunk);
  return 0;
}
"""


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", SCAN_DS)
def test_suffix_scan_bitwise_the_parent_order(d, dtype):
  """Kernel 13's host build (register tiles, the elements staged in a
  ring, the state in shared memory as in global memory) gives bitwise what
  its first design's order gives (PARENT_AFFINE: a thread an entry, each
  sum in ascending l, b_k / V_k added after it) at each main-block size
  and n of test_suffix_scan_sizes_match_jax, with V and without, out A
  asked for or not, in float64 and float32; and it holds against
  affine_suffix_scan_reference within 1e-12 (float64)."""
  lib = host_lib(smooth_scan.affine_source(d) + PARENT_AFFINE)
  fn = lib.rn_parent_affine
  fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
  fn.restype = ctypes.c_int
  np_dt = np.float64 if dtype == torch.float64 else np.float32
  for n in scan_ns(HOST_CHUNK):
    for with_V in (True, False):
      A, b, V = (None if a is None else _t(a, dtype)
                 for a in _scan_elems(d, n, with_V, np_dt, seed=7))
      N = A.shape[0]
      got = Host().affine_suffix_scan(A, b, V, want_A=True)
      want = (torch.zeros_like(A), torch.zeros_like(b),
              None if V is None else torch.zeros_like(V))
      nc = -(-n // HOST_CHUNK)
      scratch = [A.new_zeros((N, nc, 2 * d * d + d)) for _ in range(2)]
      assert fn(*(_p(a) for a in (A, b, V, *want, *scratch)), N, n,
                HOST_CHUNK, dtype == torch.float64) == 0
      for g, w in zip(got, want):
        if w is None:
          assert g is None
          continue
        np.testing.assert_array_equal(g.numpy(), w.numpy())
      # out A not asked for: b and V as before, bitwise
      got_b = Host().affine_suffix_scan(A, b, V)
      np.testing.assert_array_equal(got_b[1].numpy(), want[1].numpy())
      if dtype == torch.float64:
        ref = smooth_scan.affine_suffix_scan_reference(A, b, V, want_A=True)
        for g, r in zip(got, ref):
          if r is not None:
            assert cov_err(g.numpy(), r.numpy()) <= 1e-12


def test_suffix_scan_matches_plain_doubling_scan():
  """Kernel 13 (host build) against its plain version
  (affine_suffix_scan_reference, the port's doubling scan) on the same
  elements, with V and A, float64 within TOL64: one chunk and three."""
  rng = np.random.RandomState(6)
  N, d = 2, 5
  for n in (5, 23):
    A = _t(0.9 * rng.randn(N, n, d, d) / np.sqrt(d))
    b, V = _t(rng.randn(N, n, d)), _t(_spd(rng, d, N, n, 1.0))
    got = Host().affine_suffix_scan(A, b, V, want_A=True)
    want = smooth_scan.affine_suffix_scan_reference(A, b, V, want_A=True)
    for g, w in zip(got, want):
      assert cov_err(g.numpy(), w.numpy()) <= TOL64


@needs_jax
@pytest.mark.parametrize("name", ("live", "kinematic"))
def test_float32_within_the_plain_smoothers_error(name):
  """Float32: the host builds' sequential and one-shot parallel smoothers
  against the float64 oracle (JAX's float64 smoother) at most 3x the
  plain float32 smoother's own error (the port's plain versions in
  float32) + 1e-6, in each component's scale."""
  spec, _, st, dts = family(name)
  ts32 = _t(_ts(dts), torch.float32)
  a32 = [_t(s, torch.float32) for s in st]
  for parallel in (False, True):
    oracle, _ = jax_smooth(name, parallel)
    if parallel:
      got, _ = host_parallel(name, 0, torch.float32)
      plain = [rts.rts_smooth_parallel_reference(
          spec, {}, *(a[i] for a in a32), ts32[i], norm_quats=True,
          dts=_t(dts[i], torch.float32))[0] for i in range(B_LOG)]
    else:
      got, _ = host_sequential(name, torch.float32)
      plain = [rts.rts_smooth_reference(
          spec, {}, *(a[i] for a in a32), ts32[i], norm_quats=True,
          dts=_t(dts[i], torch.float32))[0] for i in range(B_LOG)]
    err_plain = scaled_err(torch.stack(plain).numpy(), oracle)
    err = scaled_err(got.numpy(), oracle)
    assert err <= 3.0 * err_plain + 1e-6, (parallel, err, err_plain)


def test_emitted_functions_match_the_spec():
  """The emitted functions one by one (kernel 14 with e = 0 copies
  nothing but re-injects; kernel 11's refine variant at e = 0 on an
  additive spec is C itself): msckf_eskf's inject of a random
  correction against the spec's err, clones kept, float64 within 1e-12
  of each component's scale."""
  spec, _, st, dts = family("msckf")
  xq, Pq = _t(st[2]), _t(st[3])
  rng = np.random.RandomState(9)
  B, T, d2 = xq.shape[0], xq.shape[1], spec.dim_main_err
  e = _t(0.01 * rng.randn(B, T - 1, d2))
  D = _t(_spd(rng, d2, B, T - 1, 0.001))
  xs, Ps = Host().smooth_inject(spec, {}, xq, Pq, e, D, norm_quats=True)
  xr, Pr = smooth_scan.smooth_inject_reference(spec, {}, xq, Pq, e, D,
                                               norm_quats=True)
  assert scaled_err(xs.numpy(), xr.numpy()) <= 1e-12
  assert cov_err(Ps.numpy(), Pr.numpy()) <= 1e-12
  np.testing.assert_array_equal(xs[:, -1].numpy(), xq[:, -1].numpy())
  np.testing.assert_array_equal(Ps[:, -1].numpy(), Pq[:, -1].numpy())
  np.testing.assert_array_equal(Ps.numpy(), np.swapaxes(Ps.numpy(), -1, -2))
  kspec, _, kst, kdts = family("kinematic")
  a = [_t(s) for s in kst]
  h = Host()
  C = h.smooth_gains(kspec, {}, *a, _t(kdts), elements=False)
  A, b = h.smooth_gains(kspec, {}, a[0], None, a[2], None, None, C=C,
                        e=torch.zeros(B, 1, kspec.dim_main_err))
  assert cov_err(A.numpy(), C.numpy()) <= 1e-12


def test_card_route_is_one_launch_of_each_kernel(monkeypatch):
  """The card route on CPU tensors (the launchers replaced by the host
  builds): torch.func.vmap of rts_smooth's card route over a bank of
  B_LOG logs is one launch of kernels 11 and 12; rts_smooth_parallel_bank's
  one of kernels 11, 13 and 14, and with refine = 2 three of 11 and 13,
  whatever T; each equals the plain version lane by lane (float64, within
  TOL64)."""
  host = _route(monkeypatch)
  spec, _, st, dts = family("live")
  a = [_t(s) for s in st]
  t = _t(_ts(dts))
  d = _t(dts)
  xs, Ps = vmap(lambda xp, Pp, xq, Pq, tt, dd: rts._card_rts_smooth(
      spec, {}, xp, Pp, xq, Pq, tt, True, dd, False))(*a, t, d)
  assert host.counts == {"smooth_gains": 1, "smooth_backward": 1,
                         "affine_suffix_scan": 0, "smooth_inject": 0}
  assert host.lanes == [B_LOG, B_LOG]
  for i in range(B_LOG):
    xr, Pr = rts.rts_smooth_reference(spec, {}, *(v[i] for v in a), t[i],
                                      norm_quats=True, dts=d[i])
    assert scaled_err(xs[i].numpy(), xr.numpy()) <= TOL64
    assert cov_err(Ps[i].numpy(), Pr.numpy()) <= TOL64
  for refine, n in ((0, 1), (2, 3)):
    for k in host.counts:
      host.counts[k] = 0
    xs, Ps = rts._card_rts_smooth_parallel(spec, {}, *a, d, True, refine)
    assert host.counts == {"smooth_gains": n, "smooth_backward": 0,
                           "affine_suffix_scan": n, "smooth_inject": 1}
    for i in range(B_LOG):
      xr, Pr = rts.rts_smooth_parallel_reference(
          spec, {}, *(v[i] for v in a), t[i], norm_quats=True, dts=d[i],
          refine=refine)
      assert scaled_err(xs[i].numpy(), xr.numpy()) <= TOL64
      assert cov_err(Ps[i].numpy(), Pr.numpy()) <= TOL64


def test_card_route_refuses_gradients(monkeypatch):
  """The card route raises, naming what of the smoother's gradients is not
  ported, where its adjoint (kernels 11'-14') does not reach: refine > 0
  with an input that requires grad (the refine passes' adjoint) and
  torch.func.grad, launching nothing; torch.func.jvp (forward mode),
  launching nothing; and create_graph=True (higher order), after the
  forward and before any adjoint."""
  host = _route(monkeypatch)
  spec, _, st, dts = family("kinematic")
  a = [_t(s)[0] for s in st]
  t, d = _t(_ts(dts))[0], _t(dts)[0]
  xq = a[2].clone().requires_grad_()
  with pytest.raises(NotImplementedError, match="refine passes' adjoint"):
    rts._card_rts_smooth_parallel(spec, {}, a[0][None], a[1][None],
                                  xq[None], a[3][None], d[None], False, 2)
  with pytest.raises(NotImplementedError, match="torch.autograd.grad"):
    torch.func.grad(lambda x: rts._card_rts_smooth(
        spec, {}, a[0], a[1], x, a[3], t, False, d, False)[0].sum())(a[2])
  with pytest.raises(NotImplementedError, match="forward mode"):
    torch.func.jvp(lambda x: rts._card_rts_smooth(
        spec, {}, a[0], a[1], x, a[3], t, False, d, False)[0], (a[2],),
        (torch.ones_like(a[2]),))
  assert not any(host.counts.values())
  adjoints = ("smooth_gains_adjoint", "smooth_backward_adjoint")
  for name in adjoints:
    monkeypatch.setattr(smooth_scan, name, lambda *args, **kw: 1 / 0)
  xs, _ = rts._card_rts_smooth(spec, {}, a[0], a[1], xq, a[3], t, False, d,
                               False)
  with pytest.raises(NotImplementedError, match="create_graph"):
    torch.autograd.grad(xs.sum(), xq, create_graph=True)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
  """On CPU tensors the public entry points run the plain versions and no
  launcher: rts_smooth's and rts_smooth_parallel's .launches count them."""
  host = _route(monkeypatch)
  spec, _, st, dts = family("kinematic")
  a = [_t(s)[0] for s in st]
  t = _t(_ts(dts))[0]
  n_seq = rts.rts_smooth_reference.launches
  n_par = rts.rts_smooth_parallel_reference.launches
  rts.rts_smooth(spec, {}, *a, t)
  rts.rts_smooth_parallel(spec, {}, *a, t)
  assert rts.rts_smooth_reference.launches == n_seq + 1
  assert rts.rts_smooth_parallel_reference.launches == n_par + 1
  assert not any(host.counts.values())


# -------------------------------------------------------- card-only cases

def _card_case(name, dtype, lanes, dev, T=T_LOG):
  spec, _, st, dts = family_T(name, T)
  reps = -(-lanes // st[0].shape[0])
  cat = lambda s: np.concatenate([s] * reps)[:lanes]  # noqa: E731
  return spec, [_t(cat(s), dtype).to(dev) for s in st], \
      _t(cat(dts), dtype).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 37, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", FAMILIES)
def test_kernels_on_card_match_plain(cuda_device, name, dtype, lanes):
  """Kernels 11 (gains, elements, refine), 12, 13 and 14 on the card
  against their plain versions on the same card inputs: float64 within
  TOL64, float32 within 1e-3 of each output's largest entry (gains of
  conditioned covariances; the plain versions solve by the same
  Cholesky)."""
  spec, a, d = _card_case(name, dtype, lanes, cuda_device)
  tol = TOL64 if dtype == torch.float64 else 1e-3
  ss = smooth_scan
  n0 = {w: getattr(ss, w).launches for w in (
      "smooth_gains", "smooth_backward", "affine_suffix_scan",
      "smooth_inject")}
  C, b, V = ss.smooth_gains(spec, {}, *a, d)
  Cr, br, Vr = ss.smooth_gains_reference(spec, {}, *a, d)
  for g, w in ((C, Cr), (b, br), (V, Vr)):
    assert cov_err(g.cpu(), w.cpu()) <= tol
  xs, Ps = ss.smooth_backward(spec, {}, *a, C, norm_quats=True)
  xr, Pr = ss.smooth_backward_reference(spec, {}, *a, C, norm_quats=True)
  assert scaled_err(xs.cpu(), xr.cpu()) <= tol
  assert cov_err(Ps.cpu(), Pr.cpu()) <= tol
  _, e, D = ss.affine_suffix_scan(C, b, V)
  _, er, Dr = ss.affine_suffix_scan_reference(C, b, V)
  assert cov_err(e.cpu(), er.cpu()) <= tol
  assert cov_err(D.cpu(), Dr.cpu()) <= tol
  A, br2 = ss.smooth_gains(spec, {}, a[0], None, a[2], None, None, C=C,
                           e=e, norm_quats=True)
  Ar, br2r = ss.smooth_gains_reference(spec, {}, a[0], None, a[2], None,
                                       None, C=C, e=e, norm_quats=True)
  assert cov_err(A.cpu(), Ar.cpu()) <= tol
  assert cov_err(br2.cpu(), br2r.cpu()) <= tol
  xs, Ps = ss.smooth_inject(spec, {}, a[2], a[3], e, D, norm_quats=True)
  xr, Pr = ss.smooth_inject_reference(spec, {}, a[2], a[3], e, D,
                                      norm_quats=True)
  assert scaled_err(xs.cpu(), xr.cpu()) <= tol
  assert cov_err(Ps.cpu(), Pr.cpu()) <= tol
  assert {w: getattr(ss, w).launches - n for w, n in n0.items()} == {
      "smooth_gains": 2, "smooth_backward": 1, "affine_suffix_scan": 1,
      "smooth_inject": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", FAMILIES)
def test_short_logs_on_card_match_plain(cuda_device, name, dtype, T):
  """Kernels 11 and 12 on the card on the family's last T steps (T = 1:
  no gain, the seed row; T = 7: six steps against kernel 12's ring of 4
  stages) for 37 lanes against their plain versions, at
  test_kernels_on_card_match_plain's tolerances; kernel 12's lanes each
  bitwise that lane alone."""
  spec, a, d = _card_case(name, dtype, 37, cuda_device, T)
  tol = TOL64 if dtype == torch.float64 else 1e-3
  ss = smooth_scan
  C = ss.smooth_gains(spec, {}, *a, d, elements=False)
  assert C.shape == (37, T - 1, spec.dim_main_err, spec.dim_main_err)
  if T > 1:
    Cr = ss.smooth_gains_reference(spec, {}, *a, d, elements=False)
    assert cov_err(C.cpu(), Cr.cpu()) <= tol
  xs, Ps = ss.smooth_backward(spec, {}, *a, C, norm_quats=True)
  xr, Pr = ss.smooth_backward_reference(spec, {}, *a, C, norm_quats=True)
  assert scaled_err(xs.cpu(), xr.cpu()) <= tol
  assert cov_err(Ps.cpu(), Pr.cpu()) <= tol
  for i in (0, 36):
    one = [v[i:i + 1].contiguous() for v in a]
    x1, P1 = ss.smooth_backward(spec, {}, *one, C[i:i + 1].contiguous(),
                                norm_quats=True)
    assert torch.equal(x1, xs[i:i + 1]) and torch.equal(P1, Ps[i:i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", SCAN_DS)
def test_suffix_scan_on_card_matches_plain(cuda_device, d, dtype):
  """Kernel 13 on the card at each main-block size and n of
  scan_ns(AFFINE_CHUNK) (one chunk, a ragged last one, three passes), 3
  lanes, with V and without, out A asked for (the sharded smoother's
  carry) or not, against affine_suffix_scan_reference on the same card
  inputs: float64 within TOL64, float32 within 1e-4 of each output's
  largest entry (two float32 programs that associate the combines
  differently); float64 raw launches (rn_affine_scan_launch on
  preallocated outputs) bitwise the wrapped call."""
  ss = smooth_scan
  tol = TOL64 if dtype == torch.float64 else 1e-4
  np_dt = np.float64 if dtype == torch.float64 else np.float32
  lib = _build.generated_library(ss.affine_source(d))
  stream = torch.cuda.current_stream(cuda_device).cuda_stream
  for n in scan_ns(ss.AFFINE_CHUNK):
    for with_V in (True, False):
      A, b, V = (None if a is None else _t(a, dtype).to(cuda_device)
                 for a in _scan_elems(d, n, with_V, np_dt, ss.AFFINE_CHUNK))
      for want_A in (False, True):
        n0 = ss.affine_suffix_scan.launches
        got = ss.affine_suffix_scan(A, b, V, want_A=want_A)
        assert ss.affine_suffix_scan.launches == n0 + 1
        ref = ss.affine_suffix_scan_reference(A, b, V, want_A=want_A)
        for g, r in zip(got, ref):
          assert (g is None) == (r is None)
          if r is not None:
            assert cov_err(g.cpu(), r.cpu()) <= tol, (n, with_V, want_A)
        if dtype != torch.float64:
          continue
        N = A.shape[0]
        raw = [None if g is None else torch.empty_like(g) for g in got]
        nc = -(-n // ss.AFFINE_CHUNK)
        scratch = [A.new_empty((N, nc, 2 * d * d + d)) for _ in range(2)]
        _build.check(lib.rn_affine_scan_launch(
            *(_p(a) for a in (A, b, V, *raw, *scratch)), N, n,
            ss.AFFINE_CHUNK, 1, stream), "affine_suffix_scan")
        torch.cuda.synchronize()
        for g, r in zip(got, raw):
          assert g is None or torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", FAMILIES)
def test_short_logs_adjoints_on_card_match_plain(cuda_device, name, dtype, T):
  """Kernels 12' and 11' (gains and parallel forms) on the card on the
  family's last T steps for 37 lanes (T = 1: the seed row alone; T = 2
  and 7: fewer steps than 12''s ring has stages, and more) against their
  plain versions on the same inputs, seeded cotangents: float64 within
  TOL64, float32 within 2e-3 of each output's largest entry (the
  covariances' by their symmetric parts, the kernels reading one
  triangle); an output whose largest entry is within that tolerance of
  the call's largest gradient (0 but for rounding: C's at T = 2 from the
  reference seed, where x_s[1] = x_pred[1]) within it of that gradient,
  absolutely; one launch of 12' a call."""
  spec, a, d = _card_case(name, dtype, 37, cuda_device, T)
  tol = TOL64 if dtype == torch.float64 else 2e-3
  ss = smooth_scan
  g = torch.Generator(device=cuda_device)
  g.manual_seed(25)
  r = lambda like: torch.randn(like.shape, generator=g,  # noqa: E731
                               device=cuda_device, dtype=dtype)

  def held(kern, plain):
    pairs = []
    for k, p in zip(kern, plain):
      if k is None or not k.numel():
        continue
      k, p = k.double().cpu(), p.double().cpu()
      if k.dim() >= 2 and k.shape[-1] == k.shape[-2]:
        k, p = k + k.transpose(-1, -2), p + p.transpose(-1, -2)
      pairs.append((k, p))
    big = max(float(p.abs().max()) for _, p in pairs)
    for k, p in pairs:
      if float(p.abs().max()) > tol * big:
        assert cov_err(k, p) <= tol
      else:
        assert float((k - p).abs().max()) <= tol * big

  C = ss.smooth_gains(spec, {}, *a, d, elements=False)
  gx, gP = r(a[0]), r(a[1])
  n0 = ss.smooth_backward_adjoint.launches
  for ref_seed in (False, True):
    kw = dict(norm_quats=True, reference_seed=ref_seed)
    xs, Ps = ss.smooth_backward(spec, {}, *a, C, **kw)
    args = (spec, {}, *a, C, xs, Ps, gx, gP)
    held(ss.smooth_backward_adjoint(*args, **kw),
         ss.smooth_backward_adjoint_reference(*args, **kw))
  assert ss.smooth_backward_adjoint.launches == n0 + 2
  if T == 1:
    return
  gC = r(C)
  held(ss.smooth_gains_adjoint(spec, {}, *a, d, C, gC=gC),
       ss.smooth_gains_adjoint_reference(spec, {}, *a, d, C, gC=gC))
  C, b, V = ss.smooth_gains(spec, {}, *a, d)
  _, e, D = ss.affine_suffix_scan(C, b, V)
  kw = dict(gC=r(C), gb=r(b), gV=r(V), e=e, D=D)
  held(ss.smooth_gains_adjoint(spec, {}, *a, d, C, **kw),
       ss.smooth_gains_adjoint_reference(spec, {}, *a, d, C, **kw))
