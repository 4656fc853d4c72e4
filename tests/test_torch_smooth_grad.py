"""Gradients through the offline RTS smoother (smoothing/rts.py): the
port's against jax.grad of the JAX package's smoothers, and the
smoother's adjoint kernels 11'-14' (ops/smooth_scan.py: smooth_gains_adjoint,
smooth_backward_adjoint, affine_suffix_scan_adjoint, smooth_inject_adjoint;
emitted mode "smooth_adjoint", ops/adjoint.py, around
csrc/smooth_adjoint.cuh, and csrc/affine_scan.cu's transposed form)
against both.

Float64, the live, kinematic and msckf_eskf families of
tests/test_torch_smooth_kernels.py (B = 2 lanes, T = 12 steps, live's and
msckf_eskf's last T_SHORT = 6; msckf_eskf's clone slots make d2 < de;
live's and msckf_eskf's (a) and (b) in
tests/test_torch_smooth_grad_live.py and _msckf.py), and the car spec
with its params (random stacks around its x0) for the params'
gradients. The loss is a seeded random
weighting of the smoothed x and P; the gradients those of x_pred,
P_pred, x_post, P_post, dts and the params.

(a) autograd through the port's plain rts_smooth (both seeds, with and
without norm_quats), rts_smooth_parallel (refine 0) and
rts_smooth_parallel_bank equals jax.grad of the JAX package's within
GRAD_TOL of each gradient's largest entry. (b) the card's route (the
custom ops and their autograd rules, rednose::rts_smooth_backward and
rednose::rts_smooth_parallel_backward) on CPU tensors, every launcher
replaced by its host build (the emitted sources built by the host C++
compiler, entries rn_smooth_*_host, rn_smooth_*_adjoint_host and
rn_affine_scan_adjoint_host) matches the same jax.grad within GRAD_TOL.
(c) on that route: a vmapped bank of 4 logs is one launch of each
adjoint, the gradients of the inputs the logs share (dts, the params) are
the sums of the per-log ones; runtime/scan's scan_fn (kernels 9 and 10's
CPU stand-ins), then the parallel smoother of the bank and the
sequential one of lane 0, is one backward of each kernel, kernel 10
included, and its gradients of Q, Rs, x0, P0 and zs equal autograd
through the plain versions. (d) what is not ported raises by name:
refine > 0 with an input that requires grad, create_graph=True,
torch.func.jvp and forward-mode AD, torch.func.grad, and on the card the
sharded smoother with an input that requires grad.

The kernels read P as a symmetric matrix (the gains' Cholesky one
triangle), so the port's gradients of P_pred and P_post are symmetric
and JAX's (its sequential gain solves by LU, reading every entry) are
not: on symmetric directions the two agree, so the tests compare G + G^T.
This file imports JAX only in a try."""

import ctypes
import functools

import numpy as np
import pytest
import torch
from torch.func import vmap

try:  # the card's machine has no JAX
  import jax
  import jax.numpy as jnp
  from rednose_tpu.models.car import CarKalman as JCar
  from rednose_tpu.smoothing import rts as jrts
except ImportError:
  jax = jnp = JCar = jrts = None
from rednose_tpu_torch.models.car import DEFAULT_PARAMS, CarKalman
from rednose_tpu_torch.ops import smooth_scan
from rednose_tpu_torch.smoothing import rts
from test_torch_smooth_kernels import (
    B_LOG,
    T_LOG,
    Host,
    _p,
    _spd,
    _t,
    _ts,
    family,
    family_T,
    host_lib,
)

# gradients against jax.grad, relative to each one's largest entry
GRAD_TOL = 1e-8
# a bank's shared-input gradients against the sums of its logs' own
# (summation order only)
SUM_TOL = 1e-12
# (live's and msckf_eskf's (a) and (b) are tests/test_torch_smooth_grad_live.py
# and tests/test_torch_smooth_grad_msckf.py: JAX compiles its parallel
# smoother's gradient for each in about a minute, so they run in files of
# their own, which the tier-1 run's workers take apart)
FAMILIES = ("kinematic", "car")
# live's and msckf_eskf's logs are cut to their last T_SHORT steps: JAX's
# parallel smoother's gradient compiles in about 40 s there, 60 s at
# T_LOG; kernel 13''s host chunk (HOST_CHUNK) still takes two chunks
T_SHORT = 6
# (form, reference_seed, norm_quats)
# (rts_smooth_parallel_bank is the parallel smoother vmapped over the
# bank in both packages: one JAX gradient serves "par" and "bank")
CASES = (("seq", False, True), ("seq", True, False), ("par", False, True),
         ("bank", False, True))
NAMES = ("x_pred", "P_pred", "x_post", "P_post", "dts", "params")
CAR_PARAMS = dict(DEFAULT_PARAMS, u=15.0, steer_angle_deg=3.0)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX (the oracle)")


@pytest.fixture(scope="module", autouse=True)
def _jax_x64():
  if jax is None:
    yield
    return
  prev = jax.config.read("jax_enable_x64")
  jax.config.update("jax_enable_x64", True)
  yield
  jax.config.update("jax_enable_x64", prev)


@functools.lru_cache(maxsize=None)
def setup(name):
  """(spec, JAX spec, params (floats), stacks (x_pred, P_pred, x_post,
  P_post), dts (B, T - 1)), float64 numpy."""
  if name != "car":
    spec, jspec, st, dts = (family_T(name, T_SHORT)
                            if name in ("live", "msckf") else family(name))
    return spec, jspec, {}, st, dts
  spec = CarKalman.build_spec()
  rng = np.random.RandomState(5)
  T, B, dx = T_LOG, B_LOG, spec.dim_x
  x0 = np.asarray(CarKalman.initial_x, np.float64)
  x0 = np.where(x0 == 0, 0.1, x0)
  xs = [x0 * (1 + 0.05 * rng.randn(B, T, dx)) for _ in range(2)]
  P_post = _spd(rng, dx, B, T, 0.01)
  P_pred = P_post + _spd(rng, dx, B, T, 0.005)
  return (spec, JCar.build_spec() if JCar else None, dict(CAR_PARAMS),
          (xs[0], P_pred, xs[1], P_post), 0.01 + 0.01 * rng.rand(B, T - 1))


def weights(name, seed=3):
  spec, _, _, st, _ = setup(name)
  rng = np.random.RandomState(seed)
  return rng.randn(*st[0].shape), rng.randn(*st[1].shape)


def _tparams(params):
  return {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
          for k, v in params.items()}


def _compared(grads):
  """name -> numpy gradient, P's by G + G^T."""
  out = {}
  for k, g in grads.items():
    g = np.asarray(g, np.float64)
    out[k] = g + np.swapaxes(g, -1, -2) if k.startswith("P_") else g
  return out


def rel_errs(a, b):
  """max |a - b| over b's largest entry, per gradient (an all-zero one,
  absolutely)."""
  a, b = _compared(a), _compared(b)
  return {k: float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(),
                                                   1e-300))
          if b[k].size else 0.0 for k in b}


# ---------------------------------------------------------------- JAX

def jax_grads(name, form, reference_seed, norm):
  return _jax_grads(name, "par" if form == "bank" else form, reference_seed,
                    norm)


@functools.lru_cache(maxsize=None)
def _jax_grads(name, form, reference_seed, norm):
  spec, jspec, params, st, dts = setup(name)
  Wx, WP = weights(name)

  def smooth(xp, Pp, xq, Pq, d, prm):
    if form == "par":   # jax.vmap of rts_smooth_parallel over the lanes
      return jrts.rts_smooth_parallel_bank(
          jspec, prm, xp, Pp, xq, Pq, jnp.asarray(_ts(dts)),
          norm_quats=norm, dts=d, refine=0)
    one = lambda *a: jrts.rts_smooth(  # noqa: E731
        jspec, prm, *a[:4], None, norm_quats=norm, dts=a[4],
        reference_seed=reference_seed)
    return jax.vmap(one)(xp, Pp, xq, Pq, d)

  def loss(*a):
    xs, Ps = smooth(*a)
    return (xs * Wx).sum() + (Ps * WP).sum()

  args = [jnp.asarray(a) for a in (*st, dts)] + [
      {k: jnp.asarray(v) for k, v in params.items()}]
  g = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*args)
  out = dict(zip(NAMES[:5], (np.asarray(a) for a in g[:5])))
  out["params"] = np.asarray([g[5][k] for k in sorted(params)])
  return out


# ------------------------------------------------------------- the port

def port_grads(name, form, reference_seed, norm, route=False):
  """The port's gradients: autograd through the plain smoothers (CPU
  tensors), or with route through the card's custom ops (whose launchers
  the caller replaced by stand-ins), vmapped over the lanes."""
  spec, _, params, st, dts = setup(name)
  Wx, WP = (_t(w) for w in weights(name))
  ins = [_t(a).requires_grad_() for a in (*st, dts)]
  prm = _tparams(params)
  t = _t(_ts(dts))
  xp, Pp, xq, Pq, d = ins
  if form == "bank":
    xs, Ps = (rts._card_rts_smooth_parallel(spec, prm, xp, Pp, xq, Pq, d,
                                            norm, 0) if route else
              rts.rts_smooth_parallel_bank(spec, prm, xp, Pp, xq, Pq, t,
                                           norm_quats=norm, dts=d, refine=0))
  elif route:
    if form == "par":
      one = lambda *a: rts._card_rts_smooth_parallel(  # noqa: E731
          spec, prm, *(v[None] for v in a), norm, 0)
      xs, Ps = vmap(lambda *a: tuple(o[0] for o in one(*a)))(
          xp, Pp, xq, Pq, d)
    else:
      xs, Ps = vmap(lambda *a: rts._card_rts_smooth(
          spec, prm, *a[:4], None, norm, a[4], reference_seed))(
              xp, Pp, xq, Pq, d)
  else:
    outs = []
    for i in range(xp.shape[0]):
      a = (xp[i], Pp[i], xq[i], Pq[i], t[i])
      outs.append(rts.rts_smooth_parallel(spec, prm, *a, norm_quats=norm,
                                          dts=d[i], refine=0)
                  if form == "par" else
                  rts.rts_smooth(spec, prm, *a, norm_quats=norm, dts=d[i],
                                 reference_seed=reference_seed))
    xs = torch.stack([o[0] for o in outs])
    Ps = torch.stack([o[1] for o in outs])
  loss = (xs * Wx).sum() + (Ps * WP).sum()
  pv = [prm[k] for k in sorted(prm)]
  g = torch.autograd.grad(loss, ins + pv, allow_unused=True)
  out = {k: v.detach().numpy() for k, v in zip(NAMES[:5], g[:5])}
  out["params"] = np.asarray([0.0 if v is None else float(v)
                              for v in g[5:]])
  return out


# ------------------------------------------------- the adjoints' host builds

_ENTRIES = {
    "rn_smooth_gains_adjoint_host": (ctypes.c_void_p,) * 20
                                    + (ctypes.c_int,) * 3,
    "rn_smooth_backward_adjoint_host": (ctypes.c_void_p,) * 17
                                       + (ctypes.c_int,) * 5,
    "rn_smooth_backward_adjoint_work": (ctypes.c_int,) * 3
                                       + (ctypes.c_void_p,),
    "rn_smooth_adjoint_parts_host": (ctypes.c_void_p,) + (ctypes.c_double,)
                                    + (ctypes.c_void_p,) * 8
                                    + (ctypes.c_int, ctypes.c_void_p),
    "rn_smooth_inject_adjoint_host": (ctypes.c_void_p,) * 10
                                     + (ctypes.c_int,) * 5,
    "rn_affine_scan_adjoint_host": (ctypes.c_void_p,) * 7
                                   + (ctypes.c_int,) * 4,
}
# kernel 13''s host chunk: small, so that the logs take all three passes
HOST_CHUNK = 4


def _lib(source):
  lib = host_lib(source)
  for name, argtypes in _ENTRIES.items():
    fn = getattr(lib, name, None)
    if fn is not None:
      fn.argtypes = list(argtypes)
      fn.restype = ctypes.c_int
  return lib


class HostAdjoint(Host):
  """The four forward launchers (Host) and the four adjoints on CPU
  tensors through their host builds, in the launchers' signatures,
  counting their calls."""

  def __init__(self):
    super().__init__()
    self.counts.update(dict.fromkeys(
        ("smooth_gains_adjoint", "smooth_backward_adjoint",
         "affine_suffix_scan_adjoint", "smooth_inject_adjoint"), 0))

  def _alib(self, spec, params):
    return _lib(smooth_scan.smooth_adjoint_source(
        spec, smooth_scan.pnames_of(params)))

  def smooth_gains_adjoint(self, spec, params, x_pred, P_pred, x_post,
                           P_post, dts, C, *, gC=None, gb=None, gV=None,
                           e=None, D=None):
    self.counts["smooth_gains_adjoint"] += 1
    B, T = x_post.shape[:2]
    self.lanes.append(B)
    n, d2, de, dx = T - 1, spec.dim_main_err, spec.dim_err, spec.dim_x
    np_ = len(params)
    par = gb is not None
    new = x_post.new_zeros
    o = [new((B, n, dx)), new((B, n, d2, d2)), new((B, n, d2, d2)),
         new((B, n)), new((B, n, max(np_, 1)))]
    o += ([new((B, n, dx)), new((B, n, dx)), new((B, n, d2, d2))] if par
          else [None] * 3)
    prm = self._prm(params, x_post)   # alive through the call
    assert self._alib(spec, params).rn_smooth_gains_adjoint_host(
        *(_p(a) for a in (x_pred, P_pred, x_post, P_post, dts, prm, C, gC,
                          gb, gV, e, D, *o)), B, T, 1) == 0
    g_xp, g_xq = new((B, T, dx)), new((B, T, dx))
    g_Pp, g_Pq = new((B, T, de, de)), new((B, T, de, de))
    g_xq[:, :-1] += o[0]
    g_Pq[:, :-1, :d2, :d2] += o[1]
    g_Pp[:, 1:, :d2, :d2] += o[2]
    if par:
      g_xp[:, 1:] += o[5]
      g_xq[:, 1:] += o[6]
      g_Pq[:, 1:, :d2, :d2] += o[7]
    return g_xp, g_Pp, g_xq, g_Pq, o[3], o[4][..., :np_].sum(1)

  def smooth_backward_adjoint(self, spec, params, x_pred, P_pred, x_post,
                              P_post, C, xs, Ps, gxs, gPs, *,
                              norm_quats=False, reference_seed=False):
    self.counts["smooth_backward_adjoint"] += 1
    B, T = x_post.shape[:2]
    self.lanes.append(B)
    np_ = len(params)
    new = x_post.new_zeros
    o = [torch.zeros_like(x_post), torch.zeros_like(P_pred),
         torch.zeros_like(x_post), torch.zeros_like(P_post),
         torch.zeros_like(C), new((B, T - 1, max(np_, 1)))]
    prm = self._prm(params, x_post)
    lib = self._alib(spec, params)
    work = smooth_scan.backward_adjoint_scratch(
        spec, smooth_scan.pnames_of(params), B, T, x_post.dtype, "cpu",
        lib=lib)
    assert lib.rn_smooth_backward_adjoint_host(
        *(_p(a) for a in (x_pred, P_pred, x_post, P_post, C, prm, xs, Ps,
                          gxs, gPs, *o, work)),
        B, T, bool(norm_quats), bool(reference_seed), 1) == 0
    return tuple(o[:5]) + (o[5][..., :np_].sum(1),)

  def affine_suffix_scan_adjoint(self, A, gb, gV=None, chunk=HOST_CHUNK):
    self.counts["affine_suffix_scan_adjoint"] += 1
    N, n, d = A.shape[:3]
    self.lanes.append(N)
    lam = A.new_zeros((N, n, d))
    Lam = None if gV is None else A.new_zeros((N, n, d, d))
    nc = -(-n // chunk)
    tot, excl = (A.new_zeros((N, nc, 2 * d * d + d)) for _ in range(2))
    assert _lib(smooth_scan.affine_source(d)).rn_affine_scan_adjoint_host(
        _p(A), _p(gb), _p(gV), _p(lam), _p(Lam), _p(tot), _p(excl), N, n,
        chunk, 1) == 0
    return lam, Lam

  def smooth_inject_adjoint(self, spec, params, x_post, P_post, e, D, gxs,
                            gPs, *, norm_quats=False):
    self.counts["smooth_inject_adjoint"] += 1
    B, T = x_post.shape[:2]
    self.lanes.append(B)
    n, np_ = e.shape[1], len(params)
    o = [torch.zeros_like(x_post), torch.zeros_like(P_post),
         torch.zeros_like(e), torch.zeros_like(D),
         x_post.new_zeros((B, T, max(np_, 1)))]
    prm = self._prm(params, x_post)
    assert self._alib(spec, params).rn_smooth_inject_adjoint_host(
        *(_p(a) for a in (x_post, e, gxs, gPs, prm, *o)), B, T, n,
        bool(norm_quats), 1) == 0
    return tuple(o[:4]) + (o[4][..., :np_].sum(1),)


def route(monkeypatch):
  """Every launcher of kernels 11-14 and 11'-14' replaced by its host
  build: returns the HostAdjoint whose counts they keep."""
  host = HostAdjoint()
  for name in host.counts:
    monkeypatch.setattr(smooth_scan, name, getattr(host, name))
  return host


def _zero(host):
  for k in host.counts:
    host.counts[k] = 0
  host.lanes.clear()


# ------------------------------------------------------------------ tests

@needs_jax
@pytest.mark.parametrize("name", FAMILIES)
def test_plain_gradients_match_jax(name):
  """(a) Autograd through the port's plain smoothers against jax.grad of
  the JAX package's, float64, within GRAD_TOL of each gradient's largest
  entry (P's by G + G^T): rts_smooth at both seeds with and without
  norm_quats, rts_smooth_parallel (refine 0) with and without, and
  rts_smooth_parallel_bank; the car's params too."""
  for case in CASES:
    errs = rel_errs(port_grads(name, *case), jax_grads(name, *case))
    assert max(errs.values()) <= GRAD_TOL, (case, errs)


@needs_jax
@pytest.mark.parametrize("name", FAMILIES)
def test_adjoint_host_builds_match_jax(name, monkeypatch):
  """(b) The card's route on CPU tensors with every kernel its host build
  (kernels 11-14 and the adjoints 11'-14') against jax.grad, float64,
  within GRAD_TOL: the sequential smoother (12' and 11') at both seeds
  and norm_quats, the parallel one and the bank (14', 13' and 11')."""
  host = route(monkeypatch)
  for form, seed, norm in CASES:
    _zero(host)
    errs = rel_errs(port_grads(name, form, seed, norm, route=True),
                    jax_grads(name, form, seed, norm))
    assert max(errs.values()) <= GRAD_TOL, ((form, seed, norm), errs)
    adj = {k: v for k, v in host.counts.items() if k.endswith("_adjoint")}
    want = ({"smooth_backward_adjoint": 1, "smooth_gains_adjoint": 1}
            if form == "seq" else
            {"smooth_inject_adjoint": 1, "affine_suffix_scan_adjoint": 1,
             "smooth_gains_adjoint": 1})
    assert adj == dict(dict.fromkeys(adj, 0), **want), (form, adj)


def test_vmapped_bank_is_one_launch_of_each_adjoint(monkeypatch):
  """(c) A vmapped bank of 4 car logs sharing dts and the params through
  the card's route: one launch of each adjoint for the bank, and the
  gradients of dts and the params the sums of the 4 logs' own (each log
  through the route alone) within SUM_TOL."""
  host = route(monkeypatch)
  spec, _, params, st, dts = setup("car")
  Wx, WP = (_t(w) for w in weights("car"))
  reps = lambda a: torch.cat([_t(a)] * 2)  # noqa: E731
  xp, Pp, xq, Pq = (reps(a) for a in st)
  W = (torch.cat([Wx] * 2), torch.cat([WP] * 2))
  d = _t(dts[0]).requires_grad_()
  prm = _tparams(params)
  pv = [prm[k] for k in sorted(prm)]
  for form in ("seq", "par"):
    def one(a, b, c, e):
      if form == "seq":
        return rts._card_rts_smooth(spec, prm, a, b, c, e, None, True, d,
                                    False)
      xs, Ps = rts._card_rts_smooth_parallel(
          spec, prm, a[None], b[None], c[None], e[None], d[None], True, 0)
      return xs[0], Ps[0]

    _zero(host)
    xs, Ps = vmap(one)(xp, Pp, xq, Pq)
    bank = torch.autograd.grad((xs * W[0]).sum() + (Ps * W[1]).sum(),
                               [d] + pv)
    adj = [k for k in host.counts if k.endswith("_adjoint")]
    want = (("smooth_backward_adjoint", "smooth_gains_adjoint")
            if form == "seq" else
            ("smooth_inject_adjoint", "affine_suffix_scan_adjoint",
             "smooth_gains_adjoint"))
    assert {k: host.counts[k] for k in adj} == {
        k: int(k in want) for k in adj}, form
    alone = []
    for i in range(4):
      xs, Ps = one(xp[i], Pp[i], xq[i], Pq[i])
      alone.append(torch.autograd.grad(
          (xs * W[0][i]).sum() + (Ps * W[1][i]).sum(), [d] + pv))
    for j in range(len(bank)):
      total = sum(a[j] for a in alone)
      scale = float(total.abs().max())
      assert float((bank[j] - total).abs().max()) <= SUM_TOL * scale, \
          (form, j)


def test_scan_then_smoother_is_one_backward_of_each_kernel(monkeypatch):
  """(c) scan_fn vmapped over a bank of 4 live logs (kernels 9 and 10 by
  their CPU stand-ins), then rts_smooth_parallel_bank's card route over
  the bank and rts_smooth's on lane 0, a seeded weighting of the smoothed
  x and P the loss: one backward runs each of 14', 13', 12', 11' (twice)
  and kernel 10 once, and its gradients of Q, Rs, x0, P0 and zs equal
  autograd through the plain versions within GRAD_TOL."""
  from test_torch_scan_stream_grad import _op_inputs, _route as scan_route

  fwd, adj = scan_route(monkeypatch)
  host = route(monkeypatch)
  from rednose_tpu_torch.runtime import scan

  spec, kinds, ki, ins, _ = _op_inputs("live")
  X0, PP0, QQ, DT, ZS, RR, EA = ins
  B = X0.shape[0]
  rng = np.random.RandomState(17)

  def smoothed(card):
    if card:
      _, st = vmap(lambda xl, Pl, zl: scan._kernel_scan(
          spec, kinds, {}, xl, Pl, QQ, DT, ki, zl, RR, EA),
          in_dims=(0, 0, 1))(X0, PP0, ZS)
    else:
      fn, _ = scan.build_scan_stream_reference(spec, kinds)
      _, st = vmap(lambda xl, Pl, zl: fn({}, xl, Pl, QQ, DT, ki, zl, RR,
                                         EA), in_dims=(0, 0, 1))(X0, PP0, ZS)
    xp, Pp, xq, Pq = st
    d = DT[1:].expand(B, -1)
    t = torch.cat([DT.new_zeros(1), torch.cumsum(DT[1:], 0)])
    if card:
      bank = rts._card_rts_smooth_parallel(spec, {}, xp, Pp, xq, Pq, d,
                                           True, 0)
      lane0 = rts._card_rts_smooth(spec, {}, xp[0], Pp[0], xq[0], Pq[0], t,
                                   True, DT[1:], False)
    else:
      bank = rts.rts_smooth_parallel_bank(spec, {}, xp, Pp, xq, Pq,
                                          t.expand(B, -1), norm_quats=True,
                                          dts=d, refine=0)
      lane0 = rts.rts_smooth(spec, {}, xp[0], Pp[0], xq[0], Pq[0], t,
                             norm_quats=True, dts=DT[1:])
    return bank + lane0

  outs = smoothed(True)
  W = [torch.as_tensor(rng.randn(*o.shape)) for o in outs]
  wanted = [QQ, RR, X0, PP0, ZS]
  card = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, W)),
                             wanted)
  assert len(fwd) == 1 and adj == [B]
  assert {k: v for k, v in host.counts.items() if k.endswith("_adjoint")} \
      == {"smooth_gains_adjoint": 2, "smooth_backward_adjoint": 1,
          "affine_suffix_scan_adjoint": 1, "smooth_inject_adjoint": 1}
  assert host.counts["smooth_gains"] == 2
  outs = smoothed(False)
  plain = torch.autograd.grad(sum((o * w).sum() for o, w in zip(outs, W)),
                              wanted)
  for name, a, b in zip(("Q", "Rs", "x0", "P0", "zs"), card, plain):
    a, b = a.numpy(), b.numpy()
    if name in ("Q", "Rs", "P0"):
      a, b = a + np.swapaxes(a, -1, -2), b + np.swapaxes(b, -1, -2)
    assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max(), name


def test_narrowed_refusals_raise_by_name(monkeypatch):
  """(d) On the card's route: refine > 0 with an input that requires grad
  names the refine passes' adjoint and launches nothing; create_graph=True
  names higher-order gradients after the forward and before any adjoint;
  torch.func.jvp and a dual tensor name forward mode; torch.func.grad
  names torch.autograd.grad. The sharded smoother on the card names its
  adjoint for an input that requires grad, before any launch."""
  from torch.autograd import forward_ad

  from rednose_tpu_torch.parallel import sharding

  host = route(monkeypatch)
  spec, _, _, st, dts = setup("kinematic")
  a = [_t(s)[0] for s in st]
  d = _t(dts)[0]
  xq = a[2].clone().requires_grad_()
  with pytest.raises(NotImplementedError, match="refine passes' adjoint"):
    rts._card_rts_smooth_parallel(spec, {}, a[0][None], a[1][None],
                                  xq[None], a[3][None], d[None], False, 2)
  assert not any(host.counts.values())
  xs, _ = rts._card_rts_smooth(spec, {}, a[0], a[1], xq, a[3], None, False,
                               d, False)
  with pytest.raises(NotImplementedError, match="create_graph"):
    torch.autograd.grad(xs.sum(), xq, create_graph=True)
  assert not any(v for k, v in host.counts.items() if k.endswith("adjoint"))
  _zero(host)

  def run(x):
    return rts._card_rts_smooth(spec, {}, a[0], a[1], x, a[3], None, False,
                                d, False)[0]

  with pytest.raises(NotImplementedError, match="forward mode"):
    torch.func.jvp(run, (a[2],), (torch.ones_like(a[2]),))
  with forward_ad.dual_level():
    with pytest.raises(NotImplementedError, match="forward mode"):
      run(forward_ad.make_dual(a[2], torch.ones_like(a[2])))
  with pytest.raises(NotImplementedError, match="torch.autograd.grad"):
    torch.func.grad(lambda x: run(x).sum())(a[2])
  assert not any(host.counts.values())
  monkeypatch.setattr(sharding, "_on_card", lambda t: True)
  t = _t(_ts(dts))[0]
  with pytest.raises(NotImplementedError,
                     match="the sharded smoother's adjoint"):
    sharding.sharded_rts_smooth_parallel(None, spec, {}, a[0], a[1], xq,
                                         a[3], t)
  assert not any(host.counts.values())
