"""The offline RTS smoother's kernels 11-14 over a bank of logs: launchers
and plain versions.

The JAX package runs its smoother as one XLA program
(rednose_tpu/smoothing/rts.py:_jit_rts, jax.jit of rts_smooth or
rts_smooth_parallel); here it is four hand-written CUDA kernels, which
smoothing/rts.py strings together on the card:

  * kernel 11, `smooth_gains` (csrc/smooth.cuh): the gains C_k = P_{k|k}
    F_k^T P_{k+1|k}^-1 of every (lane, k) on the main error block and,
    with elements=True, the parallel form's elements b_k = C_k u_{k+1},
    V_k = C_k (P_{k+1|k+1} - P_{k+1|k}) C_k^T; its refine variant (C and
    the corrections e given) the Newton pass's A_k = C_k J_v, b_k = C_k
    (v - J_v e_{k+1}) with v(e) = inv_err(x_{k+1|k}, inject(x_{k+1|k+1},
    e)) and J_v = dv/de. Replaces _smoother_gain (:49) under the reverse
    lax.scan and the gains / elements / refine elements of
    rts_smooth_parallel (:314-342, :372-393).
  * kernel 12, `smooth_backward` (csrc/smooth.cuh): the sequential
    backward pass from kernel 11's gains, a chain over k for each lane;
    replaces the reverse lax.scan's body (:95-121).
  * kernel 13, `affine_suffix_scan` (csrc/affine_scan.cu): the inclusive
    suffix combine of affine maps (A, b[, V]) along time, three passes over
    chunks of AFFINE_CHUNK (totals, carry, apply), a warp or a few a chunk,
    each thread a register tile of the products, the elements staged ahead
    by cp.async; replaces _suffix_scan_lane (:157) and the associative_scan
    (:351).
  * kernel 14, `smooth_inject` (csrc/smooth.cuh): x_s = inject(x_{k|k},
    [e_k, 0]), P_s = sym(P_{k|k} + pad(D_k)), the rows past the elements
    copied; replaces the parallel form's inject and covariance add
    (:358-364, :395-397).

and their adjoints, the backward of jax.grad through _jit_rts, which
smoothing/rts.py's autograd rules string together:

  * kernel 11', `smooth_gains_adjoint` (csrc/smooth_adjoint.cuh): the
    cotangents of kernel 11's inputs (x_{k|k}, P_{k|k}, P_{k+1|k} and in
    the parallel form x_{k+1|k}, x_{k+1|k+1}, P_{k+1|k+1}; dt_k, the
    params) from those of C (and of b, V: kernel 13''s lambda, Lambda,
    with the scan's share of C's); it refactors P_{k+1|k} and solves once
    more; F's cotangent goes through the emitted VJP of F (second
    derivatives of f).
  * kernel 12', `smooth_backward_adjoint` (csrc/smooth_adjoint.cuh): kernel
    12's chain run forward in time, carrying x_s[k]'s and P_s[k]'s total
    cotangents; gives C's to 11'. Three kernels of one call: each step's
    state map A_k in a pass before (every SM), the two chains (a block a
    lane: A_k's matvec and kernel 12's two products a step, fed by a
    staged ring), the rest of each step in a pass after.
  * kernel 13', `affine_suffix_scan_adjoint` (csrc/affine_scan.cu):
    lambda_k = gb_k + A_{k-1}^T lambda_{k-1}, Lambda_k = gV_k + A_{k-1}^T
    Lambda_{k-1} A_{k-1}: kernel 13's passes on the transposed maps over
    reversed time, read in place.
  * kernel 14', `smooth_inject_adjoint` (csrc/smooth_adjoint.cuh): the
    inject's VJP (emitted) and the covariance add's, a warp a row.

The spec enters kernels 11, 12 and 14 only through its error-state
functions, emitted per spec and params names by ops/entry_slab.py (mode
"smooth"), one build for float32 and float64; their adjoints through
those functions and their VJPs (ops/adjoint.py, mode "smooth_adjoint", a
source of its own); kernels 13 and 13' are built once per main-block
size. All build at first use (rednose_tpu_torch/_build.py).

Layout, lane-major with time next, every matrix row-major (the stacks
runtime/scan.py's op returns): x_pred, x_post (B, T, dim_x); P_pred,
P_post (B, T, de, de); dts (B, T - 1); elements (B, T - 1, d2, d2) and
(B, T - 1, d2) for d2 = spec.dim_main_err.

Each wrapper runs its plain version (`*_reference`, plain torch in the
same layouts; an adjoint's is the VJP of the forward's plain version)
for CPU tensors and launches its kernel for CUDA tensors (contiguous,
float32 or float64), or raises; nothing falls back.
`.launches` counts the launches (kernel 13's three passes are one call of
its entry). `*_info` read the launch shape: threads, shared memory,
blocks an SM, registers and stack.
"""

from __future__ import annotations

import functools

import torch
from torch.func import jacfwd, vmap

from rednose_tpu_torch import _build
from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops import entry_slab

_SCALARS = (torch.float32, torch.float64)
# elements a chunk of kernel 13's three passes (csrc/affine_scan.cu); the
# chunking sets the order of the combines, so another chunk is not bitwise
AFFINE_CHUNK = 64


@functools.lru_cache(maxsize=None)
def smooth_source(spec: FilterSpec, pnames: tuple) -> str:
  """The emitted source of kernels 11, 12 and 14 for a spec and its params'
  names (in the params vector's order)."""
  return entry_slab.emit_source(spec, "smooth", (), None, tuple(pnames))


def affine_source(d: int) -> str:
  """Kernel 13's source for d x d elements."""
  return (f"// kernel 13 for {d} x {d} elements (ops/smooth_scan.py)\n"
          f"#define RN_AFFINE_D {d}\n#include \"affine_scan.cu\"\n")


def pnames_of(params) -> tuple:
  return tuple(sorted(params))


def _prm(params, pnames, dtype, device):
  """The params vector (one 0 for none) on the device."""
  vals = [torch.as_tensor(params[k], dtype=dtype, device=device).reshape(())
          for k in pnames]
  if any(v.ndim for v in vals):
    raise ValueError("the smoother's kernels take scalar params")
  return (torch.stack(vals) if vals
          else torch.zeros(1, dtype=dtype, device=device))


def _dtype(t):
  if t.dtype not in _SCALARS:
    raise ValueError(f"the smoother's kernels take float32 or float64, not "
                     f"{t.dtype}")
  return t.dtype


def _stream(t):
  return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t):
  return None if t is None else t.data_ptr()


# ------------------------------------------------------------- kernel 11

def smooth_gains(spec: FilterSpec, params, x_pred, P_pred, x_post, P_post,
                 dts, *, elements: bool = True, C=None, e=None,
                 norm_quats: bool = False):
  """Kernel 11 over B logs of T steps.

  Gains (C None): C (B, T - 1, d2, d2) and, with elements, (C, b, V).
  Refine variant (C from the gains call and e (B, ne, d2) given, P_pred,
  P_post and dts unused): (A, b), element k linearized at the correction
  e[:, k + 1] of step k + 1 (0 where k + 1 >= ne) through the spec's
  inject with norm_quats."""
  if x_post.device.type == "cpu":
    return smooth_gains_reference(spec, params, x_pred, P_pred, x_post,
                                  P_post, dts, elements=elements, C=C, e=e,
                                  norm_quats=norm_quats)
  dtype = _dtype(x_post)
  B, T = x_post.shape[:2]
  n, d2, de, dx = T - 1, spec.dim_main_err, spec.dim_err, spec.dim_x
  chk = _build.check_tensor
  chk("x_pred", x_pred, (B, T, dx), dtype)
  chk("x_post", x_post, (B, T, dx), dtype)
  pnames = pnames_of(params)
  prm = _prm(params, pnames, dtype, x_post.device)
  lib = _build.generated_library(smooth_source(spec, pnames))
  new = x_post.new_empty
  if C is None:
    chk("P_pred", P_pred, (B, T, de, de), dtype)
    chk("P_post", P_post, (B, T, de, de), dtype)
    chk("dts", dts, (B, n), dtype)
    out = (new((B, n, d2, d2)),) + ((new((B, n, d2)), new((B, n, d2, d2)))
                                    if elements else ())
    if B * n:
      _build.check(lib.rn_smooth_gains_launch(
          x_pred.data_ptr(), P_pred.data_ptr(), x_post.data_ptr(),
          P_post.data_ptr(), dts.data_ptr(), prm.data_ptr(),
          *(_ptr(a) for a in (out + (None, None))[:3]), B, T,
          dtype == torch.float64, _stream(x_post)), "smooth_gains")
      smooth_gains.launches += 1
    return out if elements else out[0]
  chk("C", C, (B, n, d2, d2), dtype)
  if e.ndim != 3 or e.shape[0] != B:
    raise ValueError(f"e: shape {tuple(e.shape)}, expected ({B}, ne, {d2})")
  chk("e", e, (B, e.shape[1], d2), dtype)
  A, b = new((B, n, d2, d2)), new((B, n, d2))
  if B * n:
    _build.check(lib.rn_smooth_refine_launch(
        x_pred.data_ptr(), x_post.data_ptr(), C.data_ptr(), e.data_ptr(),
        e.shape[1], prm.data_ptr(), A.data_ptr(), b.data_ptr(), B, T,
        bool(norm_quats), dtype == torch.float64, _stream(x_post)),
        "smooth_gains")
    smooth_gains.launches += 1
  return A, b


smooth_gains.launches = 0


def _inject(spec, params, x, e, norm_quats):
  """inject(x, [e, 0]) (entry_slab._smooth_inject, the function kernels 11
  and 14 emit)."""
  pad = spec.dim_err - spec.dim_main_err
  dx = torch.cat([e, e.new_zeros(pad)]) if pad else e
  return entry_slab._smooth_inject(spec, params, x, dx, norm_quats)


def smooth_gains_reference(spec: FilterSpec, params, x_pred, P_pred, x_post,
                           P_post, dts, *, elements: bool = True, C=None,
                           e=None, norm_quats: bool = False):
  """Plain torch version of kernel 11 (smooth_gains' arguments and
  results), on any device: the gains through the blocked lane Cholesky
  (ops/lane_bank), the refine variant's J_v by jacfwd."""
  from rednose_tpu_torch.ops.lane_bank import (
      _mm_t,
      cho_solve_lane_blocked,
      cholesky_lane_blocked,
  )
  from rednose_tpu_torch.smoothing.rts import _F_main

  B, T = x_post.shape[:2]
  n, d2, dx = T - 1, spec.dim_main_err, spec.dim_x
  N = B * n
  nxt = lambda a: a[:, 1:].reshape((N,) + a.shape[2:])  # noqa: E731
  if C is None:
    F = _F_main(spec, params, x_post[:, :-1].reshape(N, dx),
                dts.reshape(N))
    lane = lambda P: P[..., :d2, :d2].reshape(N, d2, d2).permute(1, 2, 0)  # noqa: E731
    X = cho_solve_lane_blocked(cholesky_lane_blocked(lane(P_pred[:, 1:])),
                               _mm_t(F, lane(P_post[:, :-1])))
    Cb = X.permute(2, 1, 0).reshape(B, n, d2, d2)
    if not elements:
      return Cb
    u = vmap(lambda xp, xf: spec.inv_err(params, xp, xf)[:d2])(
        nxt(x_pred), nxt(x_post)).reshape(B, n, d2, 1)
    dP = (P_post[:, 1:, :d2, :d2] - P_pred[:, 1:, :d2, :d2])
    return Cb, (Cb @ u)[..., 0], Cb @ dP @ Cb.transpose(-1, -2)
  ne = e.shape[1]
  e_next = e.new_zeros((B, n, d2))
  m = max(min(n, ne - 1), 0)
  e_next[:, :m] = e[:, 1:m + 1]

  def v_of(xp, xq, ee):
    return spec.inv_err(params, xp, _inject(spec, params, xq, ee,
                                            norm_quats))[:d2]

  args = (nxt(x_pred), nxt(x_post), e_next.reshape(N, d2))
  J = vmap(jacfwd(v_of, argnums=2))(*args).reshape(B, n, d2, d2)
  v = vmap(v_of)(*args).reshape(B, n, d2, 1)
  w = v - J @ e_next[..., None]
  return C @ J, (C @ w)[..., 0]


# ------------------------------------------------------------- kernel 12

def smooth_backward(spec: FilterSpec, params, x_pred, P_pred, x_post,
                    P_post, C, *, norm_quats: bool = False,
                    reference_seed: bool = False):
  """Kernel 12: the sequential RTS backward pass of B logs from kernel
  11's gains C (B, T - 1, d2, d2); one block a lane (an IO warp, a state
  warp, csrc/smooth.cuh's SM_COV_WARPS covariance warps). Returns (x_smooth
  (B, T, dim_x), P_smooth (B, T, de, de)); reference_seed seeds from the
  last predicted state (smoothing/rts.rts_smooth)."""
  if x_post.device.type == "cpu":
    return smooth_backward_reference(spec, params, x_pred, P_pred, x_post,
                                     P_post, C, norm_quats=norm_quats,
                                     reference_seed=reference_seed)
  dtype = _dtype(x_post)
  B, T = x_post.shape[:2]
  d2, de, dx = spec.dim_main_err, spec.dim_err, spec.dim_x
  if T < 1:
    raise ValueError("smooth_backward: a log of no step")
  for name, t, shape in (("x_pred", x_pred, (B, T, dx)),
                         ("x_post", x_post, (B, T, dx)),
                         ("P_pred", P_pred, (B, T, de, de)),
                         ("P_post", P_post, (B, T, de, de)),
                         ("C", C, (B, T - 1, d2, d2))):
    _build.check_tensor(name, t, shape, dtype)
  pnames = pnames_of(params)
  prm = _prm(params, pnames, dtype, x_post.device)
  lib = _build.generated_library(smooth_source(spec, pnames))
  xs, Ps = x_post.new_empty((B, T, dx)), x_post.new_empty((B, T, de, de))
  if B:
    _build.check(lib.rn_smooth_backward_launch(
        x_pred.data_ptr(), P_pred.data_ptr(), x_post.data_ptr(),
        P_post.data_ptr(), C.data_ptr(), prm.data_ptr(), xs.data_ptr(),
        Ps.data_ptr(), B, T, bool(norm_quats), bool(reference_seed),
        dtype == torch.float64, _stream(x_post)), "smooth_backward")
    smooth_backward.launches += 1
  return xs, Ps


smooth_backward.launches = 0


def smooth_backward_reference(spec: FilterSpec, params, x_pred, P_pred,
                              x_post, P_post, C, *, norm_quats: bool = False,
                              reference_seed: bool = False):
  """Plain torch version of kernel 12: smoothing/rts.py's backward loop,
  one Python iteration a step, lane by lane, on any device."""
  from rednose_tpu_torch.smoothing.rts import _backward_pass

  out = [_backward_pass(spec, params, x_pred[i], P_pred[i], x_post[i],
                        P_post[i], C[i], norm_quats, reference_seed)
         for i in range(x_post.shape[0])]
  return (torch.stack([o[0] for o in out]),
          torch.stack([o[1] for o in out]))


# ------------------------------------------------------------- kernel 13

def affine_suffix_scan(A, b, V=None, *, want_A: bool = False):
  """Kernel 13: the inclusive suffix combine out[k] = x[n-1] o ... o x[k]
  of N lanes' affine elements A (N, n, d, d), b (N, n, d) [, V (N, n, d,
  d)] (smoothing/rts._affine_combine_lane, without V _affine_combine_ab).
  Returns (A_out, b_out, V_out): A_out only with want_A, V_out only with
  V (else None)."""
  if A.device.type == "cpu":
    return affine_suffix_scan_reference(A, b, V, want_A=want_A)
  dtype = _dtype(A)
  N, n, d = A.shape[:3]
  _build.check_tensor("A", A, (N, n, d, d), dtype)
  _build.check_tensor("b", b, (N, n, d), dtype)
  if V is not None:
    _build.check_tensor("V", V, (N, n, d, d), dtype)
  new = A.new_empty
  Ao = new((N, n, d, d)) if want_A else None
  bo = new((N, n, d))
  Vo = None if V is None else new((N, n, d, d))
  nc = -(-n // AFFINE_CHUNK)
  if N * n:
    tot = new((N, nc, 2 * d * d + d)) if nc > 1 else None
    excl = new((N, nc, 2 * d * d + d)) if nc > 1 else None
    lib = _build.generated_library(affine_source(d))
    _build.check(lib.rn_affine_scan_launch(
        A.data_ptr(), b.data_ptr(), _ptr(V), _ptr(Ao), bo.data_ptr(),
        _ptr(Vo), _ptr(tot), _ptr(excl), N, n, AFFINE_CHUNK,
        dtype == torch.float64, _stream(A)), "affine_suffix_scan")
    affine_suffix_scan.launches += 1
  return Ao, bo, Vo


affine_suffix_scan.launches = 0


def affine_suffix_scan_reference(A, b, V=None, *, want_A: bool = False):
  """Plain torch version of kernel 13: smoothing/rts._suffix_scan_lane
  (the doubling scan) lane by lane, on any device."""
  from rednose_tpu_torch.smoothing.rts import _suffix_scan_lane

  lm = lambda a: a.permute(*range(1, a.ndim), 0)  # noqa: E731
  outs = []
  for i in range(A.shape[0]):
    elems = (lm(A[i]), lm(b[i][..., None])) + (
        () if V is None else (lm(V[i]),))
    outs.append(_suffix_scan_lane(*elems) if A.shape[1] else elems)
  back = lambda a: a.permute(a.ndim - 1, *range(a.ndim - 1))  # noqa: E731
  st = lambda j: torch.stack([back(o[j]) for o in outs])  # noqa: E731
  return (st(0) if want_A else None, st(1)[..., 0],
          None if V is None else st(2))


# ------------------------------------------------------------- kernel 14

def smooth_inject(spec: FilterSpec, params, x_post, P_post, e, D, *,
                  norm_quats: bool = False):
  """Kernel 14 over B logs of T rows: rows k < n = e.shape[1] injected,
  x_s = inject(x_post[k], [e[k], 0]), P_s = sym(P_post[k] + pad(D[k]));
  the rows from n on copied. e (B, n, d2), D (B, n, d2, d2). Returns
  (x_smooth (B, T, dim_x), P_smooth (B, T, de, de))."""
  if x_post.device.type == "cpu":
    return smooth_inject_reference(spec, params, x_post, P_post, e, D,
                                   norm_quats=norm_quats)
  dtype = _dtype(x_post)
  B, T = x_post.shape[:2]
  n, d2, de, dx = e.shape[1], spec.dim_main_err, spec.dim_err, spec.dim_x
  if n > T:
    raise ValueError(f"smooth_inject: {n} corrections for {T} rows")
  for name, t, shape in (("x_post", x_post, (B, T, dx)),
                         ("P_post", P_post, (B, T, de, de)),
                         ("e", e, (B, n, d2)), ("D", D, (B, n, d2, d2))):
    _build.check_tensor(name, t, shape, dtype)
  pnames = pnames_of(params)
  prm = _prm(params, pnames, dtype, x_post.device)
  lib = _build.generated_library(smooth_source(spec, pnames))
  xs, Ps = x_post.new_empty((B, T, dx)), x_post.new_empty((B, T, de, de))
  if B * T:
    _build.check(lib.rn_smooth_inject_launch(
        x_post.data_ptr(), P_post.data_ptr(), e.data_ptr(), D.data_ptr(),
        prm.data_ptr(), xs.data_ptr(), Ps.data_ptr(), B, T, n,
        bool(norm_quats), dtype == torch.float64, _stream(x_post)),
        "smooth_inject")
    smooth_inject.launches += 1
  return xs, Ps


smooth_inject.launches = 0


def smooth_inject_reference(spec: FilterSpec, params, x_post, P_post, e, D,
                            *, norm_quats: bool = False):
  """Plain torch version of kernel 14, on any device."""
  from rednose_tpu_torch.smoothing.rts import _pad_block, _sym

  B, n = e.shape[:2]
  dx = spec.dim_x
  xs = vmap(lambda x, ee: _inject(spec, params, x, ee, norm_quats))(
      x_post[:, :n].reshape(B * n, dx), e.reshape(B * n, -1))
  Ps = _sym(P_post[:, :n] + _pad_block(D, spec.dim_err))
  return (torch.cat([xs.reshape(B, n, dx), x_post[:, n:]], dim=1),
          torch.cat([Ps, P_post[:, n:]], dim=1))


# ------------------------------------------- the adjoints: 11' to 14'
# Each takes the forward's inputs and the outputs it saved, and the
# cotangents of its outputs (None: 0), and returns the cotangents of its
# inputs: covariances as full matrices of the entries the kernel reads
# (the gains' Cholesky reads one triangle; smoothing/rts.py symmetrizes
# the totals), the params' per lane (B, NP), summed over the steps in
# float64.

@functools.lru_cache(maxsize=None)
def smooth_adjoint_source(spec: FilterSpec, pnames: tuple) -> str:
  """The emitted source of kernels 11', 12' and 14' (mode
  "smooth_adjoint") for a spec and its params' names."""
  from rednose_tpu_torch.ops import adjoint

  return adjoint.smooth_adjoint_source(spec, tuple(pnames))


def _zeros_or(t, like):
  return torch.zeros_like(like) if t is None else t


def _shares(gp, np_):
  """(B, n, NPP) per-step shares of the params' cotangent -> (B, NP),
  summed in float64."""
  return gp[..., :np_].double().sum(1)


def _vjp(fn, primals, cotangents):
  """The VJP of fn at primals for its outputs' cotangents (torch.func.vjp:
  it also runs inside a custom op's backward, below the autograd key); an
  input no output reads gets 0."""
  _, vjp = torch.func.vjp(fn, *primals)
  return vjp(tuple(cotangents))


def _lanes_vjp(fn, primals, cotangents, np_):
  """The VJP of fn (every primal and cotangent (B, ...), the params vector
  shared, last in primals): the cotangents, the params' (B, NP) a lane in
  float64 (lane by lane where the spec takes params, else one VJP of the
  whole bank)."""
  if np_ == 0:
    return _vjp(fn, primals, cotangents)[:-1] + (
        primals[0].new_zeros((primals[0].shape[0], 0), dtype=torch.float64),)
  outs = []
  for i in range(primals[0].shape[0]):
    one = tuple(a[i:i + 1] for a in primals[:-1]) + (primals[-1],)
    outs.append(_vjp(fn, one, tuple(c[i:i + 1] for c in cotangents)))
  return tuple(torch.cat([o[j] for o in outs])
               for j in range(len(primals) - 1)) + (
      torch.stack([o[-1][:np_].double() for o in outs]),)


def _params_fn(params, x):
  """(pnames, the params vector (one 0 for none), the names' dict of a
  vector) for a plain version's VJP."""
  pnames = pnames_of(params)
  prm = _prm(params, pnames, x.dtype, x.device).detach()
  return pnames, prm, lambda pv: dict(zip(pnames, pv))


def smooth_gains_adjoint(spec: FilterSpec, params, x_pred, P_pred, x_post,
                         P_post, dts, C, *, gC=None, gb=None, gV=None,
                         e=None, D=None):
  """Kernel 11': the cotangents of kernel 11's inputs from those of its
  outputs. Gains only (gb None): gC (B, T - 1, d2, d2) of C. The parallel
  form: gb, gV the cotangents of b and V (kernel 13''s lambda and
  Lambda), e and D (B, T - 1, ...) the forward scan's outputs, whose
  share lambda_k e_{k+1}^T + Lambda_k C_k (D_{k+1} + D_{k+1}^T) it adds
  to gC (gC None: 0). Returns (g x_pred, g P_pred, g x_post, g P_post
  (B, T, ...), g dts (B, T - 1), g params (B, NP) float64)."""
  if x_post.device.type == "cpu":
    return smooth_gains_adjoint_reference(
        spec, params, x_pred, P_pred, x_post, P_post, dts, C, gC=gC, gb=gb,
        gV=gV, e=e, D=D)
  dtype = _dtype(x_post)
  B, T = x_post.shape[:2]
  n, d2, de, dx = T - 1, spec.dim_main_err, spec.dim_err, spec.dim_x
  par = gb is not None
  chk = _build.check_tensor
  for name, t, shape in (
      ("x_pred", x_pred, (B, T, dx)), ("x_post", x_post, (B, T, dx)),
      ("P_pred", P_pred, (B, T, de, de)), ("P_post", P_post, (B, T, de, de)),
      ("dts", dts, (B, n)), ("C", C, (B, n, d2, d2)),
      ("gC", gC, (B, n, d2, d2)), ("gb", gb, (B, n, d2)),
      ("gV", gV, (B, n, d2, d2)), ("e", e, (B, n, d2)),
      ("D", D, (B, n, d2, d2))):
    if t is not None:
      chk(name, t, shape, dtype)
  if par and (gV is None or e is None or D is None):
    raise ValueError("smooth_gains_adjoint: the parallel form takes gb, gV, "
                     "e and D")
  pnames = pnames_of(params)
  np_, npp = len(pnames), max(len(pnames), 1)
  prm = _prm(params, pnames, dtype, x_post.device)
  lib = _build.generated_library(smooth_adjoint_source(spec, pnames))
  new = x_post.new_zeros
  gxq0, gPq0, gPp1 = new((B, n, dx)), new((B, n, d2, d2)), new((B, n, d2, d2))
  gdts, gp = new((B, n)), new((B, n, npp))
  gxp1, gxq1, gPq1 = ((new((B, n, dx)), new((B, n, dx)),
                       new((B, n, d2, d2))) if par else (None,) * 3)
  if B * n:
    _build.check(lib.rn_smooth_gains_adjoint_launch(
        *(_ptr(a) for a in (x_pred, P_pred, x_post, P_post, dts, prm, C, gC,
                            gb, gV, e, D, gxq0, gPq0, gPp1, gdts, gp, gxp1,
                            gxq1, gPq1)), B, T, dtype == torch.float64,
        _stream(x_post)), "smooth_gains_adjoint")
    smooth_gains_adjoint.launches += 1
  g_xp, g_xq = new((B, T, dx)), new((B, T, dx))
  g_Pp, g_Pq = new((B, T, de, de)), new((B, T, de, de))
  g_xq[:, :-1] += gxq0
  g_Pq[:, :-1, :d2, :d2] += gPq0
  g_Pp[:, 1:, :d2, :d2] += gPp1
  if par:
    g_xp[:, 1:] += gxp1
    g_xq[:, 1:] += gxq1
    g_Pq[:, 1:, :d2, :d2] += gPq1
  return g_xp, g_Pp, g_xq, g_Pq, gdts, _shares(gp, np_)


smooth_gains_adjoint.launches = 0


def _scan_share(C, gb, gV, e, D):
  """The suffix scan's share of C's cotangent: the VJP of A -> (A e_{k+1},
  A D_{k+1} A^T) at (gb, gV), e_n = D_n = 0."""
  e1 = torch.cat([e[:, 1:], torch.zeros_like(e[:, :1])], dim=1)
  D1 = torch.cat([D[:, 1:], torch.zeros_like(D[:, :1])], dim=1)
  return _vjp(lambda A: ((A @ e1[..., None])[..., 0],
                         A @ D1 @ A.transpose(-1, -2)), (C,), (gb, gV))[0]


def smooth_gains_adjoint_reference(spec: FilterSpec, params, x_pred, P_pred,
                                   x_post, P_post, dts, C, *, gC=None,
                                   gb=None, gV=None, e=None, D=None):
  """Plain torch version of kernel 11' (smooth_gains_adjoint's arguments
  and results), on any device: the VJP (_vjp) of smooth_gains_reference
  (lane by lane where the spec takes params), the scan's share the VJP
  of its one-step combine. `.launches` counts its runs (as the other
  adjoints' plain versions')."""
  _, prm, named = _params_fn(params, x_post)
  par = gb is not None
  gC = _zeros_or(gC, C)
  if par:
    gC = gC + _scan_share(C, gb, gV, e, D)

  def fn(xp, Pp, xq, Pq, dd, pv):
    out = smooth_gains_reference(spec, named(pv), xp, Pp, xq, Pq, dd,
                                 elements=par)
    return out if par else (out,)

  smooth_gains_adjoint_reference.launches += 1
  return _lanes_vjp(fn, (x_pred, P_pred, x_post, P_post, dts, prm),
                    (gC, gb, gV) if par else (gC,), len(params))


smooth_gains_adjoint_reference.launches = 0


def smooth_backward_adjoint(spec: FilterSpec, params, x_pred, P_pred, x_post,
                            P_post, C, xs, Ps, gxs, gPs, *,
                            norm_quats: bool = False,
                            reference_seed: bool = False):
  """Kernel 12': the cotangents of kernel 12's inputs from those of its
  outputs x_smooth (gxs) and P_smooth (gPs), either None for 0; xs, Ps
  the forward's outputs. A chain over k forward in time, a block a lane,
  between a pass before and a pass after over every step (one call, its
  scratch from backward_adjoint_scratch). Returns (g x_pred, g P_pred, g x_post, g P_post (B, T, ...), g C (B,
  T - 1, d2, d2), g params (B, NP) float64)."""
  if x_post.device.type == "cpu":
    return smooth_backward_adjoint_reference(
        spec, params, x_pred, P_pred, x_post, P_post, C, xs, Ps, gxs, gPs,
        norm_quats=norm_quats, reference_seed=reference_seed)
  dtype = _dtype(x_post)
  B, T = x_post.shape[:2]
  d2, de, dx = spec.dim_main_err, spec.dim_err, spec.dim_x
  if T < 1:
    raise ValueError("smooth_backward_adjoint: a log of no step")
  for name, t, shape in (("x_pred", x_pred, (B, T, dx)),
                         ("x_post", x_post, (B, T, dx)),
                         ("P_pred", P_pred, (B, T, de, de)),
                         ("P_post", P_post, (B, T, de, de)),
                         ("C", C, (B, T - 1, d2, d2)),
                         ("xs", xs, (B, T, dx)), ("Ps", Ps, (B, T, de, de)),
                         ("gxs", gxs, (B, T, dx)),
                         ("gPs", gPs, (B, T, de, de))):
    if t is not None:
      _build.check_tensor(name, t, shape, dtype)
  pnames = pnames_of(params)
  prm = _prm(params, pnames, dtype, x_post.device)
  lib = _build.generated_library(smooth_adjoint_source(spec, pnames))
  new = x_post.new_zeros
  g_xp, g_xq = new((B, T, dx)), new((B, T, dx))
  g_Pp, g_Pq = new((B, T, de, de)), new((B, T, de, de))
  g_C, gp = new((B, T - 1, d2, d2)), new((B, T - 1, max(len(pnames), 1)))
  if B:
    work = backward_adjoint_scratch(spec, pnames, B, T, dtype, x_post.device)
    _build.check(lib.rn_smooth_backward_adjoint_launch(
        *(_ptr(a) for a in (x_pred, P_pred, x_post, P_post, C, prm, xs, Ps,
                            gxs, gPs, g_xp, g_Pp, g_xq, g_Pq, g_C, gp,
                            work)),
        B, T, bool(norm_quats), bool(reference_seed),
        dtype == torch.float64, _stream(x_post)), "smooth_backward_adjoint")
    smooth_backward_adjoint.launches += 1
  return g_xp, g_Pp, g_xq, g_Pq, g_C, _shares(gp, len(pnames))


smooth_backward_adjoint.launches = 0


def backward_adjoint_scratch(spec: FilterSpec, pnames, B: int, T: int,
                             dtype, device, lib=None):
  """Kernel 12''s scratch for B lanes of T steps: each step's state map
  and each row's x_s total (csrc/smooth_adjoint.cuh,
  rn_smooth_backward_adjoint_work), uninitialized. lib: the build to ask
  (default the spec's)."""
  import ctypes

  lib = lib or _build.generated_library(smooth_adjoint_source(
      spec, tuple(pnames)))
  out = ctypes.c_longlong()
  _build.check(lib.rn_smooth_backward_adjoint_work(
      B, T, dtype == torch.float64, ctypes.addressof(out)),
      "rn_smooth_backward_adjoint_work")
  return torch.empty(out.value, dtype=dtype, device=device)


def smooth_backward_adjoint_reference(spec: FilterSpec, params, x_pred,
                                      P_pred, x_post, P_post, C, xs, Ps, gxs,
                                      gPs, *, norm_quats: bool = False,
                                      reference_seed: bool = False):
  """Plain torch version of kernel 12', on any device: the VJP (_vjp) of
  kernel 12's backward loop (smoothing/rts.py's), vmapped over the lanes
  (xs and Ps unused)."""
  from rednose_tpu_torch.smoothing.rts import _backward_pass

  _, prm, named = _params_fn(params, x_post)

  def fn(xp, Pp, xq, Pq, CC, pv):
    return vmap(lambda *a: _backward_pass(spec, named(pv), *a, norm_quats,
                                          reference_seed))(xp, Pp, xq, Pq, CC)

  smooth_backward_adjoint_reference.launches += 1
  return _lanes_vjp(fn, (x_pred, P_pred, x_post, P_post, C, prm),
                    (_zeros_or(gxs, x_post), _zeros_or(gPs, P_post)),
                    len(params))


smooth_backward_adjoint_reference.launches = 0


def affine_suffix_scan_adjoint(A, gb, gV=None):
  """Kernel 13': the cotangents (lambda, Lambda) of the elements' b and V
  of affine_suffix_scan(A, b, V) from those of its outputs b_out (gb (N,
  n, d)) and V_out (gV (N, n, d, d); None: the (A, b) scan, Lambda None):
  lambda_k = gb_k + A_{k-1}^T lambda_{k-1}, Lambda_k = gV_k + A_{k-1}^T
  Lambda_{k-1} A_{k-1}, kernel 13 on the transposed maps backward in time
  (csrc/affine_scan.cu, entry rn_affine_scan_adjoint_launch; three passes,
  one entry call, counted once). A's cotangent is kernel 11''s to form."""
  if A.device.type == "cpu":
    return affine_suffix_scan_adjoint_reference(A, gb, gV)
  dtype = _dtype(A)
  N, n, d = A.shape[:3]
  _build.check_tensor("A", A, (N, n, d, d), dtype)
  _build.check_tensor("gb", gb, (N, n, d), dtype)
  if gV is not None:
    _build.check_tensor("gV", gV, (N, n, d, d), dtype)
  new = A.new_empty
  lam = new((N, n, d))
  Lam = None if gV is None else new((N, n, d, d))
  nc = -(-n // AFFINE_CHUNK)
  if N * n:
    tot = new((N, nc, 2 * d * d + d)) if nc > 1 else None
    excl = new((N, nc, 2 * d * d + d)) if nc > 1 else None
    lib = _build.generated_library(affine_source(d))
    _build.check(lib.rn_affine_scan_adjoint_launch(
        A.data_ptr(), gb.data_ptr(), _ptr(gV), lam.data_ptr(), _ptr(Lam),
        _ptr(tot), _ptr(excl), N, n, AFFINE_CHUNK, dtype == torch.float64,
        _stream(A)), "affine_suffix_scan_adjoint")
    affine_suffix_scan_adjoint.launches += 1
  return lam, Lam


affine_suffix_scan_adjoint.launches = 0


def affine_suffix_scan_adjoint_reference(A, gb, gV=None):
  """Plain torch version of kernel 13', on any device: the VJP (_vjp) of
  affine_suffix_scan_reference with respect to b and V (linear in them:
  taken at 0)."""
  def fn(b, V=None):
    _, bo, Vo = affine_suffix_scan_reference(A, b, V)
    return (bo,) if V is None else (bo, Vo)

  prim = (torch.zeros_like(gb),) + (() if gV is None
                                     else (torch.zeros_like(gV),))
  g = _vjp(fn, prim, (gb,) if gV is None else (gb, gV))
  affine_suffix_scan_adjoint_reference.launches += 1
  return g[0], (None if gV is None else g[1])


affine_suffix_scan_adjoint_reference.launches = 0


def smooth_inject_adjoint(spec: FilterSpec, params, x_post, P_post, e, D,
                          gxs, gPs, *, norm_quats: bool = False):
  """Kernel 14': the cotangents of kernel 14's inputs from those of its
  outputs (gxs, gPs (B, T, ...); either None for 0), a warp a row.
  Returns (g x_post, g P_post (B, T, ...), g e (B, n, d2), g D (B, n, d2,
  d2), g params (B, NP) float64)."""
  if x_post.device.type == "cpu":
    return smooth_inject_adjoint_reference(spec, params, x_post, P_post, e,
                                           D, gxs, gPs, norm_quats=norm_quats)
  dtype = _dtype(x_post)
  B, T = x_post.shape[:2]
  n, d2, de, dx = e.shape[1], spec.dim_main_err, spec.dim_err, spec.dim_x
  if n > T:
    raise ValueError(f"smooth_inject_adjoint: {n} corrections for {T} rows")
  for name, t, shape in (("x_post", x_post, (B, T, dx)),
                         ("P_post", P_post, (B, T, de, de)),
                         ("e", e, (B, n, d2)), ("D", D, (B, n, d2, d2)),
                         ("gxs", gxs, (B, T, dx)),
                         ("gPs", gPs, (B, T, de, de))):
    if t is not None:
      _build.check_tensor(name, t, shape, dtype)
  pnames = pnames_of(params)
  prm = _prm(params, pnames, dtype, x_post.device)
  lib = _build.generated_library(smooth_adjoint_source(spec, pnames))
  new = x_post.new_empty
  g_xq, g_Pq = new((B, T, dx)), new((B, T, de, de))
  ge, gD = new((B, n, d2)), new((B, n, d2, d2))
  gp = new((B, T, max(len(pnames), 1)))
  if B * T:
    _build.check(lib.rn_smooth_inject_adjoint_launch(
        *(_ptr(a) for a in (x_post, e, gxs, gPs, prm, g_xq, g_Pq, ge, gD,
                            gp)), B, T, n, bool(norm_quats),
        dtype == torch.float64, _stream(x_post)), "smooth_inject_adjoint")
    smooth_inject_adjoint.launches += 1
  return g_xq, g_Pq, ge, gD, _shares(gp, len(pnames))


smooth_inject_adjoint.launches = 0


def smooth_inject_adjoint_reference(spec: FilterSpec, params, x_post, P_post,
                                    e, D, gxs, gPs, *,
                                    norm_quats: bool = False):
  """Plain torch version of kernel 14', on any device: the VJP (_vjp) of
  smooth_inject_reference."""
  _, prm, named = _params_fn(params, x_post)

  def fn(xq, Pq, ee, DD, pv):
    return smooth_inject_reference(spec, named(pv), xq, Pq, ee, DD,
                                   norm_quats=norm_quats)

  smooth_inject_adjoint_reference.launches += 1
  return _lanes_vjp(fn, (x_post, P_post, e, D, prm),
                    (_zeros_or(gxs, x_post), _zeros_or(gPs, P_post)),
                    len(params))


smooth_inject_adjoint_reference.launches = 0


# ------------------------------------------------------------ launch shapes

_INFO_KEYS = ("threads", "smem_bytes", "blocks_per_sm", "registers",
              "local_bytes")
# each kernel's design constants, after the launch shape
# (csrc/smooth.cuh, rn_smooth_info)
_DESIGN_KEYS = {
    "gains": ("items_per_block", "tile", "F_parts", "row_stride"),
    "refine": ("items_per_block", "tile", "F_parts", "row_stride"),
    "backward": ("cov_warps", "ring_stages", "tile_M1", "tile_M"),
    "inject": ("rows_per_block",),
}
# kernel 13's design constants a pass (csrc/affine_scan.cu, RN_AF_*)
_AFFINE_KEYS = ("ring_stages", "tile_rows", "row_split", "tile_cols")


def _info(fn, *args, keys=_INFO_KEYS):
  import ctypes

  out = (ctypes.c_int * 9)()
  _build.check(fn(*args, ctypes.addressof(out)), fn.__name__)
  return dict(zip(keys, out))


def smooth_info(spec: FilterSpec, pnames=(), dtype=torch.float32) -> dict:
  """The launch shape of kernels 11 (and its refine variant), 12 and 14
  for a spec, as the CUDA runtime reads it, with each one's design
  constants: {kernel: {threads, smem_bytes, blocks_per_sm, registers,
  local_bytes, ...}} (_DESIGN_KEYS: kernel 11's items a block, register
  tile, F's parts and row stride; kernel 12's covariance warps, ring
  stages and the tiles of its two products; kernel 14's rows a block)."""
  lib = _build.generated_library(smooth_source(spec, tuple(pnames)))
  dbl = dtype == torch.float64
  return {name: _info(lib.rn_smooth_info, i, dbl,
                      keys=_INFO_KEYS + _DESIGN_KEYS[name])
          for i, name in enumerate(("gains", "refine", "backward",
                                    "inject"))}


def affine_info(d: int, dtype=torch.float32, source=None) -> dict:
  """Kernel 13's three passes' launch shapes for d x d elements (or of the
  given build of it), each with its design: ring stages, a tile's rows,
  threads a row, a tile's columns; and kernel 13''s own passes 1 and 3
  ("totals_adjoint", "apply_adjoint"; its pass 2 is kernel 13's carry),
  not of a given build (a parent's has none)."""
  lib = _build.generated_library(source or affine_source(d))
  dbl = dtype == torch.float64
  passes = ("totals", "carry", "apply", "totals_adjoint", "apply_adjoint")
  return {name: _info(lib.rn_affine_scan_info, i, dbl,
                      keys=_INFO_KEYS + _AFFINE_KEYS)
          for i, name in enumerate(passes)
          if source is None or i < 3}


# the adjoints' design constants (csrc/smooth_adjoint.cuh,
# rn_smooth_adjoint_info); "backward_adjoint" is 12''s chain, "_pre" and
# "_post" its passes before and after
_ADJOINT_KEYS = {
    "gains_adjoint": ("items_per_block", "tile", "aux_warps",
                      "factor_in_registers"),
    "backward_adjoint": ("cov_warps", "ring_stages", "tile_W2", "tile_CP"),
    "inject_adjoint": ("rows_per_block",),
    "backward_adjoint_pre": ("items_per_block", "state_map_staged"),
    "backward_adjoint_post": ("rows_per_block", "tile"),
}


def smooth_adjoint_info(spec: FilterSpec, pnames=(),
                        dtype=torch.float32) -> dict:
  """The launch shape of kernels 11', 12' and 14' for a spec, as the CUDA
  runtime reads it, with each one's design: {kernel: {threads,
  smem_bytes, blocks_per_sm, registers, local_bytes, ...}}; kernel 13''s
  passes are affine_info's "totals_adjoint" and "apply_adjoint"."""
  lib = _build.generated_library(smooth_adjoint_source(spec, tuple(pnames)))
  dbl = dtype == torch.float64
  return {name: _info(lib.rn_smooth_adjoint_info, i, dbl,
                      keys=_INFO_KEYS + keys)
          for i, (name, keys) in enumerate(_ADJOINT_KEYS.items())}
