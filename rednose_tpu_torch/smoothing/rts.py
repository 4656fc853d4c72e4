"""Rauch-Tung-Striebel smoothing: sequential and parallel-in-time.

Port of rednose_tpu/smoothing/rts.py (the reference smoother,
rednose/helpers/ekf_sym.py:651-690, is a sequential Python loop over the
estimate list):

  * `rts_smooth`, the sequential backward pass. It smooths the main
    (non-augmented) state block, takes the smoothed delta through the
    spec's inv_err / err, so it is right for an ESKF, and can renormalize
    quaternions. The gains C_k depend only on the forward pass, so they
    are computed for all k at once; the loop over k then carries only
    the smoothed state and covariance. It seeds from the last POSTERIOR
    by default; the reference seeds from the last PREDICTED state
    (ekf_sym.py:658-663), which drops the final measurement:
    `reference_seed=True` reproduces that.

  * `rts_smooth_parallel`, the parallel-in-time form. The smoothed
    correction obeys the affine backward recursion e_k = C_k (u_{k+1} +
    e_{k+1}), a first-order linear recurrence, solved by a suffix scan of
    affine maps in O(log T) depth (`_suffix_scan_lane`, a doubling scan on
    the time axis). Exact for additive error states; for an ESKF the
    recursion runs in the error tangent space, and Newton passes
    (`refine`) converge it to the sequential answer.

Both take the stacked arrays of a forward pass (runtime/scan.py) on any
device; `smooth_estimates` adapts the engine's list of Estimates.

On CUDA tensors each runs the smoother's kernels (ops/smooth_scan.py, the
JAX package's jitted smoother, _jit_rts, ported): `rts_smooth` one launch
of kernel 11 (the gains) and one of kernel 12 (the backward pass);
`rts_smooth_parallel` kernel 11 (gains and elements), kernel 13 (the
suffix scan) and kernel 14 (the inject), and for each refine pass kernel
11's refine variant and kernel 13 again; `rts_smooth_parallel_bank` the
same launches for the whole bank. Each goes through a custom op
(rednose::rts_smooth, rednose::rts_smooth_parallel) whose vmap rule
merges the vmapped axis into the op's lanes, so torch.func.vmap of either
is one launch of each kernel too. The number of launches never depends on
T.

Gradients on the card: each op's autograd rule is a backward op of its
own (rednose::rts_smooth_backward, rednose::rts_smooth_parallel_backward)
that runs the smoother's adjoint kernels (ops/smooth_scan.py), each once
a backward whatever the bank's size: kernel 12' then 11' for rts_smooth;
14', 13' then 11' for rts_smooth_parallel and rts_smooth_parallel_bank.
They give the cotangents of x_pred, P_pred, x_post, P_post, dts (of t
where dts is None, through its difference) and the params; chained after
runtime/scan's scan_fn, one backward runs them and then kernel 10. The
ops keep C (and the parallel form's e and D) as outputs of their own, so
the backward launches no forward kernel again. P's gradients are
symmetric ((G + G^T) / 2 of the entries the kernels read: the gains'
Cholesky reads one triangle), which on symmetric directions equals
jax.grad's. Not ported, and raising by name on the card: the refine
passes' adjoint (refine > 0 with an input that requires grad), higher
order (create_graph=True), forward mode (torch.func.jvp, dual tensors)
and torch.func's grad and jacrev (call torch.autograd.grad). On CPU
tensors each runs its plain version,
`rts_smooth_reference` / `rts_smooth_parallel_reference` (the bodies
below; their `.launches` count their runs), which autograd runs through.
The matrices of the plain parallel form are lane-major (d, d, T), as in
the JAX package, and its gains go through the blocked lane Cholesky
(ops/lane_bank.cholesky_lane_blocked).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.func import jacfwd, vmap

from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops import smooth_scan
from rednose_tpu_torch.ops.lane_bank import (
    _mm,
    _mm_t,
    cho_solve_lane_blocked,
    cholesky_lane_blocked,
)
from rednose_tpu_torch.ops.quaternion import normalize_slices
from rednose_tpu_torch.utils.device import resolve_device


def _sym(P):
  return 0.5 * (P + P.transpose(-1, -2))


def _pad_block(M, de):
  """(*, d2, d2) -> (*, de, de) with M in the top-left block."""
  pad = de - M.shape[-1]
  return torch.nn.functional.pad(M, (0, pad, 0, pad)) if pad else M


def _dts(t, dts):
  # only exact for float64 t: epoch-scale timestamps differenced in
  # float32 quantize dt; callers with float32 states pass host deltas
  return t[1:] - t[:-1] if dts is None else dts


def _F_main(spec: FilterSpec, params, x, dts):
  """F_k[:d2, :d2] for each row of x (T, dim_x), lane-major (d2, d2, T):
  the spec's closed form where it ships one, else jacfwd per row."""
  d2 = spec.dim_main_err
  if spec.F_lane is not None:
    return spec.F_lane(params, x.T, dts)[:d2, :d2]
  return vmap(lambda xk, dt: spec.F(params, xk, dt)[:d2, :d2],
              out_dims=2)(x, dts)


def rts_smooth(spec: FilterSpec, params, x_pred, P_pred, x_post, P_post, t,
               norm_quats: bool = False, dts=None,
               reference_seed: bool = False):
  """Sequential RTS backward pass.

  Stacked forward-pass results, time-major: x_pred (T, dim_x) x_{k|k-1},
  P_pred (T, de, de), x_post (T, dim_x) x_{k|k}, P_post (T, de, de), t
  (T,) (or host-differenced dts (T-1,)). Returns (x_smooth, P_smooth) of
  the same shapes. Only the main state block is smoothed; MSCKF clone
  slots pass through (ekf_sym.py:677-686 slices [:d1] / [:d2]).
  `reference_seed=True` seeds from the last predicted state, as the
  reference does (ekf_sym.py:658-660); the returned tail is that seed.
  CUDA tensors: kernels 11 and 12, once each (see the module docstring);
  CPU tensors: rts_smooth_reference."""
  if x_post.device.type == "cpu":
    return rts_smooth_reference(spec, params, x_pred, P_pred, x_post,
                                P_post, t, norm_quats=norm_quats, dts=dts,
                                reference_seed=reference_seed)
  return _card_rts_smooth(spec, params, x_pred, P_pred, x_post, P_post, t,
                          norm_quats, dts, reference_seed)


def _card_rts_smooth(spec, params, x_pred, P_pred, x_post, P_post, t,
                     norm_quats, dts, reference_seed):
  """rts_smooth through rednose::rts_smooth (kernels 11 and 12; in the
  backward 12' and 11'), on the device of x_post."""
  _refuse_grad(spec, (x_pred, P_pred, x_post, P_post, t, dts,
                      *params.values()))
  if x_post.shape[0] < 1:
    raise ValueError("rts_smooth: a log of no step")
  h, prm = _handle_of(spec, params, x_post)
  xs, Ps, _ = torch.ops.rednose.rts_smooth(
      x_pred[None], P_pred[None], x_post[None], P_post[None],
      _dts(t, dts)[None].to(x_post.dtype), prm, h, bool(norm_quats),
      bool(reference_seed))
  return xs[0], Ps[0]


def rts_smooth_reference(spec: FilterSpec, params, x_pred, P_pred, x_post,
                         P_post, t, norm_quats: bool = False, dts=None,
                         reference_seed: bool = False):
  """rts_smooth's plain version, on any device: the gains by
  torch.linalg.solve for every k at once (ekf_sym.py:673-677), then one
  Python iteration a step (_backward_pass). `.launches` counts its
  runs."""
  rts_smooth_reference.launches += 1
  resolve_device(x_post.device)
  d2 = spec.dim_main_err
  T = x_post.shape[0]
  C = x_post.new_zeros((0, d2, d2))
  if T > 1:
    # C_k = P_{k|k} F_k^T P_{k+1|k}^-1 for every k (ekf_sym.py:673-677):
    # solve(P_{k+1|k}, F_k P_{k|k}^T)^T
    F = _F_main(spec, params, x_post[:-1], _dts(t, dts)).permute(2, 0, 1)
    C = torch.linalg.solve(
        P_pred[1:, :d2, :d2],
        F @ P_post[:-1, :d2, :d2].transpose(-1, -2)).transpose(-1, -2)
  return _backward_pass(spec, params, x_pred, P_pred, x_post, P_post, C,
                        norm_quats, reference_seed)


rts_smooth_reference.launches = 0


def _backward_pass(spec, params, x_pred, P_pred, x_post, P_post, C,
                   norm_quats, reference_seed):
  """The backward loop over k = T-2 .. 0 from the gains C (T-1, d2, d2):
  one Python iteration a step, carrying the smoothed state and
  covariance (kernel 12's plain version)."""
  d1, d2, de = spec.dim_main, spec.dim_main_err, spec.dim_err
  T = x_post.shape[0]
  if reference_seed:
    x_next, P_next = x_pred[T - 1], P_pred[T - 1]
  else:
    x_next, P_next = x_post[T - 1], P_post[T - 1]
  xs, Ps = [x_next], [P_next]
  for k in range(T - 2, -1, -1):
    Ck, x_k = C[k], x_post[k]
    dx = spec.inv_err(params, x_pred[k + 1], x_next)
    dx = torch.cat([Ck @ dx[:d2], dx[d2:]])
    x_s = spec.err(params, x_k, dx)
    x_s = torch.cat([x_s[:d1], x_k[d1:]])
    if norm_quats:
      x_s = normalize_slices(x_s, spec.quaternion_idxs)
    M = Ck @ (P_next[:d2, :d2] - P_pred[k + 1, :d2, :d2]) @ Ck.T
    P_s = _sym(P_post[k] + _pad_block(M, de))
    xs.append(x_s)
    Ps.append(P_s)
    x_next, P_next = x_s, P_s
  return torch.stack(xs[::-1]), torch.stack(Ps[::-1])


def _affine_combine_lane(a, b):
  """Combine of the backward affine recurrence, lane-major: elements
  (A (d, d, K), b (d, 1, K), V (d, d, K)) are the maps
    e_out = A e_in + b,   D_out = V + A D_in A^T.
  `a` is the composition of LATER elements and `b` the EARLIER one, which
  the backward recursion applies outermost, so `b` wraps `a`:
    e = A_b (A_a e + b_a) + b_b."""
  A_a, b_a, V_a = a
  A_b, b_b, V_b = b
  return (_mm(A_b, A_a), _mm(A_b, b_a) + b_b,
          V_b + _mm_t(_mm(A_b, V_a), A_b))


def _affine_combine_ab(a, b):
  """(A, b)-only _affine_combine_lane, for the refinement passes (the
  covariance suffix is exact on the first pass and not run again)."""
  A_a, b_a = a
  A_b, b_b = b
  return _mm(A_b, A_a), _mm(A_b, b_a) + b_b


def _suffix_scan_lane(A, b, V=None):
  """Inclusive suffix combine of affine elements (A (d, d, T), b (d, 1, T)
  [, V (d, d, T)]) along the time axis: out[k] = x[T-1] o ... o x[k], with
  _affine_combine_lane's semantics (V=None: _affine_combine_ab).

  A doubling scan: after the level of shift s, out[k] holds the
  composition of x[k .. k+2s-1] (clipped at T-1), formed by combining
  out[k+s] (later) into out[k] (earlier). ceil(log2 T) levels, each one
  combine over the whole time axis; the JAX package chunks the scan
  instead, because its strided lane gathers cost a relayout per level on
  the TPU."""
  elems = (A, b) if V is None else (A, b, V)
  combine = _affine_combine_ab if V is None else _affine_combine_lane
  T = A.shape[-1]
  s = 1
  while s < T:
    head = combine(tuple(e[..., s:] for e in elems),
                   tuple(e[..., :T - s] for e in elems))
    elems = tuple(torch.cat([h, e[..., T - s:]], dim=-1)
                  for h, e in zip(head, elems))
    s *= 2
  return elems


def rts_smooth_parallel(spec: FilterSpec, params, x_pred, P_pred, x_post,
                        P_post, t, norm_quats: bool = False, dts=None,
                        refine: int | None = None):
  """Parallel-in-time RTS by a suffix scan of affine maps
  (rts_smooth_parallel_reference says how). CUDA tensors: kernel 11, 13
  and 14 once each, and kernel 11's refine variant and kernel 13 once
  more for each refine pass (see the module docstring); CPU tensors:
  rts_smooth_parallel_reference."""
  if x_post.device.type == "cpu":
    return rts_smooth_parallel_reference(
        spec, params, x_pred, P_pred, x_post, P_post, t,
        norm_quats=norm_quats, dts=dts, refine=refine)
  xs, Ps = _card_rts_smooth_parallel(
      spec, params, x_pred[None], P_pred[None], x_post[None], P_post[None],
      _dts(t, dts)[None], norm_quats, refine)
  return xs[0], Ps[0]


def _card_rts_smooth_parallel(spec, params, x_pred, P_pred, x_post, P_post,
                              dts, norm_quats, refine):
  """The parallel smoother of a bank (B, T, ...; dts (B, T-1)) through
  rednose::rts_smooth_parallel (kernels 11, 13 and 14; in the backward
  14', 13' and 11'), on the device of x_post."""
  n_refine = _n_refine(spec, x_post, refine)
  _refuse_grad(spec, (x_pred, P_pred, x_post, P_post, dts,
                      *params.values()), n_refine)
  if x_post.shape[1] < 2:
    return x_post.clone(), P_post.clone()
  h, prm = _handle_of(spec, params, x_post)
  return torch.ops.rednose.rts_smooth_parallel(
      x_pred, P_pred, x_post, P_post, dts.to(x_post.dtype), prm, h,
      bool(norm_quats), n_refine)[:2]


def _n_refine(spec, x_post, refine):
  """The Newton passes: `refine`, by default 2 for an ESKF spec in float64
  and 0 otherwise; none for T <= 2."""
  f64 = x_post.dtype == torch.float64
  n = (2 if (spec.is_eskf and f64) else 0) if refine is None else refine
  return n if x_post.shape[-2] > 2 else 0


def rts_smooth_parallel_reference(spec: FilterSpec, params, x_pred, P_pred,
                                  x_post, P_post, t, norm_quats: bool = False,
                                  dts=None, refine: int | None = None):
  """rts_smooth_parallel's plain version, on any device. `.launches`
  counts its runs.

  With e_k = inv_err(x_{k|k}, x_{k|T}) and u_{k+1} = inv_err(x_{k+1|k},
  x_{k+1|k+1}), the RTS recursion linearizes to e_k = C_k u_{k+1} +
  C_k e_{k+1}, e_{T-1} = 0, and D_k = P_{k|T} - P_{k|k} obeys D_k =
  C_k (P_{k+1|k+1} - P_{k+1|k}) C_k^T + C_k D_{k+1} C_k^T: both affine,
  combined associatively. Exact for additive error states. For an ESKF
  the mean recursion adds tangent-space corrections, first order in their
  size; `refine` Newton passes re-linearize the exact recursion e_k =
  C_k v(e_{k+1}), v(e) = inv_err(x_pred, inject(x_post, e)), around the
  current iterate (J_v by jacfwd) and solve it again with an (A, b)-only
  scan; the fixed point is the sequential recursion. Refinement needs
  float64 (v cancels nearly equal states, which float32 at ECEF scale
  cannot resolve). Default: 2 for ESKF specs in float64, else 0."""
  rts_smooth_parallel_reference.launches += 1
  resolve_device(x_post.device)
  d1, d2, de = spec.dim_main, spec.dim_main_err, spec.dim_err
  T = x_post.shape[0]
  if T < 2:
    return x_post.clone(), P_post.clone()
  dts = _dts(t, dts)

  # gains C_k = P_k F_k^T P_{k+1|k}^-1 for all k, lane-major (d2, d2, T-1):
  # solve P_{k+1|k} X = F_k P_k^T by the blocked lane Cholesky, C = X^T
  F = _F_main(spec, params, x_post[:-1], dts)
  Pk = P_post[:-1, :d2, :d2].permute(1, 2, 0)
  Pk1 = P_pred[1:, :d2, :d2].permute(1, 2, 0)
  X = cho_solve_lane_blocked(cholesky_lane_blocked(Pk1), _mm_t(F, Pk))
  C_l = X.transpose(0, 1)

  u_l = vmap(lambda xp, xf: spec.inv_err(params, xp, xf)[:d2],
             out_dims=1)(x_pred[1:], x_post[1:])             # (d2, T-1)
  b_l = _mm(C_l, u_l[:, None])                               # (d2, 1, T-1)
  dP_l = (P_post[1:, :d2, :d2] - P_pred[1:, :d2, :d2]).permute(1, 2, 0)
  V_l = _mm_t(_mm(C_l, dP_l), C_l)
  _, e_acc_l, D_acc_l = _suffix_scan_lane(C_l, b_l, V_l)
  e_acc = e_acc_l[:, 0].T                                    # (T-1, d2)
  D_acc = D_acc_l.permute(2, 0, 1)                           # (T-1, d2, d2)

  def inject(x_k, e_k):
    dx = torch.cat([e_k, e_k.new_zeros(de - d2)])
    x_s = spec.err(params, x_k, dx)
    x_s = torch.cat([x_s[:d1], x_k[d1:]])
    if norm_quats:
      x_s = normalize_slices(x_s, spec.quaternion_idxs)
    return x_s

  for _ in range(_n_refine(spec, x_post, refine)):
    # the smoothed states at 1..T-1 from the current corrections
    x_hat_next = torch.cat([vmap(inject)(x_post[1:-1], e_acc[1:]),
                            x_post[T - 1:]])
    v_l = vmap(lambda xp, xh: spec.inv_err(params, xp, xh)[:d2],
               out_dims=1)(x_pred[1:], x_hat_next)           # (d2, T-1)
    # ê_{k+1}: the current correction a step later (ê_{T-1} = 0)
    e_shift = torch.cat([e_acc[1:], e_acc.new_zeros((1, d2))])
    Jv = vmap(lambda xp, xpo, eh: jacfwd(
        lambda e: spec.inv_err(params, xp, inject(xpo, e))[:d2])(eh),
        out_dims=2)(x_pred[1:], x_post[1:], e_shift)          # (d2, d2, T-1)
    A_ref = _mm(C_l, Jv)
    Jv_e = torch.einsum('ijt,tj->it', Jv, e_shift)
    b_ref = _mm(C_l, (v_l - Jv_e)[:, None])
    _, e_acc_l = _suffix_scan_lane(A_ref, b_ref)
    e_acc = e_acc_l[:, 0].T

  xs = vmap(inject)(x_post[:-1], e_acc)
  Ps = _sym(P_post[:-1] + _pad_block(D_acc, de))
  return (torch.cat([xs, x_post[T - 1:]]),
          torch.cat([Ps, P_post[T - 1:]]))


rts_smooth_parallel_reference.launches = 0


def rts_smooth_parallel_bank(spec: FilterSpec, params, x_pred, P_pred,
                             x_post, P_post, t, norm_quats: bool = False,
                             dts=None, refine: int | None = None):
  """rts_smooth_parallel over a BANK of trajectories: every argument gains
  a leading bank axis B (x_* (B, T, dim_x), P_* (B, T, de, de), t (B, T),
  dts (B, T-1)). CUDA tensors: one launch of each kernel for the whole
  bank (rts_smooth_parallel's launches); CPU tensors: the plain version
  vmapped over the bank."""
  if x_post.device.type != "cpu":
    return _card_rts_smooth_parallel(
        spec, params, x_pred, P_pred, x_post, P_post,
        t[..., 1:] - t[..., :-1] if dts is None else dts, norm_quats, refine)

  def one(xp, Pp, xf, Pf, tt, dd=None):
    return rts_smooth_parallel_reference(spec, params, xp, Pp, xf, Pf, tt,
                                         norm_quats=norm_quats, dts=dd,
                                         refine=refine)

  args = (x_pred, P_pred, x_post, P_post, t)
  return vmap(one)(*args) if dts is None else vmap(one)(*args, dts)


# ------------------------------------------------- the card route (11-14)
# The smoother's custom ops take the bank layout (B lanes; dts (B, T-1))
# and a handle to (spec, the params' names); the params' values come as a
# vector. Their vmap rules merge a vmapped axis into the lanes.

_HANDLES: list = []


@functools.lru_cache(maxsize=None)
def _handle(spec: FilterSpec, pnames: tuple) -> int:
  _HANDLES.append((spec, pnames))
  return len(_HANDLES) - 1


def _handle_of(spec, params, x):
  """(handle, params vector on x's device) of a card call."""
  resolve_device(x.device)
  pnames = smooth_scan.pnames_of(params)
  return (_handle(spec, pnames),
          smooth_scan._prm(params, pnames, x.dtype, x.device))


def _grad_wanted(values) -> bool:
  """Whether autograd records through a call on these values."""
  return torch.is_grad_enabled() and any(
      torch.is_tensor(v) and v.requires_grad for v in values)


def _refuse_transforms(where, values):
  """Raise, naming what is missing, under forward mode (torch.func.jvp, a
  dual tensor of torch.autograd.forward_ad) and under torch.func's
  transforms other than vmap (grad, jacrev: the custom ops' autograd rule
  is an autograd.Function they cannot run)."""
  from torch._C._functorch import TransformType, get_interpreter_stack
  from torch.autograd import forward_ad

  tensors = [v for v in values if torch.is_tensor(v)]
  keys = {i.key() for i in get_interpreter_stack() or ()}
  if TransformType.Jvp in keys or any(
      forward_ad.unpack_dual(v).tangent is not None for v in tensors):
    raise NotImplementedError(
        f"{where}: forward mode (torch.func.jvp, forward-mode AD) through "
        "kernels 11-14 is not ported; reverse mode is (torch.autograd.grad "
        "/ backward run the smoother's adjoint, kernels 11'-14'), or smooth "
        "CPU tensors (the plain version)")
  if keys - {TransformType.Vmap}:
    raise NotImplementedError(
        f"{where} runs under torch.func.vmap only: for its gradient call "
        "torch.autograd.grad / backward (the smoother's adjoint, kernels "
        "11'-14'), not torch.func.grad or jacrev")


def _refuse_grad(spec, values, refine=0):
  """What of the smoother's gradients on the card is not ported raises,
  naming it, and never returns a silently detached result: forward mode
  and torch.func's transforms but vmap (_refuse_transforms), and the
  refine passes' adjoint (refine > 0 with an input that requires grad)."""
  where = f"RTS smoother of spec {spec.name!r} on the card"
  _refuse_transforms(where, values)
  if refine and _grad_wanted(values):
    raise NotImplementedError(
        f"{where}: gradients through refine = {refine} Newton passes need "
        "the refine passes' adjoint (kernel 11's refine variant and kernel "
        "13 on (A, b)), which is not ported; pass refine=0 (the adjoint of "
        "the one-shot parallel smoother runs on the card), smooth "
        "sequentially, or smooth CPU tensors")


@torch.library.custom_op("rednose::rts_smooth", mutates_args=())
def _rts_smooth_op(x_pred: torch.Tensor, P_pred: torch.Tensor,
                   x_post: torch.Tensor, P_post: torch.Tensor,
                   dts: torch.Tensor, prm: torch.Tensor, handle: int,
                   norm_quats: bool, reference_seed: bool) -> tuple[
                       torch.Tensor, torch.Tensor, torch.Tensor]:
  """Kernels 11 (gains) and 12 over B lanes: x_* (B, T, dim_x), P_* (B,
  T, de, de), dts (B, T-1). Returns (x_smooth, P_smooth, C): the gains
  kept for the backward."""
  spec, pnames = _HANDLES[handle]
  params = dict(zip(pnames, prm))
  x_pred, P_pred, x_post, P_post, dts = (
      a.contiguous() for a in (x_pred, P_pred, x_post, P_post, dts))
  C = smooth_scan.smooth_gains(spec, params, x_pred, P_pred, x_post,
                               P_post, dts, elements=False)
  return smooth_scan.smooth_backward(
      spec, params, x_pred, P_pred, x_post, P_post, C,
      norm_quats=norm_quats, reference_seed=reference_seed) + (C,)


@torch.library.custom_op("rednose::rts_smooth_parallel", mutates_args=())
def _rts_smooth_parallel_op(x_pred: torch.Tensor, P_pred: torch.Tensor,
                            x_post: torch.Tensor, P_post: torch.Tensor,
                            dts: torch.Tensor, prm: torch.Tensor,
                            handle: int, norm_quats: bool,
                            refine: int) -> tuple[
                                torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
  """Kernels 11, 13 and 14 over B lanes (rts_smooth_parallel's math):
  the gains and elements, the suffix scan of (C, b, V), `refine` Newton
  passes (kernel 11's refine variant, then kernel 13 on (A, b)), the
  inject. Layouts as rednose::rts_smooth's. Returns (x_smooth, P_smooth,
  C, e, D): the gains and the corrections kept for the backward."""
  spec, pnames = _HANDLES[handle]
  params = dict(zip(pnames, prm))
  x_pred, P_pred, x_post, P_post, dts = (
      a.contiguous() for a in (x_pred, P_pred, x_post, P_post, dts))
  C, b, V = smooth_scan.smooth_gains(spec, params, x_pred, P_pred, x_post,
                                     P_post, dts)
  _, e, D = smooth_scan.affine_suffix_scan(C, b, V)
  for _ in range(refine):
    A_r, b_r = smooth_scan.smooth_gains(spec, params, x_pred, None, x_post,
                                        None, None, C=C, e=e,
                                        norm_quats=norm_quats)
    _, e, _ = smooth_scan.affine_suffix_scan(A_r, b_r)
  return smooth_scan.smooth_inject(spec, params, x_post, P_post, e, D,
                                   norm_quats=norm_quats) + (C, e, D)


def _smooth_vmap(op, info, in_dims, x_pred, P_pred, x_post, P_post, dts,
                 prm, handle, norm_quats, flag):
  """vmap of a smoother op: the vmapped logs' lanes side by side in one
  call, so one launch of each kernel; batched params raise."""
  if in_dims[5] is not None:
    raise ValueError("the smoother on the card takes params shared by the "
                     "vmapped logs: vmap the plain version for batched "
                     "params")
  n = info.batch_size

  def lanes(a, d):
    a = (a.movedim(d, 0) if d is not None
         else a.unsqueeze(0).expand(n, *a.shape))
    return a.flatten(0, 1)

  out = op(*(lanes(a, d) for a, d in zip(
      (x_pred, P_pred, x_post, P_post, dts), in_dims[:5])), prm, handle,
      norm_quats, flag)
  return tuple(a.unflatten(0, (n, -1)) for a in out), (0,) * len(out)


_rts_smooth_op.register_vmap(
    functools.partial(_smooth_vmap, torch.ops.rednose.rts_smooth))
_rts_smooth_parallel_op.register_vmap(
    functools.partial(_smooth_vmap, torch.ops.rednose.rts_smooth_parallel))


def _setup_smooth(ctx, inputs, output):
  x_pred, P_pred, x_post, P_post, dts, prm, handle, norm_quats, flag = inputs
  ctx.handle, ctx.norm_quats, ctx.flag = handle, norm_quats, flag
  # an output the loss does not read reaches the backward as None
  ctx.set_materialize_grads(False)
  ctx.save_for_backward(x_pred, P_pred, x_post, P_post, dts, prm, *output)


def _refuse_second_order():
  if torch.is_grad_enabled():
    raise NotImplementedError(
        "RTS smoother on the card: higher-order gradients (create_graph="
        "True) through the smoother's adjoint (kernels 11'-14') are not "
        "ported; smooth CPU tensors (the plain version) for them")


def _prm_grad(g, prm):
  """The params' cotangent (B, NP) a lane, float64 -> prm's gradient (0
  for a spec without params: prm is one dummy 0)."""
  if g.shape[-1] != prm.shape[0]:
    return torch.zeros_like(prm)
  return g.sum(0).to(prm.dtype)


def _rts_smooth_backward(ctx, gxs, gPs, gC):
  """Autograd rule of rednose::rts_smooth: rednose::rts_smooth_backward
  (kernels 12' and 11', once each, whatever the bank's size)."""
  _refuse_second_order()
  x_pred, P_pred, x_post, P_post, dts, prm, xs, Ps, C = ctx.saved_tensors
  g = torch.ops.rednose.rts_smooth_backward(
      x_pred, P_pred, x_post, P_post, dts, prm, C, xs, Ps, gxs, gPs, gC,
      ctx.handle, ctx.norm_quats, ctx.flag)
  return g[:5] + (_prm_grad(g[5], prm), None, None, None)


def _rts_smooth_parallel_backward(ctx, gxs, gPs, gC, ge, gD):
  """Autograd rule of rednose::rts_smooth_parallel (refine 0):
  rednose::rts_smooth_parallel_backward (kernels 14', 13' and 11', once
  each, whatever the bank's size)."""
  _refuse_second_order()
  if ctx.flag:
    raise NotImplementedError(
        "RTS smoother on the card: the refine passes' adjoint is not "
        "ported")
  x_pred, P_pred, x_post, P_post, dts, prm, _, _, C, e, D = ctx.saved_tensors
  g = torch.ops.rednose.rts_smooth_parallel_backward(
      x_pred, P_pred, x_post, P_post, dts, prm, C, e, D, gxs, gPs, gC, ge,
      gD, ctx.handle, ctx.norm_quats)
  return g[:5] + (_prm_grad(g[5], prm), None, None, None)


_rts_smooth_op.register_autograd(_rts_smooth_backward,
                                 setup_context=_setup_smooth)
_rts_smooth_parallel_op.register_autograd(_rts_smooth_parallel_backward,
                                          setup_context=_setup_smooth)


def _sym_grad(*gs):
  """The sum of covariance cotangents, symmetrized: (G + G^T) / 2."""
  total = sum(gs)
  return _sym(total).contiguous()


def _add(a, b):
  return a if b is None else a + b


@torch.library.custom_op("rednose::rts_smooth_backward", mutates_args=())
def _rts_smooth_backward_op(
    x_pred: torch.Tensor, P_pred: torch.Tensor, x_post: torch.Tensor,
    P_post: torch.Tensor, dts: torch.Tensor, prm: torch.Tensor,
    C: torch.Tensor, xs: torch.Tensor, Ps: torch.Tensor,
    gxs: torch.Tensor | None, gPs: torch.Tensor | None,
    gC: torch.Tensor | None, handle: int, norm_quats: bool,
    reference_seed: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor, torch.Tensor]:
  """Kernels 12' and 11' for rednose::rts_smooth's inputs (its layout),
  its outputs (xs, Ps, C) and their cotangents (None: 0): 12' (the chain
  over k) gives C's cotangent, which 11' takes back through the gains.
  Returns the gradients of (x_pred, P_pred, x_post, P_post, dts) and the
  params' a lane (B, NP), float64; P's symmetrized."""
  spec, pnames = _HANDLES[handle]
  params = dict(zip(pnames, prm))
  args = tuple(a.contiguous() for a in (x_pred, P_pred, x_post, P_post))
  gxs, gPs = (None if a is None else a.contiguous() for a in (gxs, gPs))
  b_xp, b_Pp, b_xq, b_Pq, b_C, b_p = smooth_scan.smooth_backward_adjoint(
      spec, params, *args, C, xs, Ps, gxs, gPs, norm_quats=norm_quats,
      reference_seed=reference_seed)
  g_xp, g_Pp, g_xq, g_Pq, g_dts, g_p = smooth_scan.smooth_gains_adjoint(
      spec, params, *args, dts.contiguous(), C,
      gC=_add(b_C, gC).contiguous())
  return (g_xp + b_xp, _sym_grad(g_Pp, b_Pp), g_xq + b_xq,
          _sym_grad(g_Pq, b_Pq), g_dts, g_p + b_p)


@torch.library.custom_op("rednose::rts_smooth_parallel_backward",
                         mutates_args=())
def _rts_smooth_parallel_backward_op(
    x_pred: torch.Tensor, P_pred: torch.Tensor, x_post: torch.Tensor,
    P_post: torch.Tensor, dts: torch.Tensor, prm: torch.Tensor,
    C: torch.Tensor, e: torch.Tensor, D: torch.Tensor,
    gxs: torch.Tensor | None, gPs: torch.Tensor | None,
    gC: torch.Tensor | None, ge: torch.Tensor | None,
    gD: torch.Tensor | None, handle: int, norm_quats: bool) -> tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
        torch.Tensor, torch.Tensor]:
  """Kernels 14', 13' and 11' for rednose::rts_smooth_parallel's inputs,
  its kept outputs (C, e, D; refine 0) and the cotangents of its outputs
  (None: 0): 14' gives e's and D's (plus theirs), 13' the elements' b's
  and V's (lambda, Lambda), 11' takes them back through the elements and
  the gains with the scan's share of C's. Returns as
  rednose::rts_smooth_backward's."""
  spec, pnames = _HANDLES[handle]
  params = dict(zip(pnames, prm))
  args = tuple(a.contiguous() for a in (x_pred, P_pred, x_post, P_post))
  gxs, gPs = (None if a is None else a.contiguous() for a in (gxs, gPs))
  i_xq, i_Pq, i_e, i_D, i_p = smooth_scan.smooth_inject_adjoint(
      spec, params, args[2], args[3], e, D, gxs, gPs, norm_quats=norm_quats)
  lam, Lam = smooth_scan.affine_suffix_scan_adjoint(
      C, _add(i_e, ge).contiguous(), _add(i_D, gD).contiguous())
  g_xp, g_Pp, g_xq, g_Pq, g_dts, g_p = smooth_scan.smooth_gains_adjoint(
      spec, params, *args, dts.contiguous(), C,
      gC=None if gC is None else gC.contiguous(), gb=lam, gV=Lam, e=e, D=D)
  return (g_xp, _sym_grad(g_Pp), g_xq + i_xq, _sym_grad(g_Pq, i_Pq), g_dts,
          g_p + i_p)


def _backward_vmap(op, info, in_dims, *args):
  """vmap of a backward op: the vmapped logs' lanes side by side in one
  call (one launch of each adjoint); each log's params' cotangent its own
  lanes' (the op gives them a lane); batched params raise."""
  n_t = len(args) - 3   # the tensors, then handle and the two flags
  if in_dims[5] is not None:
    raise ValueError("the smoother's backward on the card takes params "
                     "shared by the vmapped logs")
  n = info.batch_size

  def lanes(i, a, d):
    if a is None or i == 5:   # an absent cotangent; the params
      return a
    a = (a.movedim(d, 0) if d is not None
         else a.unsqueeze(0).expand(n, *a.shape))
    return a.flatten(0, 1)

  out = op(*(lanes(i, a, d) for i, (a, d) in enumerate(
      zip(args[:n_t], in_dims[:n_t]))), *args[n_t:])
  return tuple(a.unflatten(0, (n, -1)) for a in out), (0,) * len(out)


_rts_smooth_backward_op.register_vmap(
    functools.partial(_backward_vmap, torch.ops.rednose.rts_smooth_backward))
_rts_smooth_parallel_backward_op.register_vmap(
    functools.partial(_backward_vmap,
                      torch.ops.rednose.rts_smooth_parallel_backward))


def _no_second_order(ctx, *grads):
  raise NotImplementedError(
      "RTS smoother on the card: a gradient of the smoother's adjoint "
      "(kernels 11'-14') is not ported; smooth CPU tensors for "
      "higher-order gradients")


for _op in (_rts_smooth_backward_op, _rts_smooth_parallel_backward_op):
  _op.register_autograd(_no_second_order,
                        setup_context=lambda ctx, inputs, output: None)


def _as_tensor(a, dtype, device):
  if torch.is_tensor(a):
    return a.to(device=device, dtype=dtype)
  return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                         device=device)


def _host(a):
  return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def smooth_estimates(spec: FilterSpec, params, estimates,
                     norm_quats: bool = False, parallel: bool = False,
                     dtype=None, refine: int | None = None,
                     reference_seed: bool = False, device=None):
  """Smooth a list of 9-tuple Estimates (the reference's
  rts_smooth(estimates, norm_quats), ekf_sym.py:651).

  Runs on `device` in `dtype` (default: those of the first estimate's
  posterior state when it is a tensor, else the card and float64; a
  missing card raises) and returns a list of smoothed (x, P) numpy pairs,
  oldest first. Timestamps are differenced on the host in float64.
  `reference_seed=True` (sequential only) reproduces the reference's
  last-predicted-state boundary condition (see rts_smooth)."""
  if len(estimates) <= 1:
    return [(_host(e[1]).flatten(), _host(e[3])) for e in estimates]
  first = estimates[0][1]
  if dtype is None:
    dtype = first.dtype if torch.is_tensor(first) else torch.float64
  if device is None:
    device = first.device if torch.is_tensor(first) else "cuda"
  device = resolve_device(device)

  def stack(i, flat):
    rows = [_as_tensor(e[i], dtype, device) for e in estimates]
    return torch.stack([r.reshape(-1) for r in rows] if flat else rows)

  x_pred, x_post = stack(0, True), stack(1, True)
  P_pred, P_post = stack(2, False), stack(3, False)
  t64 = np.asarray([float(e[4]) for e in estimates], dtype=np.float64)
  t = torch.as_tensor(t64, dtype=dtype, device=device)
  dts = torch.as_tensor(t64[1:] - t64[:-1], dtype=dtype, device=device)
  if parallel:
    xs, Ps = rts_smooth_parallel(spec, params, x_pred, P_pred, x_post,
                                 P_post, t, norm_quats=norm_quats, dts=dts,
                                 refine=refine)
  else:
    xs, Ps = rts_smooth(spec, params, x_pred, P_pred, x_post, P_post, t,
                        norm_quats=norm_quats, dts=dts,
                        reference_seed=reference_seed)
  xs, Ps = _host(xs), _host(Ps)
  return [(xs[i], Ps[i]) for i in range(xs.shape[0])]
