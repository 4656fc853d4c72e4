"""Offline replay of a heterogeneous observation log in one call.

Port of rednose_tpu/runtime/scan.py. The host driver (runtime/driver.py)
takes one observation at a time, with its rewind bookkeeping; this module
runs a whole recorded, time-ordered log and keeps every step's
(predicted, posterior) pair: the smoother's inputs (smoothing/rts.py). On
the card that is one launch of kernel 9 (ops/generic_scan.stream_bank_scan,
the JAX package's jitted lax.scan ported), for one log or, under
torch.func.vmap, a bank of them; on the host, and in
build_scan_stream_reference on any device, one loop over time through
core/step.py.

Gradients: on the host autograd runs through the plain loop; on the card
the custom op's autograd rule is one launch of kernel 10
(ops/generic_scan.stream_bank_scan_adjoint, the adjoint of kernel 9's
emitted arithmetic, ops/adjoint.py) for the whole bank, through the op
rednose::scan_stream_backward. It gives the cotangents of x, P, Q, dts,
zs, Rs, eas and the params. It follows the forward's gate decisions, read
from the stacks, and warns (RuntimeWarning) where its recomputed decision
differs (ops/generic_scan.stream_bank_scan_adjoint.gate_flips). P, Q and
R are read as symmetric matrices (P's and Q's upper entries, R's upper
entries of each kind's leading block), so their gradients are symmetric:
a_ij / 2 on (i, j) and (j, i) for the upper entry's cotangent a_ij,
which on symmetric directions equals jax.grad's. Q's is dense (dt times
the predicted P's cotangent, on every entry, off Q's pattern too); R's
is 0 off each kind's block and on the padded slots. Higher-order
gradients (create_graph=True, a gradient of the backward) and forward
mode (torch.func.jvp, forward-mode AD) raise, naming what is missing; so
do torch.func.grad and its relatives (use torch.autograd.grad).

Measurements of different sizes are padded to the largest dz; a padded
slot gets variance PAD_R, so it carries no information (the reference's
soft-nulling trick for Mahalanobis rejection, ekf_c.c:92). The padded rows
of H are exactly zero, so with PAD_R on the diagonal the padded slots
change neither the gain nor the covariance.

In the plain loop the kind dispatch is a host-side index into the
per-kind branches: the kind index stays on the host, and no step waits on
the device for it. A spec that ships a closed-form F (FilterSpec.F_lane,
equal to jacfwd of its dynamics) predicts with it: on an H100 the live
spec's plain step, vmapped over 64 lanes, takes about half the time it
takes with jacfwd (chip_smoke.py times both).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Sequence

import numpy as np
import torch

from rednose_tpu_torch.core import step as step_ops
from rednose_tpu_torch.core.spec import FilterSpec

# Padded-slot variance: information-free (a leak of ~1e-12 relative), and
# small enough that float32 closed-form 3x3 solves of an S holding it
# (adjugate terms are products of three entries) cannot overflow.
PAD_R = 1.0e12


def _padded_spec(spec: FilterSpec, kind: int, max_dz: int) -> FilterSpec:
  """spec with kind's h padded by zero rows to max_dz (its dz and gate
  threshold otherwise kept)."""
  om = spec.obs[kind]
  pad = max_dz - om.dz

  def h_padded(params, x, ea):
    h = om.h(params, x, ea).reshape(-1)
    return torch.cat([h, h.new_zeros(pad)])

  om_pad = dataclasses.replace(om, h=h_padded, dz=max_dz,
                               maha_thresh=om.maha_thresh)
  return dataclasses.replace(spec, obs={**spec.obs, kind: om_pad})


def _padded_update(spec_pad: FilterSpec, kind: int, params, x, P, z_pad,
                   R_pad, ea):
  """One update of `kind` with z / R padded to max_dz, on the spec
  _padded_spec made: the kind's real h / H rows, zero rows and PAD_R for
  the padding. Returns (x, P)."""
  om = spec_pad.obs[kind]
  x_new, P_new, _ = step_ops.update(spec_pad, kind, params, x, P, z_pad,
                                    R_pad, ea[:max(om.ea_len, 1)])
  return x_new, P_new


def build_scan_stream(spec: FilterSpec, kinds: Sequence[int]):
  """(scan_fn, kind_index) for a log of the given observation kinds,
  cached on (spec, kinds): a repeated call returns the same function.

  scan_fn(params, x, P, Q, dts, kind_idx, zs, Rs, eas) ->
      ((x, P), (x_preds, P_preds, x_posts, P_posts)), stacked over T, with
    dts (T,) per-step time deltas: deltas, not absolute timestamps
      (pad_log differences them on the host in float64, where they are
      exact; an epoch-scale time cast to float32 would quantize them),
    kind_idx (T,) indices into `kinds`, read on the host,
    zs (T, max_dz) padded measurements,
    Rs (T, max_dz, max_dz) padded noise (PAD_R on the padded slots),
    eas (T, max_ea) padded extra args.
  kind_index maps each kind to its index.

  On CPU tensors scan_fn runs the plain loop (build_scan_stream_reference).
  On CUDA tensors it launches kernel 9 (ops/generic_scan.stream_bank_scan)
  once for the whole log: the step's predict and the kind's update
  emitted for the spec, each step's R read as the kind's leading dz x dz
  block of Rs[t]. Under torch.func.vmap over x, P and zs (a bank of logs
  that share dts, kind_idx, Rs and eas) it is one launch for the whole
  bank; batching any other argument raises on the card, naming it. On the
  card, torch.autograd's backward through scan_fn is one launch of kernel
  10 (ops/generic_scan.stream_bank_scan_adjoint) for the whole bank, the
  shared inputs' gradients summed over every lane of every log; gradients
  of P, Q and Rs are symmetric (see the module docstring). Higher-order
  gradients and forward mode raise on the card. A float32 or float64 log,
  kinds that are not MSCKF feature kinds, dz <= 3."""
  return _build_scan_stream_cached(spec, tuple(int(k) for k in kinds))


def build_scan_stream_reference(spec: FilterSpec, kinds: Sequence[int]):
  """(scan_fn, kind_index) of the plain loop over T (core/step.py's
  predict and padded update, one Python iteration a step), on any device:
  build_scan_stream's plain version, which autograd runs through. Its
  `.launches` counts the runs of such a scan_fn, on any device (one for a
  vmapped bank of logs)."""
  return _build_reference_cached(spec, tuple(int(k) for k in kinds))


build_scan_stream_reference.launches = 0


@functools.lru_cache(maxsize=None)
def _build_reference_cached(spec: FilterSpec, kinds: tuple):
  max_dz = max(spec.obs[k].dz for k in kinds)
  branches = tuple((_padded_spec(spec, k, max_dz), k) for k in kinds)

  def scan_fn(params, x, P, Q, dts, kind_idx, zs, Rs, eas):
    build_scan_stream_reference.launches += 1
    ki = np.asarray(kind_idx.cpu() if torch.is_tensor(kind_idx)
                    else kind_idx).tolist()
    outs = ([], [], [], [])
    for t, i in enumerate(ki):
      F = None if spec.F_lane is None else spec.F_lane(params, x, dts[t])
      x_pred, P_pred = step_ops.predict(spec, params, x, P, Q, dts[t], F=F)
      spec_pad, kind = branches[i]
      x, P = _padded_update(spec_pad, kind, params, x_pred, P_pred, zs[t],
                            Rs[t], eas[t])
      for out, v in zip(outs, (x_pred, P_pred, x, P)):
        out.append(v)
    if not ki:
      return (x, P), tuple(
          v.new_zeros((0,) + tuple(v.shape)) for v in (x, P, x, P))
    return (x, P), tuple(torch.stack(out) for out in outs)

  return scan_fn, {k: i for i, k in enumerate(kinds)}


# build_scan_stream's calls of the kernel: (spec, kinds, param names) of
# each handle that the custom op rednose::scan_stream takes
_HANDLES: list = []


@functools.lru_cache(maxsize=None)
def _handle(spec: FilterSpec, kinds: tuple, pnames: tuple) -> int:
  _HANDLES.append((spec, kinds, pnames))
  return len(_HANDLES) - 1


@functools.lru_cache(maxsize=None)
def _kernel_call(handle: int, q_pattern: tuple, mode: str = "stream"):
  """The 'stream' KernelCall (kernel 9), or with mode 'stream_adjoint'
  kernel 10's, of a handle and a Q pattern, made once: the variant only
  (Q's values and the params' come with each call)."""
  from rednose_tpu_torch.ops import generic_scan

  spec, kinds, pnames = _HANDLES[handle]
  Q = np.zeros((spec.dim_err, spec.dim_err))
  for i, j in q_pattern:
    Q[i, j] = Q[j, i] = 1.0
  return generic_scan.KernelCall(spec, mode, kinds, Q=Q,
                                 params=dict.fromkeys(pnames, 0.0))


@functools.lru_cache(maxsize=None)
def _build_scan_stream_cached(spec: FilterSpec, kinds: tuple):
  plain, kind_index = _build_reference_cached(spec, kinds)

  def scan_fn(params, x, P, Q, dts, kind_idx, zs, Rs, eas):
    if x.device.type == "cpu":
      return plain(params, x, P, Q, dts, kind_idx, zs, Rs, eas)
    return _kernel_scan(spec, kinds, params, x, P, Q, dts, kind_idx, zs, Rs,
                        eas)

  return scan_fn, kind_index


def _kernel_scan(spec, kinds, params, x, P, Q, dts, kind_idx, zs, Rs, eas):
  """scan_fn through kernel 9 (the custom op rednose::scan_stream, which
  launches ops/generic_scan.stream_bank_scan), on the device of x."""
  _refuse_forward_mode([v for v in (x, P, Q, dts, zs, Rs, eas,
                                    *params.values()) if torch.is_tensor(v)])
  dev, dtype = x.device, x.dtype
  as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
  pnames = tuple(sorted(params))
  prm = (torch.stack([as_dev(params[k]) for k in pnames]) if pnames
         else torch.zeros(1, dtype=dtype, device=dev))
  ki = torch.as_tensor(kind_idx, device=dev).to(torch.int32)
  out = torch.ops.rednose.scan_stream(
      x[None], as_dev(P)[None], as_dev(zs)[:, None], as_dev(dts), ki,
      as_dev(Rs), as_dev(eas), as_dev(Q), prm, _handle(spec, kinds, pnames))
  x_, P_, xp, Pp, xq, Pq = (a[0] for a in out)
  return (x_, P_), (xp, Pp, xq, Pq)


def _bank_copy(a, *dims):
  """A contiguous copy of a permuted view, also where the view is already
  contiguous (kernel 9 advances its x and P in place)."""
  return a.permute(*dims).clone(memory_format=torch.contiguous_format)


@torch.library.custom_op("rednose::scan_stream", mutates_args=())
def _scan_stream_op(x: torch.Tensor, P: torch.Tensor, zs: torch.Tensor,
                    dts: torch.Tensor, kind_idx: torch.Tensor,
                    Rs: torch.Tensor, eas: torch.Tensor, Q: torch.Tensor,
                    prm: torch.Tensor, handle: int) -> tuple[
                        torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor, torch.Tensor]:
  """Kernel 9 over B lanes in scan_fn's layout: x (B, dim_x), P (B, de,
  de), zs (T, B, max_dz); the rest shared by the lanes. Returns (x, P,
  x_preds (B, T, dim_x), P_preds (B, T, de, de), x_posts, P_posts): the
  kernel's bank-minor stacks, transposed by one copy each."""
  from rednose_tpu_torch.ops import entry_slab, generic_scan

  spec, kinds, _ = _HANDLES[handle]
  call = _kernel_call(handle, entry_slab.q_pattern_of(
      Q.detach().cpu().double().numpy()))
  T, B = dts.shape[0], x.shape[0]
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  eas_b = (None if max_ea == 0 else
           eas[:, :max_ea, None].expand(T, max_ea, B).contiguous())
  xk, Pk = _bank_copy(x, 1, 0), _bank_copy(P, 1, 2, 0)
  xp, Pp, xq, Pq = generic_scan.stream_bank_scan(
      call, xk, Pk, zs.transpose(1, 2).contiguous(), dts.contiguous(),
      kind_idx.contiguous(), Rs.contiguous(), eas_b, prm.contiguous(),
      Q.contiguous())
  return (xk.T.contiguous(), Pk.permute(2, 0, 1).contiguous(),
          xp.permute(2, 0, 1).contiguous(),
          Pp.permute(3, 0, 1, 2).contiguous(),
          xq.permute(2, 0, 1).contiguous(),
          Pq.permute(3, 0, 1, 2).contiguous())


def _scan_stream_vmap(info, in_dims, x, P, zs, dts, kind_idx, Rs, eas, Q,
                      prm, handle):
  """vmap of rednose::scan_stream over x, P and zs: the lanes of every
  vmapped log side by side in one call, so one launch; an argument that
  the logs do not share raises, naming it."""
  names = ("dts", "kind_idx", "Rs", "eas", "Q", "params")
  for name, d in zip(names, in_dims[3:9]):
    if d is not None:
      raise ValueError(
          f"scan_fn on the card takes a bank of logs that differ in x, P "
          f"and zs only: {name} is batched (vmap "
          "build_scan_stream_reference's scan_fn instead)")
  n = info.batch_size

  def lanes(a, d, at):
    """a with the vmapped axis moved before its lane axis `at` and merged
    with it (a log's lanes stay together)."""
    a = (a.movedim(d, at) if d is not None
         else a.unsqueeze(at).expand(*a.shape[:at], n, *a.shape[at:]))
    return a.flatten(at, at + 1)

  out = torch.ops.rednose.scan_stream(
      lanes(x, in_dims[0], 0), lanes(P, in_dims[1], 0),
      lanes(zs, in_dims[2], 1), dts, kind_idx, Rs, eas, Q, prm, handle)
  return tuple(a.unflatten(0, (n, -1)) for a in out), (0,) * 6


_scan_stream_op.register_vmap(_scan_stream_vmap)


def _refuse_forward_mode(values):
  """Forward mode through kernel 9 is not ported (it would need kernel 9's
  tangent scan): raise, naming it, under torch.func.jvp or with a dual
  tensor of torch.autograd.forward_ad; the other torch.func transforms but
  vmap reach the op as an autograd.Function they cannot run, so raise
  there too, naming torch.autograd.grad."""
  from torch._C._functorch import TransformType, get_interpreter_stack
  from torch.autograd import forward_ad

  keys = {i.key() for i in get_interpreter_stack() or ()}
  if TransformType.Jvp in keys or any(
      forward_ad.unpack_dual(v).tangent is not None for v in values):
    raise NotImplementedError(
        "scan_fn on the card: forward mode (torch.func.jvp, forward-mode AD) "
        "through kernel 9 is not ported; reverse mode is (torch.autograd."
        "grad / backward run kernel 10), or run "
        "build_scan_stream_reference's plain loop")
  if keys - {TransformType.Vmap}:
    raise NotImplementedError(
        "scan_fn on the card runs under torch.func.vmap only: for its "
        "gradient call torch.autograd.grad / backward (kernel 10), not "
        "torch.func.grad or jacrev")


def _setup_backward(ctx, inputs, output):
  x, P, zs, dts, kind_idx, Rs, eas, Q, prm, handle = inputs
  ctx.handle = handle
  ctx.save_for_backward(x, P, zs, dts, kind_idx, Rs, eas, Q, prm,
                        *output[2:])


def _scan_stream_backward(ctx, gx, gP, gxp, gPp, gxq, gPq):
  """Autograd rule of rednose::scan_stream: kernel 10 once, through the op
  rednose::scan_stream_backward, whatever the bank's size."""
  if torch.is_grad_enabled():
    raise NotImplementedError(
        "scan_fn on the card: higher-order gradients (create_graph=True) "
        "through kernel 10 are not ported; run build_scan_stream_reference's "
        "plain loop for them")
  saved = ctx.saved_tensors
  outs = saved[9:]                           # xp, Pp, xq, Pq
  full = (saved[0], saved[1]) + outs
  grads = [torch.zeros_like(like) if g is None else g
           for g, like in zip((gx, gP, gxp, gPp, gxq, gPq), full)]
  dx, dP, dzs, ddts, dRs, deas, dQ, dprm = \
      torch.ops.rednose.scan_stream_backward(*saved, *grads, ctx.handle)
  return dx, dP, dzs, ddts, None, dRs, deas, dQ, dprm, None


_scan_stream_op.register_autograd(_scan_stream_backward,
                                  setup_context=_setup_backward)


def _sym(a):
  """(A + A^T) / 2 of a matrix of upper-entry cotangents (lower entries
  0): the gradient in the symmetric convention."""
  return (a + a.transpose(-1, -2)) / 2


@torch.library.custom_op("rednose::scan_stream_backward", mutates_args=())
def _scan_stream_backward_op(
    x: torch.Tensor, P: torch.Tensor, zs: torch.Tensor, dts: torch.Tensor,
    kind_idx: torch.Tensor, Rs: torch.Tensor, eas: torch.Tensor,
    Q: torch.Tensor, prm: torch.Tensor, xp: torch.Tensor, Pp: torch.Tensor,
    xq: torch.Tensor, Pq: torch.Tensor, gx: torch.Tensor, gP: torch.Tensor,
    gxp: torch.Tensor, gPp: torch.Tensor, gxq: torch.Tensor,
    gPq: torch.Tensor, handle: int) -> tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """Kernel 10 for rednose::scan_stream's inputs (x, P, zs, dts, kind_idx,
  Rs, eas, Q, prm in its layout), its stacks (xp, Pp, xq, Pq) and the
  cotangents of its six outputs: one launch of
  ops/generic_scan.stream_bank_scan_adjoint on bank-minor copies, the
  shared inputs' per-lane cotangents summed over the lanes, P's, Q's and
  R's symmetrized; a RuntimeWarning where a lane-step's recomputed gate
  decision differs from the forward's. Returns the gradients of (x, P,
  zs, dts, Rs, eas, Q, prm)."""
  from rednose_tpu_torch.ops import entry_slab, generic_scan

  spec, kinds, _ = _HANDLES[handle]
  call = _kernel_call(handle, entry_slab.q_pattern_of(
      Q.detach().cpu().double().numpy()), "stream_adjoint")
  T, B = dts.shape[0], x.shape[0]
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  eas_b = (None if max_ea == 0 else
           eas[:, :max_ea, None].expand(T, max_ea, B).contiguous())
  bm = lambda a: a.permute(*range(1, a.dim()), 0).contiguous()  # noqa: E731
  dx0, dP0, dzs, dRs, ddts, deas, dQ, dprm = \
      generic_scan.stream_bank_scan_adjoint(
          call, bm(x), bm(P), zs.transpose(1, 2).contiguous(),
          dts.contiguous(), kind_idx.contiguous(), Rs.contiguous(), eas_b,
          prm.contiguous(), Q.contiguous(), bm(xp), bm(Pp), bm(xq), bm(Pq),
          bm(gx), bm(gP), bm(gxp), bm(gPp), bm(gxq), bm(gPq))
  flips = generic_scan.stream_bank_scan_adjoint.gate_flips
  g_eas = torch.zeros_like(eas)
  if deas is not None:
    g_eas[:, :max_ea] = deas.sum(-1)
  out = (dx0.T.contiguous(), _sym(dP0.permute(2, 0, 1)).contiguous(),
         dzs.transpose(1, 2).contiguous(), ddts.sum(-1),
         _sym(dRs.sum(-1)), g_eas, _sym(dQ.sum(-1)), dprm.sum(-1))
  # read once the reductions are queued: the backward's one wait
  n = int(flips.sum())
  if n:
    warnings.warn(
        f"scan_fn on the card: at {n} lane-steps kernel 10 recomputed a gate "
        "decision that differs from the forward's, which it read from the "
        "stacks (a step is rejected where every diagonal entry of the "
        "posterior P equals the predicted one) and followed; if an accepted "
        "update's change to P rounded away there, its share of the gradient "
        "is missing (build_scan_stream_reference's plain loop decides "
        "each step once)", RuntimeWarning, stacklevel=2)
  return out


def _refuse_second_order(ctx, *grads):
  raise NotImplementedError(
      "scan_fn on the card: a gradient of kernel 10 (the backward of "
      "rednose::scan_stream) is not ported; run "
      "build_scan_stream_reference's plain loop for higher-order gradients")


_scan_stream_backward_op.register_autograd(
    _refuse_second_order, setup_context=lambda ctx, inputs, output: None)


def pad_log(spec: FilterSpec, kinds: Sequence[int], log, t0: float = 0.0,
            dtype=np.float64):
  """Host-side packing of a list of (t, kind, z, R[, ea]) records into the
  padded arrays scan_fn takes: (dts, kind_idx, zs, Rs, eas), numpy.
  Timestamps are differenced here, in float64, so absolute epochs survive
  a float32 device dtype. Every record carries its own R."""
  kinds = tuple(kinds)
  kind_to_idx = {k: i for i, k in enumerate(kinds)}
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(max(spec.obs[k].ea_len, 1) for k in kinds)
  T = len(log)
  dts = np.zeros((T,), dtype=dtype)
  ki = np.zeros((T,), dtype=np.int32)
  zs = np.zeros((T, max_dz), dtype=dtype)
  Rs = np.zeros((T, max_dz, max_dz), dtype=dtype)
  eas = np.zeros((T, max_ea), dtype=dtype)
  t_prev = np.float64(t0)
  for i, rec in enumerate(log):
    t, kind, z, R = rec[0], rec[1], np.asarray(rec[2]).reshape(-1), rec[3]
    ea = (np.asarray(rec[4]).reshape(-1)
          if len(rec) > 4 and rec[4] is not None else np.zeros(0))
    dz = spec.obs[kind].dz
    if z.shape[0] != dz:
      raise ValueError(f"record {i}: kind {kind} takes {dz} values, got "
                       f"{z.shape[0]}")
    if np.float64(t) < t_prev:
      raise ValueError(
          f"log timestamps must be non-decreasing (record {i}: {t} < "
          f"{t_prev}); out-of-order streams belong to the host driver's "
          "rewind/replay path, not the log scan")
    dts[i] = np.float64(t) - t_prev
    t_prev = np.float64(t)
    ki[i] = kind_to_idx[kind]
    zs[i, :dz] = z
    Rs[i] = np.eye(max_dz) * PAD_R
    Rs[i, :dz, :dz] = np.asarray(R).reshape(dz, dz)
    eas[i, :ea.shape[0]] = ea
  return dts, ki, zs, Rs, eas
