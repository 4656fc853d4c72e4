"""Filter banks: T steps of B independent filters of one kind.

Port of rednose_tpu/runtime/bank.py, whose run_bank is one XLA program
(jit_run_bank: jax.jit of a lax.scan over the vmapped predict + update).
Here run_bank on CUDA tensors is one launch of kernel 15
(ops/generic_scan.bank_run_scan, emitted mode "bank") through the custom
op rednose::run_bank, which copies the bank into the kernel's bank-minor
layout and back once a call; on CPU tensors it is run_bank_reference, the
per-filter step of core/step.py vmapped over the bank with
torch.func.vmap and looped over time in Python: the reference every bank
kernel is checked against, not a fast path.

Gradients: on the host autograd runs through the loop; on the card the
op's autograd rule recomputes the stacks (each step's predicted and
posterior state) with kernel 9's lane form and runs kernel 10's lane
form once (ops/generic_scan.stream_bank_scan_lanes,
stream_bank_scan_adjoint_lanes: R and the innovations' cotangent read by
lane), so the forward keeps nothing beyond ys. It gives the gradients of
x, P, t, dts, zs, Rs (by lane, or summed over the lanes where R came
shared), eas, Q and the params; P, Q and R are read as symmetric
matrices (upper entries), so their gradients are symmetric, as
runtime/scan's are. Higher-order gradients (create_graph=True) and
forward mode (torch.func.jvp, forward-mode AD) raise on the card,
naming what is missing.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch
from torch.func import vmap

from rednose_tpu_torch.core import step as step_ops
from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.runtime import scan


@dataclasses.dataclass
class BankState:
  """State of B independent filters: x (B, dim_x), P (B, dim_err, dim_err),
  t (B,) seconds SINCE `epoch` (a host float64, so epoch-scale absolute
  times keep their precision in f32 lanes). Absolute time = epoch + t."""
  x: torch.Tensor
  P: torch.Tensor
  t: torch.Tensor
  epoch: float = 0.0

  @property
  def batch(self) -> int:
    return self.x.shape[0]

  def absolute_t(self):
    return self.epoch + self.t.detach().cpu().numpy().astype(np.float64)


def init_bank(spec: FilterSpec, x0, P0, batch: int, t0=0.0,
              dtype=torch.float32, device="cuda") -> BankState:
  """Broadcast one initial (x0, P0) to a B-wide bank; t0 becomes the epoch."""
  x0 = torch.as_tensor(np.asarray(x0), dtype=dtype, device=device)
  P0 = torch.as_tensor(np.asarray(P0), dtype=dtype, device=device)
  if x0.shape != (spec.dim_x,) or P0.shape != (spec.dim_err, spec.dim_err):
    raise ValueError(f"x0 {tuple(x0.shape)} / P0 {tuple(P0.shape)} do not "
                     f"fit spec {spec.name!r}")
  return BankState(
      x=x0.expand(batch, spec.dim_x).clone(),
      P=P0.expand(batch, spec.dim_err, spec.dim_err).clone(),
      t=torch.zeros((batch,), dtype=dtype, device=device),
      epoch=float(t0),
  )


def bank_predict_and_update(spec: FilterSpec, kind: int, params,
                            state: BankState, Q, dt, z, R, ea):
  """One fused predict+update across the whole bank.

  dt (B,) or scalar; z (B, dz); R (B, dz, dz); ea (B, ea_dim).
  Returns (new_state, y (B, dz)).
  """
  x = state.x
  dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device).expand(state.batch)

  def one(x, P, dt_i, z_i, R_i, ea_i):
    x_p, P_p = step_ops.predict(spec, params, x, P, Q, dt_i)
    return step_ops.update(spec, kind, params, x_p, P_p, z_i, R_i, ea_i)

  x_new, P_new, y = vmap(one)(x, state.P, dt, z, R, ea)
  return BankState(x=x_new, P=P_new, t=state.t + dt, epoch=state.epoch), y


def run_bank(spec: FilterSpec, kind: int, params, state: BankState, Q,
             dts, zs, Rs, eas=None):
  """T steps over a B-wide bank. dts (T,), zs (T, B, dz),
  Rs (T, B, dz, dz) or (T, dz, dz) shared, eas (T, B, ea) or None.
  Returns (final BankState, ys (T, B, dz)), ys the innovations
  z - h(x_pred). On CUDA tensors: one launch of kernel 15 (the custom op
  rednose::run_bank; its gradient kernels 9 and 10's lane forms, once
  each), the inputs cast to the state's dtype (float32 or float64), t of
  that dtype too, a kind that is not an MSCKF feature kind. On CPU
  tensors: run_bank_reference."""
  if state.x.device.type == "cpu":
    return run_bank_reference(spec, kind, params, state, Q, dts, zs, Rs,
                              eas)
  return _kernel_run_bank(spec, kind, params, state, Q, dts, zs, Rs, eas)


def run_bank_reference(spec: FilterSpec, kind: int, params,
                       state: BankState, Q, dts, zs, Rs, eas=None):
  """run_bank's plain version on any device: one Python iteration a step
  of the vmapped core/step predict + update, which autograd runs
  through. Its `.launches` counts its runs."""
  run_bank_reference.launches += 1
  om = spec.obs[kind]
  T, B = zs.shape[0], state.batch
  if Rs.ndim == 3:
    Rs = Rs[:, None].expand(T, B, om.dz, om.dz)
  if eas is None:
    eas = torch.zeros((T, B, max(om.ea_len, 1)), dtype=state.x.dtype,
                      device=state.x.device)
  ys = []
  for k in range(T):
    state, y = bank_predict_and_update(spec, kind, params, state, Q, dts[k],
                                       zs[k], Rs[k], eas[k])
    ys.append(y)
  if not ys:
    return state, zs.new_zeros((0, B, om.dz), dtype=state.x.dtype)
  return state, torch.stack(ys)


run_bank_reference.launches = 0


# ------------------------------------------------- the card: kernel 15

def _kernel_run_bank(spec, kind, params, state, Q, dts, zs, Rs, eas=None):
  """run_bank through kernel 15 (the custom op rednose::run_bank), on the
  device of the state."""
  om = spec.obs[kind]
  x = state.x
  dev, dtype = x.device, x.dtype
  as_dev = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
  _refuse_forward_mode([v for v in (x, state.P, state.t, Q, dts, zs, Rs,
                                    eas, *params.values())
                        if torch.is_tensor(v)])
  if state.t.dtype != dtype:
    raise ValueError(f"run_bank on the card: t is {state.t.dtype}, x "
                     f"{dtype}; the kernel advances t in x's dtype")
  T, B = zs.shape[0], state.batch
  pnames = tuple(sorted(params))
  prm = (torch.stack([as_dev(params[k]) for k in pnames]) if pnames
         else torch.zeros(1, dtype=dtype, device=dev))
  ea = None
  if om.ea_len:
    ea = (as_dev(eas)[..., :om.ea_len] if eas is not None
          else x.new_zeros((T, B, om.ea_len)))
  x_, P_, t_, ys = torch.ops.rednose.run_bank(
      x, as_dev(state.P), state.t, as_dev(dts), as_dev(zs), as_dev(Rs), ea,
      as_dev(Q), prm, scan._handle(spec, (int(kind),), pnames))
  return BankState(x=x_, P=P_, t=t_, epoch=state.epoch), ys


def _lanes_last(a):
  """A contiguous copy of a with its lane axis (the first) moved last, or
  None for None; a copy also where the view is contiguous, since kernels
  9 and 15 advance their x and P in place."""
  if a is None:
    return None
  return a.permute(*range(1, a.dim()), 0).clone(
      memory_format=torch.contiguous_format)


def _steps_lanes_last(a):
  """(T, B, ...) -> a contiguous (T, ..., B), or None for None."""
  if a is None:
    return None
  return a.permute(0, *range(2, a.dim()), 1).contiguous()


@torch.library.custom_op("rednose::run_bank", mutates_args=())
def _run_bank_op(x: torch.Tensor, P: torch.Tensor, t: torch.Tensor,
                 dts: torch.Tensor, zs: torch.Tensor, Rs: torch.Tensor,
                 eas: torch.Tensor | None, Q: torch.Tensor,
                 prm: torch.Tensor, handle: int) -> tuple[
                     torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """Kernel 15 over B lanes in run_bank's layout: x (B, dim_x), P (B, de,
  de), t (B,), dts (T,), zs (T, B, dz), Rs (T, B, dz, dz) by lane or (T,
  dz, dz) shared, eas (T, B, ea_len) or None. Returns (x, P, t, ys (T, B,
  dz)): the kernel's bank-minor outputs, transposed by one copy each."""
  from rednose_tpu_torch.ops import generic_scan

  call = scan._kernel_call(handle, scan._q_pattern(Q), "bank")
  xk, Pk, tk = _lanes_last(x), _lanes_last(P), t.clone()
  Rk = _steps_lanes_last(Rs) if Rs.dim() == 4 else Rs.contiguous()
  _, _, _, ys = generic_scan.bank_run_scan(
      call, xk, Pk, tk, _steps_lanes_last(zs), dts.contiguous(), Rk,
      _steps_lanes_last(eas), prm.contiguous(), Q.contiguous())
  return (xk.T.contiguous(), Pk.permute(2, 0, 1).contiguous(), tk,
          ys.transpose(1, 2).contiguous())


def _refuse_forward_mode(values):
  """Forward mode through kernel 15 is not ported (it would need a tangent
  scan): raise, naming it, under torch.func.jvp or with a dual tensor of
  torch.autograd.forward_ad; the other torch.func transforms reach the op
  as an autograd.Function they cannot run, so raise there too, naming
  torch.autograd.grad."""
  from torch._C._functorch import TransformType, get_interpreter_stack
  from torch.autograd import forward_ad

  keys = {i.key() for i in get_interpreter_stack() or ()}
  if TransformType.Jvp in keys or any(
      forward_ad.unpack_dual(v).tangent is not None for v in values):
    raise NotImplementedError(
        "run_bank on the card: forward mode (torch.func.jvp, forward-mode "
        "AD) through kernel 15 is not ported; reverse mode is (torch."
        "autograd.grad / backward run kernels 9 and 10's lane forms), or "
        "run run_bank_reference's plain loop")
  if keys:
    raise NotImplementedError(
        "run_bank on the card runs under no torch.func transform: for its "
        "gradient call torch.autograd.grad / backward (kernels 9 and 10's "
        "lane forms), not torch.func.grad, jacrev or vmap")


def _setup_backward(ctx, inputs, output):
  x, P, t, dts, zs, Rs, eas, Q, prm, handle = inputs
  ctx.handle = handle
  # an output the loss does not read reaches the backward as None
  ctx.set_materialize_grads(False)
  ctx.save_for_backward(x, P, dts, zs, Rs, eas, Q, prm)


def _run_bank_backward(ctx, gx, gP, gt, gys):
  """Autograd rule of rednose::run_bank: kernels 9 and 10's lane forms
  once each, through the op rednose::run_bank_backward. t_final = t +
  sum(dts) lane by lane, so t's cotangent passes to t and, summed over
  the lanes, to every dt."""
  if torch.is_grad_enabled():
    raise NotImplementedError(
        "run_bank on the card: higher-order gradients (create_graph=True) "
        "through kernels 9 and 10's lane forms are not ported; run "
        "run_bank_reference's plain loop for them")
  x, P, dts, zs, Rs, eas, Q, prm = ctx.saved_tensors
  dx, dP, ddts, dzs, dRs, deas, dQ, dprm = \
      torch.ops.rednose.run_bank_backward(x, P, dts, zs, Rs, eas, Q, prm, gx,
                                          gP, gys, ctx.handle)
  if gt is not None:
    ddts = ddts + gt.sum()
  return (dx, dP, gt, ddts, dzs, dRs, None if eas is None else deas, dQ,
          dprm, None)


_run_bank_op.register_autograd(_run_bank_backward,
                               setup_context=_setup_backward)


@torch.library.custom_op("rednose::run_bank_backward", mutates_args=())
def _run_bank_backward_op(
    x: torch.Tensor, P: torch.Tensor, dts: torch.Tensor, zs: torch.Tensor,
    Rs: torch.Tensor, eas: torch.Tensor | None, Q: torch.Tensor,
    prm: torch.Tensor, gx: torch.Tensor | None, gP: torch.Tensor | None,
    gys: torch.Tensor | None, handle: int) -> tuple[
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
        torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """The gradients of rednose::run_bank's (x, P, dts, zs, Rs, eas, Q,
  prm) from the cotangents of its final x and P and of its ys (None for
  an output the loss does not read, which the kernels skip): kernel 9's
  lane form recomputes the stacks from (x, P), then kernel 10's lane
  form runs the log backwards with the innovations' cotangent seeded on
  each update's y; the shared inputs' per-lane cotangents summed over
  the lanes, P's, Q's and R's symmetrized (R's per lane where it came by
  lane); an empty eas gradient where eas is None; a RuntimeWarning where
  a lane-step's recomputed gate decision differs from the stacks'."""
  from rednose_tpu_torch.ops import generic_scan

  qp = scan._q_pattern(Q)
  T, B = dts.shape[0], x.shape[0]
  x0k, P0k = _lanes_last(x), _lanes_last(P)
  zk, ek = _steps_lanes_last(zs), _steps_lanes_last(eas)
  Rk = (_steps_lanes_last(Rs) if Rs.dim() == 4
        else Rs[..., None].expand(*Rs.shape, B).contiguous())
  ki = torch.zeros(T, dtype=torch.int32, device=x.device)
  dts, prm, Q = dts.contiguous(), prm.contiguous(), Q.contiguous()
  stacks = generic_scan.stream_bank_scan_lanes(
      scan._kernel_call(handle, qp, "stream", True), x0k.clone(),
      P0k.clone(), zk, dts, ki, Rk, ek, prm, Q)
  dx0, dP0, dzs, dRs, ddts, deas, dQ, dprm = \
      generic_scan.stream_bank_scan_adjoint_lanes(
          scan._kernel_call(handle, qp, "stream_adjoint", True), x0k, P0k,
          zk, dts, ki,
          Rk, ek, prm, Q, *stacks, _lanes_last(gx), _lanes_last(gP), None,
          None, None, None, _steps_lanes_last(gys))
  flips = generic_scan.stream_bank_scan_adjoint_lanes.gate_flips
  dR = (scan._sym(dRs.permute(0, 3, 1, 2)) if Rs.dim() == 4
        else scan._sym(dRs.sum(-1)))
  out = (dx0.T.contiguous(), scan._sym(dP0.permute(2, 0, 1)).contiguous(),
         ddts.sum(-1), dzs.transpose(1, 2).contiguous(), dR.contiguous(),
         (x.new_zeros(0) if deas is None
          else deas.transpose(1, 2).contiguous()),
         scan._sym(dQ.sum(-1)), dprm.sum(-1))
  # read once the reductions are queued: the backward's one wait
  n = int(flips.sum())
  if n:
    warnings.warn(
        f"run_bank on the card: at {n} lane-steps kernel 10's lane form "
        "recomputed a gate decision that differs from the one it read from "
        "the recomputed stacks (a step is rejected where every diagonal "
        "entry of the posterior P equals the predicted one) and followed; "
        "if an accepted update's change to P rounded away there, its share "
        "of the gradient is missing (run_bank_reference's plain loop "
        "decides each step once)", RuntimeWarning, stacklevel=2)
  return out


def _refuse_second_order(ctx, *grads):
  raise NotImplementedError(
      "run_bank on the card: a gradient of its backward (kernels 9 and 10's "
      "lane forms) is not ported; run run_bank_reference's plain loop for "
      "higher-order gradients")


_run_bank_backward_op.register_autograd(
    _refuse_second_order, setup_context=lambda ctx, inputs, output: None)


def bank_rmse(state: BankState, truth):
  """Bank-wide state RMSE against a broadcast truth vector, over every lane
  and state entry: the aggregate that parallel/sharding computes from
  every rank's shard (sharded_bank_rmse)."""
  truth = torch.as_tensor(np.asarray(truth), dtype=state.x.dtype,
                          device=state.x.device)
  return torch.sqrt(torch.mean((state.x - truth) ** 2))
