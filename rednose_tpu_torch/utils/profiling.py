"""Tracing / profiling / numeric-debug hooks.

Port of rednose_tpu/utils/profiling.py. The reference's only tracing is a
Cython profile directive (ekf_sym_pyx.pyx:2); the port's equivalents are
torch.profiler traces (CPU and CUDA activity, viewable in TensorBoard or
Perfetto), `record_function` scopes (with an NVTX range on the card) on
the hot ops, NaN detection over state trees, a FLOP counter on eager
torch code with the JAX counter's rule, and the operation count of an
emitted kernel body.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _is_cuda(device) -> bool:
  if torch.is_tensor(device):
    return device.is_cuda
  return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def named_scope(name: str, device=None):
  """A named span in profiler traces (torch.profiler.record_function),
  plus an NVTX range when `device` (a device, or a tensor) is CUDA."""
  nvtx = _is_cuda(device)
  with torch.profiler.record_function(name):
    if nvtx:
      torch.cuda.nvtx.range_push(name)
    try:
      yield
    finally:
      if nvtx:
        torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(logdir: str):
  """Profile a block over CPU activity, and CUDA activity when a card is
  present: with trace('/tmp/tb') as prof: run(). The Chrome / TensorBoard
  trace (*.pt.trace.json) is written into logdir when the block ends."""
  os.makedirs(logdir, exist_ok=True)
  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  with torch.profiler.profile(
      activities=activities,
      on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
    yield prof


def annotate_step(fn, name: str):
  """Wrap a step function in a named scope so it is attributable in traces
  (the scope's NVTX range when its first tensor argument is on CUDA)."""
  def wrapped(*args, **kwargs):
    first = next((a for a in args if torch.is_tensor(a)), None)
    with named_scope(name, first):
      return fn(*args, **kwargs)
  return wrapped


def _leaves_with_path(tree, path=""):
  """(path, leaf) of every tensor or array in nested dicts, lists, tuples
  and dataclasses; the path in the JAX package's keystr form."""
  if isinstance(tree, dict):
    for k, v in tree.items():
      yield from _leaves_with_path(v, f"{path}[{k!r}]")
  elif isinstance(tree, (list, tuple)):
    for i, v in enumerate(tree):
      yield from _leaves_with_path(v, f"{path}[{i}]")
  elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    for f in dataclasses.fields(tree):
      yield from _leaves_with_path(getattr(tree, f.name), f"{path}.{f.name}")
  elif torch.is_tensor(tree) or isinstance(tree, (np.ndarray, np.generic,
                                                  float, int)):
    yield path, tree


def assert_finite(tree, name: str = "state"):
  """Host-side NaN / inf check over a tree of tensors and arrays; raises
  FloatingPointError naming the first non-finite leaf's path."""
  for path, leaf in _leaves_with_path(tree):
    ok = (bool(torch.isfinite(leaf).all()) if torch.is_tensor(leaf)
          else bool(np.all(np.isfinite(leaf))))
    if not ok:
      raise FloatingPointError(f"non-finite values in {name}{path}")


def finite_or_nan_flag(tree):
  """A 0-d bool tensor on the device of the tree's first tensor: True when
  every tensor of the tree is finite (bank health monitoring). It never
  reads a value back to the host, so it queues behind the work before it
  without a sync."""
  leaves = [leaf for _, leaf in _leaves_with_path(tree)
            if torch.is_tensor(leaf)]
  if not leaves:
    return torch.tensor(True)
  dev = leaves[0].device
  return torch.stack([torch.isfinite(leaf).all().to(dev)
                      for leaf in leaves]).all()


# The JAX counter's rule (rednose_tpu/utils/profiling.py), its primitive
# names mapped to aten's: elementwise operations and comparisons count one
# FLOP per output element, matrix products 2 * out * K, everything else
# (data movement, reductions, views, copies) 0. An elementwise function
# that aten dispatches whole (hypot, softplus, a jvp's tanh_backward)
# counts one, as a primitive does; a composite counts the elementwise
# arithmetic of its formula (_COMPOSITE_FLOPS).
_ELEMENTWISE_FLOP_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "neg",
    "maximum", "minimum", "max", "min", "pow", "exp", "log", "log1p",
    "expm1", "sqrt", "rsqrt", "reciprocal", "sin", "cos", "tan", "asin",
    "acos", "atan", "atan2", "sinh", "cosh", "tanh", "sigmoid", "erf",
    "erfc", "abs", "sign", "sgn", "floor", "ceil", "round", "nextafter",
    "where", "clamp", "clamp_min", "clamp_max", "square", "hypot",
    "softplus", "tanh_backward", "sigmoid_backward", "softplus_backward",
    "masked_fill",
})
# composites: (args, out) -> FLOPs. A cross product is two products and a
# difference per output element; a vector norm squares (or takes the abs
# of) each input and takes a root per output, its sum a reduction (0); a
# mean divides each output, its sum 0 too.
_COMPOSITE_FLOPS = {
    "linalg_cross": lambda args, out: 3 * _numel(out),
    "linalg_vector_norm": lambda args, out: (
        args[0].numel()
        + (_numel(out) if len(args) < 2 or float(args[1]) != 1.0 else 0)),
    "mean": lambda args, out: _numel(out),
}
_COMPARE_OPS = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})
# matrix products: the argument index of the left operand, whose last
# dimension is the contracted one
_MATMUL_OPS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0,
               "addmm": 1, "baddbmm": 1, "addmv": 1}


def _numel(out) -> int:
  return sum(t.numel() for t in tree_leaves(out) if torch.is_tensor(t))


def _nbytes(tree) -> int:
  return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
             if torch.is_tensor(t))


def _op_flops(name, args, out) -> int:
  if name in _MATMUL_OPS:
    lhs = args[_MATMUL_OPS[name]]
    return 2 * _numel(out) * (lhs.shape[-1] if lhs.ndim else 1)
  if name in _ELEMENTWISE_FLOP_OPS or name in _COMPARE_OPS:
    return _numel(out)
  if name in _COMPOSITE_FLOPS:
    return _COMPOSITE_FLOPS[name](args, out)
  return 0


class _CostCounter(TorchDispatchMode):
  """Counts FLOPs and the bytes each op reads and writes, per dispatched
  aten op (after vmap's batching and jacfwd's dual numbers)."""

  def __init__(self):
    super().__init__()
    self.flops = 0
    self.bytes = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
      name = name[:-1]   # in-place variant: the same arithmetic
    self.flops += _op_flops(name, args, out)
    if not func.is_view:
      self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
    return out


def torch_flops(fn, *args, **kwargs) -> int:
  """FLOPs of fn(*args) under the JAX package's counting rule (jaxpr_flops):
  each elementwise or comparison op contributes its output size (a
  (22, 22, B) mul is 484 * B FLOPs), a matrix product 2 * out * K, data
  movement 0. The ops are counted as they run (a TorchDispatchMode), so a
  Python loop of T steps counts T bodies, as a JAX scan of length T does;
  JAX's while_loop counts one body whatever its trip count, where eager
  code counts the trips it took. An elementwise function that aten
  dispatches whole counts one FLOP per output element, and a composite
  (a cross product, a vector norm, a mean) the arithmetic of its formula,
  where JAX counts the primitives it lowers them to, so the two counts
  part by such ops."""
  with _CostCounter() as c:
    fn(*args, **kwargs)
  return c.flops


def cost_report(fn, *args, **kwargs) -> dict:
  """{'flops': torch_flops, 'bytes accessed': the bytes every dispatched op
  reads and writes, its tensor inputs and outputs (views, which move no
  data, excluded)}. Eager torch runs each op alone, so the byte count is
  unfused: an upper bound on what a fused kernel moves, where XLA's
  cost_analysis in the JAX package counts after fusion."""
  with _CostCounter() as c:
    fn(*args, **kwargs)
  return {"flops": c.flops, "bytes accessed": c.bytes}


def emitted_ops(source: str) -> dict:
  """Arithmetic operations of each function of an emitted kernel source
  (ops/entry_slab.py, ops/adjoint.py): every SSA definition that is not a
  plain load of an input (x, P, dt, p, Q, z, ea, R; in an adjoint also the
  incoming cotangents lx, GEN_L and the gate decision rej) is one
  operation (a product, a sum, a compare, a select, a sqrt)."""
  ops, name = {}, None
  load = re.compile(r"= (x\[|GEN_P\(|dt;|p\[|Q\[|z\[|ea\[|R\[|lx\[|"
                    r"GEN_L\(|rej;)")
  for line in source.splitlines():
    m = re.match(r"GEN_HD GEN_(?:INLINE|PHASE) void (\w+)\(", line)
    if m:
      name = m.group(1)
      ops[name] = 0
    elif name and line.startswith("  const ") and not load.search(line):
      ops[name] += 1
  return ops


def step_ops(source: str, kinds, mode: str = "single") -> float:
  """Operations of one step of an emitted source (its global form,
  generic_scan.KernelCall.counting_source()): the predict plus the update
  (or camera frame) of each kind of an epoch, of the one kind of a single
  or frame step, or on average over a mixed schedule that cycles through
  its kinds evenly. An adjoint source (mode "stream_adjoint") counts its
  adjoint phases, gen_adj_predict and gen_adj_update_k<kind>."""
  ops = emitted_ops(source)
  pre = "gen_adj_" if "gen_adj_predict" in ops else "gen_"

  def unit(k):
    return next(v for name, v in ops.items()
                if re.fullmatch(rf"{pre}(update|frame)_k{int(k)}(_g)?", name))

  units = sum(unit(k) for k in kinds)
  return ops[f"{pre}predict"] + (units / len(kinds) if mode == "mixed"
                                 else units)
