"""Structural partial evaluation of spec functions into a scalar expression DAG.

Port of rednose_tpu/ops/structural.py, rebuilt for C emission. The
reference gets sparse, simplified Jacobians from sympy, which derives each
F / H entry symbolically and emits only the nonzero arithmetic as C
(rednose/helpers/ekf_sym.py:76-89). Here a spec function is traced once
with `torch.fx.experimental.proxy_tensor.make_fx` at per-filter logical
shapes (its Jacobian columns by tracing `torch.func.jvp`), and the aten
graph is interpreted at scalar granularity. Every value is a numpy object
array whose elements are

  * None         a structural zero,
  * a float      a folded constant (a bool for folded comparisons),
  * an `Expr`    a node of a memoized SSA expression DAG.

With the evaluation point v = 0 known structurally, sin(0) folds to 0,
cos(0) to 1, a product with a zero vanishes and a product with +-1 is a
sign: each Jacobian column keeps only its nonzero arithmetic. The DAG is
hash-consed, so a subexpression shared between the nominal propagation and
the Jacobian taps exists once (the reference's sympy CSE,
sympy_helpers.py:122-162). ops/entry_slab.py turns the DAG into CUDA C.

Every aten op the interpreter meets needs a rule: an op without one raises
and names it. There is no fallback that evaluates the real op, since the
result must be C source. A graph that mutates a tensor (a vector norm's
jvp divides in place and masks the zero-norm case with masked_fill_) is
traced again functionalized, so the interpreter sees only pure ops; a
graph without a mutation keeps its first trace.
"""

from __future__ import annotations

import itertools
import math
import operator

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx


class Expr:
  """One SSA node: an operation on child nodes / constants, or a leaf
  ('load', array name, index) read from the kernel's inputs."""

  __slots__ = ("op", "args", "id", "is_bool")

  def __init__(self, op, args, nid, is_bool=False):
    self.op = op
    self.args = args
    self.id = nid
    self.is_bool = is_bool

  def __repr__(self):
    return f"Expr#{self.id}({self.op})"


def _is_const(e):
  return isinstance(e, (bool, int, float))


def _key(e):
  if e is None:
    return None
  if isinstance(e, Expr):
    return ("e", e.id)
  return ("c", type(e).__name__, e)


_BOOL_OPS = frozenset({"gt", "lt", "ge", "le", "eq", "ne", "and", "or",
                       "not"})

# f(0) = 0 elementwise functions (a structural zero stays one)
_ZERO_PRESERVING = frozenset({
    "sin", "tan", "tanh", "sinh", "asin", "atan", "asinh", "atanh",
    "expm1", "log1p", "abs", "sign", "sqrt", "erf", "floor", "ceil",
})
# f(0) = 1 elementwise functions
_ONE_AT_ZERO = frozenset({"cos", "cosh", "exp"})
_UNARY = _ZERO_PRESERVING | _ONE_AT_ZERO | {"log", "acos", "rsqrt"}
_PY_UNARY = {
    "sin": math.sin, "cos": math.cos, "tan": math.tan, "tanh": math.tanh,
    "sinh": math.sinh, "cosh": math.cosh, "asin": math.asin,
    "acos": math.acos, "atan": math.atan, "asinh": math.asinh,
    "atanh": math.atanh, "exp": math.exp, "expm1": math.expm1,
    "log": math.log, "log1p": math.log1p, "abs": abs, "sqrt": math.sqrt,
    "erf": math.erf, "floor": math.floor, "ceil": math.ceil,
    "sign": lambda a: float((a > 0) - (a < 0)),
    "rsqrt": lambda a: 1.0 / math.sqrt(a),
}
_PY_BINARY = {
    "max": max, "min": min, "atan2": math.atan2, "fmod": math.fmod,
    # floor-mod taking the divisor's sign, as torch.remainder
    "remainder": operator.mod, "hypot": math.hypot,
    "gt": operator.gt, "lt": operator.lt, "ge": operator.ge,
    "le": operator.le, "eq": operator.eq, "ne": operator.ne,
    "and": lambda a, b: bool(a) and bool(b),
    "or": lambda a, b: bool(a) or bool(b),
}


class ExprDAG:
  """Hash-consed expression builder with the zero / constant folding of
  the JAX interpreter's scalar rules (_Interp.s_*)."""

  def __init__(self):
    self.memo = {}
    self.nodes = []

  def node(self, op, *args):
    key = (op,) + tuple(_key(a) for a in args)
    e = self.memo.get(key)
    if e is None:
      e = Expr(op, args, len(self.nodes), op in _BOOL_OPS)
      self.memo[key] = e
      self.nodes.append(e)
    return e

  def load(self, name, idx=()):
    return self.node("load", name, tuple(idx))

  # ------------------------------------------------------------ scalar rules

  def mul(self, x, y):
    if x is None or y is None:
      return None
    if _is_const(x) and _is_const(y):
      return x * y
    for lit, other in ((x, y), (y, x)):
      if _is_const(lit):
        if lit == 1.0:
          return other
        if lit == -1.0:
          return self.neg(other)
    return self.node("mul", x, y)

  def add(self, x, y):
    if x is None:
      return y
    if y is None:
      return x
    if _is_const(x) and _is_const(y):
      return x + y
    return self.node("add", x, y)

  def sub(self, x, y):
    if y is None:
      return x
    if x is None:
      return self.neg(y)
    if _is_const(x) and _is_const(y):
      return x - y
    return self.node("sub", x, y)

  def neg(self, x):
    if x is None:
      return None
    if _is_const(x):
      return -x
    return self.node("neg", x)

  def div(self, x, y):
    if y is None or (_is_const(y) and y == 0.0):
      # a structurally zero denominator keeps the real division, so 0/0
      # is NaN as in the jacfwd oracle
      return self.node("div", 0.0 if x is None else x, 0.0)
    if x is None:
      return None
    if _is_const(x) and _is_const(y):
      return x / y
    return self.node("div", x, y)

  def unary(self, name, x):
    if x is None:
      if name in _ZERO_PRESERVING:
        return None
      if name in _ONE_AT_ZERO:
        return 1.0
      x = 0.0
    if _is_const(x) and name != "rsqrt":
      try:
        return float(_PY_UNARY[name](x))
      except (ValueError, OverflowError):
        return math.nan
    return self.node(name, x)

  def pow(self, x, y):
    if _is_const(x) and _is_const(y):
      return float(x) ** y
    if y is None or (_is_const(y) and y == 0.0):
      return 1.0  # x**0 == 1, 0**0 included
    if x is None:
      if _is_const(y) and y > 0:
        return None
      x = 0.0
    if _is_const(y) and float(y).is_integer() and 1 <= y <= 4:
      # small integer powers as products (what x**2 in model code means)
      out = x
      for _ in range(int(y) - 1):
        out = self.mul(out, x)
      return out
    return self.node("pow", x, y)

  def binop(self, name, x, y):
    """max, min, atan2, fmod, remainder, hypot, comparisons, logical
    and/or: no structural shortcut is safe (fmod(0, 0) is NaN), so zeros
    are materialized."""
    x = 0.0 if x is None else x
    y = 0.0 if y is None else y
    if _is_const(x) and _is_const(y):
      try:
        return _PY_BINARY[name](x, y)
      except (ValueError, ZeroDivisionError):
        return math.nan
    return self.node(name, x, y)

  def where(self, c, a, b):
    c = 0.0 if c is None else c
    if _is_const(c):
      return a if c else b
    if a is None and b is None:
      return None
    return self.node("where", c, 0.0 if a is None else a,
                     0.0 if b is None else b)

  def logical_not(self, c):
    c = 0.0 if c is None else c
    if _is_const(c):
      return not c
    return self.node("not", c)

  def to_float(self, c):
    if c is None or (_is_const(c) and not c):
      return None
    if _is_const(c):
      return float(c)
    return self.node("cast", c) if c.is_bool else c


# ------------------------------------------------------------- object arrays

def obj_array(shape, fill=None):
  out = np.empty(shape, dtype=object)
  out.fill(fill)
  return out


def const_array(values):
  """A concrete tensor / array as an object array of folded constants."""
  arr = np.asarray(values.detach().cpu().numpy() if torch.is_tensor(values)
                   else values)
  out = obj_array(arr.shape)
  for idx in np.ndindex(arr.shape):
    v = arr[idx].item()
    out[idx] = None if v == 0 else v
  return out


def load_array(dag, name, shape):
  """Object array of leaves name[idx] for a kernel input of this shape."""
  out = obj_array(shape)
  for idx in np.ndindex(shape):
    out[idx] = dag.load(name, idx)
  return out


def _ew(fn, *arrs):
  shape = np.broadcast_shapes(*[a.shape for a in arrs])
  bs = [np.broadcast_to(a, shape) for a in arrs]
  out = obj_array(shape)
  for idx in np.ndindex(shape):
    out[idx] = fn(*[b[idx] for b in bs])
  return out


def _arr(v):
  """An indexing result as an object array (numpy returns a bare element
  for a full index)."""
  if isinstance(v, np.ndarray):
    return v
  out = obj_array(())
  out[()] = v
  return out


def _as_obj(v):
  if isinstance(v, np.ndarray) and v.dtype == object:
    return v
  if isinstance(v, (bool, int, float)):
    out = obj_array(())
    out[()] = None if v == 0 and not isinstance(v, bool) else v
    return out
  raise NotImplementedError(f"structural interpreter: operand {v!r}")


def _dim(d, ndim):
  return d + ndim if d < 0 else d


def _arg(args, kw, i, name, default=None):
  """Argument i of an aten call, positional or by keyword."""
  return args[i] if len(args) > i else kw.get(name, default)


def _sum(dag, x, dims, keep):
  """Left-fold sum of x over dims (None or empty: every dim)."""
  if dims is None or (isinstance(dims, (list, tuple)) and not dims):
    dims = tuple(range(x.ndim))
  dims = tuple(_dim(a, x.ndim) for a in (dims if isinstance(
      dims, (list, tuple)) else [dims]))
  out_shape = tuple(s for i, s in enumerate(x.shape) if i not in dims)
  out = obj_array(out_shape)
  for oidx in np.ndindex(out_shape):
    it = iter(oidx)
    base = [0 if i in dims else next(it) for i in range(x.ndim)]
    acc = None
    for ridx in itertools.product(*[range(x.shape[a]) for a in dims]):
      idx = list(base)
      for a, v in zip(dims, ridx):
        idx[a] = v
      acc = dag.add(acc, x[tuple(idx)])
    out[oidx] = acc
  if keep:
    for a in dims:
      out = np.expand_dims(out, a)
  return out


def _contract(dag, a, b, out_shape, idx_fn, k):
  """Left-fold sum over the contracted index (the JAX dot order)."""
  out = obj_array(out_shape)
  for oidx in np.ndindex(out_shape):
    acc = None
    for c in range(k):
      ia, ib = idx_fn(oidx, c)
      acc = dag.add(acc, dag.mul(a[ia], b[ib]))
    out[oidx] = acc
  return out


# ops that return their operand as it is
_ALIASES = frozenset({"alias", "detach", "clone", "lift_fresh_copy",
                      "contiguous", "view_of", "lift_fresh", "positive",
                      "resolve_conj", "resolve_neg"})
# shape ops; a functionalized graph writes the views among them, and
# alias, as <name>_copy
_SHAPE_OPS = frozenset({
    "select", "slice", "cat", "concat", "stack", "unsqueeze", "squeeze",
    "view", "reshape", "_unsafe_view", "_reshape_alias", "t", "numpy_T",
    "permute", "transpose", "expand", "broadcast_to", "unbind", "flip",
    "roll"})


class Interpreter:
  """Evaluates make_fx graphs of spec functions on object arrays."""

  def __init__(self, dag: ExprDAG):
    self.dag = dag

  # ------------------------------------------------------------ array rules

  def _arith(self, name, args, kw):
    d = self.dag
    a, b = _as_obj(args[0]), _as_obj(args[1])
    alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
    if name in ("add", "sub") and alpha != 1:
      b = _ew(lambda e: d.mul(float(alpha), e), b)
    if name == "div" and kw.get("rounding_mode") is not None:
      raise NotImplementedError("structural interpreter: aten.div with "
                                f"rounding_mode={kw['rounding_mode']!r}")
    rule = {"add": d.add, "sub": d.sub, "mul": d.mul, "div": d.div,
            "pow": d.pow}[name]
    return _ew(rule, a, b)

  def _shape_op(self, name, args, kw):
    x = args[0]
    if name == "select":
      dim, i = _dim(args[1], x.ndim), args[2]
      return _arr(np.take(x, i, axis=dim))
    if name == "slice":
      dim = _dim(args[1] if len(args) > 1 else kw.get("dim", 0), x.ndim)
      start = args[2] if len(args) > 2 else kw.get("start")
      end = args[3] if len(args) > 3 else kw.get("end")
      step = args[4] if len(args) > 4 else kw.get("step", 1)
      sl = [slice(None)] * x.ndim
      sl[dim] = slice(start, end, step)
      return x[tuple(sl)]
    if name in ("cat", "concat"):
      parts = [p for p in args[0] if p.size or p.ndim > 1]
      dim = args[1] if len(args) > 1 else kw.get("dim", 0)
      return np.concatenate(parts, axis=_dim(dim, parts[0].ndim))
    if name == "stack":
      dim = args[1] if len(args) > 1 else kw.get("dim", 0)
      return np.stack(args[0], axis=_dim(dim, args[0][0].ndim + 1))
    if name == "unsqueeze":
      return np.expand_dims(x, _dim(args[1], x.ndim + 1))
    if name == "squeeze":
      if len(args) == 1:
        return np.squeeze(x)
      dims = args[1] if isinstance(args[1], (list, tuple)) else [args[1]]
      dims = tuple(_dim(d, x.ndim) for d in dims if x.shape[_dim(d, x.ndim)]
                   == 1)
      return np.squeeze(x, axis=dims)
    if name in ("view", "reshape", "_unsafe_view", "_reshape_alias"):
      return np.reshape(x, tuple(args[1]))
    if name in ("t", "numpy_T"):
      return x.T
    if name == "permute":
      return np.transpose(x, tuple(_dim(d, x.ndim) for d in args[1]))
    if name == "transpose":
      return np.swapaxes(x, _dim(args[1], x.ndim), _dim(args[2], x.ndim))
    if name in ("expand", "broadcast_to"):
      sizes = list(args[1])
      lead = len(sizes) - x.ndim
      sizes = [x.shape[i - lead] if s == -1 else s
               for i, s in enumerate(sizes)]
      return np.broadcast_to(x, tuple(sizes))
    if name == "unbind":
      dim = _dim(args[1] if len(args) > 1 else 0, x.ndim)
      return [_arr(np.take(x, i, axis=dim)) for i in range(x.shape[dim])]
    if name == "flip":
      return np.flip(x, tuple(_dim(a, x.ndim) for a in args[1]))
    if name == "roll":
      dims = _arg(args, kw, 2, "dims", [])
      return np.roll(x, tuple(args[1]),
                     tuple(_dim(a, x.ndim) for a in dims) if dims else None)
    raise AssertionError(name)

  def _reduce(self, name, args, kw):
    d = self.dag
    if name == "dot":
      a, b = args
      return _contract(d, a, b, (), lambda o, c: ((c,), (c,)),
                       a.shape[0])
    if name == "mv":
      a, b = args
      return _contract(d, a, b, (a.shape[0],),
                       lambda o, c: ((o[0], c), (c,)), a.shape[1])
    if name == "mm":
      a, b = args
      return _contract(d, a, b, (a.shape[0], b.shape[1]),
                       lambda o, c: ((o[0], c), (c, o[1])), a.shape[1])
    x = args[0]
    if name in ("sum", "mean"):
      dims = _arg(args, kw, 1, "dim")
      keep = _arg(args, kw, 2, "keepdim", False)
      out = _sum(d, x, dims, keep)
      if name == "sum":
        return out
      n = x.size // max(out.size, 1)
      return _ew(lambda e: d.div(e, float(n)), out)
    if name == "linalg_vector_norm":
      order = float(_arg(args, kw, 1, "ord", 2))
      dims, keep = _arg(args, kw, 2, "dim"), _arg(args, kw, 3, "keepdim",
                                                  False)
      if order == 2.0:
        return _ew(lambda e: d.unary("sqrt", e),
                   _sum(d, _ew(lambda e: d.mul(e, e), x), dims, keep))
      if order == 1.0:
        return _sum(d, _ew(lambda e: d.unary("abs", e), x), dims, keep)
      raise NotImplementedError(
          f"structural interpreter: linalg_vector_norm of ord {order!r} "
          "(ord 2 and 1 have rules)")
    if name == "cumsum":
      dim = _dim(_arg(args, kw, 1, "dim"), x.ndim)
      out = obj_array(x.shape)
      for idx in np.ndindex(x.shape[:dim] + x.shape[dim + 1:]):
        acc = None
        for i in range(x.shape[dim]):
          full = idx[:dim] + (i,) + idx[dim:]
          acc = d.add(acc, x[full])
          out[full] = acc
      return out
    raise AssertionError(name)

  def _elementwise(self, name, args, kw):
    """Activations and their jvp rules (aten's *_backward ops) as the
    formulas aten evaluates, so a structural zero folds through them."""
    d = self.dag
    a = [_as_obj(v) for v in args[:2]]
    if name == "sigmoid":
      return _ew(lambda e: d.div(1.0, d.add(1.0, d.unary("exp", d.neg(e)))),
                 a[0])
    if name == "tanh_backward":      # g (1 - y^2)
      return _ew(lambda g, y: d.mul(g, d.sub(1.0, d.mul(y, y))), *a)
    if name == "sigmoid_backward":   # g (1 - y) y
      return _ew(lambda g, y: d.mul(d.mul(g, d.sub(1.0, y)), y), *a)
    if name == "softplus":   # x b > threshold ? x : log1p(exp(x b)) / b
      beta = float(_arg(args, kw, 1, "beta", 1.0))
      thr = float(_arg(args, kw, 2, "threshold", 20.0))

      def softplus(x):
        xb = d.mul(x, beta)
        return d.where(d.binop("gt", xb, thr), x,
                       d.div(d.unary("log1p", d.unary("exp", xb)), beta))
      return _ew(softplus, a[0])
    if name == "softplus_backward":  # x b > thr ? g : g z / (z + 1)
      beta, thr = float(args[2]), float(args[3])

      def softplus_backward(g, x):
        xb = d.mul(x, beta)
        z = d.unary("exp", xb)   # z = e^(x b)
        return d.where(d.binop("gt", xb, thr), g,
                       d.div(d.mul(g, z), d.add(z, 1.0)))
      return _ew(softplus_backward, *a)
    if name == "masked_fill":
      return _ew(lambda x, m, v: d.where(m, v, x), a[0], a[1],
                 _as_obj(_arg(args, kw, 2, "value")))
    if name == "linalg_cross":       # aten's order: a1 b2 - a2 b1, ...
      x, y = a
      shape = np.broadcast_shapes(x.shape, y.shape)
      dim = _dim(kw.get("dim", -1), len(shape))
      if shape[dim] != 3:
        raise NotImplementedError("structural interpreter: linalg_cross "
                                  f"of dimension {shape[dim]}, not 3")
      x = np.moveaxis(np.broadcast_to(x, shape), dim, -1)
      y = np.moveaxis(np.broadcast_to(y, shape), dim, -1)
      out = obj_array(x.shape)
      for idx in np.ndindex(x.shape[:-1]):
        u, v = x[idx], y[idx]
        for i in range(3):
          j, k = (i + 1) % 3, (i + 2) % 3
          out[idx + (i,)] = d.sub(d.mul(u[j], v[k]), d.mul(u[k], v[j]))
      return np.moveaxis(out, -1, dim)
    raise AssertionError(name)

  def _make(self, name, args, kw):
    if name in ("zeros", "empty", "_efficientzerotensor", "new_zeros"):
      size = args[-1] if name == "new_zeros" else args[0]
      return obj_array(tuple(size))
    if name in ("ones", "new_ones"):
      size = args[-1] if name == "new_ones" else args[0]
      return obj_array(tuple(size), 1.0)
    if name in ("full", "new_full"):
      size, v = (args[1], args[2]) if name == "new_full" else args[:2]
      return obj_array(tuple(size), None if v == 0 else float(v))
    if name in ("zeros_like", "empty_like"):
      return obj_array(args[0].shape)
    if name == "ones_like":
      return obj_array(args[0].shape, 1.0)
    if name == "full_like":
      v = args[1]
      return obj_array(args[0].shape, None if v == 0 else float(v))
    if name == "scalar_tensor":
      return _as_obj(float(args[0]))
    if name == "eye":
      n = args[0]
      m = args[1] if len(args) > 1 and isinstance(args[1], int) else n
      out = obj_array((n, m))
      for i in range(min(n, m)):
        out[i, i] = 1.0
      return out
    raise AssertionError(name)

  def call(self, target, args, kw):
    d = self.dag
    name = target.overloadpacket.__name__ if hasattr(
        target, "overloadpacket") else getattr(target, "__name__", str(target))
    if name.endswith("_copy") and name[:-5] in _SHAPE_OPS | _ALIASES:
      name = name[:-5]   # a view, as a functionalized graph writes it
    if name == "rsub":  # rsub(a, b, alpha) = b - alpha a
      name, args = "sub", (args[1], args[0]) + tuple(args[2:])
    if name in ("add", "sub", "mul", "div", "pow"):
      return self._arith(name, args, kw)
    if name == "neg":
      return _ew(d.neg, args[0])
    if name == "reciprocal":
      return _ew(lambda e: d.div(1.0, e), args[0])
    if name == "square":
      return _ew(lambda e: d.mul(e, e), args[0])
    if name == "sgn":
      name = "sign"
    if name in _UNARY:
      return _ew(lambda e: d.unary(name, e), args[0])
    if name in ("sigmoid", "tanh_backward", "sigmoid_backward", "softplus",
                "softplus_backward", "masked_fill", "linalg_cross"):
      return self._elementwise(name, args, kw)
    if name in ("maximum", "minimum", "atan2", "gt", "lt", "ge", "le", "eq",
                "ne", "logical_and", "logical_or", "fmod", "remainder",
                "hypot"):
      op = {"maximum": "max", "minimum": "min", "logical_and": "and",
            "logical_or": "or"}.get(name, name)
      return _ew(lambda a, b: d.binop(op, a, b), _as_obj(args[0]),
                 _as_obj(args[1]))
    if name == "logical_not":
      return _ew(d.logical_not, args[0])
    if name in ("clamp", "clamp_min", "clamp_max"):
      x = args[0]
      lo = args[1] if len(args) > 1 else kw.get("min")
      hi = args[2] if len(args) > 2 else kw.get("max")
      if name == "clamp_max":
        lo, hi = None, lo
      if lo is not None:
        x = _ew(lambda a, b: d.binop("max", a, b), x, _as_obj(lo))
      if hi is not None:
        x = _ew(lambda a, b: d.binop("min", a, b), x, _as_obj(hi))
      return x
    if name == "where":
      return _ew(d.where, _as_obj(args[0]), _as_obj(args[1]),
                 _as_obj(args[2]))
    if name in _SHAPE_OPS:
      return self._shape_op(name, args, kw)
    if name in ("dot", "mv", "mm", "sum", "mean", "linalg_vector_norm",
                "cumsum"):
      return self._reduce(name, args, kw)
    if name in ("zeros", "empty", "_efficientzerotensor", "new_zeros", "ones",
                "new_ones", "full", "new_full", "zeros_like", "empty_like",
                "ones_like", "full_like", "scalar_tensor", "eye"):
      return self._make(name, args, kw)
    if name in _ALIASES:
      return args[0]
    if name in ("_to_copy", "to", "convert_element_type"):
      dtype = kw.get("dtype", args[1] if len(args) > 1 else None)
      if dtype is not None and dtype.is_floating_point:
        return _ew(d.to_float, args[0])
      return args[0]
    if name in ("is_same_size", "_has_same_storage_numel"):
      return True
    raise NotImplementedError(
        f"structural interpreter: no rule for {target} (op {name!r}); add "
        "one, or write the model with the supported ops")

  # ------------------------------------------------------------ interpreter

  def run(self, gm, *inputs):
    """Interpret graph module gm on object-array inputs (one per
    placeholder, in order); returns its output structure."""
    env = {}
    inputs = list(inputs)

    def read(a):
      if isinstance(a, torch.fx.Node):
        return env[a]
      if isinstance(a, (list, tuple)):
        return type(a)(read(v) for v in a)
      return a

    for node in gm.graph.nodes:
      if node.op == "placeholder":
        env[node] = inputs.pop(0)
      elif node.op == "get_attr":
        env[node] = const_array(getattr(gm, node.target))
      elif node.op == "call_function":
        if node.target is operator.getitem:
          env[node] = read(node.args[0])[node.args[1]]
          continue
        env[node] = self.call(node.target, read(node.args),
                              {k: read(v) for k, v in node.kwargs.items()})
      elif node.op == "output":
        return read(node.args[0])
      else:
        raise NotImplementedError(f"structural interpreter: node {node.op}")
    raise AssertionError("graph without output")


def _mutates(node):
  schema = getattr(node.target, "_schema", None)
  return node.op == "call_function" and bool(schema and schema.is_mutable)


def trace(fn, *example_args):
  """make_fx graph of fn at the example arguments' (logical) shapes; a
  graph with an in-place op is traced again functionalized (views then
  arrive as <view>_copy ops)."""
  gm = make_fx(fn)(*example_args)
  if any(_mutates(n) for n in gm.graph.nodes):
    gm = make_fx(torch.func.functionalize(
        fn, remove="mutations_and_views"))(*example_args)
  return gm


def _examples(shapes, seed=0):
  g = torch.Generator().manual_seed(seed)
  # nonzero, moderate values: tracing runs the real ops once
  return [0.5 + torch.rand(s, generator=g, dtype=torch.float64)
          for s in shapes]


def run_primal(dag, fn, shapes, inputs):
  """Trace fn(*args) at `shapes` and evaluate it on the object arrays
  `inputs` (one per argument, of those shapes)."""
  gm = trace(fn, *_examples(shapes))
  return Interpreter(dag).run(gm, *inputs)


def run_entry_taps(dag, fn, shapes, inputs, n, cols):
  """Jacobian-column taps of fn(*args, v) at v = 0.

  Traces torch.func.jvp of fn in v once, then evaluates the graph with v
  structurally zero and the tangent one-hot in each requested column.
  Returns (primal object array, {col: tangent object array})."""

  def wrapper(*all_args):
    args, v, t = all_args[:-2], all_args[-2], all_args[-1]
    return torch.func.jvp(lambda vv: fn(*args, vv), (v,), (t,))

  ex = _examples(list(shapes) + [(n,)])
  gm = trace(wrapper, *ex, torch.zeros(n, dtype=torch.float64))
  interp = Interpreter(dag)
  zvec = obj_array((n,))
  primal, taps = None, {}
  for k in cols:
    onehot = obj_array((n,))
    onehot[k] = 1.0
    primal, tangent = interp.run(gm, *inputs, zvec, onehot)
    taps[k] = tangent
  if primal is None:
    primal, _ = interp.run(gm, *inputs, zvec, zvec)
  return primal, taps
