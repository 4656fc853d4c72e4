"""Reverse mode over the emitter's expression DAG: the phases of kernel 10,
the adjoint scan of kernel 9 (the offline log scan, runtime/scan.py).

The JAX package differentiates its log scan (rednose_tpu/runtime/scan.py
scan_fn) with jax.grad: XLA's transpose of the lax.scan. The port's
forward on the card is kernel 9, whose arithmetic is the emitted DAGs of
entry_slab.predict_phase and entry_slab.update_phase (the factored
P + (V + V^T) predict, closed-form inverses, the factored Joseph form,
upper-triangle loads). Here those DAGs are differentiated node by node, so
the gradient is the one of the function the card computes; the forward
values the adjoint reads are recomputed in the same DAG (hash-consed, so a
forward node that the adjoint needs exists once).

`backward(dag, seeds, wanted)` walks the DAG's nodes in reverse
topological order (creation order), each node's adjoint the sum of its
consumers' contributions, and returns the adjoint of every wanted leaf.
Only nodes that depend on a wanted leaf take an adjoint (the others are
pruned), and ops of zero derivative (comparisons, logical ops, cast,
floor, ceil, sign) pass none. Each op's rule follows jax's: `where` sends
the adjoint to the taken branch only; max and min split a tie in half;
fmod and remainder follow jnp.fmod's and jnp.remainder's rules (the
divisor's adjoint -g trunc(a / b), plus g where remainder added b).

The adjoint phases (`predict_adjoint`, `update_adjoint`) seed the new
state's entries with the incoming cotangents, leaves of their own: `gx`
(the new x) and `gP` (the new P's upper entries; a full-matrix cotangent
G enters an upper entry (i, j), i < j, as G_ij + G_ji, and a diagonal one
as G_ii), and give, in the same convention, the cotangents of the step's
inputs: x, P's upper entries, dt and the params from the predict; x, P,
z, R's upper entries within the kind's block, ea and the params from the
update. The update is built with the forward's gate decision as an input
(`stored_gate`): the adjoint follows the branch the forward took, and the
decision recomputed from the same inputs is an output, so the kernel can
count the steps where the two differ. Q's cotangent is dense, dt times
the predicted P's cotangent on every entry (not only Q's pattern), and
the kernel's loop accumulates it (csrc/stream_adjoint.cuh).

`emit_source` prints the adjoint phases with entry_slab's printer as the
source of one variant (emitted mode "stream_adjoint") around
csrc/stream_adjoint.cuh; cotangents are written in place (the new x's
and P's over the incoming ones), each old value loaded before its store.
"""

from __future__ import annotations

import math

from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops import entry_slab
from rednose_tpu_torch.ops.structural import Expr

# ops whose derivative is zero wherever it exists: no adjoint passes
_FLAT = frozenset({"gt", "lt", "ge", "le", "eq", "ne", "and", "or", "not",
                   "cast", "floor", "ceil", "sign"})
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


def _unary_grad(d, name, x, y, g):
  """The adjoint of x for y = name(x) and y's adjoint g."""
  sq = d.mul(x, x)
  deriv = {
      "sin": lambda: d.unary("cos", x),
      "cos": lambda: d.neg(d.unary("sin", x)),
      "tan": lambda: d.add(1.0, d.mul(y, y)),
      "tanh": lambda: d.sub(1.0, d.mul(y, y)),
      "sinh": lambda: d.unary("cosh", x),
      "cosh": lambda: d.unary("sinh", x),
      "asin": lambda: d.unary("rsqrt", d.sub(1.0, sq)),
      "acos": lambda: d.neg(d.unary("rsqrt", d.sub(1.0, sq))),
      "atan": lambda: d.div(1.0, d.add(1.0, sq)),
      "asinh": lambda: d.unary("rsqrt", d.add(sq, 1.0)),
      "atanh": lambda: d.div(1.0, d.sub(1.0, sq)),
      "exp": lambda: y,
      "expm1": lambda: d.add(y, 1.0),
      "log": lambda: d.div(1.0, x),
      "log1p": lambda: d.div(1.0, d.add(1.0, x)),
      "abs": lambda: d.unary("sign", x),
      "sqrt": lambda: d.div(0.5, y),
      "rsqrt": lambda: d.mul(-0.5, d.div(y, x)),
      "erf": lambda: d.mul(_TWO_OVER_SQRT_PI, d.unary("exp", d.neg(sq))),
  }
  if name not in deriv:
    raise NotImplementedError(f"adjoint: no rule for op {name!r}")
  return d.mul(g, deriv[name]())


def _trunc(d, q):
  """trunc(q) = sign(q) floor(|q|), as jax's rem rule writes it."""
  return d.mul(d.unary("sign", q), d.unary("floor", d.unary("abs", q)))


def _contributions(d, e, g, want):
  """(arg, adjoint contribution) of each argument of node e that takes one
  (want(arg)), for e's adjoint g."""
  op, args = e.op, e.args
  out = []

  def give(i, fn):
    if want(args[i]):
      out.append((args[i], fn()))

  a = args[0]
  b = args[1] if len(args) > 1 else None
  if op == "add":
    give(0, lambda: g)
    give(1, lambda: g)
  elif op == "sub":
    give(0, lambda: g)
    give(1, lambda: d.neg(g))
  elif op == "neg":
    give(0, lambda: d.neg(g))
  elif op == "mul":
    give(0, lambda: d.mul(g, b))
    give(1, lambda: d.mul(g, a))
  elif op == "div":
    give(0, lambda: d.div(g, b))
    give(1, lambda: d.neg(d.mul(d.div(g, b), e)))
  elif op == "pow":
    give(0, lambda: d.mul(g, d.mul(b, d.pow(a, d.sub(b, 1.0)))))
    # jax: the exponent's adjoint is zero where the base is zero
    give(1, lambda: d.mul(g, d.where(d.binop("eq", a, 0.0), None,
                                     d.mul(e, d.unary("log", a)))))
  elif op in ("max", "min"):
    cmp = "gt" if op == "max" else "lt"
    half = d.mul(0.5, g)
    give(0, lambda: d.where(d.binop(cmp, a, b), g,
                            d.where(d.binop("eq", a, b), half, None)))
    give(1, lambda: d.where(d.binop(cmp, b, a), g,
                            d.where(d.binop("eq", a, b), half, None)))
  elif op == "atan2":
    den = d.add(d.mul(a, a), d.mul(b, b))
    give(0, lambda: d.div(d.mul(g, b), den))
    give(1, lambda: d.neg(d.div(d.mul(g, a), den)))
  elif op == "hypot":
    give(0, lambda: d.mul(g, d.div(a, e)))
    give(1, lambda: d.mul(g, d.div(b, e)))
  elif op == "fmod":
    give(0, lambda: g)
    give(1, lambda: d.neg(d.mul(g, _trunc(d, d.div(a, b)))))
  elif op == "remainder":
    def divisor():
      # jnp.remainder: fmod, plus b where the fmod's sign is not b's
      m = d.binop("fmod", a, b)
      plus = d.binop("and", d.binop("ne", m, 0.0),
                     d.binop("ne", d.binop("lt", b, 0.0),
                             d.binop("lt", m, 0.0)))
      return d.add(d.neg(d.mul(g, _trunc(d, d.div(a, b)))),
                   d.where(plus, g, None))
    give(0, lambda: g)
    give(1, divisor)
  elif op == "where":
    give(1, lambda: d.where(a, g, None))
    give(2, lambda: d.where(a, None, g))
  elif op in entry_slab._FUNCS or op in ("sqrt", "rsqrt"):
    give(0, lambda: _unary_grad(d, op, a, e, g))
  else:
    raise NotImplementedError(f"adjoint: no rule for op {op!r}")
  return out


def backward(dag, seeds, wanted) -> dict:
  """Reverse mode over dag: seeds [(root, its adjoint)], wanted(load args)
  picks the leaves whose adjoints are asked for. Returns {leaf args:
  adjoint} for each wanted leaf that a seeded root depends on (the adjoint
  None where it is structurally zero)."""
  nodes = list(dag.nodes)
  live = set()
  for e in nodes:
    if e.op == "load":
      if wanted(e.args):
        live.add(e.id)
    elif e.op not in _FLAT and any(isinstance(a, Expr) and a.id in live
                                   for a in e.args):
      live.add(e.id)

  def want(a):
    return isinstance(a, Expr) and a.id in live

  adj = {}
  for root, seed in seeds:
    if want(root) and seed is not None:
      adj[root.id] = dag.add(adj.get(root.id), seed)
  for e in reversed(nodes):
    g = adj.get(e.id)
    if g is None or e.op == "load":
      continue
    for a, c in _contributions(dag, e, g, want):
      adj[a.id] = dag.add(adj.get(a.id), c)
  return {e.args: adj.get(e.id) for e in nodes
          if e.op == "load" and e.id in live}


class AdjointPhase:
  """One emitted adjoint function: the DAG (the forward phase's, extended)
  and its stores in order, each (target, index, value); a target "gp" is
  accumulated (+=), every other written."""

  def __init__(self, dag):
    self.dag = dag
    self.stores = []


def _seeds(ph):
  d = ph.dag
  return ([(v, d.load("gx", (i,))) for i, v in enumerate(ph.x_out)]
          + [(v, d.load("gP", ij)) for ij, v in sorted(ph.p_out.items())])


def _state_stores(adj, de, dx):
  """The cotangents of the phase's input x and P, over the incoming ones:
  the new x's first, then P's upper entries."""
  return ([("lx", i, adj.get(("x", (i,)))) for i in range(dx)]
          + [("L", (i, j), adj.get(("P", (i, j))))
             for i in range(de) for j in range(i, de)])


def predict_adjoint(spec: FilterSpec, structure, pnames, q_pattern):
  """The adjoint of entry_slab.predict_phase: from the cotangents of the
  predicted x and P (leaves gx, gP) those of the previous x and P (over
  them), dt's (written) and the params' (accumulated). Q's cotangent is
  the kernel loop's (dt times the incoming P cotangent, dense)."""
  ph = entry_slab.predict_phase(spec, structure, pnames, q_pattern)
  adj = backward(ph.dag, _seeds(ph),
                 lambda a: a[0] in ("x", "P", "dt", "p"))
  out = AdjointPhase(ph.dag)
  out.stores = ([("gdt", (), adj.get(("dt", ())))]
                + [("gp", k, adj.get(("p", (k,))))
                   for k in range(len(pnames))]
                + _state_stores(adj, spec.dim_err, spec.dim_x))
  return out


def update_adjoint(spec: FilterSpec, kind: int, structure, pnames,
                   gate: bool):
  """The adjoint of entry_slab.update_phase of `kind`, gated on the
  forward's decision (the leaf rej) where the kind gates: the cotangents
  of the predicted x and P (over the incoming ones), of z and ea
  (written), of R's upper entries within the kind's dz x dz block
  (written) and of the params (accumulated); and, for a gated kind, the
  decision recomputed from the inputs (target rec)."""
  om = spec.obs[kind]
  ph = entry_slab.update_phase(spec, kind, structure, pnames, gate,
                               stored_gate=True)
  adj = backward(ph.dag, _seeds(ph),
                 lambda a: a[0] in ("x", "P", "z", "R", "ea", "p"))
  out = AdjointPhase(ph.dag)
  out.stores = ([("gz", r, adj.get(("z", (r,)))) for r in range(om.dz)]
                + [("gea", k, adj.get(("ea", (k,))))
                   for k in range(om.ea_len)]
                + [("gR", (r, q), adj.get(("R", (r, q))))
                   for r in range(om.dz) for q in range(r, om.dz)]
                + [("gp", k, adj.get(("p", (k,))))
                   for k in range(len(pnames))]
                + ([("rec", (), ph.gate)] if ph.gate is not None else [])
                + _state_stores(adj, spec.dim_err, spec.dim_x))
  return out


# ------------------------------------------------------------------ printing

class _AdjointPrinter(entry_slab._Printer):
  """entry_slab's SSA printer, reading the incoming cotangents (gx from
  lx, gP through GEN_L) and the forward's gate decision rej."""

  def _load(self, a):
    if a[0] == "gx":
      return f"lx[{a[1][0]}]"
    if a[0] == "gP":
      return f"GEN_L({a[1][0]}, {a[1][1]})"
    if a[0] == "rej":
      return "rej"
    return super()._load(a)


def _store_text(target, idx, val):
  if target == "lx":
    return f"  lx[{idx}] = {val};"
  if target == "L":
    return f"  GEN_L({idx[0]}, {idx[1]}) = {val};"
  if target == "gz":
    return f"  gz[(size_t){idx} * ld_in] = {val};"
  if target == "gea":
    return f"  gea[(size_t){idx} * ld_in] = {val};"
  if target == "gR":
    return f"  gR[(size_t)({idx[0]} * NZROWS + {idx[1]}) * ldg] = {val};"
  if target == "gp":
    return f"  gp[(size_t){idx} * ldg] += {val};"
  if target == "gdt":
    return f"  *gdt = {val};"
  if target == "rec":
    return f"  *rec = {val};"
  raise AssertionError(target)


def print_adjoint(ph: AdjointPhase, dz: int) -> list:
  """Statements of one adjoint phase: SSA definitions in dependency order,
  each store as soon as its value exists; a store over an incoming
  cotangent (lx, GEN_L) first loads the old value if the DAG reads it, so
  every later expression reads the value from before the store."""
  pr = _AdjointPrinter(dz)
  incoming = {("lx", e.args[1][0]) if e.args[0] == "gx"
              else ("L", e.args[1]): e
              for e in ph.dag.nodes
              if e.op == "load" and e.args[0] in ("gx", "gP")}
  for target, idx, v in ph.stores:
    if target == "gp" and v is None:
      continue
    pr.emit(v)
    old = incoming.get((target, idx))
    if old is not None:
      pr.emit(old)
    pr.lines.append(_store_text(target, idx, pr.ref(v)))
  return pr.lines


P_PREDICT = ["const scalar_t* x", "const scalar_t* P", "size_t ld",
             "const scalar_t dt", "const scalar_t* p", "const scalar_t* Q",
             "scalar_t* lx", "scalar_t* L", "size_t ldl", "scalar_t* gdt",
             "scalar_t* gp", "size_t ldg"]
P_UPDATE = ["const scalar_t* x", "const scalar_t* P", "size_t ld",
            "const scalar_t* z", "const scalar_t* ea", "size_t ld_in",
            "const scalar_t* R", "const scalar_t* p", "const bool rej",
            "scalar_t* lx", "scalar_t* L", "size_t ldl", "scalar_t* gz",
            "scalar_t* gea", "scalar_t* gR", "scalar_t* gp", "size_t ldg",
            "bool* rec"]


def emit_source(spec: FilterSpec, units, structure, pnames, q_pattern=(),
                scalar="float") -> str:
  """C++ source of kernel 10's variant for a log of units ((kind, gate)
  pairs, kernel 9's 'stream' units): gen_adj_predict, one
  gen_adj_update_k<kind>[_g] a unit and the switch gen_adj_update over
  them by the step's kind index, then csrc/stream_adjoint.cuh (the loop
  over t = T-1 ... 0, the kernel and its entry points). Every phase is a
  call of its own on the card (GEN_PHASE)."""
  if scalar not in ("float", "double"):
    raise ValueError(f"scalar {scalar!r} is not 'float' or 'double'")
  kinds = [k for k, _ in units]
  if any(spec.obs[k].is_feature for k in kinds):
    raise ValueError("mode 'stream_adjoint' takes no MSCKF feature kind")
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  out = [
      "// Generated by rednose_tpu_torch/ops/adjoint.py: do not edit.",
      f"// spec {spec.name!r}, mode stream_adjoint, units (kind, gate) "
      f"{list(units)},",
      f"// params {list(pnames)}.",
      "// design: global: one thread a lane, the cotangent of P in global "
      "memory; each step's update and predict recomputed from the forward's "
      "stacks",
      f"#define REDNOSE_SCALAR {scalar}",
      '#include "generic_scan.cuh"',
      "",
      "namespace rn_gen {",
      "",
      f"constexpr int DX = {spec.dim_x};",
      f"constexpr int DE = {spec.dim_err};",
      f"constexpr int NP = {len(pnames)};",
      f"constexpr int NZROWS = {max_dz};",
      f"constexpr int NEAROWS = {max_ea};",
      "",
      "#define GEN_P(i, j) P[(size_t)((i) * DE + (j)) * ld]",
      "#define GEN_L(i, j) L[(size_t)((i) * DE + (j)) * ldl]",
      "",
  ]
  out += entry_slab._function("gen_adj_predict", P_PREDICT, print_adjoint(
      predict_adjoint(spec, structure, pnames, q_pattern), 0), "GEN_PHASE")
  names = []
  for k, g in units:
    name = f"gen_adj_update_k{k}{'_g' if g else ''}"
    if name not in names:
      out += [""] + entry_slab._function(name, P_UPDATE, print_adjoint(
          update_adjoint(spec, k, structure, pnames, g), max_dz), "GEN_PHASE")
    names.append(name)
  args = ", ".join(entry_slab._args(P_UPDATE))
  out += ["", "GEN_HD GEN_INLINE void gen_adj_update(int ki, "
          f"{', '.join(P_UPDATE)}) {{", "  switch (ki) {"]
  out += [f"    case {u}: {n}({args}); break;" for u, n in enumerate(names)]
  out += ["    default: break;", "  }", "}", "", "}  // namespace rn_gen", "",
          "#define REDNOSE_GENERIC_STREAM_ADJOINT",
          '#include "stream_adjoint.cuh"', ""]
  return "\n".join(out)
