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
csrc/stream_adjoint.cuh: in tile form (TilePlan, below: each phase's
shared values in stages split across the warps of a shared-memory tile)
where the tile fits a block, else in the global form, one function a
phase whose cotangents are written in place (the new x's and P's over
the incoming ones), each old value loaded before its store.
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
                   gate: bool, seed_y: bool = False):
  """The adjoint of entry_slab.update_phase of `kind`, gated on the
  forward's decision (the leaf rej) where the kind gates: the cotangents
  of the predicted x and P (over the incoming ones), of z and ea
  (written), of R's upper entries within the kind's dz x dz block
  (written) and of the params (accumulated); and, for a gated kind, the
  decision recomputed from the inputs (target rec). seed_y (kernel 10's
  lane form, the adjoint of runtime/bank.run_bank): the innovations
  y = z - h(x) take the incoming cotangent gy (leaves gy) as seeds too."""
  om = spec.obs[kind]
  ph = entry_slab.update_phase(spec, kind, structure, pnames, gate,
                               stored_gate=True)
  seeds = _seeds(ph)
  if seed_y:
    seeds += [(v, ph.dag.load("gy", (r,))) for r, v in enumerate(ph.y)]
  adj = backward(ph.dag, seeds,
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
  lx, gP through GEN_L, the lane form's gy through GEN_GY) and the
  forward's gate decision rej."""

  def _load(self, a):
    if a[0] == "gx":
      return f"lx[{a[1][0]}]"
    if a[0] == "gP":
      return f"GEN_L({a[1][0]}, {a[1][1]})"
    if a[0] == "gy":
      return f"GEN_GY({a[1][0]})"
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


def print_adjoint(ph: AdjointPhase, dz: int, lane: bool = False) -> list:
  """Statements of one adjoint phase: SSA definitions in dependency order,
  each store as soon as its value exists; a store over an incoming
  cotangent (lx, GEN_L) first loads the old value if the DAG reads it, so
  every later expression reads the value from before the store. lane: R
  read by lane (entry_slab._Printer's lane_r)."""
  pr = _AdjointPrinter(dz, lane_r=lane)
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
# kernel 10's lane form (R and the innovations' cotangent gy by lane)
P_UPDATE_LANE = (P_UPDATE[:7] + ["size_t ld_r"] + P_UPDATE[7:9]
                 + ["const scalar_t* gy"] + P_UPDATE[9:])

# ------------------------------------------------------------ the tile form
# Kernel 10 in tile form (csrc/stream_adjoint.cuh, REDNOSE_ADJOINT_TILE): a
# block of 32 lanes x W warps keeps L (P's cotangent, upper entries), Q's
# cotangent, lx, the stacked state each phase recomputes from and a scratch
# in shared memory, and runs each adjoint phase in stages. A phase's cut
# values are the nodes of its DAG that more than one node (or store)
# reads; every other node has one reader, so it lies in the cone of
# exactly one cut value or store. A cut value's level is the number of cut
# values on its longest path from the inputs, and stage g computes the cut
# values of level g: each warp its share, whole cones, largest first, each
# to the warp whose work ends least with it, stored into the scratch as it
# goes; then a barrier. The cones are disjoint, so no warp repeats
# another's work, and the reductions over L that feed the update's heavy
# outputs (its gains' and Joseph factors' cotangents, then S's and HP's)
# and the predict's products of L with F and P are cut values, computed
# across the warps. The outputs come last: every warp computes its share
# from the scratch into registers, barrier, stores it (adding the next
# incoming cotangent), barrier. A store or cut value whose private cone
# exceeds SPLIT_CONE nodes and is one long sum (the predict's dt
# cotangent, ~230 terms) is summed in pieces of ~SPLIT_PIECE nodes, each a
# cut value of its own, then added up: another rounding order than the
# global form's, the only one.

SPLIT_CONE = 64      # a private cone above which a sum is split
SPLIT_PIECE = 32     # nodes a piece of a split sum, about


def _is_load(v, name, idx):
  return isinstance(v, Expr) and v.op == "load" and v.args == (name, idx)


class _Graph:
  """The computed nodes that roots reach, where a node of `sub` (id ->
  Expr) reads its replacement instead of its own arguments (a sum summed
  in pieces): `args(e)`, `nodes` in an order where every node follows
  what it reads, and `readers`, the number of distinct nodes and roots
  that read each id."""

  def __init__(self, roots, sub=None):
    self.sub = sub or {}
    seen, self.nodes = set(), []
    for r in roots:
      if not isinstance(r, Expr) or r.op == "load" or r.id in seen:
        continue
      stack = [(r, False)]
      while stack:
        e, done = stack.pop()
        if done:
          self.nodes.append(e)
          continue
        if e.id in seen:
          continue
        seen.add(e.id)
        stack.append((e, True))
        stack.extend((a, False) for a in self.args(e)
                     if isinstance(a, Expr) and a.op != "load"
                     and a.id not in seen)
    self.readers = {}
    for e in self.nodes:
      for a in {x.id for x in self.args(e) if isinstance(x, Expr)}:
        self.readers[a] = self.readers.get(a, 0) + 1
    for v in roots:
      if isinstance(v, Expr):
        self.readers[v.id] = self.readers.get(v.id, 0) + 1

  def args(self, e):
    return (self.sub[e.id],) if e.id in self.sub else e.args

  def cone(self, v, cut):
    """v (unless a load or a constant) and the nodes it needs up to the
    cut ids: the nodes a warp computes for it."""
    if not isinstance(v, Expr) or v.op == "load":
      return set()
    out, stack = {v.id}, list(self.args(v))
    while stack:
      e = stack.pop()
      if (not isinstance(e, Expr) or e.op == "load" or e.id in cut
          or e.id in out):
        continue
      out.add(e.id)
      stack.extend(self.args(e))
    return out


def _split_sum(dag, v, private, n):
  """v, a sum whose left spine of adds is private (read once), as the sum
  of n partial sums of its terms, in order: (the new root, the partial
  sums that need computing)."""
  terms, e = [], v
  while isinstance(e, Expr) and e.op == "add" and (e is v or e.id in private):
    terms.append(e.args[1])
    e = e.args[0]
  terms.append(e)
  terms.reverse()
  size = -(-len(terms) // n)
  parts = [entry_slab._lsum(dag, terms[i:i + size])
           for i in range(0, len(terms), size)]
  return entry_slab._lsum(dag, parts), [
      p for p in parts if isinstance(p, Expr) and p.op != "load"]


def _lpt(items, n_roles, cones):
  """Items (value, payload) to n_roles roles, largest cone first (cones:
  the node ids of each value's cone), each to the role whose work (the
  nodes of its cones) ends least with it, ties to the role with fewer
  items: (the payloads of each role in item order, each role's node
  count)."""
  roles = [[] for _ in range(n_roles)]
  work = [set() for _ in range(n_roles)]
  for k in sorted(range(len(items)), key=lambda k: -len(cones[k])):
    r = min(range(n_roles), key=lambda r: (len(work[r] | cones[k]),
                                           len(roles[r]), r))
    roles[r].append(k)
    work[r] |= cones[k]
  return [[items[k][1] for k in sorted(rl)] for rl in roles], \
      [len(w) for w in work]


_STATE_ORDER = {"lx": 0, "L": 1}


class TilePlan:
  """One adjoint phase's outputs in tile form over n_roles warps:
  `stages[g][r]` the cut values role r computes into the scratch in stage
  g; `slots` (node id -> scratch slot, a slot reused once no later stage
  reads its value); `nscr`, the slots; `roles[r]` the outputs role r
  computes after the last stage, (target, index, value); `unchanged[r]`
  the state entries (target, index) that keep their incoming cotangent,
  to which role r adds the next one; `alias` (node id -> Expr), the cut
  values summed in pieces, each computed as its replacement; `work`, the
  largest role's node count of each stage and of the outputs; `nodes`,
  the phase's computed nodes."""

  def __init__(self, dag, outputs, n_roles):
    same = [(t, i) for t, i, v in outputs
            if (t == "lx" and _is_load(v, "gx", (i,)))
            or (t == "L" and _is_load(v, "gP", i))]
    kept = set(same)
    outs = [o for o in outputs if (o[0], o[1]) not in kept]
    gr = _Graph([v for _, _, v in outs])
    cut = {i for i, n in gr.readers.items() if n > 1}
    # a sum whose private cone is larger than SPLIT_CONE nodes (a store's
    # or a cut value's), summed in pieces that are cut values of their own
    forced, self.alias = set(), {}
    for e in gr.nodes + [v for _, _, v in outs]:
      if (not isinstance(e, Expr) or e.op != "add" or e.id in self.alias
          or (e.id not in cut and gr.readers.get(e.id, 0) > 0
              and not any(v is e for _, _, v in outs))):
        continue
      cone = gr.cone(e, cut)
      if len(cone) <= SPLIT_CONE:
        continue
      root, parts = _split_sum(dag, e, cone - {e.id}, min(
          n_roles, -(-len(cone) // SPLIT_PIECE)))
      forced |= {p.id for p in parts}
      if e.id in cut:
        self.alias[e.id] = root
      else:
        outs = [(t, i, root if v is e else v) for t, i, v in outs]
    roots = [v for _, _, v in outs]
    gr = _Graph(roots, self.alias)
    nodes = gr.nodes
    ids = {e.id for e in nodes}
    cut = ({i for i, n in gr.readers.items() if n > 1} | forced
           | set(self.alias)) & ids
    level = {}
    for e in nodes:
      level[e.id] = max([level[a.id] + (a.id in cut) for a in gr.args(e)
                         if isinstance(a, Expr) and a.op != "load"] + [0])
    nst = 1 + max((level[i] for i in cut), default=-1)
    # the stage each node is computed in (a private node in its reader's)
    # and the last stage that reads each cut value (nst: the outputs)
    home, last = {}, {}
    for v in roots:
      if isinstance(v, Expr):
        home.setdefault(v.id, nst)
        if v.id in cut:
          last[v.id] = nst
    for e in reversed(nodes):
      at = level[e.id] if e.id in cut else home[e.id]
      home[e.id] = at
      for a in gr.args(e):
        if isinstance(a, Expr) and a.op != "load":
          if a.id in cut:
            last[a.id] = max(last.get(a.id, 0), at)
          else:
            home[a.id] = at
    byid = {e.id: e for e in nodes}
    self.stages, self.slots, self.work, held = [], {}, [], []
    for g in range(nst):
      vals = [byid[i] for i in sorted(cut) if level[i] == g]
      roles, work = _lpt([(e, e) for e in vals], n_roles,
                         [gr.cone(e, cut) for e in vals])
      for e in vals:
        k = next((k for k, h in enumerate(held) if h < g), len(held))
        if k == len(held):
          held.append(0)
        held[k] = last.get(e.id, g)
        self.slots[e.id] = k
      self.stages.append(roles)
      self.work.append(max(work))
    self.nscr = len(held)
    self.roles, work = _lpt([(v, o) for o in outs for v in (o[2],)],
                            n_roles, [gr.cone(v, cut) for _, _, v in outs])
    self.work.append(max(work))
    self.unchanged = [[] for _ in range(n_roles)]
    for t, i in sorted(same, key=lambda ti: (_STATE_ORDER[ti[0]], ti[1])):
      r = min(range(n_roles), key=lambda r: (
          len(self.roles[r]) + len(self.unchanged[r]), r))
      self.unchanged[r].append((t, i))
    self.nodes = len(nodes)


def tile_outputs(ph: AdjointPhase, nzrows=0, nearows=0, dz=None,
                 ea_len=0) -> list:
  """A phase's stores as the tile takes them: a params cotangent that is
  structurally zero left out; for an update (dz given) zeros on the
  padded rows of z and ea and on R's entries outside the kind's upper
  dz x dz block, which the global form clears before each step."""
  outs = [(t, i, v) for t, i, v in ph.stores
          if not (t == "gp" and v is None)]
  if dz is not None:
    outs += ([("gz", r, None) for r in range(dz, nzrows)]
             + [("gea", k, None) for k in range(ea_len, nearows)]
             + [("gR", (r, q), None) for r in range(nzrows)
                for q in range(nzrows) if not r <= q < dz])
  return outs


class _TilePrinter(entry_slab._Printer):
  """The SSA printer of the tile: x, P, lx and L from the tile (GEN_X,
  GEN_P, GEN_LX, GEN_L), a cut value of an earlier stage from its scratch
  slot (GEN_S)."""

  def __init__(self, dz, slots, alias=None):
    super().__init__(dz, True, slots)
    self.alias = alias or {}

  def emit(self, root):
    """As the SSA printer's, but a cut value summed in pieces (alias) is
    printed as its replacement."""
    if (isinstance(root, Expr) and root.id in self.alias
        and root.id not in self.names and root.id not in self.slots):
      super().emit(self.alias[root.id])
      self.names[root.id] = self.ref(self.alias[root.id])
      return
    super().emit(root)

  def _load(self, a):
    if a[0] == "gx":
      return f"GEN_LX({a[1][0]})"
    if a[0] == "gP":
      return f"GEN_L({a[1][0]}, {a[1][1]})"
    if a[0] == "rej":
      return "rej"
    return super()._load(a)


T_IN = ["const scalar_t* x", "const scalar_t* P", "size_t ld",
        "const scalar_t dt", "const scalar_t* p", "const scalar_t* Q",
        "const scalar_t* z", "const scalar_t* ea", "size_t ld_in",
        "const scalar_t* R", "const bool rej", "const scalar_t* L",
        "const scalar_t* lx"]
T_STAGE = T_IN + ["scalar_t* s"]
T_FINAL = T_IN + ["const scalar_t* s", "scalar_t* v"]
T_STORE = ["scalar_t* L", "scalar_t* lx", "scalar_t* gQ", "size_t ld",
           "const scalar_t* v", "const scalar_t* gPin",
           "const scalar_t* gxin", "size_t ldg", "const scalar_t dt",
           "scalar_t* gz", "scalar_t* gea", "scalar_t* gR", "scalar_t* gp",
           "scalar_t* gdt", "int* nflip", "const bool rej",
           "const bool live"]


def _incoming(t, i):
  """The next incoming cotangent of a state entry (target t, index i)."""
  if t == "lx":
    return f"rn_gx(gxin, {i}, ldg)"
  return f"rn_gin(gPin, {i[0]}, {i[1]}, ldg)"


def _tile_store(t, i, k, c, update):
  """The store pass's line for output k of a role's (target t, index i;
  c names the next incoming cotangent of a state entry, loaded above):
  the state's cotangents with the next incoming one added (and, after the
  update, Q's cotangent accumulated), the others to the global outputs
  of a lane in the bank (live)."""
  if t == "L":
    if update:
      return (f"  {{ const scalar_t n = v[{k}] + {c}; GEN_L({i[0]}, {i[1]}) "
              f"= n; GEN_GQ({i[0]}, {i[1]}) += dt * n; }}")
    return f"  GEN_L({i[0]}, {i[1]}) = v[{k}] + {c};"
  if t == "lx":
    return f"  GEN_LX({i}) = v[{k}] + {c};"
  if t == "rec":
    return f"  *nflip += (v[{k}] != (scalar_t)0) != rej;"
  if t == "gp":
    return f"  if (live) gp[(size_t){i} * ldg] += v[{k}];"
  dst = {"gz": f"gz[(size_t){i} * ldg]", "gea": f"gea[(size_t){i} * ldg]",
         "gdt": "*gdt"}.get(t)
  if t == "gR":
    dst = f"gR[(size_t)({i[0]} * NZROWS + {i[1]}) * ldg]"
  return f"  if (live) {dst} = v[{k}];"


def _tile_enter(t, i, c, update):
  """The store pass's line for a state entry that keeps its cotangent:
  the next incoming one (c, loaded above) added (and Q's cotangent
  accumulated)."""
  if t == "lx":
    return f"  GEN_LX({i}) += {c};"
  if update:
    return (f"  {{ const scalar_t n = GEN_L({i[0]}, {i[1]}) + {c}; "
            f"GEN_L({i[0]}, {i[1]}) = n; GEN_GQ({i[0]}, {i[1]}) += dt * n; }}")
  return f"  GEN_L({i[0]}, {i[1]}) += {c};"


def _store_lines(outs, unchanged, update):
  """A role's store pass: every next incoming cotangent it adds loaded
  first (global loads, independent, so they are in flight together; a
  load after a store to the tile could not pass it), then the stores."""
  state = [(t, i) for t, i, _ in outs if t in ("L", "lx")] + list(unchanged)
  name = {ti: f"c{n}" for n, ti in enumerate(state)}
  lines = [f"  const scalar_t {name[ti]} = {_incoming(*ti)};" for ti in state]
  lines += [_tile_store(t, i, k, name.get((t, i)), update)
            for k, (t, i, _) in enumerate(outs)]
  return lines + [_tile_enter(t, i, name[(t, i)], update)
                  for t, i in unchanged]


def _tile_phase(name, plan, dz, update, n_roles):
  """The functions of one phase in tile form: each stage's role functions
  name_s{g}_r{r} (its cut values into the scratch), each role's outputs
  name_f_r{r} (into v) and store name_w_r{r}; the dispatchers
  name_stage(g, r, ...), name_final(r, ...) and name_store(r, ...); and
  the stage count name_NSTAGES."""
  out = []
  earlier = {}
  for g, roles in enumerate(plan.stages):
    for r, vals in enumerate(roles):
      pr = _TilePrinter(dz, earlier, plan.alias)
      for e in vals:
        pr.emit(e)
        pr.lines.append(f"  GEN_S({plan.slots[e.id]}) = {pr.ref(e)};")
      out += ["", *entry_slab._function(f"{name}_s{g}_r{r}", T_STAGE,
                                        pr.lines)]
    earlier |= {e.id: plan.slots[e.id] for vals in roles for e in vals}
  for r, outs in enumerate(plan.roles):
    pr = _TilePrinter(dz, earlier)
    for _, _, v in outs:
      pr.emit(v)
    pr.lines += [f"  v[{k}] = {pr.ref(v)};" for k, (_, _, v) in
                 enumerate(outs)]
    out += ["", *entry_slab._function(f"{name}_f_r{r}", T_FINAL, pr.lines)]
    out += ["", *entry_slab._function(
        f"{name}_w_r{r}", T_STORE,
        _store_lines(outs, plan.unchanged[r], update))]
  args = ", ".join(entry_slab._args(T_STAGE))
  cases = [f"    case {g}: switch (r) {{ " + " ".join(
      f"case {r}: {name}_s{g}_r{r}({args}); break;"
      for r in range(n_roles)) + " default: break; } break;"
      for g in range(len(plan.stages))]
  out += ["", f"GEN_HD GEN_INLINE void {name}_stage(int g, int r, "
          f"{', '.join(T_STAGE)}) {{", "  switch (g) {", *cases,
          "    default: break;", "  }", "}"]
  out += entry_slab._dispatch(f"{name}_final", T_FINAL,
                              lambda r: f"{name}_f_r{r}", n_roles)
  out += entry_slab._dispatch(f"{name}_store", T_STORE,
                              lambda r: f"{name}_w_r{r}", n_roles)
  out.append(f"constexpr int {name}_NSTAGES = {len(plan.stages)};")
  return out


def _plan_note(name, plan):
  """The header lines of a phase's plan: its stages, each stage's cut
  values a warp and the largest warp's nodes, and the outputs'."""
  per = [f"[{', '.join(str(len(r)) for r in roles)}] {w}"
         for roles, w in zip(plan.stages, plan.work)]
  out = [f"//   {name}: {plan.nodes:,} nodes, {len(plan.stages)} stages, "
         f"{plan.nscr} scratch slots, the largest warp's nodes a step "
         f"{sum(plan.work):,}; a stage's cut values a warp, and the "
         "largest warp's nodes:"]
  for k in range(0, len(per), 4):
    out.append("//     " + "; ".join(
        f"s{g} {p}" for g, p in enumerate(per[k:k + 4], k)))
  out.append(f"//     outputs [{', '.join(str(len(r)) for r in plan.roles)}"
             f"] {plan.work[-1]}, entries that keep their cotangent "
             f"[{', '.join(str(len(u)) for u in plan.unchanged)}]")
  return out


def emit_source(spec: FilterSpec, units, structure, pnames, q_pattern=(),
                scalar="float", tile=True, lane=False) -> str:
  """C++ source of kernel 10's variant for a log of units ((kind, gate)
  pairs, kernel 9's 'stream' units), around csrc/stream_adjoint.cuh (the
  loop over t = T-1 ... 0, the kernel and its entry points).

  The tile form, where its tile fits a block (entry_slab.adjoint_tile_bytes
  at TILE_ROLES_ADJOINT warps): each phase's TilePlan printed by
  _tile_phase (gen_adjt_predict, one gen_adjt_update_k<kind>[_g] a unit)
  and the switches over the units by the step's kind index. The global
  form (tile=False, or a tile that does not fit): gen_adj_predict, one
  gen_adj_update_k<kind>[_g] a unit and the switch gen_adj_update over
  them, every phase a call of its own on the card (GEN_PHASE). lane (the
  lane form, the backward of runtime/bank.run_bank): the global form with
  R read by lane (R[k * ld_r]) and each update's innovations seeded with
  their cotangent gy (GEN_GY, a lane's row of gys, or 0 where the
  launcher passes none)."""
  if scalar not in ("float", "double"):
    raise ValueError(f"scalar {scalar!r} is not 'float' or 'double'")
  kinds = [k for k, _ in units]
  if any(spec.obs[k].is_feature for k in kinds):
    raise ValueError("mode 'stream_adjoint' takes no MSCKF feature kind")
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  names = [f"gen_adj_update_k{k}{'_g' if g else ''}" for k, g in units]
  head = [
      "// Generated by rednose_tpu_torch/ops/adjoint.py: do not edit.",
      f"// spec {spec.name!r}, mode stream_adjoint, units (kind, gate) "
      f"{list(units)},",
      f"// params {list(pnames)}.",
  ]
  body = [
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
  ]
  stored = ("one thread a lane, the cotangent of P in global memory; each "
            "step's update and predict recomputed from the forward's stacks")
  pred = predict_adjoint(spec, structure, pnames, q_pattern)
  upds = {}
  for (k, g), name in zip(units, names):
    if name not in upds:
      upds[name] = (update_adjoint(spec, k, structure, pnames, g, lane),
                    spec.obs[k])
  if lane:
    head.append("// design: global (lane form: R and the innovations' "
                f"cotangent by lane): {stored}")
  elif not tile:
    head.append(f"// design: global: {stored}")
  else:
    w = entry_slab.TILE_ROLES_ADJOINT
    plans = {"gen_adjt_predict": (TilePlan(pred.dag, tile_outputs(pred), w),
                                  False)}
    for name, (ph, om) in upds.items():
      plans[name.replace("gen_adj_", "gen_adjt_")] = (TilePlan(
          ph.dag, tile_outputs(ph, max_dz, max_ea, om.dz, om.ea_len), w),
          True)
    nscr = max(pl.nscr for pl, _ in plans.values())
    nbytes = entry_slab.adjoint_tile_bytes(spec, nscr, max_dz, max_ea,
                                           scalar)
    if nbytes <= entry_slab.TILE_SMEM_MAX:
      return "\n".join(head + _adjoint_tile_source(
          body, plans, names, max_dz, nscr, nbytes, w))
    head.append(
        f"// design: global: the tile of {entry_slab.TILE_LANES} lanes "
        f"({nbytes:,} B in {scalar}) exceeds the "
        f"{entry_slab.TILE_SMEM_MAX:,} B a block may use, so {stored}")
  p_update = P_UPDATE_LANE if lane else P_UPDATE
  out = head + body + [
      "#define GEN_P(i, j) P[(size_t)((i) * DE + (j)) * ld]",
      "#define GEN_L(i, j) L[(size_t)((i) * DE + (j)) * ldl]",
  ] + (["#define GEN_GY(r) (gy == nullptr ? (scalar_t)0 "
        ": gy[(size_t)(r) * ld_in])"] if lane else []) + [""]
  out += entry_slab._function("gen_adj_predict", P_PREDICT, print_adjoint(
      pred, 0), "GEN_PHASE")
  for name, (ph, _) in upds.items():
    out += [""] + entry_slab._function(name, p_update, print_adjoint(
        ph, max_dz, lane), "GEN_PHASE")
  args = ", ".join(entry_slab._args(p_update))
  out += ["", "GEN_HD GEN_INLINE void gen_adj_update(int ki, "
          f"{', '.join(p_update)}) {{", "  switch (ki) {"]
  out += [f"    case {u}: {n}({args}); break;" for u, n in enumerate(names)]
  out += ["    default: break;", "  }", "}", "", "}  // namespace rn_gen", "",
          "#define REDNOSE_GENERIC_STREAM_ADJOINT"]
  if lane:
    out.append("#define REDNOSE_STREAM_ADJOINT_LANE")
  out += ['#include "stream_adjoint.cuh"', ""]
  return "\n".join(out)


def _adjoint_tile_source(body, plans, names, max_dz, nscr, nbytes, n_roles):
  """The lines after the header of a variant in tile form: the design
  line and each phase's plan, the tile's macros and constants, each
  phase's functions (_tile_phase) and the switches over the units by the
  step's kind index."""
  nval = max(len(r) for pl, _ in plans.values() for r in pl.roles)
  upd = [n.replace("gen_adj_", "gen_adjt_") for n in names]
  out = [f"// design: tile, {n_roles} roles, {len(names)} units switched on "
         f"the step's kind: a block of {entry_slab.TILE_LANES} lanes x "
         f"{n_roles} warps keeps L and Q's cotangent (upper entries), lx, "
         "each phase's stacked state and "
         f"{nscr} scratch values a lane in shared memory ({nbytes:,} B a "
         "block); each phase's cut values in stages split across the "
         "warps, the next phase's state staged during this one"]
  for name, (pl, _) in plans.items():
    out += _plan_note(name, pl)
  out += body + [
      "#define RN_UP(i, j) ((i) * DE - (i) * ((i) - 1) / 2 + (j) - (i))",
      "#define GEN_P(i, j) P[(size_t)RN_UP(i, j) * ld]",
      "#define GEN_L(i, j) L[(size_t)RN_UP(i, j) * ld]",
      "#define GEN_GQ(i, j) gQ[(size_t)RN_UP(i, j) * ld]",
      "#define GEN_X(i) x[(size_t)(i) * ld]",
      "#define GEN_LX(i) lx[(size_t)(i) * ld]",
      "#define GEN_S(k) s[(size_t)(k) * ld]",
      f"constexpr int NROLES = {n_roles};",
      f"constexpr int NSCR = {nscr};",
      f"constexpr int NVAL = {nval};",
      "",
      "// the next incoming cotangent of an upper entry (i, j) of L, of a "
      "lane with",
      "// stride ld (a full matrix's G_ij + G_ji; none from a null one)",
      "GEN_HD GEN_INLINE scalar_t rn_gin(const scalar_t* g, int i, int j, "
      "size_t ld) {",
      "  if (g == nullptr) return (scalar_t)0;",
      "  return i == j ? g[(size_t)(i * DE + i) * ld]",
      "                : g[(size_t)(i * DE + j) * ld] + "
      "g[(size_t)(j * DE + i) * ld];",
      "}",
      "GEN_HD GEN_INLINE scalar_t rn_gx(const scalar_t* g, int i, size_t ld) "
      "{",
      "  return g == nullptr ? (scalar_t)0 : g[(size_t)i * ld];",
      "}",
  ]
  for name, (pl, update) in plans.items():
    out += ["", f"// {name}"] + _tile_phase(name, pl, max_dz if update else 0,
                                            update, n_roles)

  out += ["", "GEN_HD GEN_INLINE int gen_adjt_update_nstages(int ki) {",
          "  switch (ki) {",
          *[f"    case {u}: return {n}_NSTAGES;" for u, n in enumerate(upd)],
          "    default: return 0;", "  }", "}"]
  for fn, params, lead in (("stage", T_STAGE, "g, r"),
                           ("final", T_FINAL, "r"), ("store", T_STORE, "r")):
    decl = ", ".join(f"int {a}" for a in lead.split(", "))
    args = ", ".join(entry_slab._args(params))
    out += ["", f"GEN_HD GEN_INLINE void gen_adjt_update_{fn}(int ki, {decl}, "
            f"{', '.join(params)}) {{", "  switch (ki) {",
            *[f"    case {u}: {n}_{fn}({lead}, {args}); break;"
              for u, n in enumerate(upd)], "    default: break;", "  }", "}"]
  out += ["", "}  // namespace rn_gen", "",
          "#define REDNOSE_GENERIC_STREAM_ADJOINT",
          "#define REDNOSE_ADJOINT_TILE",
          '#include "stream_adjoint.cuh"', ""]
  return out


# ------------------------------------------------ mode "smooth_adjoint"
# Kernels 11', 12' and 14', the smoother's adjoint (csrc/smooth_adjoint.cuh):
# the VJPs of mode "smooth"'s functions, each by backward() over the very
# DAG entry_slab prints the function from, so each VJP is the one of the
# function the forward kernels compute.

def _vjp_function(name, params, dag, outs_of, seeds, leaves):
  """A template function of mode "smooth_adjoint": backward() of `dag`
  from `seeds` [(root, seed)], storing the adjoint of each leaf of
  `leaves` [(array, [leaf args])] (0 where none reaches it)."""
  names = {a[0] for _, args in leaves for a in args}
  adj = backward(dag, seeds, lambda a: a[0] in names)
  outs = [(arr, [adj.get(a) for a in args]) for arr, args in leaves]
  voids = " ".join(f"(void){p.split()[-1].lstrip('*')};"
                   for p in params.split(", "))
  return entry_slab._smooth_function(name, params, outs, "\n  " + voids)


def _vjp_parts(name, params, dag, part_seeds, leaves):
  """A template function of mode "smooth_adjoint" over `part` (0 ..
  len(part_seeds) - 1): part r is backward() of `dag` from the seeds
  part_seeds[r], storing the adjoint of each leaf of `leaves` as
  _vjp_function does. The parts' stores summed are the VJP from all the
  seeds (it is linear in them)."""
  names = {a[0] for _, args in leaves for a in args}
  voids = " ".join(f"(void){p.split()[-1].lstrip('*')};"
                   for p in params.split(", "))
  lines = ["template <typename scalar_t>",
           f"GEN_HD GEN_PHASE void {name}({params}, int part) {{",
           "  " + voids, "  switch (part) {"]
  for r, seeds in enumerate(part_seeds):
    adj = backward(dag, seeds, lambda a: a[0] in names)
    outs = [(arr, [adj.get(a) for a in args]) for arr, args in leaves]
    pr = entry_slab._SmoothPrinter(0)
    for _, values in outs:
      for v in values:
        pr.emit(v)
    lines += [f"  case {r}: {{"] + ["  " + ln for ln in pr.lines]
    lines += [f"    {arr}[{i}] = {pr.ref(v)};" for arr, values in outs
              for i, v in enumerate(values)]
    lines += ["    break;", "  }"]
  return lines + ["  default: break;", "  }", "}"]


def smooth_vjp_functions(spec: FilterSpec, pnames) -> list:
  """The lines of mode "smooth_adjoint"'s VJPs in namespace rn_gen:

    gen_sm_F_vjp(x, dt, p, gF, ld, gx, gdt, gp)
                                    gF (D2 x D2, row i at gF + i * ld) the
                                    cotangent of F's main block
                                    (gen_sm_F_part's): gx (DX), gdt[0] and
                                    gp (NP), second derivatives of f (the
                                    parts' reference);
    gen_sm_F_vjp_part(x, dt, p, gF, ld, gx, gdt, gp, part)
                                    the same from the entries of gF that
                                    part r of gen_sm_F_part computes
                                    (entry_slab.smooth_split): summed over
                                    the SM_PARTS parts, gen_sm_F_vjp;
    gen_sm_inv_err_vjp(xa, xb, p, g, gxa, gxb, gp)
                                    g (DE) the cotangent of inv_err(xa, xb):
                                    gxa, gxb (DX), gp;
    gen_sm_inv_err_vjp_xb(xa, xb, p, g, gxb)
                                    its gxb alone (the DAG pruned to it);
    gen_sm_inject_vjp_n{0,1}(x, dx, p, g, gx, gdx, gp)
                                    g (DX) the cotangent of inject(x, dx)
                                    (gen_sm_inject_n{0,1}'s): gx (DX), gdx
                                    (DE), gp; the renormalization's
                                    adjoint in n1;
    gen_sm_inject_vjp_dx_n{0,1}(x, dx, p, g, gdx)
                                    its gdx alone.

  The pruned ones carry kernel 12''s state chain: the columns of its step
  map (csrc/smooth_adjoint.cuh, pass before the chain)."""
  de, dx, np_ = spec.dim_err, spec.dim_x, len(pnames)
  xs = [("x", (i,)) for i in range(dx)]
  ps = [("p", (j,)) for j in range(np_)]
  funcs = []
  F_params = ("const scalar_t* x, const scalar_t dt, const scalar_t* p, "
              "const scalar_t* gF, int ld, scalar_t* gx, scalar_t* gdt, "
              "scalar_t* gp")
  F_leaves = [("gx", xs), ("gdt", [("dt", ())]), ("gp", ps)]
  d, F = entry_slab.smooth_F_dag(spec, pnames)
  funcs += _vjp_function(
      "gen_sm_F_vjp", F_params, d, F,
      [(v, d.load("gF", (idx,))) for idx, v in F], F_leaves)
  d, F = entry_slab.smooth_F_dag(spec, pnames)
  funcs += [""] + _vjp_parts(
      "gen_sm_F_vjp_part", F_params, d,
      [[(v, d.load("gF", (idx,))) for _, idx, v in part]
       for part in entry_slab.smooth_split([("F", F)])], F_leaves)
  xa = [("xa", (i,)) for i in range(dx)]
  xb = [("xb", (i,)) for i in range(dx)]
  for name, leaves in (("gen_sm_inv_err_vjp",
                        [("gxa", xa), ("gxb", xb), ("gp", ps)]),
                       ("gen_sm_inv_err_vjp_xb", [("gxb", xb)])):
    d, out = entry_slab.smooth_inv_err_dag(spec, pnames)
    funcs += [""] + _vjp_function(
        name, "const scalar_t* xa, const scalar_t* xb, const scalar_t* p, "
        "const scalar_t* g, " + ", ".join(
            f"scalar_t* {arr}" for arr, _ in leaves), d, out,
        [(v, d.load("g", (i,))) for i, v in enumerate(out)], leaves)
  gdx = [("dx", (i,)) for i in range(de)]
  for norm in (0, 1):
    for name, leaves in ((f"gen_sm_inject_vjp_n{norm}",
                          [("gx", xs), ("gdx", gdx), ("gp", ps)]),
                         (f"gen_sm_inject_vjp_dx_n{norm}", [("gdx", gdx)])):
      d, out = entry_slab.smooth_inject_dag(spec, pnames, norm)
      funcs += [""] + _vjp_function(
          name, "const scalar_t* x, const scalar_t* dx, const scalar_t* p, "
          "const scalar_t* g, " + ", ".join(
              f"scalar_t* {arr}" for arr, _ in leaves), d, out,
          [(v, d.load("g", (i,))) for i, v in enumerate(out)], leaves)
  return funcs


def smooth_adjoint_source(spec: FilterSpec, pnames) -> str:
  """C++ source of the smoother's adjoint kernels 11', 12' and 14' for one
  spec (emitted mode "smooth_adjoint"): mode "smooth"'s constants and
  functions (entry_slab.smooth_head, smooth_functions: the forward values
  the adjoint recomputes), smooth_vjp_functions, then csrc/smooth.cuh's
  helpers (RN_SM_HELPERS_ONLY: none of kernels 11, 12 and 14) and
  csrc/smooth_adjoint.cuh, the kernels and their C entries. A source of
  its own, so every mode "smooth" text stays as it was."""
  return "\n".join(
      entry_slab.smooth_head(spec, pnames, "smooth_adjoint")
      + entry_slab.smooth_functions(spec, pnames) + [""]
      + smooth_vjp_functions(spec, pnames)
      + ["", "}  // namespace rn_gen", "", "#define RN_SM_HELPERS_ONLY",
         '#include "smooth.cuh"', '#include "smooth_adjoint.cuh"', ""])
