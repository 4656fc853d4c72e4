"""Spec-to-CUDA emitter: the whole predict / update body of ANY FilterSpec
as C source, the port's counterpart of the reference's sympy-to-C codegen
(rednose/helpers/ekf_sym.py:76-89).

Port of rednose_tpu/ops/entry_slab.py (entry_predict_slab,
entry_update_slab) with the same algebra and term order, but where the
JAX version emits slab ops for Mosaic, this module builds one scalar
expression DAG per step phase through the structural interpreter
(ops/structural.py) and prints it as a `__host__ __device__` C++ function
over a `scalar_t` typedef. A variant's source is every phase function plus
a `gen_step` dispatcher; csrc/generic_scan.cuh wraps it in the scan loop
and the `__global__` kernel (ops/generic_scan.py builds and launches it).

Predict (entry_predict_slab): x_new = f(x, dt) and the Jacobian taps of
G = F - I over structure.g_cols through one shared DAG; compact
M = G P rows, N = M G^T, V = M + N / 2, P' = P + (V + V^T) (symmetric by
construction), then P' += dt Q on Q's structural nonzero pattern. For an
MSCKF spec G stays in the main block: the block predict of ekf_c.c:17-29.

Update (entry_update_slab): the composed-H taps of h(err(x, v), ea) over
structure.cols_for(kind); HP rows; S = HP H^T + R as an upper triangle
shared by the mirror pair; S^-1 by the closed-form adjugate (dz <= 3);
K^T = S^-1 HP; the zero-gain Mahalanobis gate; the factored Joseph
W = K (S K^T / 2 - HP) with P' = P + (W + W^T); error injection through
err and quaternion renormalization. An all-zero H row is a zero row here
(the JAX emitter raises a TypeError on it), and R's upper triangle is read
(the wrappers refuse an asymmetric R).

Camera frame (frame_phase, kernel 7): the MSCKF feature kind's update
projected onto the left null space of He, with the window augment folded
into its covariance store.

Run-time inputs of the emitted functions, all leaves of the DAG: x (in
registers), P (global memory, bank-minor: element (i, j) of this filter at
P[(i * DE + j) * ld]), dt, the params vector p, Q, z, ea and R. So the
source depends only on the spec, the kinds, the structure, the param
names, the streamed keys, the gate flags, Q's pattern and a camera frame's
R pattern ("iso" or R's nonzero entries), never on values.

P is read at the upper-triangle location of each symmetric pair (the
kernels keep P bitwise symmetric). A phase writes P in place: before the
store of a location, its old value is loaded if a later expression still
reads it; the nominal state is written back after every expression of
the phase.

Modes "single" (kernel 4), "epoch" (kernel 5), "mixed" (kernel 6) and
"frame" (kernel 7) print the tile form instead when the tile fits a block
(tile_bytes; an epoch's adds its staged inputs, epoch_input_bytes): each
phase split over W role bodies (TILE_ROLES, or TILE_ROLES_FRAME for a
variant with a camera-frame unit) that compute their share of p_out (role
0 also x_out) into constant-indexed values, and store functions the
template calls after a barrier, so no role stores an entry another role
still reads; each update's shared values (Phase.shared: the gated gains,
the Joseph factor rows, dx, and the gate decision in them) are printed
once, into shared scratch (role_split, _tile_source); a camera frame's
in stages, most of them split across the roles (stage_plan). Its window
roll then costs nothing: each role computes its rolled entries from the
old P and the scratch, and stores them after the barrier. A
mixed tile prints that for every unit and dispatchers that switch on the
step's kind index, then on the role; an epoch tile prints it once for
each distinct unit of its slots, dispatchers that switch on the unit,
and the slot table (each slot's unit, z and ea rows and R offset) its
loop reads. A variant whose tile does not fit prints the global form.

Mode "stream" (kernel 9, the offline log scan of runtime/scan.py) prints
the global form only: the predict, one update function per kind reading
the leading dz x dz block of the step's streamed max_dz x max_dz R, and a
switch over them by the step's kind index.
Mode "stream_adjoint" (kernel 10, the adjoint of kernel 9) is the reverse
mode of these DAGs, ops/adjoint.py.
"""

from __future__ import annotations

import math

import numpy as np

from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops import structural
from rednose_tpu_torch.ops.structural import Expr, ExprDAG


# ------------------------------------------------------------ entry algebra

def _ent_mul(d, e, row):
  """entry * row, folding structural / +-1 entries; row is a list."""
  if e is None or row is None:
    return None
  return [d.mul(e, r) for r in row]


def _row_add(d, a, b):
  return [d.add(u, v) for u, v in zip(a, b)]


def _tree_sum(d, terms, add=None):
  """Balanced pairwise sum (entry_slab._tree_sum) of rows or scalars; None
  when every term is None."""
  add = add or d.add
  terms = [t for t in terms if t is not None]
  if not terms:
    return None
  while len(terms) > 1:
    nxt = [add(terms[i], terms[i + 1]) for i in range(0, len(terms) - 1, 2)]
    if len(terms) % 2:
      nxt.append(terms[-1])
    terms = nxt
  return terms[0]


def _lsum(d, terms):
  """Left fold: python's sum() over slabs, as the JAX algebra writes it."""
  acc = None
  for t in terms:
    acc = d.add(acc, t)
  return acc


def _inv_entries(d, s, n):
  """Closed-form adjugate inverse on a nested list of entries
  (entry_slab._inv_entries)."""
  if n == 1:
    return [[d.div(1.0, s[0][0])]]
  if n == 2:
    det = d.sub(d.mul(s[0][0], s[1][1]), d.mul(s[0][1], s[1][0]))
    return [[d.div(s[1][1], det), d.div(d.neg(s[0][1]), det)],
            [d.div(d.neg(s[1][0]), det), d.div(s[0][0], det)]]
  if n == 3:
    def m2(a, b, c, e):
      return d.sub(d.mul(a, b), d.mul(c, e))
    c = [[m2(s[1][1], s[2][2], s[1][2], s[2][1]),
          m2(s[0][2], s[2][1], s[0][1], s[2][2]),
          m2(s[0][1], s[1][2], s[0][2], s[1][1])],
         [m2(s[1][2], s[2][0], s[1][0], s[2][2]),
          m2(s[0][0], s[2][2], s[0][2], s[2][0]),
          m2(s[0][2], s[1][0], s[0][0], s[1][2])],
         [m2(s[1][0], s[2][1], s[1][1], s[2][0]),
          m2(s[0][1], s[2][0], s[0][0], s[2][1]),
          m2(s[0][0], s[1][1], s[0][1], s[1][0])]]
    det = d.add(d.add(d.mul(s[0][0], c[0][0]), d.mul(s[0][1], c[1][0])),
                d.mul(s[0][2], c[2][0]))
    return [[d.div(c[i][j], det) for j in range(3)] for i in range(3)]
  raise NotImplementedError(
      f"the emitter inverts S in closed form for dz <= 3 only, got dz={n}")


def _normalize(d, x, idxs):
  x = list(x)
  for idx in idxs:
    q = x[idx:idx + 4]
    ss = d.add(d.add(d.add(d.mul(q[0], q[0]), d.mul(q[1], q[1])),
                     d.mul(q[2], q[2])), d.mul(q[3], q[3]))
    inv = d.unary("rsqrt", ss)
    x[idx:idx + 4] = [d.mul(qi, inv) for qi in q]
  return x


class Phase:
  """One emitted function: its DAG, the new P entries (upper triangle, by
  location) and the new nominal state. An update's `shared` values (the
  gated gain rows, the Joseph factor rows and dx) are what every entry of
  p_out and x_out reads from its innovation: the tile form prints them
  once per filter, into shared scratch (emit_source). A camera frame's
  `stages` split that work: (kind, groups of values) in order, "serial"
  computed by one role, "split" across the roles a group at a time (a
  column), each stage reading the values of earlier stages from the
  scratch; the last stage's values are `shared`."""

  def __init__(self):
    self.dag = ExprDAG()
    self.p_out = {}
    self.x_out = []
    self.shared = []
    self.stages = None
    self.gate = None

  def P(self, i, j):
    return self.dag.load("P", (min(i, j), max(i, j)))

  def inputs(self, name, shape):
    return structural.load_array(self.dag, name, shape)


def _param_inputs(ph, pnames):
  return [_scalar(ph.dag.load("p", (i,))) for i in range(len(pnames))]


def _scalar(e):
  out = structural.obj_array(())
  out[()] = e
  return out


def predict_phase(spec: FilterSpec, structure, pnames, q_pattern) -> Phase:
  """entry_predict_slab as a DAG (see the module docstring). For an MSCKF
  spec G is confined to the main block [0, dim_main_err): rows outside it
  get no M row, so V + V^T updates the main block fully, the coupling
  one-sided, and leaves the clone block as it is (ekf_c.c:17-29)."""
  m = spec.dim_main_err
  if any(k >= m for k in structure.g_cols):
    raise ValueError(f"structure g_cols {structure.g_cols} leave the main "
                     f"block [0, {m}) of spec {spec.name!r}")
  ph = Phase()
  d = ph.dag
  de, dx = spec.dim_err, spec.dim_x
  x = ph.inputs("x", (dx,))
  dt = _scalar(d.load("dt"))
  prm = _param_inputs(ph, pnames)
  np_ = len(pnames)

  def f(xx, dtt, *pv):
    return spec.f(dict(zip(pnames, pv)), xx, dtt)

  shapes = [(dx,), ()] + [()] * np_
  x_new = structural.run_primal(d, f, shapes, [x, dt] + prm)

  if spec.f_err is not None:
    def fe(xx, dtt, *rest):
      return spec.f_err(dict(zip(pnames, rest[:-1])), xx, rest[-1], dtt)
  else:
    if de != dx:
      raise ValueError("additive spec with dim_err != dim_x")

    def fe(xx, dtt, *rest):
      return spec.f(dict(zip(pnames, rest[:-1])), xx + rest[-1], dtt)

  g_cols = structure.g_cols
  _, taps = structural.run_entry_taps(d, fe, shapes, [x, dt] + prm, de,
                                      g_cols)
  G = {}
  for k in g_cols:
    col = list(taps[k])
    e = col[k]
    if e is None:
      col[k] = -1.0
    elif structural._is_const(e):
      col[k] = e - 1.0 if e != 1.0 else None
    else:
      col[k] = d.sub(e, 1.0)
    G[k] = col

  P_rows = {k: [ph.P(k, j) for j in range(de)] for k in g_cols}
  m_rows = [_tree_sum(d, [_ent_mul(d, G[k][i], P_rows[k]) for k in g_cols],
                      add=lambda a, b: _row_add(d, a, b))
            for i in range(m)] + [None] * (de - m)
  nz = [i for i in range(de) if m_rows[i] is not None]
  V = [None] * de
  if nz:
    M_cols = {k: [m_rows[i][k] for i in nz] for k in g_cols}
    n_cols = []
    for j in nz:
      acc = _tree_sum(d, [_ent_mul(d, G[k][j], M_cols[k]) for k in g_cols],
                      add=lambda a, b: _row_add(d, a, b))
      n_cols.append(acc if acc is not None else [None] * len(nz))
    for p, i in enumerate(nz):
      row = list(m_rows[i])
      for q, c in enumerate(nz):
        row[c] = d.add(row[c], d.mul(0.5, n_cols[q][p]))
      V[i] = row
  qset = set(q_pattern)
  for i in range(de):
    for j in range(i, de):
      vij = V[i][j] if V[i] is not None else None
      vji = V[j][i] if V[j] is not None else None
      out = d.add(ph.P(i, j), d.add(vij, vji))
      if (i, j) in qset:
        out = d.add(out, d.mul(d.load("dt"), d.load("Q", (i, j))))
      ph.p_out[(i, j)] = out
  ph.x_out = _normalize(d, list(x_new), spec.quaternion_idxs)
  return ph


def update_phase(spec: FilterSpec, kind: int, structure, pnames,
                 gate: bool, stored_gate: bool = False) -> Phase:
  """entry_update_slab as a DAG (see the module docstring). stored_gate
  (the adjoint's form, ops/adjoint.py): a gated kind gates on the leaf
  'rej', a decision given with the inputs, and the decision recomputed
  from them is Phase.gate."""
  om = spec.obs[kind]
  if om.is_feature:
    raise ValueError(f"kind {kind} is an MSCKF feature kind: its update is "
                     "the frame unit (frame_phase)")
  ph = Phase()
  d = ph.dag
  dz, de, dx = om.dz, spec.dim_err, spec.dim_x
  x = ph.inputs("x", (dx,))
  ea_len = max(om.ea_len, 1)
  ea = (ph.inputs("ea", (om.ea_len,)) if om.ea_len
        else structural.obj_array((1,)))
  prm = _param_inputs(ph, pnames)
  cols = structure.cols_for(kind)

  def fh(xx, ee, *rest):
    params = dict(zip(pnames, rest[:-1]))
    return om.h(params, spec.err(params, xx, rest[-1]), ee)

  shapes = [(dx,), (ea_len,)] + [()] * len(pnames)
  h, taps = structural.run_entry_taps(d, fh, shapes, [x, ea] + prm, de, cols)
  z = ph.inputs("z", (dz,))
  y = [d.sub(z[r], h[r]) for r in range(dz)]

  P_rows = {c: [ph.P(c, j) for j in range(de)] for c in cols}
  hp_rows = [_tree_sum(d, [_ent_mul(d, taps[c][r], P_rows[c]) for c in cols],
                       add=lambda a, b: _row_add(d, a, b))
             for r in range(dz)]

  def hp(r, c):
    return hp_rows[r][c] if hp_rows[r] is not None else None

  s = [[None] * dz for _ in range(dz)]
  for r in range(dz):
    for q in range(r, dz):
      acc = _tree_sum(d, [d.mul(taps[c][q], hp(r, c)) for c in cols])
      acc = d.add(acc, d.load("R", (r, q)))
      s[r][q] = acc
      s[q][r] = acc
  siv = _inv_entries(d, s, dz)

  kt = [None] * dz
  for i in range(dz):
    terms = [[d.mul(siv[i][j], e) for e in hp_rows[j]]
             for j in range(dz) if hp_rows[j] is not None]
    kt[i] = _lsum_rows(d, terms)
  if gate:
    dist = _lsum(d, [d.mul(d.mul(y[i], siv[i][j]), y[j])
                     for i in range(dz) for j in range(dz)])
    rej = d.binop("gt", dist, float(om.maha_thresh))
    if stored_gate:
      ph.gate, rej = rej, d.load("rej")
      rej.is_bool = True
    kt = [None if row is None else [d.where(rej, None, e) for e in row]
          for row in kt]
  dxe = [_lsum(d, [d.mul(kt[i][c], y[i]) for i in range(dz)
                   if kt[i] is not None]) for c in range(de)]

  t_rows = []
  for i in range(dz):
    sk = _lsum_rows(d, [[d.mul(s[i][j], e) for e in kt[j]]
                        for j in range(dz) if kt[j] is not None])
    t_rows.append([d.sub(None if sk is None else d.mul(0.5, sk[c]),
                         hp(i, c)) for c in range(de)])
  for a in range(de):
    for b in range(a, de):
      wab = _lsum(d, [d.mul(kt[i][a], t_rows[i][b]) for i in range(dz)
                      if kt[i] is not None])
      wba = _lsum(d, [d.mul(kt[i][b], t_rows[i][a]) for i in range(dz)
                      if kt[i] is not None])
      ph.p_out[(a, b)] = d.add(ph.P(a, b), d.add(wab, wba))
  ph.shared = ([e for row in kt if row is not None for e in row]
               + [e for row in t_rows for e in row] + list(dxe))
  # in a variant with a camera frame (stage_plan): one role the taps and
  # the innovation, every role its columns of HP, one role S, its inverse
  # and the gate, every role its columns of K^T, the Joseph factor rows
  # and dx
  rows = [row for row in kt if row is not None]
  ph.stages = [
      ("serial", [[taps[c][r] for c in cols for r in range(dz)] + y]),
      ("split", [[hp(r, c) for r in range(dz)] for c in range(de)]),
      ("serial", [[s[r][q] for r in range(dz) for q in range(r, dz)]
                  + [e for row in siv for e in row]
                  + ([rej] if gate else [])]),
      ("split", [[row[c] for row in rows] + [t[c] for t in t_rows]
                 + [dxe[c]] for c in range(de)])]

  dx_arr = structural.obj_array((de,))
  for c in range(de):
    dx_arr[c] = dxe[c]

  def fe(xx, dd, *pv):
    return spec.err(dict(zip(pnames, pv)), xx, dd)

  x_new = structural.run_primal(d, fe, [(dx,), (de,)] + [()] * len(pnames),
                                [x, dx_arr] + prm)
  ph.x_out = _normalize(d, list(x_new), spec.quaternion_idxs)
  return ph


def _lsum_rows(d, rows):
  acc = None
  for r in rows:
    acc = r if acc is None else _row_add(d, acc, r)
  return acc


# ------------------------------------------------------ MSCKF camera frame

def _householder(d, he_cols, dz):
  """Householder reflectors of the thin QR of He, given as its columns
  (lists of dz entries): [(j, v entries, beta)], lane_bank._householder_qt
  on entries. sign = where(c0 >= 0, 1, -1); beta = where(vtv > 0, 2 / vtv,
  0), so a structurally rank-deficient column reflects by the identity."""
  cols = [list(c) for c in he_cols]
  refl = []
  for j in range(len(cols)):
    c = cols[j][j:]
    sigma = _lsum(d, [d.mul(ci, ci) for ci in c])
    norm = d.unary("sqrt", sigma)
    sign = d.where(d.binop("ge", c[0], 0.0), 1.0, -1.0)
    v0 = d.sub(c[0], d.neg(d.mul(sign, norm)))
    v = [v0] + c[1:]
    vtv = d.add(d.sub(sigma, d.mul(c[0], c[0])), d.mul(v0, v0))
    beta = d.where(d.binop("gt", vtv, 0.0), d.div(2.0, vtv), None)
    refl.append((j, v, beta))
    for k in range(j + 1, len(cols)):
      ck = cols[k]
      w = _lsum(d, [d.mul(v[i], ck[j + i]) for i in range(dz - j)])
      bw = d.mul(beta, w)
      cols[k] = ck[:j] + [d.sub(ck[j + i], d.mul(bw, v[i]))
                          for i in range(dz - j)]
  return refl


def _apply_qt(d, refl, M):
  """Q^T M for M a list of dz rows (lists of n entries), by the
  reflectors (lane_bank._apply_qt on entries)."""
  M = [list(r) for r in M]
  n = len(M[0])
  for j, v, beta in refl:
    for c in range(n):
      w = _lsum(d, [d.mul(v[i], M[j + i][c]) for i in range(len(v))])
      bw = d.mul(beta, w)
      for i in range(len(v)):
        M[j + i][c] = d.sub(M[j + i][c], d.mul(bw, v[i]))
  return M


def _cholesky(d, S, n):
  """lane_bank.cholesky_lane on entries: column j of the lower factor from
  the diagonal down. S(i, j) reads the symmetric S."""
  cols = []
  for j in range(n):
    s = [S(i, j) for i in range(j, n)]
    for k in range(j):
      s = [d.sub(s[t], d.mul(cols[k][j - k + t], cols[k][j - k]))
           for t in range(len(s))]
    diag = d.unary("sqrt", s[0])
    cols.append([diag] + [d.div(e, diag) for e in s[1:]])
  return cols


def _cho_solve(d, cols, rows):
  """lane_bank.cho_solve_lane on entries: rows is the right-hand side as
  n rows of entries."""
  n, m = len(cols), len(rows[0])
  Y = [None] * n
  for i in range(n):
    s = list(rows[i])
    for k in range(i):
      s = [d.sub(s[c], d.mul(cols[k][i - k], Y[k][c])) for c in range(m)]
    Y[i] = [d.div(e, cols[i][0]) for e in s]
  X = [None] * n
  for i in reversed(range(n)):
    s = list(Y[i])
    for k in range(i + 1, n):
      s = [d.sub(s[c], d.mul(cols[i][k - i], X[k][c])) for c in range(m)]
    X[i] = [d.div(e, cols[i][0]) for e in s]
  return X


def frame_phase(spec: FilterSpec, kind: int, structure, pnames, gate: bool,
                r_pattern) -> Phase:
  """The MSCKF camera frame after the predict, as a DAG: the projected
  feature update of `kind` and the window augment (JAX entry_slab.py
  entry_feature_innovation_slab, entry_feature_apply_slab with
  augment=True and joseph_sym_augment).

  Innovation: the composed-H taps of h(err(x, v), ea) over
  structure.cols_for(kind) and the He taps (ea_dim columns of
  h(x, ea + w)); the Householder reflectors of He as entries; the
  projected yp, H and HP rows and the upper triangle of S = HP H^T + R'.
  R' = Q^T R Q: r_pattern "iso" adds R[0] on the diagonal (exact for
  R = s^2 I), else the general product over R's nonzero (i, j), i <= j.
  Apply: the Cholesky of S (dz' = dz - ea_dim) and K^T = S^-1 HP; the gate
  (S^-1 yp) . yp > maha_thresh gives zero gain; dx; the factored Joseph
  B = P + (W + W^T), W = K (S K^T / 2 - HP), stored with the window roll:
  the new P is B with the oldest clone's rows and columns dropped and the
  pose's duplicated into the newest slot, so almost every location reads
  another's old value (print_phase loads each before its store); then
  err(x, dx), quaternion renormalization and the roll of x."""
  om = spec.obs[kind]
  if not om.is_feature:
    raise ValueError(f"kind {kind} is not an MSCKF feature kind")
  ph = Phase()
  d = ph.dag
  dz, me, de, dx = om.dz, om.ea_dim, spec.dim_err, spec.dim_x
  dzp = dz - me
  x = ph.inputs("x", (dx,))
  ea = ph.inputs("ea", (om.ea_len,))
  prm = _param_inputs(ph, pnames)
  cols = structure.cols_for(kind)
  shapes = [(dx,), (om.ea_len,)] + [()] * len(pnames)

  def fh(xx, ee, *rest):
    params = dict(zip(pnames, rest[:-1]))
    return om.h(params, spec.err(params, xx, rest[-1]), ee)

  def fe(xx, ee, *rest):
    return om.h(dict(zip(pnames, rest[:-1])), xx, ee + rest[-1])

  h, taps = structural.run_entry_taps(d, fh, shapes, [x, ea] + prm, de, cols)
  _, etaps = structural.run_entry_taps(d, fe, shapes, [x, ea] + prm,
                                       om.ea_len, tuple(range(me)))
  z = ph.inputs("z", (dz,))
  y = [d.sub(z[r], h[r]) for r in range(dz)]

  refl = _householder(d, [list(etaps[c]) for c in range(me)], dz)
  yp = [r[0] for r in _apply_qt(d, refl, [[e] for e in y])[me:]]
  Hp = _apply_qt(d, refl, [[taps[c][r] for c in cols]
                           for r in range(dz)])[me:]        # dz' x nc

  P_rows = {c: [ph.P(c, j) for j in range(de)] for c in cols}
  HP = [_tree_sum(d, [_ent_mul(d, Hp[r][j], P_rows[c])
                      for j, c in enumerate(cols)],
                  add=lambda a, b: _row_add(d, a, b))
        for r in range(dzp)]
  s = [[None] * dzp for _ in range(dzp)]
  r_terms = []                     # R' = Q^T R Q's upper triangle
  if r_pattern != "iso":
    rset = set(r_pattern)
    Rm = [[d.load("R", (i, j)) if (min(i, j), max(i, j)) in rset else None
           for j in range(dz)] for i in range(dz)]
    T1 = _apply_qt(d, refl, Rm)
    Rp = _apply_qt(d, refl, [list(r) for r in zip(*T1)])
  for r in range(dzp):
    for q in range(r, dzp):
      acc = _tree_sum(d, [d.mul(HP[r][c], Hp[q][j])
                          for j, c in enumerate(cols)])
      if r_pattern == "iso":
        if r == q:
          acc = d.add(acc, d.load("R", (0, 0)))
      else:
        r_terms.append(d.mul(0.5, d.add(Rp[me + r][me + q],
                                        Rp[me + q][me + r])))
        acc = d.add(acc, r_terms[-1])
      s[r][q] = acc

  def S(i, j):
    return s[min(i, j)][max(i, j)]

  L = _cholesky(d, S, dzp)
  kt = _cho_solve(d, L, HP)                                  # K^T rows
  rej = []
  if gate:
    sy = _cho_solve(d, L, [[e] for e in yp])
    dist = _lsum(d, [d.mul(yp[i], sy[i][0]) for i in range(dzp)])
    rej = [d.binop("gt", dist, float(om.maha_thresh))]
    kt = [[d.where(rej[0], None, e) for e in row] for row in kt]
  dxe = [_lsum(d, [d.mul(kt[i][c], yp[i]) for i in range(dzp)])
         for c in range(de)]
  t_rows = [[d.sub(d.mul(0.5, _lsum(d, [d.mul(S(i, j), kt[j][c])
                                         for j in range(dzp)])), HP[i][c])
             for c in range(de)] for i in range(dzp)]

  def w(a, b):
    return _lsum(d, [d.mul(kt[i][a], t_rows[i][b]) for i in range(dzp)])

  d1, d2 = spec.dim_main, spec.dim_main_err
  d3, d4 = spec.dim_augment, spec.dim_augment_err

  def old(i):
    """The updated P's row / column that the new row / column i is."""
    if i < d2:
      return i
    return i + d4 if i < de - d4 else i - (de - d4)

  updated = {}
  for i in range(de):
    for j in range(i, de):
      a, b = sorted((old(i), old(j)))
      if (a, b) not in updated:
        updated[(a, b)] = d.add(ph.P(a, b), d.add(w(a, b), w(b, a)))
      ph.p_out[(i, j)] = updated[(a, b)]

  dx_arr = structural.obj_array((de,))
  for c in range(de):
    dx_arr[c] = dxe[c]

  def fe_inj(xx, dd, *pv):
    return spec.err(dict(zip(pnames, pv)), xx, dd)

  x_new = structural.run_primal(d, fe_inj,
                                [(dx,), (de,)] + [()] * len(pnames),
                                [x, dx_arr] + prm)
  x_new = _normalize(d, list(x_new), spec.quaternion_idxs)
  ph.x_out = x_new[:d1] + x_new[d1 + d3:] + x_new[:d3]
  # column by column: column c of kt and t_rows and dx[c] need only
  # column c of HP, so each column is one group of the last stage below
  ph.shared = [e for c in range(de)
               for e in ([kt[i][c] for i in range(dzp)]
                         + [t_rows[i][c] for i in range(dzp)] + [dxe[c]])]
  # the tile computes the shared values in stages (stage_plan): one role
  # He's reflectors, the projected innovation (and R' = Q^T R Q); every
  # role its columns of the projected H, then its columns of HP, then its
  # entries of S; one role S's Cholesky factor and the gate; every role its
  # columns of K^T, the Joseph factor rows and dx
  n = 2 * dzp + 1
  ph.stages = [
      ("serial", [[e for _, v, beta in refl for e in v + [beta]] + yp
                  + r_terms]),
      ("split", [[Hp[r][j] for r in range(dzp)] for j in range(len(cols))]),
      ("split", [[HP[r][c] for r in range(dzp)] for c in range(de)]),
      ("split", [[s[r][q]] for r in range(dzp) for q in range(r, dzp)]),
      ("serial", [[e for col in L for e in col] + rej]),
      ("split", [ph.shared[c * n:(c + 1) * n] for c in range(de)])]
  return ph


# --------------------------------------------------------------- C printing

_FUNCS = {
    "sqrt": "g_sqrt", "rsqrt": "g_rsqrt", "sin": "g_sin", "cos": "g_cos",
    "tan": "g_tan", "tanh": "g_tanh", "sinh": "g_sinh", "cosh": "g_cosh",
    "asin": "g_asin", "acos": "g_acos", "atan": "g_atan",
    "asinh": "g_asinh", "atanh": "g_atanh", "exp": "g_exp",
    "expm1": "g_expm1", "log": "g_log", "log1p": "g_log1p",
    "abs": "g_abs", "sign": "g_sign", "erf": "g_erf", "floor": "g_floor",
    "ceil": "g_ceil", "pow": "g_pow", "max": "g_max", "min": "g_min",
    "atan2": "g_atan2", "fmod": "g_fmod", "remainder": "g_remainder",
    "hypot": "g_hypot",
}
_INFIX = {"add": "+", "sub": "-", "mul": "*", "div": "/", "gt": ">",
          "lt": "<", "ge": ">=", "le": "<=", "eq": "==", "ne": "!=",
          "and": "&&", "or": "||"}


def _lit(v):
  if isinstance(v, bool):
    return "true" if v else "false"
  v = float(v)
  if math.isnan(v):
    return "((scalar_t)NAN)"
  if math.isinf(v):
    return "((scalar_t)INFINITY)" if v > 0 else "(-(scalar_t)INFINITY)"
  return f"((scalar_t){v!r})"


def _load_text(name, idx, dz):
  if name == "x":
    return f"x[{idx[0]}]"
  if name == "P":
    return f"GEN_P({idx[0]}, {idx[1]})"
  if name == "dt":
    return "dt"
  if name == "p":
    return f"p[{idx[0]}]"
  if name == "Q":
    return f"Q[{idx[0]} * DE + {idx[1]}]"
  if name == "z":
    return f"z[(size_t){idx[0]} * ld_in]"
  if name == "ea":
    return f"ea[(size_t){idx[0]} * ld_in]"
  if name == "R":
    return f"R[{idx[0] * dz + idx[1]}]"
  raise AssertionError(name)


def _c_text(e, ref, load):
  """The C expression of one DAG node; ref names an operand, load gives a
  leaf's text from its (array name, index)."""
  a = e.args
  if e.op == "load":
    return load(a)
  if e.op in _INFIX:
    return f"{ref(a[0])} {_INFIX[e.op]} {ref(a[1])}"
  if e.op == "neg":
    return f"-{ref(a[0])}"
  if e.op == "not":
    return f"!{ref(a[0])}"
  if e.op == "where":
    return f"{ref(a[0])} ? {ref(a[1])} : {ref(a[2])}"
  if e.op == "cast":
    return f"(scalar_t)({ref(a[0])})"
  if e.op in _FUNCS:
    return f"{_FUNCS[e.op]}({', '.join(ref(v) for v in a)})"
  raise NotImplementedError(f"emitter: no C form for op {e.op!r}")


def _reachable(roots):
  seen, stack = set(), [r for r in roots if isinstance(r, Expr)]
  out = []
  while stack:
    e = stack.pop()
    if e.id in seen:
      continue
    seen.add(e.id)
    out.append(e)
    stack.extend(a for a in e.args if isinstance(a, Expr))
  return out


class _Printer:
  """SSA statements of one emitted function: each node a `const`
  definition after its operands. x reads as x[i], or in the tile form
  (tile=True) through GEN_X; a node of `slots` (tile form) is read from
  its scratch slot through GEN_S instead of computed."""

  def __init__(self, dz, tile=False, slots=None):
    self.lines, self.names, self.dz = [], {}, dz
    self.tile, self.slots = tile, slots or {}

  def ref(self, v):
    if v is None:
      return "((scalar_t)0)"
    if isinstance(v, Expr):
      return self.names[v.id]
    return _lit(v)

  def _load(self, a):
    if self.tile and a[0] == "x":
      return f"GEN_X({a[1][0]})"
    return _load_text(a[0], a[1], self.dz)

  def emit(self, root):
    if not isinstance(root, Expr) or root.id in self.names:
      return
    stack = [(root, False)]
    while stack:
      e, ready = stack.pop()
      if e.id in self.names:
        continue
      if ready or e.id in self.slots:
        text = (f"GEN_S({self.slots[e.id]})" if e.id in self.slots
                else _c_text(e, self.ref, self._load))
        self.names[e.id] = f"t{e.id}"
        ctype = "bool" if e.is_bool else "scalar_t"
        self.lines.append(f"  const {ctype} t{e.id} = {text};")
        continue
      stack.append((e, True))
      for a in reversed(e.args):
        if isinstance(a, Expr) and a.id not in self.names:
          stack.append((a, False))


def print_phase(ph: Phase, dz: int = 0) -> list:
  """Statements of one phase: SSA definitions in dependency order, P
  stores as soon as their value exists (after the old value is loaded if
  anything still reads it), x stores last."""
  pr = _Printer(dz)
  lines, ref, emit = pr.lines, pr.ref, pr.emit

  roots = list(ph.p_out.values()) + list(ph.x_out)
  p_loads = {e.args[1]: e for e in _reachable(roots)
             if e.op == "load" and e.args[0] == "P"}
  for (i, j), v in sorted(ph.p_out.items()):
    old = p_loads.get((i, j))
    if v is old:
      continue  # unchanged entry
    emit(v)
    if old is not None:
      emit(old)
    val = ref(v)
    lines.append(f"  GEN_P({i}, {j}) = {val};")
    if i != j:
      lines.append(f"  GEN_P({j}, {i}) = {val};")
  changed = [(i, v) for i, v in enumerate(ph.x_out)
             if not _unchanged(v, "x", (i,))]
  for _, v in changed:
    emit(v)
  for i, v in changed:
    lines.append(f"  x[{i}] = {ref(v)};")
  return lines


# ---------------------------------------------------------- a mode as a tile
# Kernels 4-7 keep P, x and the update's shared values of TILE_LANES
# filters in a block's shared memory for the whole T loop and split each
# phase over W roles, one warp each (csrc/generic_scan.cuh,
# REDNOSE_GENERIC_SCAN_TILE): role r computes its share of the phase's new
# P entries (and role 0 the new x) into constant-indexed values, and after
# the template's barrier stores them. An update's shared values (the gated
# gain rows, the Joseph factor rows and dx, with the gate decision they
# carry) are printed once, in a function of their own that one role runs
# into the shared scratch before the other roles read them there; a mixed
# variant (and an epoch's distinct units) has one such function and one
# role set per unit, and its scratch holds the largest unit's values. A
# variant whose tile exceeds what a block may use keeps the global form.

TILE_ROLES = 2           # W: measured among 1, 2, 4 and 8 (PERF.md)
TILE_ROLES_FRAME = 8     # W of a variant with a camera-frame unit (PERF.md)
TILE_ROLES_STREAM = 8    # W of a log-scan variant (mode "stream", PERF.md)
TILE_LANES = 32          # filters a block holds, one a lane
TILE_SMEM_MAX = 232_448  # shared memory bytes a block may use on the H100
_SCALAR_BYTES = {"float": 4, "double": 8}


def _computed(values, seen=None) -> list:
  """The values that need computing (no constant, no plain load), each
  once, in order, skipping the ids in seen (which it extends)."""
  seen = set() if seen is None else seen
  out = []
  for e in values:
    if isinstance(e, Expr) and e.op != "load" and e.id not in seen:
      seen.add(e.id)
      out.append(e)
  return out


def shared_nodes(ph) -> list:
  """The update's shared values that need computing (no constant, no
  plain load), each once, in order: the scratch slots."""
  return _computed(ph.shared)


def _frontier(roots, stop) -> set:
  """The ids of stop that the roots read, not looking past them."""
  out, seen = set(), set()
  stack = [r for r in roots if isinstance(r, Expr)]
  while stack:
    e = stack.pop()
    if e.id in seen:
      continue
    seen.add(e.id)
    if e.id in stop:
      out.add(e.id)
    elif e.op != "load":
      stack.extend(a for a in e.args if isinstance(a, Expr))
  return out


def stage_plan(upd, staged):
  """(stages, slots, nscr): an update's shared values in the tile, as
  stages [(kind, groups of values)] in order, "serial" (one role computes
  and stores them) or "split" (every role computes its share, whole
  groups, then, after a barrier, stores it), and the scratch slot of each
  value by id. One serial stage of the shared values, or, in a variant
  with a camera frame (staged), the unit's own stages (Phase.stages),
  where a value takes the lowest slot whose value no later stage reads: a
  serial stage's values after the stage that last reads the slot, a split
  stage's from that stage on, since its roles store only after all have
  read."""
  if not staged or upd.stages is None:
    cuts = shared_nodes(upd)
    return [("serial", [cuts])], {e.id: k for k, e in enumerate(cuts)}, \
        len(cuts)
  seen = set()
  stages = [(kind, [grp for grp in (_computed(g, seen) for g in groups)
                    if grp]) for kind, groups in upd.stages]
  stages = [st for st in stages if st[1]]     # e.g. HP of an H of ones
  last, earlier = {}, set()
  for g, (_, groups) in enumerate(stages):
    vals = [e for grp in groups for e in grp]
    for i in _frontier(vals, earlier):
      last[i] = g
    earlier |= {e.id for e in vals}
  for e in shared_nodes(upd):                 # the update's roles read them
    last[e.id] = len(stages)
  slots, held = {}, []                        # held[k]: last reader of k
  for g, (kind, groups) in enumerate(stages):
    for e in (e for grp in groups for e in grp):
      k = next((k for k, h in enumerate(held)
                if h < g or (h == g and kind == "split")), len(held))
      if k == len(held):
        held.append(0)
      held[k] = last.get(e.id, g)
      slots[e.id] = k
  return stages, slots, len(held)


def tile_bytes(spec, upd, scalar, staged=False) -> int:
  """Shared memory of a block of the tile form: TILE_LANES filters x
  (P, x, the update's scratch, in stages in a variant with a camera
  frame); a mixed variant's is the largest of its units'; an epoch
  variant's adds epoch_input_bytes."""
  vals = spec.dim_err ** 2 + spec.dim_x + stage_plan(upd, staged)[2]
  return vals * TILE_LANES * _SCALAR_BYTES[scalar]


def epoch_input_bytes(nzrows, nearows, scalar) -> int:
  """An epoch tile's staged inputs: two steps' z and ea rows of
  TILE_LANES filters (the step that runs and the next, copied ahead)."""
  return 2 * (nzrows + nearows) * TILE_LANES * _SCALAR_BYTES[scalar]


def stream_input_bytes(nzrows, nearows, scalar) -> int:
  """A log-scan tile's staged inputs, two steps' worth (the step that runs
  and the next, copied ahead): the z and ea rows of TILE_LANES filters,
  the step's nzrows x nzrows R, its dt and its kind index (in a value's
  slot)."""
  return 2 * ((nzrows + nearows) * TILE_LANES + nzrows ** 2 + 2) * \
      _SCALAR_BYTES[scalar]


def _needs(root, stop):
  """Ids of the nodes (loads aside) that root needs, up to the stop ids."""
  out, stack = set(), [root] if isinstance(root, Expr) else []
  while stack:
    e = stack.pop()
    if e.id in out or e.id in stop or e.op == "load":
      continue
    out.add(e.id)
    stack.extend(a for a in e.args if isinstance(a, Expr))
  return out


def _unchanged(v, name, idx):
  return isinstance(v, Expr) and v.op == "load" and v.args == (name, idx)


def role_split(ph, n_roles, stop=frozenset()) -> list:
  """A phase's changed outputs split over n_roles roles, one list of
  (array, index, value) each: role 0 takes the new x; each new P entry,
  upper triangle in row-major order, goes to the role whose work (the
  nodes it computes, up to the stop ids; a role computes a shared
  subexpression once) ends least, ties to the lower role."""
  roles = [[] for _ in range(n_roles)]
  work = [set() for _ in range(n_roles)]
  for i, v in enumerate(ph.x_out):
    if not _unchanged(v, "x", (i,)):
      roles[0].append(("x", i, v))
      work[0] |= _needs(v, stop)
  return _balance(roles, work, [[("P", ij, v)] for ij, v in
                                sorted(ph.p_out.items())
                                if not _unchanged(v, "P", ij)], stop)


def _balance(roles, work, groups, stop):
  """Each group of (array, index, value) outputs, whole, to the role whose
  work ends least with it (role_split)."""
  for grp in groups:
    need = set().union(*(_needs(v, stop) for _, _, v in grp))
    r = min(range(len(roles)), key=lambda r: len(work[r] | need))
    roles[r].extend(grp)
    work[r] |= need
  return roles


def _args(params):
  """The argument names of a C parameter list."""
  return [p.split()[-1].lstrip("*") for p in params]


def _function(name, params, lines, inline="GEN_INLINE"):
  return ([f"GEN_HD {inline} void {name}({', '.join(params)}) {{",
           "  " + " ".join(f"(void){n};" for n in _args(params))]
          + lines + ["}"])


def _role_functions(name, params, roles, dz, slots,
                    stored=("scalar_t* x", "scalar_t* P", "size_t ld",
                            "const scalar_t* v")):
  """Role r's compute function name_r{r} (its values into v) and store
  function name_r{r}_store (v into P and x, each P entry at (i, j) and
  (j, i); a stage's values, array "s", into their scratch slots)."""
  out = []
  for r, outs in enumerate(roles):
    pr = _Printer(dz, True, slots)
    for _, _, v in outs:
      pr.emit(v)
    pr.lines += [f"  v[{k}] = {pr.ref(v)};" for k, (_, _, v) in
                 enumerate(outs)]
    out += ["", *_function(f"{name}_r{r}", params + ["scalar_t* v"],
                           pr.lines)]
    store = []
    for k, (arr, idx, _) in enumerate(outs):
      if arr == "x":
        store.append(f"  GEN_X({idx}) = v[{k}];")
      elif arr == "s":
        store.append(f"  GEN_S({idx}) = v[{k}];")
      else:
        i, j = idx
        store.append(f"  GEN_P({i}, {j}) = v[{k}];")
        if i != j:
          store.append(f"  GEN_P({j}, {i}) = v[{k}];")
    out += ["", *_function(f"{name}_r{r}_store", list(stored), store)]
  return out


def _split_stages(stages, slots, n_roles):
  """Each stage (stage_plan) with its roles: (kind, values, roles), roles
  None for a serial stage, else the split of its groups, each role's up to
  the values of earlier stages (which it reads from the scratch)."""
  out, earlier = [], set()
  for kind, groups in stages:
    vals = [e for grp in groups for e in grp]
    roles = None if kind == "serial" else _balance(
        [[] for _ in range(n_roles)], [set() for _ in range(n_roles)],
        [[("s", slots[e.id], e) for e in grp] for grp in groups],
        frozenset(earlier))
    out.append((kind, vals, roles))
    earlier |= {e.id for e in vals}
  return out


def _stage_functions(name, p_in, stages, slots, n_roles, dz, frame):
  """A unit's shared values in stages (_split_stages): a serial stage g's
  function name_s{g} (one role, each value stored into its slot as soon
  as it is computed; GEN_PHASE for a camera frame), a split stage's role
  functions name_s{g}_r{r} and their stores; then name_stage(g, r, ...)
  and name_stage_store(g, r, s, ld, v), the switches over the stages and
  roles, and the stage count name_NSTAGES."""
  out, cases, store_cases, earlier = [], [], [], {}
  args = ", ".join(_args(p_in))
  for g, (kind, vals, roles) in enumerate(stages):
    fn = f"{name}_s{g}"
    if kind == "serial":
      pr = _Printer(dz, True, earlier)
      for e in vals:
        pr.emit(e)
        pr.lines.append(f"  GEN_S({slots[e.id]}) = {pr.ref(e)};")
      out += ["", *_function(fn, p_in + ["scalar_t* s"], pr.lines,
                             "GEN_PHASE" if frame else "GEN_INLINE")]
      cases.append(f"if (r == 0) {fn}({args}, s);")
      store_cases.append("")
    else:
      out += _role_functions(fn, p_in + ["const scalar_t* s"], roles, dz,
                             earlier, ("scalar_t* s", "size_t ld",
                                       "const scalar_t* v"))
      out += _dispatch(f"{fn}_roles", p_in + ["const scalar_t* s",
                                              "scalar_t* v"],
                       lambda r, fn=fn: f"{fn}_r{r}", n_roles)
      out += _dispatch(f"{fn}_stores", ["scalar_t* s", "size_t ld",
                                        "const scalar_t* v"],
                       lambda r, fn=fn: f"{fn}_r{r}_store", n_roles)
      cases.append(f"{fn}_roles(r, {args}, s, v);")
      store_cases.append(f"{fn}_stores(r, s, ld, v);")
    earlier |= {e.id: slots[e.id] for e in vals}
  for fname, params, body in (
      ("stage", p_in + ["scalar_t* s", "scalar_t* v"], cases),
      ("stage_store", ["scalar_t* s", "size_t ld", "const scalar_t* v"],
       store_cases)):
    lines = ["  switch (g) {"]
    lines += [f"    case {g}: {c} break;" if c else f"    case {g}: break;"
              for g, c in enumerate(body)]
    lines += ["    default: break;", "  }"]
    out += ["", f"GEN_HD GEN_INLINE void {name}_{fname}(int g, int r, "
            f"{', '.join(params)}) {{", "  (void)r; " + " ".join(
                f"(void){n};" for n in _args(params)), *lines, "}"]
  out.append(f"constexpr int {name}_NSTAGES = {len(stages)};")
  return out


def _dispatch(name, params, fn, n_roles):
  """name(int r, params): the switch over the roles' functions fn_r{r}."""
  args = ", ".join(_args(params))
  lines = ["  switch (r) {"]
  lines += [f"    case {r}: {fn(r)}({args}); break;" for r in range(n_roles)]
  lines += ["    default: break;", "  }"]
  return ["", f"GEN_HD GEN_INLINE void {name}(int r, {', '.join(params)}) {{",
          *lines, "}"]


def _kind_dispatch(name, params, cases, var="ki"):
  """name(int ki, params): the switch over the units by the step's kind
  index (an epoch's: by the unit index var); cases[u] is unit u's call
  text."""
  lines = [f"  switch ({var}) {{"]
  lines += [f"    case {u}: {c} break;" for u, c in enumerate(cases)]
  lines += ["    default: break;", "  }"]
  return ["", f"GEN_HD GEN_INLINE void {name}(int {var}, "
          f"{', '.join(params)}) {{", *lines, "}"]


def _tile_source(body, pred, units, n_roles, mixed=False,
                 smem=None, slot_table=None, stream=False) -> list:
  """The lines after the header of a variant in tile form: the role
  functions of the predict and of each update unit, each unit's shared
  values and the dispatchers the template's tile loop calls, over n_roles
  roles. units: (C name, update Phase, dz, R offset, camera frame) of each
  unit in order (a unit repeated under the same R prints once); mode
  'single' and mode 'frame' have one. Without a camera frame each unit's
  shared values are one function that one role runs (mode 'single': it is
  gen_tile_shared itself); with one, every unit's are stages
  (stage_plan, _stage_functions). A mixed variant's update dispatchers
  switch on the step's kind index, then on the role, and pass unit u its
  R (R + its offset), as the global form's gen_step does. An epoch
  variant (slot_table given: (unit, z row, ea row, R offset) of each slot in
  order; units its distinct units) prints the same per-unit functions,
  dispatchers that switch on the unit index and pass their arguments
  through, and the slot table gen_slot(k) from which the template's epoch
  loop takes each slot's unit, rows and R. A log-scan variant (stream:
  mode 'stream', mixed, each unit's R the leading block of the step's
  staged R, offset 0) prints a mixed variant's functions for the
  template's REDNOSE_GENERIC_SCAN_STREAM tile loop. smem, when given: the
  block's shared memory bytes, named in the design line."""
  staged = any(u[4] for u in units)
  epoch = slot_table is not None
  funcs = {}
  for name, upd, dz, _, frame in units:
    if name not in funcs:
      stages, slots, nscr = stage_plan(upd, staged)
      funcs[name] = (dz, _split_stages(stages, slots, n_roles), slots, nscr,
                     role_split(upd, n_roles, frozenset(slots)), frame)
  pred_roles = role_split(pred, n_roles)
  nscr = max(f[3] for f in funcs.values())
  nval = max([len(o) for o in pred_roles]
             + [len(o) for f in funcs.values() for o in f[4]]
             + [len(o) for f in funcs.values() for st in f[1] if st[2]
                for o in st[2]] + [1])
  switched = (f", {len(units)} units switched on the step's kind"
              if mixed else "")
  if stream:
    switched += (", each step's inputs staged a step ahead and its x and P "
                 "stored from the tile after the predict and after the "
                 "update")
  if epoch:
    switched = (f", {len(slot_table)} slots of {len(units)} "
                f"unit{'s' if len(units) > 1 else ''}, each step's inputs "
                "staged a step ahead")
  size = f" ({smem:,} B a block)" if smem is not None else ""
  out = [f"// design: tile, {n_roles} roles{switched}: a block of "
         f"{TILE_LANES} filters x {n_roles} warps keeps P, x and {nscr} "
         f"scratch values a filter in shared memory{size}"] + body + [
      "#define GEN_X(i) x[(size_t)(i) * ld]",
      "#define GEN_S(k) s[(size_t)(k) * ld]",
      f"constexpr int NROLES = {n_roles};",
      f"constexpr int NSCR = {nscr};",
      f"constexpr int NVAL = {nval};",
  ]
  if epoch:
    out += [f"constexpr int NSLOTS = {len(slot_table)};",
            "// the slot table: slot k runs unit `unit` (the dispatchers' "
            "u) on the step's",
            "// z rows from `zrow` and ea rows from `earow`, with R + roff",
            "struct GenSlot { int unit, zrow, earow, roff; };",
            "GEN_HD GEN_INLINE GenSlot gen_slot(int k) {",
            "  switch (k) {",
            *[f"    case {k}: return {{{u}, {zr}, {er}, {ro}}};"
              for k, (u, zr, er, ro) in enumerate(slot_table)],
            "    default: return {0, 0, 0, 0};", "  }", "}"]
  p_pred = ["const scalar_t* x", "const scalar_t* P", "size_t ld",
            "const scalar_t dt", "const scalar_t* p", "const scalar_t* Q"]
  p_in = ["const scalar_t* x", "const scalar_t* P", "size_t ld",
          "const scalar_t* z", "const scalar_t* ea", "size_t ld_in",
          "const scalar_t* R", "const scalar_t* p"]
  p_upd = p_in + ["const scalar_t* s"]
  p_store = ["scalar_t* x", "scalar_t* P", "size_t ld", "const scalar_t* v"]
  p_stage = p_in + ["scalar_t* s", "scalar_t* v"]
  p_stage_store = ["scalar_t* s", "size_t ld", "const scalar_t* v"]
  out += _role_functions("gen_predict", p_pred, pred_roles, 0, {})
  for name, (dz, stages, slots, _, roles, frame) in funcs.items():
    if staged:
      out += ["", f"// {name}: the shared values, once a filter, in stages",
              *_stage_functions(name, p_in, stages, slots, n_roles, dz,
                                frame)]
    else:
      cuts = stages[0][1]                     # its one serial stage
      pr = _Printer(dz, True)
      for e in cuts:
        pr.emit(e)
      pr.lines += [f"  GEN_S({k}) = {pr.ref(e)};" for k, e in enumerate(cuts)]
      out += ["", f"// {name}: the shared values, once a filter",
              *_function(f"{name}_shared" if mixed or epoch
                         else "gen_tile_shared", p_in + ["scalar_t* s"],
                         pr.lines)]
    out += _role_functions(name, p_upd, roles, dz, slots)
    if mixed or epoch:
      out += _dispatch(f"{name}_update", p_upd + ["scalar_t* v"],
                       lambda r, n=name: f"{n}_r{r}", n_roles)
      out += _dispatch(f"{name}_update_store", p_store,
                       lambda r, n=name: f"{n}_r{r}_store", n_roles)
  out += _dispatch("gen_tile_predict", p_pred + ["scalar_t* v"],
                   lambda r: f"gen_predict_r{r}", n_roles)
  out += _dispatch("gen_tile_predict_store", p_store,
                   lambda r: f"gen_predict_r{r}_store", n_roles)

  def call(fn, params, u, lead=""):
    a = [f"R + {units[u][3]}" if v == "R" else v for v in _args(params)]
    return f"{fn}({lead}{', '.join(a)});"

  if epoch:
    for fn, params, lead in (
        ("shared", p_in + ["scalar_t* s"], ""),
        ("update", p_upd + ["scalar_t* v"], "r, "),
        ("update_store", p_store, "r, ")):
      out += _kind_dispatch(
          f"gen_tile_{fn}", ([] if not lead else ["int r"]) + params,
          [f"{u[0]}_{fn}({lead}{', '.join(_args(params))});" for u in units],
          "u")
  elif mixed:
    if staged:
      out += ["", "GEN_HD GEN_INLINE int gen_tile_nstages(int ki) {",
              "  switch (ki) {",
              *[f"    case {u}: return {n[0]}_NSTAGES;"
                for u, n in enumerate(units)],
              "    default: return 0;", "  }", "}"]
      out += _kind_dispatch("gen_tile_stage", ["int g", "int r"] + p_stage,
                            [call(f"{n[0]}_stage", p_stage, u, "g, r, ")
                             for u, n in enumerate(units)])
      out += _kind_dispatch("gen_tile_stage_store", ["int g", "int r"]
                            + p_stage_store, [
          f"{n[0]}_stage_store(g, r, {', '.join(_args(p_stage_store))});"
          for n in units])
    else:
      p_sh = p_in + ["scalar_t* s"]
      out += _kind_dispatch("gen_tile_shared", p_sh, [
          call(f"{u[0]}_shared", p_sh, i) for i, u in enumerate(units)])
    out += _kind_dispatch("gen_tile_update", ["int r"] + p_upd
                          + ["scalar_t* v"], [
        call(f"{u[0]}_update", p_upd + ["scalar_t* v"], i, "r, ")
        for i, u in enumerate(units)])
    out += _kind_dispatch("gen_tile_update_store", ["int r"] + p_store, [
        f"{u[0]}_update_store(r, {', '.join(_args(p_store))});"
        for u in units])
  else:
    name = units[0][0]
    if staged:
      out += ["", "GEN_HD GEN_INLINE int gen_tile_nstages() { return "
              f"{name}_NSTAGES; }}",
              "", "GEN_HD GEN_INLINE void gen_tile_stage(int g, int r, "
              f"{', '.join(p_stage)}) {{",
              f"  {call(f'{name}_stage', p_stage, 0, 'g, r, ')}", "}",
              "", "GEN_HD GEN_INLINE void gen_tile_stage_store(int g, int r, "
              f"{', '.join(p_stage_store)}) {{",
              f"  {name}_stage_store(g, r, "
              f"{', '.join(_args(p_stage_store))});", "}"]
    out += _dispatch("gen_tile_update", p_upd + ["scalar_t* v"],
                     lambda r: f"{name}_r{r}", n_roles)
    out += _dispatch("gen_tile_update_store", p_store,
                     lambda r: f"{name}_r{r}_store", n_roles)
  out += ["", "}  // namespace rn_gen", "",
          "#define REDNOSE_GENERIC_SCAN_TILE"]
  if mixed:
    out.append("#define REDNOSE_GENERIC_SCAN_TILE_KINDS")
  if epoch:
    out.append("#define REDNOSE_GENERIC_SCAN_TILE_EPOCH")
  if staged:
    out.append("#define REDNOSE_GENERIC_SCAN_TILE_STAGES")
  if stream:
    out.append("#define REDNOSE_GENERIC_SCAN_STREAM")
  out += ["#define REDNOSE_GENERIC_SCAN_LOOPS",
          '#include "generic_scan.cuh"', ""]
  return out


# ----------------------------------------------------------- variant source

MODES = ("single", "mixed", "epoch", "frame", "stream", "stream_adjoint")


def _unit_name(kind, gate, frame=False):
  return f"gen_{'frame' if frame else 'update'}_k{kind}{'_g' if gate else ''}"


def _r_text(r_pattern):
  return r_pattern if r_pattern == "iso" else list(r_pattern)


def emit_source(spec: FilterSpec, mode: str, units, structure, pnames,
                ps_keys=(), q_pattern=(), scalar="float",
                r_patterns=None, tile=True) -> str:
  """C++ source of one kernel variant.

  mode 'single' (kernel 4: one unit), 'mixed' (kernel 6: a switch over
  the units by the streamed kind index), 'epoch' (kernel 5: every unit in
  order, one slot each) or 'frame' (kernel 7: the MSCKF camera frame of
  one feature kind); each prints the tile form where it fits (tile_bytes),
  over TILE_ROLES_FRAME roles when a unit is a camera frame, else
  TILE_ROLES. Mode 'stream' (kernel 9, the offline log scan): each unit
  reads its R as the leading dz x dz block of the step's streamed
  max_dz x max_dz R; the tile form (its tile and two steps' staged inputs,
  stream_input_bytes, fit) is a mixed variant's role functions over
  TILE_ROLES_STREAM roles, the global form the predict and a switch over
  the units by the kind index (gen_stream_update); the template's
  REDNOSE_GENERIC_SCAN_STREAM sections store each step's predicted and
  posterior state between them. units: tuple of (kind, gate) pairs.
  A unit of an MSCKF feature kind is a camera frame (frame_phase: the
  projected update and the window augment); mode 'frame' is one such
  unit, and mode 'mixed' may hold them among its other units (kernel 6's
  camera-frame branch).
  pnames: the names of the params vector, in order; ps_keys: the streamed
  ones. q_pattern: the (i, j), i <= j, entries of Q that are nonzero.
  scalar: the C type of every value, 'float' or 'double'. r_patterns:
  aligned with units, for a feature unit "iso" (R = s^2 I) or R's nonzero
  (i, j), i <= j, and None for any other unit; None for no feature unit.
  tile: False prints the global form of a variant that would tile, with
  no design line (the whole phases, one function each). Mode
  'stream_adjoint' (kernel 10, the adjoint of mode 'stream') is printed by
  ops/adjoint.emit_source, in the global form only."""
  if mode not in MODES:
    raise ValueError(f"mode {mode!r} not in {MODES}")
  if mode == "stream_adjoint":
    from rednose_tpu_torch.ops import adjoint

    return adjoint.emit_source(spec, units, structure, pnames, q_pattern,
                               scalar)
  r_patterns = (tuple(r_patterns) if r_patterns is not None
                else (None,) * len(units))
  feature = [spec.obs[k].is_feature for k, _ in units]
  if len(r_patterns) != len(units) or any(
      (rp is not None) != f for rp, f in zip(r_patterns, feature)):
    raise ValueError("pass an R pattern for each feature unit and only "
                     f"for it: units {units}, r_patterns {r_patterns}")
  if mode == "frame" and (len(units) != 1 or not feature[0]):
    raise ValueError(f"mode 'frame' takes one feature unit, got {units}")
  if mode in ("single", "epoch", "stream") and any(feature):
    raise ValueError(f"mode {mode!r} takes no MSCKF feature kind: a camera "
                     "frame runs in mode 'frame' or 'mixed'")
  if scalar not in ("float", "double"):
    raise ValueError(f"scalar {scalar!r} is not 'float' or 'double'")
  kinds = [k for k, _ in units]
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  nzrows = max_dz * (len(units) if mode == "epoch" else 1)
  nearows = max_ea * (len(units) if mode == "epoch" else 1)
  r_off, off = [], 0
  for k, _ in units:
    r_off.append(off)
    off += spec.obs[k].dz ** 2
  ps_idx = [list(pnames).index(k) for k in ps_keys]
  # a camera frame's phases (the predict and each frame unit) are calls of
  # their own on the card (GEN_PHASE, csrc/generic_scan.cuh): its inlined
  # msckf_eskf body took ~70 s of nvcc; the other units stay inline
  has_frame = any(feature)
  inline = "GEN_PHASE" if has_frame else "GEN_INLINE"
  if mode == "frame":
    r_note = f", R {_r_text(r_patterns[0])}."
  elif has_frame:
    r_note = ", R " + "; ".join(
        f"unit {u} {_r_text(rp)}" for u, rp in enumerate(r_patterns)
        if rp is not None) + "."
  else:
    r_note = "."

  head = [
      "// Generated by rednose_tpu_torch/ops/entry_slab.py: do not edit.",
      f"// spec {spec.name!r}, mode {mode}, units (kind, gate) {list(units)},",
      f"// params {list(pnames)}, streamed {list(ps_keys)}" + r_note,
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
      f"constexpr int NPS = {len(ps_keys)};",
      "// index in p of the i-th streamed param",
      "GEN_HD GEN_INLINE int ps_idx(int i) {",
      f"  const int idx[{max(len(ps_idx), 1)}] = "
      f"{{{', '.join(str(i) for i in ps_idx) or '0'}}};",
      "  return idx[i];",
      "}",
      f"constexpr int NZROWS = {nzrows};",
      f"constexpr int NEAROWS = {nearows};",
      "",
      "#define GEN_P(i, j) P[(size_t)((i) * DE + (j)) * ld]",
      "",
  ]
  # one function per distinct (kind, gate, R pattern); a second R pattern
  # of the same feature kind and gate gets a suffix
  names, done = [], {}
  for (k, g), f, rp in zip(units, feature, r_patterns):
    if (k, g, rp) not in done:
      n = sum(1 for kk, gg, _ in done if (kk, gg) == (k, g))
      done[(k, g, rp)] = _unit_name(k, g, f) + (f"_r{n}" if n else "")
    names.append(done[(k, g, rp)])
  pred, phases = None, {}
  stream = mode == "stream"
  stored = ("one thread a lane, P in global memory; each step's x and P "
            "stored after the predict and after the update")
  if stream and not tile:
    head.append(f"// design: global: {stored}")
  if tile:
    # the tile form when 32 filters' P, x and the largest unit's scratch
    # (and an epoch's or a log's staged inputs) fit a block
    pred = predict_phase(spec, structure, pnames, q_pattern)
    for (k, g), f, rp, name in zip(units, feature, r_patterns, names):
      if name not in phases:
        phases[name] = (frame_phase(spec, k, structure, pnames, g, rp) if f
                        else update_phase(spec, k, structure, pnames, g))
    nbytes = max(tile_bytes(spec, ph, scalar, has_frame)
                 for ph in phases.values())
    if mode == "epoch":
      nbytes += epoch_input_bytes(nzrows, nearows, scalar)
    if stream:
      nbytes += stream_input_bytes(nzrows, nearows, scalar)
    if nbytes <= TILE_SMEM_MAX and mode == "epoch":
      # one unit per distinct (kind, gate), and the slots' table
      dz_of = {n: spec.obs[k].dz for n, (k, _) in zip(names, units)}
      distinct = list(phases)
      return "\n".join(head + _tile_source(
          body, pred, [(n, phases[n], dz_of[n], 0, False) for n in distinct],
          TILE_ROLES, smem=nbytes,
          slot_table=[(distinct.index(n), u * max_dz, u * max_ea, r_off[u])
                      for u, n in enumerate(names)]))
    elif nbytes <= TILE_SMEM_MAX and stream:
      # every unit reads the step's staged max_dz x max_dz R
      return "\n".join(head + _tile_source(
          body, pred, [(n, phases[n], max_dz, 0, False) for n in names],
          TILE_ROLES_STREAM, mixed=True, smem=nbytes, stream=True))
    elif nbytes <= TILE_SMEM_MAX:
      return "\n".join(head + _tile_source(
          body, pred, [(n, phases[n], spec.obs[k].dz, o, f) for n, (k, _), o, f
                       in zip(names, units, r_off, feature)],
          TILE_ROLES_FRAME if has_frame else TILE_ROLES,
          mixed=mode == "mixed", smem=nbytes if has_frame else None))
    head.append(
        f"// design: global: the tile of {TILE_LANES} filters ({nbytes:,} B "
        f"in {scalar}) exceeds the {TILE_SMEM_MAX:,} B a block may use, so "
        + (stored if stream else "one thread a filter and P in global "
           "memory"))
  out = head + body + [
      f"GEN_HD {inline} void gen_predict(scalar_t* x, scalar_t* P, "
      "size_t ld, const scalar_t dt, const scalar_t* p, const scalar_t* Q) {",
      "  (void)p; (void)Q;",
  ]
  out += print_phase(pred if pred is not None
                     else predict_phase(spec, structure, pnames, q_pattern))
  out.append("}")
  printed = set()
  for (k, g), f, rp, name in zip(units, feature, r_patterns, names):
    if name in printed:
      continue
    printed.add(name)
    out += [
        "",
        f"GEN_HD {'GEN_PHASE' if f else 'GEN_INLINE'} void {name}("
        "scalar_t* x, scalar_t* P, size_t ld, const scalar_t* z, "
        "const scalar_t* ea, size_t ld_in, const scalar_t* R, "
        "const scalar_t* p) {",
        "  (void)ea; (void)p; (void)R;",
    ]
    ph = (phases[name] if name in phases
          else frame_phase(spec, k, structure, pnames, g, rp) if f
          else update_phase(spec, k, structure, pnames, g))
    # a streamed R is the step's max_dz x max_dz matrix: its leading block
    out += print_phase(ph, max_dz if stream else spec.obs[k].dz)
    out.append("}")
  if stream:
    out += [
        "",
        "GEN_HD GEN_INLINE void gen_stream_update(scalar_t* x, scalar_t* P, "
        "size_t ld, const scalar_t* z, const scalar_t* ea, size_t ld_in, "
        "int ki, const scalar_t* R, const scalar_t* p) {",
        "  switch (ki) {"]
    out += [f"    case {u}: {names[u]}(x, P, ld, z, ea, ld_in, R, p); break;"
            for u in range(len(units))]
    out += ["    default: break;", "  }", "}", "", "}  // namespace rn_gen",
            "", "#define REDNOSE_GENERIC_SCAN_STREAM",
            "#define REDNOSE_GENERIC_SCAN_LOOPS",
            '#include "generic_scan.cuh"', ""]
    return "\n".join(out)
  out += [
      "",
      "GEN_HD GEN_INLINE void gen_step(scalar_t* x, scalar_t* P, size_t ld, "
      "const scalar_t* z, const scalar_t* ea, const scalar_t dt, int ki, "
      "const scalar_t* p, const scalar_t* Q, const scalar_t* R) {",
      "  (void)ki; (void)ea;",
      "  gen_predict(x, P, ld, dt, p, Q);",
  ]

  def call(u, zrow, earow):
    ea_arg = f"ea + (size_t){earow} * ld" if max_ea else "nullptr"
    return (f"{names[u]}(x, P, ld, z + (size_t){zrow} * ld, {ea_arg}, ld, "
            f"R + {r_off[u]}, p);")

  if mode in ("single", "frame"):
    out.append("  " + call(0, 0, 0))
  elif mode == "mixed":
    out.append("  switch (ki) {")
    for u in range(len(units)):
      out.append(f"    case {u}: {call(u, 0, 0)} break;")
    out += ["    default: break;", "  }"]
  else:
    for u in range(len(units)):
      out.append("  " + call(u, u * max_dz, u * max_ea))
  out += ["}", "", "}  // namespace rn_gen", "",
          "#define REDNOSE_GENERIC_SCAN_LOOPS",
          '#include "generic_scan.cuh"', ""]
  return "\n".join(out)


def q_pattern_of(Q) -> tuple:
  """The (i, j), i <= j, nonzero entries of a symmetric Q (host array)."""
  Q = np.asarray(Q, dtype=np.float64)
  if not np.array_equal(Q, Q.T):
    raise ValueError("process noise Q must be symmetric")
  return tuple((int(i), int(j)) for i, j in zip(*np.nonzero(np.triu(Q))))
