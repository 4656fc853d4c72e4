"""sympy front end: a FilterSpec from reference-style symbolic models.

Port of rednose_tpu/frontend/sympy_spec.py. The reference's filters are
defined in sympy and lowered to C by gen_code
(rednose/helpers/ekf_sym.py:29-217). This module takes that same input
surface and lowers it to torch functions with sympy.lambdify; the spec
then runs on every path of the port, with its Jacobians taken by
torch.func.jacfwd of the lowered functions (equal to the symbolic
Jacobians of ekf_sym.py:76-80).

Each matrix is lowered as the flat list of its entries, and the list is
put together with torch.stack: lambdify's own matrix printer builds the
result with torch.tensor(...), which copies its inputs out of the autograd
graph (jacfwd through it gives zeros without an error) and fixes the dtype
and device. A constant entry is broadcast with torch.full_like of the
state, so it takes the state's dtype and device and survives vmap and
jacfwd.

Input conventions (those of gen_code, ekf_sym.py:29-113):
  f_sym        sympy Matrix (dim_x, 1) in x_sym and dt_sym
  x_sym        MatrixSymbol (dim_x, 1), or any iterable of scalar Symbols
  obs_eqs      list of [h_sym, kind, ea_sym] (ea_sym None for plain kinds)
  eskf_params  ([err_expr, nom_x, delta_x], [inv_err_expr, nom_x, true_x],
                H_mod_sym, f_err_sym, x_err_sym)
  msckf_params (dim_main, dim_augment, dim_main_err, dim_augment_err, N,
                feature_track_kinds)
  global_vars  scalar Symbols, runtime-settable params (the reference's C
               globals and set_<name>, ekf_sym.py:129-132), default 0.0
  extra_routines  [(name, expr, [arg_syms]), ...] (ekf_sym.py:109-113)
"""

from __future__ import annotations

from typing import Sequence

import sympy as sp
import torch

from rednose_tpu_torch.core.spec import (
    FilterSpec,
    ObservationModel,
    ParamsRoutine,
)


def _sym_args(sym):
  """One lambdify argument: a scalar Symbol stays itself (shape None); a
  MatrixSymbol or Matrix of symbols passes through with its (r, c); any
  other iterable of symbols becomes a tuple taking a flat vector (n, 0)."""
  if isinstance(sym, sp.Symbol):
    return sym, None
  if hasattr(sym, "shape"):
    r, c = (int(d) for d in sym.shape)
    return sym, (r, c)
  seq = tuple(sym)
  return seq, (len(seq), 0)


def _lambdify(arg_syms, expr, global_syms, ravel_out: bool):
  """Lower `expr` (a sympy matrix) to a torch function of a params mapping
  holding the global_vars (by name) and the positional arguments."""
  norm = [_sym_args(s) for s in arg_syms]
  M = sp.Matrix(expr)
  out_shape = (-1,) if ravel_out else tuple(int(d) for d in M.shape)
  lam = sp.lambdify([s for s, _ in norm] + list(global_syms), list(M),
                    modules="torch")
  shapes = [shape for _, shape in norm]
  names = [g.name for g in global_syms]

  def fn(params, *args):
    vals, ref = [], None
    for a, shape in zip(args, shapes):
      if not torch.is_tensor(a):
        a = torch.as_tensor(a)
      if ref is None and a.is_floating_point():
        ref = a.reshape(-1)[0]
      if shape is None:
        vals.append(a)
      elif shape[1] == 0:   # tuple-of-symbols argument: a flat vector
        vals.append(a.reshape(shape[0]))
      else:
        vals.append(a.reshape(shape))
    out = lam(*vals, *(params[n] for n in names))
    if ref is None:
      ref = next((v for v in out if torch.is_tensor(v)),
                 torch.zeros((), dtype=torch.get_default_dtype()))
    entries = [v.to(ref.dtype) if torch.is_tensor(v)
               else torch.full_like(ref, float(v)) for v in out]
    return torch.stack(entries).reshape(out_shape)

  return fn


def spec_from_sympy(name, f_sym, dt_sym, x_sym, obs_eqs, dim_x, dim_err,
                    eskf_params=None, msckf_params=None,
                    maha_test_kinds: Sequence[int] = (),
                    quaternion_idxs: Sequence[int] = (),
                    global_vars=None, extra_routines=()) -> FilterSpec:
  """gen_code's input surface (ekf_sym.py:29-30) -> FilterSpec."""
  gv = tuple(global_vars or ())
  default_params = {g.name: 0.0 for g in gv}  # C globals default to 0.0

  lam_f = _lambdify([x_sym, dt_sym], f_sym, gv, ravel_out=True)
  kwargs = {}
  if eskf_params is not None:
    err_eqs, inv_err_eqs, H_mod_sym, f_err_sym, x_err_sym = eskf_params
    kwargs = dict(
        err=_lambdify([err_eqs[1], err_eqs[2]], err_eqs[0], gv, True),
        inv_err=_lambdify([inv_err_eqs[1], inv_err_eqs[2]], inv_err_eqs[0],
                          gv, True),
        H_mod=_lambdify([x_sym], H_mod_sym, gv, False),
        f_err=_lambdify([x_sym, x_err_sym, dt_sym], f_err_sym, gv, True))

  if msckf_params is not None:
    (dim_main, dim_augment, dim_main_err, dim_augment_err, n_augment,
     feature_track_kinds) = msckf_params
  else:
    dim_main, dim_main_err = dim_x, dim_err
    dim_augment = dim_augment_err = n_augment = 0
    feature_track_kinds = ()

  obs = {}
  for entry in obs_eqs:
    h_sym, kind, ea_sym = entry[0], int(entry[1]), entry[2]
    if ea_sym is not None:
      h = _lambdify([x_sym, ea_sym], h_sym, gv, ravel_out=True)
      # ea_len sizes every extra-args placeholder; ea_dim (the projected
      # dims) is for feature kinds only: the loc_kf pseudorange family
      # passes extra args to non-feature kinds (ekf_sym.py:84-89)
      ea_len = int(ea_sym.shape[0])
      ea_dim = ea_len if kind in tuple(feature_track_kinds) else 0
    else:
      lam_h = _lambdify([x_sym], h_sym, gv, ravel_out=True)
      h = (lambda lh: lambda params, x, ea: lh(params, x))(lam_h)
      ea_dim = ea_len = 0
    obs[kind] = ObservationModel(
        kind=kind, h=h, dz=int(h_sym.shape[0]), ea_dim=ea_dim, ea_len=ea_len,
        maha_test=kind in tuple(maha_test_kinds))

  # a ParamsRoutine: the engine applies its current params at each call,
  # so set_global updates reach the routine (the reference's generated
  # routines read the live C globals)
  routines = {rname: ParamsRoutine(_lambdify(arg_syms, expr, gv,
                                             ravel_out=expr.shape[1] == 1))
              for rname, expr, arg_syms in extra_routines}

  return FilterSpec(
      name=name,
      dim_x=int(dim_x),
      dim_err=int(dim_err),
      f=lam_f,
      obs=obs,
      quaternion_idxs=tuple(quaternion_idxs),
      dim_main=int(dim_main),
      dim_main_err=int(dim_main_err),
      dim_augment=int(dim_augment),
      dim_augment_err=int(dim_augment_err),
      n_augment=int(n_augment),
      default_params=default_params,
      extra_routines=routines,
      **kwargs,
  )
