"""Declarative filter specification.

Port of rednose_tpu/core/spec.py. A filter is a set of plain torch
functions; the Jacobians come from torch.func.jacfwd, as the JAX package
takes them from jax.jacfwd (the reference derives them symbolically with
sympy, rednose/helpers/ekf_sym.py:76-89).

Canonical function signatures (params is a mapping of runtime-tunable
values, the reference's mutable C globals, ekf_sym.py:129-132):

  f(params, x, dt)          -> x_new          state propagation (dim_x,)
  f_err(params, x, dx, dt)  -> dx_new         error-state propagation (dim_err,)
  h(params, x, ea)          -> z_pred         observation model (dz,)
  err(params, x, dx)        -> x_true         error injection (dim_x,)
  inv_err(params, nom, tru) -> dx             error extraction (dim_err,)
  H_mod(params, x)          -> (dim_x, dim_err) ESKF observation-matrix modifier

Model functions must be functional (torch.stack / torch.cat, no in-place
writes into their inputs) so that jacfwd and vmap can trace them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch
from torch.func import jacfwd

from rednose_tpu_torch.utils.chi2 import chi2_ppf


@dataclasses.dataclass(frozen=True)
class ObservationModel:
  """One observation kind (reference: ekf_sym.py:84-89, one
  [h_sym, kind, ea_sym] triple)."""

  kind: int
  h: Callable  # h(params, x, ea) -> (dz,)
  dz: int
  # >0 marks an MSCKF feature-track kind whose update projects the
  # feature-position error out (He = dh/dea, ekf_sym.py:86-87)
  ea_dim: int = 0
  # length of the extra-args vector h() expects (None -> ea_dim)
  ea_len: int | None = None
  # Mahalanobis outlier gate (reference: maha_test_kinds + baked chi2
  # threshold, ekf_sym.py:144-152)
  maha_test: bool = False
  maha_thresh: float | None = None

  def __post_init__(self):
    if self.maha_thresh is None:
      # baked from the unprojected observation dim (ekf_sym.py:144)
      object.__setattr__(self, "maha_thresh", chi2_ppf(0.95, self.dz))
    if self.ea_len is None:
      object.__setattr__(self, "ea_len", self.ea_dim)
    if self.ea_len < self.ea_dim:
      raise ValueError(f"ea_len {self.ea_len} < ea_dim {self.ea_dim}")

  @property
  def is_feature(self) -> bool:
    return self.ea_dim > 0


class ParamsRoutine:
  """An extra routine that takes the engine's params as its first argument.

  FilterEngine.get_extra_routine applies the engine's *current* params at
  every call, so set_global updates reach it, as the reference's generated
  routines read the live C globals (ekf_sym.py:109-113, 129-132). Plain
  callables in extra_routines are returned as they are."""

  __slots__ = ("fn",)

  def __init__(self, fn):
    self.fn = fn

  def __call__(self, params, *args):
    return self.fn(params, *args)


def _default_err(params, x, dx):
  del params
  return x + dx


def _default_inv_err(params, nom_x, true_x):
  del params
  return true_x - nom_x


@dataclasses.dataclass(frozen=True, eq=False)
class FilterSpec:
  """Complete declarative description of one (E|MSC)KF (reference gen_code
  signature, ekf_sym.py:29-30, plus the EKF_sym dims, ekf_sym.py:221-222)."""

  name: str
  dim_x: int
  dim_err: int
  f: Callable  # f(params, x, dt) -> (dim_x,)
  obs: Mapping[int, ObservationModel]

  # ESKF (None => additive error state, identity H_mod; ekf_sym.py:42-53)
  err: Callable = _default_err
  inv_err: Callable = _default_inv_err
  H_mod: Callable | None = None  # H_mod(params, x) -> (dim_x, dim_err)
  f_err: Callable | None = None  # error dynamics; F = d f_err / d dx at dx=0
  quaternion_idxs: Sequence[int] = ()

  # optional closed-form lane-major F: F_lane(params, x (dim_x, *b), dt
  # scalar or (*b)) -> (de, de, *b), equal to F; the smoother's gains pass
  # takes it in place of a jacfwd per step
  F_lane: Callable | None = None

  # MSCKF sliding-window dims (msckf_params, ekf_sym.py:57-66)
  dim_main: int | None = None
  dim_main_err: int | None = None
  dim_augment: int = 0
  dim_augment_err: int = 0
  n_augment: int = 0

  # default runtime-tunable params (the reference's global_vars)
  default_params: Any = dataclasses.field(default_factory=dict)

  # named auxiliary functions shipped with the filter (gen_code's
  # extra_routines, ekf_sym.py:109-113; EKFSym::get_extra_routine,
  # ekf_sym.cc:221-223)
  extra_routines: Mapping[str, Callable] = dataclasses.field(
      default_factory=dict)

  def __post_init__(self):
    if self.dim_main is None:
      object.__setattr__(self, "dim_main", self.dim_x)
    if self.dim_main_err is None:
      object.__setattr__(self, "dim_main_err", self.dim_err)
    if (self.dim_main + self.dim_augment * self.n_augment != self.dim_x
        or self.dim_main_err + self.dim_augment_err * self.n_augment
        != self.dim_err):
      raise ValueError(f"inconsistent MSCKF dims in spec {self.name!r}")
    object.__setattr__(self, "obs", dict(self.obs))

  @property
  def is_eskf(self) -> bool:
    return self.H_mod is not None

  @property
  def is_msckf(self) -> bool:
    return self.n_augment > 0

  # The Jacobians are cast to x's dtype: under jacfwd, a python float
  # times a 0-d tensor (x[i] * 1.2e5) can come out float64 for a float32 x.

  def F(self, params, x, dt):
    """State-transition Jacobian d f_err / d dx at dx=0 (ESKF), else d f / d x
    (the autodiff form of ekf_sym.py:76-80)."""
    if self.f_err is not None:
      zeros = torch.zeros(self.dim_err, dtype=x.dtype, device=x.device)
      F = jacfwd(lambda dx: self.f_err(params, x, dx, dt))(zeros)
    else:
      F = jacfwd(lambda xx: self.f(params, xx, dt))(x)
    return F.to(x.dtype)

  def H(self, kind: int, params, x, ea):
    """Observation Jacobian H = dh/dx (ekf_sym.py:85)."""
    return jacfwd(lambda xx: self.obs[kind].h(params, xx, ea))(x).to(x.dtype)

  def He(self, kind: int, params, x, ea):
    """Feature-position Jacobian He = dh/dea (ekf_sym.py:86-87)."""
    return jacfwd(lambda e: self.obs[kind].h(params, x, e))(ea).to(x.dtype)

  def H_mod_at(self, params, x):
    if self.H_mod is None:
      return torch.eye(self.dim_x, self.dim_err, dtype=x.dtype,
                       device=x.device)
    return self.H_mod(params, x)
