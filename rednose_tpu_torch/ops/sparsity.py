"""Automatic structural-sparsity detection for generic filter banks.

Port of rednose_tpu/ops/sparsity.py without the masked slab products (a
measured dead end, PARITY.md). The reference gets structural-zero
elimination from sympy (rednose/helpers/ekf_sym.py:76-89); here the
spec's jacfwd Jacobians are sampled at randomly perturbed states and
params on the host in float64 (a structural zero of an autodiff Jacobian
is exactly 0.0 at every point), the union nonzero pattern is taken, and
held-out samples verify it: any violation raises StructureError.

The pattern drives the CUDA emitter (ops/entry_slab.py): F P F^T is
accumulated over the columns where G = F - I is nonzero (`g_cols`), and
each kind's update over the nonzero columns of its composed
H_err = H @ H_mod (`cols_for`). The composed-H shortcut: H_err equals the
Jacobian of h(err(x, dx)) in dx at dx = 0 whenever H_mod = d err/d dx;
detect_structure checks that identity against the spec's own H_mod.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec

Cols = tuple  # tuple[int, ...]


class StructureError(ValueError):
  """Raised when a detected sparsity pattern fails held-out verification."""


@dataclasses.dataclass(frozen=True)
class SpecStructure:
  """Static, hashable sparsity description.

  f_rows[i] is the tuple of columns k with F[i, k] structurally nonzero;
  h_cols maps kind -> the structurally nonzero columns of the composed
  H_err = H @ H_mod (dz, dim_err); g_cols are the columns where
  G = F - I is nonzero."""

  f_rows: tuple
  h_cols: tuple  # tuple[tuple[int, Cols], ...] sorted by kind
  g_cols: Cols = ()

  def cols_for(self, kind: int) -> Cols:
    for k, cols in self.h_cols:
      if k == kind:
        return cols
    raise KeyError(f"kind {kind} not in detected structure")


def dense_structure(spec: FilterSpec) -> SpecStructure:
  """Every column nonzero: the structure of a spec whose pattern could not
  be detected (the emitter then writes the dense body). An MSCKF spec's G
  stays in the main block, which is all its block predict propagates."""
  de = spec.dim_err
  every = tuple(range(de))
  return SpecStructure(f_rows=(every,) * de,
                       h_cols=tuple((k, every) for k in sorted(spec.obs)),
                       g_cols=tuple(range(spec.dim_main_err)))


def _t64(a):
  return torch.as_tensor(np.asarray(a, dtype=np.float64))


def sample_states(spec: FilterSpec, x0, n: int, seed: int = 0,
                  rel: float = 0.1, absolute: float = 0.1) -> np.ndarray:
  """n plausible states: x0 perturbed multiplicatively and additively (so
  both ECEF-scale and zero entries move), quaternions renormalized."""
  rng = np.random.RandomState(seed)
  x0 = np.asarray(x0, dtype=np.float64)
  xs = x0[None] * (1.0 + rel * rng.randn(n, x0.shape[0]))
  xs = xs + absolute * rng.randn(n, x0.shape[0])
  for idx in spec.quaternion_idxs:
    q = xs[:, idx:idx + 4]
    xs[:, idx:idx + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
  return xs


def perturb_params(params, rng, rel: float = 0.1, absolute: float = 0.5):
  """Randomly perturb every floating value of a params mapping, returned as
  0-d float64 tensors (array values as tensors of their shape). A
  params-dependent F / H entry that is zero at the caller's params (a
  global still at its 0.0 default) must still count as nonzero: the
  structure is applied at whatever params a later set_global gives."""
  out = {}
  for k in sorted(params):
    arr = np.asarray(params[k])
    if np.issubdtype(arr.dtype, np.floating):
      out[k] = _t64(arr * (1.0 + rel * rng.randn(*arr.shape))
                    + absolute * rng.randn(*arr.shape))
    else:
      out[k] = params[k]
  return out


def composed_h_jvp(spec: FilterSpec, kind: int, params, x, cols: Cols,
                   ea=None):
  """h(x) and the requested columns of d h(err(x, dx))/d dx at dx = 0, by
  one torch.func.jvp per column (unbatched x). Returns (h (dz,),
  [column (dz,)])."""
  om = spec.obs[kind]
  if ea is None:
    if om.ea_len:
      raise ValueError(f"kind {kind} takes {om.ea_len} extra args; pass ea=")
    ea = torch.zeros((1,), dtype=x.dtype)
  zero = torch.zeros((spec.dim_err,), dtype=x.dtype)

  def fn(dd):
    return om.h(params, spec.err(params, x, dd), ea)

  out = []
  h = fn(zero)
  for c in cols:
    e = torch.zeros_like(zero)
    e[c] = 1.0
    out.append(torch.func.jvp(fn, (zero,), (e,))[1])
  return h, out


def f_columns(spec: FilterSpec, params, x, dt, cols: Cols):
  """Selected columns of F = d f_err / d dx at dx = 0 (additive specs:
  d f / d x). Returns {col: (dim_err,) column}."""
  de = spec.dim_err
  zero = torch.zeros((de,), dtype=x.dtype)
  if spec.f_err is not None:
    fn = lambda dd: spec.f_err(params, x, dd, dt)  # noqa: E731
  else:
    if de != spec.dim_x:
      raise ValueError("additive spec with dim_err != dim_x")
    fn = lambda dd: spec.f(params, x + dd, dt)  # noqa: E731
  out = {}
  for c in cols:
    e = torch.zeros_like(zero)
    e[c] = 1.0
    out[c] = torch.func.jvp(fn, (zero,), (e,))[1]
  return out


def _dense_h_err(spec: FilterSpec, kind: int, params, x, ea=None):
  """The composed Jacobian H @ H_mod through the spec's own H_mod (what
  core/step.update computes)."""
  om = spec.obs[kind]
  if ea is None:
    ea = torch.zeros((max(om.ea_len, 1),), dtype=x.dtype)
  H = spec.H(kind, params, x, ea)
  if spec.is_eskf:
    H = H @ spec.H_mod_at(params, x)
  return H


def detect_structure(spec: FilterSpec, x0, kinds=None, params=None,
                     n_detect: int = 4, n_verify: int = 2, seed: int = 0,
                     dts=(0.013, 0.17), consistency_tol: float = 1e-5):
  """Detect and verify the structural sparsity of F and of every kind's
  composed H (same samples, checks and errors as the JAX package).

  x0: a representative state; samples are random perturbations of it.
  kinds defaults to every kind without extra args; kinds with extra args
  are detected with randomly sampled ones. Raises StructureError if a
  held-out sample contradicts the pattern, or if the spec's H_mod is
  inconsistent with d err/d dx."""
  if params is None:
    params = spec.default_params
  if kinds is None:
    kinds = tuple(sorted(k for k, om in spec.obs.items() if om.ea_len == 0))
  if any(spec.obs[k].ea_len for k in kinds):
    raise ValueError("explicit kinds= must take no extra args; kinds with "
                     f"extra args are detected automatically: {kinds}")
  de = spec.dim_err

  xs = sample_states(spec, x0, n_detect + n_verify, seed=seed)
  xs_det, xs_ver = xs[:n_detect], xs[n_detect:]
  prng = np.random.RandomState(seed + 0x5EED)
  ps_det = [perturb_params(params, prng) for _ in xs_det]
  ps_ver = [perturb_params(params, prng) for _ in xs_ver]

  def F_at(p, x, dt):
    return spec.F(p, _t64(x), _t64(dt)).numpy()

  eye = np.eye(de)
  f_mask = np.zeros((de, de), dtype=bool)
  g_mask = np.zeros((de, de), dtype=bool)
  for p, x in zip(ps_det, xs_det):
    for dt in dts:
      F = F_at(p, x, float(dt))
      f_mask |= F != 0.0
      g_mask |= (F - eye) != 0.0
  for p, x in zip(ps_ver, xs_ver):
    for dt in dts:
      F = F_at(p, x, float(dt))
      bad = ((F != 0.0) & ~f_mask) | (((F - eye) != 0.0) & ~g_mask)
      if bad.any():
        ij = np.argwhere(bad)[:8].tolist()
        raise StructureError(
            f"F entries {ij} nonzero on held-out samples but zero on all "
            f"detection samples; pass more/better samples (x0, n_detect)")
  # an MSCKF block predict propagates the main block only (ekf_c.c:17-29;
  # JAX entry_slab.py:178-180)
  outside = np.argwhere(g_mask)
  outside = outside[(outside >= spec.dim_main_err).any(axis=1)]
  if len(outside):
    raise StructureError(
        f"spec {spec.name!r}: G = F - I is nonzero outside the main block "
        f"at {outside[:8].tolist()}; the clone states of an MSCKF spec "
        "must be static")
  f_rows = tuple(tuple(int(k) for k in np.nonzero(f_mask[i])[0])
                 for i in range(de))
  g_cols = tuple(int(k) for k in np.nonzero(g_mask.any(axis=0))[0])

  h_cols = []
  for kind in kinds:
    mask = np.zeros((de,), dtype=bool)
    for p, x in zip(ps_det, xs_det):
      mask |= (_dense_h_err(spec, kind, p, _t64(x)).numpy() != 0.0).any(axis=0)
    cols = tuple(int(c) for c in np.nonzero(mask)[0])
    for p, x in zip(ps_ver, xs_ver):
      Hd = _dense_h_err(spec, kind, p, _t64(x)).numpy()
      bad = (Hd != 0.0).any(axis=0) & ~mask
      if bad.any():
        raise StructureError(
            f"kind {kind}: H_err columns {np.nonzero(bad)[0].tolist()} "
            f"nonzero on held-out samples but missed by detection")
      # composed-H shortcut: the jvp through err must reproduce the spec's
      # H @ H_mod on the detected columns
      _, hc = composed_h_jvp(spec, kind, p, _t64(x), cols)
      for c, col in zip(cols, hc):
        ref = Hd[:, c]
        if not np.allclose(col.numpy(), ref, rtol=consistency_tol,
                           atol=consistency_tol * max(1.0,
                                                      np.abs(ref).max())):
          raise StructureError(
              f"kind {kind}: spec H_mod is inconsistent with d err/d dx at "
              f"column {c}; the composed-H emitter would diverge from "
              f"core/step semantics for this spec")
    h_cols.append((int(kind), cols))

  # extra-args kinds (the pseudorange family and MSCKF feature tracks):
  # column support with randomly sampled extra args (the jvp identity is
  # verified through the ea-free kinds above)
  frng = np.random.RandomState(seed + 0xFEA7)
  for kind, om in sorted(spec.obs.items()):
    if om.ea_len == 0:
      continue
    mask = np.zeros((de,), dtype=bool)
    for p, x in zip(ps_det, xs_det):
      ea = _t64(frng.randn(om.ea_len))
      Hd = _dense_h_err(spec, kind, p, _t64(x), ea).numpy()
      mask |= (Hd != 0.0).any(axis=0)
    cols = tuple(int(c) for c in np.nonzero(mask)[0])
    for p, x in zip(ps_ver, xs_ver):
      ea = _t64(frng.randn(om.ea_len))
      Hd = _dense_h_err(spec, kind, p, _t64(x), ea).numpy()
      bad = (Hd != 0.0).any(axis=0) & ~mask
      if bad.any():
        raise StructureError(
            f"extra-args kind {kind}: H_err columns "
            f"{np.nonzero(bad)[0].tolist()} nonzero on held-out samples "
            f"but missed by detection")
    h_cols.append((int(kind), cols))

  return SpecStructure(f_rows=f_rows, h_cols=tuple(h_cols), g_cols=g_cols)


_structure_cache: dict = {}


def structure_for(spec: FilterSpec, x0, kinds=None, **kw) -> SpecStructure:
  """Cached detect_structure: one detection per (spec, x0, kinds); specs
  hash by identity."""
  key = (spec, tuple(float(v) for v in np.asarray(x0).ravel()), kinds,
         tuple(sorted(kw.items())))
  if key not in _structure_cache:
    _structure_cache[key] = detect_structure(spec, x0, kinds=kinds, **kw)
  return _structure_cache[key]
