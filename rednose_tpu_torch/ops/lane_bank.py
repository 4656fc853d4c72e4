"""Lane-major generic filter banks: the plain versions of kernels 4-6.

Port of rednose_tpu/ops/lane_bank.py, non-MSCKF part. A bank of B filters
of ANY spec keeps its covariances as (d, d, B) with the bank axis last;
each step vmaps the spec's own f / h / err over the bank and takes the
Jacobians densely with torch.func.jacfwd. Semantics are core/step.py's:
F P F^T, innovation, ESKF H·H_mod, the Mahalanobis zero-gain gate, the
closed-form S^-1 for dz <= 3, the Joseph form and error injection; the
covariance algebra is the one the kernels (and the JAX package's
structured lane path) use: F = I + G with P' = P + (V + V^T), and the
factored Joseph P' = P + (W + W^T), both exactly symmetric.

`lane_bank_scan`, `lane_mixed_bank_scan` and `lane_epoch_bank_scan` are
the plain torch versions of the generic CUDA kernels (ops/generic_scan.py):
the wrappers run them for CPU tensors, and the tests and chip_smoke.py
hold the kernels against them. Layout as in the JAX package: x (B, dim_x),
P (de, de, B), zs (T, B, dz). The masked products, the Cholesky /
Householder solves and augment_slab wait for the MSCKF slice.

Runtime params: a mapping of name -> float or 0-d tensor (the reference's
global_vars, ekf_sym.py:129-132); with ps_keys / pss each step's params are
`params` overlaid with that step's row of pss (T, len(ps_keys)).
"""

from __future__ import annotations

import torch
from torch.func import vmap

from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops.quaternion import normalize_slices


def _inv_small(S):
  """Closed-form inverse of (d, d, B) for d <= 3 (adjugate), on lanes — the
  replacement of the reference's Eigen LU (ekf_c.c:101)."""
  d = S.shape[0]
  if d == 1:
    return 1.0 / S
  if d == 2:
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    row0 = torch.stack([S[1, 1], -S[0, 1]])
    row1 = torch.stack([-S[1, 0], S[0, 0]])
    return torch.stack([row0, row1]) / det
  if d == 3:
    c = [[S[1, 1] * S[2, 2] - S[1, 2] * S[2, 1],
          S[0, 2] * S[2, 1] - S[0, 1] * S[2, 2],
          S[0, 1] * S[1, 2] - S[0, 2] * S[1, 1]],
         [S[1, 2] * S[2, 0] - S[1, 0] * S[2, 2],
          S[0, 0] * S[2, 2] - S[0, 2] * S[2, 0],
          S[0, 2] * S[1, 0] - S[0, 0] * S[1, 2]],
         [S[1, 0] * S[2, 1] - S[1, 1] * S[2, 0],
          S[0, 1] * S[2, 0] - S[0, 0] * S[2, 1],
          S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]]]
    det = S[0, 0] * c[0][0] + S[0, 1] * c[1][0] + S[0, 2] * c[2][0]
    return torch.stack([torch.stack(row) for row in c]) / det
  raise NotImplementedError(f"closed-form inverse only for d<=3, got {d}")


def _mm(A, B_):
  """(m, k, B) @ (k, n, B) -> (m, n, B)."""
  return torch.einsum('mkb,knb->mnb', A, B_)


def _mm_t(A, B_):
  """(m, k, B) @ (n, k, B)^T -> (m, n, B)."""
  return torch.einsum('mkb,nkb->mnb', A, B_)


def _no_msckf(spec):
  if spec.dim_main_err != spec.dim_err:
    raise NotImplementedError(
        "MSCKF block specs come with the port's MSCKF slice")


def _normalize(spec, x):
  if not spec.quaternion_idxs:
    return x
  return vmap(lambda xx: normalize_slices(xx, spec.quaternion_idxs))(x)


def lane_predict(spec: FilterSpec, params, x, P, Q, dt):
  """Bank predict: x (B, dim_x), P (de, de, B); x <- f(x, dt),
  P <- F P F^T + dt Q (ekf_c.c:8-33), assembled as the kernels do:
  F = I + G, M = G P, V = M + (M G^T) / 2, P' = P + (V + V^T) (exactly
  symmetric; the JAX package's fpf_masked algebra, here dense)."""
  _no_msckf(spec)
  x_new = vmap(lambda xx: spec.f(params, xx, dt))(x)
  F = vmap(lambda xx: spec.F(params, xx, dt), out_dims=2)(x)
  G = F - torch.eye(spec.dim_err, dtype=F.dtype, device=F.device)[:, :, None]
  M = _mm(G, P)
  V = M + 0.5 * _mm_t(M, G)
  P_new = P + (V + V.transpose(0, 1)) + (dt * Q)[:, :, None]
  return _normalize(spec, x_new), P_new


def lane_update(spec: FilterSpec, kind: int, params, x, P, z, R, ea=None,
                gate: bool | None = None):
  """Bank update: z (B, dz), R (dz, dz) shared or (dz, dz, B), ea
  (B, ea_len) for extra-args kinds. gate None gates as the kind's
  maha_test says (the reference); True / False force it on / off, as the
  generic kernels' flag does. Returns (x, P, y (B, dz))."""
  om = spec.obs[kind]
  if om.is_feature:
    raise NotImplementedError(
        "MSCKF feature-kind updates come with the port's MSCKF slice")
  if (ea is None) != (om.ea_len == 0):
    raise ValueError(f"kind {kind} ea_len={om.ea_len}: pass ea (B, ea_len) "
                     "iff the kind takes extra args")
  dz, de = om.dz, spec.dim_err
  gate = om.maha_test if gate is None else gate
  if R.ndim == 2:
    R = R[:, :, None]
  if ea is None:
    ea0 = torch.zeros((max(om.ea_len, 1),), dtype=x.dtype, device=x.device)
    h = vmap(lambda xx: om.h(params, xx, ea0), out_dims=1)(x)
    H = vmap(lambda xx: spec.H(kind, params, xx, ea0), out_dims=2)(x)
  else:
    h = vmap(lambda xx, ee: om.h(params, xx, ee), out_dims=1)(x, ea)
    H = vmap(lambda xx, ee: spec.H(kind, params, xx, ee), out_dims=2)(x, ea)
  if spec.is_eskf:
    H = _mm(H, vmap(lambda xx: spec.H_mod_at(params, xx), out_dims=2)(x))
  y = z.T - h                                     # (dz, B)
  PHt = _mm_t(P, H)                               # (de, dz, B)
  S = _mm(H, PHt) + R
  Sinv = _inv_small(S)
  K = _mm(PHt, Sinv)                              # (de, dz, B)
  if gate:
    # zero gain: the exact R -> inf limit of the reference's 1e16 R
    # inflation (ekf_c.c:88-94); a NaN distance does not gate
    dist = sum(y[i] * Sinv[i, j] * y[j] for i in range(dz) for j in range(dz))
    K = torch.where(dist[None, None, :] > om.maha_thresh,
                    torch.zeros_like(K), K)
  dx = sum(K[:, i, :] * y[i][None, :] for i in range(dz))    # (de, B)
  # Joseph form (I - KH) P (I - KH)^T + K R K^T, factored as the kernels
  # compute it: P + (W + W^T), W = K (S K^T / 2 - HP), exactly symmetric
  W = _mm(K, 0.5 * _mm_t(S, K) - PHt.transpose(0, 1))
  P_new = P + (W + W.transpose(0, 1))
  x_new = vmap(lambda xx, d: spec.err(params, xx, d))(x, dx.T)
  return _normalize(spec, x_new), P_new, y.T


def _step_params(params, ps_keys, ps_row):
  if ps_row is None:
    return params
  return {**params, **{k: ps_row[i] for i, k in enumerate(ps_keys)}}


def _check_streams(T, eas, need_ea, ps_keys, pss):
  if (eas is None) == need_ea:
    raise ValueError("pass eas iff a kind of the scan takes extra args")
  if (pss is None) != (len(ps_keys) == 0):
    raise ValueError("pass pss (T, len(ps_keys)) iff ps_keys is non-empty")
  if pss is not None and tuple(pss.shape) != (T, len(ps_keys)):
    raise ValueError(f"pss {tuple(pss.shape)}, expected ({T}, {len(ps_keys)})")


def lane_bank_scan(spec: FilterSpec, kind: int, params, x, P, Q, dts, zs,
                   R, eas=None, ps_keys=(), pss=None,
                   gate: bool | None = None):
  """T fused predict + update steps of one kind over a lane-major bank.

  x (B, dim_x), P (de, de, B), dts (T,), zs (T, B, dz), R (dz, dz); eas
  (T, B, ea_len) for extra-args kinds; ps_keys / pss per-step params.
  gate as in lane_update. Returns the final (x, P)."""
  _check_streams(dts.shape[0], eas, spec.obs[kind].ea_len > 0, ps_keys, pss)
  for t in range(dts.shape[0]):
    p_t = _step_params(params, ps_keys, None if pss is None else pss[t])
    x, P = lane_predict(spec, p_t, x, P, Q, dts[t])
    x, P, _ = lane_update(spec, kind, p_t, x, P, zs[t], R,
                          ea=None if eas is None else eas[t], gate=gate)
  return x, P


def lane_mixed_bank_scan(spec: FilterSpec, kinds, params, x, P, Q, dts,
                         kind_idx, zs, R_list, eas=None, ps_keys=(),
                         pss=None, gate: bool = True):
  """A heterogeneous kind schedule: each step one predict and the update of
  kinds[kind_idx[t]]. zs (T, B, max_dz) and eas (T, B, max_ea_len) rows are
  padded; each kind reads its own leading columns. R_list: per-kind
  (dz, dz), aligned with kinds. gate True applies each kind's own
  maha_test (reference semantics); False gates nothing."""
  kinds = tuple(int(k) for k in kinds)
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  _check_streams(dts.shape[0], eas, max_ea > 0, ps_keys, pss)
  for t, ki in enumerate(torch.as_tensor(kind_idx).tolist()):
    om = spec.obs[kinds[ki]]
    p_t = _step_params(params, ps_keys, None if pss is None else pss[t])
    x, P = lane_predict(spec, p_t, x, P, Q, dts[t])
    x, P, _ = lane_update(
        spec, om.kind, p_t, x, P, zs[t][:, :om.dz], R_list[ki],
        ea=eas[t][:, :om.ea_len] if om.ea_len else None,
        gate=gate and om.maha_test)
  return x, P


def lane_epoch_bank_scan(spec: FilterSpec, slot_kinds, params, x, P, Q,
                         dts, zs, R_list, eas=None, ps_keys=(), pss=None,
                         gate: bool = True):
  """T epochs, each one predict then the K slot updates in order (the
  reference's predict_and_update_batch, ekf_sym.py:484-531). zs
  (T, K, B, max_dz), eas (T, K, B, max_ea_len), R_list per slot; gate as
  in lane_mixed_bank_scan."""
  slot_kinds = tuple(int(k) for k in slot_kinds)
  max_ea = max(spec.obs[k].ea_len for k in slot_kinds)
  _check_streams(dts.shape[0], eas, max_ea > 0, ps_keys, pss)
  for t in range(dts.shape[0]):
    p_t = _step_params(params, ps_keys, None if pss is None else pss[t])
    x, P = lane_predict(spec, p_t, x, P, Q, dts[t])
    for k, kind in enumerate(slot_kinds):
      om = spec.obs[kind]
      x, P, _ = lane_update(
          spec, kind, p_t, x, P, zs[t, k][:, :om.dz], R_list[k],
          ea=eas[t, k][:, :om.ea_len] if om.ea_len else None,
          gate=gate and om.maha_test)
  return x, P


def to_lane(P_batch):
  """(B, d, d) -> (d, d, B)."""
  return P_batch.permute(1, 2, 0)


def from_lane(P_lane):
  """(d, d, B) -> (B, d, d)."""
  return P_lane.permute(2, 0, 1)
