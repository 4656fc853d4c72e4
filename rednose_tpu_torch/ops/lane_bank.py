"""Lane-major generic filter banks: the plain versions of kernels 4-7.

Port of rednose_tpu/ops/lane_bank.py. A bank of B filters
of ANY spec keeps its covariances as (d, d, B) with the bank axis last;
each step vmaps the spec's own f / h / err over the bank and takes the
Jacobians densely with torch.func.jacfwd. Semantics are core/step.py's:
F P F^T, innovation, ESKF H·H_mod, the Mahalanobis zero-gain gate, the
closed-form S^-1 for dz <= 3, the Joseph form and error injection; the
covariance algebra is the one the kernels (and the JAX package's
structured lane path) use: F = I + G with P' = P + (V + V^T), and the
factored Joseph P' = P + (W + W^T), both exactly symmetric.

MSCKF specs (dim_main_err < dim_err) predict in the block form of
ekf_c.c:17-29: G = F - I is confined to the main block, so V + V^T updates
the main block fully, the coupling one-sided, and leaves the clone block
as it is. A feature kind projects its update onto the left null space of
He by Householder reflectors and solves the dz' = dz - ea_dim system by a
lane Cholesky; `augment_slab` clones the pose into the window.

`lane_bank_scan`, `lane_mixed_bank_scan`, `lane_epoch_bank_scan` and
`lane_frame_bank_scan` are the plain torch versions of the generic CUDA
kernels 4, 6, 5 and 7 (ops/generic_scan.py): the wrappers run them for CPU
tensors, and the tests and chip_smoke.py hold the kernels against them.
Layout as in the JAX package: x (B, dim_x), P (de, de, B), zs (T, B, dz).
The blocked Cholesky (`cholesky_lane_blocked` / `cho_solve_lane_blocked`)
serves the smoother's gains pass (smoothing/rts.py).

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


def cholesky_lane(A):
  """Column-slab Cholesky of SPD (d, d, B) lane-major matrices: the list of
  lower-factor columns cols[j] (d - j, B), from the diagonal down, that
  cho_solve_lane takes (A = L L^T)."""
  d = A.shape[0]
  cols = []
  for j in range(d):
    s = A[j:, j]
    for k in range(j):
      s = s - cols[k][j - k:] * cols[k][j - k][None]
    diag = torch.sqrt(s[0])
    cols.append(torch.cat([diag[None], s[1:] / diag[None]]))
  return cols


def cho_solve_lane(cols, B_):
  """Solve A X = B_ with A = L L^T from cholesky_lane; B_ (d, m, B)."""
  d = len(cols)
  Y = [None] * d
  for i in range(d):
    s = B_[i]
    for k in range(i):
      s = s - cols[k][i - k][None] * Y[k]
    Y[i] = s / cols[i][0][None]
  X = [None] * d
  for i in reversed(range(d)):
    s = Y[i]
    for k in range(i + 1, d):
      s = s - cols[i][k - i][None] * X[k]
    X[i] = s / cols[i][0][None]
  return torch.stack(X)


def cholesky_lane_blocked(A, r: int = 8):
  """Blocked right-looking Cholesky of SPD (d, d, B) lane-major matrices:
  per r-wide panel an unrolled r x r diagonal factor, an r-step panel
  substitution and one rank-r trailing update (_mm_t), so the chain of
  dependent slab ops is about r/2 times shorter than cholesky_lane's.
  Returns the dense lower factor (d, d, B) that cho_solve_lane_blocked
  takes."""
  d = A.shape[0]
  S = A  # trailing submatrix, shrinking by r each panel
  panels = []
  for b0 in range(0, d, r):
    rr = min(r, d - b0)
    Ablk = S[:rr, :rr]
    # Ld[j]: column j of the diagonal block's factor from the diagonal down
    Ld = []
    for j in range(rr):
      s = Ablk[j:, j]
      for k in range(j):
        s = s - Ld[k][j - k:] * Ld[k][j - k][None]
      diag = torch.sqrt(s[0])
      Ld.append(torch.cat([diag[None], s[1:] / diag[None]])
                if j + 1 < rr else diag[None])
    # the panel below the diagonal block: solve Lp Ld^T = S[rr:, :rr]
    Lp_cols = []
    if rr < S.shape[0]:
      Pn = S[rr:, :rr]
      for j in range(rr):
        s = Pn[:, j]
        for k in range(j):
          s = s - Lp_cols[k] * Ld[k][j - k][None]
        Lp_cols.append(s / Ld[j][0][None])
    dcol = torch.stack(
        [torch.cat([torch.zeros((j,) + Ld[j].shape[1:], dtype=A.dtype,
                                device=A.device), Ld[j]]) if j else Ld[0]
         for j in range(rr)], dim=1)
    if Lp_cols:
      Lp = torch.stack(Lp_cols, dim=1)                      # (n, rr, B)
      panel = torch.cat([dcol, Lp])
      S = S[rr:, rr:] - _mm_t(Lp, Lp)                       # rank-r update
    else:
      panel = dcol
    panels.append(torch.cat([torch.zeros((b0,) + panel.shape[1:],
                                         dtype=A.dtype, device=A.device),
                             panel]) if b0 else panel)
  return torch.cat(panels, dim=1)


def cho_solve_lane_blocked(L, B_, r: int = 8):
  """Solve A X = B_ with A = L L^T from cholesky_lane_blocked; B_
  (d, m, B). Blocked substitution: per panel one slab product (_mm) for
  the cross-panel part and an unrolled r-step small substitution."""
  d = L.shape[0]
  Y_blocks = []                                   # forward: L Y = B_
  for b0 in range(0, d, r):
    rr = min(r, d - b0)
    s = B_[b0:b0 + rr]
    if Y_blocks:
      s = s - _mm(L[b0:b0 + rr, :b0], torch.cat(Y_blocks))
    rows = []
    for i in range(rr):
      si = s[i]
      for k in range(i):
        si = si - L[b0 + i, b0 + k][None] * rows[k]
      rows.append(si / L[b0 + i, b0 + i][None])
    Y_blocks.append(torch.stack(rows))
  Y = torch.cat(Y_blocks)
  X_blocks = []                                   # backward: L^T X = Y
  for b0 in reversed(range(0, d, r)):
    rr = min(r, d - b0)
    s = Y[b0:b0 + rr]
    if X_blocks:
      # (L^T)[b0:b0+rr, b0+rr:] = L[b0+rr:, b0:b0+rr]^T
      s = s - _mm(L[b0 + rr:, b0:b0 + rr].transpose(0, 1),
                  torch.cat(X_blocks))
    rows = [None] * rr
    for i in reversed(range(rr)):
      si = s[i]
      for k in range(i + 1, rr):
        si = si - L[b0 + k, b0 + i][None] * rows[k]
      rows[i] = si / L[b0 + i, b0 + i][None]
    X_blocks.insert(0, torch.stack(rows))
  return torch.cat(X_blocks)


def _householder_qt(He):
  """Householder reflectors of the thin QR of He (dz, m, B): a list of
  (j, v, beta, v elements) whose application in order left-multiplies by
  Q^T (_apply_qt). A structurally rank-deficient column gets beta = 0 (the
  identity) instead of the reference's nullspace-failure branch
  (ekf_sym.py:588-591); the Mahalanobis gate backs it up."""
  dz, m = He.shape[0], He.shape[1]
  cols = [He[:, k] for k in range(m)]
  refl = []
  for j in range(m):
    c = [cols[j][i] for i in range(j, dz)]
    sigma = sum(ci * ci for ci in c)
    norm = torch.sqrt(sigma)
    sign = torch.where(c[0] >= 0, 1.0, -1.0).to(He.dtype)
    v0 = c[0] + sign * norm
    v = torch.stack([v0] + c[1:])
    ve = [v0] + c[1:]
    vtv = sigma - c[0] * c[0] + v0 * v0
    beta = torch.where(vtv > 0, 2.0 / torch.where(vtv > 0, vtv, 1.0),
                       0.0).to(He.dtype)
    refl.append((j, v, beta, ve))
    for k in range(j + 1, m):
      ck = cols[k]
      w = sum(ve[i] * ck[j + i] for i in range(dz - j))
      tail = ck[j:] - (beta * w)[None] * v
      cols[k] = torch.cat([ck[:j], tail]) if j else tail
  return refl


def _apply_qt(refl, M):
  """Left-multiply M (dz, n, B) by Q^T through the reflectors."""
  for j, v, beta, ve in refl:
    sub = M[j:]
    w = sum(ve[i][None] * sub[i] for i in range(sub.shape[0]))   # (n, B)
    sub = sub - (beta[None] * w)[None] * v[:, None]
    M = torch.cat([M[:j], sub]) if j else sub
  return M


def _solve_spd_lane(S, B_):
  """S^-1 B_ for SPD lane-major S (d, d, B): the adjugate for d <= 3, the
  column-slab Cholesky above it (a projected feature update has d = 5)."""
  if S.shape[0] <= 3:
    return _mm(_inv_small(S), B_)
  return cho_solve_lane(cholesky_lane(S), B_)


def _normalize(spec, x):
  if not spec.quaternion_idxs:
    return x
  return vmap(lambda xx: normalize_slices(xx, spec.quaternion_idxs))(x)


def lane_predict(spec: FilterSpec, params, x, P, Q, dt):
  """Bank predict: x (B, dim_x), P (de, de, B); x <- f(x, dt),
  P <- F P F^T + dt Q (ekf_c.c:8-33), assembled as the kernels do:
  F = I + G, M = G P, V = M + (M G^T) / 2, P' = P + (V + V^T) (exactly
  symmetric; the JAX package's fpf_masked algebra, here dense). For an
  MSCKF spec G keeps only its main block (the clone states are static)."""
  x_new = vmap(lambda xx: spec.f(params, xx, dt))(x)
  F = vmap(lambda xx: spec.F(params, xx, dt), out_dims=2)(x)
  m = spec.dim_main_err
  G = torch.zeros_like(F)
  G[:m, :m] = F[:m, :m] - torch.eye(m, dtype=F.dtype,
                                    device=F.device)[:, :, None]
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
  if om.is_feature:
    return _feature_update(spec, om, params, x, P, z, R, ea, H, h, gate)
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


def _feature_update(spec, om, params, x, P, z, R, ea, H, h, gate):
  """The MSCKF feature-kind update (lane_update's; JAX lane_bank.py:366-412):
  per-lane He, the Householder projection onto null(He^T), then the
  update at dz' = dz - ea_dim with the lane Cholesky. y is the projected
  innovation (its basis differs from core/step's complete QR by a
  rotation; x and P do not)."""
  me, dzp, B = om.ea_dim, om.dz - om.ea_dim, x.shape[0]
  He = vmap(lambda xx, ee: spec.He(om.kind, params, xx, ee),
            out_dims=2)(x, ea)                           # (dz, ea_dim, B)
  refl = _householder_qt(He)
  y = _apply_qt(refl, (z.T - h)[:, None])[me:, 0]       # (dz', B)
  H = _apply_qt(refl, H)[me:]                            # (dz', de, B)
  T1 = _apply_qt(refl, R.expand(om.dz, om.dz, B))        # Q^T R
  Rp = _apply_qt(refl, T1.transpose(0, 1))[me:, me:]     # Q^T R Q
  HP = _mm_t(H, P)                                       # (dz', de, B)
  S = _mm_t(HP, H) + 0.5 * (Rp + Rp.transpose(0, 1))
  Kt = _solve_spd_lane(S, HP)                            # S^-1 H P = K^T
  if gate:
    sy = _solve_spd_lane(S, y[:, None])
    dist = sum(y[i] * sy[i, 0] for i in range(dzp))
    Kt = torch.where(dist[None, None, :] > om.maha_thresh,
                     torch.zeros_like(Kt), Kt)
  dx = sum(Kt[i] * y[i][None] for i in range(dzp))      # (de, B)
  # factored Joseph P + (W + W^T), W = K (S K^T / 2 - HP)
  W = _mm(Kt.transpose(0, 1), 0.5 * _mm(S, Kt) - HP)
  P_new = P + (W + W.transpose(0, 1))
  x_new = vmap(lambda xx, d: spec.err(params, xx, d))(x, dx.T)
  return _normalize(spec, x_new), P_new, y.T


def augment_slab(spec: FilterSpec, x, P):
  """MSCKF augmentation on slab state x (dim_x, *b), P (de, de, *b): clone
  the current pose into the newest window slot (core/step.augment,
  ekf_sym.py:365-391), by slices and concatenation only."""
  if not spec.is_msckf:
    raise ValueError(f"spec {spec.name!r} has no clone window")
  d1, d2 = spec.dim_main, spec.dim_main_err
  d3, d4 = spec.dim_augment, spec.dim_augment_err
  x_new = torch.cat([x[:d1], x[d1 + d3:], x[:d3]])
  # drop the oldest clone's rows / columns (two contiguous ranges)
  Pr = torch.cat([
      torch.cat([P[:d2, :d2], P[:d2, d2 + d4:]], dim=1),
      torch.cat([P[d2 + d4:, :d2], P[d2 + d4:, d2 + d4:]], dim=1),
  ])
  # to_mult: the first d4 rows / columns again in the newest slot
  P_new = torch.cat([torch.cat([Pr, Pr[:, :d4]], dim=1),
                     torch.cat([Pr[:d4], Pr[:d4, :d4]], dim=1)])
  return x_new, 0.5 * (P_new + P_new.transpose(0, 1))


def lane_augment(spec: FilterSpec, x, P):
  """Banked MSCKF augmentation: x (B, dim_x), P (de, de, B)."""
  x_new, P_new = augment_slab(spec, x.T, P)
  return x_new.T, P_new


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
  maha_test (reference semantics); False gates nothing. A step of an
  MSCKF feature kind is a camera frame: its projected update, then the
  window augment (JAX lane_bank.py:600-614)."""
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
    if om.is_feature:
      x, P = lane_augment(spec, x, P)
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


def lane_frame_bank_scan(spec: FilterSpec, kind: int, params, x, P, Q, dts,
                         zs, eas, R, gate: bool | None = None):
  """T MSCKF camera frames over a lane-major bank, each a block predict,
  the projected update of feature kind `kind` and the window augment (the
  twin of JAX msckf_bank._jit_frame_scan): x (B, dim_x), P (de, de, B),
  dts (T,), zs (T, B, dz), eas (T, B, ea_len) landmark positions, R
  (dz, dz); gate as in lane_update. Returns the final (x, P)."""
  if not spec.obs[kind].is_feature:
    raise ValueError(f"kind {kind} is not an MSCKF feature kind")
  for t in range(dts.shape[0]):
    x, P = lane_predict(spec, params, x, P, Q, dts[t])
    x, P, _ = lane_update(spec, kind, params, x, P, zs[t], R, ea=eas[t],
                          gate=gate)
    x, P = lane_augment(spec, x, P)
  return x, P


def to_lane(P_batch):
  """(B, d, d) -> (d, d, B)."""
  return P_batch.permute(1, 2, 0)


def from_lane(P_lane):
  """(d, d, B) -> (B, d, d)."""
  return P_lane.permute(2, 0, 1)
