"""Structure-exploiting fused step for the live ESKF bank: the slab functions.

Port of rednose_tpu/ops/live_lane.py. These are the plain torch versions
of kernels 2 and 3 (ops/live_scan.py, csrc/live_scan.cu), and the bank
path on the CPU.

The live model's closed-form sparsity is used by hand, as the reference's
sympy codegen does (rednose/helpers/ekf_sym.py:76-89):

  * F = I + dt*A where A (the error-dynamics Jacobian at dx=0,
    examples/live_kf.py:177-184) has five nonzero 3x3 blocks:
      A[pos, vel] = I, A[att, att] = -skew(R(q) w), A[att, omega] = R(q),
      A[vel, att] = -skew(R(q) a), A[vel, accel_err] = R(q).
    P' = (I+dtA) P (I+dtA)^T + dt*Q = P + M + M^T + M(dtA)^T + dt*Q with
    M = (dtA)P having only 9 nonzero rows.
  * Each kind's H = H_raw @ H_mod is a few 3x3 (or 1x3) blocks on a few
    error-state columns; the Joseph form factors (joseph_sym) into one
    22x22xdz product.

Every function works on slab state with trailing bank dims `*b`:
x (23, *b), P (22, 22, *b), z (dz, *b). Built with torch.stack / torch.cat,
never writing into an input.
"""

from __future__ import annotations

import torch

from rednose_tpu_torch.models.live import (
    EARTH_GM,
    ObservationKind as _K,
    _omega_matrix,
)
from rednose_tpu_torch.ops.quaternion import quat_to_rot, skew
from rednose_tpu_torch.utils.chi2 import chi2_ppf

# chi2(0.95, 3), the optional position gate (ekf_sym.py:144-147)
MAHA_THRESH_3D = chi2_ppf(0.95, 3)


def _mv(M, v, n):
  """(n, n, *b) @ (n, *b) -> (n, *b), unrolled."""
  return torch.stack([sum(M[i, k] * v[k] for k in range(n)) for i in range(n)])


def _mm_l(A, B, k):
  """(m, k, *b) @ (k, n, *b) -> (m, n, *b), unrolled over k."""
  return sum(A[:, i][:, None] * B[i][None] for i in range(k))


def _mm_rt(A, B, k):
  """(m, k, *b) @ (n, k, *b)^T -> (m, n, *b), unrolled over k."""
  return sum(A[:, i][:, None] * B[:, i][None] for i in range(k))


def _swap01(M):
  return torch.swapaxes(M, 0, 1)


def joseph_sym(P, K, HP, S, k):
  """sym(P - K HP - (K HP)^T + K S K^T), assembled as P + (W + W^T) with
  W = K (0.5 S K^T - HP): one (de, de) product, bitwise symmetric (float
  add commutes); a gated K = 0 leaves P exactly unchanged."""
  T = 0.5 * _mm_l(S, _swap01(K), k) - HP   # (k, de, *b)
  W = _mm_l(K, T, k)
  return P + (W + _swap01(W))


def _inv3(S):
  """Closed-form adjugate inverse of (3, 3, *b)."""
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


def _normalize_quat(x):
  q = x[3:7]
  inv = torch.rsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
  return torch.cat([x[0:3], q * inv, x[7:]])


def _bcast(a, like):
  """Append trailing unit dims so a (r, c) noise matrix meets (r, c, *b)."""
  return a.reshape(a.shape + (1,) * (like.ndim - a.ndim))


def live_predict_slab(x, P, Q, dt):
  """Fused live predict on slab state: x (23, *b), P (22, 22, *b), dt a
  scalar. Q is (22, 22), or (22,) for a diagonal Q (the kernels' form).
  core/step.predict semantics with the closed-form block-sparse F."""
  if Q.ndim == 1:
    Q = torch.diag(Q)
  q, v = x[3:7], x[7:10]
  w, a = x[10:13], x[17:20]
  Rq = quat_to_rot(q)                    # (3, 3, *b)
  wd = _mv(Rq, w, 3)                     # R(q) @ omega
  ad = _mv(Rq, a, 3)                     # R(q) @ accel

  # nominal state: first-order integrator (live_kf.py:160-168) + quat renorm
  x_new = torch.cat([
      x[0:3] + dt * v,
      q + dt * _mv(_omega_matrix(w), q, 4),
      v + dt * ad,
      x[10:],
  ])
  x_new = _normalize_quat(x_new)

  # M = (dt*A) @ P: rows 0:9 only; dt folded into the small A blocks
  Swd, Sad = dt * skew(wd), dt * skew(ad)
  Rqd = dt * Rq
  M0 = dt * P[6:9]                                             # pos <- vel
  M1 = _mm_l(Rqd, P[9:12], 3) - _mm_l(Swd, P[3:6], 3)          # att rows
  M2 = _mm_l(Rqd, P[16:19], 3) - _mm_l(Sad, P[3:6], 3)         # vel rows
  M = torch.cat([M0, M1, M2])            # (9, 22, *b)

  # 0.5 * N with N = M @ (dt*A)^T: columns 0:9 only
  N0 = (0.5 * dt) * M[:, 6:9]
  N1 = 0.5 * (_mm_rt(M[:, 9:12], Rqd, 3) - _mm_rt(M[:, 3:6], Swd, 3))
  N2 = 0.5 * (_mm_rt(M[:, 16:19], Rqd, 3) - _mm_rt(M[:, 3:6], Sad, 3))
  N_half = torch.cat([N0, N1, N2], dim=1)  # (9, 9, *b)

  # P' = P + M + M^T + N, assembled blockwise and bitwise symmetric
  MM = M[:, 0:9] + _swap01(M[:, 0:9])
  NN = N_half + _swap01(N_half)
  TL = (P[0:9, 0:9] + MM) + NN
  TR = P[0:9, 9:] + M[:, 9:]
  P_new = torch.cat([
      torch.cat([TL, TR], dim=1),
      torch.cat([_swap01(TR), P[9:, 9:]], dim=1),
  ])
  return x_new, P_new + _bcast(dt * Q, P_new)


def live_update_pos_slab(x, P, z, R, gate: bool = False,
                         gate_thresh: float = MAHA_THRESH_3D):
  """Fused ECEF_POS update (H = [I3 | 0], so HP = P[:3])."""
  return live_update_slab(_K.ECEF_POS, x, P, z, R, gate=gate,
                          gate_thresh=gate_thresh)


def live_step_slab(x, P, Q, dt, z, R, gate: bool = False):
  """One fused predict + ECEF_POS update (the bank hot path)."""
  x, P = live_predict_slab(x, P, Q, dt)
  return live_update_pos_slab(x, P, z, R, gate=gate)


def live_lane_scan(x, P, Q, dts, zs, R, gate: bool = False):
  """T fused predict + ECEF_POS steps over a lane-major live bank.

  x (B, 23), P (22, 22, B), Q (22, 22) or (22,), dts (T,), zs (T, B, 3),
  R (3, 3). Returns the final (x (B, 23), P)."""
  xl = x.T
  for k in range(dts.shape[0]):
    xl, P, _ = live_step_slab(xl, P, Q, dts[k], zs[k].T, R, gate=gate)
  return xl.T, P


# ---------------------------------------------------------------------------
# Closed-form sparse H for every live observation kind. Each kind's
# H = H_raw @ H_mod is a handful of 3x3 (or 1x3) blocks on a few error-state
# columns (JAX live_lane.py:230-363, checked there against jacfwd).
#   d(R(e)u)/de   = [ (R e_x) x u', (Rz e_y) x u', e_z x u' ],  u' = R(e)u
#   d(R(q)^T u)/d(dtheta) = R(q)^T skew(u)
# ---------------------------------------------------------------------------

# error-state column offsets (models/live.py States *_ERR slices)
_POS, _ATT, _VEL, _OMEGA = 0, 3, 6, 9
_BIAS, _SCALE, _ACC, _OFF = 12, 15, 16, 19


def _cross(a, b):
  """(3, *b) x (3, *b) elementwise cross product."""
  return torch.stack([a[1] * b[2] - a[2] * b[1],
                      a[2] * b[0] - a[0] * b[2],
                      a[0] * b[1] - a[1] * b[0]])


def _euler_rot_slab(e):
  """euler_to_rot on slab euler angles (3, *b) -> (3, 3, *b)."""
  cr, sr = torch.cos(e[0]), torch.sin(e[0])
  cp, sp_ = torch.cos(e[1]), torch.sin(e[1])
  cy, sy = torch.cos(e[2]), torch.sin(e[2])
  one, zero = torch.ones_like(cr), torch.zeros_like(cr)
  r_roll = torch.stack([torch.stack([one, zero, zero]),
                        torch.stack([zero, cr, -sr]),
                        torch.stack([zero, sr, cr])])
  r_pitch = torch.stack([torch.stack([cp, zero, sp_]),
                         torch.stack([zero, one, zero]),
                         torch.stack([-sp_, zero, cp])])
  r_yaw = torch.stack([torch.stack([cy, -sy, zero]),
                       torch.stack([sy, cy, zero]),
                       torch.stack([zero, zero, one])])
  return _mm_l(r_yaw, _mm_l(r_pitch, r_roll, 3), 3)


def _d_euler_rot(e, Re, u_prime):
  """d(R(e)u)/de as (3, 3, *b) given R(e) and u' = R(e)u."""
  cy, sy = torch.cos(e[2]), torch.sin(e[2])
  zero = torch.zeros_like(cy)
  one = torch.ones_like(cy)
  col_r = _cross(Re[:, 0], u_prime)                          # (R e_x) x u'
  col_p = _cross(torch.stack([-sy, cy, zero]), u_prime)      # (Rz e_y) x u'
  col_y = _cross(torch.stack([zero, zero, one]), u_prime)    # e_z x u'
  return torch.stack([col_r, col_p, col_y], dim=1)


# Each builder: x (23, *b) -> (h (dz, *b), blocks); blocks is a tuple of
# (col, width, Hb) with Hb (dz, width, *b), or None for an identity block.

def _hH_ecef_pos(x):
  return x[0:3], ((_POS, 3, None),)


def _hH_no_rot(x):
  return x[10:13], ((_OMEGA, 3, None),)


def _hH_imu_frame(x):
  return x[20:23], ((_OFF, 3, None),)


def _hH_odo_speed(x):
  v, s = x[7:10], x[16]
  speed = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
  h = (speed * s)[None]
  # |v| -> 0 leaves the velocity direction undefined; the clamp degrades a
  # standstill update to information-free on the velocity rows
  Hv = (s / torch.clamp(speed, min=1e-6)) * v
  return h, ((_VEL, 3, Hv[None]), (_SCALE, 1, speed[None, None]))


def _hH_cam_trans(x):
  q, v = x[3:7], x[7:10]
  RqT = _swap01(quat_to_rot(q))
  h = _mv(RqT, v, 3)
  return h, ((_ATT, 3, _mm_l(RqT, skew(v), 3)), (_VEL, 3, RqT))


def _hH_gyro(x):
  w, b_, o = x[10:13], x[13:16], x[20:23]
  Re = _euler_rot_slab(o)
  up = _mv(Re, w + b_, 3)
  return up, ((_OMEGA, 3, Re), (_BIAS, 3, Re),
              (_OFF, 3, _d_euler_rot(o, Re, up)))


def _hH_accel(x):
  p, q, a, o = x[0:3], x[3:7], x[17:20], x[20:23]
  Rq = quat_to_rot(q)
  RqT = _swap01(Rq)
  Re = _euler_rot_slab(o)
  r2 = p[0] * p[0] + p[1] * p[1] + p[2] * p[2]
  scale = EARTH_GM / (r2 * torch.sqrt(r2))
  u = scale * p                                  # GM p / r^3
  g = _mv(RqT, u, 3)
  h = _mv(Re, g + a, 3)
  ReRqT = _mm_l(Re, RqT, 3)
  # d u / d p = scale * (I - 3 p p^T / r^2)
  php = torch.stack([torch.stack([p[i] * p[j] for j in range(3)])
                     for i in range(3)]) * (3.0 / r2)
  eye3 = torch.stack([
      torch.stack([torch.ones_like(r2) if i == j else torch.zeros_like(r2)
                   for j in range(3)]) for i in range(3)])
  Hp = scale * _mm_l(ReRqT, eye3 - php, 3)
  return h, ((_POS, 3, Hp),
             (_ATT, 3, _mm_l(ReRqT, skew(u), 3)),
             (_ACC, 3, Re),
             (_OFF, 3, _d_euler_rot(o, Re, h)))


# kind -> (dz, builder); NO_ROT and CAMERA_ODO_ROTATION share h = omega
LANE_KINDS = {
    _K.ECEF_POS: (3, _hH_ecef_pos),
    _K.NO_ROT: (3, _hH_no_rot),
    _K.CAMERA_ODO_ROTATION: (3, _hH_no_rot),
    _K.IMU_FRAME: (3, _hH_imu_frame),
    _K.ODOMETRIC_SPEED: (1, _hH_odo_speed),
    _K.CAMERA_ODO_TRANSLATION: (3, _hH_cam_trans),
    _K.PHONE_GYRO: (3, _hH_gyro),
    _K.PHONE_ACCEL: (3, _hH_accel),
}


def _inject(x, dx):
  """ESKF error injection + quat renorm (shared by all updates)."""
  q = x[3:7]
  d1, d2, d3 = 0.5 * dx[3], 0.5 * dx[4], 0.5 * dx[5]
  q_new = torch.stack([
      q[0] - q[1] * d1 - q[2] * d2 - q[3] * d3,
      q[1] + q[0] * d1 + q[3] * d2 - q[2] * d3,
      q[2] - q[3] * d1 + q[0] * d2 + q[1] * d3,
      q[3] + q[2] * d1 - q[1] * d2 + q[0] * d3,
  ])
  return _normalize_quat(
      torch.cat([x[0:3] + dx[0:3], q_new, x[7:] + dx[6:]]))


def live_update_slab(kind: int, x, P, z, R, gate: bool = False,
                     gate_thresh: float | None = None):
  """Fused update for any live observation kind on slab state, via the
  kind's closed-form sparse H blocks. z (dz, *b); R (dz, dz) or
  (dz, dz, *b). Returns (x, P, y)."""
  dz, builder = LANE_KINDS[kind]
  h, blocks = builder(x)
  y = z - h

  # HP = H @ P, accumulated per sparse block (identity block = row slice)
  HP = None
  for c, w, Hb in blocks:
    term = P[c:c + w] if Hb is None else _mm_l(Hb, P[c:c + w], w)
    HP = term if HP is None else HP + term  # (dz, 22, *b)
  # S = HP @ H^T + R
  S = None
  for c, w, Hb in blocks:
    term = HP[:, c:c + w] if Hb is None else _mm_rt(HP[:, c:c + w], Hb, w)
    S = term if S is None else S + term
  S = S + (_bcast(R, S) if R.ndim == 2 else R)

  if dz == 1:
    Sinv = 1.0 / S
  elif dz == 3:
    Sinv = _inv3(S)
  else:
    raise NotImplementedError(f"dz={dz}")
  K = _mm_l(_swap01(HP), Sinv, dz)  # P H^T S^-1 (P symmetric)
  if gate:
    if gate_thresh is None:
      gate_thresh = chi2_ppf(0.95, dz)
    dist = sum(y[i] * Sinv[i, j] * y[j]
               for i in range(dz) for j in range(dz))
    # a NaN distance compares False and does not gate
    K = torch.where(dist[None, None] > gate_thresh, torch.zeros_like(K), K)
  dx = sum(K[:, i] * y[i][None] for i in range(dz))

  P_new = joseph_sym(P, K, HP, S, dz)
  return _inject(x, dx), P_new, y


def make_update_branches(kinds: tuple, R_by_kind, stream_kinds: tuple = (),
                         gate: bool = False):
  """Per-kind update closures `(x, P, z3, r_row) -> (x, P)`, one for each
  entry of `kinds`. Kinds in `stream_kinds` build a diagonal R from the
  step's r_row (3,); the others use R_by_kind[kind] (dz, dz)."""
  def _branch(k):
    dz = LANE_KINDS[k][0]

    def apply(xc, Pc, z, r_row):
      R = torch.diag(r_row[:dz]) if k in stream_kinds else R_by_kind[k]
      return live_update_slab(k, xc, Pc, z[:dz], R, gate=gate)[:2]

    return apply

  return tuple(_branch(k) for k in kinds)


def live_mixed_scan(x, P, Q, dts, kind_idx, zs, R_by_kind, kinds: tuple,
                    gate: bool = False, r_stream=None,
                    stream_kinds: tuple = ()):
  """A heterogeneous sensor stream over the lane-major live bank: each step
  one predict, then the closed-form update of kinds[kind_idx[t]].

  x (B, 23), P (22, 22, B), Q (22, 22) or (22,), dts (T,), kind_idx (T,)
  indices into `kinds`, zs (T, B, 3) padded to dz <= 3, R_by_kind mapping
  kind -> (dz, dz). Kinds in `stream_kinds` take a per-step diagonal noise
  from r_stream (T, 3) (live_kf.py:325-337). Returns (x (B, 23), P)."""
  if (r_stream is None) != (not stream_kinds):
    raise ValueError("r_stream and stream_kinds go together")
  branches = make_update_branches(kinds, R_by_kind, stream_kinds, gate)
  xl = x.T
  for t, ki in enumerate(torch.as_tensor(kind_idx).tolist()):
    xl, P = live_predict_slab(xl, P, Q, dts[t])
    r_row = None if r_stream is None else r_stream[t]
    xl, P = branches[ki](xl, P, zs[t].T, r_row)
  return xl.T, P
