"""MSCKF feature triangulation: batched Gauss-Newton on inverse depth.

Port of rednose_tpu/msckf/triangulation.py (the reference template
rednose/templates/compute_pos.c:10-52). The residual is a plain torch
function (the standard MSCKF reprojection residual over a pose window),
its Jacobian comes from torch.func.jacfwd under vmap, and one call solves
every track of a frame at once.

Parameterization (compute_pos.c:31-33, 45-47): the feature is
(alpha, beta, rho) = (u, v, inverse depth) in the LAST camera frame of the
track; its ECEF position is R(q_last) @ RC^T @ [alpha/rho, beta/rho, 1/rho]
+ p_last.

Solver (compute_pos.c:18-26): per track a do-while of at most 30 full
Gauss-Newton steps, stopping once the squared step norm is <= 1e-4. Here
it is one loop of at most 30 iterations over the tracks still active: a
track that has converged keeps its parameters, and the loop ends when no
track is active. Each step is a least-squares solve by QR (the same
solution as the reference's normal equations, without squaring the
condition number).
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from rednose_tpu_torch.ops.quaternion import quat_to_rot

MAX_ITERS = 30
STEP_TOL_SQ = 1e-4


def feature_ecef(to_c, pose_last, param):
  """ECEF position of a feature from its last-frame inverse-depth param
  (compute_pos.c:36-51)."""
  p_last, q_last = pose_last[0:3], pose_last[3:7]
  q_last = q_last / torch.linalg.vector_norm(q_last)
  rel = torch.stack([param[0] / param[2], param[1] / param[2],
                     1.0 / param[2]])
  return quat_to_rot(q_last) @ to_c.T @ rel + p_last


def reprojection_residual(to_c, poses, img_positions, param):
  """Stacked (2K,) residual: predicted minus observed normalized image
  coordinates over the K-frame window. poses (K, 7) rows [ecef_pos(3),
  quat wxyz(4)]; img_positions (K, 2)."""
  p_ecef = feature_ecef(to_c, poses[-1], param)
  out = []
  for k in range(poses.shape[0]):
    q = poses[k, 3:7] / torch.linalg.vector_norm(poses[k, 3:7])
    p_c = to_c @ quat_to_rot(q).T @ (p_ecef - poses[k, 0:3])
    out.append(torch.stack([p_c[0] / p_c[2] - img_positions[k, 0],
                            p_c[1] / p_c[2] - img_positions[k, 1]]))
  return torch.cat(out)


def _gn_step(to_c, poses, img_positions, param):
  """One Gauss-Newton step of one track: (new param, squared step norm)."""
  def res(p):
    return reprojection_residual(to_c, poses, img_positions, p)

  r = res(param)
  J = jacfwd(res)(param)
  q, rr = torch.linalg.qr(J)
  delta = torch.linalg.solve_triangular(rr, (q.T @ r)[:, None],
                                        upper=True)[:, 0]
  return param - delta, torch.sum(delta * delta)


def compute_pos(to_c, poses, img_positions):
  """Triangulate one track: poses (K, 7), img_positions (K, 2). Returns
  (ecef position (3,), converged 0-d bool): from the last observation
  with inverse depth 0.1, Gauss-Newton steps until the squared step norm
  is <= 1e-4, at most 30 (compute_pos.c:30-52)."""
  to_c = torch.as_tensor(to_c, dtype=poses.dtype, device=poses.device)
  param = torch.cat([img_positions[-1],
                     torch.full((1,), 0.1, dtype=poses.dtype,
                                device=poses.device)])
  for _ in range(MAX_ITERS):
    param, delta_sq = _gn_step(to_c, poses, img_positions, param)
    if delta_sq <= STEP_TOL_SQ:
      break
  return feature_ecef(to_c, poses[-1], param), delta_sq <= STEP_TOL_SQ


def compute_pos_batch(to_c, poses, img_positions):
  """Triangulate N tracks: poses (N, K, 7), img_positions (N, K, 2).
  Returns (ecef positions (N, 3), converged (N,) bool): each track starts
  from its last observation with inverse depth 0.1 (compute_pos.c:30-52)."""
  to_c = torch.as_tensor(to_c, dtype=poses.dtype, device=poses.device)
  n = poses.shape[0]
  param = torch.cat([img_positions[:, -1],
                     torch.full((n, 1), 0.1, dtype=poses.dtype,
                                device=poses.device)], dim=1)
  delta_sq = torch.zeros((n,), dtype=poses.dtype, device=poses.device)
  active = torch.ones((n,), dtype=torch.bool, device=poses.device)
  step = vmap(lambda p, z, prm: _gn_step(to_c, p, z, prm))
  for _ in range(MAX_ITERS):
    idx = torch.nonzero(active).flatten()
    if idx.numel() == 0:
      break
    new_param, new_dsq = step(poses[idx], img_positions[idx], param[idx])
    param = param.index_copy(0, idx, new_param)
    delta_sq = delta_sq.index_copy(0, idx, new_dsq)
    active = active.index_copy(0, idx, new_dsq > STEP_TOL_SQ)
  pos = vmap(lambda p, prm: feature_ecef(to_c, p[-1], prm))(poses, param)
  return pos, delta_sq <= STEP_TOL_SQ
