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
Gauss-Newton steps, stopping once the squared step norm is <= 1e-4. Each
step is a least-squares solve by QR (the same solution as the reference's
normal equations, without squaring the condition number).

On CUDA tensors `compute_pos_batch` and `compute_pos` launch kernel 8
(csrc/triangulate.cu: a thread a track, K a template parameter, a
stride-0 pose window set up once a block in shared memory, the Jacobian in
closed form, a Householder QR), which replaces the JAX package's jitted
vmap of a per-track while_loop; `compute_pos_batch.launches` counts its
launches.
On CPU tensors they run the plain version, `compute_pos_batch_reference`:
one loop of at most 30 iterations over the tracks still active, a track
that has converged keeping its parameters (one host sync an iteration;
its `.launches` counts its runs, on any device).
"""

from __future__ import annotations

import ctypes

import torch
from torch.func import jacfwd, vmap

from rednose_tpu_torch import _build
from rednose_tpu_torch.ops.quaternion import quat_to_rot

MAX_ITERS = 30
STEP_TOL_SQ = 1e-4
MAX_K = 16   # frames a track kernel 8 takes (rn_tri::MAX_K)


def feature_ecef(to_c, pose_last, param):
  """ECEF position of a feature from its last-frame inverse-depth param
  (compute_pos.c:36-51)."""
  p_last, q_last = pose_last[0:3], pose_last[3:7]
  q_last = q_last / torch.linalg.vector_norm(q_last)
  # (alpha, beta, 1) / rho: torch 2.13's forward AD of `1.0 / (0-d
  # tensor)` promotes the tangent to float64 and fails in float32
  rel = torch.stack([param[0], param[1], torch.ones_like(param[2])]) \
      / param[2]
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


def flops_per_iteration(K: int) -> int:
  """Floating-point operations of one Gauss-Newton iteration of one track
  of K frames in kernel 8's closed form (csrc/triangulate.cu), counted
  from its loop, a division or square root as one: 1 / rho and rel (3),
  p_ecef and G (42); per frame d, the camera point and E = A_k G (63),
  the residual and the Jacobian rows (23); the Householder QR of the
  2K x 3 Jacobian, each reflector (2 (rows - 1) + 7) applied to the later
  columns and to r (4 rows each); the back substitution, the squared step
  and the update (17)."""
  qr = sum(2 * (2 * K - j - 1) + 7 + (3 - j) * 4 * (2 * K - j)
           for j in range(3))
  return 45 + K * 86 + qr + 17


def _reference_iters(to_c, poses, img_positions):
  """The plain version: (positions (N, 3), converged (N,), iterations
  (N,) int32)."""
  to_c = torch.as_tensor(to_c, dtype=poses.dtype, device=poses.device)
  n = poses.shape[0]
  param = torch.cat([img_positions[:, -1],
                     torch.full((n, 1), 0.1, dtype=poses.dtype,
                                device=poses.device)], dim=1)
  delta_sq = torch.zeros((n,), dtype=poses.dtype, device=poses.device)
  active = torch.ones((n,), dtype=torch.bool, device=poses.device)
  iters = torch.zeros((n,), dtype=torch.int32, device=poses.device)
  step = vmap(lambda p, z, prm: _gn_step(to_c, p, z, prm))
  for _ in range(MAX_ITERS):
    idx = torch.nonzero(active).flatten()
    if idx.numel() == 0:
      break
    new_param, new_dsq = step(poses[idx], img_positions[idx], param[idx])
    param = param.index_copy(0, idx, new_param)
    delta_sq = delta_sq.index_copy(0, idx, new_dsq)
    iters = iters + active.to(torch.int32)
    active = active.index_copy(0, idx, new_dsq > STEP_TOL_SQ)
  pos = vmap(lambda p, prm: feature_ecef(to_c, p[-1], prm))(poses, param)
  return pos, delta_sq <= STEP_TOL_SQ, iters


def compute_pos_batch_reference(to_c, poses, img_positions):
  """Plain torch version of kernel 8 on any device: poses (N, K, 7),
  img_positions (N, K, 2). Returns (positions (N, 3), converged (N,))."""
  compute_pos_batch_reference.launches += 1
  return _reference_iters(to_c, poses, img_positions)[:2]


compute_pos_batch_reference.launches = 0


def _launch(to_c, poses, img_positions):
  """Check the arguments, launch kernel 8 and count the launch: (positions
  (N, 3), converged (N,), iterations (N,) int32)."""
  if poses.dtype not in (torch.float32, torch.float64):
    raise ValueError(f"kernel 8 takes float32 or float64, not {poses.dtype}")
  if poses.ndim != 3 or poses.shape[2] != 7:
    raise ValueError(f"poses {tuple(poses.shape)}, expected (N, K, 7)")
  N, K = poses.shape[0], poses.shape[1]
  if tuple(img_positions.shape) != (N, K, 2):
    raise ValueError(f"img_positions {tuple(img_positions.shape)}, expected "
                     f"({N}, {K}, 2)")
  if img_positions.device != poses.device or img_positions.dtype != poses.dtype:
    raise ValueError("img_positions must share the poses' device and dtype")
  if not 1 <= K <= MAX_K:
    raise ValueError(f"kernel 8 takes 1 to {MAX_K} frames a track, got {K}")
  if not (isinstance(to_c, torch.Tensor) and to_c.dtype == poses.dtype
          and to_c.device == poses.device and to_c.is_contiguous()):
    to_c = torch.as_tensor(to_c, dtype=poses.dtype,
                           device=poses.device).contiguous()
  if tuple(to_c.shape) != (3, 3):
    raise ValueError(f"to_c {tuple(to_c.shape)}, expected (3, 3)")
  pos = torch.empty((N, 3), dtype=poses.dtype, device=poses.device)
  conv = torch.empty((N,), dtype=torch.bool, device=poses.device)
  iters = torch.empty((N,), dtype=torch.int32, device=poses.device)
  if N == 0:
    return pos, conv, iters
  code = _build.library().triangulate_launch(
      to_c.data_ptr(), poses.data_ptr(), *poses.stride(),
      img_positions.data_ptr(), *img_positions.stride(), pos.data_ptr(),
      conv.data_ptr(), iters.data_ptr(), N, K,
      int(poses.dtype == torch.float64),
      torch.cuda.current_stream(poses.device).cuda_stream)
  _build.check(code, "triangulate_launch")
  compute_pos_batch.launches += 1
  return pos, conv, iters


def launch_shape(K: int, dtype=torch.float64) -> dict:
  """Kernel 8's launch shape for K frames a track as the CUDA runtime reads
  it (entry triangulate_info): threads a block, static shared bytes,
  blocks an SM holds, registers and local (stack) bytes a thread."""
  out = (ctypes.c_int * 5)()
  _build.check(_build.library().triangulate_info(
      K, int(dtype == torch.float64), ctypes.addressof(out)),
      "triangulate_info")
  return dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                   "local_bytes"), out))


def compute_pos_batch(to_c, poses, img_positions):
  """Triangulate N tracks: poses (N, K, 7), img_positions (N, K, 2).
  Returns (ecef positions (N, 3), converged (N,) bool): each track starts
  from its last observation with inverse depth 0.1 (compute_pos.c:30-52).
  Kernel 8 on CUDA tensors (any strides), the plain version on CPU
  tensors."""
  if poses.device.type == "cpu":
    return compute_pos_batch_reference(to_c, poses, img_positions)
  return _launch(to_c, poses, img_positions)[:2]


compute_pos_batch.launches = 0


def compute_pos(to_c, poses, img_positions):
  """Triangulate one track: poses (K, 7), img_positions (K, 2). Returns
  (ecef position (3,), converged 0-d bool): from the last observation
  with inverse depth 0.1, Gauss-Newton steps until the squared step norm
  is <= 1e-4, at most 30 (compute_pos.c:30-52). compute_pos_batch on a
  batch of one: kernel 8 on a CUDA tensor, the plain version on a CPU
  tensor."""
  pos, ok = compute_pos_batch(to_c, poses[None], img_positions[None])
  return pos[0], ok[0]
