"""Multi-device scale-out: a filter bank sharded over torch.distributed.

Port of rednose_tpu/parallel/sharding.py. The bank's filters are
independent, so each rank runs the same scan on its own block of lanes
with no collective in the scan; the bank-wide metrics (the RMSE) and the
time-sharded smoother's carry are the only communication.

The JAX names and their counterparts here:
  jax.sharding.Mesh             torch.distributed.device_mesh.DeviceMesh,
                                dims "bank" (1-D) or ("slice", "bank")
  NamedSharding of the bank     BankSharding: the rank's block of lanes
  a sharded jax.Array           the rank's local shard, a tensor
  reading one back to the host  gather_bank
  psum inside shard_map         all_reduce over a mesh dim's group
  jit with shardings            none: eager torch, the rank's lanes only

A mesh spans every rank of the default process group: the group that is
up, else one from torchrun's environment, else a one-rank group from an
in-process HashStore (one card, as jax.devices() is one device there). The
default backend is "cpu:gloo,cuda:nccl", so CPU and CUDA tensors both
reach their collectives; a group started by the caller (Gloo ranks sharing
one card) is used as it is.

Layout: the port's bank-minor one. The bank axis is the LAST axis of the
kernels' x (d, B), P (d, d, B), zs (T, dz, B) and eas, axis 0 of a
BankState (x (B, dx), P (B, de, de), t (B,)) and axis 1 of run_bank's
streams zs (T, B, dz), Rs (T, B, dz, dz), eas (T, B, ea). Rank r of n
holds the lanes [r B/n, (r+1) B/n): the contiguous block the JAX package's
folded (..., 8, B/8) layout gives shard r of its sub-bank axis (C order),
so both hold the same filters per shard. B must divide by n.

Arguments: the streams (zs, Rs, eas) are whole-bank on every rank, as a
host array given to JAX's device_put; a state (x, P, or a BankState) is
either whole-bank or already the rank's shard (from shard_bank or an
earlier sharded call). Replicated arguments (dts, Q, R, params, the kind
schedule, the params stream) are the same on every rank. Each function
moves what it reads to the mesh's device and returns the rank's shard.
The TPU-only arguments of the JAX functions (t_chunk, tile_b, interpret,
phase_mode, slot_mode) are not ported.
"""

from __future__ import annotations

import dataclasses
import math
import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops import generic_scan, live_scan, smooth_scan
from rednose_tpu_torch.runtime import bank as bank_ops
from rednose_tpu_torch.smoothing.rts import (
    _affine_combine_ab,
    _affine_combine_lane,
    _dts,
)
from rednose_tpu_torch.utils.device import resolve_device

BANK_AXIS = "bank"
SLICE_AXIS = "slice"
# torchrun's environment: the default group starts from it when it is set
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


# ------------------------------------------------------------------- meshes

def _default_group():
  """Start the default process group unless one is up: from torchrun's
  environment where it is set, else one rank from an in-process store."""
  if dist.is_initialized():
    return
  backend = "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"
  if all(k in os.environ for k in _TORCHRUN_ENV):
    dist.init_process_group(backend)
  else:
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _rank_device(devices) -> torch.device:
  """The device this rank runs on: the card (devices None or "cuda"), as
  cuda:LOCAL_RANK under torchrun and cuda:0 otherwise, made current; or
  the host when the caller asks for "cpu". A missing card raises."""
  dev = resolve_device("cuda" if devices is None else devices)
  if dev.type == "cuda":
    if dev.index is None:
      dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
  return dev


def mesh_device(mesh: DeviceMesh) -> torch.device:
  """The device this rank's shard lives on."""
  if mesh.device_type == "cpu":
    return torch.device("cpu")
  return torch.device(mesh.device_type, torch.cuda.current_device())


def make_bank_mesh(devices=None) -> DeviceMesh:
  """1-D mesh over every rank of the default group with a single "bank"
  dim. `devices` is the device each rank runs on: None or "cuda" for the
  card, "cpu" for the host."""
  dev = _rank_device(devices)
  _default_group()
  return DeviceMesh(dev.type, torch.arange(dist.get_world_size()),
                    mesh_dim_names=(BANK_AXIS,))


@dataclasses.dataclass(frozen=True)
class BankSharding:
  """The bank axis split over `dims` of the mesh: one contiguous block of
  lanes a rank, blocks in row-major order of the ranks' coordinates on
  those dims (replicated over the mesh's other dims)."""
  mesh: DeviceMesh
  dims: tuple

  @property
  def size(self) -> int:
    names = self.mesh.mesh_dim_names
    return math.prod(self.mesh.size(names.index(d)) for d in self.dims)

  @property
  def index(self) -> int:
    names, coord = self.mesh.mesh_dim_names, self.mesh.get_coordinate()
    i = 0
    for d in self.dims:
      k = names.index(d)
      i = i * self.mesh.size(k) + coord[k]
    return i

  def lanes(self, batch: int) -> slice:
    """This rank's lanes of a bank of `batch` filters."""
    n = self.size
    if batch % n:
      raise ValueError(f"a bank of {batch} does not split over {n} ranks")
    w = batch // n
    return slice(self.index * w, (self.index + 1) * w)

  def local(self, t, dim: int, batch: int):
    """This rank's shard of t along `dim`, contiguous on the mesh's
    device: t whole-bank (`batch` lanes there) gives its block, t already
    a shard (batch / n lanes) is taken as it is."""
    if t is None:
      return None
    t = torch.as_tensor(t)
    n, width = self.size, t.shape[dim]
    if width == batch:
      lanes = self.lanes(batch)
      t = t.narrow(dim, lanes.start, lanes.stop - lanes.start)
    elif width * n != batch:
      raise ValueError(f"a bank axis of {width} lanes is neither the whole "
                       f"bank ({batch}) nor a shard of {n} ranks")
    return t.to(mesh_device(self.mesh)).contiguous()


def bank_sharding(mesh: DeviceMesh) -> BankSharding:
  """The bank split over the "bank" dim (JAX: NamedSharding(mesh,
  P("bank")))."""
  return BankSharding(mesh, (BANK_AXIS,))


def _replicated(mesh, t):
  """A replicated argument on the mesh's device (a Python number, which
  the functions below cast to the bank's dtype, as it is)."""
  if t is None or isinstance(t, (int, float)):
    return t
  return torch.as_tensor(t).to(mesh_device(mesh))


def _local_state(sh, state, batch):
  return bank_ops.BankState(x=sh.local(state.x, 0, batch),
                            P=sh.local(state.P, 0, batch),
                            t=sh.local(state.t, 0, batch), epoch=state.epoch)


def shard_bank(state: bank_ops.BankState,
               mesh: DeviceMesh) -> bank_ops.BankState:
  """This rank's shard of a whole-bank BankState."""
  return _local_state(bank_sharding(mesh), state, state.batch)


def gather_bank(mesh: DeviceMesh, t, dim: int):
  """The whole bank from every rank's shard of t along `dim`, in the
  mesh's order (row-major over its dims), on t's device: the counterpart
  of reading a sharded jax.Array back. One all_gather over the default
  group on t's own device (Gloo gathers CUDA tensors too, as PyTorch 2.11
  built for CUDA 12.8 does on the H100). Every shard must have the same
  shape."""
  world = dist.get_world_size()
  if mesh.size() != world:
    raise ValueError(f"the mesh has {mesh.size()} ranks, the group {world}")
  t = t.contiguous()
  parts = [torch.empty_like(t) for _ in range(world)]
  dist.all_gather(parts, t)
  return torch.cat([parts[r] for r in mesh.mesh.flatten().tolist()], dim=dim)


# ------------------------------------------------- run_bank (kernel 15)

def sharded_run_bank(spec: FilterSpec, kind: int, mesh: DeviceMesh, params,
                     state: bank_ops.BankState, Q, dts, zs, Rs, eas=None):
  """runtime/bank.run_bank on this rank's lanes (on the card one launch
  of kernel 15 on B/n lanes; gathered, bitwise the unsharded launch,
  since a lane's arithmetic does not depend on its block): zs (T, B, dz)
  and eas (T, B, ea) whole-bank, Rs (T, B, dz, dz) whole-bank or (T, dz,
  dz) replicated; dts, Q and params replicated. Returns (this rank's
  final BankState, its ys (T, B/n, dz)). No collective."""
  sh, B = bank_sharding(mesh), zs.shape[1]
  Rs = sh.local(Rs, 1, B) if Rs.ndim == 4 else _replicated(mesh, Rs)
  return bank_ops.run_bank(spec, kind, params, _local_state(sh, state, B),
                           _replicated(mesh, Q), _replicated(mesh, dts),
                           sh.local(zs, 1, B), Rs, sh.local(eas, 1, B))


def _staged_bank_rmse(mesh: DeviceMesh, state: bank_ops.BankState, truth,
                      dims):
  """The bank RMSE from every rank's shard: this rank's squared-error sum
  and entry count, all_reduced over each mesh dim of `dims` in order (so a
  caller stages the cheap link first). One definition for every mesh."""
  x = state.x
  truth = torch.as_tensor(np.asarray(truth), dtype=x.dtype, device=x.device)
  part = torch.stack([((x - truth) ** 2).sum(),
                      torch.tensor(float(x.numel()), dtype=x.dtype,
                                   device=x.device)])
  for d in dims:
    dist.all_reduce(part, group=mesh.get_group(d))
  return torch.sqrt(part[0] / part[1])


def sharded_bank_rmse(mesh: DeviceMesh, state: bank_ops.BankState, truth):
  """Bank-wide RMSE against a broadcast truth vector from every rank's
  shard: partial sums combined by all_reduce over the "bank" dim."""
  return _staged_bank_rmse(mesh, state, truth, (BANK_AXIS,))


def jit_sharded_step(spec: FilterSpec, kind: int, mesh: DeviceMesh,
                     sharding: BankSharding | None = None):
  """One fused bank predict + update on this rank's lanes:
  step(params, state, Q, dt, z (B, dz), R (B, dz, dz), ea (B, ea)) ->
  (this rank's BankState, its y). The name is JAX's; nothing is compiled.
  `sharding` overrides the bank placement (multislice_sharding for a 2-D
  (slice, bank) mesh: the step then spans both dims, still with no
  collective)."""
  sh = sharding if sharding is not None else bank_sharding(mesh)

  def step(params, state, Q, dt, z, R, ea):
    B = z.shape[0]
    return bank_ops.bank_predict_and_update(
        spec, kind, params, _local_state(sh, state, B),
        _replicated(mesh, Q), _replicated(mesh, dt), sh.local(z, 0, B),
        sh.local(R, 0, B), sh.local(ea, 0, B))

  return step


# ----------------------------------------------------- the kernels, sharded

def _dims(axis):
  return (axis,) if isinstance(axis, str) else tuple(axis)


def sharded_live_bank_scan(mesh: DeviceMesh, x, P, zs, dts, q_diag, R,
                           gate: bool = False, axis=BANK_AXIS):
  """Kernel 2 (ops/live_scan.live_bank_scan) on this rank's lanes: x
  (23, B), P (22, 22, B), zs (T, 3, B); dts, q_diag, R replicated.
  `axis` is the mesh dim (or dims) the bank splits over: "bank" on the
  1-D mesh, ("slice", "bank") on a multislice mesh; the kernel is the
  same either way. Returns this rank's (x, P)."""
  sh, B = BankSharding(mesh, _dims(axis)), zs.shape[-1]
  return live_scan.live_bank_scan(
      sh.local(x, -1, B), sh.local(P, -1, B), sh.local(zs, -1, B),
      _replicated(mesh, dts), _replicated(mesh, q_diag),
      _replicated(mesh, R), gate)


def sharded_generic_bank_scan(mesh: DeviceMesh, x, P, zs, dts, eas=None,
                              pss=None, **kw):
  """Kernel 4 (ops/generic_scan.generic_bank_scan, any spec, one kind) on
  this rank's lanes: x, P, zs and the extra-args stream eas split, the
  per-step params stream pss (T, len(ps_keys)) replicated (every rank
  reads the same control inputs); kw are generic_bank_scan's (spec, kind,
  Q, R, params, gate, structure, ps_keys, or call). Returns this rank's
  (x, P)."""
  sh, B = bank_sharding(mesh), zs.shape[-1]
  return generic_scan.generic_bank_scan(
      sh.local(x, -1, B), sh.local(P, -1, B), sh.local(zs, -1, B),
      _replicated(mesh, dts), eas=sh.local(eas, -1, B),
      pss=_replicated(mesh, pss), **kw)


def sharded_vo_bank_scan(mesh: DeviceMesh, x, P, zs, eas, dts, **kw):
  """Kernel 7 (ops/generic_scan.vo_bank_scan, MSCKF camera frames) on this
  rank's lanes: the bank and its landmark stream split, the frame times
  replicated; kw are vo_bank_scan's. Returns this rank's (x, P)."""
  sh, B = bank_sharding(mesh), zs.shape[-1]
  return generic_scan.vo_bank_scan(
      sh.local(x, -1, B), sh.local(P, -1, B), sh.local(zs, -1, B),
      sh.local(eas, -1, B), _replicated(mesh, dts), **kw)


def sharded_generic_bank_scan_mixed(mesh: DeviceMesh, x, P, zs, dts,
                                    kind_idx, eas=None, pss=None, **kw):
  """Kernel 6 (ops/generic_scan.generic_bank_scan_mixed, a kind schedule,
  camera frames among other kinds) on this rank's lanes: the kind
  schedule kind_idx (T,) replicated, every rank dispatching the same
  kinds on its own lanes; kw are generic_bank_scan_mixed's. Returns this
  rank's (x, P)."""
  sh, B = bank_sharding(mesh), zs.shape[-1]
  return generic_scan.generic_bank_scan_mixed(
      sh.local(x, -1, B), sh.local(P, -1, B), sh.local(zs, -1, B),
      _replicated(mesh, dts), _replicated(mesh, kind_idx),
      eas=sh.local(eas, -1, B), pss=_replicated(mesh, pss), **kw)


def sharded_generic_bank_scan_epoch(mesh: DeviceMesh, x, P, zs, dts,
                                    eas=None, pss=None, **kw):
  """Kernel 5 (ops/generic_scan.generic_bank_scan_epoch, one predict and K
  slot updates a step) on this rank's lanes: zs (T, K, dz, B) and the
  per-lane ea stream (satellites per receiver) split, the slot layout
  replicated; kw are generic_bank_scan_epoch's. Returns this rank's
  (x, P)."""
  sh, B = bank_sharding(mesh), zs.shape[-1]
  return generic_scan.generic_bank_scan_epoch(
      sh.local(x, -1, B), sh.local(P, -1, B), sh.local(zs, -1, B),
      _replicated(mesh, dts), eas=sh.local(eas, -1, B),
      pss=_replicated(mesh, pss), **kw)


# ------------------------------------------------ the time-sharded smoother

def _carry(mesh, totals, combine):
  """The composition of the LATER blocks' totals, for this rank's block:
  every rank's total all-gathered (mesh order), then folded from the last
  block back to the one after this rank's. None for the last block."""
  sh = BankSharding(mesh, mesh.mesh_dim_names)
  flat = torch.cat([e.reshape(-1) for e in totals])
  every = gather_bank(mesh, flat[None], 0)
  shapes = [e.shape for e in totals]
  sizes = [e.numel() for e in totals]

  def total(j):
    return tuple(p.reshape(s) for p, s in
                 zip(torch.split(every[j], sizes), shapes))

  carry = None
  for j in range(sh.size - 1, sh.index, -1):
    carry = total(j) if carry is None else combine(carry, total(j))
  return carry


def _block_scan(mesh, elems):
  """Suffix scan of this rank's affine elements (A, b[, V]), lane-major on
  the time axis, continued across the blocks of the later ranks: the
  block scanned locally (kernel 13, ops/smooth_scan.affine_suffix_scan,
  on the card; its plain version on the host), the totals all-gathered,
  the later blocks' totals composed into a carry and the carry applied to
  the block."""
  combine = _affine_combine_lane if len(elems) == 3 else _affine_combine_ab
  bank = [e.permute(2, 0, 1)[None].contiguous() for e in elems]
  A, b, V = smooth_scan.affine_suffix_scan(bank[0], bank[1][..., 0],
                                           *bank[2:], want_A=True)
  out = (_lane(A), _lane(b[..., None])) + (() if V is None else (_lane(V),))
  carry = _carry(mesh, tuple(e[..., :1] for e in out), combine)
  if carry is None:
    return out
  K = elems[0].shape[-1]
  return combine(tuple(c.expand(*c.shape[:-1], K) for c in carry), out)


def _lane(a):
  """One lane of the kernels' layout (1, K, m, n) -> lane-major (m, n, K)."""
  return a[0].permute(1, 2, 0)


def _on_card(t) -> bool:
  """Whether the smoother's wrappers launch kernels for this tensor (they
  run their plain versions on the host)."""
  return t.device.type != "cpu"


def _refuse_sharded_grad(spec, values):
  """rts._refuse_grad's test, for the sharded smoother's adjoint."""
  from rednose_tpu_torch.smoothing import rts

  where = f"sharded RTS smoother of spec {spec.name!r} on the card"
  missing = ("gradients need the sharded smoother's adjoint, which is not "
             "ported; smooth CPU tensors (the plain versions, which autograd "
             "runs through), call the unsharded rts_smooth_parallel "
             "(refine=0), or detach the inputs")
  try:
    rts._refuse_transforms(where, values)
  except NotImplementedError as err:
    raise NotImplementedError(f"{where}: {missing}") from err
  if rts._grad_wanted(values):
    raise NotImplementedError(f"{where}: {missing}")


def sharded_rts_smooth_parallel(mesh: DeviceMesh, spec: FilterSpec, params,
                                x_pred, P_pred, x_post, P_post, t,
                                norm_quats: bool = False, dts=None,
                                refine: int | None = None):
  """smoothing/rts.rts_smooth_parallel with the TIME axis split over every
  rank of the mesh: rank r smooths the rows [r T/n, (r+1) T/n) and
  returns them (x_smooth (T/n, dim_x), P_smooth (T/n, de, de)); T must
  divide by n. The whole forward-pass log (time-major, as
  rts_smooth_parallel takes it) is on every rank, so the step across a
  block boundary needs no halo exchange.

  Each rank forms the affine elements (C_k, C_k u_{k+1}, V_k) of its
  rows (kernel 11 on the card, ops/smooth_scan.smooth_gains; its plain
  version on the host), the last rank's final row the zero map (e_{T-1}
  = 0), scans them locally, all-gathers the block totals, composes the
  later blocks' totals into a carry and applies it to its block
  (_block_scan). Each Newton pass of `refine` needs the corrections a
  row later: the corrections of every block are all-gathered (T x d2
  values), then the (A, b) elements are formed (kernel 11's refine
  variant) and scanned the same way. The rows are injected by kernel 14
  (smooth_inject). The result equals the unsharded rts_smooth_parallel up
  to the rounding of the other association.

  Gradients: on the card it raises for an input that requires grad, and
  under torch.func's transforms other than vmap, naming the sharded
  smoother's adjoint, which is not ported (kernels 11-14 write into new
  tensors, so the result would come back silently detached); on the host
  the plain versions keep their autograd."""
  if _on_card(x_post):
    _refuse_sharded_grad(spec, (x_pred, P_pred, x_post, P_post, t, dts,
                                *params.values()))
  x_pred, P_pred, x_post, P_post, t = (
      _replicated(mesh, a) for a in (x_pred, P_pred, x_post, P_post, t))
  resolve_device(x_post.device)
  d2 = spec.dim_main_err
  T = x_post.shape[0]
  rows = BankSharding(mesh, mesh.mesh_dim_names).lanes(T)
  lo, hi = rows.start, rows.stop
  if T < 2:
    return x_post[lo:hi].clone(), P_post[lo:hi].clone()
  dts = _replicated(mesh, _dts(t, dts))
  k_hi = min(hi, T - 1)          # the block's elements k in [lo, k_hi)
  pad = hi - k_hi                # the zero map at k = T - 1

  def zero_pad(e):
    return torch.cat([e, e.new_zeros(e.shape[:-1] + (pad,))], dim=-1) \
        if pad else e

  def one(a):
    return a[None].contiguous()

  win = slice(lo, k_hi + 1)      # the rows the block's elements read
  xw_pred, xw_post = one(x_pred[win]), one(x_post[win])
  C, b, V = smooth_scan.smooth_gains(
      spec, params, xw_pred, one(P_pred[win]), xw_post, one(P_post[win]),
      one(dts[lo:k_hi].to(x_post.dtype)))
  _, e_l, D_l = _block_scan(mesh, (zero_pad(_lane(C)),
                                   zero_pad(_lane(b[..., None])),
                                   zero_pad(_lane(V))))
  e_acc = e_l[:, 0].T                                      # (T/n, d2)

  f64 = x_post.dtype == torch.float64
  n_refine = (2 if (spec.is_eskf and f64) else 0) if refine is None \
      else refine
  for _ in range(n_refine if T > 2 else 0):
    # every block's corrections; element k reads the one of row k + 1
    e_all = gather_bank(mesh, e_acc, 0)                    # (T, d2)
    A, b = smooth_scan.smooth_gains(spec, params, xw_pred, None, xw_post,
                                    None, None, C=C, e=one(e_all[lo:]),
                                    norm_quats=norm_quats)
    _, e_l = _block_scan(mesh, (zero_pad(_lane(A)),
                                zero_pad(_lane(b[..., None]))))
    e_acc = e_l[:, 0].T

  xs, Ps = smooth_scan.smooth_inject(
      spec, params, one(x_post[lo:hi]), one(P_post[lo:hi]),
      one(e_acc[:k_hi - lo]), one(D_l.permute(2, 0, 1)[:k_hi - lo]),
      norm_quats=norm_quats)
  return xs[0], Ps[0]


# ------------------------------------------------------- multi-slice meshes

def _hostnames(dev) -> list:
  """Every rank's host name, in rank order."""
  name = socket.gethostname().encode()[:255]
  mine = torch.zeros(256, dtype=torch.uint8, device=dev)
  mine[:len(name)] = torch.tensor(list(name), dtype=torch.uint8)
  parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
  dist.all_gather(parts, mine)
  return [bytes(p.cpu().tolist()).rstrip(b"\0").decode() for p in parts]


def make_multislice_mesh(n_slices: int, devices=None) -> DeviceMesh:
  """2-D ("slice", "bank") mesh: "bank" spans the ranks within a slice,
  "slice" spans slices. A slice is a host: its ranks share the host's
  links (NVLink between its cards), and the slices meet over the network.
  The bank splits over both dims (multislice_sharding); the split lets a
  collective reduce within the slice first and then move one value per
  slice across (multislice_bank_rmse).

  The ranks are ordered by (host, rank) and each mesh row must lie on one
  host: a row that would span hosts raises. `devices` as in
  make_bank_mesh."""
  dev = _rank_device(devices)
  _default_group()
  world = dist.get_world_size()
  if world % n_slices:
    raise ValueError(f"{world} ranks do not split into {n_slices} slices")
  hosts = _hostnames(dev)
  ranks = sorted(range(world), key=lambda r: (hosts[r], r))
  grid = torch.tensor(ranks).reshape(n_slices, -1)
  for row in grid.tolist():
    if len({hosts[r] for r in row}) != 1:
      raise ValueError(f"mesh row {row} spans hosts "
                       f"{sorted({hosts[r] for r in row})}")
  return DeviceMesh(dev.type, grid, mesh_dim_names=(SLICE_AXIS, BANK_AXIS))


def multislice_sharding(mesh: DeviceMesh) -> BankSharding:
  """The bank folded over ("slice", "bank"): B / (n_slices n_bank) lanes
  a rank."""
  return BankSharding(mesh, (SLICE_AXIS, BANK_AXIS))


def multislice_bank_rmse(mesh: DeviceMesh, state: bank_ops.BankState,
                         truth):
  """Bank-wide RMSE on a multislice mesh, staged: all_reduce over "bank"
  within the slice first, then one pair of values per slice over
  "slice". The same value as sharded_bank_rmse."""
  return _staged_bank_rmse(mesh, state, truth, (BANK_AXIS, SLICE_AXIS))
