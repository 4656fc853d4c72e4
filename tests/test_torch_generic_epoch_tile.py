"""Kernel 5's tile form (mode "epoch", ops/entry_slab.py): each step a
predict, then the epoch's slots in order, each slot a unit (one per
distinct kind and gate) taken from the emitted slot table with its z and
ea rows and its R, the step's inputs staged a step ahead.

The role split of every epoch unit partitions the upper triangle (loc's
two kinds, the live spec's four). The emitted text, built with the host
C++ compiler as double (tests/torch_parity.run_host: the template's host
loop runs, for each filter and step, the predict's roles, then for each
slot its shared values, every role's compute, every role's store, reading
the step's input rows from a copy as the card reads them from shared
memory), is held at rtol 1e-9 against the JAX package's
pallas_bank.generic_bank_scan_epoch in interpret mode (loc: 4 pseudoranges
+ 4 rates, and the two kinds interleaved, gate on, one bad satellite) and
the JAX lane path (the live spec's four kinds, gate off and on), B = 16,
T = 8; and against its own global form at rtol 1e-12. Skips the host
builds, with the reason, where no C++ compiler is on PATH."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import live as jlive
from rednose_tpu.models import loc as jloc
from rednose_tpu.ops import lane_bank as jlane
from rednose_tpu.ops import pallas_bank
from rednose_tpu.ops import sparsity as jsparsity
from rednose_tpu_torch import interop
from rednose_tpu_torch.models import live, loc
from rednose_tpu_torch.models.live import ObservationKind as K
from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
from rednose_tpu_torch.ops import entry_slab, generic_scan, sparsity
from torch_parity import host_compiler, np_, run_host

B, T = 16, 8
RTOL = 1e-9
# a pseudorange is ~2e7 m: float64 rounds each innovation by ~4e-9 m, and
# the gain carries that into the ~1 m/s velocities, whatever the op order
LOC_ATOL_X = 1e-7
PR, RATE = K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS
LOC_ORDERS = {"4 pseudoranges + 4 rates": (PR,) * 4 + (RATE,) * 4,
              "interleaved": (PR, RATE, RATE, PR, RATE, PR, PR, RATE)}
LIVE_KINDS = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)
# a live position is ~2.7e6 m (float64 ulp 4.7e-10 m); with the gate off a
# far lane is pulled by 1 km fixes through 32 updates, and the emitter's
# structural algebra and the lane path's dense one part by tens of ulps
LIVE_ATOL_X = 1e-7


def _needs_compiler():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted source")


def _loc_call(slots):
  spec = loc.build_loc_spec()
  return generic_scan.KernelCall(
      spec, "epoch", slots, Q=loc.LocKalman.Q,
      R_list=[loc.LocKalman.obs_noise[k] for k in slots],
      structure=sparsity.structure_for(spec, loc.LocKalman.initial_x))


def _gated(spec, gate):
  """The spec with every live kind gated or not (the live kinds are not
  gated by default; an epoch call gates a kind as its maha_test says)."""
  obs = dict(spec.obs)
  for k in LIVE_KINDS:
    obs[int(k)] = dataclasses.replace(obs[int(k)], maha_test=gate)
  return dataclasses.replace(spec, obs=obs)


def _live_call(spec=None):
  spec = spec or live.build_live_spec()
  return generic_scan.KernelCall(
      spec, "epoch", LIVE_KINDS, Q=live.LiveKalman.Q,
      R_list=[live.LiveKalman.obs_noise[k] for k in LIVE_KINDS],
      structure=sparsity.structure_for(spec, live.LiveKalman.initial_x))


@pytest.mark.parametrize("name", [f"loc unit {k}" for k in (PR, RATE)]
                         + [f"live unit {int(k)}" for k in LIVE_KINDS])
def test_roles_partition_the_upper_triangle(name):
  """Each epoch unit's roles store every changed P entry of the upper
  triangle once, no unchanged one, and only role 0 stores x; its shared
  function and role set print once, however many slots run it."""
  kind = int(name.split()[-1])
  c = _loc_call(LOC_ORDERS["interleaved"]) if name.startswith("loc") \
      else _live_call()
  gate = dict(c._units())[kind]
  upd = entry_slab.update_phase(c.spec, kind, c.structure, c._pnames, gate)
  cuts = frozenset(e.id for e in entry_slab.shared_nodes(upd))
  de = c.spec.dim_err
  upper = {(i, j) for i in range(de) for j in range(i, de)}
  assert set(upd.p_out) == upper and cuts
  roles = entry_slab.role_split(upd, entry_slab.TILE_ROLES, cuts)
  stored = [ij for r in roles for arr, ij, _ in r if arr == "P"]
  unchanged = {ij for ij, v in upd.p_out.items()
               if entry_slab._unchanged(v, "P", ij)}
  assert len(stored) == len(set(stored))
  assert set(stored) | unchanged == upper and not set(stored) & unchanged
  assert not [i for r in roles[1:] for arr, i, _ in r if arr == "x"]
  src = c.source(torch.float32)
  unit = entry_slab._unit_name(kind, gate)
  assert src.count(f"void {unit}_shared(") == 1
  for r in range(entry_slab.TILE_ROLES):
    assert src.count(f"void {unit}_r{r}(") == 1
    assert src.count(f"void {unit}_r{r}_store(") == 1


def test_epoch_design_lines_and_slot_table():
  """loc's epoch prints the tile in float and double, with 2 units for
  its 8 slots and the slot table of gen_step's offsets (slot u: z row u,
  ea row 6 u, R offset u); msckf_eskf's epoch in double does not fit and
  keeps the global form, named; tile=False prints the global form."""
  c = _loc_call(LOC_ORDERS["interleaved"])
  for dt, nbytes in ((torch.float32, "35,456"), (torch.float64, "70,912")):
    src = c.source(dt)
    assert f"// design: tile, {entry_slab.TILE_ROLES} roles, 8 slots of 2 " \
        "units, each step's inputs staged a step ahead" in src
    assert f"({nbytes} B a block)" in src
    assert "#define REDNOSE_GENERIC_SCAN_TILE_EPOCH" in src
    assert "gen_step(" not in src
    units = [0 if k == PR else 1 for k in LOC_ORDERS["interleaved"]]
    for u, unit in enumerate(units):
      assert f"    case {u}: return {{{unit}, {u}, {6 * u}, {u}}};" in src
  g = c.source(torch.float32, tile=False)
  assert "// design:" not in g and "GEN_INLINE void gen_step(" in g
  espec = MSCKFEskf.build_spec()
  e = generic_scan.KernelCall(
      espec, "epoch", (12, 12), Q=MSCKFEskf.Q,
      R_list=[MSCKFEskf.obs_noise[12]] * 2,
      structure=sparsity.structure_for(espec, MSCKFEskf.initial_x))
  assert "// design: tile" in e.source(torch.float32)
  d = e.source(torch.float64)
  assert "// design: global: the tile of 32 filters (409,856 B in double)" \
      in d and "gen_tile_" not in d


def _loc_inputs(seed, slots):
  """A loc bank near x0 (P = 10 I), and per slot (T, B, 1) measurements
  consistent with it and (T, B, 6) satellite states, slot 1's satellite
  1e5 m off on every fourth lane (gated)."""
  rng = np.random.RandomState(seed)
  x = np.tile(jloc.LocKalman.initial_x, (B, 1)) + rng.randn(B, 11)
  P = np.tile(np.diag(np.full(11, 10.0))[:, :, None], (1, 1, B))
  zs, eas = [], []
  for k in slots:
    sat = jloc.LocKalman.initial_x[:3] + 2e7 * rng.randn(T, B, 3)
    vel = 3e3 * rng.randn(T, B, 3)
    d = x[None, :, :3] - sat
    u = d / np.linalg.norm(d, axis=-1, keepdims=True)
    if k == PR:
      z = np.linalg.norm(d, axis=-1) + x[None, :, 6] + 2.0 * rng.randn(T, B)
    else:
      z = (np.sum(u * (x[None, :, 3:6] - vel), axis=-1) + x[None, :, 7]
           + 0.05 * rng.randn(T, B))
    zs.append(z[..., None])
    eas.append(np.concatenate([sat, vel], axis=-1))
  zs, eas = np.stack(zs, axis=1), np.stack(eas, axis=1)    # (T, K, B, .)
  zs[:, 1, ::4, 0] += 1e5
  return x, P, zs, eas, np.full(T, 1.0)


def _close(ours, ref_x, ref_P, atol_x=1e-9, atol_P=1e-10):
  np.testing.assert_allclose(np_(ours[0]), ref_x, rtol=RTOL, atol=atol_x)
  np.testing.assert_allclose(np_(ours[1]), ref_P, rtol=RTOL, atol=atol_P)
  np.testing.assert_array_equal(np_(ours[1]),
                                np_(ours[1]).transpose(1, 0, 2))


def _bank_minor(a):
  """(T, K, B, n) -> the wrappers' (T, K, n, B)."""
  return np.ascontiguousarray(np.swapaxes(a, -1, -2))


@pytest.mark.parametrize("order", list(LOC_ORDERS))
def test_loc_epoch_tile_matches_jax_kernel(order):
  """loc's epoch tile, gate on (each slot gated on its own), against the
  JAX kernel 5 in interpret mode with all slots inline."""
  _needs_compiler()
  slots = LOC_ORDERS[order]
  x, P, zs, eas, dts = _loc_inputs(50, slots)
  xp, Pp = pallas_bank.pack_bank(jnp.asarray(x), jnp.asarray(P))
  jspec = jloc.build_loc_spec()
  xo, Po = pallas_bank.generic_bank_scan_epoch(
      xp, Pp, pallas_bank.pack_bank_epochs(jnp.asarray(zs)),
      jnp.asarray(dts), pallas_bank.pack_bank_epochs(jnp.asarray(eas)),
      spec=jspec, slot_kinds=tuple(int(k) for k in slots),
      q_diag=tuple(np.diag(jloc.LocKalman.Q)),
      r_mats=tuple(tuple(tuple(r) for r in jloc.LocKalman.obs_noise[int(k)])
                   for k in slots),
      t_chunk=4, tile_b=8, interpret=True, slot_mode="unroll",
      structure=jsparsity.structure_for(jspec, jloc.LocKalman.initial_x))
  c = _loc_call(slots)
  assert "// design: tile" in c.source(torch.float64)
  ours = run_host("epoch", c.spec, slots, x.T, P, _bank_minor(zs), dts,
                  Q=c.Q, R_list=c.R_list, structure=c.structure,
                  eas=_bank_minor(eas))
  rx, rP = interop.bank_from_jax(xo, Po, torch.float64)
  _close(ours, np_(rx), np_(rP), atol_x=LOC_ATOL_X)


@pytest.mark.parametrize("order", list(LOC_ORDERS))
def test_loc_epoch_tile_matches_its_global_form(order):
  """The same variant's tile and global form (one thread a filter, the
  slots through gen_step, inputs read in place), both built as double on
  the host, agree to rounding."""
  _needs_compiler()
  slots = LOC_ORDERS[order]
  x, P, zs, eas, dts = _loc_inputs(51, slots)
  c = _loc_call(slots)
  kw = dict(Q=c.Q, R_list=c.R_list, structure=c.structure,
            eas=_bank_minor(eas))
  args = ("epoch", c.spec, slots, x.T, P, _bank_minor(zs), dts)
  tile = run_host(*args, **kw)
  glob = run_host(*args, **kw, tile=False)
  for a, b in zip(tile, glob):
    np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("gate", [False, True])
def test_live_epoch_tile_matches_jax_lane(gate):
  """The live spec's all-sensors epoch (gyro, accel, camera rotation,
  ECEF_POS; every fourth lane's measurements far off, so the gate has
  work) against the JAX lane path."""
  _needs_compiler()
  rng = np.random.RandomState(52)
  x = np.tile(jlive.LiveKalman.initial_x, (B, 1)) + 0.01 * rng.randn(B, 23)
  x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
  A = 0.1 * rng.randn(B, 22, 22)
  P = np.einsum("bij,bkj->ikb", A, A) + 0.01 * np.diag(
      jlive.LiveKalman.initial_P_diag)[:, :, None]
  tspec = _gated(live.build_live_spec(), gate)
  far = np.arange(B) % 4 == 0
  zs = np.zeros((T, len(LIVE_KINDS), B, 3))
  for s, k in enumerate(LIVE_KINDS):
    h = torch.func.vmap(lambda xx, k=k: tspec.obs[k].h({}, xx, None))(
        torch.as_tensor(x)).numpy()
    scale, off = (5.0, 1e3) if k == K.ECEF_POS else (0.05, 20.0)
    zs[:, s] = h + np.where(far[:, None], off, scale) * rng.randn(T, B, 3)
  dts = np.full(T, 0.01)
  c = _live_call(tspec)
  assert "// design: tile" in c.source(torch.float64)
  jspec = _gated(jlive.LiveKalman.build_spec(), gate)
  xr, Pr = jlane.jit_lane_epoch_bank_scan(
      jspec, tuple(int(k) for k in LIVE_KINDS))(
      {}, jnp.asarray(x), jnp.asarray(P), jnp.asarray(jlive.LiveKalman.Q),
      jnp.asarray(dts), jnp.asarray(zs),
      tuple(jnp.asarray(r) for r in c.R_list))
  ours = run_host("epoch", tspec, LIVE_KINDS, x.T, P, _bank_minor(zs), dts,
                  Q=c.Q, R_list=c.R_list, structure=c.structure)
  _close(ours, np.asarray(xr).T, np.asarray(Pr), atol_x=LIVE_ATOL_X,
         atol_P=1e-9)
