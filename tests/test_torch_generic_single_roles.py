"""Kernel 4's tile form (mode "single", ops/entry_slab.py): the split of
each phase over the roles, and the emitted role bodies run on the host.

The role split is checked in Python: the roles' stored P entries and the
entries a phase leaves unchanged partition the upper triangle exactly
once, and only role 0 stores x (live, car, loc and msckf_eskf POSITION).
The emitted text of a single variant, built with the host C++ compiler as
double (tests/torch_parity.run_host: the template's host loop runs, for
each filter and step, every role's compute, then every role's store), is
held at rtol 1e-9 against the JAX package's pallas_bank.generic_bank_scan
in interpret mode (car with the params stream, loc observe) and the JAX
lane path (the live spec's ECEF_POS, gate on and off), B = 16, T = 8.
Variants of the other modes emit no role section, except mode "mixed"
without a camera-frame unit (kernel 6), whose tile is held in
tests/test_torch_generic_mixed_tile.py. Skips the host builds, with the
reason, where no C++ compiler is on PATH."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import car as jcar
from rednose_tpu.models import live as jlive
from rednose_tpu.models import loc as jloc
from rednose_tpu.ops import lane_bank as jlane
from rednose_tpu.ops import pallas_bank
from rednose_tpu.ops import sparsity as jsparsity
from rednose_tpu_torch import interop
from rednose_tpu_torch.models import car, live, loc
from rednose_tpu_torch.models.live import ObservationKind as K
from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
from rednose_tpu_torch.ops import entry_slab, generic_scan, sparsity
from torch_parity import host_compiler, np_, run_host

B, T = 16, 8
RTOL = 1e-9
PS_KEYS = ("u", "steer_angle_deg")
LOC_ATOL_X = 1e-7   # a ~2e7 m range rounds by ~4e-9 m in float64


def _needs_compiler():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted source")


def _calls():
  """(model, KernelCall) of the single variants the main paths launch."""
  lspec, cspec = live.build_live_spec(), car.CarKalman.build_spec()
  lcspec, espec = loc.LocKalman.build_spec(), MSCKFEskf.build_spec()

  def call(model, spec, kind, **kw):
    return generic_scan.KernelCall(
        spec, "single", (kind,), Q=model.Q, R_list=(model.obs_noise[kind],),
        structure=sparsity.structure_for(spec, model.initial_x), **kw)

  return {
      "live": call(live.LiveKalman, lspec, K.ECEF_POS, gate=True),
      "car": call(car.CarKalman, cspec, 1, ps_keys=PS_KEYS),
      "loc": call(loc.LocKalman, lcspec, K.PSEUDORANGE_GPS),
      "msckf_eskf": call(MSCKFEskf, espec, 12),
  }


MIXED_KINDS = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)


def _mixed_call():
  """The live spec's 4-kind mixed variant (KalmanBank.run_mixed)."""
  spec = live.build_live_spec()
  return generic_scan.KernelCall(
      spec, "mixed", MIXED_KINDS, Q=live.LiveKalman.Q,
      R_list=[live.LiveKalman.obs_noise[k] for k in MIXED_KINDS],
      structure=sparsity.structure_for(spec, live.LiveKalman.initial_x))


@pytest.mark.parametrize("name", ["live", "car", "loc", "msckf_eskf"]
                         + [f"live mixed unit {u}" for u in range(4)])
def test_roles_partition_the_upper_triangle(name):
  """For each single variant and each unit of the live 4-kind mixed
  variant."""
  mixed = name.startswith("live mixed")
  c = _mixed_call() if mixed else _calls()[name]
  u = int(name[-1]) if mixed else 0
  st = c.structure
  pred = entry_slab.predict_phase(c.spec, st, c._pnames, c._q_pattern)
  kind, gate = c._units()[u]
  upd = entry_slab.update_phase(c.spec, kind, st, c._pnames, gate)
  cuts = frozenset(e.id for e in entry_slab.shared_nodes(upd))
  de = c.spec.dim_err
  upper = {(i, j) for i in range(de) for j in range(i, de)}
  for ph, stop in ((pred, frozenset()), (upd, cuts)):
    assert set(ph.p_out) == upper
    roles = entry_slab.role_split(ph, entry_slab.TILE_ROLES, stop)
    assert len(roles) == entry_slab.TILE_ROLES
    stored = [ij for r in roles for arr, ij, _ in r if arr == "P"]
    unchanged = {ij for ij, v in ph.p_out.items()
                 if entry_slab._unchanged(v, "P", ij)}
    assert len(stored) == len(set(stored))               # once each
    assert set(stored) | unchanged == upper              # all of them
    assert not set(stored) & unchanged
    assert all(all(ij[0] <= ij[1] for arr, ij, _ in r if arr == "P")
               for r in roles)
    xs = [i for r in roles[1:] for arr, i, _ in r if arr == "x"]
    assert not xs                                        # x: role 0 only
    assert sorted(i for arr, i, _ in roles[0] if arr == "x") == [
        i for i, v in enumerate(ph.x_out)
        if not entry_slab._unchanged(v, "x", (i,))]
  # the update's roles read the innovation only from the scratch
  assert len(cuts) > 0
  src = c.source(torch.float32)
  assert "#define REDNOSE_GENERIC_SCAN_TILE" in src
  if mixed:   # the scratch holds the largest unit's values
    nscr = int(src.split("constexpr int NSCR = ")[1].split(";")[0])
    assert nscr >= len(cuts)
    assert f"void gen_update_k{kind}_shared(" in src
  else:
    assert f"constexpr int NSCR = {len(cuts)};" in src


def test_other_modes_emit_no_role_section():
  """Mode 'epoch' of live, car, loc and msckf_eskf (float and double)
  prints its tile (kernel 5: one shared function and one role set per
  unit, the slot table, no gen_step), or, where its tile does not fit
  (msckf_eskf in double), the global form, named; its tile is held in
  tests/test_torch_generic_epoch_tile.py. A mode-'mixed' variant without a camera-frame unit (live, car,
  loc, msckf_eskf; float and double) prints one shared function and one
  role set per unit and switches them on the step's kind, or, where its
  tile does not fit (msckf_eskf in double), the global form, named.
  msckf_eskf's mode 'frame' and mode 'mixed' with a camera-frame unit
  print a tile of TILE_ROLES_FRAME roles in float and, in double, the
  global form, named."""
  srcs, mixed = [], []
  for model, spec, kinds in (
      (live.LiveKalman, live.build_live_spec(), (K.PHONE_GYRO, K.ECEF_POS)),
      (car.CarKalman, car.CarKalman.build_spec(), (1, 2)),
      (loc.LocKalman, loc.LocKalman.build_spec(),
       (K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS)),
      (MSCKFEskf, MSCKFEskf.build_spec(), (12,))):
    st = sparsity.structure_for(spec, model.initial_x)
    R = [model.obs_noise[k] for k in kinds]
    for mode in ("mixed", "epoch"):
      c = generic_scan.KernelCall(spec, mode, kinds, Q=model.Q, R_list=R,
                                  structure=st)
      for dt in (torch.float32, torch.float64):
        (mixed if mode == "mixed" else srcs).append((c, dt, c.source(dt)))
  espec = MSCKFEskf.build_spec()
  est = sparsity.structure_for(espec, MSCKFEskf.initial_x)
  for c in (generic_scan.KernelCall(
      espec, "frame", (16,), Q=MSCKFEskf.Q, R_list=(1e-4 * np.eye(8),),
      structure=est), generic_scan.KernelCall(
      espec, "mixed", (12, 16), Q=MSCKFEskf.Q,
      R_list=(np.eye(3), 1e-4 * np.eye(8)), structure=est)):
    f32, f64 = c.source(), c.source(torch.float64)
    assert f"// design: tile, {entry_slab.TILE_ROLES_FRAME} roles" in f32
    assert "(221,824 B a block)" in f32
    assert f32.count("GEN_PHASE void ") == 2    # the frame's serial stages
    assert "// design: global: the tile of 32 filters (443,648 B in " \
        "double)" in f64 and "gen_tile_" not in f64
  for c, dt, src in srcs:
    if c.spec.name == "msckf_eskf" and dt == torch.float64:
      assert "// design: global: the tile of 32 filters" in src
      assert "REDNOSE_GENERIC_SCAN_TILE" not in src
      assert "gen_tile_" not in src and "_r0(" not in src
      assert "GEN_INLINE void gen_step(" in src
      continue
    assert f"// design: tile, {entry_slab.TILE_ROLES} roles, " \
        f"{len(c.kinds)} slots of " in src
    assert "#define REDNOSE_GENERIC_SCAN_TILE_EPOCH" in src
    assert f"constexpr int NSLOTS = {len(c.kinds)};" in src
    assert "gen_step(" not in src
    for k, g in set(c._units()):
      name = entry_slab._unit_name(k, g)
      assert src.count(f"void {name}_shared(") == 1
      assert src.count(f"void {name}_r0(") == 1
  for c, dt, src in mixed:
    units = c._units()
    if c.spec.name == "msckf_eskf" and dt == torch.float64:
      assert "// design: global" in src and "gen_tile_" not in src
      assert "GEN_INLINE void gen_step(" in src
      continue
    assert f"// design: tile, {entry_slab.TILE_ROLES} roles, {len(units)} " \
        "units" in src
    assert "#define REDNOSE_GENERIC_SCAN_TILE_KINDS" in src
    assert "gen_step(" not in src
    for k, g in units:
      name = entry_slab._unit_name(k, g)
      assert src.count(f"void {name}_shared(") == 1
      for r in range(entry_slab.TILE_ROLES):
        assert src.count(f"void {name}_r{r}(") == 1
        assert src.count(f"void {name}_r{r}_store(") == 1
    assert src.count("_shared(const scalar_t* x") == len(set(units))
  # the single variant that does not fit keeps the global form, named
  c = _calls()["msckf_eskf"]
  g = c.source(torch.float64)
  assert "// design: global" in g and "gen_tile_" not in g
  assert "GEN_INLINE void gen_step(" in g


def _packed(model, rng, scale, P_diag=None):
  x = np.tile(model.initial_x, (B, 1)) + scale * rng.randn(
      B, len(model.initial_x))
  P_diag = model.initial_P_diag if P_diag is None else P_diag
  P = np.tile(np.diag(P_diag)[:, :, None], (1, 1, B))
  xp, Pp = pallas_bank.pack_bank(jnp.asarray(x), jnp.asarray(P))
  return xp, Pp, interop.bank_from_jax(xp, Pp, torch.float64)


def _unpacked(xo, Po):
  x, P = interop.bank_from_jax(xo, Po, torch.float64)
  return np_(x), np_(P)


def _close(ours, ref_x, ref_P, atol_x=1e-9, atol_P=1e-10):
  np.testing.assert_allclose(np_(ours[0]), ref_x, rtol=RTOL, atol=atol_x)
  np.testing.assert_allclose(np_(ours[1]), ref_P, rtol=RTOL, atol=atol_P)
  np.testing.assert_array_equal(np_(ours[1]),
                                np_(ours[1]).transpose(1, 0, 2))


def test_car_tile_matches_jax_kernel():
  """The car's YAW_RATE tile with the per-step params stream."""
  _needs_compiler()
  rng = np.random.RandomState(30)
  xp, Pp, (x, P) = _packed(car.CarKalman, rng, 0.05)
  zs = 0.1 * rng.randn(T, B, 1)
  pss = np.stack([15.0 + 5.0 * rng.rand(T),
                  30.0 * np.sin(np.linspace(0, 3, T))], axis=1)
  base = tuple((k, float(v)) for k, v in sorted(jcar.DEFAULT_PARAMS.items())
               if k not in PS_KEYS)
  dts = np.full(T, 0.05)
  jspec = jcar.CarKalman.build_spec()
  xo, Po = pallas_bank.generic_bank_scan(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      jnp.asarray(dts), None, jnp.asarray(pss), spec=jspec, kind=1,
      q_diag=tuple(np.diag(jcar.CarKalman.Q)), r_mat=((0.001**2,),),
      gate=True, t_chunk=4, tile_b=8, interpret=True,
      structure=jsparsity.structure_for(jspec, jcar.CarKalman.initial_x),
      ps_keys=PS_KEYS, base_params=base)
  spec = car.CarKalman.build_spec()
  assert "REDNOSE_GENERIC_SCAN_TILE" in _calls()["car"].source(torch.float64)
  ours = run_host(
      "single", spec, (1,), x, P, np.swapaxes(zs, 1, 2), dts,
      Q=car.CarKalman.Q, R_list=(car.CarKalman.obs_noise[1],), gate=True,
      structure=sparsity.structure_for(spec, car.CarKalman.initial_x),
      pss=pss, ps_keys=PS_KEYS)
  _close(ours, *_unpacked(xo, Po))


def test_loc_observe_tile_matches_jax_kernel():
  """loc's PSEUDORANGE_GPS tile (KalmanBank.observe) with the satellite
  positions streamed as extra args."""
  _needs_compiler()
  rng = np.random.RandomState(31)
  xp, Pp, (x, P) = _packed(jloc.LocKalman, rng, 1.0, np.full(11, 10.0))
  kind = K.PSEUDORANGE_GPS
  xs = np_(x).T
  sat = jloc.LocKalman.initial_x[:3] + 2e7 * rng.randn(T, B, 3)
  zs = (np.linalg.norm(xs[None, :, :3] - sat, axis=-1) + xs[None, :, 6]
        + 2.0 * rng.randn(T, B))[..., None]
  dts = np.full(T, 0.1)
  jspec = jloc.build_loc_spec()
  xo, Po = pallas_bank.generic_bank_scan(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      jnp.asarray(dts), pallas_bank.pack_bank_measurements(jnp.asarray(sat)),
      spec=jspec, kind=int(kind), q_diag=tuple(np.diag(jloc.LocKalman.Q)),
      r_mat=tuple(tuple(r) for r in jloc.LocKalman.obs_noise[int(kind)]),
      gate=True, t_chunk=4, tile_b=8, interpret=True,
      structure=jsparsity.structure_for(jspec, jloc.LocKalman.initial_x))
  spec = loc.build_loc_spec()
  ours = run_host(
      "single", spec, (kind,), x, P, np.swapaxes(zs, 1, 2), dts,
      Q=loc.LocKalman.Q, R_list=(loc.LocKalman.obs_noise[kind],), gate=True,
      structure=sparsity.structure_for(spec, loc.LocKalman.initial_x),
      eas=np.swapaxes(sat, 1, 2))
  _close(ours, *_unpacked(xo, Po), atol_x=LOC_ATOL_X)


@pytest.mark.parametrize("gate", [False, True])
def test_live_tile_matches_jax_lane(gate):
  """The unmodified live spec's ECEF_POS tile, gate off and on (every
  fourth lane's fixes 1 km off, so the gate has work), against the JAX
  lane path."""
  _needs_compiler()
  rng = np.random.RandomState(32)
  x = np.tile(jlive.LiveKalman.initial_x, (B, 1)) + 0.01 * rng.randn(B, 23)
  x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
  A = 0.1 * rng.randn(B, 22, 22)
  P = np.einsum("bij,bkj->ikb", A, A) + 0.01 * np.diag(
      jlive.LiveKalman.initial_P_diag)[:, :, None]
  far = np.where(np.arange(B) % 4 == 0, 1e3, 5.0)[None, :, None]
  zs = x[None, :, :3] + far * rng.randn(T, B, 3)
  dts = np.full(T, 0.01)
  R = live.LiveKalman.obs_noise[K.ECEF_POS]
  jspec = jlive.LiveKalman.build_spec()
  om = jspec.obs[int(K.ECEF_POS)]
  # the JAX lane path gates as the kind's maha_test says (off for the
  # live ECEF_POS kind): the gate-on reference is the spec with it on
  jspec = dataclasses.replace(jspec, obs={
      **jspec.obs, int(K.ECEF_POS): dataclasses.replace(om, maha_test=gate)})
  xr, Pr = jlane.lane_bank_scan(
      jspec, int(K.ECEF_POS), {}, jnp.asarray(x), jnp.asarray(P),
      jnp.asarray(jlive.LiveKalman.Q), jnp.asarray(dts), jnp.asarray(zs),
      jnp.asarray(R))
  tspec = live.LiveKalman.build_spec()
  ours = run_host("single", tspec, (K.ECEF_POS,), x.T, P,
                  np.swapaxes(zs, 1, 2), dts, Q=jlive.LiveKalman.Q,
                  R_list=(R,), gate=gate,
                  structure=sparsity.structure_for(
                      tspec, live.LiveKalman.initial_x))
  _close(ours, np.asarray(xr).T, np.asarray(Pr), atol_x=1e-8, atol_P=1e-9)
