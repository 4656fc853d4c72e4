"""The spec-to-CUDA emitter (ops/entry_slab.py), run on the host: the
emitted source, the same text nvcc builds for kernels 4-6, is compiled
with the host C++ compiler as scalar_t = double and run over a small bank
(B = 16, T = 8) through the template's host loop (tests/torch_parity.py).

It is held, float64, at rtol 1e-9, against the JAX package's
pallas_bank.generic_bank_scan / _mixed / _epoch in interpret mode for car
and loc (as tests/test_pallas_bank.py and test_car_bank.py run them), and
against the JAX lane path for the live spec; plus the two latent faults of
the JAX emitter, which the port must not copy, against the port's
core/step oracle. Skips, with the reason, where no C++ compiler is on
PATH."""

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
from rednose_tpu_torch.core import step as tstep
from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel
from rednose_tpu_torch.models import car, live, loc
from rednose_tpu_torch.models.live import ObservationKind as K
from rednose_tpu_torch.ops import entry_slab, generic_scan, sparsity
from torch_parity import host_compiler, np_, run_host, t64

B, T = 16, 8
RTOL = 1e-9
PS_KEYS = ("u", "steer_angle_deg")
# a pseudorange is ~2e7 m: float64 rounds each innovation by ~4e-9 m, and
# the gain carries that into the ~1 m/s velocities, whatever the op order
LOC_ATOL_X = 1e-7


@pytest.fixture(autouse=True)
def _needs_compiler():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted source")


def _close(ours, ref_x, ref_P, atol_x=1e-9, atol_P=1e-10):
  np.testing.assert_allclose(np_(ours[0]), ref_x, rtol=RTOL, atol=atol_x)
  np.testing.assert_allclose(np_(ours[1]), ref_P, rtol=RTOL, atol=atol_P)


def _packed(model, rng, scale, P_diag=None):
  """A JAX folded bank (x (dx, 8, B/8), P (de, de, 8, B/8)) and the port's
  bank-minor copy of it (interop)."""
  x = np.tile(model.initial_x, (B, 1)) + scale * rng.randn(
      B, len(model.initial_x))
  P_diag = model.initial_P_diag if P_diag is None else P_diag
  P = np.tile(np.diag(P_diag)[:, :, None], (1, 1, B))
  xp, Pp = pallas_bank.pack_bank(jnp.asarray(x), jnp.asarray(P))
  return xp, Pp, interop.bank_from_jax(xp, Pp, torch.float64)


def _unpacked(xo, Po):
  x, P = interop.bank_from_jax(xo, Po, torch.float64)
  return np_(x), np_(P)


def _car_inputs(rng):
  zs = 0.1 * rng.randn(T, B, 1)
  pss = np.stack([15.0 + 5.0 * rng.rand(T),
                  30.0 * np.sin(np.linspace(0, 3, T))], axis=1)
  base = tuple((k, float(v)) for k, v in sorted(jcar.DEFAULT_PARAMS.items())
               if k not in PS_KEYS)
  return zs, np.full(T, 0.05), pss, base


def test_car_params_stream_matches_jax_kernel():
  """Kernel 4 body: CarKalman YAW_RATE with the per-step params stream."""
  rng = np.random.RandomState(0)
  xp, Pp, (x, P) = _packed(car.CarKalman, rng, 0.05)
  zs, dts, pss, base = _car_inputs(rng)
  xo, Po = pallas_bank.generic_bank_scan(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      jnp.asarray(dts), None, jnp.asarray(pss),
      spec=jcar.CarKalman.build_spec(), kind=1,
      q_diag=tuple(np.diag(jcar.CarKalman.Q)), r_mat=((0.001**2,),),
      gate=True, t_chunk=4, tile_b=8, interpret=True,
      structure=jsparsity.structure_for(jcar.CarKalman.build_spec(),
                                        jcar.CarKalman.initial_x),
      ps_keys=PS_KEYS, base_params=base)
  spec = car.CarKalman.build_spec()
  ours = run_host(
      "single", spec, (1,), x, P, np.swapaxes(zs, 1, 2), dts,
      Q=car.CarKalman.Q, R_list=(car.CarKalman.obs_noise[1],), gate=True,
      structure=sparsity.structure_for(spec, car.CarKalman.initial_x),
      pss=pss, ps_keys=PS_KEYS)
  _close(ours, *_unpacked(xo, Po))


def test_car_mixed_and_dense_body_match_jax_kernel():
  """Kernel 6 body: the car's two kinds interleaved, gated per kind, with
  the params stream; once with the detected structure and once with the
  dense body (every column nonzero, what a spec whose structure cannot be
  detected gets)."""
  rng = np.random.RandomState(1)
  xp, Pp, (x, P) = _packed(car.CarKalman, rng, 0.05)
  zs, dts, pss, base = _car_inputs(rng)
  kind_idx = np.arange(T) % 2
  kinds = (1, 2)
  xo, Po = pallas_bank.generic_bank_scan_mixed(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      jnp.asarray(dts), jnp.asarray(kind_idx, jnp.int32), None,
      jnp.asarray(pss), spec=jcar.CarKalman.build_spec(), kinds=kinds,
      q_diag=tuple(np.diag(jcar.CarKalman.Q)),
      r_mats=(((0.001**2,),), ((0.3**2,),)), t_chunk=4, tile_b=8,
      interpret=True,
      structure=jsparsity.structure_for(jcar.CarKalman.build_spec(),
                                        jcar.CarKalman.initial_x),
      ps_keys=PS_KEYS, base_params=base)
  spec = car.CarKalman.build_spec()
  for structure in (sparsity.structure_for(spec, car.CarKalman.initial_x),
                    None):
    ours = run_host(
        "mixed", spec, kinds, x, P, np.swapaxes(zs, 1, 2), dts,
        Q=car.CarKalman.Q,
        R_list=[car.CarKalman.obs_noise[k] for k in kinds],
        structure=structure, pss=pss, ps_keys=PS_KEYS, kind_idx=kind_idx)
    _close(ours, *_unpacked(xo, Po))


def _loc_stream(rng, x, kinds):
  """(T, B, 1) measurements and (T, B, 6) satellite states for loc kinds
  per step, consistent with the states x (B, 11)."""
  sat = jloc.LocKalman.initial_x[:3] + 2e7 * rng.randn(T, B, 3)
  vel = 3e3 * rng.randn(T, B, 3)
  d = x[None, :, :3] - sat
  u = d / np.linalg.norm(d, axis=-1, keepdims=True)
  rho = np.linalg.norm(d, axis=-1) + x[None, :, 6] + 2.0 * rng.randn(T, B)
  rate = np.sum(u * (x[None, :, 3:6] - vel), axis=-1) + x[None, :, 7] \
      + 0.05 * rng.randn(T, B)
  is_rho = np.array([k == K.PSEUDORANGE_GPS for k in kinds])[:, None]
  return (np.where(is_rho, rho, rate)[..., None],
          np.concatenate([sat, vel], axis=-1))


@pytest.mark.parametrize("kind", [K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS])
def test_loc_extra_args_match_jax_kernel(kind):
  """Kernel 4 body with the satellite-state stream (eas)."""
  rng = np.random.RandomState(kind)
  xp, Pp, (x, P) = _packed(jloc.LocKalman, rng, 1.0, np.full(11, 10.0))
  zs, eas = _loc_stream(rng, np_(x).T, (kind,) * T)
  om = loc.build_loc_spec().obs[kind]
  eas = eas[..., :om.ea_len]
  dts = np.full(T, 0.1)
  jspec = jloc.build_loc_spec()
  xo, Po = pallas_bank.generic_bank_scan(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      jnp.asarray(dts), pallas_bank.pack_bank_measurements(jnp.asarray(eas)),
      spec=jspec, kind=int(kind), q_diag=tuple(np.diag(jloc.LocKalman.Q)),
      r_mat=tuple(tuple(r) for r in jloc.LocKalman.obs_noise[int(kind)]),
      gate=True, t_chunk=4, tile_b=8, interpret=True,
      structure=jsparsity.structure_for(jspec, jloc.LocKalman.initial_x))
  spec = loc.build_loc_spec()
  ours = run_host(
      "single", spec, (kind,), x, P, np.swapaxes(zs, 1, 2), dts,
      Q=loc.LocKalman.Q, R_list=(loc.LocKalman.obs_noise[kind],), gate=True,
      structure=sparsity.structure_for(spec, loc.LocKalman.initial_x),
      eas=np.swapaxes(eas, 1, 2))
  _close(ours, *_unpacked(xo, Po), atol_x=LOC_ATOL_X)


def test_loc_epoch_matches_jax_kernel():
  """Kernel 5 body: a GNSS epoch of 2 pseudoranges + 2 rates per step with
  one bad satellite, each slot gated on its own."""
  rng = np.random.RandomState(13)
  xp, Pp, (x, P) = _packed(jloc.LocKalman, rng, 1.0, np.full(11, 10.0))
  slots = (K.PSEUDORANGE_GPS,) * 2 + (K.PSEUDORANGE_RATE_GPS,) * 2
  zs, eas = zip(*[_loc_stream(rng, np_(x).T, (k,) * T) for k in slots])
  zs, eas = np.stack(zs, axis=1), np.stack(eas, axis=1)  # (T, K, B, .)
  zs[:, 1, ::4, 0] += 1e5
  dts = np.full(T, 1.0)
  jspec = jloc.build_loc_spec()
  r_mats = tuple(tuple(tuple(r) for r in jloc.LocKalman.obs_noise[int(k)])
                 for k in slots)
  xo, Po = pallas_bank.generic_bank_scan_epoch(
      xp, Pp, pallas_bank.pack_bank_epochs(jnp.asarray(zs)),
      jnp.asarray(dts), pallas_bank.pack_bank_epochs(jnp.asarray(eas)),
      spec=jspec, slot_kinds=tuple(int(k) for k in slots),
      q_diag=tuple(np.diag(jloc.LocKalman.Q)), r_mats=r_mats, t_chunk=4,
      tile_b=8, interpret=True, slot_mode="unroll",
      structure=jsparsity.structure_for(jspec, jloc.LocKalman.initial_x))
  spec = loc.build_loc_spec()
  ours = run_host(
      "epoch", spec, slots, x, P,
      interop.stream_from_jax(pallas_bank.pack_bank_epochs(jnp.asarray(zs)),
                              torch.float64), dts,
      Q=loc.LocKalman.Q, R_list=[loc.LocKalman.obs_noise[k] for k in slots],
      structure=sparsity.structure_for(spec, loc.LocKalman.initial_x),
      eas=interop.stream_from_jax(
          pallas_bank.pack_bank_epochs(jnp.asarray(eas)), torch.float64))
  _close(ours, *_unpacked(xo, Po), atol_x=LOC_ATOL_X)


def test_loc_mixed_matches_jax_kernel():
  """Kernel 6 body: pseudorange (ea 3), rate (ea 6) and ECEF_POS (dz 3)
  interleaved, rows padded."""
  rng = np.random.RandomState(21)
  xp, Pp, (x, P) = _packed(jloc.LocKalman, rng, 1.0, np.full(11, 10.0))
  kinds = (K.PSEUDORANGE_GPS, K.PSEUDORANGE_RATE_GPS, K.ECEF_POS)
  kind_idx = np.arange(T) % 3
  z1, eas = _loc_stream(rng, np_(x).T, [kinds[i] for i in kind_idx])
  zs = np.zeros((T, B, 3))
  zs[:, :, :1] = z1
  pos = kind_idx == 2
  zs[pos] = np_(x).T[None, :, :3] + 5.0 * rng.randn(pos.sum(), B, 3)
  dts = np.full(T, 0.1)
  jspec = jloc.build_loc_spec()
  xo, Po = pallas_bank.generic_bank_scan_mixed(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      jnp.asarray(dts), jnp.asarray(kind_idx, jnp.int32),
      pallas_bank.pack_bank_measurements(jnp.asarray(eas)), spec=jspec,
      kinds=tuple(int(k) for k in kinds),
      q_diag=tuple(np.diag(jloc.LocKalman.Q)),
      r_mats=tuple(tuple(tuple(r) for r in jloc.LocKalman.obs_noise[int(k)])
                   for k in kinds), t_chunk=4, tile_b=8, interpret=True,
      structure=jsparsity.structure_for(jspec, jloc.LocKalman.initial_x))
  spec = loc.build_loc_spec()
  ours = run_host(
      "mixed", spec, kinds, x, P, np.swapaxes(zs, 1, 2), dts,
      Q=loc.LocKalman.Q, R_list=[loc.LocKalman.obs_noise[k] for k in kinds],
      structure=sparsity.structure_for(spec, loc.LocKalman.initial_x),
      eas=np.swapaxes(eas, 1, 2), kind_idx=kind_idx)
  _close(ours, *_unpacked(xo, Po), atol_x=LOC_ATOL_X)


def _live_bank(rng):
  x = np.tile(jlive.LiveKalman.initial_x, (B, 1)) + 0.01 * rng.randn(B, 23)
  x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
  A = 0.1 * rng.randn(B, 22, 22)
  P = np.einsum("bij,bkj->ikb", A, A) + 0.01 * np.diag(
      jlive.LiveKalman.initial_P_diag)[:, :, None]
  return x, P


def test_live_single_and_mixed_match_jax_lane():
  """Kernels 4 and 6 bodies of the UNMODIFIED live spec against the JAX
  lane path: the ECEF_POS stream, and the gyro / accel / camera rotation
  / position cycle."""
  rng = np.random.RandomState(2)
  x, P = _live_bank(rng)
  dts = np.full(T, 0.01)
  tspec = live.LiveKalman.build_spec()
  st = sparsity.structure_for(tspec, live.LiveKalman.initial_x)
  jspec = jlive.LiveKalman.build_spec()
  Q = jlive.LiveKalman.Q

  zs = x[None, :, :3] + 5.0 * rng.randn(T, B, 3)
  R = live.LiveKalman.obs_noise[K.ECEF_POS]
  xr, Pr = jlane.jit_lane_bank_scan(jspec, int(K.ECEF_POS))(
      {}, jnp.asarray(x), jnp.asarray(P), jnp.asarray(Q), jnp.asarray(dts),
      jnp.asarray(zs), jnp.asarray(R))
  ours = run_host("single", tspec, (K.ECEF_POS,), x.T, P,
                  np.swapaxes(zs, 1, 2), dts, Q=Q, R_list=(R,), gate=None,
                  structure=st)
  _close(ours, np.asarray(xr).T, np.asarray(Pr), atol_x=1e-8, atol_P=1e-9)

  kinds = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)
  kind_idx = np.arange(T) % 4
  zs = np.where((kind_idx == 3)[:, None, None],
                x[None, :, :3] + 5.0 * rng.randn(T, B, 3),
                0.05 * rng.randn(T, B, 3))
  R_list = [live.LiveKalman.obs_noise[k] for k in kinds]
  xr, Pr = jlane.jit_lane_mixed_bank_scan(jspec,
                                          tuple(int(k) for k in kinds))(
      {}, jnp.asarray(x), jnp.asarray(P), jnp.asarray(Q), jnp.asarray(dts),
      jnp.asarray(kind_idx, jnp.int32), jnp.asarray(zs),
      tuple(jnp.asarray(r) for r in R_list))
  ours = run_host("mixed", tspec, kinds, x.T, P, np.swapaxes(zs, 1, 2), dts,
                  Q=Q, R_list=R_list, structure=st, kind_idx=kind_idx)
  _close(ours, np.asarray(xr).T, np.asarray(Pr), atol_x=1e-8, atol_P=1e-9)


def test_off_diagonal_Q_enters_by_its_pattern():
  """An off-diagonal Q is a run-time input on its structural pattern (the
  JAX kernels take diagonal Q only): the emitted body equals the port's
  plain version with the full Q."""
  from rednose_tpu_torch.models.kinematic import KinematicKalman

  rng = np.random.RandomState(3)
  spec = KinematicKalman.build_spec()
  x = 0.5 * rng.randn(2, B)
  P = np.tile(np.diag(KinematicKalman.initial_P_diag)[:, :, None], (1, 1, B))
  Q = np.array([[0.01, 0.003], [0.003, 4.0]])
  zs = 0.5 * rng.randn(T, 1, B)
  dts = np.full(T, 0.01)
  R = KinematicKalman.obs_noise[1]
  ours = run_host("single", spec, (1,), x, P, zs, dts, Q=Q, R_list=(R,),
                  structure=sparsity.structure_for(
                      spec, KinematicKalman.initial_x))
  ref = generic_scan.generic_bank_scan(
      t64(x), t64(P), t64(zs), t64(dts), spec=spec, kind=1, Q=Q, R=R)
  _close(ours, np_(ref[0]), np_(ref[1]))
  with pytest.raises(ValueError, match="symmetric"):
    generic_scan.generic_bank_scan(
        t64(x), t64(P), t64(zs), t64(dts), spec=spec, kind=1,
        Q=np.array([[0.01, 0.003], [0.0, 4.0]]), R=R)


# ------------------------------------------- latent faults of the JAX emitter

def _const_row_spec():
  """A 2-state spec whose dz = 2 kind has a constant row (an all-zero H
  row): entry_slab.py:366 of the JAX package raises a TypeError on it."""

  def f(params, x, dt):
    del params
    return torch.stack([x[0] + dt * x[1], x[1]])

  def h(params, x, ea):
    del params, ea
    return torch.stack([x[0], torch.full_like(x[0], 2.0)])

  return FilterSpec(name="const_row", dim_x=2, dim_err=2, f=f,
                    obs={5: ObservationModel(kind=5, h=h, dz=2)})


def test_all_zero_H_row_is_a_zero_row():
  spec = _const_row_spec()
  rng = np.random.RandomState(4)
  x0 = rng.randn(2, B)
  P0 = np.tile(np.diag([1.0, 4.0])[:, :, None], (1, 1, B))
  Q = np.diag([0.01, 0.1])
  R = np.array([[0.04, 0.01], [0.01, 0.09]])
  zs = np.stack([rng.randn(T, B), 2.0 + 0.3 * rng.randn(T, B)], axis=1)
  dts = np.full(T, 0.1)
  st = sparsity.detect_structure(spec, np.zeros(2))
  assert st.cols_for(5) == (0,)
  ours = run_host("single", spec, (5,), x0, P0, zs, dts, Q=Q, R_list=(R,),
                  structure=st)
  xs, Ps = [], []
  for b in range(B):       # the port's core/step oracle, filter by filter
    x, P = t64(x0[:, b]), t64(P0[:, :, b])
    for t in range(T):
      x, P = tstep.predict(spec, {}, x, P, t64(Q), t64(dts[t]))
      x, P, _ = tstep.update(spec, 5, {}, x, P, t64(zs[t, :, b]), t64(R),
                             t64(np.zeros(1)))
    xs.append(np_(x))
    Ps.append(np_(P))
  _close(ours, np.stack(xs, axis=1), np.stack(Ps, axis=-1))


def test_asymmetric_R_is_refused():
  """entry_slab.py:372 of the JAX package reads only R's upper triangle;
  the port refuses an asymmetric R on every path."""
  spec = _const_row_spec()
  R = np.array([[0.04, 0.01], [0.02, 0.09]])
  with pytest.raises(ValueError, match="symmetric"):
    generic_scan.KernelCall(spec, "single", (5,), Q=np.eye(2), R_list=(R,))
  with pytest.raises(ValueError, match="symmetric"):
    generic_scan.generic_bank_scan(
        t64(np.zeros((2, 4))), t64(np.tile(np.eye(2)[:, :, None],
                                           (1, 1, 4))),
        t64(np.zeros((1, 2, 4))), t64([0.1]), spec=spec, kind=5,
        Q=np.eye(2), R=R)


def test_kernel_call_emits_one_variant_per_dtype():
  """A float64 bank gets the same body in double (the text the host tests
  build); a call of another mode, a half bank or a vector param is
  refused."""
  spec = _const_row_spec()
  R = np.diag([0.04, 0.09])
  call = generic_scan.KernelCall(spec, "single", (5,), Q=np.eye(2),
                                 R_list=(R,))
  f32, f64 = call.source(torch.float32), call.source(torch.float64)
  assert "#define REDNOSE_SCALAR float" in f32
  assert f64 == f32.replace("#define REDNOSE_SCALAR float",
                            "#define REDNOSE_SCALAR double")
  with pytest.raises(ValueError, match="float32 or float64"):
    call.source(torch.float16)
  with pytest.raises(ValueError, match="'single' call given to the 'epoch'"):
    generic_scan.generic_bank_scan_epoch(
        t64(np.zeros((2, 4))), t64(np.tile(np.eye(2)[:, :, None], (1, 1, 4))),
        t64(np.zeros((1, 1, 2, 4))), t64([0.1]), call=call)
  vec = generic_scan.KernelCall(spec, "single", (5,), Q=np.eye(2),
                                R_list=(R,), params={"g": np.ones(2)})
  with pytest.raises(ValueError, match="not a scalar"):
    vec.values(torch.float64, "cpu")


def test_op_without_rule_raises_and_names_it():
  """The interpreter has no fallback: an aten op without a rule raises,
  and so does a vector norm of an order without one."""
  spec = _const_row_spec()

  def h_prod(params, x, ea):
    del params, ea
    return torch.prod(x)[None]

  def h_norm3(params, x, ea):
    del params, ea
    return torch.linalg.vector_norm(x, ord=3)[None]

  for h, name in ((h_prod, "prod"), (h_norm3, "linalg_vector_norm")):
    bad = dataclasses.replace(
        spec, obs={5: ObservationModel(kind=5, h=h, dz=1)})
    with pytest.raises(NotImplementedError, match=name):
      entry_slab.emit_source(bad, "single", ((5, False),),
                             sparsity.dense_structure(bad), (), (), ())
