"""The port's sharded bank (rednose_tpu_torch/parallel) against the JAX
package's (rednose_tpu/parallel/sharding.py), on the CPU.

Mirrors tests/test_sharding.py, the time-sharded smoother of
tests/test_precision.py:46 and the dry run of __graft_entry__.py. The
port's side runs on 4 Gloo ranks spawned once for the module
(parallel/dryrun.spawn_ranks, a file store under pytest's tmp_path): a
1-D mesh of 4 and a 2 x 2 multislice mesh. Every case's inputs are made
with numpy from a seed (dryrun.case_inputs, B = 64, float64); the same
arrays go to JAX on the 8 virtual CPU devices of tests/conftest.py. Each
test holds the port's gathered result:
- against the port's unsharded call: bitwise (torch.equal), since each
  lane's arithmetic is the same whatever the block (the RMSE and the
  smoother, whose sums are grouped another way, at the tolerances below);
- against JAX at RTOL relative (float64; `close`). The kernels' JAX
  reference is their plain lane scan (rednose_tpu/ops/lane_bank.py,
  live_lane.py, msckf_bank's frame scan): JAX's sharded Pallas kernels
  need interpret mode (their tests are `slow`), and JAX holds them equal
  to those scans.
The card-only cases (the two Gloo ranks sharing one card, the one-rank
NCCL mesh in process) carry the `cuda` marker.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch_parity import cuda_device  # noqa: F401

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax
  import jax.numpy as jnp
  from rednose_tpu.models import car as jcar
  from rednose_tpu.models import live as jlive
  from rednose_tpu.models import loc as jloc
  from rednose_tpu.models import msckf_eskf as jeskf
  from rednose_tpu.models.kinematic import KinematicKalman
  from rednose_tpu.ops import lane_bank as jlane
  from rednose_tpu.ops import live_lane as jlive_lane
  from rednose_tpu.parallel import sharding as jshard
  from rednose_tpu.runtime import bank as jbank
  from rednose_tpu.runtime import msckf_bank as jmsckf
  from rednose_tpu.smoothing.rts import rts_smooth_parallel
except ImportError:
  jax = jnp = jcar = jlive = jloc = jeskf = KinematicKalman = None
  jlane = jlive_lane = jshard = jbank = jmsckf = rts_smooth_parallel = None
from rednose_tpu_torch.parallel import dryrun

N_RANKS = 4
RTOL = 1e-12          # the port against JAX, float64
SMOOTH_RTOL = 1e-10   # the time-sharded smoother against JAX's
POS = dryrun.POSITION


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
  """Every case of the dry run on 4 Gloo ranks: rank 0's record (the
  gathered outputs) and every rank's launch counts and lanes."""
  return dryrun.spawn_ranks(N_RANKS, "cpu", "small",
                            workdir=tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def unsharded():
  torch.set_num_threads(1)
  return dryrun.unsharded_outputs("small", "cpu")


def port(ranks, case):
  return {k: v.numpy() for k, v in ranks[0][case]["outputs"].items()}


def inputs(case):
  return dryrun.case_inputs(case, "small")


def hold_unsharded(ranks, unsharded, case):
  """The gathered outputs equal the unsharded call's bitwise; every rank
  ran a quarter of the lanes and launched no kernel (the CPU runs the
  plain versions)."""
  for k, want in unsharded[case].items():
    assert torch.equal(ranks[0][case]["outputs"][k], want), (case, k)
  for r in ranks:
    assert r[case]["counts"] == {}
  lanes = {r[case]["lanes"] for r in ranks}
  assert len(lanes) == 1 and lanes.pop() * N_RANKS == 64


def close(a, b, rtol=RTOL):
  """Within rtol of each entry, or of the array's largest entry: an entry
  near 0 is a difference of large terms (a cross-covariance), its
  rounding that of those terms."""
  b = np.asarray(b)
  np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                             atol=rtol * float(np.abs(b).max()))


@pytest.fixture(scope="module")
def jmesh():
  assert len(jax.devices()) == 8, jax.devices()
  return jshard.make_bank_mesh()


def _jax_bank(inp):
  spec = KinematicKalman.build_spec()
  B = inp["zs"].shape[1]
  state = jbank.init_bank(spec, KinematicKalman.initial_x,
                          np.diag(KinematicKalman.initial_P_diag), batch=B,
                          dtype=jnp.float64)
  return spec, state, jnp.asarray(KinematicKalman.Q)


def test_sharded_matches_unsharded(ranks, unsharded, jmesh):
  """sharded_run_bank (test_sharding.py:34): the gathered state and ys
  equal the port's unsharded run_bank, and JAX's sharded_run_bank."""
  hold_unsharded(ranks, unsharded, "bank")
  inp = inputs("bank")
  spec, state, Q = _jax_bank(inp)
  final, ys = jshard.sharded_run_bank(
      spec, POS, jmesh, {}, state, Q, jnp.asarray(inp["dts"]),
      jnp.asarray(inp["zs"]), jnp.asarray(inp["Rs"]))
  got = port(ranks, "bank")
  close(got["x"], final.x)
  close(got["P"], final.P)
  close(got["t"], final.t)
  close(got["ys"], ys)


def test_sharded_rmse_psum(ranks, jmesh):
  """sharded_bank_rmse (test_sharding.py:49): every rank's partial sums
  all_reduced equal the local mean and JAX's psum, at RTOL."""
  inp = inputs("bank")
  spec, state, Q = _jax_bank(inp)
  final, _ = jshard.sharded_run_bank(
      spec, POS, jmesh, {}, state, Q, jnp.asarray(inp["dts"]),
      jnp.asarray(inp["zs"]), jnp.asarray(inp["Rs"]))
  want = float(jshard.sharded_bank_rmse(jmesh, final, jnp.zeros(2)))
  got = port(ranks, "bank")
  close(got["rmse"], want)
  close(got["rmse64"], want)
  close(want, float(jbank.bank_rmse(final, jnp.zeros(2))))


def test_jit_sharded_step(ranks, unsharded, jmesh):
  """jit_sharded_step (test_sharding.py:59) on the 1-D mesh and, through
  sharding=multislice_sharding, on the 2 x 2 mesh: both equal the
  unsharded step bitwise and JAX's sharded step at RTOL."""
  hold_unsharded(ranks, unsharded, "step")
  hold_unsharded(ranks, unsharded, "step_2d")
  inp = inputs("step")
  spec, state, Q = _jax_bank(inp)
  fn = jshard.jit_sharded_step(spec, POS, jmesh)
  B = state.batch
  st, y = fn({}, jshard.shard_bank(state, jmesh), Q, jnp.asarray(0.01),
             jnp.asarray(inp["zs"][0]), jnp.asarray(inp["Rs"][0]),
             jnp.zeros((B, 1)))
  for case in ("step", "step_2d"):
    got = port(ranks, case)
    close(got["x"], st.x)
    close(got["P"], st.P)
    close(got["y"], y)


def test_lane_bank_sharded(ranks, unsharded):
  """The lane-major bank on each rank's lanes (test_sharding.py:70)
  against JAX's lane_bank_scan."""
  hold_unsharded(ranks, unsharded, "lane")
  inp = inputs("lane")
  spec = KinematicKalman.build_spec()
  x, P = jlane.lane_bank_scan(
      spec, POS, {}, jnp.asarray(inp["x0"]),
      jnp.asarray(inp["P0"].transpose(1, 2, 0)), jnp.asarray(inp["Q"]),
      jnp.asarray(inp["dts"]), jnp.asarray(inp["zs"]),
      jnp.asarray(inp["Rs"][0, 0]))
  got = port(ranks, "lane")
  close(got["x"], x)
  close(got["P"], P)


def test_sharded_live_bank_scan(ranks, unsharded):
  """Kernel 2's sharded wrapper (test_sharding.py:95) on the 1-D mesh
  and, folded over both dims, on the 2 x 2 mesh: against the unsharded
  call bitwise and JAX's live_lane_scan (the scan JAX holds its sharded
  kernel to bitwise), gate on."""
  hold_unsharded(ranks, unsharded, "live")
  hold_unsharded(ranks, unsharded, "live_2d")
  inp = inputs("live")
  x, P = jlive_lane.live_lane_scan(
      jnp.asarray(inp["x"].T), jnp.asarray(inp["P"]),
      jnp.asarray(np.diag(inp["q_diag"])), jnp.asarray(inp["dts"]),
      jnp.asarray(inp["zs"].transpose(0, 2, 1)), jnp.asarray(inp["R"]),
      gate=True)
  for case in ("live", "live_2d"):
    got = port(ranks, case)
    close(got["x"].T, x)
    close(got["P"], P)


def _lane(a):
  """The port's bank-minor stream (..., d, B) -> JAX's lane form
  (..., B, d)."""
  return jnp.asarray(np.swapaxes(a, -1, -2))


def test_sharded_generic_bank_scan_live(ranks, unsharded):
  """Kernel 4's sharded wrapper on the live spec's ECEF_POS fixes, gate
  on (the JAX kernel's gate flag, as bench.py sets it), against JAX's
  lane_bank_scan of the live spec with ECEF_POS's maha_test on, which is
  what that flag means."""
  hold_unsharded(ranks, unsharded, "generic_live")
  inp = inputs("generic_live")
  LK = jlive.LiveKalman
  spec = LK.build_spec()
  kind = jlive.ObservationKind.ECEF_POS
  spec = dataclasses.replace(spec, obs={
      **spec.obs, kind: dataclasses.replace(spec.obs[kind], maha_test=True,
                                            maha_thresh=None)})
  x, P = jlane.lane_bank_scan(
      spec, kind, {},
      jnp.asarray(inp["x"].T), jnp.asarray(inp["P"]), jnp.asarray(LK.Q),
      jnp.asarray(inp["dts"]), _lane(inp["zs"]),
      jnp.asarray(LK.obs_noise[jlive.ObservationKind.ECEF_POS]))
  got = port(ranks, "generic_live")
  close(got["x"].T, x)
  close(got["P"], P)


def test_sharded_generic_bank_scan_params_stream(ranks, unsharded):
  """Kernel 4's sharded wrapper on car with its per-step speed / steering
  stream replicated (__graft_entry__.py:338-366) against JAX's
  lane_bank_scan with the same stream."""
  hold_unsharded(ranks, unsharded, "car")
  inp = inputs("car")
  CK = jcar.CarKalman
  spec = CK.build_spec()
  kind = jcar.ObservationKind.YAW_RATE
  x, P = jlane.lane_bank_scan(
      spec, kind, dict(spec.default_params), jnp.asarray(inp["x"].T),
      jnp.asarray(inp["P"]), jnp.asarray(CK.Q), jnp.asarray(inp["dts"]),
      _lane(inp["zs"]), jnp.asarray(CK.obs_noise[kind]),
      ps_keys=dryrun.PS_KEYS, pss=jnp.asarray(inp["pss"]))
  got = port(ranks, "car")
  close(got["x"].T, x)
  close(got["P"], P)


def test_sharded_mixed_generic_kernel(ranks, unsharded):
  """Kernel 6's sharded wrapper (test_sharding.py:135) on the live spec's
  4-kind cycle, the kind schedule replicated, against JAX's
  lane_mixed_bank_scan (each kind gated as its maha_test says)."""
  hold_unsharded(ranks, unsharded, "mixed_live")
  inp = inputs("mixed_live")
  LK = jlive.LiveKalman
  kinds = dryrun.MIXED_KINDS
  x, P = jlane.lane_mixed_bank_scan(
      LK.build_spec(), kinds, {}, jnp.asarray(inp["x"].T),
      jnp.asarray(inp["P"]), jnp.asarray(LK.Q), jnp.asarray(inp["dts"]),
      jnp.asarray(inp["kind_idx"]), _lane(inp["zs"]),
      [jnp.asarray(LK.obs_noise[k]) for k in kinds])
  got = port(ranks, "mixed_live")
  close(got["x"].T, x)
  close(got["P"], P)


def _eskf_r():
  spec = jeskf.MSCKFEskf.build_spec()
  return dryrun.FEATURE_R * np.eye(spec.obs[dryrun.ESKF_FEATURE].dz)


def test_sharded_mixed_generic_kernel_vio(ranks, unsharded):
  """Kernel 6's sharded wrapper on msckf_eskf's VIO schedule, camera
  frames (projected update + window augment) among position fixes, the
  landmark stream split (__graft_entry__.py:310-336), against JAX's
  lane_mixed_bank_scan."""
  hold_unsharded(ranks, unsharded, "vio")
  inp = inputs("vio")
  E = jeskf.MSCKFEskf
  x, P = jlane.lane_mixed_bank_scan(
      E.build_spec(), (dryrun.ESKF_POS, dryrun.ESKF_FEATURE), {},
      jnp.asarray(inp["x"].T), jnp.asarray(inp["P"]), jnp.asarray(E.Q),
      jnp.asarray(inp["dts"]), jnp.asarray(inp["kind_idx"]),
      _lane(inp["zs"]), [jnp.eye(3), jnp.asarray(_eskf_r())],
      eas=_lane(inp["eas"]))
  got = port(ranks, "vio")
  close(got["x"].T, x)
  close(got["P"], P)


def test_sharded_epoch_generic_kernel(ranks, unsharded):
  """Kernel 5's sharded wrapper (test_sharding.py:184) on loc's GNSS
  epochs, 4 pseudoranges and 4 range rates, the satellite stream split,
  against JAX's lane_epoch_bank_scan."""
  hold_unsharded(ranks, unsharded, "epoch")
  inp = inputs("epoch")
  L = jloc.LocKalman
  x, P = jlane.lane_epoch_bank_scan(
      L.build_spec(), dryrun.LOC_SLOTS, {}, jnp.asarray(inp["x"].T),
      jnp.asarray(inp["P"]), jnp.asarray(L.Q), jnp.asarray(inp["dts"]),
      _lane(inp["zs"]), [jnp.asarray(L.obs_noise[k])
                         for k in dryrun.LOC_SLOTS],
      eas=_lane(inp["eas"]))
  got = port(ranks, "epoch")
  close(got["x"].T, x)
  close(got["P"], P)


def test_sharded_vo_bank_scan(ranks, unsharded):
  """Kernel 7's sharded wrapper on msckf_eskf's camera frames
  (__graft_entry__.py:262-308) against JAX's frame scan (msckf_bank's
  lane twin of vo_bank_scan)."""
  hold_unsharded(ranks, unsharded, "vo")
  inp = inputs("vo")
  E = jeskf.MSCKFEskf
  x, P = jmsckf._jit_frame_scan(E.build_spec(), dryrun.ESKF_FEATURE, None)(
      jnp.asarray(inp["x"].T), jnp.asarray(inp["P"]), jnp.asarray(E.Q),
      jnp.asarray(inp["dts"]), _lane(inp["zs"]), _lane(inp["eas"]),
      jnp.asarray(_eskf_r()))
  got = port(ranks, "vo")
  close(got["x"].T, x)
  close(got["P"], P)


def test_multislice_hierarchical_rmse(ranks):
  """The staged RMSE on the 2 x 2 (slice, bank) mesh (test_sharding.py:248)
  equals the 1-D one, the local mean and JAX's multislice_bank_rmse on
  its 2 x 4 mesh, at RTOL."""
  inp = inputs("bank")
  spec, state, Q = _jax_bank(inp)
  final, _ = jbank.jit_run_bank(spec, POS)(
      {}, state, Q, jnp.asarray(inp["dts"]), jnp.asarray(inp["zs"]),
      jnp.asarray(inp["Rs"]), None)
  mesh2 = jshard.make_multislice_mesh(n_slices=2)
  state2 = jax.tree.map(
      lambda a: jax.device_put(a, jshard.multislice_sharding(mesh2)), final)
  want = float(jshard.multislice_bank_rmse(mesh2, state2, np.zeros(2)))
  got = port(ranks, "bank")
  close(got["rmse_2d64"], want)
  close(got["rmse_2d"], want)
  close(got["rmse_2d64"], got["rmse64"])


def test_kinematic_log_is_the_engines(ranks):
  """dryrun.kinematic_log (numpy) is the log test_precision.py:46 takes
  from JAX's KinematicKalman engine, at RTOL (the same arithmetic in
  another order: the engine's adjugate solve and its jitted products)."""
  rng = np.random.default_rng(0)
  kf = KinematicKalman()
  kf.filter.set_filter_time(0.0)
  est = [kf.predict_and_observe((k + 1) * 0.01, POS,
                                [[rng.normal(0, 0.3)]],
                                R=np.full((1, 1, 1), 0.01))
         for k in range(256)]
  log = dryrun.kinematic_log(256)
  close(log["x_pred"], np.stack([np.asarray(e[0]).reshape(-1) for e in est]))
  close(log["x_post"], np.stack([np.asarray(e[1]).reshape(-1) for e in est]))
  close(log["P_pred"], np.stack([np.asarray(e[2]) for e in est]))
  close(log["P_post"], np.stack([np.asarray(e[3]) for e in est]))
  close(log["t"], np.asarray([e[4] for e in est]))


def test_time_sharded_smoother(ranks, unsharded):
  """sharded_rts_smooth_parallel over the 4 ranks, 64 steps each, with 2
  Newton passes, against the port's unsharded rts_smooth_parallel and
  JAX's, at SMOOTH_RTOL (float64)."""
  log = inputs("smoother")
  spec = KinematicKalman.build_spec()
  xs, Ps = rts_smooth_parallel(
      spec, {}, *(jnp.asarray(log[k]) for k in
                  ("x_pred", "P_pred", "x_post", "P_post", "t")), refine=2)
  got = port(ranks, "smoother")
  close(got["x"], xs, SMOOTH_RTOL)
  close(got["P"], Ps, SMOOTH_RTOL)
  close(got["x"], unsharded["smoother"]["x"].numpy(), SMOOTH_RTOL)
  close(got["P"], unsharded["smoother"]["P"].numpy(), SMOOTH_RTOL)
  assert {r["smoother"]["lanes"] for r in ranks} == {256 // N_RANKS}


def test_time_sharded_smoother_refuses_gradients_on_the_card(monkeypatch):
  """On the card's route (sharding._on_card stood in to say so, every
  smoother launcher a counting stand-in) sharded_rts_smooth_parallel
  raises NotImplementedError naming the sharded smoother's adjoint for an
  input that requires grad, and under torch.func.grad, before any
  launch or collective (the mesh is never read)."""
  from rednose_tpu_torch.models.kinematic import KinematicKalman as KK
  from rednose_tpu_torch.ops import smooth_scan
  from rednose_tpu_torch.parallel import sharding

  calls = []

  def stand_in(*args, **kw):
    calls.append(1)
    raise RuntimeError("stand-in launcher reached")

  for name in ("smooth_gains", "affine_suffix_scan", "smooth_inject"):
    monkeypatch.setattr(smooth_scan, name, stand_in)
  monkeypatch.setattr(sharding, "_on_card", lambda t: True)
  spec = KK.build_spec()
  T, de = 6, spec.dim_err
  rng = np.random.RandomState(0)
  x = torch.as_tensor(rng.randn(T, spec.dim_x))
  P = torch.as_tensor(np.tile(np.eye(de), (T, 1, 1)))
  t = torch.arange(T, dtype=torch.float64)
  xg = x.clone().requires_grad_()
  with pytest.raises(NotImplementedError,
                     match="the sharded smoother's adjoint"):
    sharding.sharded_rts_smooth_parallel(None, spec, {}, x, P, xg, P, t)
  with pytest.raises(NotImplementedError,
                     match="the sharded smoother's adjoint"):
    torch.func.grad(lambda v: sharding.sharded_rts_smooth_parallel(
        None, spec, {}, x, P, v, P, t)[0].sum())(x)
  assert calls == []


def test_dryrun_multichip_cpu(tmp_path, capsys):
  """dryrun_multichip(4, "cpu") end to end: spawns its own 4 ranks and
  holds every case against the unsharded call in this process."""
  rows = dryrun.dryrun_multichip(N_RANKS, "cpu", workdir=tmp_path)
  assert [r["case"] for r in rows] == list(dryrun.CASES)
  assert "dryrun_multichip(4, 'cpu'): ok" in capsys.readouterr().out


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(cuda_device, tmp_path):
  """Two Gloo ranks on the one card (cuda:0), the full widths: each
  launches each case's kernel once on B/2 lanes, and the gathered results
  equal the unsharded launches bitwise. The parent builds every kernel
  first; the ranks only load them."""
  from rednose_tpu_torch import _build

  _build.build()
  _build.build_generated_many(
      [dryrun.kernel_call(n).source(torch.float32)
       for n in ("generic_live", "car", "mixed_live", "vio", "epoch", "vo")])
  results = dryrun.spawn_ranks(2, "cuda", "full", workdir=tmp_path)
  assert {r["device"] for r in results} == {"cuda:0"}
  dryrun.verify(results, "full", dryrun.unsharded_outputs("full", "cuda"),
                "cuda")


@pytest.mark.cuda
def test_one_rank_nccl_mesh_in_process(cuda_device):
  """make_bank_mesh() on the card with no group up: a one-rank group
  ("cpu:gloo,cuda:nccl") in this process; every case through it equals
  the unsharded call bitwise and launches its kernel once."""
  from rednose_tpu_torch.parallel import sharding

  mesh = sharding.make_bank_mesh()
  mesh2 = sharding.make_multislice_mesh(1)
  names = ("bank", "live", "generic_live", "mixed_live", "epoch", "vo")
  res = dryrun.run_cases(mesh, mesh2, "full", names, keep_outputs=True)
  dryrun.verify([dict(res, rank=0)], "full",
                dryrun.unsharded_outputs("full", "cuda", names), "cuda")
