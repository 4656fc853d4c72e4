"""runtime/bank.run_bank on the card's route: kernel 15 (emitted mode
"bank", ops/entry_slab.py around csrc/generic_scan.cuh) and its gradient
through kernels 9 and 10's lane forms (R and the innovations' cotangent
by lane), against the JAX package's jit_run_bank and jax.grad of it.

Four banks, float64, B <= 8 lanes, T <= 32 steps, inputs from a numpy
seed, each with R by lane (T, B, dz, dz) and shared (T, dz, dz): the
kinematic POSITION bank; the car spec's gated YAW_RATE with its params
(every fourth lane's yaw rate 3 rad/s off at every other step, which the
gate rejects); the live spec with every gate on, ECEF_POS, from the state
the plain loop reaches in WARM steps from the prior, every fourth lane's
positions 100 m off at every other step; and the op battery's gated
RANGE to a per-lane anchor (the extra args), every fourth lane's range
30 m off. Each lane starts at its own t.

(a) run_bank_reference (the plain loop) equals jax.jit(run_bank)
(jit_run_bank) to rtol 1e-10. (b) kernel 15's host build (the emitted
source built by the host C++ compiler as double, entry
rn_generic_bank_host: the tile form the card builds, and the global form
of a spec whose tile does not fit) equals the plain loop on ys, x, P and
t within BANK_TOL of each output's largest entry.
(c) the card's route (the custom op rednose::run_bank and its autograd
rule, the op rednose::run_bank_backward) on CPU tensors, its three
launchers replaced by their host builds: the gradient of a seeded
weighting of ys and the final x, P and t, with respect to x0, P0, t0, Q,
dts, zs, Rs, eas and the params, equals jax.grad within ADJ_TOL of each
gradient's largest entry (P0, Q and Rs: symmetric parts, as in
tests/test_torch_scan_stream_grad.py). (d) that route launches kernel 15
once a call and each lane form once a backward, equals the plain loop at
T = 0, gives sharded_run_bank's result on the dry run's bank case lane
block by lane block bitwise, and refuses jvp and create_graph=True by
name. (e) on the card: kernel 15 and the lane forms against their plain
versions (skipped without CUDA). This file imports JAX only in a try."""

import ctypes
import dataclasses
import functools
import pathlib
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX
  import jax
  import jax.numpy as jnp
  from rednose_tpu.models.car import CarKalman as JCar
  from rednose_tpu.models.kinematic import KinematicKalman as JKinematic
  from rednose_tpu.models.live import LiveKalman as JLive
  from rednose_tpu.runtime import bank as jbank
except ImportError:
  jax = jnp = JCar = JKinematic = JLive = jbank = None
from rednose_tpu_torch.models import user_specs as us
from rednose_tpu_torch.models.car import CarKalman
from rednose_tpu_torch.models.kinematic import KinematicKalman
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.ops import entry_slab, generic_scan
from rednose_tpu_torch.parallel import dryrun, sharding
from rednose_tpu_torch.runtime import bank, scan
from rednose_tpu_torch.runtime.live_bank import gated_live_spec
from torch_parity import host_compiler

CSRC = pathlib.Path(__file__).resolve().parents[1] / "rednose_tpu_torch" / \
    "csrc"
# the plain loop against JAX's jit_run_bank (the same algebra)
RTOL = 1e-10
# kernel 15's host build (the emitted factored algebra) against the plain
# loop, relative to each output's largest entry
BANK_TOL = 1e-9
# the lane forms' gradient against jax.grad, relative to each gradient's
# largest entry (tests/test_torch_scan_stream_grad.py's ADJ_TOL)
ADJ_TOL = 1e-7
WARM = 32
# kernel 15's ring on the host: a whole block of 32 lanes (16-B copies in
# float64, B even) and a ragged one, over more than two ring stages' steps
# (BANK_CHUNK steps a stage at most) and a ragged last chunk
RING_B = 38
RING_T = 2 * entry_slab.BANK_CHUNK + 3
FAMILIES = ("kinematic", "car", "live_gated", "battery")
R_FORMS = ("lane", "shared")
GRADS = ("x0", "P0", "t0", "Q", "dts", "zs", "Rs", "eas", "params")
SYMMETRIC = ("P0", "Q", "Rs")
f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa


def _gated(spec):
  return dataclasses.replace(spec, obs={
      k: dataclasses.replace(om, maha_test=True)
      for k, om in spec.obs.items()})


def _noise(rng, R0, T, B, form):
  """R0 scaled by 1 + U(0, 1) per lane and step (lane) or per step."""
  if form == "lane":
    return R0 * (1.0 + rng.rand(T, B))[..., None, None]
  return R0 * (1.0 + rng.rand(T))[:, None, None]


@functools.lru_cache(maxsize=None)
def family(name, form, ring=False):
  """(spec, JAX spec or None, kind, Q, params, inputs): inputs x0 (B, dx),
  P0 (B, de, de), t0 (B,), dts (T,), zs (T, B, dz), Rs (by lane or
  shared), eas (T, B, ea_len) or None; numpy float64. ring (kinematic and
  car): RING_B lanes x RING_T steps instead, a whole block and a ragged
  one through every stage of kernel 15's ring twice over."""
  rng = np.random.RandomState(FAMILIES.index(name) + 10 * R_FORMS.index(form)
                              + 100 * ring)
  if name == "kinematic":
    (T, B), m = (RING_T, RING_B) if ring else (32, 6), KinematicKalman
    x0 = m.initial_x + 0.1 * rng.randn(B, 2)
    P0 = np.tile(np.diag(m.initial_P_diag), (B, 1, 1))
    inp = dict(x0=x0, P0=P0, dts=0.005 + 0.01 * rng.rand(T),
               zs=0.3 * rng.randn(T, B, 1),
               Rs=_noise(rng, m.obs_noise[1], T, B, form), eas=None)
    out = (m.build_spec(), JKinematic and JKinematic.build_spec(), 1, m.Q,
           {})
  elif name == "car":
    (T, B), m = (RING_T, RING_B) if ring else (24, 4), CarKalman
    kind = 1                                    # YAW_RATE, gated
    zs = 0.05 * rng.randn(T, B, 1)
    zs[::2, ::4] += 3.0
    params = {k: float(v) + 0.01 * rng.randn() * abs(float(v))
              for k, v in m.build_spec().default_params.items()}
    inp = dict(x0=m.initial_x + 0.1 * rng.randn(B, 5),
               P0=np.tile(np.diag(m.initial_P_diag), (B, 1, 1)),
               dts=np.full(T, 0.01), zs=zs,
               Rs=_noise(rng, m.obs_noise[kind], T, B, form), eas=None)
    out = (m.build_spec(), JCar and JCar.build_spec(), kind, m.Q, params)
  elif name == "live_gated":
    from test_torch_scan_stream_kernel import live_log

    T, B, m, spec = 16, 4, LiveKalman, gated_live_spec()
    x0, P0, dts, _, zs, Rs, _ = live_log((K.ECEF_POS,), WARM + T, B, 3)
    state = bank.BankState(x=f64(x0), P=f64(P0), t=f64(np.zeros(B)))
    state, _ = bank.run_bank_reference(spec, K.ECEF_POS, {}, state, f64(m.Q),
                                       f64(dts[:WARM]), f64(zs[:WARM]),
                                       f64(Rs[:WARM]))
    zs = zs[WARM:].copy()
    zs[::2, ::4] += 100.0
    inp = dict(x0=state.x.numpy(), P0=state.P.numpy(), dts=dts[WARM:],
               zs=zs, Rs=_noise(rng, m.obs_noise[K.ECEF_POS], T, B, form),
               eas=None)
    out = (spec, JLive and _gated(JLive.build_spec()), K.ECEF_POS, m.Q, {})
  else:
    T, B, spec = 24, 4, us.battery_spec()
    x0 = us.BATTERY_X0 + np.concatenate(
        [2.0 * rng.randn(B, 3), 0.1 * rng.randn(B, 5)], axis=1)
    truth = us.simulate(spec, x0, us.BATTERY_Q, T, 0.05, rng)
    eas = truth[1:, :, :3].numpy() + 50.0 * rng.randn(T, B, 3)
    zs = us.measure(spec, us.RANGE, truth[1:], us.BATTERY_R[us.RANGE], rng,
                    torch.as_tensor(eas)).numpy()
    zs[::2, ::4] += 30.0
    inp = dict(x0=x0, P0=np.tile(np.diag(us.BATTERY_P_DIAG), (B, 1, 1)),
               dts=np.full(T, 0.05), zs=zs,
               Rs=_noise(rng, us.BATTERY_R[us.RANGE], T, B, form), eas=eas)
    jspec = None
    if jax is not None:
      from test_torch_random_specs import _j_battery_spec

      jspec = _j_battery_spec()
    out = (spec, jspec, us.RANGE, us.BATTERY_Q, {})
  inp["t0"] = 10.0 * rng.rand(inp["x0"].shape[0])
  return (*out, inp)


def _weights(spec, inp, seed=11):
  """A seeded weighting of x (B, dx), P (B, de, de), t (B,), ys (T, B,
  dz)."""
  rng = np.random.RandomState(seed)
  B, (T, _, dz) = inp["x0"].shape[0], inp["zs"].shape
  return [rng.randn(*s) for s in ((B, spec.dim_x), (B, spec.dim_err,
                                                    spec.dim_err), (B,),
                                  (T, B, dz))]


def _loss(outs, W):
  return sum((o * f64(w)).sum() for o, w in zip(outs, W))


def run_plain(name, form, ring=False):
  spec, _, kind, Q, params, inp = family(name, form, ring)
  state = bank.BankState(x=f64(inp["x0"]), P=f64(inp["P0"]),
                         t=f64(inp["t0"]))
  final, ys = bank.run_bank_reference(
      spec, kind, {k: f64(v) for k, v in params.items()}, state, f64(Q),
      f64(inp["dts"]), f64(inp["zs"]), f64(inp["Rs"]),
      None if inp["eas"] is None else f64(inp["eas"]))
  return [a.numpy() for a in (final.x, final.P, final.t, ys)]


def _jax_args(name, form, ring=False):
  spec, jspec, kind, Q, params, inp = family(name, form, ring)
  a = jnp.asarray
  return jspec, kind, params, [a(inp[k]) for k in ("x0", "P0", "t0")], \
      a(Q), a(inp["dts"]), a(inp["zs"]), a(inp["Rs"]), \
      None if inp["eas"] is None else a(inp["eas"])


def run_jax(name, form, ring=False):
  jspec, kind, params, (x0, P0, t0), Q, dts, zs, Rs, eas = \
      _jax_args(name, form, ring)
  final, ys = jbank.jit_run_bank(jspec, kind)(
      {k: jnp.asarray(v) for k, v in params.items()},
      jbank.BankState(x=x0, P=P0, t=t0), Q, dts, zs, Rs, eas)
  return [np.asarray(a) for a in (final.x, final.P, final.t, ys)]


def jax_grads(name, form):
  spec = family(name, form)[0]
  jspec, kind, params, (x0, P0, t0), Q, dts, zs, Rs, eas = \
      _jax_args(name, form)
  W = [jnp.asarray(w) for w in _weights(spec, family(name, form)[5])]
  keys = sorted(params)

  def loss(x0, P0, t0, Q, dts, zs, Rs, eas, pv):
    final, ys = jbank.run_bank(jspec, kind, dict(zip(keys, pv)),
                               jbank.BankState(x=x0, P=P0, t=t0), Q, dts, zs,
                               Rs, eas)
    return sum(jnp.sum(o * w) for o, w in zip((final.x, final.P, final.t,
                                                ys), W))

  g = jax.jit(jax.grad(loss, argnums=tuple(range(9))))(
      x0, P0, t0, Q, dts, zs, Rs, eas,
      [jnp.asarray(params[k]) for k in keys])
  out = {n: (None if v is None else np.asarray(v))
         for n, v in zip(GRADS[:8], g[:8])}
  out["params"] = np.array([float(v) for v in g[8]])
  return out


@pytest.mark.parametrize("form", R_FORMS)
@pytest.mark.parametrize("name", FAMILIES)
def test_plain_loop_equals_jit_run_bank(name, form):
  """(a) run_bank_reference against the JAX package's jit_run_bank: x, P,
  t and ys to rtol 1e-10; the gated banks reject steps."""
  plain, jx = run_plain(name, form), run_jax(name, form)
  for what, a, b in zip(("x", "P", "t", "ys"), plain, jx):
    np.testing.assert_allclose(a, b, rtol=RTOL,
                               atol=1e-12 * np.abs(b).max(), err_msg=what)
  if name != "kinematic":
    # the gate fired: without it the outlier lanes end elsewhere
    spec, _, kind, Q, params, inp = family(name, form)
    free = dataclasses.replace(spec, obs={**spec.obs, kind: (
        dataclasses.replace(spec.obs[kind], maha_test=False))})
    state = bank.BankState(x=f64(inp["x0"]), P=f64(inp["P0"]),
                           t=f64(inp["t0"]))
    final, _ = bank.run_bank_reference(
        free, kind, {k: f64(v) for k, v in params.items()}, state, f64(Q),
        f64(inp["dts"]), f64(inp["zs"]), f64(inp["Rs"]),
        None if inp["eas"] is None else f64(inp["eas"]))
    assert np.abs(final.x.numpy()[::4] - plain[0][::4]).max() > 1e-2


# ------------------------------------------------------------ host builds

_LIBS = {}


def _build(source):
  d = pathlib.Path(tempfile.mkdtemp(prefix="rn_bank_host_"))
  (d / "gen.cu").write_text(source)
  proc = subprocess.run(
      [host_compiler(), "-x", "c++", "-std=c++17", "-O0", "-shared", "-fPIC",
       "-I", str(CSRC), "-o", str(d / "lib.so"), str(d / "gen.cu")],
      capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-4000:]
  return ctypes.CDLL(str(d / "lib.so"))


def _calls(name):
  """The three KernelCalls of a family's route: kernel 15 and the two lane
  forms (runtime/scan._kernel_call, as runtime/bank makes them)."""
  spec, _, kind, Q, params, _ = family(name, "lane")
  h = scan._handle(spec, (kind,), tuple(sorted(params)))
  qp = scan._q_pattern(f64(Q))
  return [scan._kernel_call(h, qp, mode, mode != "bank")
          for mode in ("bank", "stream", "stream_adjoint")]


def host_lib(call, tile=True):
  """The host build of a call's float64 source (every family's three and
  kernel 15's global forms built at once, in parallel, at the first
  call); tile=False: the global form's."""
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted kernels")
  if not _LIBS:
    srcs = list(dict.fromkeys(
        [c.source(torch.float64) for n in FAMILIES for c in _calls(n)]
        + [_calls(n)[0].source(torch.float64, tile=False)
           for n in FAMILIES]))
    with ThreadPoolExecutor(len(srcs)) as pool:
      _LIBS.update(zip(srcs, pool.map(_build, srcs)))
  src = call.source(torch.float64, tile)
  if src not in _LIBS:
    _LIBS[src] = _build(src)
  return _LIBS[src]


def _ptr(a):
  return None if a is None else ctypes.c_void_p(a.data_ptr())


def host_bank(call, x, P, t, zs, dts, Rs, eas, prm, Q, tile=True, src=None):
  """ops/generic_scan.bank_run_scan's work on CPU float64 tensors through
  kernel 15's host build (tile=False: its global form's; src: the build
  of that source text instead): x, P, t advanced in place; returns (x, P,
  t, ys)."""
  T, B = dts.shape[0], x.shape[-1]
  ys = x.new_zeros((T, call.spec.obs[call.kinds[0]].dz, B))
  if src is not None and src not in _LIBS:
    _LIBS[src] = _build(src)
  lib = host_lib(call, tile) if src is None else _LIBS[src]
  fn = lib.rn_generic_bank_host
  assert fn(_ptr(x), _ptr(P), _ptr(t), _ptr(zs), _ptr(eas), _ptr(dts),
            _ptr(Rs), ctypes.c_int(int(Rs.dim() == 4)), _ptr(prm), _ptr(Q),
            _ptr(ys), ctypes.c_int(T), ctypes.c_int(B)) == 0
  return x, P, t, ys


def host_stream_lanes(call, x, P, zs, dts, kind_idx, Rs, eas, prm, Q):
  """stream_bank_scan_lanes through kernel 9's lane form's host build."""
  spec = call.spec
  T, B = dts.shape[0], x.shape[-1]
  xp = x.new_zeros((T, spec.dim_x, B))
  Pp = x.new_zeros((T, spec.dim_err, spec.dim_err, B))
  st = [xp, Pp, torch.zeros_like(xp), torch.zeros_like(Pp)]
  fn = host_lib(call).rn_generic_stream_host
  assert fn(_ptr(x), _ptr(P), _ptr(zs), _ptr(eas), _ptr(dts), _ptr(kind_idx),
            _ptr(Rs), _ptr(prm), _ptr(Q), *map(_ptr, st), ctypes.c_int(T),
            ctypes.c_int(B)) == 0
  return tuple(st)


def host_adjoint_lanes(call, x0, P0, zs, dts, kind_idx, Rs, eas, prm, Q, xp,
                       Pp, xq, Pq, gx, gP, gxp, gPp, gxq, gPq, gys):
  """stream_bank_scan_adjoint_lanes through kernel 10's lane form's host
  build; sets the stand-in's gate_flips as the launcher does."""
  spec = call.spec
  T, B = dts.shape[0], x0.shape[-1]
  dz, ea = spec.obs[call.kinds[0]].dz, spec.obs[call.kinds[0]].ea_len
  dx, de = spec.dim_x, spec.dim_err
  new = lambda *s: x0.new_zeros(s)  # noqa: E731
  out = (new(dx, B), new(de, de, B), new(T, dz, B), new(T, dz, dz, B),
         new(T, B), new(T, ea, B) if ea else None, new(de, de, B),
         new(prm.shape[0], B))
  flips = torch.zeros(B, dtype=torch.int32)
  fn = host_lib(call).rn_generic_stream_adjoint_lane_host
  assert fn(*map(_ptr, (x0, P0, zs, eas, dts, kind_idx, Rs, prm, Q, xp, Pp,
                        xq, Pq, gx, gP, gxp, gPp, gxq, gPq, *out, flips,
                        gys)), ctypes.c_int(T), ctypes.c_int(B)) == 0
  host_adjoint_lanes.gate_flips = flips
  return out


def _rel(a, b):
  scale = np.abs(b).max() if np.size(b) else 0.0
  return float(np.abs(a - b).max() / scale) if scale else float(
      np.abs(a).max(initial=0.0))


def host_run(name, form, tile=True, src=None, ring=False):
  """A family's inputs through kernel 15's host build (host_bank), in the
  plain loop's layout: numpy (x (B, dx), P (B, de, de), t (B,), ys (T, B,
  dz))."""
  spec, _, kind, Q, params, inp = family(name, form, ring)
  lanes_last = lambda a: f64(a).permute(*range(1, a.ndim), 0).contiguous()  # noqa
  Rs = (f64(inp["Rs"]) if form == "shared"
        else f64(inp["Rs"]).permute(0, 2, 3, 1).contiguous())
  x, P, t, ys = host_bank(
      _calls(name)[0], lanes_last(inp["x0"]), lanes_last(inp["P0"]),
      f64(inp["t0"]).clone(), f64(inp["zs"]).permute(0, 2, 1).contiguous(),
      f64(inp["dts"]), Rs,
      None if inp["eas"] is None
      else f64(inp["eas"]).permute(0, 2, 1).contiguous(),
      f64([params[k] for k in sorted(params)] or [0.0]), f64(Q), tile, src)
  return [x.T.numpy(), P.permute(2, 0, 1).numpy(), t.numpy(),
          ys.permute(0, 2, 1).numpy()]


def _held(got, ref):
  """got (x, P, t, ys) against ref within BANK_TOL of each output's
  largest entry, t bitwise (one add a step in both)."""
  errs = {k: _rel(a, b) for k, a, b in zip(("x", "P", "ys"),
                                           got[:2] + got[3:],
                                           ref[:2] + ref[3:])}
  assert max(errs.values()) <= BANK_TOL, errs
  np.testing.assert_array_equal(got[2], ref[2])


@pytest.mark.parametrize("tile", (True, False), ids=("tile", "global"))
@pytest.mark.parametrize("form", R_FORMS)
@pytest.mark.parametrize("name", FAMILIES)
def test_kernel15_host_build_matches_plain(name, form, tile):
  """(b) Kernel 15's host build, its tile form (the card's) and its global
  form (a spec whose tile does not fit), against the plain loop on ys,
  x, P and t, within BANK_TOL of each output's largest entry; t bitwise
  (one add a step in both)."""
  call = _calls(name)[0]
  design = "tile" if tile else "global"
  assert f"// design: {design}" in call.source(torch.float64, tile)
  _held(host_run(name, form, tile), run_plain(name, form))


def _bank_source(call, monkeypatch, **consts):
  """Kernel 15's float64 source emitted with entry_slab's constants set."""
  with monkeypatch.context() as m:
    for k, v in consts.items():
      m.setattr(entry_slab, k, v)
    generic_scan._source.cache_clear()
    src = call.source(torch.float64)
  generic_scan._source.cache_clear()
  return src


def _design(src):
  return next(ln for ln in src.splitlines() if ln.startswith("// design"))


@pytest.mark.parametrize("ring", (False, True), ids=("family", "ring"))
@pytest.mark.parametrize("form", R_FORMS)
@pytest.mark.parametrize("name", ("kinematic", "car"))
def test_kernel15_one_warp_bitwise_two_warps(name, form, ring, monkeypatch):
  """(b) Kernel 15's tile at one warp (the lane's state in registers on
  the card) and at TILE_ROLES warps (the tile in shared memory), each
  built for the host in float64: the same x, P, t and ys bitwise, and
  both against the JAX package's jit_run_bank within BANK_TOL, t bitwise.
  ring: RING_B lanes (a whole block, 16-B copies, and a ragged one) over
  RING_T steps (the ring's stages reused, a ragged last chunk)."""
  call = _calls(name)[0]
  srcs = {w: _bank_source(call, monkeypatch, BANK_ONE_WARP_VALS=v)
          for w, v in ((1, 10 ** 9), (entry_slab.TILE_ROLES, 0))}
  for w, src in srcs.items():
    assert f"tile, {w} role{'s' if w > 1 else ''}," in _design(src)
  one, two = (host_run(name, form, src=src, ring=ring)
              for src in srcs.values())
  for a, b in zip(one, two):
    np.testing.assert_array_equal(a, b)
  _held(one, run_jax(name, form, ring))


@pytest.mark.parametrize("name", FAMILIES)
def test_kernel15_design_line_names_warps_and_ring(name):
  """(b) Each kernel 15 variant's design line names its warps and its
  ring (entry_slab.bank_design: BANK_STAGES stages of the steps that fit
  BANK_SMEM_TARGET), in float and double; the kinematic spec takes one
  warp, the live spec (a lane past BANK_ONE_WARP_VALS) TILE_ROLES."""
  call = _calls(name)[0]
  for dtype, scalar in ((torch.float32, "float"), (torch.float64, "double")):
    src = call.source(dtype)
    roles = int(src.split("constexpr int NROLES = ")[1].split(";")[0])
    chunk = int(src.split("constexpr int BANK_CHUNK = ")[1].split(";")[0])
    line = _design(src)
    assert line.startswith(f"// design: tile, {roles} role"), line
    assert (f"a ring of {entry_slab.BANK_STAGES} stages x {chunk} step"
            in line), line
    nz = call.spec.obs[call.kinds[0]].dz
    ea = call.spec.obs[call.kinds[0]].ea_len
    vals = int(src.split("constexpr int NSCR = ")[1].split(";")[0]) + \
        call.spec.dim_err ** 2 + call.spec.dim_x
    assert entry_slab.bank_design(vals, nz, ea, scalar)[:2] == (roles, chunk)
    assert (roles == 1) == (vals <= entry_slab.BANK_ONE_WARP_VALS)
    if name == "kinematic":
      assert roles == 1 and "no barrier in a step" in line
    if name == "live_gated":
      assert roles == entry_slab.TILE_ROLES


@pytest.mark.parametrize("limit", ("smaller ring", "global"))
def test_kernel15_ring_past_the_limit(limit, monkeypatch):
  """(b) A kernel 15 variant whose tile and ring pass the block's target
  stages fewer steps (down to one a stage), and one that passes
  TILE_SMEM_MAX even with one step a stage emits the global form; the
  design line says which, emission never raises, and the host build of
  either still equals the plain loop (the smaller ring reused over many
  more chunks)."""
  call = _calls("kinematic")[0]
  if limit == "smaller ring":
    target = entry_slab.bank_ring_bytes(1, 0, 4, "double")
    src = _bank_source(call, monkeypatch, BANK_SMEM_TARGET=target)
    assert "a ring of 2 stages x 4 steps" in _design(src), _design(src)
  else:
    src = _bank_source(call, monkeypatch, TILE_SMEM_MAX=16)
    assert _design(src).startswith("// design: global: the tile"), \
        _design(src)
    assert "#define REDNOSE_GENERIC_SCAN_TILE" not in src
  _held(host_run("kinematic", "lane", src=src, ring=True),
        run_plain("kinematic", "lane", ring=True))


# ---------------------------------------------- the card's route, on the CPU

class _StandIn:
  """A launcher replaced by a host build: counts its calls in `counts`;
  its gate_flips (read by the backward after a launch) is the host
  adjoint's."""

  def __init__(self, name, fn, counts):
    self.name, self.fn, self.counts = name, fn, counts

  def __call__(self, *args):
    self.counts[self.name] += 1
    return self.fn(*args)

  @property
  def gate_flips(self):
    return host_adjoint_lanes.gate_flips


def _route(monkeypatch):
  """The three launchers of run_bank's route replaced by their host
  builds; returns the launch counts by launcher name."""
  counts = {}
  for name, fn in (("bank_run_scan", host_bank),
                   ("stream_bank_scan_lanes", host_stream_lanes),
                   ("stream_bank_scan_adjoint_lanes", host_adjoint_lanes)):
    counts[name] = 0
    monkeypatch.setattr(generic_scan, name, _StandIn(name, fn, counts))
  return counts


def route_inputs(name, form, grad=True):
  """The family's inputs as CPU tensors (requiring grad), and the
  kwargs of run_bank."""
  spec, _, kind, Q, params, inp = family(name, form)
  names = ("x0", "P0", "t0", "Q", "dts", "zs", "Rs", "eas")
  vals = dict(zip(names, (f64(inp["x0"]), f64(inp["P0"]), f64(inp["t0"]),
                          f64(Q), f64(inp["dts"]), f64(inp["zs"]),
                          f64(inp["Rs"]),
                          None if inp["eas"] is None else f64(inp["eas"]))))
  prm = {k: f64(v) for k, v in params.items()}
  if grad:
    for v in (*vals.values(), *prm.values()):
      if v is not None:
        v.requires_grad_()
  return spec, kind, vals, prm


def route_run(spec, kind, vals, prm):
  state = bank.BankState(x=vals["x0"], P=vals["P0"], t=vals["t0"])
  final, ys = bank._kernel_run_bank(spec, kind, prm, state, vals["Q"],
                                    vals["dts"], vals["zs"], vals["Rs"],
                                    vals["eas"])
  return final.x, final.P, final.t, ys


def route_grads(name, form, monkeypatch):
  spec, kind, vals, prm = route_inputs(name, form)
  counts = _route(monkeypatch)
  outs = route_run(spec, kind, vals, prm)
  assert counts == {"bank_run_scan": 1, "stream_bank_scan_lanes": 0,
                    "stream_bank_scan_adjoint_lanes": 0}
  loss = _loss(outs, _weights(spec, family(name, form)[5]))
  keys = sorted(prm)
  wrt = [v for v in vals.values() if v is not None] + [prm[k] for k in keys]
  g = iter(torch.autograd.grad(loss, wrt))
  out = {n: (next(g).numpy() if v is not None else None)
         for n, v in vals.items()}
  out["params"] = np.array([float(next(g)) for _ in keys])
  assert counts == {"bank_run_scan": 1, "stream_bank_scan_lanes": 1,
                    "stream_bank_scan_adjoint_lanes": 1}
  return out, [o.detach().numpy() for o in outs]


@pytest.mark.parametrize("form", R_FORMS)
@pytest.mark.parametrize("name", FAMILIES)
def test_lane_forms_gradient_matches_jax(name, form, monkeypatch):
  """(c) The route's gradient (kernel 15's host build forward, the lane
  forms' host builds backward) against jax.grad, within ADJ_TOL of each
  gradient's largest entry, symmetric parts of P0, Q and Rs; its forward
  equals the plain loop within BANK_TOL; no gate flip."""
  got, outs = route_grads(name, form, monkeypatch)
  for a, b in zip(outs, run_plain(name, form)):
    assert _rel(a, b) <= BANK_TOL
  jx = jax_grads(name, form)
  errs = {}
  for k in GRADS:
    if jx[k] is None or got[k] is None:
      assert jx[k] is None and got[k] is None, k
      continue
    a, b = got[k], jx[k]
    if k in SYMMETRIC:
      a, b = a + np.swapaxes(a, -1, -2), b + np.swapaxes(b, -1, -2)
    assert a.shape == b.shape, (k, a.shape, b.shape)
    errs[k] = _rel(a, b)
  assert max(errs.values()) <= ADJ_TOL, errs
  assert int(host_adjoint_lanes.gate_flips.sum()) == 0


def test_route_at_t0_and_refusals(monkeypatch):
  """(d) T = 0: the route returns the state and no innovations (one call
  of the launcher, which launches nothing then); jvp through it and
  create_graph=True raise by name."""
  spec, kind, vals, prm = route_inputs("kinematic", "lane", grad=False)
  counts = _route(monkeypatch)
  empty = dict(vals, dts=vals["dts"][:0], zs=vals["zs"][:0],
               Rs=vals["Rs"][:0])
  x, P, t, ys = route_run(spec, kind, empty, prm)
  assert torch.equal(x, vals["x0"]) and torch.equal(P, vals["P0"])
  assert torch.equal(t, vals["t0"]) and ys.shape == (0, 6, 1)
  assert counts["bank_run_scan"] == 1   # which at T = 0 launches nothing
  with pytest.raises(NotImplementedError, match="forward mode"):
    torch.func.jvp(lambda z: route_run(spec, kind, dict(vals, zs=z), prm)[3],
                   (vals["zs"],), (torch.ones_like(vals["zs"]),))
  zs = vals["zs"].clone().requires_grad_()
  ys = route_run(spec, kind, dict(vals, zs=zs), prm)[3]
  with pytest.raises(NotImplementedError, match="create_graph"):
    torch.autograd.grad(ys.sum(), zs, create_graph=True)


def test_sharded_run_bank_by_lane_blocks(monkeypatch):
  """(d) sharded_run_bank on the dry run's bank case (B = 64, T = 32,
  float64) through the route: each of two ranks' block of lanes (the
  rank emulated on a one-rank mesh) launches kernel 15's host build once,
  and the blocks side by side equal the unsharded launch bitwise."""
  inp = dryrun.case_inputs("bank", "small")
  spec = KinematicKalman.build_spec()
  counts = _route(monkeypatch)
  monkeypatch.setattr(bank, "run_bank", bank._kernel_run_bank)
  state = bank.BankState(x=f64(inp["x0"]), P=f64(inp["P0"]),
                         t=f64(inp["t0"]))
  args = (f64(inp["Q"]), f64(inp["dts"]), f64(inp["zs"]), f64(inp["Rs"]))
  whole, ys = bank.run_bank(spec, 1, {}, state, *args)
  mesh = sharding.make_bank_mesh("cpu")
  monkeypatch.setattr(sharding.BankSharding, "size", property(lambda s: 2))
  parts = []
  for rank in range(2):
    monkeypatch.setattr(sharding.BankSharding, "index",
                        property(lambda s, r=rank: r))
    parts.append(sharding.sharded_run_bank(spec, 1, mesh, {}, state, *args))
  assert counts["bank_run_scan"] == 3
  for got, ref in ((torch.cat([p[0].x for p in parts]), whole.x),
                   (torch.cat([p[0].P for p in parts]), whole.P),
                   (torch.cat([p[0].t for p in parts]), whole.t),
                   (torch.cat([p[1] for p in parts], 1), ys)):
    assert torch.equal(got, ref)


# ------------------------------------------------------------ on the card

cuda = pytest.mark.skipif(not torch.cuda.is_available(),
                          reason="needs a CUDA device (kernel 15 and the "
                                 "lane forms of kernels 9 and 10)")


@cuda
@pytest.mark.cuda
@pytest.mark.parametrize("form", R_FORMS)
@pytest.mark.parametrize("name", FAMILIES)
def test_card_kernel15_and_lane_forms_match_plain(name, form):
  """(e) On the card, float64: run_bank (kernel 15) against the plain loop
  within BANK_TOL, t bitwise; its gradient (the lane forms) against
  autograd through the plain loop within ADJ_TOL."""
  spec, kind, vals, prm = route_inputs(name, form)
  dev = {k: (None if v is None else v.detach().cuda().requires_grad_())
         for k, v in vals.items()}
  dprm = {k: v.detach().cuda().requires_grad_() for k, v in prm.items()}
  before = (generic_scan.bank_run_scan.launches,
            generic_scan.stream_bank_scan_lanes.launches,
            generic_scan.stream_bank_scan_adjoint_lanes.launches)
  state = bank.BankState(x=dev["x0"], P=dev["P0"], t=dev["t0"])
  final, ys = bank.run_bank(spec, kind, dprm, state, dev["Q"], dev["dts"],
                            dev["zs"], dev["Rs"], dev["eas"])
  W = _weights(spec, family(name, form)[5])
  outs = (final.x, final.P, final.t, ys)
  keys = sorted(prm)
  wrt = [v for v in dev.values() if v is not None] + [dprm[k] for k in keys]
  g = torch.autograd.grad(_loss([o.cpu() for o in outs], W), wrt)
  after = (generic_scan.bank_run_scan.launches,
           generic_scan.stream_bank_scan_lanes.launches,
           generic_scan.stream_bank_scan_adjoint_lanes.launches)
  assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
  pstate = bank.BankState(x=vals["x0"], P=vals["P0"], t=vals["t0"])
  pf, pys = bank.run_bank_reference(spec, kind, prm, pstate, vals["Q"],
                                    vals["dts"], vals["zs"], vals["Rs"],
                                    vals["eas"])
  pouts = (pf.x, pf.P, pf.t, pys)
  for a, b in zip(outs[:2] + outs[3:], pouts[:2] + pouts[3:]):
    assert _rel(a.detach().cpu().numpy(), b.detach().numpy()) <= BANK_TOL
  assert torch.equal(outs[2].detach().cpu(), pouts[2].detach())
  pwrt = [v for v in vals.values() if v is not None] + [prm[k] for k in keys]
  pg = torch.autograd.grad(_loss(pouts, W), pwrt)
  names = [n for n, v in vals.items() if v is not None] + keys
  for n, a, b in zip(names, g, pg):
    a, b = a.cpu().numpy(), b.numpy()
    if n in SYMMETRIC:
      a, b = a + np.swapaxes(a, -1, -2), b + np.swapaxes(b, -1, -2)
    assert _rel(a, b) <= ADJ_TOL, n
