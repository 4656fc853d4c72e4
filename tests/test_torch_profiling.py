"""utils/profiling on the port, mirroring tests/test_aux_subsystems.py's
profiling tests (assert_finite, finite_or_nan_flag, cost_report and the
FLOP counter), with the port's counter held against the JAX package's
jaxpr_flops on the same bodies, and its trace read back on the CPU."""

import glob
import json

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rednose_tpu_torch.utils import profiling


def test_assert_finite():
  profiling.assert_finite({"x": np.ones(3), "P": [torch.eye(2)]})
  with pytest.raises(FloatingPointError, match=r"state\['x'\]"):
    profiling.assert_finite({"x": np.array([1.0, np.nan])})
  with pytest.raises(FloatingPointError, match=r"bank\[1\]\.P"):
    from rednose_tpu_torch.runtime.bank import BankState

    st = BankState(x=torch.zeros(2, 2), P=torch.full((2, 2, 2), np.inf),
                   t=torch.zeros(2))
    profiling.assert_finite((torch.ones(1), st), name="bank")


class _HostReads(TorchDispatchMode):
  """Counts the ops that read a tensor's value back to the host (.item(),
  bool(), float(): aten._local_scalar_dense)."""

  def __init__(self):
    super().__init__()
    self.reads = 0

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    if func is torch.ops.aten._local_scalar_dense.default:
      self.reads += 1
    return func(*args, **(kwargs or {}))


def test_finite_flag_reads_nothing_back():
  with _HostReads() as mode:
    ok = profiling.finite_or_nan_flag({"a": torch.ones(4),
                                       "b": [torch.zeros(2, 2)]})
    bad = profiling.finite_or_nan_flag({"a": torch.tensor([1.0, np.inf])})
  assert mode.reads == 0
  assert torch.is_tensor(ok) and ok.shape == () and ok.dtype == torch.bool
  assert bool(ok) and not bool(bad)


def test_cost_report():
  from rednose_tpu_torch.core import step
  from rednose_tpu_torch.models.kinematic import KinematicKalman

  spec = KinematicKalman.build_spec()
  rep = profiling.cost_report(
      lambda x, P, Q, dt: step.predict(spec, {}, x, P, Q, dt),
      torch.zeros(2), torch.eye(2), torch.eye(2), torch.tensor(0.01))
  assert rep["flops"] > 0 and rep["bytes accessed"] > 0


def test_torch_flops_counter():
  """The JAX counter's own cases (test_aux_subsystems.py), exact."""
  z, o = torch.zeros, torch.ones
  assert profiling.torch_flops(lambda a, b: a * b + b,
                               z((4, 5)), o((4, 5))) == 40
  assert profiling.torch_flops(lambda a, b: a @ b,
                               z((3, 4)), z((4, 2))) == 48

  def loop(x):   # a Python loop counts every trip, as a JAX scan does
    for _ in range(7):
      x = x * 2.0 + 1.0
    return x
  assert profiling.torch_flops(loop, z((5,))) == 7 * 2 * 5
  assert profiling.torch_flops(lambda a: a.T.reshape(-1), z((4, 5))) == 0


def _live_inputs(mod, asarray):
  """The live model's x (23, 1), P (22, 22, 1), Q, R (25 I), z and dt in
  float64, from the package `mod`'s LiveKalman, as tools/flops_report.py
  builds them."""
  lk = mod.LiveKalman
  x = asarray(lk.initial_x)[:, None]
  P = asarray(np.diag(lk.initial_P_diag))[..., None]
  z = asarray(lk.initial_x[:3])[:, None]
  return x, P, asarray(lk.Q), asarray(np.diag([25.0] * 3)), z


def test_flops_match_jaxpr_flops():
  """The port's counter against jaxpr_flops on the same bodies in
  float64: the hand live step (predict + ECEF_POS update, live_lane)
  within 1%, the dense core/step predict + ECEF_POS update within 5%
  (aten dispatches some composites whole, a vector norm among them, which
  count 0 here where JAX counts their primitives)."""
  import jax.numpy as jnp
  from rednose_tpu.core import step as jstep
  from rednose_tpu.models import live as jlive
  from rednose_tpu.ops import live_lane as jlane
  from rednose_tpu.utils.profiling import jaxpr_flops

  from rednose_tpu_torch.core import step
  from rednose_tpu_torch.models import live
  from rednose_tpu_torch.ops import live_lane

  K = int(live.ObservationKind.ECEF_POS)
  j = _live_inputs(jlive, lambda a: jnp.asarray(a, jnp.float64))
  t = _live_inputs(live, lambda a: torch.as_tensor(np.asarray(a),
                                                   dtype=torch.float64))
  jdt, tdt = jnp.asarray(0.01), torch.tensor(0.01, dtype=torch.float64)

  f_jax = jaxpr_flops(lambda x, P, z: jlane.live_step_slab(
      x, P, j[2], jdt, z, j[3]), j[0], j[1], j[4])
  f_port = profiling.torch_flops(lambda x, P, z: live_lane.live_step_slab(
      x, P, t[2], tdt, z, t[3]), t[0], t[1], t[4])
  assert abs(f_port - f_jax) <= 0.01 * f_jax, (f_port, f_jax)

  jspec, spec = jlive.LiveKalman.build_spec(), live.LiveKalman.build_spec()

  def jdense(x, P, z):
    xp, Pp = jstep.predict(jspec, {}, x, P, j[2], jdt)
    return jstep.update(jspec, K, {}, xp, Pp, z, j[3], jnp.zeros(1))

  def dense(x, P, z):
    xp, Pp = step.predict(spec, {}, x, P, t[2], tdt)
    return step.update(spec, K, {}, xp, Pp, z, t[3],
                       torch.zeros(1, dtype=torch.float64))

  f_jax = jaxpr_flops(jdense, j[0][:, 0], j[1][..., 0], j[4][:, 0])
  f_port = profiling.torch_flops(dense, t[0][:, 0], t[1][..., 0], t[4][:, 0])
  assert abs(f_port - f_jax) <= 0.05 * f_jax, (f_port, f_jax)


def test_trace_writes_the_step_scopes(tmp_path):
  """trace() writes a Chrome trace on the CPU, and the kinematic filter's
  predict and update scopes (core/step.py) and an annotate_step scope are
  in it."""
  from rednose_tpu_torch.models.kinematic import KinematicKalman

  kf = KinematicKalman(device="cpu")
  step = profiling.annotate_step(kf.predict_and_observe, "example/step")
  with profiling.trace(str(tmp_path)):
    for i in range(3):
      step(0.01 * (i + 1), 1, [0.1 * i])
  files = glob.glob(str(tmp_path / "*.pt.trace.json"))
  assert len(files) == 1
  with open(files[0]) as f:
    names = {e.get("name") for e in json.load(f)["traceEvents"]}
  assert {"rednose/kinematic/predict", "rednose/kinematic/update_1",
          "example/step"} <= names


def test_flops_report(tmp_path):
  """tools/flops_report: the eight bodies, each with FLOPs, bytes and the
  emitted body's operations; the hand live step's FLOPs are the ones
  test_flops_match_jaxpr_flops holds (float32 here); the sustained-rate
  lines read chip_smoke.py's times JSON and nothing else."""
  from rednose_tpu_torch.tools import flops_report

  times = tmp_path / "times.json"
  times.write_text(json.dumps({"card": "a card", "rows": [
      {"name": "live_bank_scan", "shape": "B=8192 T=64 gate on",
       "ms": 0.5}]}))
  rows = flops_report.main(["--times", str(times)])
  assert len(rows) == 8
  assert all(f > 0 and b > 0 and o > 0 for _, f, b, o, _ in rows)
  assert rows[0][1] == 9214
  rate, row = rows[0][4]
  assert rate == 8192 * 64 / 0.5e-3 and row["name"] == "live_bank_scan"
  assert all(r[4] is None for r in rows[1:])


def test_user_spec_ops_are_counted():
  """The ops the emitter takes beyond the shipped models count in both
  counters: torch_flops by the rule (an elementwise function one FLOP an
  output element, a cross product 3, a vector norm its squares and root,
  a mean its division, cumsum / flip / roll 0, as data movement and
  reductions), on a 4-vector through user_specs.OPS (each op's output
  times ones where it is a scalar: 4 more); and step_ops on the battery's
  epoch variant, kernel 5's body, counts every emitted definition that is
  not a load, the fmod, remainder and hypot calls among them."""
  import re

  from rednose_tpu_torch.models import user_specs as us
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  x = torch.as_tensor(us.OP_X0)
  expected = {"tanh": 4, "sigmoid": 4, "softplus": 4, "abs": 4,
              "norm": 3 + 1 + 4, "cross": 9, "remainder": 4, "fmod": 4,
              "hypot": 4, "cumsum": 0, "flip": 0, "roll": 0,
              "mean": 1 + 4}
  assert {n: profiling.torch_flops(op, x) for n, op in us.OPS.items()} \
      == expected
  # the jvp's aten ops count as one elementwise function each
  t = torch.ones(4, dtype=torch.float64)
  for name, n in (("tanh", 8), ("sigmoid", 8), ("softplus", 8)):
    assert profiling.torch_flops(
        lambda v: torch.func.jvp(us.OPS[name], (v,), (t,)), x) == n, name

  spec = us.battery_spec()
  slots = us.BATTERY_SLOTS
  src = gs.KernelCall(
      spec, "epoch", slots, Q=us.BATTERY_Q,
      R_list=[us.BATTERY_R[k] for k in slots],
      structure=sparsity.structure_for(spec, us.BATTERY_X0)
  ).counting_source()
  ops = profiling.emitted_ops(src)
  load = re.compile(r"= (x\[|GEN_P\(|dt;|p\[|Q\[|z\[|ea\[|R\[)")
  defs = [ln for ln in src.splitlines()
          if re.match(r"  const (scalar_t|bool) ", ln)
          and not load.search(ln)]
  assert sum(ops.values()) == len(defs)
  for fn in ("g_fmod", "g_remainder", "g_hypot", "g_tanh", "g_exp"):
    assert any(fn + "(" in ln for ln in defs), fn
  assert profiling.step_ops(src, slots, "epoch") == ops["gen_predict"] + sum(
      next(v for k, v in ops.items() if re.fullmatch(
          rf"gen_update_k{int(s)}(_g)?", k)) for s in slots)
