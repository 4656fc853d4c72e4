"""The port's examples (rednose_tpu_torch/examples) against the JAX
package's examples/ scripts, on the CPU: run_kinematic, run_car, run_loc
(both halves), run_compat_migration, run_mixed_bank and run_bank here;
run_live and the three MSCKF examples in tests/test_torch_examples_msckf.py
(pytest-xdist's --dist loadfile puts the two files on different workers).

Each case runs the JAX script through runpy, as tests/test_examples.py
does (its module, then its main() with stdout captured), and takes the
numbers it printed at full precision from the locals of its main() (and
run_loc's bank_demo()) at return: sys.monitoring watches those code
objects alone, so the rest of the run is not slowed. It then runs the
port's main(device="cpu") and holds:
- every number of the port's returned dict against the JAX one: 1e-6
  relative in the float64 examples; counts and outcomes exact; each
  float32 number at the tolerance stated beside it in its case, measured
  on this CPU, with the reason;
- every number of the JAX script's printed lines against the port's value
  of the same key, within half a unit of its last printed digit plus that
  number's tolerance; and the printed text between the numbers equal, but
  for the port's route in place of JAX's `pallas=...` and the device
  count of run_bank's mesh: JAX's spans every device of the process (8
  virtual CPUs), the port's every rank of its process group (one on the
  CPU here, the ranks under torchrun).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import pathlib
import re
import runpy
import sys

import numpy as np
import pytest
import torch
from torch_parity import cuda_device  # noqa: F401

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
NUMBER = re.compile(r"[-+]?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")
REL64 = (1e-6, 0.0)   # (rtol, atol) of a float64 number
EXACT = None
F32_EPS = float(np.finfo(np.float32).eps)
# printed text that differs by design: the route for `pallas=...`, the
# port's mesh size for the JAX mesh's device count
MASKS = ((re.compile(r"\((?:pallas=\w+|route: [^)]*)\)"), "(ROUTE)"),
         (re.compile(r"on \d+ device\(s\)"), "on N device(s)"))


@dataclasses.dataclass
class Case:
  """jax: the JAX main's locals ({function name: locals}) -> the numbers
  keyed as the port's main returns them; printed: the key of each number
  of the JAX script's stdout in order (None: a constant of the text, held
  by the text check); tols: (rtol, atol) by key where it is not REL64,
  EXACT for a count."""
  jax: object
  printed: tuple
  tols: dict = dataclasses.field(default_factory=dict)
  fns: tuple = ("main",)


def _free_tool():
  return next(t for t in (3, 4, 5, 2, 1, 0)
              if sys.monitoring.get_tool(t) is None)


def run_jax(name, fns=("main",)):
  """Run examples/<name>.py: (its stdout, {function: its locals at
  return} for each function of fns)."""
  sys.path.insert(0, str(EXAMPLES))
  try:
    g = runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name=f"jax_{name}")
    codes = {g[f].__code__: f for f in fns}
    captured = {}

    def on_return(code, offset, retval):
      if code in codes:
        captured[codes[code]] = dict(sys._getframe(1).f_locals)

    event = sys.monitoring.events.PY_RETURN
    tool = _free_tool()
    sys.monitoring.use_tool_id(tool, "rednose example locals")
    try:
      sys.monitoring.register_callback(tool, event, on_return)
      for code in codes:
        sys.monitoring.set_local_events(tool, code, event)
      out = io.StringIO()
      with contextlib.redirect_stdout(out):
        g["main"]()
    finally:
      for code in codes:
        sys.monitoring.set_local_events(tool, code, 0)
      sys.monitoring.register_callback(tool, event, None)
      sys.monitoring.free_tool_id(tool)
  finally:
    sys.path.pop(0)
  return out.getvalue(), captured


def run_port(name):
  """The port's example: (its stdout, its returned dict)."""
  mod = importlib.import_module(f"rednose_tpu_torch.examples.{name}")
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    got = mod.main(device="cpu")
  return out.getvalue(), got


def _flat(d):
  """{key: value}, a list value as key[0], key[1], ..."""
  out = {}
  for k, v in d.items():
    if isinstance(v, (list, tuple, np.ndarray)):
      out |= {f"{k}[{i}]": x for i, x in enumerate(np.asarray(v).tolist())}
    else:
      out[k] = v.item() if hasattr(v, "item") else v
  return out


def _unit(token):
  """Half a unit of the last printed digit of a number token."""
  m = re.fullmatch(r"[-+]?\d+(?:\.(\d*))?(?:[eE]([-+]?\d+))?", token)
  return 0.5 * 10.0**(-len(m.group(1) or "") + int(m.group(2) or 0))


def _masked(text):
  for pat, rep in MASKS:
    text = pat.sub(rep, text)
  return text


def hold(name, case):
  jax_out, captured = run_jax(name, case.fns)
  port_out, got = run_port(name)
  want = _flat(case.jax(captured))
  got = _flat(got)
  for key, w in want.items():
    g, tol = got[key], case.tols.get(key, REL64)
    if tol is EXACT or isinstance(w, (bool, int)):
      assert g == w, f"{name} {key}: port {g}, JAX {w}"
    else:
      rtol, atol = tol
      assert abs(g - w) <= rtol * abs(w) + atol, (
          f"{name} {key}: port {g!r}, JAX {w!r}, tolerance {tol}")
  # the printed lines: the same text, each JAX number the port's value
  jax_text, port_text = _masked(jax_out), _masked(port_out)
  assert NUMBER.split(port_text) == NUMBER.split(jax_text), (
      f"{name} printed:\n{port_out}\nJAX printed:\n{jax_out}")
  tokens = NUMBER.findall(jax_text)
  assert len(tokens) == len(case.printed), (tokens, case.printed)
  for token, key in zip(tokens, case.printed):
    if key is None:
      continue
    rtol, atol = (0.0, 0.0) if case.tols.get(key) is EXACT else \
        case.tols.get(key, REL64)
    w = float(token)
    assert abs(float(got[key]) - w) <= _unit(token) + rtol * abs(w) + atol, (
        f"{name} printed {key} {token}, port {got[key]!r}")
  return got


def test_example_run_kinematic():
  hold("run_kinematic", Case(
      jax=lambda c: {"position": c["main"]["xs_kf"][-1],
                     "truth": c["main"]["xs"][-1],
                     "std": c["main"]["xs_std"][-1]},
      printed=("position", "truth", "std")))


def test_example_run_car():
  def jax(c):
    m = c["main"]
    return {"steer_ratio": m["sR"], "steer_ratio_std": m["std"][0],
            "stiffness": m["sf"], "stiffness_std": m["std"][1],
            "angle_offset": m["ao"], "angle_offset_std": m["std"][2]}
  hold("run_car", Case(jax=jax, printed=(
      "steer_ratio", "steer_ratio_std", None, "stiffness", "stiffness_std",
      None, "angle_offset", "angle_offset_std", None)))


def test_example_run_compat_migration():
  def jax(c):
    m = c["main"]
    return {"position": m["state"][0], "truth": m["x"],
            "position_std": m["std"][0], "velocity": m["state"][1],
            "velocity_std": m["std"][1]}
  hold("run_compat_migration", Case(jax=jax, printed=(
      "position", "truth", "position_std", "velocity", "velocity_std",
      None, None, None)))


def test_example_run_loc():
  """The engine half in float64; bank_demo's bank in float32 at ECEF
  scale from the 1e8 m^2 prior (KalmanBank's default dtype in both
  packages), where a range ulp is 2 m and two float32 programs part by
  tens of metres on a lane and by hundreds on a few (JAX 29.31 m mean,
  762.7 m on lane 5; the port 10.92 m, 2.8 m there): bank_err1 is held at
  30 m absolute, and test_loc_bank_demo_in_double holds the same bank on
  the same data in double at 1e-6 sigma. bank_err0 is computed from the
  data alone."""
  def jax(c):
    m, b = c["main"], c["bank_demo"]
    return {"pos_err": m["pos_err"], "vel_err": m["vel_err"],
            "bias_err": m["bias_err"], "drift_err": m["drift_err"],
            "bank_err0": b["err0"], "bank_err1": b["err1"]}
  got = hold("run_loc", Case(
      jax=jax, fns=("main", "bank_demo"),
      printed=(None, None, "pos_err", "vel_err", "bias_err", "drift_err",
               None, None, "bank_err0", "bank_err1"),
      tols={"bank_err1": (0.0, 30.0)}))
  assert got["bank_err1"] < got["bank_err0"]


def test_loc_bank_demo_in_double():
  """run_loc's bank_demo bank (LocKalman, B = 64, T = 16 pseudorange and
  rate epochs, per-lane satellite states) in float64 in both packages:
  every lane within 1e-6 standard deviations of the JAX bank in every
  state and covariance entry (utils/compare.py)."""
  import jax.numpy as jnp
  from rednose_tpu.models.loc import LocKalman as JLoc
  from rednose_tpu.runtime.generic_bank import KalmanBank as JBank

  from rednose_tpu_torch.examples.run_loc import (
      BANK_B,
      BANK_T,
      bank_demo_data,
  )
  from rednose_tpu_torch.models.loc import LocKalman
  from rednose_tpu_torch.runtime.generic_bank import KalmanBank
  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  kinds, kind_idx, zs, eas, _ = bank_demo_data()
  jbank = JBank(JLoc, batch=BANK_B, dtype=jnp.float64, use_pallas=False)
  bank = KalmanBank(LocKalman, batch=BANK_B, dtype=torch.float64,
                    device="cpu")
  for b in (jbank, bank):
    b.run_mixed(np.full(BANK_T, 0.1), kind_idx, zs, kinds, eas=eas)
  ex, ep = lane_sigma_errs(
      LocKalman.build_spec(), bank._x, bank._P,
      torch.as_tensor(np.array(jbank._x)).T,
      torch.as_tensor(np.array(jbank._P)))
  assert float(ex.max()) < 1e-6 and float(ep.max()) < 1e-6, (ex, ep)


def test_example_run_mixed_bank():
  """float32 from the 10-rad attitude prior (LiveKalmanBank's default in
  both packages), where the first accelerometer update cancels an
  attitude variance of 100 to ~1e-3 and two float32 programs part in the
  low digits: pos_var, a mean over 512 lanes, is held at 1e-5 relative
  (measured: 1.57e-07, about one float32 ulp), and
  quat_err, the largest |norm - 1| over 512 lanes, which is a rounding of
  a few float32 ulps whatever the program (JAX 1 ulp, the port 1.5), at 4
  ulps of 1.0 absolute."""
  def jax(c):
    m = c["main"]
    return {"pos_var": m["pos_var"], "quat_err": m["quat_err"],
            "t": m["bank"].t}
  got = hold("run_mixed_bank", Case(
      jax=jax, printed=(None, None, "pos_var", None, "quat_err", "t"),
      tols={"pos_var": (1e-5, 0.0), "quat_err": (0.0, 4 * F32_EPS)}))
  assert got["launches"] == {}   # the CPU runs the plain version


def test_example_run_bank():
  """float32 kinematic bank sharded over a mesh in both packages: rmse, a
  sum over 4096 lanes in another order, is held at 1e-5 relative
  (measured: 1.09e-07, about one float32 ulp); the JAX script's mesh
  spans every device of the test process (8 virtual CPUs), the port's
  every rank of its process group, here one (a one-rank group on the
  CPU)."""
  got = hold("run_bank", Case(
      jax=lambda c: {"rmse": float(c["main"]["rmse"])},
      printed=(None, None, "rmse"),
      tols={"rmse": (1e-5, 0.0)}))
  assert got["devices"] == 1


@pytest.mark.cuda
def test_bank_examples_on_card(cuda_device):
  """On the card the bank examples launch their kernels (run_mixed_bank
  kernel 3, run_loc's bank_demo kernel 6, run_msckf_bank kernel 6 with
  frames and 4 kernel 7 launches) and print what the CPU run prints:
  run_msckf_bank (float64) to 1e-6 relative, run_mixed_bank at the
  tolerances of its CPU case. bank_demo's float32 bank at ECEF scale parts
  from the CPU's by tens of metres a lane (any two float32 programs do,
  see test_example_run_loc): its own asserts hold, and the same bank in
  double (kernel 6's float64 build) holds every lane within 1e-6 sigma of
  the CPU's."""
  from rednose_tpu_torch.examples import run_loc, run_mixed_bank
  from rednose_tpu_torch.examples import run_msckf_bank

  dev = str(cuda_device)
  card, cpu = run_msckf_bank.main(device=dev), run_msckf_bank.main("cpu")
  assert card["launches"] == {"generic_bank_scan_mixed": 1,
                              "vo_bank_scan": 4}
  for key in ("err0", "err1"):
    assert abs(card[key] - cpu[key]) <= 1e-6 * abs(cpu[key])
  assert card["late_replayed"] and card["too_old_dropped"]
  card, cpu = run_mixed_bank.main(device=dev), run_mixed_bank.main("cpu")
  assert card["launches"] == {"live_bank_scan_mixed": 1}
  assert abs(card["pos_var"] - cpu["pos_var"]) <= 1e-5 * cpu["pos_var"]
  assert abs(card["quat_err"] - cpu["quat_err"]) <= 4 * F32_EPS
  card = run_loc.bank_demo(device=dev)
  assert card["launches"] == {"generic_bank_scan_mixed": 1}
  assert card["bank_err1"] < card["bank_err0"]

  from rednose_tpu_torch.models.loc import LocKalman
  from rednose_tpu_torch.runtime.generic_bank import KalmanBank
  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  kinds, kind_idx, zs, eas, _ = run_loc.bank_demo_data()
  banks = [KalmanBank(LocKalman, batch=run_loc.BANK_B, dtype=torch.float64,
                      device=d) for d in (dev, "cpu")]
  for b in banks:
    b.run_mixed(np.full(run_loc.BANK_T, 0.1), kind_idx, zs, kinds, eas=eas)
  ex, ep = lane_sigma_errs(LocKalman.build_spec(), banks[0]._x.cpu(),
                           banks[0]._P.cpu(), banks[1]._x, banks[1]._P)
  assert float(ex.max()) < 1e-6 and float(ep.max()) < 1e-6, (ex, ep)
