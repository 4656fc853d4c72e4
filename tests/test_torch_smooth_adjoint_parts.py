"""The decompositions that kernels 11' and 12' (csrc/smooth_adjoint.cuh,
emitted mode "smooth_adjoint", ops/adjoint.py) run on the card, checked
against the whole emitted functions at one point per spec, float64, in
the host build (rn_smooth_adjoint_parts_host):

  * 11' runs F's VJP in SM_PARTS parts across a block's warps
    (gen_sm_F_vjp_part, each from the entries of gF its part of F
    computes): the parts' gx, gdt and gp summed equal the whole
    gen_sm_F_vjp's within PARTS_TOL of each one's largest entry;
  * 12' carries the state chain as a DX x DX map A_k formed in a pass
    before the chain, its columns from the VJPs pruned to the carried
    cotangents (gen_sm_inject_vjp_dx_n*, gen_sm_inv_err_vjp_xb) at unit
    seeds: A_k go equals the full VJPs' x_s[k+1] cotangent,
    gen_sm_inv_err_vjp of C^T on the main block of gen_sm_inject_vjp_n*'s
    dx' cotangent, within PARTS_TOL.

Kinematic, car with its params, live (with and without renormalized
quaternions) and msckf_eskf (clone slots: d2 < de); inputs from a seeded
numpy generator around each model's x0. No JAX: both sides are the
port's own emitted functions (tests/test_torch_smooth_grad*.py hold the
kernels' host builds against jax.grad)."""

import ctypes
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest

from rednose_tpu_torch.models.car import DEFAULT_PARAMS, CarKalman
from rednose_tpu_torch.models.kinematic import KinematicKalman
from rednose_tpu_torch.models.live import LiveKalman
from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
from rednose_tpu_torch.ops import smooth_scan
from torch_parity import host_compiler

CSRC = (pathlib.Path(__file__).resolve().parent.parent / "rednose_tpu_torch"
        / "csrc")
# the parts' sum against the whole, A_k go against the full VJPs, relative
# to each output's largest entry (the order of the sums differs)
PARTS_TOL = 1e-12
MODELS = {"kinematic": KinematicKalman, "car": CarKalman,
          "live": LiveKalman, "msckf_eskf": MSCKFEskf}
# (model, the params' names, inject's renormalization)
CASES = (("kinematic", (), 0), ("car", tuple(sorted(DEFAULT_PARAMS)), 0),
         ("live", (), 1), ("live", (), 0), ("msckf_eskf", (), 1))


def parts_lib(spec, pnames):
  """The host build of the spec's mode "smooth_adjoint" source, its
  rn_smooth_adjoint_parts_host declared."""
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH")
  d = pathlib.Path(tempfile.mkdtemp(prefix="rn_sma_parts_"))
  (d / "gen.cu").write_text(smooth_scan.smooth_adjoint_source(spec, pnames))
  proc = subprocess.run(
      [host_compiler(), "-x", "c++", "-std=c++17", "-O1", "-shared", "-fPIC",
       "-I", str(CSRC), "-o", str(d / "lib.so"), str(d / "gen.cu")],
      capture_output=True, text=True)
  assert proc.returncode == 0, proc.stderr[-4000:]
  fn = ctypes.CDLL(str(d / "lib.so")).rn_smooth_adjoint_parts_host
  fn.argtypes = ([ctypes.c_void_p, ctypes.c_double] + [ctypes.c_void_p] * 8
                 + [ctypes.c_int, ctypes.c_void_p])
  fn.restype = ctypes.c_int
  return fn


def point(model, spec, pnames, seed):
  """Seeded inputs: x, xa, xb, xk around x0 (quaternions normalized), dt,
  the params, gF (d2 x d2), dx' (de), go (dx), C (d2 x d2)."""
  rng = np.random.RandomState(seed)
  dx, de, d2 = spec.dim_x, spec.dim_err, spec.dim_main_err
  x0 = np.asarray(model.initial_x, np.float64)
  x0 = np.where(x0 == 0, 0.1, x0)

  def state():
    x = x0 * (1 + 0.05 * rng.randn(dx)) + 0.05 * rng.randn(dx)
    for q in spec.quaternion_idxs:
      x[q:q + 4] /= np.linalg.norm(x[q:q + 4])
    return x

  prm = np.asarray([DEFAULT_PARAMS[k] for k in pnames] or [0.0])
  return dict(x=state(), dt=0.01 + 0.01 * rng.rand(), p=prm,
              gF=rng.randn(d2, d2), xa=state(), xb=state(), xk=state(),
              dxp=0.01 * rng.randn(de), go=rng.randn(dx),
              C=0.3 * rng.randn(d2, d2))


def rel(a, b):
  return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name,pnames,norm", CASES)
def test_decompositions_match_the_whole_vjps(name, pnames, norm):
  """F's VJP parts summed against gen_sm_F_vjp (gx, gdt, the params'), and
  A_k go against the full VJPs' x_s[k+1] cotangent, float64, within
  PARTS_TOL of each output's largest entry; A_k go nonzero."""
  model = MODELS[name]
  spec = model.build_spec()
  fn = parts_lib(spec, pnames)
  dx, np_ = spec.dim_x, len(pnames)
  vals = dx + 1 + max(np_, 1)
  out = np.zeros(2 * vals + 2 * dx)
  pt = {k: np.ascontiguousarray(v, np.float64) if k != "dt" else v
        for k, v in point(model, spec, pnames, 11).items()}
  ptr = lambda a: a.ctypes.data  # noqa: E731
  assert fn(ptr(pt["x"]), pt["dt"], ptr(pt["p"]), ptr(pt["gF"]),
            ptr(pt["xa"]), ptr(pt["xb"]), ptr(pt["xk"]), ptr(pt["dxp"]),
            ptr(pt["go"]), ptr(pt["C"]), norm, ptr(out)) == 0
  parts, whole = out[:vals], out[vals:2 * vals]
  ax, ref = out[2 * vals:2 * vals + dx], out[2 * vals + dx:]
  for what, a, b in (("gx", parts[:dx], whole[:dx]),
                     ("gdt", parts[dx:dx + 1], whole[dx:dx + 1]),
                     ("gp", parts[dx + 1:dx + 1 + np_],
                      whole[dx + 1:dx + 1 + np_])):
    if b.size:
      assert rel(a, b) <= PARTS_TOL, (what, rel(a, b))
  assert np.abs(ref).max() > 0
  assert rel(ax, ref) <= PARTS_TOL, rel(ax, ref)
