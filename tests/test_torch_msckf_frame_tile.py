"""The camera frame in tile form (ops/entry_slab.py): kernel 7 (mode
"frame") and kernel 6 with a camera-frame unit (mode "mixed", the VIO
schedule), the emitted text the card runs, built with the host C++
compiler as double (tests/torch_parity.run_host: the template's host loop
runs, for each filter and step, every role's predict, then the step's
unit: its shared values, every role's compute, every role's store).

msckf_eskf's double tile (443,648 B a block) exceeds what a block may use,
so its global form is what a float64 bank runs on the card; here the
emitter's limit is raised (the host loop has none) to build its tile.

Held, float64: kernel 7's tile against the JAX package's
pallas_bank.vo_bank_scan in interpret mode (B = 8, T = 8, the gate on and
a frame whose outliers the gate rejects) at rtol 1e-9; kernel 6's VIO
tile of both models against pallas_bank.generic_bank_scan_mixed in
interpret mode (tests/test_torch_vio_emitter.py's schedule) at rtol
1e-9; each tile against its own global form at rtol 1e-12, from a P with
a distinct value in every entry; and the `// design:` lines of the
shipped variants. msckf_eskf's kernel 7 against JAX and its tiles against
their global form are in tests/test_torch_msckf_frame_tile_eskf.py, a
file of its own so that the long builds run on another test worker.
Skips the host builds, with the reason, where no C++ compiler is on
PATH."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models import msckf_eskf as jes
from rednose_tpu.models import msckf_vo as jvo
from rednose_tpu.ops import pallas_bank
from rednose_tpu.ops import sparsity as jsparsity
from rednose_tpu_torch import interop
from rednose_tpu_torch.models import msckf_eskf as tes
from rednose_tpu_torch.models import msckf_vo as tvo
from rednose_tpu_torch.ops import entry_slab, generic_scan, sparsity
from torch_parity import host_compiler, np_, run_host, vio_schedule
import test_torch_msckf_emitter as frame_tests
import test_torch_vio_emitter as vio_tests

RTOL = 1e-9
KIND = 16
IDS = ["msckf_vo", "msckf_eskf"]


@pytest.fixture(autouse=True)
def _needs_compiler():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build the "
                "emitted source")


@pytest.fixture
def roomy(monkeypatch):
  """The emitter with no shared-memory limit, so msckf_eskf's double
  variants print their tile too (the host loop keeps the tile in ordinary
  memory); the emission cache is cleared on both sides."""
  monkeypatch.setattr(entry_slab, "TILE_SMEM_MAX", 1 << 30)
  generic_scan._source.cache_clear()
  yield
  generic_scan._source.cache_clear()


def _frame_call(tm, R, gate=None):
  spec = tm.build_spec()
  return generic_scan.KernelCall(
      spec, "frame", (KIND,), Q=tm.Q, R_list=(R,), gate=gate,
      structure=sparsity.structure_for(spec, tm.initial_x))


def _vio_call(tm, R_list):
  spec = tm.build_spec()
  return generic_scan.KernelCall(
      spec, "mixed", vio_tests.KINDS, Q=tm.Q, R_list=R_list,
      structure=sparsity.structure_for(spec, tm.initial_x))


def _tile_roles(src):
  """The W of a tile source, from its NROLES line."""
  assert "// design: tile" in src and "#define REDNOSE_GENERIC_SCAN_TILE" \
      in src
  return int(src.split("constexpr int NROLES = ")[1].split(";")[0])


def check_frame_tile_against_jax(jm, tm, gate_work=False):
  """T frames of block predict + projected feature update + window roll,
  the tile against the JAX VO kernel itself; with gate_work, also that
  frame 3's outliers (every third lane) are gated: ungated, those lanes
  end elsewhere."""
  jspec, xs, P, eas, zs = frame_tests._bank(jm, np.random.RandomState(10))
  R = np.eye(jspec.obs[KIND].dz) * 0.01**2
  T = zs.shape[0]
  dts = np.full(T, 0.05)
  assert _tile_roles(_frame_call(tm, R).source(torch.float64)) == \
      entry_slab.TILE_ROLES_FRAME
  xp, Pp = pallas_bank.pack_bank(jnp.asarray(xs), jnp.asarray(P))
  xo, Po = pallas_bank.vo_bank_scan(
      xp, Pp, pallas_bank.pack_bank_measurements(jnp.asarray(zs)),
      pallas_bank.pack_bank_measurements(jnp.asarray(eas)),
      jnp.asarray(dts), spec=jspec, kind=KIND,
      q_diag=tuple(np.diag(jm.Q)), r_mat=tuple(tuple(r) for r in R),
      gate=True, t_chunk=4, tile_b=8, interpret=True,
      structure=jsparsity.structure_for(jspec, jm.initial_x),
      phase_mode="flat")
  xr, Pr = interop.bank_from_jax(xo, Po, torch.float64)
  x, Pn = frame_tests._host(tm, xs, P, zs, eas, dts, R)
  np.testing.assert_allclose(np_(x), np_(xr), rtol=RTOL, atol=1e-12)
  np.testing.assert_allclose(np_(Pn), np_(Pr), rtol=RTOL, atol=1e-13)
  assert torch.equal(Pn, Pn.transpose(0, 1))
  if gate_work:
    xu, _ = frame_tests._host(tm, xs, P, zs, eas, dts, R, gate=False)
    assert not np.allclose(np_(xu)[:, 0::3], np_(x)[:, 0::3])


def check_vio_tile_against_jax(jm, tm):
  """Camera frame / position fix / frame / fix through kernel 6's tile
  (the frame unit and POSITION switched on the step's kind) against the
  JAX mixed kernel's camera-frame branch."""
  src = _vio_call(tm, (np.eye(3), 0.01**2 * np.eye(8))).source(
      torch.float64)
  assert _tile_roles(src) == entry_slab.TILE_ROLES_FRAME
  assert "#define REDNOSE_GENERIC_SCAN_TILE_KINDS" in src
  vio_tests.check_mixed_against_jax_kernel(jm, tm)


def test_frame_tile_matches_jax_vo_kernel(roomy):
  """msckf_vo (msckf_eskf: tests/test_torch_msckf_frame_tile_eskf.py, a
  file of its own so that its long cases run on another test worker)."""
  check_frame_tile_against_jax(jvo.MSCKFVisualOdometry,
                               tvo.MSCKFVisualOdometry, gate_work=True)


@pytest.mark.parametrize("models", [
    (jvo.MSCKFVisualOdometry, tvo.MSCKFVisualOdometry),
    (jes.MSCKFEskf, tes.MSCKFEskf)], ids=IDS)
def test_vio_tile_matches_jax_mixed_kernel(models, roomy):
  check_vio_tile_against_jax(*models)


def _distinct_P(de, B, rng):
  A = rng.randn(B, de, de)
  return np.einsum("bij,bkj->ikb", A, A) / de + np.eye(de)[:, :, None]


def check_tile_against_global(tm, mode, monkeypatch):
  """The same variant as a tile and, with no shared memory to spare, in
  the global form (one function a phase, the rolled P stored as soon as
  computed, each old entry loaded before its store): both built as
  double agree to rounding, from a P with a distinct value in every
  entry, over frames (and fixes) whose outliers the gate rejects."""
  B, T = 8, 4
  spec = tm.build_spec()
  xs, zs, eas, kind_idx = vio_schedule(tm, T, B, seed=11)
  zs[2, ::3, :] += 5.0       # frame 2's outliers: rejected
  if mode == "frame":        # every step a camera frame
    zs[1::2] = zs[0::2]
    eas[1::2] = eas[0::2]
    kinds, R_list, kind_idx = (KIND,), (0.01**2 * np.eye(8),), None
  else:
    kinds, R_list = vio_tests.KINDS, (np.eye(3), 0.01**2 * np.eye(8))
  P = _distinct_P(spec.dim_err, B, np.random.RandomState(12))
  kw = dict(Q=tm.Q, R_list=R_list, kind_idx=kind_idx,
            structure=sparsity.structure_for(spec, tm.initial_x),
            eas=np.swapaxes(eas, 1, 2))
  args = (mode, spec, kinds, xs.T, P, np.swapaxes(zs, 1, 2),
          np.full(T, 0.05))
  call = generic_scan.KernelCall(spec, mode, kinds, Q=tm.Q, R_list=R_list,
                                 structure=kw["structure"])
  assert _tile_roles(call.source(torch.float64)) > 0
  tile = run_host(*args, **kw)
  monkeypatch.setattr(entry_slab, "TILE_SMEM_MAX", 0)
  generic_scan._source.cache_clear()
  src = call.source(torch.float64)
  assert "// design: global" in src and "gen_tile_" not in src
  glob = run_host(*args, **kw)
  for a, b in zip(tile, glob):
    np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12, atol=1e-14)
  assert torch.equal(tile[1], tile[1].transpose(0, 1))


@pytest.mark.parametrize("mode", ["frame", "mixed"])
def test_frame_tile_matches_its_global_form(mode, roomy, monkeypatch):
  """msckf_vo (msckf_eskf in tests/test_torch_msckf_frame_tile_eskf.py)."""
  check_tile_against_global(tvo.MSCKFVisualOdometry, mode, monkeypatch)


@pytest.mark.parametrize("tm", [tvo.MSCKFVisualOdometry, tes.MSCKFEskf],
                         ids=IDS)
def test_frame_design_lines(tm):
  """A float32 frame or VIO variant is a tile of TILE_ROLES_FRAME warps
  that names its bytes a block (32 filters x (DE^2 + DX + the frame's
  scratch) x 4 B); in double msckf_vo's still fits and msckf_eskf's
  (twice 221,824 B) is the global form, named."""
  spec = tm.build_spec()
  nscr = 2 * (spec.obs[KIND].dz - spec.obs[KIND].ea_dim) * spec.dim_err \
      + spec.dim_err
  for call in (_frame_call(tm, 1e-4 * np.eye(8)),
               _vio_call(tm, (np.eye(3), 1e-4 * np.eye(8)))):
    f32, f64 = call.source(), call.source(torch.float64)
    nbytes = 32 * 4 * (spec.dim_err ** 2 + spec.dim_x + nscr)
    head = f32.splitlines()[3]
    assert head.startswith(
        f"// design: tile, {entry_slab.TILE_ROLES_FRAME} roles")
    assert head.endswith(f"{nscr} scratch values a filter in shared "
                         f"memory ({nbytes:,} B a block)")
    assert _tile_roles(f32) == entry_slab.TILE_ROLES_FRAME
    if 2 * nbytes <= entry_slab.TILE_SMEM_MAX:
      assert f"({2 * nbytes:,} B a block)" in f64.splitlines()[3]
    else:
      assert f64.splitlines()[3] == (
          f"// design: global: the tile of 32 filters ({2 * nbytes:,} B "
          f"in double) exceeds the {entry_slab.TILE_SMEM_MAX:,} B a block "
          "may use, so one thread a filter and P in global memory")
      assert "gen_tile_" not in f64 and "GEN_INLINE void gen_step(" in f64
  assert (spec.name == "msckf_eskf") == (
      2 * 32 * 4 * (spec.dim_err ** 2 + spec.dim_x + nscr)
      > entry_slab.TILE_SMEM_MAX)
