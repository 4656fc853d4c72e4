"""Kernel 9 in tile form: the offline log scan (emitted mode "stream" as a
tile, csrc/generic_scan.cuh's REDNOSE_GENERIC_SCAN_STREAM tile section;
wrappers ops/generic_scan.stream_bank_scan and runtime/scan's scan_fn).

On the CPU the tile's emitted text is built with the host C++ compiler as
double (entry rn_generic_stream_host: lane by lane, each phase's roles in
barrier order, the stacks stored after the predict and after the update)
and held, float64, against the JAX package's build_scan_stream, the
port's plain scan_fn and the variant's own global form (its host build,
tests/test_torch_scan_stream_kernel.py): the live log's two kinds
(ECEF_POS and NO_ROT) and the refinement log's three (ECEF_POS,
PHONE_GYRO and NO_ROT), each from the state the plain version reaches in
WARM steps of it (within TOL) and from the live prior (within PRIOR_TOL:
there the emitted factored covariance algebra and the plain scan's dense
Joseph form part by ~1e-8 sigma), and the kinematic spec's one-kind log
from its prior (within TOL). Every predicted and posterior stack entry
and the final state are compared, in standard deviations of the plain
result (utils/compare.py). Every variant that chip_smoke.stream_calls()
ships prints the tile form; msckf_eskf's position kind in double, whose
tile does not fit in a block, prints the global form and says why.

Card-only cases (marked cuda) hold the tile, launched through scan_fn,
against the plain version and against its global form, float64 from the
live prior, at B = 1, 37 and 64 and at T = 0 and 1; this file imports JAX
only in a try (the card's machine has none): `python -m pytest
tests/test_torch_scan_stream_tile.py -m cuda --noconftest`."""

import numpy as np
import pytest
import torch
from torch.func import vmap

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax  # noqa: F401
  from rednose_tpu.models.kinematic import KinematicKalman as JKinematic
  from rednose_tpu.models.live import LiveKalman as JLive
except ImportError:
  JKinematic = JLive = None
import chip_smoke as cs
from rednose_tpu_torch import _build
from rednose_tpu_torch.models.kinematic import (
    KinematicKalman,
    ObservationKind as KK,
)
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.ops import entry_slab, generic_scan
from rednose_tpu_torch.runtime import scan
from test_torch_scan_stream_kernel import (
    PRIOR_TOL,
    TOL,
    WARM,
    live_log,
    run_host,
    run_jax,
    run_plain,
    sigma_err,
)
from torch_parity import cuda_device  # noqa: F401

LIVE_KINDS = (K.ECEF_POS, K.NO_ROT)                   # the live log's
REFINE_KINDS = (K.ECEF_POS, K.PHONE_GYRO, K.NO_ROT)   # the refinement log's
CARD_TOL = 1e-6   # the smoke's SCAN64_TOL: the card contracts into FMAs


def refine_log(T, B, seed):
  """chip_smoke.refine_log's cold log for B lanes from the live prior:
  ECEF_POS (the start position plus noise of 1 m, R = 25 I), PHONE_GYRO
  (a time-varying angular-rate command plus noise of 0.01, R = 0.025^2 I)
  and NO_ROT (z = 0, R = 0.25^2 I) in turn, dt 0.01; each R padded as
  pad_log pads it. Returns (x0, P0, dts, ki, zs (T, B, 3), Rs, eas)."""
  rng = np.random.RandomState(seed)
  x0 = np.tile(LiveKalman.initial_x, (B, 1))
  P0 = np.tile(np.diag(LiveKalman.initial_P_diag), (B, 1, 1))
  ki = (np.arange(T) % 3).astype(np.int32)
  ts = (1 + np.arange(T)) * 0.01
  omega = np.stack([0.4 * np.sin(0.5 * ts), 0.3 * np.cos(0.8 * ts),
                    0.2 * np.ones(T)], axis=1)
  zs = np.zeros((T, B, 3))
  zs[ki == 0] = LiveKalman.initial_x[:3] + rng.randn(int((ki == 0).sum()),
                                                     B, 3)
  zs[ki == 1] = omega[ki == 1][:, None] + 0.01 * rng.randn(
      int((ki == 1).sum()), B, 3)
  Rs = np.stack([v * np.eye(3) for v in (25.0, 0.025**2, 0.25**2)])[ki]
  return x0, P0, np.full(T, 0.01), ki, zs, Rs, np.zeros((T, 1))


def _warm(spec, kinds, log):
  """The log after WARM steps of the plain version from its prior: the
  state it reached and the rest of the log."""
  x0, P0, dts, ki, zs, Rs, eas = log
  plain, _ = scan.build_scan_stream_reference(spec, kinds)
  w = run_plain(plain, LiveKalman.Q, x0, P0, dts[:WARM], ki[:WARM],
                zs[:WARM], Rs[:WARM], eas[:WARM])
  return (w[0].T.numpy(), w[1].permute(2, 0, 1).numpy(), dts[WARM:],
          ki[WARM:], zs[WARM:], Rs[WARM:], eas[WARM:])


def _four_ways(spec, jspec, kinds, Q, x0, P0, dts, ki, zs, Rs, eas):
  """The tile's host build, its global form's, the plain scan_fn's and
  JAX's results on one log."""
  tile = run_host(spec, kinds, Q, x0, P0, dts, ki, zs, Rs, tile=True)
  glob = run_host(spec, kinds, Q, x0, P0, dts, ki, zs, Rs)
  fn, _ = scan.build_scan_stream(spec, kinds)
  plain = run_plain(fn, Q, x0, P0, dts, ki, zs, Rs, eas)
  return tile, glob, plain, run_jax(jspec, kinds, Q, x0, P0, dts, ki, zs,
                                    Rs, eas)


@pytest.mark.parametrize("log,start", [("live", "warm"), ("live", "prior"),
                                       ("refine", "warm"),
                                       ("refine", "prior")])
def test_tile_host_build_matches_jax_plain_and_global_live(log, start):
  """The live spec's log-scan tile in float64 over 24 steps (after WARM
  steps of the plain version, or from the prior) against JAX's scan, the
  plain scan_fn and its own global form, every stacked state: within TOL
  from the warm state, within PRIOR_TOL from the prior (measured: the
  tile and its global form agree to 1e-18 sigma or closer on every log;
  against the plain version and JAX, from the warm state 1.1e-13 /
  2.1e-15 and from the prior 3.1e-9 / 2.6e-10 sigma on the live /
  refinement log)."""
  kinds = LIVE_KINDS if log == "live" else REFINE_KINDS
  make = live_log if log == "live" else refine_log
  spec, jspec = LiveKalman.build_spec(), JLive.build_spec()
  data = make(kinds, WARM + 24, 8, seed=3) if log == "live" else make(
      WARM + 24, 8, seed=3)
  data = _warm(spec, kinds, data) if start == "warm" else tuple(
      a[:24] if i >= 2 else a for i, a in enumerate(data))
  tile, glob, plain, jx = _four_ways(spec, jspec, kinds, LiveKalman.Q, *data)
  tol = TOL if start == "warm" else PRIOR_TOL
  assert sigma_err(spec, tile, plain) <= tol
  assert sigma_err(spec, tile, jx) <= tol
  assert sigma_err(spec, tile, glob) <= TOL


def test_tile_host_build_matches_jax_plain_and_global_kinematic():
  """The kinematic spec's one-kind log (POSITION, dz 1) from its prior,
  float64, within TOL of JAX, the plain scan_fn and the global form."""
  spec, jspec = KinematicKalman.build_spec(), JKinematic.build_spec()
  kinds, T, B = (KK.POSITION,), 32, 6
  rng = np.random.RandomState(4)
  x0 = np.tile(KinematicKalman.initial_x, (B, 1))
  P0 = np.tile(np.diag(KinematicKalman.initial_P_diag), (B, 1, 1))
  zs = 0.3 * rng.randn(T, B, 1)
  Rs = np.tile(KinematicKalman.obs_noise[KK.POSITION], (T, 1, 1))
  tile, glob, plain, jx = _four_ways(
      spec, jspec, kinds, KinematicKalman.Q, x0, P0,
      0.005 + 0.01 * rng.rand(T), np.zeros(T, np.int32), zs, Rs,
      np.zeros((T, 1)))
  for ref in (plain, jx, glob):
    assert sigma_err(spec, tile, ref) <= TOL


def test_shipped_stream_variants_are_tiles_and_a_large_one_is_not():
  """Every variant chip_smoke.stream_calls() ships is a tile of
  TILE_ROLES_STREAM warps in float32 and in float64; its global form
  (tile=False) is the design before; msckf_eskf's position kind (de 36)
  in double does not fit a block and keeps the global form, saying why."""
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf

  w = entry_slab.TILE_ROLES_STREAM
  for name, (call, _) in cs.stream_calls().items():
    for dtype in (torch.float32, torch.float64):
      src = call.source(dtype)
      assert f"\n// design: tile, {w} roles, {len(call.kinds)} units " \
          "switched on the step's kind, each step's inputs staged" in src
      assert "#define REDNOSE_GENERIC_SCAN_STREAM" in src
      assert "#define REDNOSE_GENERIC_SCAN_TILE" in src
    glob = call.source(tile=False)
    assert "\n// design: global: one thread a lane" in glob
    assert "#define REDNOSE_GENERIC_SCAN_TILE" not in glob
  big = generic_scan.KernelCall(MSCKFEskf.build_spec(), "stream", (12,),
                                Q=MSCKFEskf.Q).source(torch.float64)
  assert "\n// design: global: the tile of 32 filters (" in big
  assert "B in double) exceeds the 232,448 B a block may use, so one " \
      "thread a lane, P in global memory" in big
  assert "#define REDNOSE_GENERIC_SCAN_TILE" not in big


# ------------------------------------------------------------- on the card

def _card_case(device, B, T):
  """The live log of LIVE_KINDS for B lanes from the prior, float64 on the
  card: the tile through scan_fn (vmapped: one launch, or none at T = 0),
  the plain version and the global form, each in the bank-minor layout."""
  spec = LiveKalman.build_spec()
  x0, P0, dts, ki, zs, Rs, eas = (
      torch.as_tensor(a, device=device) if a.dtype != np.int32 else a
      for a in live_log(LIVE_KINDS, T, B, seed=7))
  fn, _ = scan.build_scan_stream(spec, LIVE_KINDS)
  plain, _ = scan.build_scan_stream_reference(spec, LIVE_KINDS)
  Q = torch.as_tensor(LiveKalman.Q, device=device)
  n = generic_scan.stream_bank_scan.launches

  def lanes(f):
    (x, P), (xp, Pp, xq, Pq) = vmap(
        lambda xl, Pl, zl: f({}, xl, Pl, Q, dts, ki, zl, Rs, eas),
        in_dims=(0, 0, 1))(x0, P0, zs)
    return tuple(a.cpu() for a in (
        x.T, P.permute(1, 2, 0), xp.permute(1, 2, 0),
        Pp.permute(1, 2, 3, 0), xq.permute(1, 2, 0), Pq.permute(1, 2, 3, 0)))

  tile = lanes(fn)
  torch.cuda.synchronize()
  launched = generic_scan.stream_bank_scan.launches - n
  ref = lanes(plain)
  call = generic_scan.KernelCall(spec, "stream", LIVE_KINDS, Q=LiveKalman.Q)
  glob = tuple(a.cpu() for a in cs.stream_launch(
      call.source(torch.float64, tile=False), call, x0.T.contiguous(),
      P0.permute(1, 2, 0).contiguous(), zs.transpose(1, 2).contiguous(),
      dts, ki, Rs)())
  info = _build.generated_info(call.source(torch.float64))
  return spec, tile, ref, glob, launched, info


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 64])
def test_tile_matches_plain_and_global_on_the_card(cuda_device, B):
  """scan_fn vmapped over B live logs on the card (one launch of the tile,
  design 1, at TILE_ROLES_STREAM warps), float64 from the prior over 32
  steps: every stacked state within CARD_TOL sigma of the plain version's
  and of the global form's; B = 37 leaves a ragged second block."""
  spec, tile, ref, glob, launched, info = _card_case(cuda_device, B, 32)
  assert launched == 1
  assert info["design"] == 1
  assert info["warps"] == entry_slab.TILE_ROLES_STREAM
  assert sigma_err(spec, tile, ref) <= CARD_TOL
  assert sigma_err(spec, tile, glob) <= CARD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("T", [0, 1])
def test_tile_short_logs_on_the_card(cuda_device, T):
  """A log of T = 0 steps launches nothing and returns the state as it was
  with empty stacks; of T = 1 one launch, within CARD_TOL sigma of the
  plain version and the global form (B = 37)."""
  spec, tile, ref, glob, launched, _ = _card_case(cuda_device, 37, T)
  assert launched == T
  for a, b in zip(tile, ref):
    assert a.shape == b.shape
  if T == 0:
    assert all(torch.equal(a, b) for a, b in zip(tile[:2], glob[:2]))
  else:
    assert sigma_err(spec, tile, ref) <= CARD_TOL
    assert sigma_err(spec, tile, glob) <= CARD_TOL
