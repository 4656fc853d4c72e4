"""Kernel 10 in tile form: the adjoint of the offline log scan (emitted mode
"stream_adjoint" as a tile, ops/adjoint.TilePlan around
csrc/stream_adjoint.cuh's REDNOSE_ADJOINT_TILE section; wrappers
ops/generic_scan.stream_bank_scan_adjoint and the autograd rule of
runtime/scan's custom op).

On the CPU the tile's emitted text is built with the host C++ compiler as
double (entry rn_generic_stream_adjoint_host: lane by lane, each phase's
stages, outputs and stores in barrier order) and held on the six logs of
tests/test_torch_scan_stream_grad.py (the gated one with rejected steps
among them) against jax.grad of the JAX package's scan_fn, autograd
through the port's plain loop and the variant's own global form (its
host build), within that file's ADJ_TOL of each gradient's largest
entry, with no gate flip. A live variant's tile does not fit a block in
double, so these tests raise the emitter's limit (TILE_SMEM_MAX): the
host build has no block. Every adjoint variant chip_smoke.adjoint_calls()
ships is a tile where adjoint_tile_bytes fits, else the global form
saying why; msckf_eskf's position kind, too large in float32, keeps the
global form.

Card-only cases (marked cuda) hold the float32 live tile against the
plain version (autograd through build_scan_stream_reference on the
card) and against its global form (raw launches on the same stacks and
cotangents) at B = 1, 37 and 64 and at T = 0 and 1, from the state
kernel 9 reaches in CARD_WARM steps in float64; this file imports JAX
only in a try (the card's machine has none): `python -m pytest
tests/test_torch_scan_stream_adjoint_tile.py -m cuda --noconftest`."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.func import vmap

import chip_smoke as cs
from rednose_tpu_torch import _build
from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
from rednose_tpu_torch.ops import entry_slab, generic_scan
from rednose_tpu_torch.runtime import scan
from test_torch_scan_stream_grad import (
    ADJ_TOL,
    FAMILIES,
    _adjoint_call,
    family,
    host_adjoint,
    kernel_grads,
    rel_errs,
    results,
)
from test_torch_scan_stream_kernel import live_log
from torch_parity import cuda_device  # noqa: F401

LIVE_KINDS = (K.ECEF_POS, K.NO_ROT)
# the card's float32 tile against the plain version and its global form,
# relative to each gradient's largest entry (chip_smoke.py's GRAD32_TOL)
GRAD32_TOL = 1e-4
CARD_WARM = 256   # steps of kernel 9 (float64) before the window


def _tile_source(call):
  """The call's float64 source in tile form, the emitter's limit on a
  block's shared memory lifted (the host build has no block)."""
  limit = entry_slab.TILE_SMEM_MAX
  try:
    entry_slab.TILE_SMEM_MAX = 1 << 40
    generic_scan._source.cache_clear()
    return call.source(torch.float64)
  finally:
    entry_slab.TILE_SMEM_MAX = limit
    generic_scan._source.cache_clear()


_SOURCES = {}


def sources(name):
  """(tile, global form) float64 sources of the family's adjoint call;
  every family's built at once, in parallel, at the first call."""
  if not _SOURCES:
    for n in FAMILIES:
      spec, _, kinds, Q, params, _ = family(n)
      call = _adjoint_call(spec, kinds, Q, params)
      _SOURCES[n] = (call, _tile_source(call),
                     call.source(torch.float64, tile=False))
    host_adjoint(_SOURCES[FAMILIES[0]][0])   # the families' own builds
    with ThreadPoolExecutor(2 * len(FAMILIES)) as pool:
      list(pool.map(lambda cs_: host_adjoint(*cs_),
                    [(c, s) for c, *srcs in _SOURCES.values()
                     for s in srcs]))
  return _SOURCES[name]


@pytest.mark.parametrize("name", FAMILIES)
def test_tile_host_build_matches_jax_plain_and_global(name):
  """The tile's host build on each log against jax.grad, the plain loop
  and the global form's host build, within ADJ_TOL of each gradient's
  largest entry (measured: at most 7e-14 against JAX and the plain loop,
  the dz3 / dz1 log; the tile and its global form part only where the
  predict's dt cotangent is summed in pieces); no gate flip in either
  form, the gated log's rejected steps followed."""
  _, tile, glob = sources(name)
  assert "\n// design: tile, " in tile
  assert "\n// design: global: one thread a lane" in glob
  plain, jx, _ = results(name)
  got, flips = kernel_grads(name, tile)
  ref, ref_flips = kernel_grads(name, glob)
  for other in (jx, plain, ref):
    errs = rel_errs(name, got, other)
    assert max(errs.values()) <= ADJ_TOL, errs
  assert flips == ref_flips == 0


def test_shipped_adjoint_variants_are_tiles_where_they_fit():
  """Every adjoint variant chip_smoke.adjoint_calls() ships is a tile of
  TILE_ROLES_ADJOINT warps where adjoint_tile_bytes (its scratch read
  from its plans) fits a block, and says its size; else the global form,
  naming the tile's size: the float32 live and gated live variants and
  the ML tuning's kinematic float64 one are tiles, the float64 live ones
  are not. Its global form (tile=False) is the design before.
  msckf_eskf's position kind (de 36) does not fit even in float32."""
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf

  w = entry_slab.TILE_ROLES_ADJOINT
  tiles = set()
  for name, (call, dtype) in cs.adjoint_calls().items():
    if call.mode != "stream_adjoint":
      continue
    src = call.source(dtype)
    scalar = "double" if dtype == torch.float64 else "float"
    nscr = int(src.split(" scratch values a lane")[0].rsplit(" ", 1)[-1]) \
        if "\n// design: tile" in src else None
    if nscr is not None:
      tiles.add(name)
      nzrows = max(call.spec.obs[k].dz for k in call.kinds)
      nearows = max(call.spec.obs[k].ea_len for k in call.kinds)
      nbytes = entry_slab.adjoint_tile_bytes(call.spec, nscr, nzrows,
                                             nearows, scalar)
      assert nbytes <= entry_slab.TILE_SMEM_MAX
      assert f"\n// design: tile, {w} roles, {len(call.kinds)} units " \
          "switched on the step's kind" in src
      assert f"({nbytes:,} B a block)" in src
      assert "#define REDNOSE_ADJOINT_TILE" in src
    else:
      assert "\n// design: global: the tile of 32 lanes (" in src
      assert f"B in {scalar}) exceeds the 232,448 B a block may use" in src
      assert "#define REDNOSE_ADJOINT_TILE" not in src
    glob = call.source(dtype, tile=False)
    assert "\n// design: global: one thread a lane" in glob
    assert "#define REDNOSE_ADJOINT_TILE" not in glob
  assert tiles == {"live log adjoint (kernel 10)",
                   "ML tuning log adjoint (kernel 10), float64",
                   "gated live log adjoint (kernel 10), float32"}
  big = generic_scan.KernelCall(MSCKFEskf.build_spec(), "stream_adjoint",
                                (12,), Q=MSCKFEskf.Q).source()
  assert "\n// design: global: the tile of 32 lanes (" in big
  assert "B in float) exceeds the 232,448 B a block may use, so one " \
      "thread a lane, the cotangent of P in global memory" in big


# ------------------------------------------------------------- on the card

def _card_case(dev, B, T):
  """The live log for B lanes on the card, float32, from the state kernel
  9 reaches in CARD_WARM steps (float64), T steps: scan_fn's inputs
  (x0, P0, Q, dts, kind_idx, zs, Rs, eas) and a seeded weighting of its
  six outputs."""
  x0, P0, dts, ki, zs, Rs, eas = live_log(LIVE_KINDS, CARD_WARM + T, B,
                                          seed=17)
  spec = LiveKalman.build_spec()
  fn, _ = scan.build_scan_stream(spec, LIVE_KINDS)
  f = dict(dtype=torch.float64, device=dev)
  t = lambda a: torch.as_tensor(a, **f)  # noqa: E731
  w = slice(None, CARD_WARM)
  with torch.no_grad():
    (xw, Pw), _ = vmap(lambda xl, Pl, zl: fn(
        {}, xl, Pl, t(LiveKalman.Q), t(dts[w]), ki[w], zl, t(Rs[w]),
        t(eas[w])), in_dims=(0, 0, 1))(t(x0), t(P0), t(zs[w]))
  c = lambda a: torch.as_tensor(a, device=dev).float()  # noqa: E731
  rest = slice(CARD_WARM, None)
  rng = np.random.RandomState(18)
  dx, de = spec.dim_x, spec.dim_err
  W = [c(rng.randn(*s)) for s in ((B, dx), (B, de, de), (B, T, dx),
                                  (B, T, de, de), (B, T, dx),
                                  (B, T, de, de))]
  return (c(xw), c(Pw), c(LiveKalman.Q), c(dts[rest]), ki[rest],
          c(zs[rest]), c(Rs[rest]), c(eas[rest])), W


def _grads(fn, case, W):
  """Autograd through fn vmapped over the bank, the loss W's weighting of
  the six outputs: the gradients of x0, P0, Q, dts, zs and Rs."""
  x0, P0, Q, dts, ki, zs, Rs, eas = case
  ins = [a.clone().requires_grad_() for a in (x0, P0, Q, dts, zs, Rs)]
  X0, PP0, QQ, DT, ZS, RR = ins
  (x, P), st = vmap(lambda xl, Pl, zl: fn({}, xl, Pl, QQ, DT, ki, zl, RR,
                                          eas), in_dims=(0, 0, 1))(X0, PP0,
                                                                    ZS)
  loss = sum((o * w).sum() for o, w in zip((x, P, *st), W))
  g = torch.autograd.grad(loss, ins, allow_unused=True)
  return [(torch.zeros_like(a) if d is None else d).double().cpu()
          for d, a in zip(g, ins)]


def _rel(a, b):
  """The largest difference over b's largest entry (0 for empty ones)."""
  if not b.numel():
    return 0.0
  scale = float(b.abs().max())
  return float((a - b).abs().max()) / scale if scale else float(
      a.abs().max())


def _check(dev, B, T):
  """The tile through scan_fn (one launch of kernel 10, design 1 at
  TILE_ROLES_ADJOINT warps) against the plain version, and the tile's
  raw launch against its global form's on kernel 9's stacks with W as
  the cotangents, each within GRAD32_TOL."""
  case, W = _card_case(dev, B, T)
  spec = LiveKalman.build_spec()
  fn, _ = scan.build_scan_stream(spec, LIVE_KINDS)
  plain, _ = scan.build_scan_stream_reference(spec, LIVE_KINDS)
  n = generic_scan.stream_bank_scan_adjoint.launches
  got = _grads(fn, case, W)
  torch.cuda.synchronize()
  assert generic_scan.stream_bank_scan_adjoint.launches == n + 1
  assert int(generic_scan.stream_bank_scan_adjoint.gate_flips.sum()) == 0
  ref = _grads(plain, case, W)
  for i, (a, b) in enumerate(zip(got, ref)):
    if i in (1, 2, 5):                  # P0, Q, Rs: symmetric parts
      a, b = a + a.transpose(-1, -2), b + b.transpose(-1, -2)
    assert a.shape == b.shape
    assert _rel(a, b) <= GRAD32_TOL, i
  call = cs.adjoint_calls()["live log adjoint (kernel 10)"][0]
  info = _build.generated_info(call.source(torch.float32))
  assert info["design"] == 1
  assert info["warps"] == entry_slab.TILE_ROLES_ADJOINT
  x0, P0, Q, dts, ki, zs, Rs, _ = case
  x0b, P0b = x0.T.contiguous(), P0.permute(1, 2, 0).contiguous()
  zsb = zs.transpose(1, 2).contiguous()
  fwd = cs.stream_calls()["live log scan (kernel 9)"][0]
  de, dx = spec.dim_err, spec.dim_x
  stacks = (cs.stream_launch(fwd.source(torch.float32), fwd, x0b, P0b, zsb,
                             dts, ki, Rs)()[2:] if T else
            [x0b.new_empty(s) for s in ((0, dx, B), (0, de, de, B)) * 2])
  cots = [w.permute(*range(1, w.dim()), 0).contiguous() for w in W]
  outs = [[o.double().cpu() for o in cs.adjoint_launch(
      src, call, x0b, P0b, zsb, dts, ki, Rs, stacks, cots)()[:6]]
          for src in (call.source(torch.float32),
                      call.source(torch.float32, tile=False))]
  for a, b in zip(*outs):
    assert _rel(a, b) <= GRAD32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 64])
def test_tile_matches_plain_and_global_on_the_card(cuda_device, B):
  """The float32 live tile at B lanes over 32 steps (B = 1: every copy a
  value a thread; 37: a ragged second block) against the plain version
  and against its global form, within GRAD32_TOL."""
  _check(cuda_device, B, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [0, 1])
def test_tile_short_logs_on_the_card(cuda_device, T):
  """A log of T = 0 steps (the final state's cotangents straight through)
  and of T = 1 step, B = 37: the tile against the plain version and its
  global form, within GRAD32_TOL."""
  _check(cuda_device, 37, T)
