"""The port's examples: the JAX package's examples/ scripts, on the card.

    python -m rednose_tpu_torch.examples.run_live               # CUDA
    python -m rednose_tpu_torch.examples.run_live --device cpu  # the host

Each module keeps its JAX script's seed, sizes and printed line, and its
`main(device="cuda")` returns a dict of the numbers it prints. The seven
single-filter examples (run_kinematic, run_live, run_car, run_loc's
engine half, run_compat_migration, run_msckf, run_vo_pipeline) run plain
torch, as the JAX package runs them in plain jnp. The bank examples run
the kernels a user's bank takes on the card (run_mixed_bank kernel 3,
run_loc's bank_demo kernel 6, run_msckf_bank kernels 6 and 7; run_bank
runtime/bank.run_bank, kernel 15, sharded over the mesh,
parallel/sharding) and print, where the JAX script prints `pallas=...`, the kernels they
launched. Nothing falls back: on CUDA a kernel that does not build or
launch raises.
"""

from __future__ import annotations

import argparse


def kernel_wrappers():
  """Every kernel wrapper of the port (each counts its launches)."""
  from rednose_tpu_torch.msckf import triangulation
  from rednose_tpu_torch.ops import (
      generic_scan,
      kinematic_scan,
      live_scan,
      smooth_scan,
  )

  return (kinematic_scan.kinematic_bank_scan, live_scan.live_bank_scan,
          live_scan.live_bank_scan_mixed, generic_scan.generic_bank_scan,
          generic_scan.generic_bank_scan_epoch,
          generic_scan.generic_bank_scan_mixed, generic_scan.vo_bank_scan,
          triangulation.compute_pos_batch, generic_scan.stream_bank_scan,
          generic_scan.stream_bank_scan_adjoint, smooth_scan.smooth_gains,
          smooth_scan.smooth_backward, smooth_scan.affine_suffix_scan,
          smooth_scan.smooth_inject, generic_scan.bank_run_scan,
          generic_scan.stream_bank_scan_lanes,
          generic_scan.stream_bank_scan_adjoint_lanes)


def launch_counts() -> dict:
  return {w.__name__: w.launches for w in kernel_wrappers()}


def launched_since(before: dict) -> dict:
  """The kernels launched since `before` (a launch_counts()), by name."""
  return {name: n - before[name] for name, n in launch_counts().items()
          if n != before[name]}


def route_text(launched: dict) -> str:
  """The route a bank example printed in place of the JAX `pallas=...`."""
  if not launched:
    return "route: plain torch, no kernel"
  return "route: " + ", ".join(f"{name} x{n}"
                               for name, n in launched.items())


def cli(main, doc: str | None = None):
  """Run main(device=...) with the examples' one option, --device."""
  ap = argparse.ArgumentParser(description=doc)
  ap.add_argument("--device", default="cuda",
                  help="cuda (default; raises without a card) or cpu")
  main(device=ap.parse_args().device)
