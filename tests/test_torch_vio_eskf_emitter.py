"""Kernel 6's camera-frame branch on msckf_eskf (41 nominal / 36 error
states): the emitted mixed body with a frame unit, built with the host C++
compiler as double, against the JAX package's generic_bank_scan_mixed in
interpret mode at B = 8, T = 4, rtol 1e-9 (the msckf_vo case and the rest
are in tests/test_torch_vio_emitter.py)."""

from rednose_tpu.models import msckf_eskf as jes
from rednose_tpu_torch.models import msckf_eskf as tes
from test_torch_vio_emitter import _needs_compiler  # noqa: F401
from test_torch_vio_emitter import check_mixed_against_jax_kernel


def test_mixed_body_with_frame_unit_matches_jax_kernel_eskf():
  check_mixed_against_jax_kernel(jes.MSCKFEskf, tes.MSCKFEskf)
