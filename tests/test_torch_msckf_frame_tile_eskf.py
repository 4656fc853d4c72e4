"""The camera frame in tile form on msckf_eskf (41 nominal / 36 error
states), built with the host C++ compiler as double: kernel 7's tile
against the JAX package's vo_bank_scan in interpret mode at rtol 1e-9,
and kernel 7's and kernel 6's VIO tiles against their own global form at
rtol 1e-12 (the msckf_vo cases, kernel 6's VIO tiles against JAX and the
design lines are in tests/test_torch_msckf_frame_tile.py; a file of its
own so that the long builds run on another test worker)."""

import pytest

from rednose_tpu.models import msckf_eskf as jes
from rednose_tpu_torch.models import msckf_eskf as tes
from test_torch_msckf_frame_tile import _needs_compiler  # noqa: F401
from test_torch_msckf_frame_tile import roomy  # noqa: F401
from test_torch_msckf_frame_tile import (
    check_frame_tile_against_jax,
    check_tile_against_global,
)


def test_frame_tile_matches_jax_vo_kernel_eskf(roomy):  # noqa: F811
  check_frame_tile_against_jax(jes.MSCKFEskf, tes.MSCKFEskf)


@pytest.mark.parametrize("mode", ["frame", "mixed"])
def test_frame_tile_matches_its_global_form_eskf(mode, roomy,  # noqa: F811
                                                 monkeypatch):
  check_tile_against_global(tes.MSCKFEskf, mode, monkeypatch)
