"""msckf_eskf's cases (a) and (b) of tests/test_torch_smooth_grad.py: its
clone slots pass through the smoother (d2 < de). Autograd through the
port's plain smoothers, and the card's route with every kernel of 11-14
and 11'-14' its host build, against jax.grad of the JAX package's
smoothers, float64, within GRAD_TOL of each gradient's largest entry. In
a file of its own, so that the tier-1 run's workers compile JAX's
parallel smoother's gradient for it and for live apart. This file
imports JAX only in a try (through tests/test_torch_smooth_grad.py)."""

import test_torch_smooth_grad as sg
from test_torch_smooth_grad import _jax_x64  # noqa: F401 (the fixture)


@sg.needs_jax
def test_plain_gradients_match_jax_msckf():
  """(a) on msckf_eskf (test_torch_smooth_grad.py's docstring)."""
  sg.test_plain_gradients_match_jax("msckf")


@sg.needs_jax
def test_adjoint_host_builds_match_jax_msckf(monkeypatch):
  """(b) on msckf_eskf (test_torch_smooth_grad.py's docstring)."""
  sg.test_adjoint_host_builds_match_jax("msckf", monkeypatch)
