"""Gradients through the port's plain filter, mirroring
tests/test_differentiable.py: torch autograd through core/step.predict /
update over T = 200 steps (the innovation NLL of the process noise) and
through runtime/bank.run_bank equal jax.grad of the JAX package's same
functions to rtol 1e-8, float64. The maximum-likelihood descent of the
JAX test (400 gradient evaluations at T = 800) is not mirrored: one such
gradient takes seconds in eager torch on one CPU thread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rednose_tpu.models.kinematic import KinematicKalman as JKinematic
from rednose_tpu.runtime import bank as jbank
from rednose_tpu_torch.core import step
from rednose_tpu_torch.models.kinematic import KinematicKalman, ObservationKind
from rednose_tpu_torch.runtime import bank
from test_differentiable import _nll as jax_nll, _sim
from torch_parity import np_, t64


def _nll(log_q, zs):
  """The innovation negative log-likelihood of the filter under process
  noise exp(log_q) (test_differentiable._nll)."""
  spec = KinematicKalman.build_spec()
  Q = torch.diag(torch.stack([t64(0.1**2), torch.exp(log_q)]))
  R = t64([[0.1**2]])
  x = t64(KinematicKalman.initial_x)
  P = t64(np.diag(KinematicKalman.initial_P_diag))
  nlls = []
  for z in zs:
    x, P = step.predict(spec, {}, x, P, Q, t64(0.01))
    S = P[0, 0] + R[0, 0]
    nlls.append(0.5 * (torch.log(S) + (z - x[0]) ** 2 / S))
    x, P, _ = step.update(spec, ObservationKind.POSITION, {}, x, P, z[None],
                          R, t64(np.zeros(1)))
  return torch.stack(nlls).mean()


@pytest.mark.parametrize("log_q", [-2.0, 0.0, 2.0])
def test_gradient_through_filter_equals_jax(log_q):
  _, zs = _sim(200)
  lq = t64(log_q).requires_grad_()
  loss = _nll(lq, t64(zs))
  loss.backward()
  g_ref = jax.grad(jax_nll)(jnp.asarray(log_q), jnp.asarray(zs))
  assert np.isfinite(float(lq.grad)) and abs(float(lq.grad)) > 0
  np.testing.assert_allclose(float(lq.grad), float(g_ref), rtol=1e-8)
  np.testing.assert_allclose(float(loss.detach()), float(jax_nll(log_q, zs)),
                             rtol=1e-10)


def test_gradient_through_bank_equals_jax():
  rng = np.random.default_rng(0)
  T, B = 32, 8
  zs = rng.normal(0, 0.3, (T, B, 1))
  P0 = np.diag(KinematicKalman.initial_P_diag)

  def loss(q_diag):
    state = bank.init_bank(KinematicKalman.build_spec(),
                           KinematicKalman.initial_x, P0, batch=B,
                           dtype=torch.float64, device="cpu")
    _, ys = bank.run_bank(KinematicKalman.build_spec(),
                          ObservationKind.POSITION, {}, state,
                          torch.diag(q_diag), t64(np.full(T, 0.01)), t64(zs),
                          t64(np.full((T, 1, 1), 0.01)))
    return torch.mean(ys ** 2)

  def jloss(q_diag):
    spec = JKinematic.build_spec()
    state = jbank.init_bank(spec, JKinematic.initial_x, P0, batch=B,
                            dtype=jnp.float64)
    Rs = jnp.broadcast_to(jnp.asarray(0.01).reshape(1, 1, 1, 1),
                          (T, B, 1, 1))
    _, ys = jbank.run_bank(spec, ObservationKind.POSITION, {}, state,
                           jnp.diag(q_diag), jnp.full((T,), 0.01),
                           jnp.asarray(zs), Rs)
    return jnp.mean(ys ** 2)

  q = t64([0.01, 4.0]).requires_grad_()
  loss(q).backward()
  g_ref = np.asarray(jax.grad(jloss)(jnp.asarray([0.01, 4.0])))
  assert q.grad.shape == (2,) and bool(torch.isfinite(q.grad).all())
  np.testing.assert_allclose(np_(q.grad), g_ref, rtol=1e-8)
