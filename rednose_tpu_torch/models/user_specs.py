"""User-written filter specs for the port's any-spec kernels (4-7), in
torch and numpy only: what chip_smoke.py's user-spec path drives on the
card, what tests/test_torch_random_specs.py holds on the CPU and what
tools/flops_report counts.

- `random_spec(seed, dim, dz)`: the JAX package's random-spec family
  (tests/test_random_specs.py), f = x + dt (A tanh(x) + b) with a random
  sparse A, h = C x + sin(x0), drawn from the same numpy seed in the
  same order, so the JAX twin of a seed is the same filter.
- `op_spec(name)`: a 4-state spec whose f and h apply one op of `OPS`,
  the ops the emitter (ops/structural.py) takes beyond the shipped
  models' (tanh, sigmoid, softplus, abs, norm, cross, remainder, fmod,
  hypot, cumsum, flip, roll, mean).
- `battery_spec()`: an 8-state vehicle whose f uses tanh, sigmoid,
  softplus, abs, cumsum, flip, roll, mean and remainder (a heading wrap),
  with three kinds: RANGE (the norm to a per-lane anchor, the extra args,
  ea_len 3, gated), BEARING (atan2 and hypot, wrapped with fmod) and
  CROSS (linalg.cross).
- `simulate` and `measure`: a truth of any spec and its measurements,
  for consistent data.

    from rednose_tpu_torch.models import user_specs
    bank = KalmanBank(spec=user_specs.battery_spec(),
                      x0=user_specs.BATTERY_X0,
                      P_diag=user_specs.BATTERY_P_DIAG, Q=user_specs.BATTERY_Q,
                      obs_noise=user_specs.BATTERY_R, batch=8192)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel


def _const(a, x):
  return torch.as_tensor(a, dtype=x.dtype, device=x.device)


def random_spec(seed: int, dim: int, dz: int):
  """(spec, rng): tests/test_random_specs.py's _random_spec in torch; rng
  is the numpy generator after the spec's draws, as the JAX test goes on
  drawing its data from it."""
  rng = np.random.RandomState(seed)
  mask = rng.rand(dim, dim) < 0.4
  np.fill_diagonal(mask, rng.rand(dim) < 0.5)
  A = np.where(mask, 0.3 * rng.randn(dim, dim), 0.0)
  b = 0.1 * rng.randn(dim)
  C = rng.randn(dz, dim)

  def f(params, x, dt):
    del params
    return x + dt * (_const(A, x) @ torch.tanh(x) + _const(b, x))

  def h(params, x, ea):
    del params, ea
    return _const(C, x) @ x + torch.sin(x[0])

  obs = {1: ObservationModel(kind=1, h=h, dz=dz, maha_test=bool(seed % 2))}
  return FilterSpec(name=f"rand{seed}", dim_x=dim, dim_err=dim, f=f,
                    obs=obs), rng


# each op on a 4-vector, giving a 4-vector
OPS = {
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": torch.nn.functional.softplus,
    "abs": torch.abs,
    "norm": lambda x: torch.linalg.norm(x[:3]) * torch.ones_like(x),
    "cross": lambda x: torch.cat([torch.linalg.cross(x[:3], x[1:]), x[3:]]),
    "remainder": lambda x: torch.remainder(x, 2.0 * math.pi),
    "fmod": lambda x: torch.fmod(x, 2.0),
    "hypot": lambda x: torch.hypot(x, torch.flip(x, (0,))),
    "cumsum": lambda x: torch.cumsum(x, 0),
    "flip": lambda x: torch.flip(x, (0,)),
    "roll": lambda x: torch.roll(x, 1),
    "mean": lambda x: torch.mean(x) * torch.ones_like(x),
}
OP_X0 = np.array([0.3, -0.7, 1.1, 0.5])


def op_spec(name: str, in_h: bool = True) -> FilterSpec:
  """4 states, f = x + dt op(x), one kind (1, dz 2): h = x[:2] +
  0.1 op(x)[:2], so the op is in the predict's and the update's
  Jacobian (in_h=False: h = x[:2])."""
  op = OPS[name]

  def f(params, x, dt):
    del params
    return x + dt * op(x)

  def h(params, x, ea):
    del params, ea
    return x[:2] + 0.1 * op(x)[:2] if in_h else x[:2]

  return FilterSpec(name=f"op_{name}", dim_x=4, dim_err=4, f=f,
                    obs={1: ObservationModel(kind=1, h=h, dz=2)})


# ------------------------------------------------------------ the battery

RANGE, BEARING, CROSS = 1, 2, 3
BATTERY_KINDS = (RANGE, BEARING, CROSS)
# an epoch's slots (run_epochs): 4 ranges, each to its own anchor
BATTERY_SLOTS = (RANGE,) * 4 + (BEARING, CROSS)
# x: position (3), heading psi in [0, 2 pi), speed v, three latent
# rates w. The vehicle starts 65 m from the origin heading north (psi
# ~ pi / 2, a quarter turn from the wrap) at 1 m/s, so float32 resolves
# its sigmas: at 200 m with a range sigma of 0.5 m, the heading stored
# about pi, a float32 bank parted from a float64 one by ~3e-3 sigma in
# 64 steps.
BATTERY_X0 = np.array([-25.0, 60.0, 2.0, math.pi / 2, 1.0, 0.0, 0.0, 0.0])
BATTERY_P_DIAG = np.array([4.0, 4.0, 4.0, 0.01, 1.0, 0.01, 0.01, 0.01])
BATTERY_Q = np.diag([1e-3, 1e-3, 1e-3, 1e-4, 1e-2, 1e-4, 1e-4, 1e-4])
BATTERY_R = {RANGE: np.array([[1.0]]),
             BEARING: np.diag([1e-4, 1.0]),
             CROSS: np.diag([1.0, 1.0, 1.0])}


def _heading(x):
  # tanh / 10, not 0.1 * tanh: torch's forward AD of a 0-d tensor times a
  # float, stacked into linalg.cross, fails in float32 (torch 2.13)
  psi = x[3]
  return torch.stack([torch.cos(psi), torch.sin(psi), torch.tanh(x[5]) / 10])


def battery_f(params, x, dt):
  del params
  p, psi, v, w = x[0:3], x[3], x[4], x[5:8]
  p = p + dt * v * _heading(x)
  psi = torch.remainder(psi + dt * w[1], 2.0 * math.pi)
  drag = 0.05 * torch.abs(v) * torch.sigmoid(w[2])
  v = v + dt * (torch.nn.functional.softplus(w[0]) - math.log(2.0) - drag)
  dw = (-0.7 * w + 0.5 * torch.mean(w) + 0.05 * torch.flip(w, (0,))
        + 0.02 * torch.cumsum(torch.roll(w, 1), 0))
  return torch.cat([p, psi[None], v[None], w + dt * dw])


def _range(params, x, ea):
  del params
  return torch.linalg.norm(x[0:3] - ea)[None]


def _bearing(params, x, ea):
  del params, ea
  rel = torch.atan2(x[1], x[0]) - x[3]
  return torch.stack([torch.fmod(rel, 2.0 * math.pi),
                      torch.hypot(x[0], x[1])])


def _cross(params, x, ea):
  del params, ea
  return torch.linalg.cross(0.1 * x[0:3], _heading(x))


def battery_spec() -> FilterSpec:
  return FilterSpec(
      name="battery", dim_x=8, dim_err=8, f=battery_f,
      obs={RANGE: ObservationModel(kind=RANGE, h=_range, dz=1, ea_dim=0,
                                   ea_len=3, maha_test=True),
           BEARING: ObservationModel(kind=BEARING, h=_bearing, dz=2),
           CROSS: ObservationModel(kind=CROSS, h=_cross, dz=3)})


def simulate(spec: FilterSpec, x0, Q, T, dt, rng, device="cpu",
             dtype=torch.float64):
  """(T + 1, B, dim_x) states from x0 (B, dim_x) over T steps of spec.f,
  each state driven by white noise of variance Q's diagonal times dt (an
  error-state spec's dim_x = dim_err)."""
  x = torch.as_tensor(x0, dtype=dtype, device=device)
  step = torch.func.vmap(lambda xi: spec.f({}, xi, dt))
  sd = torch.as_tensor(np.sqrt(np.diag(Q) * dt), dtype=dtype, device=device)
  out = [x]
  for _ in range(T):
    noise = torch.as_tensor(rng.randn(*x.shape), dtype=dtype, device=device)
    x = step(x) + sd * noise
    out.append(x)
  return torch.stack(out)


def measure(spec: FilterSpec, kind, xs, R, rng, eas=None):
  """Measurements of `kind` of the states xs (..., dim_x) with noise of
  R's diagonal, eas (..., ea_len) for an extra-args kind: (..., dz)."""
  om = spec.obs[kind]
  flat = xs.reshape(-1, xs.shape[-1])
  ea = (torch.zeros_like(flat[:, :1]) if eas is None
        else eas.reshape(flat.shape[0], -1).to(flat))
  z = torch.func.vmap(lambda xi, ei: om.h({}, xi, ei))(flat, ea)
  sd = np.sqrt(np.diag(np.asarray(R, dtype=np.float64)))
  noise = torch.as_tensor(rng.randn(*z.shape) * sd, dtype=z.dtype,
                          device=z.device)
  return (z + noise).reshape(*xs.shape[:-1], om.dz)


def random_setup(seed: int, dim: int, dz: int):
  """(spec, x0, P_diag, Q, R) of a random spec: x0, Q and R drawn after
  the spec, as tests/test_random_specs.py draws them."""
  spec, rng = random_spec(seed, dim, dz)
  x0 = rng.randn(dim)
  Q = np.diag(0.01 + 0.1 * rng.rand(dim))
  R = np.diag(0.5 + rng.rand(dz))
  return spec, x0, np.ones(dim), Q, R
