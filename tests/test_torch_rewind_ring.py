"""The port's rewind rings (rednose_tpu_torch/runtime/rewind.py), mirroring
tests/test_rewind_ring.py: the API tests on both the native ring
(csrc/rewind_ring.cc, built by the host C++ compiler at first use) and
the Python ring, which is its oracle; the native ring against the Python
one and against the JAX package's native ring on the same random
sequence of checkpoints and rewinds (exact: both hold the objects they
were given); the engine's rewind and replay through the native ring; the
bank ring's byte budget."""

import numpy as np
import pytest

from rednose_tpu.runtime import rewind as jrw
from rednose_tpu_torch.runtime import rewind as rw

IMPLS = ("python", "native")


@pytest.fixture(params=IMPLS)
def impl(request):
  return rw.PyRewindRing if request.param == "python" else rw.NativeRewindRing


def test_native_is_the_ring():
  assert rw.HAVE_NATIVE
  assert rw.RewindRing is rw.NativeRewindRing
  assert rw.NativeRewindRing is not rw.PyRewindRing


def test_basic_checkpoint_rewind(impl):
  ring = impl(8)
  for i in range(5):
    ring.checkpoint(float(i), f's{i}', f'o{i}')
  assert len(ring) == 5
  assert ring.first_t() == 0.0 and ring.last_t() == 4.0

  t0, state, replay = ring.rewind(2.5)
  assert t0 == 2.0 and state == 's2'
  assert replay == ['o3', 'o4']
  assert len(ring) == 3 and ring.last_t() == 2.0


def test_capacity_eviction(impl):
  ring = impl(4)
  for i in range(10):
    ring.checkpoint(float(i), i, i)
  assert len(ring) == 4
  assert ring.first_t() == 6.0 and ring.last_t() == 9.0


def test_can_rewind(impl):
  ring = impl(16)
  assert not ring.can_rewind(1.0, 1.0)
  for i in range(5):
    ring.checkpoint(float(i), i, i)
  assert ring.can_rewind(3.5, 1.0)
  assert not ring.can_rewind(-0.5, 100.0)  # older than the ring
  assert not ring.can_rewind(2.0, 1.0)     # beyond max_rewind_age
  assert ring.can_rewind(3.0, 1.0)


def test_errors(impl):
  ring = impl(4)
  ring.checkpoint(1.0, 'a', 'b')
  with pytest.raises(ValueError):
    ring.checkpoint(0.5, 'a', 'b')  # time must be non-decreasing
  with pytest.raises(ValueError):
    ring.rewind(0.5)  # older than the ring
  with pytest.raises(ValueError):
    impl(0)           # capacity must be positive


def _random_ops(seed, rings):
  """The same random sequence of checkpoints and rewinds on every ring;
  after each op every ring's length, oldest and newest time must agree
  with the first's, and each rewind's return too."""
  rng = np.random.default_rng(seed)
  ref = rings[0]
  t = 0.0
  for step in range(500):
    if rng.random() < 0.8 or len(ref) == 0:
      t += float(rng.random())
      for ring in rings:
        ring.checkpoint(t, ('s', t), ('o', t))
    else:
      target = float(ref.first_t() + rng.random() * (t - ref.first_t()))
      got = [tuple(ring.rewind(target)) for ring in rings]
      assert all(g == got[0] for g in got), step
      t = got[0][0]
    for ring in rings[1:]:
      assert len(ring) == len(ref)
      assert ring.first_t() == ref.first_t()
      assert ring.last_t() == ref.last_t()


def test_native_matches_python_randomized():
  _random_ops(0, [rw.PyRewindRing(32), rw.NativeRewindRing(32)])


def test_native_matches_jax_native_ring():
  """The port's native ring and the JAX package's (tests/conftest.py
  builds it) on one random sequence."""
  assert jrw.HAVE_NATIVE
  _random_ops(1, [jrw.NativeRewindRing(32), rw.NativeRewindRing(32)])


def test_driver_uses_ring_out_of_order():
  """The engine's rewind and replay through the native ring
  (test_rewind_ring.py:90): a late observation rewinds and replays, a
  too-old one is rejected."""
  from rednose_tpu_torch.models.kinematic import (
      KinematicKalman,
      ObservationKind,
  )

  kf = KinematicKalman(device="cpu")
  assert type(kf.filter.ring) is rw.NativeRewindRing
  for t in np.arange(0.0, 0.5, 0.01):
    kf.predict_and_observe(t, ObservationKind.POSITION, [0.0])
  n_before = len(kf.filter.ring)
  kf.predict_and_observe(0.25, ObservationKind.POSITION, [0.1])  # rewind
  assert len(kf.filter.ring) >= n_before
  assert kf.filter.predict_and_update_batch(
      -10.0, ObservationKind.POSITION, [[0.0]],
      np.full((1, 1, 1), 0.01)) is None  # too old -> rejected


def test_bank_ring_ckpt_bytes_budget():
  """ckpt_bytes bounds the memory BankRewindRing snapshots pin
  (test_rewind_ring.py:113): the oldest snapshots go first, and rewinds
  work against the window left."""
  per = np.zeros((1024,), dtype=np.float32).nbytes
  ring = rw.BankRewindRing(ckpt_every=1, ckpt_keep=8, ckpt_bytes=3 * per)
  for i in range(10):
    ring.record(float(i), np.zeros((1024,), dtype=np.float32) + i, f'o{i}')
  assert ring.retained_bytes() <= 3 * per
  assert len(ring._ckpt_t) == 3
  t0, state, replay = ring.rewind(8.5)
  assert t0 == 8.0 and float(state[0]) == 8.0
  assert replay == ['o9']
  with pytest.raises(ValueError):
    ring.rewind(5.0)
  with pytest.raises(ValueError):
    rw.BankRewindRing(ckpt_bytes=0)


def test_bank_ring_unbudgeted_keeps_ckpt_keep():
  ring = rw.BankRewindRing(ckpt_every=1, ckpt_keep=4)
  for i in range(10):
    ring.record(float(i), np.zeros((8,), np.float32), i)
  assert len(ring._ckpt_t) == 4
  assert ring.retained_bytes() == 4 * 32
