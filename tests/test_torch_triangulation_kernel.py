"""Kernel 8, the MSCKF triangulation (csrc/triangulate.cu, wrapper and
plain version in rednose_tpu_torch/msckf/triangulation.py).

On the CPU the kernel's per-track solver, a __host__ __device__ function,
is built with the host C++ compiler (-x c++, entry triangulate_host) and
held against the JAX package's compute_pos_batch (a jitted vmap of a
while_loop) and against the port's plain version on random tracks of
K = 2, 4 and 8 frames: float64 with the camera moving (at the origin and
at ECEF scale, to_c the identity or the camera-from-device permutation),
sentinel rows (no observation: u = v = 0 in every frame) and rows of
noise among them, and with the camera at rest (no parallax: the inverse
depth is unobservable and no track converges, in any of the three
programs); float32 against the plain version in float32; a stride-0 pose
window (set up once, as the kernel's blocks do) against the same poses
read a track at a time, bitwise; the dispatch on K at its ends (K = 1:
two rows for three unknowns, every track NaN and unconverged; K = MAX_K
against JAX and the plain version); the long-tail batch (768 tracks at
K = 8, a few in a hundred running all 30 iterations, the batch
chip_smoke.py holds on the card). Skips, with the reason, where no C++
compiler is on PATH.

Tolerances, float64: converged flags equal; where the host build and the
plain version take the same number of Gauss-Newton iterations, positions
within 1e-9 of max(|p|, 1) of JAX's and of the plain version's (measured
~1e-14: the kernel's Jacobian is written in closed form, the plain one is
jacfwd of the residual, the same values rounded in another order). A
track whose last squared step lands next to the 1e-4 threshold can take
one iteration more in one program than in the other: such tracks are
counted and left out of the position check, and at most 5% of the tracks
may be such. Float32 (moving camera at the origin, depths 3-20 m): flags
equal on at least 95% of the tracks (a track whose iterations end next to
the threshold can converge in one float32 program and not in the other:
1 of 40 at K = 8), positions within 1e-4 of max(|p|, 1) (measured ~2e-5)
where both converge in as many iterations.

Card-only cases (marked cuda) launch kernel 8 against its plain version
on the card, and against the host build bit for bit on a store-like
window and on the long-tail batch (skipped, with the reason, where no
host C++ compiler is on PATH); this file imports JAX only in a try (the
card's machine has none): `python -m pytest
tests/test_torch_triangulation_kernel.py -m cuda --noconftest`."""

import ctypes
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest
import torch

try:  # the card's machine has no JAX; only the cuda tests run there
  import jax.numpy as jnp
  from rednose_tpu.msckf import triangulation as jtri
except ImportError:
  jnp = jtri = None
from rednose_tpu_torch.msckf import triangulation as tri
from torch_parity import cuda_device, host_compiler  # noqa: F401

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "rednose_tpu_torch" / \
    "csrc" / "triangulate.cu"
# camera frame from device frame (x right, y down, z forward)
TO_C = {"identity": np.eye(3),
        "device": np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                            [1.0, 0.0, 0.0]])}
RTOL64, RTOL32 = 1e-9, 1e-4
ITER_SHARE = 0.05
# the long-tail batch, tracks(0, TAIL_N, TAIL_K), and the tolerance of its
# slowly converging tracks (below)
TAIL_N, TAIL_K, TAIL_RTOL64 = 768, 8, 1e-6
_LIB = []


def _host_fn():
  if host_compiler() is None:
    pytest.skip("no host C++ compiler (g++ / c++) on PATH to build "
                "csrc/triangulate.cu")
  if not _LIB:
    d = pathlib.Path(tempfile.mkdtemp(prefix="rn_triangulate_host_"))
    lib = d / "libtriangulate.so"
    proc = subprocess.run(
        [host_compiler(), "-x", "c++", "-std=c++17", "-O1", "-shared",
         "-fPIC", "-o", str(lib), str(SOURCE)], capture_output=True,
        text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(lib)).triangulate_host
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] + [ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)
    fn.restype = ctypes.c_int
    _LIB.append(fn)
  return _LIB[0]


def host(to_c, poses, uv, dtype=np.float64):
  """The host build on numpy arrays (poses read through their strides):
  (positions (N, 3), converged (N,), iterations (N,))."""
  poses = poses if poses.dtype == dtype else poses.astype(dtype)
  uv = np.ascontiguousarray(uv, dtype=dtype)
  to_c = np.ascontiguousarray(to_c, dtype=dtype)
  N, K = poses.shape[:2]
  pos = np.zeros((N, 3), dtype)
  conv = np.zeros(N, np.uint8)
  iters = np.zeros(N, np.int32)
  size = poses.itemsize
  rc = _host_fn()(to_c.ctypes.data, poses.ctypes.data,
                  *[s // size for s in poses.strides], uv.ctypes.data,
                  *[s // size for s in uv.strides], pos.ctypes.data,
                  conv.ctypes.data, iters.ctypes.data, N, K,
                  int(dtype == np.float64))
  assert rc == 0
  return pos, conv.astype(bool), iters


def _rot(q):
  w, x, y, z = q / np.linalg.norm(q)
  return np.array([
      [w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
       2 * (x * z + w * y)],
      [2 * (x * y + w * z), w * w - x * x + y * y - z * z,
       2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x),
       w * w - x * x - y * y + z * z]])


def tracks(seed, n, K, moving=True, offset=0.0, to_c=np.eye(3)):
  """n tracks of K frames: each a camera path from a random base (plus
  offset on every axis), moving at a random velocity of ~0.5 m a frame
  with small random attitudes (quaternions of random norm), or at rest;
  a landmark 3-20 m ahead of the last frame, observed in every frame with
  noise of 1e-3. With the camera moving, row 0 is a sentinel (u = v = 0
  in every frame, as harvest_complete's padding) and row 1 noise."""
  rng = np.random.RandomState(seed)
  poses, uv = np.zeros((n, K, 7)), np.zeros((n, K, 2))
  for i in range(n):
    base = offset + rng.randn(3)
    vel = 0.5 * rng.randn(3) if moving else np.zeros(3)
    for k in range(K):
      q = np.concatenate([[1.0], 0.05 * rng.randn(3)])
      poses[i, k, 3:7] = q * rng.uniform(0.5, 2.0)
      poses[i, k, :3] = base + vel * k
    depth, u0, v0 = rng.uniform(3, 20), *(0.3 * rng.randn(2))
    lm = poses[i, -1, :3] + _rot(poses[i, -1, 3:7]) @ to_c.T @ (
        depth * np.array([u0, v0, 1.0]))
    for k in range(K):
      pc = to_c @ _rot(poses[i, k, 3:7]).T @ (lm - poses[i, k, :3])
      uv[i, k] = pc[:2] / pc[2] + 1e-3 * rng.randn(2)
  if moving:
    uv[0] = 0.0
    uv[1] = 3.0 * rng.randn(K, 2)
  return poses, uv


def _plain(to_c, poses, uv, dtype=torch.float64):
  t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
  return [a.numpy() for a in tri._reference_iters(t(to_c), t(poses), t(uv))]


def _close(a, b, rtol):
  """|a - b| within rtol of max(|b|, 1), entry by entry."""
  return np.abs(a - b) <= rtol * np.maximum(np.abs(b), 1.0)


@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("offset,to_c", [(0.0, "identity"),
                                         (4.0e6, "identity"),
                                         (0.0, "device")])
def test_host_build_matches_jax_and_plain_moving(K, offset, to_c):
  """Float64, camera moving, with a sentinel and a noise row: converged
  flags equal to JAX's and the plain version's, positions within 1e-9
  where the iteration counts agree, and the sentinel's non-finite entries
  where the plain version's are."""
  to_c = TO_C[to_c]
  poses, uv = tracks(10 + K, 40, K, offset=offset, to_c=to_c)
  hp, hc, hi = host(to_c, poses, uv)
  jp, jc = (np.asarray(a) for a in jtri.compute_pos_batch(
      jnp.asarray(to_c), jnp.asarray(poses), jnp.asarray(uv)))
  tp, tc, ti = _plain(to_c, poses, uv)
  np.testing.assert_array_equal(hc, jc)
  np.testing.assert_array_equal(hc, tc)
  assert hc[2:].mean() > 0.9, "most real tracks converge"
  same = hi == ti
  assert (~same).mean() <= ITER_SHARE, \
      f"{int((~same).sum())} of {len(same)} tracks differ in iterations"
  ok = hc & same
  assert _close(hp[ok], jp[ok], RTOL64).all()
  assert _close(hp[ok], tp[ok], RTOL64).all()
  np.testing.assert_array_equal(np.isfinite(hp[:2]), np.isfinite(tp[:2]))


@pytest.mark.parametrize("K", [2, 4, 8])
def test_host_build_at_rest_converges_nowhere(K):
  """Float64, camera at rest: no parallax, so the inverse depth is
  unobservable (its Jacobian column is rounding noise) and no track may
  report converged, in the host build, JAX or the plain version."""
  poses, uv = tracks(20 + K, 24, K, moving=False)
  _, hc, hi = host(np.eye(3), poses, uv)
  _, jc = jtri.compute_pos_batch(jnp.eye(3), jnp.asarray(poses),
                                 jnp.asarray(uv))
  _, tc, _ = _plain(np.eye(3), poses, uv)
  assert not hc.any() and not np.asarray(jc).any() and not tc.any()
  assert (hi >= 1).all() and (hi <= tri.MAX_ITERS).all()


def test_host_build_vio_store_sentinels_come_out_nan():
  """The VIO store's padding rows (u = v = 0 in every frame) over the
  synthetic tracker's window (identity attitudes, the camera moving in
  the x-y plane): the first step takes rho to 0 exactly in the plain
  version and in the host build (each operation rounded alone, as the
  kernel does on the card), which report the rows NaN after 2
  iterations; JAX's rounding lands next to 0, and it reports a point
  8e31 m away as converged. No program gives a usable position: the
  callers take only converged rows, so the VIO path drops these rows on
  the card and in the plain version alike."""
  K = 4
  poses = np.zeros((6, K, 7))
  poses[:, :, 0] = 0.2 * np.arange(K)
  poses[:, :, 1] = -0.1 * np.arange(K)
  poses[:, :, 3] = 1.0
  uv = np.zeros((6, K, 2))
  hp, hc, hi = host(np.eye(3), poses, uv)
  jp, jc = jtri.compute_pos_batch(jnp.eye(3), jnp.asarray(poses),
                                  jnp.asarray(uv))
  tp, tc, ti = _plain(np.eye(3), poses, uv)
  assert not hc.any() and not tc.any()
  assert np.isnan(hp).all() and np.isnan(tp).all()
  np.testing.assert_array_equal(hi, ti)
  assert (np.linalg.norm(np.asarray(jp), axis=1) > 1e20).all()


@pytest.mark.parametrize("K", [2, 4, 8])
def test_host_build_float32_matches_plain(K):
  """Float32 against the plain version in float32: flags equal on 95% of
  the tracks, positions within 1e-4 of max(|p|, 1) where both converged
  in as many iterations."""
  poses, uv = tracks(30 + K, 40, K)
  hp, hc, hi = host(np.eye(3), poses, uv, np.float32)
  tp, tc, ti = _plain(np.eye(3), poses, uv, torch.float32)
  assert (hc == tc).mean() >= 0.95
  same = hi == ti
  assert (~same).mean() <= ITER_SHARE
  ok = hc & tc & same
  assert ok[2:].mean() > 0.8
  assert _close(hp[ok], tp[ok], RTOL32).all()


def test_host_build_reads_a_stride_0_window():
  """One pose window expanded over 30 tracks (stride 0, as the VIO path
  passes it) gives what its contiguous copy gives, bitwise; K beyond
  MAX_K is refused."""
  poses, uv = tracks(40, 30, 4)
  window = np.broadcast_to(poses[2:3], (30, 4, 7))
  a = host(np.eye(3), window, uv)
  b = host(np.eye(3), np.ascontiguousarray(window), uv)
  assert window.strides[0] == 0
  for u, v in zip(a, b):
    np.testing.assert_array_equal(u, v)
  assert _host_fn()(*[None] * 2, 0, 0, 0, None, 0, 0, 0, *[None] * 3, 1,
                    tri.MAX_K + 1, 1) != 0


def store_like(n=768, pad=18, K=4, seed=0):
  """The VIO store's triangulation inputs in kind: one window of K
  identity attitudes on a camera moving in the x-y plane (chip_smoke.
  cohort_tracker's), expanded over n tracks with stride 0; exact
  projections of landmarks ~10 m ahead, the last `pad` rows padding
  (u = v = 0 in every frame)."""
  rng = np.random.RandomState(seed)
  window = np.zeros((K, 7))
  window[:, 0] = 0.2 * np.arange(K)
  window[:, 1] = -0.1 * np.arange(K)
  window[:, 3] = 1.0
  land = np.array([1.0, 2.0, 10.0]) + np.concatenate(
      [0.5 * rng.randn(n, 2), 1.0 + 0.2 * rng.randn(n, 1)], axis=1)
  rel = land[:, None, :] - window[None, :, :3]
  uv = rel[..., :2] / rel[..., 2:3]
  uv[n - pad:] = 0.0
  return np.broadcast_to(window, (n, K, 7)), uv


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["store", "K=2", "K=8", "K=16"])
def test_host_build_shared_window_equals_per_track(case, dtype):
  """A stride-0 pose window, set up once (A_k, p_k and M, as a block of
  the kernel sets it up in shared memory), against the same window copied
  to every track and set up a track at a time: bitwise, on the store-like
  window with its padding rows (in float64, the VIO store's type, NaN and
  unconverged in both, every other row converged) and on random windows
  of K = 2, 8 and MAX_K."""
  if case == "store":
    window, uv = store_like(n=64, pad=6)
  else:
    K = int(case[2:])
    poses, uv = tracks(70 + K, 24, K)
    window = np.broadcast_to(poses[2:3], poses.shape)
  assert window.strides[0] == 0
  a = host(np.eye(3), window, uv, dtype)
  b = host(np.eye(3), np.ascontiguousarray(window), uv, dtype)
  for u, v in zip(a, b):
    np.testing.assert_array_equal(u, v)
  if case == "store" and dtype == np.float64:
    assert np.isnan(a[0][-6:]).all() and not a[1][-6:].any()
    assert a[1][:-6].all()


def test_host_build_at_k_1_is_nan_and_unconverged():
  """K = 1, the dispatch's first case: two rows for three unknowns. The
  QR's third row is zero, so every step and position is NaN and no track
  converges, after one iteration; the plain version refuses the
  non-square triangular solve."""
  poses, uv = tracks(80, 12, 2)
  poses, uv = poses[:, 1:], uv[:, 1:]
  hp, hc, hi = host(np.eye(3), poses, uv)
  assert np.isnan(hp).all() and not hc.any() and (hi == 1).all()
  with pytest.raises(RuntimeError):
    _plain(np.eye(3), poses, uv)


def test_host_build_at_max_k_matches_jax_and_plain():
  """K = MAX_K, the dispatch's last case, float64, camera moving: flags
  equal to JAX's and the plain version's, positions within 1e-9 where the
  iteration counts agree (most real tracks converge: over 16 frames of
  random attitudes a few run all 30 iterations), and the sentinel's and
  the noise row's non-finite entries where the plain version's are."""
  K = tri.MAX_K
  poses, uv = tracks(10 + K, 40, K)
  hp, hc, hi = host(np.eye(3), poses, uv)
  jp, jc = (np.asarray(a) for a in jtri.compute_pos_batch(
      jnp.eye(3), jnp.asarray(poses), jnp.asarray(uv)))
  tp, tc, ti = _plain(np.eye(3), poses, uv)
  np.testing.assert_array_equal(hc, jc)
  np.testing.assert_array_equal(hc, tc)
  assert hc[2:].mean() > 0.8
  same = hi == ti
  assert (~same).mean() <= ITER_SHARE
  ok = hc & same
  assert _close(hp[ok], jp[ok], RTOL64).all()
  assert _close(hp[ok], tp[ok], RTOL64).all()
  np.testing.assert_array_equal(np.isfinite(hp[:2]), np.isfinite(tp[:2]))


def test_host_build_long_tail_batch():
  """The long-tail batch (768 tracks at K = 8, float64): some tracks run
  all 30 iterations. Flags equal to JAX's and the plain version's on
  every row. Apart, on at most ITER_SHARE of the rows: those whose
  iteration counts differ from the plain version's (2 here), and those
  neither program converges that are NaN in one only (a track that never
  converges has no position: after 30 iterations the two roundings can
  leave it finite in one and NaN in the other, 1 row here). Every other
  row's non-finite entries equal the plain version's. Where the counts
  agree and the track converges, positions within 1e-9 of JAX's and the
  plain version's, or within TAIL_RTOL64 for a track that converged in
  more than 10 iterations (two here: one at 20 parts from the plain
  version by 1.2e-7 m and from JAX by 2.5e-7 m, the three roundings
  of a slow chain); rows apart within 1e-4 where both converge."""
  poses, uv = tracks(0, TAIL_N, TAIL_K)
  hp, hc, hi = host(np.eye(3), poses, uv)
  jp, jc = (np.asarray(a) for a in jtri.compute_pos_batch(
      jnp.eye(3), jnp.asarray(poses), jnp.asarray(uv)))
  tp, tc, ti = _plain(np.eye(3), poses, uv)
  assert (hi == tri.MAX_ITERS).sum() >= 5
  np.testing.assert_array_equal(hc, jc)
  np.testing.assert_array_equal(hc, tc)
  finite = np.isfinite(hp).all(axis=1) == np.isfinite(tp).all(axis=1)
  apart = (hi != ti) | (~hc & ~finite)
  assert apart.mean() <= ITER_SHARE, \
      f"{int(apart.sum())} of {len(apart)} tracks part"
  np.testing.assert_array_equal(np.isfinite(hp[~apart]),
                                np.isfinite(tp[~apart]))
  ok = hc & ~apart
  rtol = np.where(hi > 10, TAIL_RTOL64, RTOL64)[ok, None]
  for ref in (jp, tp):
    assert _close(hp[ok], ref[ok], rtol).all()
  assert _close(hp[hc], jp[hc], RTOL32).all()
  assert _close(hp[hc], tp[hc], RTOL32).all()


def test_cpu_tensors_take_the_plain_version():
  """On CPU tensors compute_pos_batch and compute_pos (a batch of one)
  run the plain version and launch nothing."""
  poses, uv = tracks(50, 6, 4)
  n = tri.compute_pos_batch.launches
  r = tri.compute_pos_batch_reference.launches
  pos, ok = tri.compute_pos_batch(torch.eye(3, dtype=torch.float64),
                                  torch.as_tensor(poses),
                                  torch.as_tensor(uv))
  p1, ok1 = tri.compute_pos(torch.eye(3, dtype=torch.float64),
                            torch.as_tensor(poses[3]), torch.as_tensor(uv[3]))
  assert tri.compute_pos_batch.launches == n
  assert tri.compute_pos_batch_reference.launches == r + 2
  assert bool(ok1) == bool(ok[3])
  np.testing.assert_allclose(p1.numpy(), pos[3].numpy(), rtol=1e-12)


def test_flops_per_iteration_counts_the_closed_form():
  """The bound's operation count grows with K as the loop does: 86 a
  frame in the residual and Jacobian; in the QR 4 a row for each of the
  (3 + 2 + 1) column and r updates and 2 a row for each of the 3 norms,
  two rows a frame."""
  assert tri.flops_per_iteration(5) - tri.flops_per_iteration(4) == \
      86 + 8 * (3 + 2 + 1) + 4 * 3


# ------------------------------------------------------------- on the card

def _card_case(dev, dtype, K=4, n=768):
  poses, uv = tracks(60 + K, n, K)
  t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
  return t(np.eye(3)), t(poses), t(uv)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel8_matches_plain_on_the_card(cuda_device, dtype):
  """Kernel 8 against the plain version on the card, 768 tracks of K = 4
  with a stride-0 copy of one window too: float64 flags equal and
  positions within 1e-9 where the iteration counts agree; float32 within
  1e-4 (and flags on at least 95% of the tracks: the card's FMAs round
  otherwise than torch's separate operations)."""
  to_c, poses, uv = _card_case(cuda_device, dtype)
  n = tri.compute_pos_batch.launches
  r = tri.compute_pos_batch_reference.launches
  kp, kc = tri.compute_pos_batch(to_c, poses, uv)
  torch.cuda.synchronize()
  assert tri.compute_pos_batch.launches == n + 1
  assert tri.compute_pos_batch_reference.launches == r
  _, _, ki = tri._launch(to_c, poses, uv)
  pp, pc, pi = tri._reference_iters(to_c, poses, uv)
  kp, kc, ki, pp, pc, pi = (a.cpu().numpy() for a in (kp, kc, ki, pp, pc,
                                                      pi))
  same = ki == pi
  assert (~same).mean() <= ITER_SHARE
  if dtype == torch.float64:
    np.testing.assert_array_equal(kc, pc)
  else:
    assert (kc == pc).mean() >= 0.95
  ok = kc & pc & same
  assert ok.mean() > 0.9
  assert _close(kp[ok], pp[ok], RTOL64 if dtype == torch.float64
                else RTOL32).all()
  window = poses[:1].expand(poses.shape[0], -1, -1)
  a = tri.compute_pos_batch(to_c, window, uv)
  b = tri.compute_pos_batch(to_c, window.contiguous(), uv)
  assert all(torch.equal(u, v) for u, v in zip(a, b))
  p1, ok1 = tri.compute_pos(to_c, poses[5], uv[5])
  assert torch.equal(p1, torch.as_tensor(kp[5], device=cuda_device)) \
      and bool(ok1) == bool(kc[5])


@pytest.mark.cuda
def test_kernel8_refuses_what_it_does_not_take(cuda_device):
  """A call the kernel does not take raises; it does not fall back."""
  to_c, poses, uv = _card_case(cuda_device, torch.float64, n=8)
  with pytest.raises(ValueError):
    tri.compute_pos_batch(to_c, poses, uv[:, :3])
  with pytest.raises(ValueError):
    tri.compute_pos_batch(to_c, poses.float(), uv)
  big = torch.zeros((2, tri.MAX_K + 1, 7), dtype=torch.float64,
                    device=cuda_device)
  with pytest.raises(ValueError):
    tri.compute_pos_batch(to_c, big, big[..., :2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["store", "long tail"])
def test_kernel8_equals_host_build_on_the_card(cuda_device, case, dtype):
  """Kernel 8 on the card against its host build, bit for bit (positions,
  NaN where the host build has NaN, flags and iteration counts): the
  store-like window (stride 0, set up once a block; and its contiguous
  copy, set up a track at a time) with its padding rows, and the
  long-tail batch (768 tracks at K = 8, some at 30 iterations)."""
  if case == "store":
    poses, uv = store_like()
  else:
    poses, uv = tracks(0, TAIL_N, TAIL_K)
  npdt = np.float64 if dtype == torch.float64 else np.float32
  want = host(np.eye(3), np.ascontiguousarray(poses), uv, npdt)
  t = lambda a: torch.as_tensor(np.ascontiguousarray(a, npdt),  # noqa: E731
                                device=cuda_device)
  p = t(poses[:1]).expand(poses.shape) if case == "store" else t(poses)
  for pp in (p, p.contiguous()):
    got = [a.cpu().numpy() for a in tri._launch(t(np.eye(3)), pp, t(uv))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
