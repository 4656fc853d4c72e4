"""The port's run_live, run_msckf, run_msckf_bank and run_vo_pipeline
examples against the JAX package's scripts, on the CPU, all in float64:
each number the JAX script printed at 1e-6 relative, the counts (feature
updates, live tracks, dropped) and the late / too-old frame outcomes
exact. The harness (tests/test_torch_examples.py) runs the JAX script
through runpy and takes its numbers from its main()'s locals at full
precision; this file holds the four slowest examples, so that pytest-
xdist's --dist loadfile runs them beside the other six."""

import numpy as np

from test_torch_examples import Case, hold


def test_example_run_live():
  def jax(c):
    m = c["main"]
    return {"pos_err": np.linalg.norm(m["kf"].x[0:3] - m["pos0"]),
            "quat_norm": np.linalg.norm(m["kf"].x[3:7]),
            "smoothed_err": np.linalg.norm(m["x0_smoothed"][0:3]
                                           - m["pos0"])}
  hold("run_live", Case(jax=jax, printed=(
      None, "pos_err", "quat_norm", "smoothed_err")))


def test_example_run_msckf():
  def jax(c):
    m = c["main"]
    return {"pos": np.asarray(m["kf"].x[0:3]), "sigma": m["pos_sigma"],
            "window": np.asarray(m["kf"].filter.get_augment_times())}
  hold("run_msckf", Case(jax=jax, printed=(
      None, "pos[0]", "pos[1]", "pos[2]", "sigma[0]", "sigma[1]",
      "sigma[2]", "window[0]", "window[1]", "window[2]", "window[3]")))


def test_example_run_msckf_bank():
  def jax(c):
    m = c["main"]
    return {"err0": m["err0"], "err1": m["err1"], "steps": m["Tm"],
            "late_replayed": m["late"] is not None,
            "too_old_dropped": m["dropped"] is None}
  got = hold("run_msckf_bank", Case(jax=jax, printed=(
      None, "err0", "err1", "steps")))
  assert got["launches"] == {}   # the CPU runs the plain versions


def test_example_run_vo_pipeline():
  def jax(c):
    m = c["main"]
    return {"frames": m["frame"] + 1, "updates": m["updates"],
            "live_tracks": int(m["pipe"].live_track_count),
            "dropped": int(m["pipe"].dropped_total), "err": m["err"],
            "sigma": np.sqrt(np.diag(m["kf"].P)[0:3]).max()}
  hold("run_vo_pipeline", Case(jax=jax, printed=(
      "frames", "updates", "live_tracks", "dropped", "err", "sigma")))
