"""Drop-in migration surface for reference (commaai/rednose) users.

Port of rednose_tpu/compat.py. The reference workflow: define the filter
symbolically, call `gen_code(generated_dir, name, ...)` at build time to
emit and compile C (rednose/helpers/ekf_sym.py:29-217), then construct
`EKF_sym(folder, name, Q, x0, P0, ...)` (ekf_sym.py:221) or its Cython
twin `EKF_sym_pyx` (ekf_sym_pyx.pyx:85-111) against the generated library.

Here both call sites work unchanged with no generated files: `gen_code`
lowers the same symbolic inputs to a torch FilterSpec
(frontend/sympy_spec.py) and keeps it in the process under `name`;
`EKF_sym` / `EKF_sym_pyx` look the spec up and run it on the port's
engine (runtime/driver.FilterEngine: init_state, predict,
predict_and_update_batch with rewind / replay, augment, maha_test,
rts_smooth, set_global, ...), on the card unless device="cpu" is asked
for. A reference filter class ports by changing only its imports:

    from rednose_tpu_torch.compat import gen_code, EKF_sym_pyx
    from rednose_tpu_torch.models.kalman_filter import KalmanFilter

`generated_dir` is accepted and ignored; gen_code must run in the process
before the engine is built.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.frontend.sympy_spec import spec_from_sympy
from rednose_tpu_torch.runtime.driver import FilterEngine, KalmanError  # noqa: F401

# name -> spec built by gen_code in this process (the analog of the
# generated lib{name}.so the reference's EKF_sym loads)
_GENERATED: dict[str, FilterSpec] = {}


def gen_code(folder, name, f_sym, dt_sym, x_sym, obs_eqs, dim_x, dim_err,
             eskf_params=None, msckf_params=None, maha_test_kinds=(),
             quaternion_idxs=(), global_vars=None, extra_routines=()):
  """The reference gen_code signature (ekf_sym.py:29-30); `folder` is
  ignored. Returns the FilterSpec and keeps it for EKF_sym."""
  del folder
  spec = spec_from_sympy(
      name, f_sym, dt_sym, x_sym, obs_eqs, dim_x, dim_err,
      eskf_params=eskf_params, msckf_params=msckf_params,
      maha_test_kinds=tuple(maha_test_kinds),
      quaternion_idxs=tuple(quaternion_idxs),
      global_vars=global_vars, extra_routines=tuple(extra_routines))
  _GENERATED[name] = spec
  return spec


def generated_spec(name: str) -> FilterSpec:
  """A spec built by gen_code (the compat analog of ekf_lookup)."""
  if name not in _GENERATED:
    raise KeyError(
        f"no generated filter {name!r}: call compat.gen_code (the filter "
        f"class's generate_code) in this process first; "
        f"generated: {sorted(_GENERATED)}")
  return _GENERATED[name]


class EKF_sym(FilterEngine):
  """The reference EKF_sym constructor signature (ekf_sym.py:221-222) on the
  port's engine. maha_test_kinds / quaternion_idxs / global_vars are baked
  into the spec by gen_code, as in the reference's generated C, and
  accepted here only for the signature; device and dtype are the
  engine's, as are normalize_slice / normalize_quaternions
  (ekf_sym.py:405-410)."""

  def __init__(self, folder, name, Q, x_initial, P_initial, dim_main,
               dim_main_err, N=0, dim_augment=0, dim_augment_err=0,
               maha_test_kinds=(), quaternion_idxs=(), global_vars=None,
               max_rewind_age: float = 1.0, logger=logging, device="cuda",
               dtype=torch.float64):
    del folder, maha_test_kinds, quaternion_idxs, global_vars
    spec = generated_spec(name)
    x_initial = np.asarray(x_initial).reshape(-1)
    # the reference constructor's dimension checks (ekf_sym.py:234-239)
    if not (dim_main + dim_augment * N == x_initial.shape[0] == spec.dim_x
            and dim_main_err + dim_augment_err * N
            == np.asarray(P_initial).shape[0] == spec.dim_err
            and (spec.dim_main, spec.dim_augment, spec.n_augment)
            == (dim_main, dim_augment, N)):
      raise ValueError(f"dimensions do not fit generated filter {name!r}")
    super().__init__(spec, Q, x_initial, P_initial,
                     max_rewind_age=max_rewind_age, logger=logger,
                     device=device, dtype=dtype)


# The Cython engine's Python-visible class (ekf_sym_pyx.pyx:85): the same
# construction surface, so reference call sites need only the import change.
EKF_sym_pyx = EKF_sym
