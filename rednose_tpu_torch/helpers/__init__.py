"""`rednose.helpers` import-path mirror.

Port of rednose_tpu/helpers. Reference filters import from
`rednose.helpers.*` (e.g. live_kf.py:5-12); this package keeps those paths
under a one-token rename (`rednose.` -> `rednose_tpu_torch.`): the
kalmanfilter / ekf_sym / ekf_sym_pyx / sympy_helpers / chi2_lookup
submodules, and KalmanError here. The reference's `load_code` /
`write_code` (cffi and generated-C file IO, rednose/helpers/__init__.py:5-31)
have no meaning without generated files and are absent: gen_code returns
a live spec instead.
"""

from rednose_tpu_torch.runtime.driver import KalmanError  # noqa: F401
