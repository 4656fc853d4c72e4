"""Mirror of `rednose.helpers.ekf_sym_pyx` (see helpers/__init__.py)."""

from rednose_tpu_torch.compat import EKF_sym_pyx  # noqa: F401
