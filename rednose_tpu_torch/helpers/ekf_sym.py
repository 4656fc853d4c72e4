"""Mirror of `rednose.helpers.ekf_sym` (see helpers/__init__.py)."""

from rednose_tpu_torch.compat import EKF_sym, gen_code  # noqa: F401
