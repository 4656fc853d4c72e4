"""Mirror of `rednose.helpers.kalmanfilter` (see helpers/__init__.py)."""

from rednose_tpu_torch.models.kalman_filter import KalmanFilter  # noqa: F401
