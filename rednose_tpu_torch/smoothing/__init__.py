from rednose_tpu_torch.smoothing.rts import (  # noqa: F401
    rts_smooth,
    rts_smooth_parallel,
    rts_smooth_parallel_bank,
    smooth_estimates,
)
