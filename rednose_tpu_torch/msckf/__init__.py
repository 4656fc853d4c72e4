from rednose_tpu_torch.msckf.triangulation import (  # noqa: F401
    compute_pos,
    compute_pos_batch,
)
