"""Multi-device scale-out of the filter banks over torch.distributed (port
of rednose_tpu/parallel)."""

from rednose_tpu_torch.parallel.sharding import (  # noqa: F401
    BANK_AXIS,
    bank_sharding,
    make_bank_mesh,
    shard_bank,
    sharded_bank_rmse,
    sharded_run_bank,
)
