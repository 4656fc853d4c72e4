"""rednose_tpu_torch: the PyTorch + CUDA port of rednose_tpu.

The JAX package `rednose_tpu` is the reference; this package keeps its
module tree (core/, ops/, runtime/, models/, msckf/, smoothing/,
frontend/, helpers/, utils/, compat.py) so each module's counterpart sits
at the same path. It imports torch and numpy, never jax.
The hot bank paths run hand-written CUDA kernels (csrc/, built by
_build.py at first use) on CUDA tensors, and their plain torch versions
on CPU tensors.
"""

from rednose_tpu_torch.core.spec import FilterSpec, ObservationModel  # noqa: F401
from rednose_tpu_torch.registry import lookup, register, registered_filters  # noqa: F401
from rednose_tpu_torch.runtime.driver import FilterEngine, KalmanError  # noqa: F401

__version__ = "0.1.0"
