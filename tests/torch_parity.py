"""Shared setup of the port's parity tests (tests/test_torch_*.py).

Each test feeds the same numpy-seeded inputs to the JAX package
(rednose_tpu, the reference) and to the port (rednose_tpu_torch) in one
process on the CPU, float64 unless a test says otherwise. Torch is held
to one intra-op thread: the suite runs under several pytest-xdist workers.

Tests that need the card take the `cuda_device` fixture and carry the
`cuda` marker; they skip where torch.cuda.is_available() is False and run
on the card with `python -m pytest tests -k torch -m cuda`.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def t64(a):
  return torch.as_tensor(np.array(a), dtype=torch.float64)


def t32(a):
  return torch.as_tensor(np.array(a), dtype=torch.float32)


def np_(t):
  return t.detach().cpu().numpy()


@pytest.fixture
def cuda_device():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device("cuda")
