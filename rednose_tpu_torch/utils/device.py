"""Device selection shared by the port's engines and facades."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
  """torch.device for `device`; raises when CUDA is asked for and absent,
  so a facade built for the card never runs on the host instead.

  On CUDA it also turns TF32 off for matrix products and convolutions: the
  port's float32 filters need IEEE float32 products, and TF32 keeps about
  three decimal digits."""
  dev = torch.device(device)
  if dev.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError(
          f"device {device!r} requested but torch.cuda.is_available() is "
          "False; pass device='cpu' to run the plain torch path on the host")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  return dev
