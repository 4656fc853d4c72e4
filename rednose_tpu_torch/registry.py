"""Filter registry: name -> filter class.

Port of rednose_tpu/registry.py (the reference's ekf_register / ekf_lookup,
rednose/helpers/ekf_load.{h,cc}).
"""

from __future__ import annotations

_REGISTRY: dict[str, type] = {}


def register(cls):
  """Class decorator: register a KalmanFilter subclass under its `name`."""
  name = getattr(cls, "name", None)
  if not name or name == "<name>":
    raise ValueError(f"{cls!r} has no usable `name` attribute")
  _REGISTRY[name] = cls
  return cls


def lookup(name: str):
  """Fetch a registered filter class (reference: ekf_lookup, ekf_load.cc:21)."""
  _ensure_builtins()
  if name not in _REGISTRY:
    raise KeyError(
        f"no filter named {name!r}; registered: {sorted(_REGISTRY)}")
  return _REGISTRY[name]


def registered_filters() -> dict[str, type]:
  _ensure_builtins()
  return dict(_REGISTRY)


def _ensure_builtins():
  # import for side effect: the shipped models self-register via @register
  from rednose_tpu_torch.models import (  # noqa: F401
      car,
      kinematic,
      live,
      loc,
      msckf_eskf,
      msckf_vo,
  )
