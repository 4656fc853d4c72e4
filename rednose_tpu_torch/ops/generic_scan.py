"""Fused T-step scans of a bank of ANY filter spec (kernels 4, 5, 6, 7,
kernel 9, the offline log scan, and kernel 10, its adjoint).

`generic_bank_scan` replaces the Pallas TPU kernel
rednose_tpu/ops/pallas_bank.py:_kernel (launched by generic_bank_scan),
`generic_bank_scan_epoch` replaces pallas_bank.py:_epoch_kernel
(generic_bank_scan_epoch, flat form), `generic_bank_scan_mixed` replaces
pallas_bank.py:_mixed_kernel (generic_bank_scan_mixed) with its MSCKF
camera-frame branch (`_feature_frame_branch`, flat form): a step of an
MSCKF feature kind is a camera frame, so one kernel interleaves frames
with other sensors. `vo_bank_scan` replaces pallas_bank.py:_vo_kernel
(vo_bank_scan, flat form): T MSCKF camera frames, each a block predict,
the feature kind's projected update and the window augment. A camera
frame is the same emitted unit in both (entry_slab.frame_phase). The CUDA
source of each is emitted per spec variant by ops/entry_slab.py around
csrc/generic_scan.cuh and built by nvcc at first use
(rednose_tpu_torch/_build.py).

Layout, bank-minor (no TPU sublane fold): x (dim_x, B), P (de, de, B),
zs (T, dz, B) — (T, max_dz, B) for a mixed schedule, (T, K, max_dz, B)
for epochs — eas likewise with the extra-args widths (a camera frame's
landmark positions (T, ea_len, B)), dts (T,), kind_idx (T,) int32, pss
(T, len(ps_keys)). Q, R and the params are run-time values: the emitted
code depends only on the spec, the kinds, the structure, the param names,
the streamed keys, the gate flags, Q's nonzero pattern, for each camera-
frame unit whether its R is isotropic (else R's nonzero pattern), and the
scalar type, so a new value of the same pattern never triggers a build.

A `KernelCall` is one checked description of a call: the variant and its
run-time values. The wrappers take one (call=), or make one from their
keyword arguments; KalmanBank keeps its calls, so the checks, the
emission lookup and the copies of params, Q and R to the device run once
per call it keeps.

`stream_bank_scan` (kernel 9, emitted mode "stream") replaces the JAX
package's log scan, rednose_tpu/runtime/scan.py:scan_fn, an XLA program
(jax.jit of one lax.scan with a lax.switch over the kinds), not a Pallas
kernel: T steps of a recorded log, each a predict and the update of the
step's kind with that step's R, every step's predicted and posterior
state kept (the smoother's inputs). It is the launcher behind the
wrapper runtime/scan.build_scan_stream's scan_fn, which takes CPU
tensors to its plain loop (build_scan_stream_reference) and gives this
launcher copies of x and P to advance in place.
`stream_bank_scan_adjoint` (kernel 10, emitted mode "stream_adjoint",
ops/adjoint.py around csrc/stream_adjoint.cuh) replaces jax.grad of that
scan_fn (XLA's transpose of the lax.scan): the log backwards, each step's
update and predict recomputed from kernel 9's stacks, the cotangents of
every floating input out. Its caller is the autograd rule of scan_fn's
custom op.

Every other wrapper returns new (x, P) and never writes its inputs. For CPU
tensors it runs the plain version (ops/lane_bank.py); for CUDA tensors
(float32, or float64 for a variant built in double; contiguous) it copies
x and P once and launches the kernel, which updates the copies in place,
or it raises. `.launches` counts the kernel launches.

Gating: `generic_bank_scan(gate=None)` gates as the kind's maha_test
says and True / False force it (the JAX kernel's flag, which bench.py
sets for the live ECEF_POS stream); in the mixed and epoch scans
gate=True applies each kind's own maha_test and False gates nothing.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rednose_tpu_torch import _build
from rednose_tpu_torch.core.spec import FilterSpec
from rednose_tpu_torch.ops import entry_slab, lane_bank, sparsity

_SCALARS = {torch.float32: "float", torch.float64: "double"}


def _host64(a):
  if torch.is_tensor(a):
    return a.detach().cpu().double().numpy()
  return np.asarray(a, dtype=np.float64)


def _symmetric_R(spec, kind, R):
  dz = spec.obs[kind].dz
  R = _host64(R).reshape(dz, dz)
  if not np.array_equal(R, R.T):
    raise ValueError(f"measurement noise R of kind {kind} must be symmetric")
  return R


def r_pattern_of(R) -> object:
  """A camera frame's R variant key: "iso" for R = s^2 I, else the (i, j),
  i <= j, nonzero entries of the symmetric R."""
  R = np.asarray(R, dtype=np.float64)
  if np.array_equal(R, R[0, 0] * np.eye(R.shape[0])):
    return "iso"
  return tuple((int(i), int(j)) for i, j in zip(*np.nonzero(np.triu(R))))


@functools.lru_cache(maxsize=None)
def _source(spec, mode, units, structure, pnames, ps_keys, q_pattern,
            r_patterns=None, scalar="float", tile=True):
  """The variant's source. A variant printed in the global form (tile=False)
  differs between float and double only in its REDNOSE_SCALAR line, so it
  is emitted once, for float; the tile form is emitted per scalar type,
  since whether its tile fits in a block depends on it."""
  return entry_slab.emit_source(
      spec, mode, units,
      structure if structure is not None else sparsity.dense_structure(spec),
      pnames, ps_keys, q_pattern, scalar, r_patterns, tile)


class KernelCall:
  """One generic call, checked once: the spec, the mode ('single' /
  'mixed' / 'epoch' / 'frame' / 'stream' / 'stream_adjoint', kernel 9's
  adjoint, keyed as 'stream' is), the kind, kind set or slot
  kinds, the gate, the structure (None: the dense body) and the streamed
  param keys, with Q, one R per kind or slot (none in modes 'stream' and
  'stream_adjoint', whose R comes with each step) and the params. An
  MSCKF feature kind is a
  camera frame: mode 'frame' takes one, mode 'mixed' takes them among
  other kinds, and the other modes refuse them. Refuses an unknown
  kind, anything but a feature kind in mode 'frame', an asymmetric Q or R
  and a wrong number of R. The emitted source and the device copies of
  the values are made at first use and kept."""

  def __init__(self, spec: FilterSpec, mode: str, kinds, *, Q, R_list=(),
               params=None, gate: bool | None = None, structure=None,
               ps_keys=()):
    if not isinstance(spec, FilterSpec):
      raise TypeError(f"not a FilterSpec: {spec!r}")
    if mode not in entry_slab.MODES:
      raise ValueError(f"mode {mode!r} not in {entry_slab.MODES}")
    kinds = tuple(int(k) for k in kinds)
    if mode in ("single", "frame") and len(kinds) != 1:
      raise ValueError(f"mode {mode!r} takes one kind, got {kinds}")
    for k in kinds:
      if k not in spec.obs:
        raise ValueError(f"kind {k} not in spec {spec.name!r}")
      if spec.obs[k].is_feature and mode not in ("frame", "mixed"):
        raise ValueError(
            f"kind {k} is an MSCKF feature kind: a camera frame runs in "
            "mode 'frame' (vo_bank_scan, MSCKFBank.run_frames) or in a "
            "mixed schedule (generic_bank_scan_mixed, MSCKFBank.run_mixed), "
            f"not in mode {mode!r}")
      if mode == "frame" and not spec.obs[k].is_feature:
        raise ValueError(f"mode 'frame' takes an MSCKF feature kind, not "
                         f"kind {k}")
    if mode in ("stream", "stream_adjoint"):
      if len(R_list) or gate is False or ps_keys:
        raise ValueError(f"mode {mode!r} streams R per step (Rs), gates as "
                         "each kind's maha_test says and streams no params")
    elif len(R_list) != len(kinds):
      raise ValueError(f"{len(R_list)} R for {len(kinds)} kinds / slots")
    self.spec, self.mode, self.kinds = spec, mode, kinds
    self.params = dict(spec.default_params if params is None else params)
    self.gate = (True if gate is None and mode in (
        "mixed", "epoch", "stream", "stream_adjoint") else gate)
    self.structure = structure
    self.ps_keys = tuple(ps_keys)
    self.Q = _host64(Q)
    self._q_pattern = entry_slab.q_pattern_of(self.Q)
    self.R_list = [_symmetric_R(spec, k, R) for k, R in zip(kinds, R_list)]
    self._r_patterns = self._r_patterns_of(self.R_list)
    self._pnames = tuple(sorted(set(self.params) | set(self.ps_keys)))
    self._values = {}

  def _r_patterns_of(self, R_list):
    """A camera-frame unit's R variant key, None for every other unit;
    None for a call without a camera frame."""
    rps = tuple(r_pattern_of(R) if self.spec.obs[k].is_feature else None
                for k, R in zip(self.kinds, R_list))
    return rps if any(rp is not None for rp in rps) else None

  def set_R(self, R_list):
    """New R values, one per kind or slot, for the same variant: the kept
    device copies are rewritten in place, after any launch already queued
    on the stream, so a caller whose R changes from call to call builds
    and copies nothing else. A camera frame's R pattern picks its variant
    and may not change."""
    if len(R_list) != len(self.kinds):
      raise ValueError(f"{len(R_list)} R for {len(self.kinds)} kinds / slots")
    R_list = [_symmetric_R(self.spec, k, R)
              for k, R in zip(self.kinds, R_list)]
    if all(np.array_equal(a, b) for a, b in zip(R_list, self.R_list)):
      return self
    if self._r_patterns_of(R_list) != self._r_patterns:
      raise ValueError("a camera frame's R pattern picks the variant: make "
                       "a new KernelCall for it")
    self.R_list = R_list
    packed = np.concatenate([R.ravel() for R in R_list])
    for _, _, R in self._values.values():
      R.copy_(torch.as_tensor(packed, dtype=R.dtype))
    return self

  def _units(self):
    spec = self.spec
    if self.mode in ("single", "frame"):
      k = self.kinds[0]
      return ((k, spec.obs[k].maha_test if self.gate is None
               else bool(self.gate)),)
    return tuple((k, bool(self.gate) and spec.obs[k].maha_test)
                 for k in self.kinds)

  def source(self, dtype=torch.float32, tile=True) -> str:
    """The emitted CUDA source of this variant for a bank of dtype: the
    tile form where it fits, else the global form; tile=False asks for the
    global form. _build.build_generated_many compiles several at once."""
    if dtype not in _SCALARS:
      raise ValueError(f"the generic kernels take float32 or float64, not "
                       f"{dtype}")
    args = (self.spec, self.mode, self._units(), self.structure,
            self._pnames, self.ps_keys, self._q_pattern, self._r_patterns)
    if tile:
      return _source(*args, scalar=_SCALARS[dtype])
    return _source(*args, tile=False).replace(
        "#define REDNOSE_SCALAR float",
        f"#define REDNOSE_SCALAR {_SCALARS[dtype]}", 1)

  def counting_source(self) -> str:
    """The variant's phases printed whole, one function each (gen_predict,
    then the update or frame functions), for counting the operations of a
    step: the global form, since the tile form splits them into role
    functions that recompute shared subexpressions."""
    return self.source(tile=False)

  def values(self, dtype, device):
    """The run-time inputs on the device: the params vector (in the
    source's order), Q (de * de) and every unit's R packed (dz * dz each,
    unit by unit). Refuses non-scalar params."""
    key = (dtype, torch.device(device))
    if key not in self._values:
      vals = []
      for k in self._pnames:
        v = _host64(self.params.get(k, 0.0))
        if v.ndim:
          raise ValueError(f"param {k!r} is not a scalar; the generic "
                           "kernels take scalar params")
        vals.append(float(v))
      self._values[key] = tuple(
          torch.as_tensor(np.asarray(a, dtype=np.float64).ravel(),
                          dtype=dtype, device=device)
          for a in (vals or [0.0], self.Q,
                    np.concatenate([R.ravel() for R in self.R_list])))
    return self._values[key]


def _call_for(call, mode, spec, kinds, **kw):
  if call is None:
    return KernelCall(spec, mode, kinds, **kw)
  if call.mode != mode:
    raise ValueError(f"a {call.mode!r} call given to the {mode!r} scan")
  return call


def _plain(call, x, P, zs, dts, eas, pss, kind_idx=None):
  """The plain torch version of the call (ops/lane_bank.py) in the
  wrappers' layout, on any device; the structure is not used."""
  spec, params = call.spec, call.params
  Q = torch.as_tensor(call.Q, dtype=x.dtype, device=x.device)
  Rs = [torch.as_tensor(R, dtype=x.dtype, device=x.device)
        for R in call.R_list]
  lane = lambda a: None if a is None else a.transpose(-1, -2)  # noqa: E731
  kw = dict(eas=lane(eas), ps_keys=call.ps_keys, pss=pss, gate=call.gate)
  if call.mode == "single":
    xo, Po = lane_bank.lane_bank_scan(spec, call.kinds[0], params, x.T, P, Q,
                                      dts, lane(zs), Rs[0], **kw)
  elif call.mode == "frame":
    xo, Po = lane_bank.lane_frame_bank_scan(
        spec, call.kinds[0], params, x.T, P, Q, dts, lane(zs), lane(eas),
        Rs[0], gate=call.gate)
  elif call.mode == "mixed":
    xo, Po = lane_bank.lane_mixed_bank_scan(
        spec, call.kinds, params, x.T, P, Q, dts, kind_idx, lane(zs), Rs,
        **kw)
  else:
    xo, Po = lane_bank.lane_epoch_bank_scan(
        spec, call.kinds, params, x.T, P, Q, dts, lane(zs), Rs, **kw)
  return xo.T.contiguous(), Po.contiguous()


def _launch(wrapper, call, x, P, zs, dts, eas, pss, kind_idx=None):
  """Check the CUDA arguments, build / load the variant, launch it and
  count the launch on the wrapper."""
  spec, kinds = call.spec, call.kinds
  T, B = dts.shape[0], x.shape[-1]
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  dtype = x.dtype if x.dtype in _SCALARS else torch.float32
  _build.check_tensor("x", x, (spec.dim_x, B), dtype)
  _build.check_tensor("P", P, (spec.dim_err, spec.dim_err, B), dtype)
  lead = (T, len(kinds)) if call.mode == "epoch" else (T,)
  _build.check_tensor("zs", zs, lead + (max_dz, B), dtype)
  _build.check_tensor("dts", dts, (T,), dtype)
  if (eas is None) != (max_ea == 0):
    raise ValueError(f"kinds {kinds}: pass eas iff a kind takes extra args")
  if eas is not None:
    _build.check_tensor("eas", eas, lead + (max_ea, B), dtype)
  if (pss is None) != (len(call.ps_keys) == 0):
    raise ValueError("pass pss (T, len(ps_keys)) iff ps_keys is non-empty")
  if pss is not None:
    _build.check_tensor("pss", pss, (T, len(call.ps_keys)), dtype)
  if kind_idx is not None:
    _build.check_tensor("kind_idx", kind_idx, (T,), torch.int32)
    if T and not 0 <= int(kind_idx.min()) <= int(kind_idx.max()) < len(kinds):
      raise ValueError(f"kind_idx outside [0, {len(kinds)})")
  prm, Qd, R = call.values(dtype, x.device)
  x, P = x.clone(), P.clone()
  if T == 0:
    return x, P
  fn = _build.generated_launcher(call.source(dtype))
  ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
  code = fn(x.data_ptr(), P.data_ptr(), zs.data_ptr(), ptr(eas),
            dts.data_ptr(), ptr(kind_idx), ptr(pss), prm.data_ptr(),
            Qd.data_ptr(), R.data_ptr(), T, B,
            torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(code, wrapper.__name__)
  wrapper.launches += 1
  return x, P


def generic_bank_scan_reference(x, P, zs, dts, *, spec: FilterSpec,
                                kind: int, Q, R, params=None,
                                gate: bool | None = None, structure=None,
                                eas=None, pss=None, ps_keys=()):
  """Plain torch version of kernel 4 (lane_bank.lane_bank_scan) in the
  wrapper's layout, on any device; `structure` is not used."""
  return _plain(KernelCall(spec, "single", (kind,), Q=Q, R_list=(R,),
                           params=params, gate=gate, structure=structure,
                           ps_keys=ps_keys), x, P, zs, dts, eas, pss)


def generic_bank_scan(x, P, zs, dts, *, spec: FilterSpec | None = None,
                      kind: int | None = None, Q=None, R=None, params=None,
                      gate: bool | None = None, structure=None, eas=None,
                      pss=None, ps_keys=(), call: KernelCall | None = None):
  """T fused predict + update steps of one kind over a B-wide bank.

  x (dim_x, B), P (de, de, B), zs (T, dz, B), dts (T,), Q (de, de), R
  (dz, dz); eas (T, ea_len, B) for extra-args kinds; params a mapping of
  scalars (default spec.default_params) with ps_keys / pss overlaying
  per-step values. `structure` (ops/sparsity) selects the emitted body;
  None emits the dense one. Or call= a 'single' KernelCall in place of
  spec, kind, Q, R, params, gate, structure and ps_keys. Returns the new
  (x, P)."""
  call = _call_for(call, "single", spec, (kind,), Q=Q, R_list=(R,),
                   params=params, gate=gate, structure=structure,
                   ps_keys=ps_keys)
  if x.device.type == "cpu":
    return _plain(call, x, P, zs, dts, eas, pss)
  return _launch(generic_bank_scan, call, x, P, zs, dts, eas, pss)


generic_bank_scan.launches = 0


def generic_bank_scan_mixed_reference(x, P, zs, dts, kind_idx, *,
                                      spec: FilterSpec, kinds, Q, R_list,
                                      params=None, gate: bool = True,
                                      structure=None, eas=None, pss=None,
                                      ps_keys=()):
  """Plain torch version of kernel 6 (lane_bank.lane_mixed_bank_scan) in
  the wrapper's layout, on any device; `structure` is not used."""
  return _plain(KernelCall(spec, "mixed", kinds, Q=Q, R_list=R_list,
                           params=params, gate=gate, structure=structure,
                           ps_keys=ps_keys), x, P, zs, dts, eas, pss,
                kind_idx)


def generic_bank_scan_mixed(x, P, zs, dts, kind_idx, *,
                            spec: FilterSpec | None = None, kinds=(), Q=None,
                            R_list=(), params=None, gate: bool = True,
                            structure=None, eas=None, pss=None, ps_keys=(),
                            call: KernelCall | None = None):
  """T steps of a heterogeneous schedule: one predict, then the update of
  kinds[kind_idx[t]] (the same kind for the whole bank at a step); a step
  of an MSCKF feature kind is a camera frame, its projected update and the
  window augment.

  zs (T, max_dz, B) and eas (T, max_ea_len, B) rows padded (a camera
  frame's landmark positions in its ea rows); kind_idx (T,) int32; R_list
  per kind, aligned with kinds. Or call= a 'mixed' KernelCall. Returns
  the new (x, P)."""
  call = _call_for(call, "mixed", spec, kinds, Q=Q, R_list=R_list,
                   params=params, gate=gate, structure=structure,
                   ps_keys=ps_keys)
  if x.device.type == "cpu":
    return _plain(call, x, P, zs, dts, eas, pss, kind_idx)
  return _launch(generic_bank_scan_mixed, call, x, P, zs, dts, eas, pss,
                 kind_idx)


generic_bank_scan_mixed.launches = 0


def generic_bank_scan_epoch_reference(x, P, zs, dts, *, spec: FilterSpec,
                                      slot_kinds, Q, R_list, params=None,
                                      gate: bool = True, structure=None,
                                      eas=None, pss=None, ps_keys=()):
  """Plain torch version of kernel 5 (lane_bank.lane_epoch_bank_scan) in
  the wrapper's layout, on any device; `structure` is not used."""
  return _plain(KernelCall(spec, "epoch", slot_kinds, Q=Q, R_list=R_list,
                           params=params, gate=gate, structure=structure,
                           ps_keys=ps_keys), x, P, zs, dts, eas, pss)


def generic_bank_scan_epoch(x, P, zs, dts, *, spec: FilterSpec | None = None,
                            slot_kinds=(), Q=None, R_list=(), params=None,
                            gate: bool = True, structure=None, eas=None,
                            pss=None, ps_keys=(),
                            call: KernelCall | None = None):
  """T epochs, each one predict then the K slot updates in order (the
  reference's predict_and_update_batch, ekf_sym.py:484-531), all K inline.

  zs (T, K, max_dz, B), eas (T, K, max_ea_len, B); R_list per slot. Or
  call= an 'epoch' KernelCall. Returns the new (x, P)."""
  call = _call_for(call, "epoch", spec, slot_kinds, Q=Q, R_list=R_list,
                   params=params, gate=gate, structure=structure,
                   ps_keys=ps_keys)
  if x.device.type == "cpu":
    return _plain(call, x, P, zs, dts, eas, pss)
  return _launch(generic_bank_scan_epoch, call, x, P, zs, dts, eas, pss)


generic_bank_scan_epoch.launches = 0


def vo_bank_scan_reference(x, P, zs, eas, dts, *, spec: FilterSpec,
                           kind: int, Q, R, params=None,
                           gate: bool | None = None, structure=None):
  """Plain torch version of kernel 7 (lane_bank.lane_frame_bank_scan) in
  the wrapper's layout, on any device; `structure` is not used."""
  return _plain(KernelCall(spec, "frame", (kind,), Q=Q, R_list=(R,),
                           params=params, gate=gate, structure=structure),
                x, P, zs, dts, eas, None)


def vo_bank_scan(x, P, zs, eas, dts, *, spec: FilterSpec | None = None,
                 kind: int | None = None, Q=None, R=None, params=None,
                 gate: bool | None = None, structure=None,
                 call: KernelCall | None = None):
  """T MSCKF camera frames over a B-wide bank: each a block predict, the
  projected update of feature kind `kind` and the window augment.

  x (dim_x, B), P (de, de, B), zs (T, dz, B), eas (T, ea_len, B) landmark
  positions, dts (T,), Q (de, de), R (dz, dz); gate None gates as the
  kind's maha_test says, a bool forces it. Or call= a 'frame' KernelCall.
  Returns the new (x, P)."""
  call = _call_for(call, "frame", spec, (kind,), Q=Q, R_list=(R,),
                   params=params, gate=gate, structure=structure)
  if x.device.type == "cpu":
    return _plain(call, x, P, zs, dts, eas, None)
  return _launch(vo_bank_scan, call, x, P, zs, dts, eas, None)


vo_bank_scan.launches = 0


# ------------------------------------------------------ kernel 9: the log scan

def stream_bank_scan(call: KernelCall, x, P, zs, dts, kind_idx, Rs, eas,
                     prm, Q):
  """Kernel 9: T steps of a recorded log over a B-wide bank of CUDA
  tensors, each a predict with dts[t], then the update of
  call.kinds[kind_idx[t]] with zs[t] and the step's noise Rs[t], gated as
  the kind's maha_test says (core/step.update); every step's predicted and
  posterior state kept.

  call a 'stream' KernelCall (the variant: its Q pattern and param names);
  x (dim_x, B) and P (de, de, B), advanced in place to the final state;
  zs (T, max_dz, B) rows padded, dts (T,), kind_idx (T,) int32, Rs (T,
  max_dz, max_dz) shared by the bank and padded as runtime/scan.pad_log
  pads it (the kernel reads each kind's leading dz x dz block), eas (T,
  max_ea_len, B) for extra-args kinds, else None; prm the params in the
  call's order (sorted names; one zero for none) and Q (de, de), run-time
  values of the call's pattern. Returns (x_preds (T, dim_x, B), P_preds
  (T, de, de, B), x_posts, P_posts). Its caller is runtime/scan's scan_fn
  (through the custom op rednose::scan_stream), which runs the plain loop
  for CPU tensors; a CPU tensor here raises."""
  if call.mode != "stream":
    raise ValueError(f"a {call.mode!r} call given to the 'stream' scan")
  spec, kinds = call.spec, call.kinds
  T, B = dts.shape[0], x.shape[-1]
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  dx, de = spec.dim_x, spec.dim_err
  dtype = x.dtype if x.dtype in _SCALARS else torch.float32
  _build.check_tensor("x", x, (dx, B), dtype)
  _build.check_tensor("P", P, (de, de, B), dtype)
  _build.check_tensor("zs", zs, (T, max_dz, B), dtype)
  _build.check_tensor("dts", dts, (T,), dtype)
  _build.check_tensor("kind_idx", kind_idx, (T,), torch.int32)
  _build.check_tensor("Rs", Rs, (T, max_dz, max_dz), dtype)
  _build.check_tensor("prm", prm, (max(len(call._pnames), 1),), dtype)
  _build.check_tensor("Q", Q, (de, de), dtype)
  if (eas is None) != (max_ea == 0):
    raise ValueError(f"kinds {kinds}: pass eas iff a kind takes extra args")
  if eas is not None:
    _build.check_tensor("eas", eas, (T, max_ea, B), dtype)
  if T and not 0 <= int(kind_idx.min()) <= int(kind_idx.max()) < len(kinds):
    raise ValueError(f"kind_idx outside [0, {len(kinds)})")
  xp, xq = (x.new_empty((T, dx, B)) for _ in range(2))
  Pp, Pq = (x.new_empty((T, de, de, B)) for _ in range(2))
  if T == 0:
    return xp, Pp, xq, Pq
  fn = _build.generated_launcher(call.source(dtype))
  code = fn(x.data_ptr(), P.data_ptr(), zs.data_ptr(),
            None if eas is None else eas.data_ptr(), dts.data_ptr(),
            kind_idx.data_ptr(), Rs.data_ptr(), prm.data_ptr(),
            Q.data_ptr(), xp.data_ptr(), Pp.data_ptr(), xq.data_ptr(),
            Pq.data_ptr(), T, B,
            torch.cuda.current_stream(x.device).cuda_stream)
  _build.check(code, "stream_bank_scan")
  stream_bank_scan.launches += 1
  return xp, Pp, xq, Pq


stream_bank_scan.launches = 0


# ------------------------------------------- kernel 10: the log scan's adjoint

def stream_bank_scan_adjoint(call: KernelCall, x0, P0, zs, dts, kind_idx,
                             Rs, eas, prm, Q, xp, Pp, xq, Pq, gx, gP, gxp,
                             gPp, gxq, gPq):
  """Kernel 10: the adjoint of stream_bank_scan over a B-wide bank of CUDA
  tensors, one launch: from kernel 9's inputs and stacks, in its layout
  (x0 (dim_x, B) and P0 (de, de, B) the state before the log, xp, xq
  (T, dim_x, B), Pp, Pq (T, de, de, B)), and the cotangents of its
  outputs (gx, gP of the final state, gxp, gPp, gxq, gPq of the stacks,
  full matrices, in the same layouts), the cotangents of its inputs, per
  lane: (dx0 (dim_x, B), dP0 (de, de, B), dzs (T, max_dz, B), dRs (T,
  max_dz, max_dz, B), ddts (T, B), deas (T, max_ea_len, B) or None,
  dQ (de, de, B), dprm (len(prm), B)). dP0, dQ and dRs hold the
  cotangents of the upper entries the kernel reads (a full-matrix one
  G_ij + G_ji off the diagonal; lower entries 0, and dRs 0 off each
  kind's block): (A + A^T) / 2 is the gradient in the symmetric
  convention. dQ is dense, every entry dt times the predicted P's
  cotangent, summed over the steps.

  call a 'stream_adjoint' KernelCall (keyed as the forward's 'stream'
  call). The adjoint follows the forward's gate decisions, read from the
  stacks; `.gate_flips` keeps the last launch's per-lane count (B,) int32
  of steps whose decision, recomputed from the stored predicted state,
  differs. Its caller is the autograd rule of runtime/scan's custom op
  rednose::scan_stream (the op rednose::scan_stream_backward); a CPU
  tensor here raises."""
  if call.mode != "stream_adjoint":
    raise ValueError(f"a {call.mode!r} call given to the 'stream_adjoint' "
                     "scan")
  spec, kinds = call.spec, call.kinds
  T, B = dts.shape[0], x0.shape[-1]
  max_dz = max(spec.obs[k].dz for k in kinds)
  max_ea = max(spec.obs[k].ea_len for k in kinds)
  dx, de = spec.dim_x, spec.dim_err
  dtype = x0.dtype if x0.dtype in _SCALARS else torch.float32
  for name, t, shape in (
      ("x0", x0, (dx, B)), ("P0", P0, (de, de, B)),
      ("zs", zs, (T, max_dz, B)), ("dts", dts, (T,)),
      ("Rs", Rs, (T, max_dz, max_dz)),
      ("prm", prm, (max(len(call._pnames), 1),)), ("Q", Q, (de, de)),
      ("xp", xp, (T, dx, B)), ("Pp", Pp, (T, de, de, B)),
      ("xq", xq, (T, dx, B)), ("Pq", Pq, (T, de, de, B)),
      ("gx", gx, (dx, B)), ("gP", gP, (de, de, B)),
      ("gxp", gxp, (T, dx, B)), ("gPp", gPp, (T, de, de, B)),
      ("gxq", gxq, (T, dx, B)), ("gPq", gPq, (T, de, de, B))):
    _build.check_tensor(name, t, shape, dtype)
  _build.check_tensor("kind_idx", kind_idx, (T,), torch.int32)
  if (eas is None) != (max_ea == 0):
    raise ValueError(f"kinds {kinds}: pass eas iff a kind takes extra args")
  if eas is not None:
    _build.check_tensor("eas", eas, (T, max_ea, B), dtype)
  if T and not 0 <= int(kind_idx.min()) <= int(kind_idx.max()) < len(kinds):
    raise ValueError(f"kind_idx outside [0, {len(kinds)})")
  new = x0.new_empty
  out = (new((dx, B)), new((de, de, B)), new((T, max_dz, B)),
         new((T, max_dz, max_dz, B)), new((T, B)),
         new((T, max_ea, B)) if max_ea else None, new((de, de, B)),
         # the kernel writes the params' rows; a call without params
         # passes one placeholder, whose cotangent stays 0
         x0.new_zeros((prm.shape[0], B)))
  flips = torch.zeros(B, dtype=torch.int32, device=x0.device)
  fn = _build.generated_launcher(call.source(dtype))
  ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
  code = fn(*(ptr(a) for a in (x0, P0, zs, eas, dts, kind_idx, Rs, prm, Q,
                               xp, Pp, xq, Pq, gx, gP, gxp, gPp, gxq, gPq,
                               *out, flips)),
            T, B, torch.cuda.current_stream(x0.device).cuda_stream)
  _build.check(code, "stream_bank_scan_adjoint")
  stream_bank_scan_adjoint.launches += 1
  stream_bank_scan_adjoint.gate_flips = flips
  return out


stream_bank_scan_adjoint.launches = 0
stream_bank_scan_adjoint.gate_flips = None
