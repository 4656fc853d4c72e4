#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one H100

Builds the port's CUDA kernels from the repository (rednose_tpu_torch/
_build.py): csrc/*.cu, and, in parallel, one emitted source per generic
kernel variant the run uses (ops/entry_slab.py around
csrc/generic_scan.cuh, one nvcc each, the examples' variants among
them). Then:
  1. ten main paths, each with every kernel's launch count set to 0
     just before it and read just after it:
     - kinematic and live: KinematicKalman(device="cuda") on a
       100-observation stream (the engine on the native rewind ring; P
       shrinks, a late observation rewinds and replays, a too-old one
       returns None); the kinematic bank scan at
       B = 16384, T = 4096 with the gate on; LiveKalmanBank(batch=8192):
       run_mixed over T = 1024 steps of the gyro / accel / camera rotation
       / position schedule, run over T = 1024 ECEF_POS steps, 8 observe
       calls with one late; all finite, P exactly symmetric, no diverged
       lane, every position within 8 sigma + 5 m of the truth;
     - the generic bank (KalmanBank): CarKalman at B = 8192, T = 1024
       yaw-rate steps with the per-step speed / steering stream; LocKalman
       at B = 8192, T = 512 GNSS epochs of 4 pseudoranges + 4 rates, then
       8 observe calls with one late; the unmodified live spec at
       B = 8192, run_mixed T = 512 over the 4-kind cycle and run T = 512
       ECEF_POS with the gate on; all finite, P exactly symmetric, no
       diverged lane;
     - the MSCKF bank (MSCKFBank): msckf_vo at B = 4096, run_frames
       T = 128; msckf_eskf at B = 4096, run_frames T = 64, then 8
       observe_frame calls with one late and 2 position fixes; on camera
       frames consistent with a per-lane truth; at most 1% of lanes lost
       (beyond 10 sigma of their truth, or not finite), every non-finite
       lane flagged by diverged() and re-seeded by reset_diverged(), every
       other P exactly symmetric;
     - VIO: the track store at the reference's design point (6000 tracks x
       3000 features, float64 on the card) over 32 frames of the JAX
       bench's synthetic tracker, each harvest, merge and triangulation
       (kernel 8, one launch a frame) checked; MSCKFBank.run_mixed at B = 4096 over 64 steps alternating
       camera frame (its landmarks from the store's triangulations) and
       position fix, for both MSCKF models, healthy as above; the
       single-filter VisualOdometryPipeline on MSCKFEskf(device="cuda")
       over the scenario of tests/test_vo_pipeline.py;
     - offline smoother and migration, all on the card: LiveKalmanBank
       (batch=8192) with an off-diagonal Q (full_q), run_mixed over T = 512
       steps of the 4-kind cycle, run over T = 512 ECEF_POS steps, 8
       observe calls with one late, healthy as above; bench.py:363-400's
       live log (ECEF_POS and NO_ROT in turn, dt 0.01, T = 8192, float32)
       through runtime/scan.build_scan_stream for 64 lanes at once (kernel
       9 in tile form, one launch, then once more timed with CUDA events;
       the plain scan's predict with F_lane and jacfwd timed on its first
       F_LANE_T steps);
       rts_smooth and rts_smooth_parallel on lane 0, the parallel result
       against the float64 sequential one within 3x the float32
       sequential's own error (tests/test_rts_live.py:131-152);
       rts_smooth_parallel_bank over all 64 lanes, three of them held
       against their lane smoothed alone; the cold T = 600 log of
       tests/test_rts_live.py in float64, refine = 8 within 1e-6 of the
       sequential smoother (the log itself through kernel 9, float64;
       both offline variants of kernel 9 must be the tile, design 1, at
       TILE_ROLES_STREAM warps, each printed with its registers, stack
       and spills);
       the gains step of every lane through the
       blocked lane Cholesky and through torch.linalg; the migrated
       kinematic filter of examples/run_compat_migration.py
       (compat.EKF_sym_pyx, float64) on the reference's goldens, then its
       smoother.
     - the full-Q live bank with streamed R: LiveKalmanBank(batch=8192)
       with the off-diagonal Q in float64, run_mixed over T = 512 steps
       of the 4-kind cycle with the camera rotation's variances streamed
       (r_stream): the plain full-Q slab on the card (the JAX reference's
       route), no kernel; held against the same call on the CPU on 64
       lanes within 1e-6 sigma, healthy as above;
     - the examples: each of the port's ten examples
       (rednose_tpu_torch/examples) through its main(device="cuda") at its
       own sizes, the counts zeroed before each and read after it, its
       own asserts holding and its wall time printed: kernel 3 in
       run_mixed_bank (B = 512, T = 256), kernel 6 in run_loc's bank_demo
       (loc, B = 64, T = 16, float32), kernel 6 with frames and kernel 7
       (4 observe_frame launches) in run_msckf_bank (msckf_eskf, B = 64,
       float64), no kernel in the other seven (run_bank on a mesh of one
       rank, parallel/sharding);
     - the sharded bank (parallel/sharding.py through the cases of
       parallel/dryrun.py): sharded_run_bank (kinematic, B = 4096,
       T = 500) with the staged RMSE on the 1-D and the multislice mesh,
       jit_sharded_step, the lane bank, and kernels 2 (live, B = 8192,
       T = 1024), 4 (live spec ECEF_POS gate on, B = 8192, T = 512; car
       with its params stream, T = 1024), 6 (live 4-kind cycle, B = 8192,
       T = 512; msckf_eskf VIO, B = 4096, T = 64), 5 (loc, B = 8192,
       T = 512 x 8 slots, float32) and 7 (msckf_eskf, B = 4096, T = 64)
       through their sharded wrappers, and the time-sharded smoother
       (float64, T = 4096): (a) in this process on make_bank_mesh(), one
       NCCL rank; (b) on SHARD_RANKS Gloo ranks spawned on the card, each
       on its block of lanes, its launch counts and CUDA-event times sent
       back. Each result, gathered, equals the unsharded launch bitwise;
       the RMSE and the smoother within parallel/dryrun.py's tolerances;
     - user specs (rednose_tpu_torch/models/user_specs.py, specs whose
       ops the shipped models do not use): KalmanBank(spec=...) at
       B = 8192 on the JAX package's random-spec family (seeds 2, 3, 9:
       dims 7, 11, 14), run over T = 512 steps and 8 observe calls with
       one late, and on the op battery (tanh, sigmoid, softplus, abs,
       cumsum, flip, roll, mean, a remainder heading wrap; a range to a
       per-lane anchor, a bearing through atan2, hypot and fmod, a
       cross product), run_mixed over its three kinds and run_epochs of
       4 ranges, a bearing and a cross, T = 512 each; on data
       consistent with a truth simulated per lane; finite, P exactly
       symmetric, no diverged lane, the battery's lanes tracking their
       truth;
     - the gradient through the log: the offline path's live log (64
       lanes x T = 8192, float32) through runtime/scan's scan_fn vmapped
       over the lanes, torch.autograd.grad of the innovation NLL of its
       predicted stacks w.r.t. Q, Rs, x0, P0 and zs: kernel 9 once and
       kernel 10 (the backward, csrc/stream_adjoint.cuh) once, no other;
       the gradients finite and nonzero, no gate flip.
     Every kernel of a path must have launched in it, and no main path
     may run the plain version of kernel 8 or 9; the VIO path launches
     kernels 6 (its camera-frame branch) and 8 and no other, the offline
     path kernels 4, 6 and 9 and no other, the streamed-R path none,
     the sharded path kernels 2, 4, 5, 6 and 7 and no other, the
     user-spec path kernels 4, 5 and 6 and no other.
  2. each kernel against its plain torch version on the card (kinematic at
     B = 16384, T = 4096, and at a ragged shape, KIN_RAGGED; the others
     at B = 8192, T = 64, kernel 7 at
     B = 4096, T = 16, kernel 6 with camera frames at B = 4096, T = 16,
     from converged states or fresh banks with consistent data), the
     difference in standard deviations of the plain result
     (utils/compare.py), both timed with CUDA events, with the least time
     the card could take (bound). loc (kernel 5), the live spec's 4-kind
     cycle (kernel 6, from the generic bank's state after run_mixed; in
     float32 it is held from kernel 3's state, see LIVE64_TOL) and both
     MSCKF models (kernels 7 and 6) are also held in double, the float64
     build of the body against the float64 plain version, and planted
     faults must fail that limit; loc's and the live spec's float32
     agreement there is printed; kernel 5 is held in float32 on loc at
     local scale (LOC_LOCAL_M); on the main path's loc data its share of
     lanes over 100 m off is held against the plain version's. As a
     cross-check, the generic live kernels against the hand ones on the
     same inputs: kernel 4 (ECEF_POS, gate on) against kernel 2, kernel 6
     against kernel 3 with its gate off. The full-Q variants (kernel 4,
     and kernel 6 over all 8 live lane kinds, on the main path's 4-kind
     cycle and on an 8-kind one) and their gate-on variants, on data far
     past the gate on every 16th lane, against their plain versions at
     T = 64 from kernel 3's state, at GEN_TOL; kernel 6's full-Q variant
     also in double, with planted faults (a unit left out, Q's
     velocity-acceleration coupling dropped or halved).
     Kernel 1's launch shape as the CUDA runtime reads it (its ring of
     chunks of zs in shared memory) and its raw-launch times at
     T = 4096 and T = 1. Kernels 2-7 keep P in shared memory (a tile of
     32 filters, the step split across warps): kernels 2 and 3's launch
     shapes and their raw-launch times at T = 64 and T = 1; kernel 5's on
     loc in float32 (its inputs staged a step ahead) beside its wrapped
     time; for each mode-"single", "mixed" and "frame"
     variant of the main paths the design it took (tile or global), its
     warps, shared memory a block, blocks an SM, registers, local bytes
     and its raw-launch time at T = 64 and T = 1 (every float32 one must
     be a tile), and msckf_eskf's POSITION tile against its plain
     version; kernel 5's float32 bound on loc; and each camera-frame
     variant's float32 tile (kernel 7 at T = 16 and T = 1, an
     observe_frame call; kernel 6 with frames at T = 16) against its
     global form on the same inputs (within GEN_TOL), both timed. The
     examples' variants on each example's own data: kernel 6 on loc in
     float64 (float32 printed) within LOC64_TOL, kernel 6 with frames and
     kernel 7 at T = 1 on msckf_eskf in float64 within MSCKF64_TOL, each
     timed wrapped and raw with its design. The user-spec variants
     (kernel 4 on each random spec, 6 and 5 on the battery) against their
     plain versions at T = 64, the random specs' at USER_RAND_CMP_T
     (compare_user_specs): float32 at GEN_TOL,
     the double builds within USER64_TOL with planted faults beyond it;
     each with its nvcc time, registers and spills, design and raw-launch
     times at T = 64 and T = 1, and its bound. Kernel 8 against its
     plain version on the VIO store's first and last frames and on the
     long-tail batch (768 tracks of K = 8, some at 30 iterations; float64,
     TRI64_TOL_M: all 768 rows against the plain version on the host, the
     harvested ones against it on the card too), the rows apart printed,
     a stride-0 window bitwise its contiguous copy; timed raw on the
     device (queued behind a sleep), wrapped (host clock) and beside its
     launch floor; kernel 9's tile against its plain version and
     its global form on the offline log's 64 lanes over SCAN_CMP_T
     steps: float64 from the prior within SCAN64_TOL sigmas (also on 1
     and SCAN_RAGGED_B lanes) with planted faults beyond it, float32
     from a converged state within GEN_TOL; timed with its bound, and
     both forms as raw launches in turns at SCAN_CMP_T and RTS_T.
     Kernel 10 against autograd through the plain version on the same
     64 lanes over SCAN_CMP_T steps (compare_scan_grad): float64 from
     the prior within GRAD64_TOL of each gradient's largest entry, with
     planted faults beyond it, float32 from a converged state within
     GRAD32_TOL with the same faults beyond it, the gated live spec's
     log with outliers in both types (steps rejected), no gate flip on
     any; timed wrapped and raw at SCAN_CMP_T and
     RTS_T with its bound, and the plain backward. The maximum-likelihood
     tuning of tests/test_differentiable.py through kernels 9 and 10
     (ml_tuning: T = 800, 200 momentum steps from two starts, float64).
  3. a trace (utils/profiling.trace) around run_mixed_bank and 20
     LiveKalman.predict_and_observe calls, read back: kernel 3's CUDA
     kernel and the rednose/live/predict and update scopes in it; and
     finite_or_nan_flag on a bank's state with no host sync inside it.
  4. this run's kernel times written to build/chip_smoke_times.json and
     rednose_tpu_torch/tools/flops_report run on them.
Prints the build times and ptxas lines, the card's name and power limit,
a JSON line of the kernels, and last `{"ok": true, "device": {...}}`. Any
failure raises (non-zero exit). It needs a CUDA card and the repository;
without either it exits non-zero and prints no result. It imports nothing
of JAX.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 0
KIN_B, KIN_T = 16384, 4096
KIN_RAGGED = (16384 + 37, 1024 + 29)   # kernel 1 held at a ragged shape too
LIVE_B, LIVE_T = 8192, 1024
CMP_T = 64
# generic bank (bench.py's car_params_stream, generic_epoch, generic_entry
# and generic_mixed shapes)
GEN_B = 8192
CAR_T, LOC_T, GEN_LIVE_T = 1024, 512, 512
PS_KEYS = ("u", "steer_angle_deg")
# kernel vs plain version, in standard deviations of the plain result
# (utils/compare.py): both float32, differing in rounding only (FMA
# contraction and rsqrtf in the kernel, torch's separate elementwise ops)
KIN_TOL = 1e-3
LIVE_TOL = 1e-3
# the generic kernels against their plain versions, which take dense
# jacfwd Jacobians where the kernels run the structural, zero-folded
# taps: the same math in another rounding order
GEN_TOL = 1e-3
# the generic live kernels against the hand ones: the hand kernels take
# closed-form Jacobians (live_lane.py), the generic ones the autodiff taps
# of the model as written, so every entry of H is the same value rounded
# another way (e.g. GM / r^3 against pow(r2, 1.5))
CROSS_TOL = 1e-2
# loc in float32 at ECEF scale: one ulp of a position is 0.5 m and of a
# range 2 m, against a converged position sigma under 1 m and a range
# sigma of 2 m, so any two float32 programs part by about a sigma per lane
# and gate a borderline satellite apart; their agreement is printed, not
# held. Kernel 5 is held on loc in double instead: the float64 build of
# the same emitted body against the float64 plain version, every lane
# within LOC64_TOL sigmas (a gate decision taken apart would move its
# lane by a good part of a sigma). Planted faults must fail that limit.
# On the main path's data from the 1e8 m^2 prior, the float32 kernel's
# share of lanes over LOC_FAR_M off may be at most LOC_SHARE_RATIO times
# the float32 plain version's plus LOC_SHARE_SLACK, and the double
# kernel's within LOC64_SHARE_DIFF of the float64 plain version's.
LOC64_TOL = 1e-6
# kernel 5 is held in float32 at GEN_TOL where float32 resolves a sigma: a
# receiver at the origin, satellites LOC_LOCAL_M away (a range ulp 1.2e-4 m
# against R's 2 m sigma), from a bank the float64 plain version converged
# on such epochs. The measurements' noise is LOC_LOCAL_NOISE of R's sigma
# and, in the compared epochs, slot 1 of every 16th lane is LOC_LOCAL_OFF m
# off: no distance comes
# near the gate's threshold, where two float32 programs (any two: the
# kernel's FMAs, torch's separate operations) take a decision apart on
# some of the 4M decisions and part that lane by a good part of a sigma,
# and the gate rejects the far slot on every one.
LOC_LOCAL_M, LOC_LOCAL_NOISE, LOC_LOCAL_OFF = 2.0e3, 0.3, 1.0e2
# the live spec's generic kernels at ECEF scale likewise: from the generic
# bank's state after its run_mixed (T = 512 from the 10-rad attitude
# prior, attitude sigma median ~0.5 rad) two float32 programs part beyond
# GEN_TOL on some lanes whatever their quality (the one-thread-a-filter
# kernel 6 by 0.223 sigma on one lane, a float32 ulp of an ECEF
# coordinate, where kernel 3 agrees with the tile to 1.3e-3). Kernel 6 is
# held in float32 at GEN_TOL from the state kernel 3 is held from (the
# hand bank after run_mixed over T = 1024), and from the generic bank's
# own state in double: the float64 build against the float64 plain
# version, every lane within LIVE64_TOL sigmas; planted faults must fail
# that limit.
LIVE64_TOL = 1e-6
LOC_FAR_M = 100.0
LOC_SHARE_RATIO, LOC_SHARE_SLACK = 1.25, 0.01
LOC64_SHARE_DIFF = 0.002
# the MSCKF bank (bench.py's vo and vo_eskf entries): msckf_vo at
# B = 4096, T = 128, Q = 1e-6 I, R = 0.02^2 I; msckf_eskf at B = 4096,
# T = 64, the model's Q, R = 0.01^2 I; dt 0.05, the gate on, P0 = 0.1 I
MSCKF_B, VO_T, ESKF_T = 4096, 128, 64
MSCKF_DT, MSCKF_P0 = 0.05, 0.1
MSCKF_KIND, MSCKF_POS = 16, 12   # MSCKF_TEST / MSCKF_FEATURE, POSITION
# kernel 7 against its plain version at T = 16 on consistent data: float32
# at GEN_TOL, the double build against the float64 plain version at
# MSCKF64_TOL; each planted fault (run-time values, the same builds) must
# leave some lane beyond MSCKF64_TOL. A main-path lane whose error state is
# beyond MSCKF_FAR sigmas of its truth counts as lost; at most
# MSCKF_LOST_SHARE of the lanes may be.
MSCKF_CMP_T = 16
MSCKF64_TOL = 1e-6
MSCKF_FAR, MSCKF_LOST_SHARE = 10.0, 0.01
# each lane's truth starts at MSCKF_TRUTH sigmas of P0 from its estimate:
# from a whole sigma (0.32 rad of attitude), msckf_eskf's first feature
# innovations reach tens of R's sigmas, the gate rejects them, and a lane
# that never corrects drifts off its truth
MSCKF_TRUTH = 0.3
# the camera moves at MSCKF_V m/s (tests/test_msckf_vo.py's velocity): a
# 0.15 s window then spans 17 cm at 6 m depth, where the bench's camera
# at rest spans ~1.5 cm, He nearly spans H, and float32 parts from
# float64 beyond GEN_TOL on some lanes whatever the program
MSCKF_V = (1.0, 0.5, 0.2)
# the VIO path: the JAX bench's synthetic tracker (bench.py:621-696) at the
# reference's design point (feature_handler.c:23-26): a store of 6000
# tracks x 3000 features a frame, K = 4, cohorts of 750 born and 750
# harvested a frame, harvest capacity 768, 32 frames, float64 on the card;
# every frame at least TRI_CONVERGED of the harvested tracks' triangulations
# converge, each within TRI_TOL_M of its landmark (exact projections).
# Then both MSCKF models' banks at B = MSCKF_B over VIO_T steps alternating
# camera frame and position fix, each frame's landmarks from the store's
# triangulations; kernel 6 with its camera-frame branch compared at
# VIO_CMP_T on msckf_frames' data, as kernel 7
STORE_TRACKS, STORE_FEATS, STORE_K = 6000, 3000, 4
STORE_COHORT, STORE_M, STORE_FRAMES = 750, 768, 32
TRI_CONVERGED, TRI_TOL_M = 0.99, 0.01
# kernel 8 (each frame's triangulation) against its plain version on the
# store's first and last frames (compare_triangulation: all STORE_M rows,
# the padding's sentinel rows included, against the plain version on the
# host; the harvested rows against it on the card too): converged flags
# and non-finite entries equal, and the float64 positions of the tracks
# both converge in as many Gauss-Newton iterations within TRI64_TOL_M. A
# track whose last step lands next to the threshold may take one
# iteration more in one program: at most TRI_ITER_SHARE of the rows may
# be such, each printed, and where both converge their positions are held
# within TRI_TOL_M (one more step near the threshold moves a track by up
# to about the path's own landmark tolerance)
TRI64_TOL_M, TRI_ITER_SHARE = 1e-8, 0.01
# and on the long-tail batch (tri_tail_case: TRI_TAIL_N tracks of the CPU
# tests' family at K = TRI_TAIL_K, float64) at the same limits but two: a
# track that converges slowly there (12-20 iterations) parts from the
# plain version by up to 2.5e-7 m at an equal iteration count (the host
# build against the plain version on the host and against JAX), so a
# track of more than TRI_TAIL_SLOW iterations is held within
# TRI_TAIL_TOL_M; and a track neither program
# converges has no position (after MAX_ITERS steps the two roundings can
# leave it NaN in one and finite in the other), so a row where that
# happens counts among the rows apart. Kernel 8
# timed raw on the device (queued_ms: TRI_BATCHES batches of TRI_REPS
# launches, each queued behind a sleep of TRI_SLEEP_CYCLES, ~10 ms), with
# its launch floor and its wrapped time
TRI_TAIL_N, TRI_TAIL_K, TRI_TAIL_SLOW, TRI_TAIL_TOL_M = 768, 8, 10, 1e-6
TRI_REPS, TRI_BATCHES, TRI_SLEEP_CYCLES = 20, 5, 20_000_000
VIO_T, VIO_CMP_T = 64, 16
# the offline smoother and migration path: LiveKalmanBank with a full Q
# (full_q) at LIVE_B, run_mixed and run FQ_T steps; bench.py:363-400's
# live log at its default T = RTS_T through runtime/scan for RTS_B lanes,
# smoothed on lane 0 and as a bank (each of three lanes against its lane
# alone within BANK_SMOOTH_TOL of each component's scale, float32); the
# cold T = REFINE_T log of tests/test_rts_live.py in float64, refine =
# REFINE within REFINE_TOL of the sequential smoother
FQ_T = 512
# the full-Q bank with streamed R (the plain full-Q slab on the card) is
# held against the same call on the CPU on its first STREAM_CPU_B lanes
STREAM_CPU_B = 64
RTS_T, RTS_B = 8192, 64
# kernel 9 (the log scan) against its plain version and its global form
# on RTS_B lanes of the same live log over SCAN_CMP_T steps: float64 from
# the prior within SCAN64_TOL sigmas (also on 1 and SCAN_RAGGED_B lanes),
# with planted faults (run-time values, the same build) beyond it;
# float32 from the state the float64 kernel reaches in SCAN_WARM steps,
# within GEN_TOL (from the 10-rad prior two float32 programs part by
# whole sigmas)
SCAN_CMP_T, SCAN_WARM, SCAN64_TOL = 256, 2048, 1e-6
SCAN_RAGGED_B = 37   # kernel 9 also held on the first 37 lanes (2 blocks)
BANK_SMOOTH_TOL = 1e-4
REFINE_T, REFINE, REFINE_TOL = 600, 8, 1e-6
# the full-Q comparisons: the 8-kind cycle's lanes move at 1 m/s on each
# axis (at standstill the speed's Jacobian is singular); the camera
# translation, which has no default noise, takes CAM_TRANS_R. On the gate
# on data the near lanes' measurements are each kind's h at the lane's
# input state, without noise (noise drawn for one kind moves the state
# that a tighter kind sees: a gyro draw of 0.3 of its sigma puts NO_ROT
# ~12 of its sigmas off, and some lanes near its threshold), and the
# ECEF_POS rows of every FAR_EVERY-th lane FAR_SIGMA sigmas off: no gate
# decision is near its threshold
CAM_TRANS_R = 0.1**2
GATE_NOISE, FAR_EVERY, FAR_SIGMA = 0.0, 16, 100.0
# the scan stream's predict with the spec's closed-form F against jacfwd
# of its error dynamics, on the first F_LANE_T steps of path (b)'s lanes,
# in the order F_LANE_ORDER: the only runs of kernel 9's plain version on
# a main path
F_LANE_T = 128
F_LANE_ORDER = ("F_lane", "jacfwd", "jacfwd", "F_lane")
# the user-spec path: KalmanBank(spec=...) on specs a user writes
# (rednose_tpu_torch/models/user_specs.py) at the generic cells' width
# GEN_B: the JAX package's random-spec family at USER_RANDOM (seed, dim,
# dz), run over USER_T steps then USER_OBS observe calls, one late; the
# op battery, run_mixed over its three kinds then run_epochs of its six
# slots, USER_T each; dt USER_DT, on data consistent with a truth
# simulated per lane, each estimate starting a draw of P0 from its truth.
# After each of the battery's runs at least USER_TRACK of the lanes must
# be within USER_FAR sigmas of their truth in every component; the random
# specs' share is printed, not held: their EKF is not consistent over
# USER_T steps (a weakly observed nonlinear state, and with the gate on a
# lane that drifts has every later measurement rejected), the plain
# version's on the CPU in float64 alike. Kernels 4, 5 and 6 are held
# against their plain versions at CMP_T, on a truth that starts at each
# lane's estimate, measured with noise at USER_CMP_NOISE of R's sigma (no
# gate decision near its threshold): float32 at GEN_TOL, the double
# builds at USER64_TOL, and planted faults (Q dropped, a unit or a slot
# left out: run-time values, the same builds) beyond it. The battery's
# kernels are held from its bank's state after each run, over CMP_T
# steps; the random specs' from their banks' prior, since their EKF does
# not converge (after USER_T steps rand9's sigmas span 0.2 to 200 and two
# float32 programs part by 0.0076 sigma on a lane, the double build by
# 2e-11), over USER_RAND_CMP_T steps: their dynamics amplify rounding, so
# rand9's float32 plain version parts from its float64 one by 1e-5 sigma
# in 16 steps, 1e-4 in 32 and 2e-3 in 64 (on the CPU, B = 8192), and no
# float32 program resolves GEN_TOL on every lane over 64.
USER_RANDOM = ((2, 7, 3), (3, 11, 2), (9, 14, 2))
USER_RAND_CMP_T = 32
USER_T, USER_OBS, USER_DT = 512, 8, 0.05
USER_FAR, USER_TRACK = 5.0, 0.99
USER_CMP_NOISE = 0.3
USER64_TOL = 1e-6
# the tenth path, the gradient through the log: scan_fn vmapped over the
# offline path's live log (RTS_B lanes x RTS_T steps, float32,
# SCAN_KINDS), the loss the innovation NLL of its predicted stacks summed
# over the lanes (innovation_nll), its gradients w.r.t. Q, Rs, x0, P0 and
# zs: one launch of kernel 9 and one of kernel 10 (the backward) and no
# run of the plain version. Kernel 10 against autograd through the plain
# version (compare_scan_grad) on RTS_B lanes x SCAN_CMP_T steps of the same
# log, the loss a random weighting of all six outputs: float64 from the
# prior within GRAD64_TOL of each gradient's largest entry (the double
# limit of the forward, SCAN64_TOL), with planted faults beyond it;
# float32 from the state the float64 kernel reaches in SCAN_WARM steps
# within GRAD32_TOL (measured 3.5e-6 on the card, H100 80GB HBM3 700 W;
# 1e-2 before that reading), with the same planted faults beyond it; the
# gated live spec's log from that state, every GRAD_FAR-th lane's
# positions GRAD_FAR_M off, in both types at their limits: some steps
# rejected, and no step whose gate decision, recomputed by kernel 10,
# differs from the forward's
GRAD64_TOL = SCAN64_TOL
GRAD32_TOL = 1e-4
GRAD_FAR, GRAD_FAR_M = 4, 100.0
# the maximum-likelihood tuning of tests/test_differentiable.py through
# kernels 9 and 10 (ml_tuning): the kinematic filter's innovation NLL over
# ML_T steps, ML_STEPS momentum steps (lr 2, momentum 0.9) from
# log q = log 1e-4 and log 1e4 in float64; both estimates within ML_RATIO
# of each other in log, and within ML_BAND of the ML optimum 0.2
ML_T, ML_STEPS = 800, 200
ML_RATIO, ML_BAND = 0.05, (0.6, 1.6)
# the least time the card could take (peak rates from NVIDIA's H100 SXM
# data sheet): operations over the peak rate of their type, compulsory
# bytes over the memory rate
FP32_PEAK, FP64_PEAK, HBM_RATE = 67e12, 34e12, 3.35e12


def log(msg):
  print(msg, flush=True)


def require(ok, what):
  """Fail the run when a check does not hold (unlike assert, kept under
  python -O)."""
  if not ok:
    raise RuntimeError(f"check failed: {what}")


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, check=True)
  return out.stdout.strip().splitlines()[0]


def timed_run(fn, reps):
  """(mean CUDA-event ms over reps calls after one warm-up call, output)."""
  import torch

  out = fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps, out


def kernel2_launch(lib, x, P, zs, dts, q_diag, R, gate=False):
  """A launch of kernel 2 from `lib` (live_bank_scan_launch) on copies of x
  and P made once, as kernel3_launch. Returns the zero-argument launch."""
  import torch

  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import live_lane

  x, P = x.clone(), P.clone()
  T, B = dts.shape[0], x.shape[-1]
  stream = torch.cuda.current_stream(x.device).cuda_stream

  def launch():
    _build.check(lib.live_bank_scan_launch(
        x.data_ptr(), P.data_ptr(), zs.data_ptr(), dts.data_ptr(),
        q_diag.data_ptr(), R.data_ptr(), T, B, int(gate),
        live_lane.MAHA_THRESH_3D, stream), "kernel 2")
    return x, P

  return launch


def kernel3_launch(lib, x, P, zs, dts, kind_idx, kinds, R_by_kind, q_diag,
                   gate=False, r_stream=None, stream_kinds=()):
  """A launch of kernel 3 from `lib` (live_bank_scan_mixed_launch) on
  copies of x and P made once, the arguments prepared once: no checks or
  copies between launches, so a timing of repeated launches (a T = 1 step
  among them) is the kernel's own. Returns the zero-argument launch, which
  returns the copies it updates (after its first call, the scan's
  result)."""
  import torch

  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import live_lane
  from rednose_tpu_torch.utils.chi2 import chi2_ppf

  dev = x.device
  x, P = x.clone(), P.clone()
  T, B = dts.shape[0], x.shape[-1]
  if r_stream is None:
    r_stream = torch.zeros((T, 3), dtype=torch.float32, device=dev)
  kinds_t = torch.tensor(kinds, dtype=torch.int32, device=dev)
  flags = torch.tensor([int(k in stream_kinds) for k in kinds],
                       dtype=torch.int32, device=dev)
  thresh = torch.tensor([chi2_ppf(0.95, live_lane.LANE_KINDS[k][0])
                         for k in kinds], dtype=torch.float32, device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream

  def launch():
    _build.check(lib.live_bank_scan_mixed_launch(
        x.data_ptr(), P.data_ptr(), zs.data_ptr(), dts.data_ptr(),
        kind_idx.data_ptr(), kinds_t.data_ptr(), R_by_kind.data_ptr(),
        flags.data_ptr(), thresh.data_ptr(), r_stream.data_ptr(),
        q_diag.data_ptr(), T, B, int(gate), stream), "kernel 3")
    return x, P

  return launch


def kernel1_launch(lib, state, zs, dts, rs, q, maha=True):
  """A launch of kernel 1 from `lib` (kinematic_bank_scan_launch) into an
  output made once, the arguments prepared once (see kernel3_launch).
  Returns the zero-argument launch, which returns the output."""
  import torch

  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import kinematic_scan

  out = torch.empty_like(state)
  T, B = zs.shape
  stream = torch.cuda.current_stream(state.device).cuda_stream

  def launch():
    _build.check(lib.kinematic_bank_scan_launch(
        state.data_ptr(), out.data_ptr(), zs.data_ptr(), dts.data_ptr(),
        rs.data_ptr(), q.data_ptr(), T, B, int(maha),
        kinematic_scan.MAHA_THRESH_1D, stream), "kernel 1")
    return out

  return launch


def hand_kernel_info(lib, entry):
  """The launch shape of kernel 2 (entry live_bank_scan_info) or kernel 3
  (live_bank_scan_mixed_info) as the CUDA runtime reads it
  (csrc/live_scan.cu)."""
  import ctypes

  from rednose_tpu_torch import _build

  out = (ctypes.c_int * 6)()
  _build.check(getattr(lib, entry)(ctypes.addressof(out)), entry)
  return dict(zip(("warps", "threads", "smem_bytes", "blocks_per_sm",
                   "registers", "local_bytes"), out))


def tile_line(name, info, raw):
  """The log line of a hand kernel's launch shape and raw-launch times."""
  return (f"{name} design: a block of 32 filters x {info['warps']} warps, "
          f"{info['smem_bytes']} B of shared memory a block, "
          f"{info['blocks_per_sm']} blocks an SM, {info['registers']} "
          f"registers, {info['local_bytes']} B local a thread; raw launches "
          f"T={CMP_T} {raw[CMP_T]:.4f} ms, T=1 {raw[1]:.4f} ms")


def generic_launch(source, call, x, P, zs, dts, eas=None, pss=None,
                   kind_idx=None, fn=None):
  """A launch of the build of an emitted `source` (rn_generic_scan_launch,
  or fn, another build's) with call's values, on copies of x and P made
  once, no checks between launches (see kernel3_launch). Returns the
  zero-argument launch."""
  import torch

  from rednose_tpu_torch import _build

  fn = fn or _build.generated_launcher(source)
  prm, Q, R = call.values(x.dtype, x.device)
  x, P = x.clone(), P.clone()
  T, B = dts.shape[0], x.shape[-1]
  stream = torch.cuda.current_stream(x.device).cuda_stream
  ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731

  def launch():
    _build.check(fn(x.data_ptr(), P.data_ptr(), zs.data_ptr(), ptr(eas),
                    dts.data_ptr(), ptr(kind_idx), ptr(pss), prm.data_ptr(),
                    Q.data_ptr(), R.data_ptr(), T, B, stream), "kernel 4")
    return x, P

  return launch


def step_ops(source, kinds, mode="single"):
  """Operations of one step of an emitted source: rednose_tpu_torch/utils/
  profiling.step_ops (the port is imported only once a card is found)."""
  from rednose_tpu_torch.utils import profiling

  return profiling.step_ops(source, kinds, mode)


def io_bytes(items, itemsize):
  """Compulsory bytes: every tensor or array of `items` (inputs read once,
  outputs written once; nested lists and tuples walked) at its size, a
  host array at the kernel's itemsize."""
  import torch

  n = 0
  for a in items:
    if torch.is_tensor(a):
      n += a.numel() * a.element_size()
    elif isinstance(a, np.ndarray):
      n += a.size * itemsize
    elif isinstance(a, (list, tuple)):
      n += io_bytes(a, itemsize)
  return n


def adjoint_bytes(call, kind_idx, B, itemsize):
  """Kernel 10's compulsory bytes on a log of kinds kind_idx (numpy) for
  B lanes: read once, x0, P0's upper entries, each step's z rows and extra
  args of its kind, the upper entries of each step's R block, dts,
  kind_idx (int32), the params, Q's pattern entries (upper), the stacks
  it recomputes from (every predicted x and P, P's upper entries; the
  posterior ones of steps 0 .. T-2, and of a gated log the diagonal of
  the last posterior P, which holds the decision) and the six outputs'
  cotangents (full matrices); written once, the gradients at the size of
  the function's outputs: x0's, P0's, Q's and each R block's upper
  entries, each step's z rows and extra args a lane, dts' and the
  params' (the shared inputs' once, not per lane)."""
  spec, T = call.spec, len(kind_idx)
  dx, de = spec.dim_x, spec.dim_err
  up = de * (de + 1) // 2
  obs = [spec.obs[call.kinds[int(k)]] for k in kind_idx]
  sz = sum(o.dz for o in obs)
  se = sum(o.ea_len for o in obs)
  sr = sum(o.dz * (o.dz + 1) // 2 for o in obs)
  q = int(np.count_nonzero(np.triu(np.asarray(call.Q))))
  n_prm = len(call._pnames)
  gated = T > 0 and any(spec.obs[k].maha_test for k in call.kinds)
  lane_in = (dx + up + sz + se + T * (dx + up) + max(T - 1, 0) * (dx + up)
             + (de if gated else 0) + (1 + 2 * T) * (dx + de * de))
  lane_out = dx + up + sz + se
  shared = T + sr + n_prm + q + sr + T + up + n_prm
  return (B * (lane_in + lane_out) + shared) * itemsize + 4 * T


def bound(nbytes, ops, double=False):
  """(bound_ms, bound_by): the larger of bytes over the memory rate and
  operations over the peak rate of their type."""
  t_bytes = nbytes / HBM_RATE
  t_ops = ops / (FP64_PEAK if double else FP32_PEAK)
  return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


def kinematic_inputs(torch, dev, gen, B=KIN_B, T=KIN_T):
  from rednose_tpu_torch.models.kinematic import KinematicKalman
  from rednose_tpu_torch.ops import kinematic_scan

  x0 = torch.as_tensor(KinematicKalman.initial_x, dtype=torch.float32,
                       device=dev).expand(B, 2)
  P0 = torch.as_tensor(np.diag(KinematicKalman.initial_P_diag),
                       dtype=torch.float32, device=dev).expand(B, 2, 2)
  state = kinematic_scan.pack_state(x0, P0).contiguous()
  zs = 0.5 * torch.randn((T, B), generator=gen, device=dev)
  dts = torch.full((T,), 0.01, device=dev)
  rs = torch.full((T,), 0.1**2, device=dev)
  Q = KinematicKalman.Q
  q = torch.tensor([Q[0, 0], Q[0, 1], Q[1, 1]], dtype=torch.float32,
                   device=dev)
  return state, zs, dts, rs, q


def mixed_schedule(torch, dev, gen, T):
  """The 4-kind sensor cycle of the bench (gyro, accel, camera rotation,
  position) for a bank at rest at LiveKalman.initial_x: each measurement
  is the model's h at that state plus noise of the kind's scale, so the
  filters stay consistent and keep tracking."""
  from rednose_tpu_torch.models.live import (
      LiveKalman,
      ObservationKind as K,
      build_live_spec,
  )

  kinds = (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)
  spec = build_live_spec()
  x0 = torch.as_tensor(LiveKalman.initial_x, dtype=torch.float64)
  h0 = torch.stack([spec.obs[k].h({}, x0, None) for k in kinds]).to(
      device=dev, dtype=torch.float32)                      # (4, 3)
  scale = torch.tensor([0.025, 0.5, 0.05, 5.0], device=dev)  # obs_noise std
  kind_idx = np.arange(T) % len(kinds)
  ki = torch.as_tensor(kind_idx, device=dev)
  zs = h0[ki][:, None, :] + scale[ki][:, None, None] * torch.randn(
      (T, LIVE_B, 3), generator=gen, device=dev)
  return kinds, kind_idx, zs


def main_path(torch, dev, gen):
  """Phase 1: the port's entry points, as a user calls them."""
  from rednose_tpu_torch.models.kinematic import KinematicKalman
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import kinematic_scan
  from rednose_tpu_torch.runtime import rewind
  from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank

  rng = np.random.RandomState(SEED)
  kf = KinematicKalman(device=dev)
  require(type(kf.filter.ring) is rewind.NativeRewindRing,
          "the engine runs the native rewind ring")
  for t in np.arange(0, 1.0, 0.01):
    kf.predict_and_observe(t, 1, [rng.normal(0, 0.1)])
  require(np.all(np.diag(kf.P) < KinematicKalman.initial_P_diag),
          f"single-filter P shrinks: {kf.P}")
  require(kf.predict_and_observe(0.5, 1, [1.0]) is not None,
          "a late observation rewinds and replays")
  require(kf.t > 0.98, "the replay ends at the newest observation")
  require(kf.predict_and_observe(-5.0, 1, [0.0]) is None,
          "a too-old observation is dropped")
  log(f"single filter: x={kf.x.tolist()} diag(P)={np.diag(kf.P).tolist()}")

  state, zs, dts, rs, q = kinematic_inputs(torch, dev, gen)
  out = kinematic_scan.kinematic_bank_scan(state, zs, dts, rs, q, maha=True)
  torch.cuda.synchronize()
  require(bool(torch.isfinite(out).all()), "kinematic bank finite")
  # the measurements scatter 5x wider than R, so the gate rejects many and
  # P may grow between accepted ones: check it stays positive definite
  require(bool((out[2] > 0).all() and (out[2] * out[4] > out[3] * out[3]).all()),
          "kinematic bank P positive definite")
  log(f"kinematic bank B={KIN_B} T={KIN_T}: mean P00 "
      f"{float(out[2].mean()):.6g}")

  bank = LiveKalmanBank(batch=LIVE_B, device=dev)
  pos = torch.as_tensor(LiveKalman.initial_x[0:3], dtype=torch.float32,
                        device=dev)
  zs = pos + 5.0 * torch.randn((LIVE_T, LIVE_B, 3), generator=gen,
                               device=dev)
  # run_mixed first: its measurements are made for a bank at rest, which a
  # fresh bank is; after ECEF_POS-only steps the unobserved attitude and
  # acceleration have wandered and the accelerometer rows would disagree
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, LIVE_T)
  t0 = time.perf_counter()
  bank.run_mixed(np.full(LIVE_T, 0.01), kind_idx, zs_m, kinds)
  torch.cuda.synchronize()
  t_mixed = time.perf_counter() - t0
  after_mixed = (bank._x, bank._P)  # new tensors every call: a snapshot
  t0 = time.perf_counter()
  bank.run(np.full(LIVE_T, 0.01), zs)
  torch.cuda.synchronize()
  t_run = time.perf_counter() - t0
  t_base = bank.t
  for i in (1, 2, 3, 5, 6, 4, 7, 8):  # the 4th call arrives late
    z = LiveKalman.initial_x[0:3] + rng.normal(0, 5.0, (LIVE_B, 3))
    require(bank.observe(t_base + 0.01 * i, K.ECEF_POS, z) is not None,
            f"observe {i} applied")
  require(abs(bank.t - (t_base + 0.08)) < 1e-9, "bank time after observe")
  require(bank.observe(t_base - 5.0, K.ECEF_POS, z) is None,
          "a too-old bank observation is dropped")
  torch.cuda.synchronize()
  require(bool(torch.isfinite(bank._x).all()
               and torch.isfinite(bank._P).all()), "live bank finite")
  require(torch.equal(bank._P, bank._P.transpose(0, 1)), "P symmetric")
  require(int(bank.diverged().sum()) == 0, "no diverged lane")
  sd = torch.diagonal(bank._P, dim1=0, dim2=1)[:, 0:3].sqrt()
  err = (bank._x[0:3] - pos[:, None]).abs().T
  require(bool((err < 8.0 * sd + 5.0).all()), "live bank keeps the position")
  log(f"live bank B={LIVE_B}: run_mixed T={LIVE_T} {t_mixed * 1e3:.3f} ms, "
      f"run T={LIVE_T} {t_run * 1e3:.3f} ms (host clock, first calls), "
      f"position sigma {float(sd.mean()):.4g} m, max error "
      f"{float(err.max()):.4g} m")
  return {"live_bank_scan": (bank._x, bank._P, bank._q_diag),
          "live_bank_scan_mixed": after_mixed + (bank._q_diag,)}


def compare(name, source, replaces, kernel, plain, args, kw, err, tol, reps,
            shape, ops):
  """Run the kernel and its plain version on the same inputs; the kernel
  passes when their difference, in standard deviations of the plain
  result (utils/compare.py), is at most tol. ops: the operations of the
  call, for its bound."""
  ms, out_k = timed_run(lambda: kernel(*args, **kw), reps)
  plain_ms, out_p = timed_run(lambda: plain(*args, **kw), 1)
  flat = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
  e = err(out_k, out_p)
  bound_ms, bound_by = bound(io_bytes([args, list(kw.values()),
                                       flat(out_k)], 4), ops)
  row = dict(
      name=name, route="cuda", source=source, replaces=replaces,
      max_abs_err=max(float((a - b).abs().max())
                      for a, b in zip(flat(out_k), flat(out_p))),
      sigma_err=e, ok=e <= tol, ms=ms, plain_ms=plain_ms, shape=shape,
      bound_ms=bound_ms, bound_by=bound_by)
  log(f"{name} [{shape}]: kernel {row['ms']:.4f} ms, plain "
      f"{row['plain_ms']:.4f} ms, bound {bound_ms:.4g} ms ({bound_by}); "
      f"max |kernel - plain| {row['max_abs_err']:.4g} = {e:.4g} sigma "
      f"(tolerance {tol}) -> {'ok' if row['ok'] else 'FAIL'}")
  return row


def hand_kernel_ops(live_spec):
  """Operations per filter-step of the hand kernels' functions, counted on
  the emitted structural body of the same function (ops/entry_slab.py;
  the hand kernels take closed-form Jacobians of the same algebra):
  kernel 1 the kinematic spec's position update with the gate, kernel 2
  the live spec's ECEF_POS update with the gate, kernel 3 the live
  4-kind cycle (one update of each kind every 4 steps)."""
  from rednose_tpu_torch.models.kinematic import KinematicKalman
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  kin = KinematicKalman.build_spec()
  st = sparsity.structure_for(live_spec, LiveKalman.initial_x)
  k1 = gs.KernelCall(kin, "single", (1,), Q=KinematicKalman.Q,
                     R_list=(KinematicKalman.obs_noise[1],), gate=True,
                     structure=sparsity.structure_for(
                         kin, KinematicKalman.initial_x)).counting_source()
  k2 = gs.KernelCall(live_spec, "single", (K.ECEF_POS,), Q=LiveKalman.Q,
                     R_list=(LiveKalman.obs_noise[K.ECEF_POS],), gate=True,
                     structure=st).counting_source()
  k3 = gs.KernelCall(live_spec, "mixed", mixed_kinds(), Q=LiveKalman.Q,
                     R_list=[LiveKalman.obs_noise[k] for k in mixed_kinds()],
                     structure=st).counting_source()
  return {"kinematic_bank_scan": step_ops(k1, (1,)),
          "live_bank_scan": step_ops(k2, (K.ECEF_POS,)),
          "live_bank_scan_mixed": step_ops(k3, mixed_kinds(), "mixed")}


def compare_kernels(torch, dev, gen, live_states, live_spec):
  """Phase 2: each kernel against its plain version on the same inputs.
  The live kernels start from bank states of the main path whose attitude
  has converged and that fit the measurements that follow: kernel 2 from
  the final state (ECEF_POS data), kernel 3 from the state after
  run_mixed (data of a bank at rest). From the 10-rad attitude prior,
  float32 itself cancels P = 100 to ~1e-3 in the first accelerometer
  update; and where the data disagree with the state, many measurements
  sit at the gate, where a rounding difference flips the decision. Either
  way two float32 programs part by whole sigmas whatever their quality."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import kinematic_scan, live_scan
  from rednose_tpu_torch.utils.compare import (
      kinematic_sigma_err,
      live_sigma_err,
  )

  def kin_err(a, ref):
    return max(kinematic_sigma_err(a, ref))

  def live_err(a, ref):
    return max(live_sigma_err(*a, *ref))

  ops = hand_kernel_ops(live_spec)
  kin_args = kinematic_inputs(torch, dev, gen)
  rows = [compare(
      "kinematic_bank_scan", "rednose_tpu_torch/csrc/kinematic_scan.cu",
      "rednose_tpu/ops/pallas_step.py:69", kinematic_scan.kinematic_bank_scan,
      kinematic_scan.kinematic_scan_reference, kin_args, dict(maha=True),
      kin_err, KIN_TOL, 10, f"B={KIN_B} T={KIN_T} gate on",
      ops["kinematic_bank_scan"] * KIN_B * KIN_T)]
  # a ragged bank and a ragged last chunk (B not a multiple of the block's
  # lanes nor of 4, T not a multiple of the ring's chunk), on data of its
  # own generator (the later comparisons keep theirs): held, not reported.
  # Measurements at 0.3 of R's sigma, every 16th lane's every 8th one in
  # the second half (P converged) 50 sigma off: the gate rejects those and
  # no distance comes near its threshold, where the float32 kernel and
  # plain version take a decision apart on some of the 17M (on the main
  # shape's data none is).
  B, T = KIN_RAGGED
  g = torch.Generator(device=dev)
  g.manual_seed(SEED + 10)
  state, zs, dts, rs, q = kinematic_inputs(torch, dev, g, B, T)
  zs = 0.06 * zs
  zs[T // 2::8, ::16] += 5.0
  ragged = compare(
      "kinematic_bank_scan", "", "", kinematic_scan.kinematic_bank_scan,
      kinematic_scan.kinematic_scan_reference, (state, zs, dts, rs, q),
      dict(maha=True), kin_err, KIN_TOL, 2, f"B={B} T={T} gate on, ragged",
      ops["kinematic_bank_scan"] * B * T)
  lib = _build.library()
  state, zs, dts, rs, q = kin_args
  raw = {T: timed_run(kernel1_launch(lib, state, zs[:T], dts[:T], rs[:T], q),
                      20 if T == 1 else 10)[0] for T in (KIN_T, 1)}
  shape = kinematic_scan.launch_shape()
  log(f"kinematic_bank_scan design: a block of {shape['threads']} filters "
      f"(a thread each), a ring of {shape['stages']} stages x "
      f"{shape['chunk_steps']} steps, {shape['smem_bytes']} B of shared "
      f"memory a block, {shape['blocks_per_sm']} blocks an SM, "
      f"{shape['registers']} registers, {shape['local_bytes']} B local a "
      f"thread; raw launches T={KIN_T} {raw[KIN_T]:.4f} ms, T=1 "
      f"{raw[1]:.4f} ms")

  x0, P0, q_diag = live_states["live_bank_scan"]
  dts = torch.full((CMP_T,), 0.01, device=dev)
  zs = (torch.as_tensor(LiveKalman.initial_x[0:3], dtype=torch.float32,
                        device=dev)[:, None]
        + 5.0 * torch.randn((CMP_T, 3, LIVE_B), generator=gen,
                            device=dev)).contiguous()
  R = torch.as_tensor(LiveKalman.obs_noise[K.ECEF_POS], dtype=torch.float32,
                      device=dev)
  rows.append(compare(
      "live_bank_scan", "rednose_tpu_torch/csrc/live_scan.cu",
      "rednose_tpu/ops/pallas_live.py:62", live_scan.live_bank_scan,
      live_scan.live_bank_scan_reference, (x0, P0, zs, dts, q_diag, R),
      dict(gate=True), live_err, LIVE_TOL, 5,
      f"B={LIVE_B} T={CMP_T} gate on",
      ops["live_bank_scan"] * LIVE_B * CMP_T))
  # the tiles' load and store weigh most at T = 1 (an observe call): raw
  # launches, so the wrapper's checks and copies are not in the time
  raw = {T: timed_run(kernel2_launch(lib, x0, P0, zs[:T], dts[:T], q_diag, R,
                                     True), 20 if T == 1 else 5)[0]
         for T in (CMP_T, 1)}
  log(tile_line("live_bank_scan", hand_kernel_info(lib, "live_bank_scan_info"),
                raw))

  x_m, P_m, q_diag = live_states["live_bank_scan_mixed"]
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, CMP_T)
  R_by_kind = torch.stack([
      torch.as_tensor(LiveKalman.obs_noise[k], dtype=torch.float32,
                      device=dev) for k in kinds])
  # the camera-rotation kind streams its per-step variances (live_kf.py:
  # 325-337), so the streamed-R branch is compared too
  r_stream = (0.05 + 0.01 * torch.rand((CMP_T, 3), generator=gen,
                                       device=dev)) ** 2
  rows.append(compare(
      "live_bank_scan_mixed", "rednose_tpu_torch/csrc/live_scan.cu",
      "rednose_tpu/ops/pallas_live.py:154", live_scan.live_bank_scan_mixed,
      live_scan.live_bank_scan_mixed_reference,
      (x_m, P_m, zs_m.permute(0, 2, 1).contiguous(), dts,
       torch.as_tensor(kind_idx, dtype=torch.int32, device=dev), kinds,
       R_by_kind, q_diag),
      dict(gate=True, r_stream=r_stream,
           stream_kinds=(K.CAMERA_ODO_ROTATION,)),
      live_err, LIVE_TOL, 5,
      f"B={LIVE_B} T={CMP_T} gate on, 4 kinds, 1 streamed",
      ops["live_bank_scan_mixed"] * LIVE_B * CMP_T))
  zs3 = zs_m.permute(0, 2, 1).contiguous()
  ki3 = torch.as_tensor(kind_idx, dtype=torch.int32, device=dev)
  raw = {T: timed_run(kernel3_launch(
      lib, x_m, P_m, zs3[:T], dts[:T], ki3[:T], kinds, R_by_kind, q_diag,
      True, r_stream[:T], (K.CAMERA_ODO_ROTATION,)), 20 if T == 1 else 5)[0]
         for T in (CMP_T, 1)}
  log(tile_line("live_bank_scan_mixed",
                hand_kernel_info(lib, "live_bank_scan_mixed_info"), raw))

  bad = [r["name"] + " " + r["shape"] for r in rows + [ragged]
         if not r["ok"]]
  require(not bad, f"kernels agree with their plain versions: {bad}")
  return rows

def lane_errs(a, b, spec):
  """Per-lane error of bank a against bank b, in sigmas of b."""
  import torch

  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  return torch.maximum(*lane_sigma_errs(spec, *a, *b))


def kernel_vs_plain(name, source, replaces, spec, kernel, plain, args, kw,
                    shape, ops, tol=GEN_TOL, *, checks, reps):
  """A bank kernel against its plain version on the same inputs, both
  timed (the kernel as the mean of reps calls); passes when every lane is
  within tol sigmas (utils/compare.py), which is appended to checks. ops:
  the operations of the call, for its bound. Returns (row, kernel out,
  plain out)."""
  import torch

  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  ms, out_k = timed_run(lambda: kernel(*args, **kw), reps)
  plain_ms, out_p = timed_run(lambda: plain(*args, **kw), 1)
  ex, ep = lane_sigma_errs(spec, *out_k, *out_p)
  e = torch.maximum(ex, ep)
  double = out_k[0].dtype == torch.float64
  bound_ms, bound_by = bound(
      io_bytes([args, [v for k, v in kw.items() if k != "spec"], out_k],
               out_k[0].element_size()), ops, double)
  row = dict(name=name, route="cuda", source=source, replaces=replaces,
             max_abs_err=max(float((a - b).abs().max())
                             for a, b in zip(out_k, out_p)),
             ms=ms, plain_ms=plain_ms, shape=shape, bound_ms=bound_ms,
             bound_by=bound_by)
  ok = float(e.max()) <= tol
  log(f"{name} [{shape}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
      f"bound {bound_ms:.4g} ms ({bound_by}); "
      f"max |kernel - plain| {row['max_abs_err']:.4g}, "
      f"{float(e.max()):.4g} sigma (state {float(ex.max()):.4g}, cov "
      f"{float(ep.max()):.4g}; median lane {float(e.median()):.4g}; "
      f"tolerance {tol}) -> {'ok' if ok else 'FAIL'}")
  checks.append((name + " " + shape, ok))
  return row, out_k, out_p


# ------------------------------------------------------------ generic bank

def generic_models():
  from rednose_tpu_torch.models.car import CarKalman
  from rednose_tpu_torch.models.live import LiveKalman, build_live_spec
  from rednose_tpu_torch.models.loc import LocKalman

  return CarKalman, LocKalman, LiveKalman, build_live_spec()


def loc_slots():
  from rednose_tpu_torch.models.live import ObservationKind as K

  return (K.PSEUDORANGE_GPS,) * 4 + (K.PSEUDORANGE_RATE_GPS,) * 4


def generic_calls(live_spec):
  """The call (ops/generic_scan.KernelCall) of every generic kernel
  variant the main path launches, as the facades make them."""
  from rednose_tpu_torch.models.car import ObservationKind as CK
  from rednose_tpu_torch.models.live import ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  CarKalman, LocKalman, LiveKalman, _ = generic_models()
  car, loc = CarKalman.build_spec(), LocKalman.build_spec()

  def call(model, spec, mode, kinds, **kw):
    return gs.KernelCall(
        spec, mode, kinds, Q=model.Q,
        R_list=[model.obs_noise[k] for k in kinds],
        structure=sparsity.structure_for(spec, model.initial_x), **kw)

  return {
      "car run (kernel 4)": call(CarKalman, car, "single", (CK.YAW_RATE,),
                                 ps_keys=PS_KEYS),
      "loc run_epochs (kernel 5)": loc_epoch_call(),
      "loc observe (kernel 4)": call(LocKalman, loc, "single",
                                     (K.PSEUDORANGE_GPS,)),
      "live run, gate on (kernel 4)": call(
          LiveKalman, live_spec, "single", (K.ECEF_POS,), gate=True),
      "live run_mixed (kernel 6)": live_mixed_call(),
  } | full_q_calls()


def generic_sources(live_spec):
  """The emitted source of every generic kernel variant the main path
  launches."""
  return {name: c.source() for name, c in generic_calls(live_spec).items()}


def loc_epoch_call(Q=None, R_list=None):
  """Kernel 5's call on loc as KalmanBank(LocKalman).run_epochs makes it,
  or with another Q or per-slot R (the planted faults of compare_generic:
  run-time values, so the same build)."""
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  LocKalman = generic_models()[1]
  loc = LocKalman.build_spec()
  return gs.KernelCall(
      loc, "epoch", loc_slots(), Q=LocKalman.Q if Q is None else Q,
      R_list=(R_list if R_list is not None
              else [LocKalman.obs_noise[k] for k in loc_slots()]),
      structure=sparsity.structure_for(loc, LocKalman.initial_x))


def live_mixed_call(Q=None, R_list=None):
  """Kernel 6's call on the live spec as KalmanBank.run_mixed makes it for
  the 4-kind cycle, or with another Q or per-kind R (the planted faults
  of compare_generic: run-time values, so the same build)."""
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  LiveKalman, live_spec = generic_models()[2:]
  return gs.KernelCall(
      live_spec, "mixed", mixed_kinds(), Q=LiveKalman.Q if Q is None else Q,
      R_list=(R_list if R_list is not None
              else [LiveKalman.obs_noise[k] for k in mixed_kinds()]),
      structure=sparsity.structure_for(live_spec, LiveKalman.initial_x))


def mixed_kinds():
  from rednose_tpu_torch.models.live import ObservationKind as K

  return (K.PHONE_GYRO, K.PHONE_ACCEL, K.CAMERA_ODO_ROTATION, K.ECEF_POS)


def car_data(torch, dev, T, seed):
  """bench.py car_params_stream: yaw-rate noise, forward speed in [18, 24]
  m/s and a sinusoidal steering input, dt = 0.05 s."""
  rng = np.random.RandomState(seed)
  xs = np.tile(generic_models()[0].initial_x, (GEN_B, 1)) \
      + 0.05 * rng.randn(GEN_B, 5)
  zs = torch.as_tensor(0.05 * rng.randn(T, GEN_B, 1), dtype=torch.float32,
                       device=dev)
  pss = np.stack([18.0 + 6.0 * rng.rand(T),
                  25.0 * np.sin(np.linspace(0, 20, T))], axis=1)
  return xs, zs, pss


def loc_data(torch, dev, gen, T, K):
  """bench.py generic_epoch: per-lane satellites on ~2e7 m shells moving at
  ~3 km/s, pseudoranges from the receiver at LocKalman.initial_x (at rest,
  clock 0) and zero range rates: zs (T, K, B, 1), eas (T, K, B, 6)."""
  LocKalman = generic_models()[1]
  pos = torch.as_tensor(LocKalman.initial_x[:3], dtype=torch.float32,
                        device=dev)
  sat = pos + 2.0e7 * torch.randn((T, K, GEN_B, 3), generator=gen,
                                  device=dev)
  vel = 3e3 * torch.randn((T, K, GEN_B, 3), generator=gen, device=dev)
  rho = torch.linalg.vector_norm(sat - pos, dim=-1)
  is_rho = (torch.arange(K, device=dev) < K // 2)[None, :, None]
  zs = torch.where(is_rho, rho, torch.zeros_like(rho))[..., None]
  return zs, torch.cat([sat, vel], dim=-1)


def loc_consistent_data(torch, dev, gen, T, K):
  """Satellites as in loc_data, with measurements consistent with the
  receiver at rest at LocKalman.initial_x with a zero clock: ranges and
  range rates -u.v_sat (computed in float64), plus noise at R's scale."""
  LocKalman = generic_models()[1]
  f64 = dict(dtype=torch.float64, device=dev)
  pos = torch.as_tensor(LocKalman.initial_x[:3], **f64)
  sat = pos + 2.0e7 * torch.randn((T, K, GEN_B, 3), generator=gen, **f64)
  vel = 3e3 * torch.randn((T, K, GEN_B, 3), generator=gen, **f64)
  d = pos - sat
  rho = torch.linalg.vector_norm(d, dim=-1)
  rate = -(d / rho[..., None] * vel).sum(dim=-1)
  is_rho = (torch.arange(K, device=dev) < K // 2)[None, :, None]
  noise = torch.randn(rho.shape, generator=gen, **f64)
  zs = torch.where(is_rho, rho + 2.0 * noise, rate + 0.05 * noise)
  return zs[..., None], torch.cat([sat, vel], dim=-1)


def loc_local_data(torch, dev, gen, T, K, far=True):
  """Epochs for a receiver at rest at the origin with a zero clock and
  satellites LOC_LOCAL_M away in random directions moving at ~30 m/s:
  ranges and range rates (float64) plus noise at LOC_LOCAL_NOISE of R's
  sigma; with far, slot 1 of every 16th lane LOC_LOCAL_OFF m off, so the
  gate of a converged bank rejects it: zs (T, K, B, 1), eas (T, K, B, 6)."""
  f64 = dict(dtype=torch.float64, device=dev)
  u = torch.randn((T, K, GEN_B, 3), generator=gen, **f64)
  sat = LOC_LOCAL_M * u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
  vel = 30.0 * torch.randn((T, K, GEN_B, 3), generator=gen, **f64)
  rho = torch.linalg.vector_norm(sat, dim=-1)
  rate = ((sat / rho[..., None]) * vel).sum(dim=-1)
  is_rho = (torch.arange(K, device=dev) < K // 2)[None, :, None]
  noise = LOC_LOCAL_NOISE * torch.randn(rho.shape, generator=gen, **f64)
  zs = torch.where(is_rho, rho + 2.0 * noise, rate + 0.05 * noise)
  if far:
    zs[:, 1, ::16] += LOC_LOCAL_OFF
  return zs[..., None], torch.cat([sat, vel], dim=-1)


def loc_local_case(torch, dev, gen):
  """Kernel 5's call on loc at local scale (loc_local_data), bank-minor,
  float64: a bank at the origin from loc's prior, converged by the plain
  version over CMP_T epochs, and CMP_T new epochs: (x, P, zs, eas, dts)."""
  from rednose_tpu_torch.ops import generic_scan as gs

  LocKalman = generic_models()[1]
  f64 = dict(dtype=torch.float64, device=dev)
  call = loc_epoch_call()

  def epochs(far):
    zs, eas = loc_local_data(torch, dev, gen, CMP_T, len(call.kinds), far)
    return (zs.transpose(-1, -2).contiguous(),
            eas.transpose(-1, -2).contiguous())

  x = torch.zeros((len(LocKalman.initial_x), GEN_B), **f64)
  P = torch.as_tensor(np.diag(LocKalman.initial_P_diag), **f64)[
      :, :, None].repeat(1, 1, GEN_B)
  dts = torch.full((CMP_T,), 0.1, **f64)
  zs, eas = epochs(False)   # from the prior the gate would let a far one in
  x, P = gs._plain(call, x, P, zs, dts, eas, None)
  return (x, P, *epochs(True), dts)


def generic_main_path(torch, dev, gen):
  """Phase 1, generic bank: KalmanBank as a user calls it."""
  from rednose_tpu_torch.models.car import ObservationKind as CK
  from rednose_tpu_torch.models.live import ObservationKind as K
  from rednose_tpu_torch.runtime.generic_bank import KalmanBank

  CarKalman, LocKalman, LiveKalman, live_spec = generic_models()

  def healthy(name, bank):
    torch.cuda.synchronize()
    require(bool(torch.isfinite(bank._x).all()
                 and torch.isfinite(bank._P).all()), f"{name} finite")
    require(torch.equal(bank._P, bank._P.transpose(0, 1)),
            f"{name} P symmetric")
    require(int(bank.diverged().sum()) == 0, f"{name}: no diverged lane")

  def timed(fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3

  xs, zs, pss = car_data(torch, dev, CAR_T, SEED)
  car = KalmanBank(CarKalman, batch=GEN_B, x0=xs, device=dev)
  ms = timed(lambda: car.run(np.full(CAR_T, 0.05), zs, CK.YAW_RATE,
                             pss=pss, ps_keys=PS_KEYS))
  healthy("car bank", car)
  log(f"car bank B={GEN_B}: run T={CAR_T} with the speed / steering "
      f"stream {ms:.3f} ms (host clock, first call); mean steer ratio "
      f"{float(car._x[0].mean()):.4f}, stiffness "
      f"{float(car._x[1].mean()):.4f}")

  slots = loc_slots()
  zs, eas = loc_data(torch, dev, gen, LOC_T, len(slots))
  loc = KalmanBank(LocKalman, batch=GEN_B, device=dev)
  ms = timed(lambda: loc.run_epochs(np.full(LOC_T, 0.1), zs, slots,
                                    eas=eas))
  healthy("loc bank", loc)
  loc_run = (zs, eas, loc._x)     # new tensors every call: a snapshot
  truth_t = torch.as_tensor(LocKalman.initial_x[:3], device=dev)[:, None]
  err = (loc._x[0:3] - truth_t).norm(dim=0)
  log(f"loc bank after run_epochs: position error median "
      f"{float(err.median()):.4g} m, share of lanes over 100 m "
      f"{float((err > 100.0).double().mean()):.6f}")
  rng = np.random.RandomState(SEED + 1)
  t_base = loc.t
  truth = LocKalman.initial_x[:3]
  sats = [truth + 2.0e7 * rng.randn(GEN_B, 3) for _ in range(8)]
  t0 = time.perf_counter()
  for i, sat in zip((1, 2, 3, 5, 6, 4, 7, 8), sats):  # the 4th is late
    z = np.linalg.norm(sat - truth, axis=1)[:, None]
    require(loc.observe(t_base + 0.1 * i, K.PSEUDORANGE_GPS, z, ea=sat)
            is not None, f"loc observe {i} applied")
  torch.cuda.synchronize()
  ms_obs = (time.perf_counter() - t0) * 1e3
  require(abs(loc.t - (t_base + 0.8)) < 1e-9, "loc bank time after observe")
  require(loc.observe(t_base - 5.0, K.PSEUDORANGE_GPS, z, ea=sat) is None,
          "a too-old loc observation is dropped")
  healthy("loc bank after observe", loc)
  err = (loc._x[0:3] - truth_t).norm(dim=0)
  log(f"loc bank B={GEN_B}: run_epochs T={LOC_T} x {len(slots)} slots "
      f"{ms:.3f} ms (host clock, first call), then 8 observe calls "
      f"{ms_obs:.3f} ms (host clock, 12 launches with the replay); "
      f"position error median {float(err.median()):.4g} m, share of lanes "
      f"over 100 m {float((err > 100.0).double().mean()):.6f}, max "
      f"{float(err.max()):.4g} m")

  live = KalmanBank(spec=live_spec, x0=LiveKalman.initial_x,
                    P_diag=LiveKalman.initial_P_diag, Q=LiveKalman.Q,
                    obs_noise=LiveKalman.obs_noise, batch=GEN_B, device=dev)
  # run_mixed first, for a bank at rest (see main_path)
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, GEN_LIVE_T)
  ms_m = timed(lambda: live.run_mixed(np.full(GEN_LIVE_T, 0.01), kind_idx,
                                      zs_m, kinds))
  healthy("generic live bank after run_mixed", live)
  after_mixed = (live._x, live._P)
  pos = torch.as_tensor(LiveKalman.initial_x[0:3], dtype=torch.float32,
                        device=dev)
  zs = pos + 5.0 * torch.randn((GEN_LIVE_T, GEN_B, 3), generator=gen,
                               device=dev)
  ms = timed(lambda: live.run(np.full(GEN_LIVE_T, 0.01), zs, K.ECEF_POS,
                              gate=True))
  healthy("generic live bank", live)
  # with the gate on, a lane whose attitude went astray in the 4-kind
  # cycle can reject every later fix (the hand kernels do the same):
  # counted, not required
  sd = torch.diagonal(live._P, dim1=0, dim2=1)[:, 0:3].sqrt()
  perr = (live._x[0:3] - pos[:, None]).abs().T
  off = int((~(perr < 8.0 * sd + 5.0).all(dim=1)).sum())
  log(f"generic live bank B={GEN_B}: run_mixed T={GEN_LIVE_T} "
      f"{ms_m:.3f} ms, run T={GEN_LIVE_T} gate on {ms:.3f} ms (host clock, "
      f"first calls); position sigma {float(sd.mean()):.4g} m, {off} lanes "
      f"beyond 8 sigma + 5 m")
  return {"car": (car._x, car._P), "live": (live._x, live._P),
          "live_mixed": after_mixed, "loc_run": loc_run}


def compare_generic(torch, dev, gen, states, hand_states, kernel_reps=5):
  """Phase 2, generic bank: kernels 4, 5, 6 against their plain versions
  and the generic live kernels against the hand ones (hand_states: the
  kinematic and live path's states, compare_kernels' inputs)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.car import ObservationKind as CK
  from rednose_tpu_torch.models.live import ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs, live_scan, sparsity
  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  CarKalman, LocKalman, LiveKalman, live_spec = generic_models()
  f32 = dict(dtype=torch.float32, device=dev)
  dts = torch.full((CMP_T,), 0.01, **f32)
  hand_q = hand_states["live_bank_scan"][2]
  rows, checks = [], []

  def call_ops(mode, spec, kinds, T, **kw):
    """Operations of T steps of a bank of GEN_B filters of this call; a
    mixed schedule cycles through its kinds evenly."""
    source = gs.KernelCall(spec, mode, kinds, **kw).counting_source()
    return step_ops(source, kinds, mode) * T * GEN_B

  def run(*a, **k):
    return kernel_vs_plain(*a, checks=checks, reps=kernel_reps, **k)

  # kernel 4 on the car: the params stream, from the converged bank
  car = CarKalman.build_spec()
  x, P = states["car"]
  _, zs, pss = car_data(torch, dev, CMP_T, SEED + 2)
  run("generic_bank_scan", "", "", car, gs.generic_bank_scan,
      gs.generic_bank_scan_reference,
      (x, P, zs.permute(0, 2, 1).contiguous(),
       torch.full((CMP_T,), 0.05, **f32)),
      dict(spec=car, kind=CK.YAW_RATE, Q=CarKalman.Q,
           R=CarKalman.obs_noise[CK.YAW_RATE], ps_keys=PS_KEYS,
           pss=torch.as_tensor(pss, **f32),
           structure=sparsity.structure_for(car, CarKalman.initial_x)),
      f"car B={GEN_B} T={CMP_T} speed / steering stream",
      call_ops("single", car, (CK.YAW_RATE,), CMP_T, Q=CarKalman.Q,
               R_list=(CarKalman.obs_noise[CK.YAW_RATE],), ps_keys=PS_KEYS,
               structure=sparsity.structure_for(car, CarKalman.initial_x)))

  # kernel 4 on the live spec, ECEF_POS with the gate forced on
  x, P = states["live"]
  zs = (torch.as_tensor(LiveKalman.initial_x[0:3], **f32)[:, None]
        + 5.0 * torch.randn((CMP_T, 3, GEN_B), generator=gen,
                            device=dev)).contiguous()
  R = LiveKalman.obs_noise[K.ECEF_POS]
  st = sparsity.structure_for(live_spec, LiveKalman.initial_x)
  row4, out4, _ = run(
      "generic_bank_scan", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:199", live_spec, gs.generic_bank_scan,
      gs.generic_bank_scan_reference, (x, P, zs, dts),
      dict(spec=live_spec, kind=K.ECEF_POS, Q=LiveKalman.Q, R=R, gate=True,
           structure=st), f"live spec B={GEN_B} T={CMP_T} gate on",
      call_ops("single", live_spec, (K.ECEF_POS,), CMP_T, Q=LiveKalman.Q,
               R_list=(R,), gate=True, structure=st))
  rows.append(row4)
  ms, out2 = timed_run(lambda: live_scan.live_bank_scan(
      x, P, zs, dts, hand_q, torch.as_tensor(R, **f32), gate=True),
      kernel_reps)
  ex, ep = lane_sigma_errs(live_spec, *out4, *out2)
  e = float(torch.maximum(ex, ep).max())
  log(f"cross-check generic kernel 4 vs hand kernel 2 (ECEF_POS, gate on): "
      f"{e:.4g} sigma (tolerance {CROSS_TOL}); hand kernel {ms:.4f} ms, "
      f"generic {row4['ms']:.4f} ms -> {'ok' if e <= CROSS_TOL else 'FAIL'}")
  checks.append(("generic kernel 4 vs hand kernel 2", e <= CROSS_TOL))

  # kernel 6 on the live spec in float32, from the state kernel 3 is held
  # from, and the same inputs through kernel 3 (see LIVE64_TOL)
  x, P = hand_states["live_bank_scan_mixed"][:2]
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, CMP_T)
  zs_m = zs_m.permute(0, 2, 1).contiguous()
  ki = torch.as_tensor(kind_idx, dtype=torch.int32, device=dev)
  R_list = [LiveKalman.obs_noise[k] for k in kinds]
  kw6 = dict(spec=live_spec, kinds=kinds, Q=LiveKalman.Q, R_list=R_list,
             structure=st)
  ops6 = call_ops("mixed", live_spec, kinds, CMP_T, Q=LiveKalman.Q,
                  R_list=R_list, structure=st)
  row6, out6, _ = run(
      "generic_bank_scan_mixed", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:250", live_spec,
      gs.generic_bank_scan_mixed, gs.generic_bank_scan_mixed_reference,
      (x, P, zs_m, dts, ki), kw6,
      f"live spec B={GEN_B} T={CMP_T}, 4 kinds, from kernel 3's state", ops6)
  rows.append(row6)
  ms, out3 = timed_run(lambda: live_scan.live_bank_scan_mixed(
      x, P, zs_m, dts, ki, kinds, torch.stack(
          [torch.as_tensor(r, **f32) for r in R_list]), hand_q,
      gate=False), kernel_reps)
  ex, ep = lane_sigma_errs(live_spec, *out6, *out3)
  e = float(torch.maximum(ex, ep).max())
  log(f"cross-check generic kernel 6 vs hand kernel 3 (gate off): "
      f"{e:.4g} sigma (tolerance {CROSS_TOL}); hand kernel {ms:.4f} ms, "
      f"generic {row6['ms']:.4f} ms -> {'ok' if e <= CROSS_TOL else 'FAIL'}")
  checks.append(("generic kernel 6 vs hand kernel 3", e <= CROSS_TOL))

  # kernel 6 from the generic bank's own state after run_mixed, in double
  # (the float64 build of the same emitted body), and planted faults (a
  # unit left out: its R scaled by 1e12; a Q term dropped: scaled by 1e-9;
  # run-time values, the same build) beyond LIVE64_TOL; its float32
  # agreement there printed
  x, P = states["live_mixed"]
  args64 = (x.double(), P.double(), zs_m.double(), dts.double(), ki)
  _, _, ref64 = run(
      "generic_bank_scan_mixed", "", "", live_spec,
      gs.generic_bank_scan_mixed, gs.generic_bank_scan_mixed_reference,
      args64, kw6, f"live spec B={GEN_B} T={CMP_T}, 4 kinds, from its own "
      "state, float64", ops6, tol=LIVE64_TOL)
  builds = _build.generated_launcher.cache_info().currsize
  faults = {}
  for u, k in enumerate(kinds):
    faults[f"unit {u} (kind {int(k)}) left out"] = live_mixed_call(
        R_list=[R * (1e12 if j == u else 1.0) for j, R in enumerate(R_list)])
  for i in np.flatnonzero(np.diag(LiveKalman.Q)):
    Qf = np.array(LiveKalman.Q, dtype=np.float64)
    Qf[i, i] *= 1e-9
    faults[f"Q[{i},{i}] dropped"] = live_mixed_call(Q=Qf)
  miss = {name: float(lane_errs(gs.generic_bank_scan_mixed(
      *args64, call=c), ref64, live_spec).max()) for name, c in faults.items()}
  least = min(miss, key=miss.get)
  ok = (miss[least] > LIVE64_TOL
        and _build.generated_launcher.cache_info().currsize == builds)
  log(f"generic_bank_scan_mixed planted faults [live spec, float64]: "
      f"{len(miss)} faults, the least visible ({least}) at "
      f"{miss[least]:.4g} sigma, must exceed {LIVE64_TOL}, with no extra "
      f"build -> {'ok' if ok else 'FAIL'}")
  checks.append(("live spec planted faults beyond the limit", ok))
  out_k = gs.generic_bank_scan_mixed(x, P, zs_m, dts, ki, **kw6)
  out_p = gs.generic_bank_scan_mixed_reference(x, P, zs_m, dts, ki, **kw6)
  e = lane_errs(out_k, out_p, live_spec)
  e64 = [lane_errs(o, ref64, live_spec) for o in (out_k, out_p)]
  log(f"generic_bank_scan_mixed [live spec B={GEN_B} T={CMP_T}, from its own "
      f"state, float32]: kernel vs plain max {float(e.max()):.4g} sigma "
      f"(lane {int(e.argmax())}), median {float(e.median()):.4g}; against "
      f"float64: kernel max {float(e64[0].max()):.4g} median "
      f"{float(e64[0].median()):.4g}, plain max {float(e64[1].max()):.4g} "
      f"median {float(e64[1].median()):.4g}")

  # kernel 5 on loc, held in double: the float64 build of the same
  # emitted body against the float64 plain version, from a bank converged
  # by the plain version on consistent epochs, over new consistent epochs
  # (the main path's zero range rates disagree with the ~3 km/s
  # satellites and leave many lanes unconverged)
  loc = LocKalman.build_spec()
  slots = loc_slots()
  kw = dict(spec=loc, slot_kinds=slots, Q=LocKalman.Q,
            R_list=[LocKalman.obs_noise[k] for k in slots],
            structure=sparsity.structure_for(loc, LocKalman.initial_x))
  f64 = dict(dtype=torch.float64, device=dev)

  def bank_minor(zs, eas, dtype=torch.float64):
    return (zs.transpose(-1, -2).to(dtype).contiguous(),
            eas.transpose(-1, -2).to(dtype).contiguous())

  def loc_bank(dtype):
    return (torch.as_tensor(LocKalman.initial_x, dtype=dtype, device=dev)[
        :, None].repeat(1, GEN_B),
            torch.as_tensor(np.diag(LocKalman.initial_P_diag), dtype=dtype,
                            device=dev)[:, :, None].repeat(1, 1, GEN_B))

  zs, eas = bank_minor(*loc_consistent_data(torch, dev, gen, CMP_T,
                                            len(slots)))
  dts64 = torch.full((CMP_T,), 0.1, **f64)
  x, P = gs.generic_bank_scan_epoch_reference(*loc_bank(torch.float64), zs,
                                              dts64, eas=eas, **kw)
  zs, eas = bank_minor(*loc_consistent_data(torch, dev, gen, CMP_T,
                                            len(slots)))
  row5, _, ref64 = run(
      "generic_bank_scan_epoch", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:635", loc, gs.generic_bank_scan_epoch,
      gs.generic_bank_scan_epoch_reference, (x, P, zs, dts64),
      dict(eas=eas, **kw),
      f"loc B={GEN_B} T={CMP_T} epochs of 4 + 4 slots, float64",
      call_ops("epoch", loc, slots, CMP_T, Q=LocKalman.Q,
               R_list=kw["R_list"], structure=kw["structure"]),
      tol=LOC64_TOL)
  rows.append(row5)
  # the limit catches planted faults: a Q term or a slot's update dropped
  # (the term scaled by 1e-9, the slot's R by 1e12, so the build is the
  # same); each must leave some lane beyond LOC64_TOL
  Q, Rs = LocKalman.Q, kw["R_list"]
  faults = {}
  for i in np.flatnonzero(np.diag(Q)):
    Qf = Q.copy()
    Qf[i, i] *= 1e-9
    faults[f"Q[{i},{i}] dropped"] = loc_epoch_call(Q=Qf)
  for k in range(len(slots)):
    faults[f"slot {k} left out"] = loc_epoch_call(
        R_list=[R * (1e12 if j == k else 1.0) for j, R in enumerate(Rs)])
  miss = {name: float(lane_errs(gs.generic_bank_scan_epoch(
      x, P, zs, dts64, eas=eas, call=c), ref64, loc).max())
          for name, c in faults.items()}
  least = min(miss, key=miss.get)
  ok = miss[least] > LOC64_TOL
  log(f"generic_bank_scan_epoch planted faults [loc, float64]: "
      f"{len(miss)} faults, the least visible ({least}) at "
      f"{miss[least]:.4g} sigma, must exceed {LOC64_TOL} -> "
      f"{'ok' if ok else 'FAIL'}")
  checks.append(("loc planted faults beyond the limit", ok))

  # the same comparison in float32, the main path's dtype: printed, not
  # held (see LOC64_TOL)
  args32 = (x.float(), P.float(), zs.float(), dts64.float())
  kw32 = dict(eas=eas.float(), **kw)
  ms, out_k = timed_run(lambda: gs.generic_bank_scan_epoch(*args32, **kw32),
                        kernel_reps)
  plain_ms, out_p = timed_run(
      lambda: gs.generic_bank_scan_epoch_reference(*args32, **kw32), 1)
  e = lane_errs(out_k, out_p, loc)
  ek, ep = (float(lane_errs(o, ref64, loc).median()) for o in (out_k, out_p))
  b32, by32 = bound(io_bytes([args32, [v for k, v in kw32.items()
                                       if k != "spec"], out_k], 4),
                    call_ops("epoch", loc, slots, CMP_T, Q=LocKalman.Q,
                             R_list=kw["R_list"], structure=kw["structure"]))
  log(f"generic_bank_scan_epoch [loc B={GEN_B} T={CMP_T}, float32]: kernel "
      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b32:.4g} ms ({by32}); "
      f"kernel vs plain median lane {float(e.median()):.4g} sigma, max "
      f"{float(e.max()):.4g}; against float64: kernel median {ek:.4g}, "
      f"plain median {ep:.4g}")
  # its launch shape and raw launches (no wrapper: no checks, no copies)
  # on the same float32 inputs
  call5 = loc_epoch_call()
  src5 = call5.source(torch.float32)
  raw = {n: timed_run(generic_launch(
      src5, call5, args32[0], args32[1], args32[2][:n], args32[3][:n],
      eas=kw32["eas"][:n]), 20 if n == 1 else 5)[0] for n in (CMP_T, 1)}
  log(variant_line("generic_bank_scan_epoch [loc, float32]",
                   _build.generated_info(src5), GEN_B, raw))

  # held in float32 at local scale (see LOC_LOCAL_M)
  x, P, zs, eas, dts = (a.float() for a in loc_local_case(torch, dev, gen))
  run("generic_bank_scan_epoch", "", "", loc, gs.generic_bank_scan_epoch,
      gs.generic_bank_scan_epoch_reference, (x, P, zs, dts),
      dict(eas=eas, **kw),
      f"loc B={GEN_B} T={CMP_T} epochs of 4 + 4 slots, float32, satellites "
      f"{LOC_LOCAL_M:g} m away", call_ops(
          "epoch", loc, slots, CMP_T, Q=LocKalman.Q, R_list=kw["R_list"],
          structure=kw["structure"]))

  # the main path's loc steps again: the float32 kernel may lose at most
  # LOC_SHARE_RATIO times (+ LOC_SHARE_SLACK) the float32 plain version's
  # share of lanes over LOC_FAR_M off; the double kernel, the float64
  # plain version's to LOC64_SHARE_DIFF
  zs, eas, x_k32 = states["loc_run"]
  zs, eas = bank_minor(zs, eas, torch.float32)
  dts32 = torch.full((LOC_T,), 0.1, **f32)
  x_p32, _ = gs.generic_bank_scan_epoch_reference(
      *loc_bank(torch.float32), zs, dts32, eas=eas, **kw)
  x_p64, _ = gs.generic_bank_scan_epoch_reference(
      *loc_bank(torch.float64), zs.double(), dts32.double(), eas=eas.double(),
      **kw)
  x_k64, _ = gs.generic_bank_scan_epoch(
      *loc_bank(torch.float64), zs.double(), dts32.double(), eas=eas.double(),
      **kw)
  truth = torch.as_tensor(LocKalman.initial_x[:3], **f64)[:, None]
  far = {name: float(((x[0:3].double() - truth).norm(dim=0)
                      > LOC_FAR_M).double().mean())
         for name, x in (("kernel f32", x_k32), ("plain f32", x_p32),
                         ("kernel f64", x_k64), ("plain f64", x_p64))}
  ok = (far["kernel f32"] <= LOC_SHARE_RATIO * far["plain f32"]
        + LOC_SHARE_SLACK
        and abs(far["kernel f64"] - far["plain f64"]) <= LOC64_SHARE_DIFF)
  log(f"loc main-path data [B={GEN_B}, T={LOC_T} epochs from the prior]: "
      f"share of lanes over {LOC_FAR_M:g} m: "
      + ", ".join(f"{k} {v:.6f}" for k, v in far.items())
      + f" (float32 kernel at most {LOC_SHARE_RATIO} x plain + "
      f"{LOC_SHARE_SLACK}; float64 within {LOC64_SHARE_DIFF}) -> "
      f"{'ok' if ok else 'FAIL'}")
  checks.append(("loc main-path lanes over 100 m", ok))

  bad = [name for name, ok in checks if not ok]
  require(not bad, f"generic kernels agree with their plain versions and "
                   f"the hand kernels: {bad}")
  return rows


def kernel_variants(torch, dev, gen, live_spec, states, reps=20):
  """Kernel 4's variants on the main paths (mode 'single'), kernel 6's
  (mode 'mixed': the live spec's 4-kind cycle, and both MSCKF models' VIO
  schedule with camera frames) and kernel 7's (mode 'frame', both MSCKF
  models): the design each took (tile or global), its warps, shared
  memory a block, blocks an SM, registers and local bytes as the CUDA
  runtime reads them, and its time (raw launches, CUDA events) at
  T = CMP_T and T = 1, from the main path's car, live and live mixed banks
  or a fresh bank (loc, msckf_eskf, the VIO and frame banks) with data of
  the main path's kind. Every float32 variant of these modes the smoke
  builds must be a tile."""
  from rednose_tpu_torch import _build

  CarKalman, LocKalman, _, _ = generic_models()
  ESKF = msckf_models()[1]
  f32 = dict(dtype=torch.float32, device=dev)
  calls = generic_calls(live_spec)
  calls["msckf_eskf observe POSITION (kernel 4)"] = msckf_position_call()
  T = CMP_T

  def fresh(model, xs):
    return (torch.as_tensor(xs.T, **f32).contiguous(),
            torch.as_tensor(np.diag(model.initial_P_diag), **f32)[
                :, :, None].repeat(1, 1, xs.shape[0]))

  _, zs, pss = car_data(torch, dev, T, SEED + 6)
  x_loc, P_loc = fresh(LocKalman, np.tile(LocKalman.initial_x, (GEN_B, 1)))
  truth = torch.as_tensor(LocKalman.initial_x[:3], **f32)[None, :, None]
  sats = truth + 2.0e7 * torch.randn((T, 3, GEN_B), generator=gen, **f32)
  x_live, P_live = states["live"]
  xs = msckf_bank_x0(ESKF, SEED + 7)
  x_es = torch.as_tensor(xs.T, **f32).contiguous()
  P_es = MSCKF_P0 * torch.eye(36, **f32)[:, :, None].repeat(1, 1, MSCKF_B)
  inputs = {
      "car run (kernel 4)": (
          *states["car"], zs.permute(0, 2, 1).contiguous(),
          torch.full((T,), 0.05, **f32), None, torch.as_tensor(pss, **f32),
          None),
      "loc observe (kernel 4)": (
          x_loc, P_loc, (sats - truth).norm(dim=1, keepdim=True), torch.full(
              (T,), 0.1, **f32), sats, None, None),
      "live run, gate on (kernel 4)": (
          x_live, P_live, (x_live[None, 0:3] + 5.0 * torch.randn(
              (T, 3, GEN_B), generator=gen, **f32)).contiguous(),
          torch.full((T,), 0.01, **f32), None, None, None),
      "msckf_eskf observe POSITION (kernel 4)": (
          x_es, P_es, (x_es[None, 0:3] + torch.randn(
              (T, 3, MSCKF_B), generator=gen, **f32)).contiguous(),
          torch.full((T,), MSCKF_DT, **f32), None, None, None),
  }
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, T)
  inputs["live run_mixed (kernel 6)"] = (
      *states["live_mixed"], zs_m.permute(0, 2, 1).contiguous(),
      torch.full((T,), 0.01, **f32), None, None,
      torch.as_tensor(kind_idx, dtype=torch.int32, device=dev))
  # the full-Q variants on the same banks and data (kernel 6's kind_idx
  # into its 8 kinds)
  from rednose_tpu_torch.runtime.live_bank import LIVE_KINDS

  inputs["live full Q run (kernel 4)"] = inputs[
      "live run, gate on (kernel 4)"]
  inputs["live full Q run_mixed / observe (kernel 6)"] = (
      *inputs["live run_mixed (kernel 6)"][:6],
      torch.as_tensor([LIVE_KINDS.index(kinds[i]) for i in kind_idx],
                      dtype=torch.int32, device=dev))
  vio_ki = vio_kind_idx(T)
  for model in msckf_models():
    name = f"{model.name} run_mixed with frames (kernel 6)"
    spec, _, _, R = msckf_setup(model)
    xs = msckf_bank_x0(model, SEED + 8)
    zs_v, eas_v, _ = msckf_frames(torch, dev, gen, model, xs, T, R,
                                  frames=vio_ki.astype(bool))
    calls[name] = vio_call(model)
    inputs[name] = (
        torch.as_tensor(xs.T, **f32).contiguous(),
        (MSCKF_P0 * torch.eye(spec.dim_err, **f32))[:, :, None].repeat(
            1, 1, MSCKF_B),
        zs_v.transpose(1, 2).to(**f32).contiguous(),
        torch.full((T,), MSCKF_DT, **f32), eas_v.transpose(1, 2).to(
            **f32).contiguous(), None,
        torch.as_tensor(vio_ki, dtype=torch.int32, device=dev))
  for model in msckf_models():
    name = f"{model.name} run_frames (kernel 7)"
    spec, _, _, R = msckf_setup(model)
    xs = msckf_bank_x0(model, SEED + 9)
    zs_f, eas_f, _ = msckf_frames(torch, dev, gen, model, xs, T, R)
    calls[name] = msckf_call(model)
    inputs[name] = (
        torch.as_tensor(xs.T, **f32).contiguous(),
        (MSCKF_P0 * torch.eye(spec.dim_err, **f32))[:, :, None].repeat(
            1, 1, MSCKF_B),
        zs_f.transpose(1, 2).to(**f32).contiguous(),
        torch.full((T,), MSCKF_DT, **f32), eas_f.transpose(1, 2).to(
            **f32).contiguous(), None, None)
  out = {}
  for name, (x, P, zs, dts, eas, pss, ki) in inputs.items():
    call = calls[name]
    src = call.source()
    info = _build.generated_info(src)

    def launch(n):
      cut = lambda a: None if a is None else a[:n]  # noqa: E731
      return generic_launch(src, call, x, P, zs[:n], dts[:n], cut(eas),
                            cut(pss), cut(ki))

    ms = {n: timed_run(launch(n), reps if n == 1 else 5)[0] for n in (T, 1)}
    out[name] = dict(info, ms=ms[T], ms_T1=ms[1])
    log(variant_line(name, info, x.shape[-1], ms))
    require(info["design"] == 1, f"{name}: the float32 variant is a tile")
  # msckf_eskf's POSITION tile (a 36 x 36 P, one block an SM) against its
  # plain version, as compare_generic holds the car and live variants
  from rednose_tpu_torch.ops import generic_scan as gs

  name = "msckf_eskf observe POSITION (kernel 4)"
  call, n, checks = calls[name], MSCKF_CMP_T, []
  x, P, zs, dts = inputs[name][:4]
  kernel_vs_plain(
      "generic_bank_scan", "", "", call.spec, gs.generic_bank_scan,
      gs.generic_bank_scan_reference, (x, P, zs[:n], dts[:n]),
      dict(spec=call.spec, kind=MSCKF_POS, Q=call.Q, R=call.R_list[0],
           structure=call.structure),
      f"msckf_eskf POSITION B={MSCKF_B} T={n}",
      step_ops(call.counting_source(), (MSCKF_POS,)) * n * MSCKF_B,
      checks=checks, reps=5)
  require(all(ok for _, ok in checks),
          "msckf_eskf's POSITION tile agrees with its plain version")
  return out


def variant_line(name, info, B, ms):
  """The log line of a generic variant's launch shape (generated_info) and
  raw-launch times ms {T: ms}, at its T and at T = 1."""
  T = max(ms)
  return (f"{name}: design {'tile' if info['design'] else 'global'}, "
          f"{info['warps']} warps a block of {info['threads']} threads, "
          f"{info['smem_bytes']} B of shared memory a block, "
          f"{info['blocks_per_sm']} blocks an SM, {info['registers']} "
          f"registers, {info['local_bytes']} B local a thread; raw launches "
          f"B={B} T={T} {ms[T]:.4f} ms, T=1 {ms[1]:.4f} ms")


def is_tile(source):
  """Whether an emitted source is the tile form (its design line)."""
  return "\n// design: tile," in source


def tile_vs_global(name, call, spec, args, kw, checks, tol=GEN_TOL):
  """A camera-frame variant's tile against its global form (one thread a
  filter, P in global memory: the design before the tile; the same
  emitted phases) on the same inputs, each a fresh launch: passes when
  every lane is within tol sigmas of the global form's result, which is
  appended to checks. Both timed (raw launches, CUDA events) at the
  inputs' T and at T = 1. Returns {form: (ms at T, ms at T = 1)}."""
  x, P, zs, dts = args
  T = dts.shape[0]
  outs, ms = {}, {}
  for form, src in (("tile", call.source(x.dtype)),
                    ("global", call.source(x.dtype, tile=False))):
    def launch(n, src=src):
      return generic_launch(src, call, x, P, zs[:n], dts[:n],
                            **{k: v[:n] for k, v in kw.items()})

    outs[form] = launch(T)()
    ms[form] = tuple(timed_run(launch(n), 20 if n == 1 else 5)[0]
                     for n in (T, 1))
  err = float(lane_errs(outs["tile"], outs["global"], spec).max())
  ok = err <= tol
  log(f"{name}: tile against its global form on the same {x.dtype} inputs "
      f"{err:.4g} sigma (tolerance {tol}) -> {'ok' if ok else 'FAIL'}; "
      f"raw launches T={T}: tile {ms['tile'][0]:.4f} ms, global "
      f"{ms['global'][0]:.4f} ms; T=1: tile {ms['tile'][1]:.4f} ms, global "
      f"{ms['global'][1]:.4f} ms")
  checks.append((f"{name}: tile against its global form", ok))
  return ms


# ------------------------------------------------------------ MSCKF bank

def msckf_models():
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
  from rednose_tpu_torch.models.msckf_vo import MSCKFVisualOdometry

  return MSCKFVisualOdometry, MSCKFEskf


def msckf_setup(model):
  """(spec, T, Q, R) of the model's bench.py entry: msckf_vo with
  Q = 1e-6 I and R = 0.02^2 I (bench.py:449-486), msckf_eskf with the
  model's Q and R = 0.01^2 I (bench.py:551-578)."""
  spec = model.build_spec()
  dz = spec.obs[MSCKF_KIND].dz
  if model.name == "msckf_vo":
    return spec, VO_T, 1e-6 * np.eye(spec.dim_err), 0.02**2 * np.eye(dz)
  return spec, ESKF_T, model.Q, 0.01**2 * np.eye(dz)


def msckf_call(model, Q=None, R=None):
  """Kernel 7's call as MSCKFBank(model).run_frames makes it for the bench
  entry, or with another Q or R of the same pattern (a planted fault:
  run-time values, the same build)."""
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  spec, _, Q0, R0 = msckf_setup(model)
  return gs.KernelCall(
      spec, "frame", (MSCKF_KIND,), Q=Q0 if Q is None else Q,
      R_list=(R0 if R is None else R,),
      structure=sparsity.structure_for(spec, model.initial_x))


def msckf_position_call():
  """Kernel 4's call for msckf_eskf's position fixes (MSCKFBank.observe)."""
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  ESKF = msckf_models()[1]
  eskf = ESKF.build_spec()
  return gs.KernelCall(
      eskf, "single", (MSCKF_POS,), Q=msckf_setup(ESKF)[2],
      R_list=(ESKF.obs_noise[MSCKF_POS],),
      structure=sparsity.structure_for(eskf, ESKF.initial_x))


def msckf_sources():
  """The emitted sources the MSCKF path launches: kernel 7 for both models
  and kernel 4 for msckf_eskf's position fixes (observe)."""
  VO, ESKF = msckf_models()
  return {
      "msckf_vo run_frames (kernel 7)": msckf_call(VO).source(),
      "msckf_eskf run_frames (kernel 7)": msckf_call(ESKF).source(),
      "msckf_eskf observe POSITION (kernel 4)":
          msckf_position_call().source(),
  }


def msckf_bank_x0(model, seed, batch=MSCKF_B):
  """(batch, dim_x) per-lane states of the bench entry: x0 (msckf_vo: a
  small main state and clones 0.3 m apart; msckf_eskf: the model's x0 with
  the clones spread 0.5 m) plus 0.02 noise, quaternions renormalized."""
  spec = model.build_spec()
  rng = np.random.RandomState(seed)
  if model.name == "msckf_vo":
    x0 = np.concatenate([[0.1, -0.2, 0.05], MSCKF_V,
                         0.3 * rng.randn(spec.n_augment * spec.dim_augment)])
  else:
    x0 = np.asarray(model.initial_x, np.float64).copy()
    x0[7:10] = MSCKF_V
    for a in range(spec.n_augment):
      o = spec.dim_main + spec.dim_augment * a
      x0[o:o + 3] += 0.5 * rng.randn(3)
  xs = np.tile(x0, (batch, 1)) + 0.02 * rng.randn(batch, spec.dim_x)
  for idx in spec.quaternion_idxs:
    xs[:, idx:idx + 4] /= np.linalg.norm(xs[:, idx:idx + 4], axis=1,
                                         keepdims=True)
  return xs


def msckf_frames(torch, dev, gen, model, xs, T, R, frames=None,
                 aheads=None):
  """Consistent camera frames for a bank at xs (B, dim_x) with P = P0 I:
  each lane's truth starts at err(x, MSCKF_TRUTH sqrt(P0) n), n standard
  normal, then per step moves by the model's f. At a camera frame it sees
  a landmark ahead of its newest clone (z = h(truth, landmark) plus noise
  at R's sigma) and rolls its window: 6 m ahead with 0.1 m of spread, or
  aheads[f] (B, 3) for the f-th frame, in the camera frame (rotated by the
  clone's attitude where the model has one). frames (T,) bool: which
  steps are camera frames (default all); the others are position fixes,
  z[:, :3] = the truth's position plus unit noise (R = I), the rest of the
  row 0. Float64 on the card. Returns (zs (T, B, dz), eas (T, B, 3), 0 on
  fix steps, truths: the (B, dim_x) truth after each step)."""
  from torch.func import vmap

  from rednose_tpu_torch.ops.quaternion import normalize_slices, quat_to_rot

  spec = model.build_spec()
  om = spec.obs[MSCKF_KIND]
  f64 = dict(dtype=torch.float64, device=dev)
  B = xs.shape[0]
  x = torch.as_tensor(xs, **f64)
  n = torch.randn((B, spec.dim_err), generator=gen, **f64)
  x = vmap(lambda xx, dd: spec.err({}, xx, dd))(
      x, MSCKF_TRUTH * MSCKF_P0 ** 0.5 * n)
  norm = vmap(lambda xx: normalize_slices(xx, spec.quaternion_idxs))
  x = norm(x)
  d1, d3 = spec.dim_main, spec.dim_augment
  newest = d1 + d3 * (spec.n_augment - 1)
  sigma = float(np.sqrt(R[0, 0]))
  zs, eas, truths = [], [], []
  n_frames = 0
  for t in range(T):
    x = norm(vmap(lambda xx: spec.f({}, xx, MSCKF_DT))(x))
    if frames is not None and not frames[t]:
      z = x[:, 0:3] + torch.randn((B, 3), generator=gen, **f64)
      zs.append(torch.cat([z, torch.zeros((B, om.dz - 3), **f64)], dim=1))
      eas.append(torch.zeros((B, 3), **f64))
      truths.append(x)
      continue
    if aheads is None:
      ahead = torch.tensor([1.0, 0.5, 6.0], **f64) + 0.1 * torch.randn(
          (B, 3), generator=gen, **f64)
    else:
      ahead = aheads[n_frames]
    n_frames += 1
    if spec.quaternion_idxs:
      rot = vmap(quat_to_rot)(x[:, newest + 3:newest + 7])
      ahead = torch.einsum("bij,bj->bi", rot, ahead)
    ea = x[:, newest:newest + 3] + ahead
    z = vmap(lambda xx, ee: om.h({}, xx, ee))(x, ea)
    zs.append(z + sigma * torch.randn(z.shape, generator=gen, **f64))
    eas.append(ea)
    x = torch.cat([x[:, :d1], x[:, d1 + d3:], x[:, :d3]], dim=1)
    truths.append(x)
  return torch.stack(zs), torch.stack(eas), truths


def msckf_lost_lanes(torch, spec, bank_x, bank_P, truth):
  """(B,) bool: the lanes whose error state against the truth is beyond
  MSCKF_FAR sigmas in some component, or not finite. bank_x (dim_x, B),
  bank_P (de, de, B), truth (B, dim_x)."""
  from torch.func import vmap

  e = vmap(lambda n, t: spec.inv_err({}, n, t))(bank_x.T.double(), truth)
  sd = torch.diagonal(bank_P.double(), dim1=0, dim2=1).sqrt()   # (B, de)
  return ~((e.abs() / sd) <= MSCKF_FAR).all(dim=1)


def msckf_lost(torch, spec, bank_x, bank_P, truth):
  """Share of the lanes msckf_lost_lanes counts lost."""
  return float(msckf_lost_lanes(torch, spec, bank_x, bank_P,
                                truth).double().mean())


def msckf_healthy(torch, name, bank, truth):
  """The lanes lost (beyond MSCKF_FAR sigmas of their truth, or not
  finite) are at most MSCKF_LOST_SHARE; a lane that went non-finite is
  flagged by diverged() and reset_diverged() re-seeds exactly those;
  every other P is exactly symmetric. Returns (lost share, lanes
  reset)."""
  torch.cuda.synchronize()
  lost = msckf_lost(torch, bank.spec, bank._x, bank._P, truth)
  require(lost <= MSCKF_LOST_SHARE,
          f"{name}: {lost} of lanes lost (beyond {MSCKF_FAR} sigma of "
          "their truth, or not finite)")
  finite = (torch.isfinite(bank._x).all(dim=0)
            & torch.isfinite(bank._P).all(dim=1).all(dim=0))
  bad = bank.diverged()
  require(bool((finite | bad).all()),
          f"{name}: every non-finite lane is flagged diverged")
  P = bank._P[:, :, ~bad]
  require(torch.equal(P, P.transpose(0, 1)), f"{name} P symmetric")
  reset = bank.reset_diverged()
  require(reset == int(bad.sum()) and bool(torch.isfinite(bank._x).all()
                                           and torch.isfinite(bank._P).all()),
          f"{name}: reset_diverged re-seeds the diverged lanes")
  return lost, reset


def msckf_main_path(torch, dev, gen):
  """Phase 1, MSCKF bank: MSCKFBank as a user calls it."""
  from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank

  def healthy(name, bank, truth, held=True):
    return msckf_healthy(torch, name, bank, truth)

  for model in msckf_models():
    spec, T, Q, R = msckf_setup(model)
    xs = msckf_bank_x0(model, SEED)
    n_obs = 8 if model.name == "msckf_eskf" else 0
    zs, eas, truths = msckf_frames(torch, dev, gen, model, xs, T + n_obs, R)
    bank = MSCKFBank(model, batch=MSCKF_B, x0=xs,
                     P_diag=np.full(spec.dim_err, MSCKF_P0), Q=Q, device=dev)
    t0 = time.perf_counter()
    bank.run_frames(np.full(T, MSCKF_DT), zs[:T], eas[:T], R=R)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    lost, reset = healthy(f"{model.name} bank", bank, truths[T - 1])
    msg = (f"{model.name} bank B={MSCKF_B}: run_frames T={T} {ms:.3f} ms "
           f"(host clock, first call); lanes lost {lost:.6f}, {reset} "
           "diverged and reset")
    if n_obs:
      t_base = bank.t
      t0 = time.perf_counter()
      for i in (1, 2, 3, 5, 6, 4, 7, 8):  # the 4th frame arrives late
        require(bank.observe_frame(t_base + MSCKF_DT * i, zs[T + i - 1].cpu(),
                                   eas[T + i - 1].cpu(), R=R) is not None,
                f"observe_frame {i} applied")
      require(abs(bank.t - (t_base + 8 * MSCKF_DT)) < 1e-9,
              "bank time after observe_frame")
      require(bank.observe_frame(t_base - 5.0, zs[T].cpu(), eas[T].cpu(),
                                 R=R) is None, "a too-old frame is dropped")
      # two position fixes (kernel 4): the truth moves on by f
      truth = truths[-1]
      for k in (1, 2):
        truth = torch.func.vmap(lambda xx: spec.f({}, xx, MSCKF_DT))(truth)
        z = truth[:, 0:3] + torch.randn((MSCKF_B, 3), generator=gen,
                                        dtype=torch.float64, device=dev)
        require(bank.observe(bank.t + MSCKF_DT, MSCKF_POS, z.cpu())
                is not None, f"position fix {k} applied")
      torch.cuda.synchronize()
      ms_obs = (time.perf_counter() - t0) * 1e3
      lost, reset = healthy(f"{model.name} bank after observe", bank, truth)
      msg += (f"; then 8 observe_frame (one late) and 2 observe "
              f"{ms_obs:.3f} ms (host clock); lanes lost {lost:.6f}, "
              f"{reset} diverged and reset")
    log(msg)


def compare_msckf(torch, dev, gen, reps=10):
  """Phase 2, MSCKF bank: kernel 7 against its plain version at
  B = MSCKF_B, T = MSCKF_CMP_T on consistent data from a fresh bank, for
  both models: float32 within GEN_TOL sigma, the double build within
  MSCKF64_TOL sigma of the float64 plain version, and planted faults (a
  clone-block Q term, the isotropic R's diagonal, one landmark coordinate,
  one dts entry; run-time values, no extra build) beyond MSCKF64_TOL; the
  float32 tile (and a double one) against its global form on the same
  inputs (tile_vs_global), both timed at T and at T = 1 (an
  observe_frame call)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import generic_scan as gs

  rows, checks = [], []
  T = MSCKF_CMP_T
  for model in msckf_models():
    spec, _, Q, R = msckf_setup(model)
    xs = msckf_bank_x0(model, SEED + 3)
    zs, eas, _ = msckf_frames(torch, dev, gen, model, xs, T, R)
    call = msckf_call(model)
    ops = step_ops(call.counting_source(), (MSCKF_KIND,)) * T * MSCKF_B
    shape = f"{model.name} B={MSCKF_B} T={T} gate on"

    def inputs(dtype, zs=zs, eas=eas, dts=np.full(T, MSCKF_DT)):
      d = dict(dtype=dtype, device=dev)
      return (torch.as_tensor(xs.T, **d).contiguous(),
              (MSCKF_P0 * torch.eye(spec.dim_err, **d))[:, :, None].repeat(
                  1, 1, MSCKF_B),
              zs.transpose(1, 2).to(**d).contiguous(),
              eas.transpose(1, 2).to(**d).contiguous(),
              torch.as_tensor(dts, **d))

    kw = dict(spec=spec, kind=MSCKF_KIND, Q=Q, R=R, structure=call.structure)
    row, _, _ = kernel_vs_plain(
        "vo_bank_scan", "rednose_tpu_torch/csrc/generic_scan.cuh",
        "rednose_tpu/ops/pallas_bank.py:755", spec, gs.vo_bank_scan,
        gs.vo_bank_scan_reference, inputs(torch.float32), kw, shape, ops,
        checks=checks, reps=reps)
    rows.append(row)
    # raw launches, the tile against its global form: T = 1 is an
    # observe_frame call on the bank
    x, P, zs32, eas32, dts32 = inputs(torch.float32)
    tile_vs_global(f"vo_bank_scan [{model.name} B={MSCKF_B}]", call, spec,
                   (x, P, zs32, dts32), dict(eas=eas32), checks)
    args64 = inputs(torch.float64)
    _, _, ref64 = kernel_vs_plain(
        "vo_bank_scan", "", "", spec, gs.vo_bank_scan,
        gs.vo_bank_scan_reference, args64, kw, shape + ", float64", ops,
        MSCKF64_TOL, checks=checks, reps=reps)
    if is_tile(call.source(torch.float64)):
      x, P, zs64, eas64, dts64 = args64
      tile_vs_global(f"vo_bank_scan [{model.name} B={MSCKF_B}, float64]",
                     call, spec, (x, P, zs64, dts64), dict(eas=eas64),
                     checks, MSCKF64_TOL)
    builds = _build.generated_launcher.cache_info().currsize
    Qf = np.array(Q, dtype=np.float64)
    Qf[-1, -1] += 1e-4
    eas_f = eas.clone()
    eas_f[T // 2, :, 2] += 0.01
    dts_f = np.full(T, MSCKF_DT)
    dts_f[T // 3] *= 1.01
    faults = {
        "clone-block Q term": (msckf_call(model, Q=Qf), args64),
        "R diagonal x 1.01": (msckf_call(model, R=1.01 * R), args64),
        "landmark depth + 1 cm": (call, inputs(torch.float64, eas=eas_f)),
        "dts entry x 1.01": (call, inputs(torch.float64, dts=dts_f)),
    }
    miss = {name: float(lane_errs(gs.vo_bank_scan(*args, call=c), ref64,
                                  spec).max())
            for name, (c, args) in faults.items()}
    least = min(miss, key=miss.get)
    ok = (miss[least] > MSCKF64_TOL
          and _build.generated_launcher.cache_info().currsize == builds)
    log(f"vo_bank_scan planted faults [{model.name}, float64]: "
        + ", ".join(f"{k} {v:.4g}" for k, v in miss.items())
        + f" sigma; the least visible must exceed {MSCKF64_TOL}, with no "
        f"extra build -> {'ok' if ok else 'FAIL'}")
    checks.append((f"{model.name} planted faults beyond the limit", ok))
  bad = [name for name, ok in checks if not ok]
  require(not bad, f"kernel 7 agrees with its plain version: {bad}")
  return rows


# ------------------------------------------------------------------- VIO

def cohort_tracker(K, n_tracks, cohort, T, seed=SEED):
  """The synthetic tracker of the JAX package's bench.py (:653-696):
  cohorts of `cohort` tracks at slots [1 + a * cohort, ...), each track
  observed from the K poses of a shared camera path (exact pinhole
  projections of its landmark), slot 0 reserved. At frame t block t % K
  was completed the frame before (harvested at its start) and takes the
  new cohort, block (t + 1) % K completes, the others grow. Returns
  (tracks0 (n_tracks, K+1, 5) the steady-state store before frame 0, feats
  (T, K * cohort, 5) the frames' feature rows, land (n_tracks, 3) the
  landmarks, poses (K, 7)), numpy float64."""
  rng = np.random.RandomState(seed)
  poses = np.zeros((K, 7))
  poses[:, 0] = 0.2 * np.arange(K)
  poses[:, 1] = -0.1 * np.arange(K)
  poses[:, 3] = 1.0  # identity attitude
  land = np.array([1.0, 2.0, 10.0])[None] + np.concatenate(
      [0.5 * rng.randn(n_tracks, 2), 1.0 + 0.2 * rng.randn(n_tracks, 1)],
      axis=1)
  rel = land[:, None, :] - poses[None, :, :3]
  uv_table = rel[..., :2] / rel[..., 2:3]        # (n_tracks, K, 2)
  tracks0 = np.zeros((n_tracks, K + 1, 5))
  tracks0[0, 0, 0] = -1.0                        # reserved slot 0
  for a in range(K):
    slots = np.arange(1 + a * cohort, 1 + (a + 1) * cohort)
    count = K - a
    tracks0[slots, 0, 0] = count                 # H_COUNT
    tracks0[slots, 0, 1] = slots                 # H_LAST_ID
    if a == 0:
      tracks0[slots, 0, 3:5] = 1.0               # complete and valid
    for c in range(count):
      tracks0[slots, 1 + c, 2:4] = uv_table[slots, c]
  feats = np.full((T, K * cohort, 5), -1.0)
  for t in range(T):
    for a in range(K):
      blk = (t + a) % K
      slots = np.arange(1 + blk * cohort, 1 + (blk + 1) * cohort)
      rows = slice(a * cohort, (a + 1) * cohort)
      feats[t, rows, 1] = slots                  # next_id
      feats[t, rows, 4] = slots                  # match
      feats[t, rows, 2:4] = uv_table[slots, 0 if a == 0 else K - a]
  return tracks0, feats, land, poses


def vio_store_path(torch, dev):
  """The VIO path's store at the reference design point, float64 on the
  card: per frame harvest_complete -> reset_seen -> empty_slots ->
  merge_features -> compute_pos_batch of the harvested tracks over the
  tracker's camera path (bench.py:653-664), kernel 8, one launch a frame.
  Every frame: exactly STORE_COHORT tracks harvested, none dropped,
  STORE_FEATS live after the merge, at least TRI_CONVERGED of the
  triangulations converged and those within TRI_TOL_M of their landmark.
  Returns (positions (STORE_FRAMES, STORE_COHORT, 3) of each frame's
  harvested tracks in slot order, a track that did not converge at the
  bench's fallback (1, 2, 11), the tracker's poses, and the first and
  last frames' triangulation inputs for compare_triangulation)."""
  from rednose_tpu_torch.msckf import feature_handler as fh
  from rednose_tpu_torch.msckf.triangulation import compute_pos_batch

  K, cohort, M = STORE_K, STORE_COHORT, STORE_M
  tracks0, feats, land, poses = cohort_tracker(
      K, STORE_TRACKS, cohort, STORE_FRAMES)
  f64 = dict(dtype=torch.float64, device=dev)
  tracks = torch.as_tensor(tracks0, **f64)
  feats = torch.as_tensor(feats, **f64)
  land = torch.as_tensor(land, **f64)
  poses_m = torch.as_tensor(poses, **f64).expand(M, K, 7)
  to_c = torch.eye(3, **f64)
  fallback = torch.tensor([1.0, 2.0, 11.0], **f64)
  positions, secs, worst, conv_min, cases = [], [], 0.0, 1.0, {}
  torch.cuda.synchronize()
  for t in range(STORE_FRAMES):
    t0 = time.perf_counter()
    idxs, uv, tracks = fh.harvest_complete(tracks, M)
    tracks = fh.reset_seen(tracks)
    empty = fh.empty_slots(tracks, STORE_FEATS)
    tracks, dropped = fh.merge_features(tracks, feats[t], empty)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n = compute_pos_batch.launches
    pos, ok = compute_pos_batch(to_c, poses_m, uv)
    torch.cuda.synchronize()
    secs.append((t1 - t0, time.perf_counter() - t1))
    require(compute_pos_batch.launches == n + 1,
            f"store frame {t}: the triangulation launched kernel 8 once")
    if t in (0, STORE_FRAMES - 1):
      cases[f"frame {t}"] = (to_c, poses_m, uv, idxs < STORE_TRACKS)
    real = idxs < STORE_TRACKS
    n_harvest = int(real.sum())
    live = int((tracks[:, 0, fh.H_COUNT] > 0).sum())
    require(n_harvest == cohort and int(dropped) == 0 and live == STORE_FEATS,
            f"store frame {t}: {n_harvest} harvested, {int(dropped)} "
            f"dropped, {live} live (want {cohort}, 0, {STORE_FEATS})")
    idx = idxs[:cohort]
    ok = ok[:cohort]
    err = (pos[:cohort] - land[idx]).norm(dim=1)
    conv = float(ok.double().mean())
    far = float(err[ok].max()) if bool(ok.any()) else float("inf")
    require(conv >= TRI_CONVERGED and far <= TRI_TOL_M,
            f"store frame {t}: {conv} of triangulations converged, the "
            f"worst converged {far} m off its landmark (want >= "
            f"{TRI_CONVERGED} and <= {TRI_TOL_M} m)")
    worst, conv_min = max(worst, far), min(conv_min, conv)
    positions.append(torch.where(ok[:, None], pos[:cohort], fallback))
  legs = np.array(secs[1:]) * 1e3          # (frames, [store, triangulate])
  log(f"VIO store {STORE_TRACKS} tracks x {STORE_FEATS} features, K={K}, "
      f"float64: {STORE_FRAMES} frames of harvest + merge + triangulation "
      f"(kernel 8) of {cohort} tracks, host clock per frame: first "
      f"{sum(secs[0]) * 1e3:.3f} ms, mean of the others "
      f"{legs.sum(axis=1).mean():.3f} ms (store legs {legs[:, 0].mean():.3f}"
      f" ms, triangulation {legs[:, 1].mean():.3f} ms), max "
      f"{legs.sum(axis=1).max():.3f} ms; least converged share "
      f"{conv_min:.6f}, worst converged landmark error {worst:.4g} m")
  return torch.stack(positions), poses, cases


def tri_tracks(seed, n, K):
  """The track family of tests/test_torch_triangulation_kernel.py::tracks
  with the camera moving (numpy float64, poses (n, K, 7), uv (n, K, 2)):
  each track a camera path from a random base at a random velocity of
  ~0.5 m a frame with small random attitudes (quaternions of random norm),
  a landmark 3-20 m ahead of the last frame observed in every frame with
  noise of 1e-3; row 0 a sentinel (u = v = 0 in every frame), row 1
  noise. At K = 8 a few tracks in a hundred run all MAX_ITERS
  iterations: the long-tail batch."""
  rng = np.random.RandomState(seed)
  poses, uv, to_c = np.zeros((n, K, 7)), np.zeros((n, K, 2)), np.eye(3)
  for i in range(n):
    base, vel = rng.randn(3), 0.5 * rng.randn(3)
    for k in range(K):
      q = np.concatenate([[1.0], 0.05 * rng.randn(3)])
      poses[i, k, 3:7] = q * rng.uniform(0.5, 2.0)
      poses[i, k, :3] = base + vel * k
    depth, u0, v0 = rng.uniform(3, 20), *(0.3 * rng.randn(2))
    lm = poses[i, -1, :3] + quat_rot(poses[i, -1, 3:7]) @ to_c.T @ (
        depth * np.array([u0, v0, 1.0]))
    for k in range(K):
      pc = to_c @ quat_rot(poses[i, k, 3:7]).T @ (lm - poses[i, k, :3])
      uv[i, k] = pc[:2] / pc[2] + 1e-3 * rng.randn(2)
  uv[0] = 0.0
  uv[1] = 3.0 * rng.randn(K, 2)
  return poses, uv


def quat_rot(q):
  """Rotation matrix of the normalised quaternion (w, x, y, z), numpy."""
  w, x, y, z = q / np.linalg.norm(q)
  return np.array([
      [w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
       2 * (x * z + w * y)],
      [2 * (x * y + w * z), w * w - x * x + y * y - z * z,
       2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x),
       w * w - x * x - y * y + z * z]])


def kernel8_launch(lib, to_c, poses, uv):
  """A launch of kernel 8 from `lib` (triangulate_launch) into outputs
  made once, with no checks between launches: a timing of repeated calls
  is the kernel's own. Returns the zero-argument launch, which returns
  (positions, converged, iterations)."""
  import torch

  from rednose_tpu_torch import _build

  N, K = poses.shape[:2]
  pos = torch.empty((N, 3), dtype=poses.dtype, device=poses.device)
  conv = torch.empty((N,), dtype=torch.bool, device=poses.device)
  iters = torch.empty((N,), dtype=torch.int32, device=poses.device)
  args = (to_c.data_ptr(), poses.data_ptr(), *poses.stride(), uv.data_ptr(),
          *uv.stride(), pos.data_ptr(), conv.data_ptr(), iters.data_ptr(),
          N, K, int(poses.dtype == torch.float64),
          torch.cuda.current_stream(poses.device).cuda_stream)

  def launch():
    _build.check(lib.triangulate_launch(*args), "kernel 8")
    return pos, conv, iters

  return launch


def kernel8_floor(lib, N, K):
  """The launch floor: an empty kernel on kernel 8's grid for N tracks of
  K frames (entry triangulate_floor_launch of `lib`, a timing aid)."""
  import torch

  from rednose_tpu_torch import _build

  stream = torch.cuda.current_stream().cuda_stream
  return lambda: _build.check(lib.triangulate_floor_launch(N, K, stream),
                              "kernel 8's launch floor")


def queued_ms(fn, reps=TRI_REPS, batches=TRI_BATCHES):
  """The device's time of fn, apart from the host's: each of `batches`
  batches queues `reps` calls behind torch.cuda._sleep(TRI_SLEEP_CYCLES),
  so that the host has enqueued them all before the first runs, and times
  them with CUDA events. Returns (mean, min, max over the batches of the
  ms a call, the host's ms a call to enqueue, whether every batch's sleep
  outlasted its enqueue)."""
  import torch

  fn()
  torch.cuda.synchronize()
  dev, host, queued = [], [], True
  for _ in range(batches):
    e0, start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
    e0.record()
    torch.cuda._sleep(TRI_SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
      fn()
    t_host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    dev.append(start.elapsed_time(end) / reps)
    host.append(t_host * 1e3 / reps)
    queued &= e0.elapsed_time(start) > t_host * 1e3
  return (sum(dev) / batches, min(dev), max(dev), sum(host) / batches,
          queued)


def wrapped_ms(fn, reps=TRI_REPS):
  """Host clock of fn followed by a synchronize, a call at a time: (mean,
  min, max ms)."""
  import torch

  fn()
  torch.cuda.synchronize()
  ts = []
  for _ in range(reps):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ts.append((time.perf_counter() - t0) * 1e3)
  return sum(ts) / reps, min(ts), max(ts)


def tri_tail_case(torch, dev):
  """The long-tail batch on the card: TRI_TAIL_N tracks of tri_tracks at
  K = TRI_TAIL_K, float64 (to_c, poses, uv)."""
  poses, uv = tri_tracks(SEED, TRI_TAIL_N, TRI_TAIL_K)
  f64 = dict(dtype=torch.float64, device=dev)
  return (torch.eye(3, **f64), torch.as_tensor(poses, **f64),
          torch.as_tensor(uv, **f64))


def compare_triangulation(torch, cases):
  """Phase 2, kernel 8 against its plain version on the VIO store's first
  and last frames, all STORE_M rows, and on the long-tail batch
  (tri_tail_case: TRI_TAIL_N tracks at K = TRI_TAIL_K, some running all
  MAX_ITERS iterations). The plain version on the host, the reference
  semantics of the CPU tests (where the kernel's host build equals it):
  converged flags equal, non-finite entries where it has them, and the
  float64 positions of the tracks both converge in as many iterations
  within TRI64_TOL_M, on every row. The plain version on the card: the
  same on the harvested rows (every row of the long-tail batch). On the
  padding rows (u = v = 0 in every frame) the first step takes rho to 0
  exactly in the kernel and the host's plain version, which report NaN;
  the card's plain version (cuBLAS products) lands next to 0, as JAX's
  does, and reports a point ~1e32 m away as converged: printed, not
  held. On the long-tail batch the tracks both converge in as many
  iterations, more than TRI_TAIL_SLOW, are held within TRI_TAIL_TOL_M (a
  slow track parts by up to 2.5e-7 m on the host), and a row that
  neither program converges and that is NaN in one only counts among the
  rows apart (1 of 768 rows on the host). The rows apart, those whose
  iteration counts differ (at most TRI_ITER_SHARE of the rows held), are
  printed and, where both converge, held within TRI_TOL_M. The kernel's
  outputs on the store's stride-0 window (the window set up once a
  block) bitwise those on its contiguous copy (set up per track). Timed:
  the raw device time (kernel8_launch queued behind a sleep, queued_ms),
  the launch floor (kernel8_floor, queued alike), the wrapped time
  (compute_pos_batch as the VIO path calls it, host clock after a
  synchronize, wrapped_ms) and the wrapper's host time a call
  (tri._launch queued behind a sleep); the plain version on the card one
  run. The bound from the closed form's operations at the iterations run
  (float64 peak) or the bytes of poses (their storage), uv and the
  outputs. Returns the store's last frame's row (ms: the raw device
  time)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.msckf import triangulation as tri

  lib = _build.library()
  to_c, poses, uv = tri_tail_case(torch, cases["frame 0"][0].device)
  cases = dict(cases) | {"long-tail batch": (
      to_c, poses, uv, torch.ones(poses.shape[0], dtype=torch.bool,
                                  device=poses.device))}
  row = None
  for label, (to_c, poses, uv, real) in cases.items():
    N, K = poses.shape[:2]
    kp, kc, ki = tri._launch(to_c, poses, uv)
    plain_ms, (gp, gc, gi) = timed_run(
        lambda: tri._reference_iters(to_c, poses, uv), 1)
    hp, hc, hi = (a.to(kp.device) for a in tri._reference_iters(
        to_c.cpu(), poses.cpu(), uv.cpu()))
    raw = queued_ms(kernel8_launch(lib, to_c, poses, uv))
    floor = queued_ms(kernel8_floor(lib, N, K))
    wrapped = wrapped_ms(lambda: tri.compute_pos_batch(to_c, poses, uv))
    host = queued_ms(lambda: tri._launch(to_c, poses, uv))
    tail = label == "long-tail batch"
    window = poses.stride(0) == 0
    per_track = (tri._launch(to_c, poses.contiguous(), uv) if window
                 else (kp, kc, ki))
    same_bits = all(torch.equal(a, b) for a, b in
                    zip((kp.nan_to_num(7.0), kc, ki),
                        (per_track[0].nan_to_num(7.0), *per_track[1:])))

    # each row's tolerance where both converge in as many iterations
    tol = torch.where(tail & (ki > TRI_TAIL_SLOW), TRI_TAIL_TOL_M,
                      TRI64_TOL_M).to(kp.dtype)

    def held(pp, pc, pi, rows):
      """(flags equal, non-finite equal, max position error of the tracks
      both converge in as many iterations, whether each is within its
      tolerance, their number, rows apart, max position error of those
      both converge in) on `rows`."""
      same = (ki == pi) & rows
      if tail:   # a track neither converges: NaN in one only is apart
        same &= (kc | pc | (kp.isfinite().all(dim=1)
                            == pp.isfinite().all(dim=1)))
      both, apart = kc & pc & same, kc & pc & ~same & rows
      err = (kp - pp).abs().amax(dim=1)
      fin = same & rows if tail else rows
      return (bool(torch.equal(kc[rows], pc[rows])),
              bool(torch.equal(kp[fin].isfinite(), pp[fin].isfinite())),
              float(err[both].max()) if bool(both.any()) else 0.0,
              bool((err[both] <= tol[both]).all()), int(both.sum()),
              (~same & rows).nonzero().flatten(),
              float(err[apart].max()) if bool(apart.any()) else 0.0)

    everywhere = torch.ones_like(real)
    h_flags, h_fin, h_err, h_in, h_n, h_diff, h_apart = held(
        hp, hc, hi, everywhere)
    g_flags, g_fin, g_err, g_in, g_n, g_diff, g_apart = held(gp, gc, gi,
                                                             real)
    n_apart = max(len(h_diff) / len(real), len(g_diff) / int(real.sum()))
    pad = ~real
    n_iter = int(ki.sum())
    ops = tri.flops_per_iteration(K) * n_iter
    nbytes = (poses.untyped_storage().nbytes() + io_bytes([uv, to_c], 8)
              + io_bytes([kp, kc, ki], 8))
    bound_ms, bound_by = bound(nbytes, ops, double=True)
    slow = int(((kp - hp).abs().amax(dim=1) > TRI64_TOL_M)[
        kc & hc & (ki == hi)].sum())
    tol_note = (f"; {TRI_TAIL_TOL_M} m beyond {TRI_TAIL_SLOW} iterations"
                if tail else "")
    fin_note = " on the rows not apart" if tail else ""
    slow_note = (", or neither converged and NaN in one only" if tail
                 else "")
    log(f"compute_pos_batch [{label}, M={N} K={K}, float64, "
        f"{'stride-0 window' if window else 'a window a track'}; "
        f"{tri.launch_shape(K)}]: raw {raw[0]:.5f} ms (device, queued "
        f"behind a sleep, mean of {TRI_BATCHES} x {TRI_REPS}; spread "
        f"{raw[1]:.5f}-{raw[2]:.5f}; queued {raw[4]}), launch floor "
        f"{floor[0]:.5f} ms ({floor[1]:.5f}-{floor[2]:.5f}; a note, not the "
        f"bound), wrapped {wrapped[0]:.5f} ms (host clock after a "
        f"synchronize; {wrapped[1]:.5f}-{wrapped[2]:.5f}), the wrapper's "
        f"host time {host[3]:.5f} ms a call (queued {host[4]}), plain "
        f"{plain_ms:.4f} ms (on the card), bound {bound_ms:.4g} ms "
        f"({bound_by}; {n_iter} Gauss-Newton iterations, largest "
        f"{int(ki.max())}, {int((ki == tri.MAX_ITERS).sum())} tracks at "
        f"{tri.MAX_ITERS}; {ops:,} operations); stride-0 window bitwise "
        f"its contiguous copy {same_bits}; against the plain version on "
        f"the host, all {N} rows: flags equal {h_flags} ({int(kc.sum())} "
        f"converged), non-finite equal {h_fin}{fin_note}, max |kernel - "
        f"plain| {h_err:.4g} m over {h_n} tracks ({slow} converged tracks "
        f"beyond {TRI64_TOL_M} m); on the "
        f"card, the {int(real.sum())} harvested rows: flags equal "
        f"{g_flags}, non-finite equal {g_fin}, {g_err:.4g} m over {g_n} "
        f"tracks (tolerance {TRI64_TOL_M} m{tol_note}); rows apart "
        f"(iteration "
        f"counts differ{slow_note}) "
        f"{len(h_diff)} / {len(g_diff)} (at most {TRI_ITER_SHARE} of the "
        f"rows; row, kernel's and host plain's iterations) "
        f"{[(int(i), int(ki[i]), int(hi[i])) for i in h_diff]}"
        f", max |kernel - plain| there {h_apart:.4g} / {g_apart:.4g} m "
        f"(tolerance {TRI_TOL_M} m); the "
        f"{int(pad.sum())} padding rows: kernel {int(kc[pad].sum())} "
        f"converged, {int(kp[pad].isnan().any(dim=1).sum())} NaN; plain on "
        f"the host {int(hc[pad].sum())} converged, "
        f"{int(hp[pad].isnan().any(dim=1).sum())} NaN; plain on the card "
        f"{int(gc[pad].sum())} converged, largest |p| "
        f"{float(gp[pad].norm(dim=1).max()) if bool(pad.any()) else 0:.4g} m")
    require(h_flags and h_fin and h_in and g_flags and g_fin and g_in
            and n_apart <= TRI_ITER_SHARE
            and max(h_apart, g_apart) <= TRI_TOL_M and same_bits
            and raw[4] and floor[4],
            f"kernel 8 holds against its plain version on {label}, a "
            f"stride-0 window gives its copy's bits, and every timed batch "
            f"was queued behind its sleep")
    if label == f"frame {STORE_FRAMES - 1}":
      row = dict(
          name="compute_pos_batch", route="cuda",
          source="rednose_tpu_torch/csrc/triangulate.cu",
          replaces="rednose_tpu/msckf/triangulation.py:106 "
                   "compute_pos_batch (an XLA program, jit of a vmapped "
                   "while_loop; not Pallas)",
          max_abs_err=max(h_err, g_err), ms=raw[0], plain_ms=plain_ms,
          bound_ms=bound_ms, bound_by=bound_by,
          shape=f"M={N} K={K} float64, {label}")
  return [row]


def vio_frames_of(torch, store):
  """The camera frames' landmarks for a bank of MSCKF_B lanes from the
  store's triangulations: frame f's landmark for lane l is the position of
  the store's frame-f track l mod STORE_COHORT, taken relative to the
  tracker camera's last pose: (STORE_FRAMES, MSCKF_B, 3), in the camera
  frame."""
  positions, poses, _ = store
  last = torch.as_tensor(poses[-1, :3], dtype=positions.dtype,
                         device=positions.device)
  lanes = torch.arange(MSCKF_B, device=positions.device) % STORE_COHORT
  return positions[:, lanes] - last


def vio_kind_idx(T):
  """kind_idx (T,) over (POSITION, feature): camera frame first, then
  alternating with position fixes."""
  return np.array([1 - t % 2 for t in range(T)], np.int32)


def vio_call(model, Q=None, R_feat=None, R_pos=None):
  """Kernel 6's call with the camera-frame branch as MSCKFBank(model).
  run_mixed makes it for the VIO schedule (POSITION R = I, the feature R of
  msckf_setup), or with another Q or R of the same pattern (a planted
  fault: run-time values, the same build)."""
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  spec, _, Q0, R0 = msckf_setup(model)
  return gs.KernelCall(
      spec, "mixed", (MSCKF_POS, MSCKF_KIND), Q=Q0 if Q is None else Q,
      R_list=(np.eye(3) if R_pos is None else R_pos,
              R0 if R_feat is None else R_feat),
      structure=sparsity.structure_for(spec, model.initial_x))


def vio_sources():
  """The emitted sources the VIO path launches: kernel 6 with the
  camera-frame branch for both models."""
  return {f"{model.name} run_mixed with frames (kernel 6)":
          vio_call(model).source() for model in msckf_models()}


def vio_main_path(torch, dev, gen):
  """Phase 1, VIO: the track store at the design point (its triangulations
  on kernel 8), MSCKFBank.run_mixed with camera frames (kernel 6's
  camera-frame branch) for both models on the store's landmarks, and the
  single-filter pipeline (its triangulations on kernel 8). Returns the
  store's triangulation inputs for compare_triangulation."""
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
  from rednose_tpu_torch.msckf.pipeline import VisualOdometryPipeline
  from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank

  store = vio_store_path(torch, dev)
  aheads = vio_frames_of(torch, store)
  kinds, kind_idx = (MSCKF_POS, MSCKF_KIND), vio_kind_idx(VIO_T)
  for model in msckf_models():
    spec, _, Q, R = msckf_setup(model)
    xs = msckf_bank_x0(model, SEED + 4)
    zs, eas, truths = msckf_frames(torch, dev, gen, model, xs, VIO_T, R,
                                   frames=kind_idx.astype(bool),
                                   aheads=aheads)
    bank = MSCKFBank(model, batch=MSCKF_B, x0=xs,
                     P_diag=np.full(spec.dim_err, MSCKF_P0), Q=Q, device=dev)
    t0 = time.perf_counter()
    bank.run_mixed(np.full(VIO_T, MSCKF_DT), kind_idx, zs, kinds,
                   R_by_kind={MSCKF_POS: np.eye(3), MSCKF_KIND: R}, eas=eas)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    lost, reset = msckf_healthy(torch, f"{model.name} VIO bank", bank,
                                truths[-1])
    log(f"{model.name} VIO bank B={MSCKF_B}: run_mixed T={VIO_T} "
        f"({int(kind_idx.sum())} camera frames on the store's landmarks, "
        f"{VIO_T - int(kind_idx.sum())} position fixes) {ms:.3f} ms (host "
        f"clock, first call); lanes lost {lost:.6f}, {reset} diverged and "
        "reset")

  # the single-filter pipeline on the scenario of tests/test_vo_pipeline.py
  rng = np.random.RandomState(SEED)
  v0 = np.array([4.0, 0.0, 0.0])
  x0 = MSCKFEskf.initial_x.copy()
  x0[7:10] = v0
  kf, blind = MSCKFEskf(device=dev), MSCKFEskf(device=dev)
  for f in (kf, blind):
    f.init_state(x0, covs_diag=MSCKFEskf.initial_P_diag, filter_time=0.0)
  landmarks = np.column_stack([rng.uniform(-4, 30, 10),
                               rng.uniform(-5, 5, 10),
                               rng.uniform(10, 18, 10)])
  pipe = VisualOdometryPipeline(kf, n_tracks=64, max_features=16)
  ids = np.full(len(landmarks), -1, dtype=np.int64)
  K = kf.spec.n_augment
  t, updates = 0.0, 0
  t0 = time.perf_counter()
  for _ in range(3 * K):
    t += 0.1
    uvs = np.stack([(lm - v0 * t)[:2] / (lm - v0 * t)[2]
                    + rng.normal(0, 0.002, 2) for lm in landmarks])
    est, ids = pipe.process_frame(t, ids, uvs)
    blind.observe_camera_frame(t, np.zeros((0, K, 2)))
    if est is not None and len(est[7]):
      updates += 1
  secs = time.perf_counter() - t0
  err = float(np.linalg.norm(kf.x[0:3] - v0 * t))
  tr, tr_blind = float(np.trace(kf.P)), float(np.trace(blind.P))
  require(updates >= 2 and np.isfinite(kf.x).all() and tr < tr_blind
          and err < 0.2 and pipe.dropped_total == 0,
          f"VIO pipeline: {updates} feature updates, trace(P) {tr} against "
          f"the blind twin's {tr_blind}, position error {err} m, "
          f"{pipe.dropped_total} detections dropped")
  log(f"VIO pipeline (MSCKFEskf on {kf.filter.device}, 64 tracks): "
      f"{3 * K} frames, {updates} feature updates, trace(P) {tr:.6g} "
      f"(blind {tr_blind:.6g}), position error {err:.4g} m, "
      f"{secs / (3 * K) * 1e3:.3f} ms a frame with its blind twin's "
      "(host clock)")
  return store[2]


def compare_vio(torch, dev, gen, reps=10):
  """Phase 2, VIO: kernel 6 with its camera-frame branch against its plain
  version at B = MSCKF_B, T = VIO_CMP_T (camera frame / position fix
  alternating) for both models, on msckf_frames' data (6 m ahead, the
  camera moving at MSCKF_V) from a fresh bank: float32 within GEN_TOL
  sigma, the double build within MSCKF64_TOL of the float64 plain version,
  and planted faults (a clone-block Q term, the feature R's diagonal x
  1.01, the position R's diagonal x 1.01, one landmark depth + 1 cm, one
  dts entry x 1.01; run-time values, no extra build) beyond MSCKF64_TOL;
  the float32 tile (and a double one) against its global form on the same
  inputs (tile_vs_global)."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import generic_scan as gs

  rows, checks = [], []
  T = VIO_CMP_T
  kinds, kind_idx = (MSCKF_POS, MSCKF_KIND), vio_kind_idx(T)
  for model in msckf_models():
    spec, _, Q, R = msckf_setup(model)
    xs = msckf_bank_x0(model, SEED + 5)
    zs, eas, _ = msckf_frames(torch, dev, gen, model, xs, T, R,
                              frames=kind_idx.astype(bool))
    call = vio_call(model)
    ops = step_ops(call.counting_source(), kinds, "mixed") * T * MSCKF_B
    shape = (f"{model.name} B={MSCKF_B} T={T}, {T // 2} camera frames + "
             f"{T // 2} position fixes, gate on")

    def inputs(dtype, eas=eas, dts=np.full(T, MSCKF_DT)):
      d = dict(dtype=dtype, device=dev)
      return (torch.as_tensor(xs.T, **d).contiguous(),
              (MSCKF_P0 * torch.eye(spec.dim_err, **d))[:, :, None].repeat(
                  1, 1, MSCKF_B),
              zs.transpose(1, 2).to(**d).contiguous(),
              torch.as_tensor(dts, **d),
              torch.as_tensor(kind_idx, dtype=torch.int32, device=dev),
              eas.transpose(1, 2).to(**d).contiguous())

    kw = dict(spec=spec, kinds=kinds, Q=Q, R_list=call.R_list,
              structure=call.structure)

    def kernel(*a, **k):
      return gs.generic_bank_scan_mixed(*a[:5], eas=a[5], **k)

    def plain(*a, **k):
      return gs.generic_bank_scan_mixed_reference(*a[:5], eas=a[5], **k)

    args32 = inputs(torch.float32)
    row, _, _ = kernel_vs_plain(
        "generic_bank_scan_mixed", "rednose_tpu_torch/csrc/generic_scan.cuh",
        "rednose_tpu/ops/pallas_bank.py:250", spec, kernel, plain, args32,
        kw, shape, ops, checks=checks, reps=reps)
    rows.append(row)
    tile_vs_global(f"generic_bank_scan_mixed with frames [{model.name} "
                   f"B={MSCKF_B}]", call, spec, args32[:4],
                   dict(eas=args32[5], kind_idx=args32[4]), checks)
    args64 = inputs(torch.float64)
    _, _, ref64 = kernel_vs_plain(
        "generic_bank_scan_mixed", "", "", spec, kernel, plain, args64, kw,
        shape + ", float64", ops, MSCKF64_TOL, checks=checks, reps=reps)
    if is_tile(call.source(torch.float64)):
      tile_vs_global(f"generic_bank_scan_mixed with frames [{model.name} "
                     f"B={MSCKF_B}, float64]", call, spec, args64[:4],
                     dict(eas=args64[5], kind_idx=args64[4]), checks,
                     MSCKF64_TOL)
    builds = _build.generated_launcher.cache_info().currsize
    Qf = np.array(Q, dtype=np.float64)
    Qf[-1, -1] += 1e-4
    eas_f = eas.clone()
    eas_f[T // 2, :, 2] += 0.01          # step T // 2 is a camera frame
    dts_f = np.full(T, MSCKF_DT)
    dts_f[T // 3] *= 1.01
    faults = {
        "clone-block Q term": (vio_call(model, Q=Qf), args64),
        "feature R diagonal x 1.01": (vio_call(model, R_feat=1.01 * R),
                                      args64),
        "position R diagonal x 1.01": (vio_call(model,
                                                R_pos=1.01 * np.eye(3)),
                                       args64),
        "landmark depth + 1 cm": (call, inputs(torch.float64, eas=eas_f)),
        "dts entry x 1.01": (call, inputs(torch.float64, dts=dts_f)),
    }
    miss = {name: float(lane_errs(kernel(*args, call=c), ref64, spec).max())
            for name, (c, args) in faults.items()}
    least = min(miss, key=miss.get)
    ok = (miss[least] > MSCKF64_TOL
          and _build.generated_launcher.cache_info().currsize == builds)
    log(f"generic_bank_scan_mixed with frames, planted faults "
        f"[{model.name}, float64]: "
        + ", ".join(f"{k} {v:.4g}" for k, v in miss.items())
        + f" sigma; the least visible must exceed {MSCKF64_TOL}, with no "
        f"extra build -> {'ok' if ok else 'FAIL'}")
    checks.append((f"{model.name} VIO planted faults beyond the limit", ok))
  bad = [name for name, ok in checks if not ok]
  require(not bad, f"kernel 6 with frames agrees with its plain version: "
                   f"{bad}")
  return rows


# ------------------------------------------- offline smoother and migration

def full_q():
  """LiveKalman.Q with velocity noise 0.1^2 and a symmetric velocity-
  acceleration coupling of 0.15 (correlation 0.5): that block positive
  definite, Q positive semidefinite (LiveKalman.Q keeps no attitude
  noise)."""
  from rednose_tpu_torch.models.live import LiveKalman

  Q = np.array(LiveKalman.Q)
  Q[6:9, 6:9] += 0.1**2 * np.eye(3)
  for i in range(3):
    Q[6 + i, 16 + i] = Q[16 + i, 6 + i] = 0.15
  idx = [*range(6, 9), *range(16, 19)]
  require(np.linalg.eigvalsh(Q[np.ix_(idx, idx)]).min() > 0,
          "the velocity-acceleration block of the full Q is definite")
  require(np.linalg.eigvalsh(Q).min() >= -1e-12 * np.abs(Q).max(),
          "the full Q is positive semidefinite")
  return Q


def full_q_calls():
  """Kernels 4 and 6 on the live spec with full_q(), as LiveKalmanBank
  makes them on the card: run (ECEF_POS, gate off) and run_mixed / observe
  (every live lane kind, LIVE_KINDS, gate off)."""
  from rednose_tpu_torch.models.live import (
      LiveKalman,
      ObservationKind as K,
      build_live_spec,
  )
  from rednose_tpu_torch.ops import generic_scan as gs, live_lane, sparsity
  from rednose_tpu_torch.runtime.live_bank import LIVE_KINDS

  spec = build_live_spec()
  st = sparsity.structure_for(spec, LiveKalman.initial_x)
  R = [np.atleast_2d(LiveKalman.obs_noise.get(
      k, np.eye(live_lane.LANE_KINDS[k][0]))) for k in LIVE_KINDS]
  return {
      "live full Q run (kernel 4)": gs.KernelCall(
          spec, "single", (K.ECEF_POS,), Q=full_q(),
          R_list=(LiveKalman.obs_noise[K.ECEF_POS],), gate=False,
          structure=st),
      "live full Q run_mixed / observe (kernel 6)": gs.KernelCall(
          spec, "mixed", LIVE_KINDS, Q=full_q(), R_list=R, gate=False,
          structure=st),
  }


def full_q_cmp_calls():
  """The comparison phase's own full-Q variants, float32: the gate=True
  ones LiveKalmanBank makes, kernel 4 with the gate on and kernel 6 on
  gated_live_spec() over LIVE_KINDS."""
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity
  from rednose_tpu_torch.runtime.live_bank import gated_live_spec

  c4, c6 = full_q_calls().values()
  gspec = gated_live_spec()
  return {
      "live full Q run, gate on (kernel 4)": gs.KernelCall(
          c4.spec, "single", c4.kinds, Q=c4.Q, R_list=c4.R_list, gate=True,
          structure=c4.structure),
      "live full Q run_mixed, gate on (kernel 6)": gs.KernelCall(
          gspec, "mixed", c6.kinds, Q=c6.Q, R_list=c6.R_list, gate=True,
          structure=sparsity.structure_for(gspec, LiveKalman.initial_x)),
  }


def refine_inputs(torch, dev, gen, T=REFINE_T):
  """tests/test_rts_live.py's cold log of T steps (REFINE_T on the offline
  path), float64 on the card: ECEF_POS, PHONE_GYRO (a time-varying
  angular-rate command) and NO_ROT in turn, dt 0.01, noise from gen.
  Returns (spec, scan_fn's arguments after the params: x0 (dim_x,), P0,
  Q, dts, kind_idx (numpy), zs (T, 3), Rs (T, 3, 3), eas (T, 1); ts)."""
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K

  f64 = dict(dtype=torch.float64, device=dev)
  spec = LiveKalman.build_spec()
  require((K.ECEF_POS, K.PHONE_GYRO, K.NO_ROT) == REFINE_KINDS,
          "REFINE_KINDS are the refinement log's kinds")
  ts = (1 + torch.arange(T, **f64)) * 0.01
  ki = np.arange(T) % 3
  kt = torch.as_tensor(ki, device=dev)
  omega = torch.stack([0.4 * torch.sin(0.5 * ts), 0.3 * torch.cos(0.8 * ts),
                       0.2 * torch.ones_like(ts)], dim=1)
  zs = torch.zeros((T, 3), **f64)
  zs = torch.where((kt == 0)[:, None], torch.as_tensor(
      LiveKalman.initial_x[0:3], **f64) + torch.randn(
          (T, 3), generator=gen, **f64), zs)
  zs = torch.where((kt == 1)[:, None], omega + 0.01 * torch.randn(
      (T, 3), generator=gen, **f64), zs)
  Rs = torch.stack([torch.diag(torch.full((3,), v, **f64))
                    for v in (25.0, 0.025**2, 0.25**2)])[kt]
  return spec, (torch.as_tensor(LiveKalman.initial_x, **f64),
                torch.as_tensor(np.diag(LiveKalman.initial_P_diag), **f64),
                torch.as_tensor(LiveKalman.Q, **f64),
                torch.full((T,), 0.01, **f64), ki, zs, Rs,
                torch.zeros((T, 1), **f64)), ts


def refine_log(torch, dev, gen):
  """The cold log of refine_inputs through the scan stream (kernel 9).
  Returns (spec, stacks, ts)."""
  from rednose_tpu_torch.runtime.scan import build_scan_stream

  spec, args, ts = refine_inputs(torch, dev, gen)
  scan_fn, _ = build_scan_stream(spec, REFINE_KINDS)
  _, stacks = scan_fn({}, *args)
  return spec, stacks, ts


SCAN_KINDS = (12, 9)   # the live ECEF_POS and NO_ROT kinds
REFINE_KINDS = (12, 4, 9)   # refine_log's ECEF_POS, PHONE_GYRO, NO_ROT


def scan_log(torch, dev, gen, T, B, dtype):
  """bench.py:363-400's live log for B lanes at once, in dtype on the card:
  ECEF_POS (every even step, R = 25 I, the start position plus noise of
  1 m a lane) and NO_ROT (every odd step, R = 0.00025^2 I, z = 0) with dt
  0.01, from the live prior. Returns (x0 (B, 23), P0 (B, 22, 22), Q, dts,
  kind_idx (numpy), zs (T, B, 3), Rs (T, 3, 3), eas (T, 1))."""
  from rednose_tpu_torch.models.live import LiveKalman

  f = dict(dtype=dtype, device=dev)
  ki = np.arange(T) % 2
  is_pos = torch.as_tensor(ki == 0, device=dev)
  pos = torch.as_tensor(LiveKalman.initial_x[0:3], **f)
  zs = torch.where(is_pos[:, None, None], pos + torch.randn(
      (T, B, 3), generator=gen, device=dev, dtype=dtype),
      torch.zeros((), **f))
  Rs = torch.where(is_pos[:, None, None],
                   torch.diag(torch.full((3,), 25.0, **f)),
                   torch.diag(torch.full((3,), 0.00025**2, **f)))
  x0 = torch.as_tensor(LiveKalman.initial_x, **f).expand(B, -1)
  P0 = torch.as_tensor(np.diag(LiveKalman.initial_P_diag), **f).expand(
      B, -1, -1)
  return (x0, P0, torch.as_tensor(LiveKalman.Q, **f),
          torch.full((T,), 0.01, **f), ki, zs, Rs, torch.zeros((T, 1), **f))


def stream_calls():
  """Kernel 9's variants of the offline path, by name, each with the dtype
  the path runs it in: the live log's two kinds (float32) and the cold
  refinement log's three (refine_log, float64), the model's Q pattern."""
  import torch

  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import generic_scan as gs

  spec = LiveKalman.build_spec()
  return {name: (gs.KernelCall(spec, "stream", kinds, Q=LiveKalman.Q), dtype)
          for name, kinds, dtype in (
              ("live log scan (kernel 9)", SCAN_KINDS, torch.float32),
              ("refinement log scan (kernel 9), float64", REFINE_KINDS,
               torch.float64))}


def stream_launch(source, call, x, P, zs, dts, kind_idx, Rs, eas=None,
                  fn=None):
  """A launch of the build of an emitted stream `source` (its
  rn_generic_stream_launch, or fn, another build's) with call's params and
  Q, on copies of the bank-minor x (dim_x, B) and P (de, de, B) made once
  and stacks allocated once, zs (T, max_dz, B), kind_idx numpy or int32,
  no checks between launches. Returns the zero-argument launch, which
  returns (x, P, x_preds, P_preds, x_posts, P_posts), bank-minor."""
  import torch

  from rednose_tpu_torch import _build

  fn = fn or _build.generated_launcher(source)
  spec, dev, dtype = call.spec, x.device, x.dtype
  prm = torch.as_tensor([float(call.params[k]) for k in call._pnames]
                        or [0.0], dtype=dtype, device=dev)
  Q = torch.as_tensor(call.Q, dtype=dtype, device=dev)
  ki = torch.as_tensor(kind_idx, device=dev).to(torch.int32)
  x, P = x.clone(), P.clone()
  T, B = dts.shape[0], x.shape[-1]
  xp, xq = (x.new_empty((T, spec.dim_x, B)) for _ in range(2))
  Pp, Pq = (x.new_empty((T, spec.dim_err, spec.dim_err, B))
            for _ in range(2))
  stream = torch.cuda.current_stream(dev).cuda_stream

  def launch():
    _build.check(fn(x.data_ptr(), P.data_ptr(), zs.data_ptr(),
                    None if eas is None else eas.data_ptr(), dts.data_ptr(),
                    ki.data_ptr(), Rs.data_ptr(), prm.data_ptr(),
                    Q.data_ptr(), xp.data_ptr(), Pp.data_ptr(),
                    xq.data_ptr(), Pq.data_ptr(), T, B, stream), "kernel 9")
    return x, P, xp, Pp, xq, Pq

  return launch


def stream_err(spec, out, ref):
  """The largest difference of a kernel 9 result from ref, both bank-minor
  (x, P, x_preds, P_preds, x_posts, P_posts), over the final state and
  every step's predicted and posterior state, in sigmas of ref
  (utils/compare.py); a non-finite difference counts as infinitely far."""
  import torch

  from rednose_tpu_torch.utils.compare import lane_sigma_errs

  de, worst = spec.dim_err, 0.0
  pairs = [(out[0], out[1], ref[0], ref[1])]
  for s in (2, 4):
    pairs.append(tuple(
        a.permute(1, 0, 2).reshape(spec.dim_x, -1) if a.dim() == 3
        else a.permute(1, 2, 0, 3).reshape(de, de, -1)
        for a in (out[s], out[s + 1], ref[s], ref[s + 1])))
  for pair in pairs:
    e = torch.maximum(*lane_sigma_errs(spec, *pair))
    worst = max(worst, float(torch.nan_to_num(e, nan=float("inf")).max()))
  return worst


def adjoint_calls():
  """Kernel 10's variants (mode "stream_adjoint") and the kernel 9
  variants that its comparisons add, by name, each with the dtype it runs
  in: the live log's adjoint in float32 (the tenth path) and float64
  (compare_scan_grad), the gated live spec's scan and adjoint in both
  (compare_scan_grad), the kinematic log's scan and adjoint in float64
  (ml_tuning, Q = diag(0.1^2, q))."""
  import torch

  from rednose_tpu_torch.models.kinematic import (
      KinematicKalman,
      ObservationKind as KK,
  )
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import generic_scan as gs
  from rednose_tpu_torch.runtime.live_bank import gated_live_spec

  live, kin = LiveKalman.build_spec(), KinematicKalman.build_spec()
  q_kin = np.diag([0.1**2, 1.0])
  calls = {
      "live log adjoint (kernel 10)": (gs.KernelCall(
          live, "stream_adjoint", SCAN_KINDS, Q=LiveKalman.Q), torch.float32),
      "live log adjoint (kernel 10), float64": (gs.KernelCall(
          live, "stream_adjoint", SCAN_KINDS, Q=LiveKalman.Q), torch.float64),
      "ML tuning log scan (kernel 9), float64": (gs.KernelCall(
          kin, "stream", (KK.POSITION,), Q=q_kin), torch.float64),
      "ML tuning log adjoint (kernel 10), float64": (gs.KernelCall(
          kin, "stream_adjoint", (KK.POSITION,), Q=q_kin), torch.float64)}
  for mode, kernel in (("stream", "scan (kernel 9)"),
                       ("stream_adjoint", "adjoint (kernel 10)")):
    for dtype in (torch.float32, torch.float64):
      calls[f"gated live log {kernel}, {str(dtype).split('.')[-1]}"] = (
          gs.KernelCall(gated_live_spec(), mode, SCAN_KINDS, Q=LiveKalman.Q),
          dtype)
  return calls


def adjoint_launch(source, call, x0, P0, zs, dts, kind_idx, Rs, stacks,
                   cots, fn=None):
  """A launch of the build of an emitted adjoint `source` (its
  rn_generic_stream_adjoint_launch) with call's params and Q, on kernel
  9's bank-minor inputs (x0 (dim_x, B), P0 (de, de, B), zs (T, max_dz, B)),
  its stacks (xp, Pp, xq, Pq) and the cotangents (gx, gP, gxp, gPp, gxq,
  gPq), its outputs allocated once, no checks between launches (a kind
  without extra args). Returns the zero-argument launch, which returns
  the outputs."""
  import torch

  from rednose_tpu_torch import _build

  fn = fn or _build.generated_launcher(source)
  spec, dev, dtype = call.spec, x0.device, x0.dtype
  prm = torch.as_tensor([float(call.params[k]) for k in call._pnames]
                        or [0.0], dtype=dtype, device=dev)
  Q = torch.as_tensor(call.Q, dtype=dtype, device=dev)
  ki = torch.as_tensor(kind_idx, device=dev).to(torch.int32)
  T, B = dts.shape[0], x0.shape[-1]
  nz, dx, de = zs.shape[1], spec.dim_x, spec.dim_err
  new = x0.new_empty
  outs = (new((dx, B)), new((de, de, B)), new((T, nz, B)),
          new((T, nz, nz, B)), new((T, B)), new((de, de, B)),
          new((prm.shape[0], B)), torch.zeros(B, dtype=torch.int32,
                                              device=dev))
  stream = torch.cuda.current_stream(dev).cuda_stream

  def launch():
    args = (x0, P0, zs, None, dts, ki, Rs, prm, Q, *stacks, *cots,
            *outs[:5], None, *outs[5:])
    _build.check(fn(*(None if a is None else a.data_ptr() for a in args),
                    T, B, stream), "kernel 10")
    return outs

  return launch


def innovation_nll(torch, spec, kinds, ki, xp, Pp, zs, Rs, eas):
  """The innovation negative log-likelihood of a log's predicted stacks,
  summed over the lanes and the steps: 0.5 (log det S + y^T S^-1 y) with
  y = z - h(x_pred) and S = H P_pred H^T + R, each step's kind's h and H
  (as core/step.py takes them: H through H_mod for an error-state spec)
  on its dz leading rows of zs and block of Rs. xp (B, T, dx), Pp (B, T,
  de, de), zs (T, B, max_dz), Rs (T, max_dz, max_dz), eas (T, max_ea)."""
  from torch.func import vmap

  total = 0.0
  for u, k in enumerate(kinds):
    om = spec.obs[k]
    idx = torch.as_tensor(np.nonzero(np.asarray(ki) == u)[0],
                          device=xp.device)

    def h_and_H(x, ea, k=k, om=om):
      ea = ea[:max(om.ea_len, 1)]
      H = spec.H(k, {}, x, ea)
      if spec.is_eskf:
        H = H @ spec.H_mod_at({}, x)
      return om.h({}, x, ea).reshape(-1), H

    h, H = vmap(vmap(h_and_H), in_dims=(0, None))(xp[:, idx], eas[idx])
    S = H @ Pp[:, idx] @ H.transpose(-1, -2) + Rs[idx, :om.dz, :om.dz]
    y = zs[idx, :, :om.dz].transpose(0, 1) - h
    L = torch.linalg.cholesky(S)
    w = torch.linalg.solve_triangular(L, y[..., None], upper=False)
    total = total + 0.5 * (
        2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum()
        + (w ** 2).sum())
  return total


def grad_path(torch, dev, gen):
  """Phase 1, the tenth path: the gradient through the offline log. The
  offline path's live log (scan_log: RTS_B lanes x RTS_T steps, float32)
  through runtime/scan.build_scan_stream's scan_fn vmapped over the lanes,
  the innovation NLL of its predicted stacks (innovation_nll) summed over
  the lanes, and torch.autograd.grad of it w.r.t. Q, Rs, x0, P0 and zs:
  kernel 9 once, kernel 10 once (the backward of the custom op), the
  plain loop never (the caller checks the counts). The gradients finite
  and nonzero, no gate flip; host-clock times after a synchronise."""
  from torch.func import vmap

  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import generic_scan as gs
  from rednose_tpu_torch.runtime.scan import build_scan_stream

  spec = LiveKalman.build_spec()
  scan_fn, _ = build_scan_stream(spec, SCAN_KINDS)
  T, B = RTS_T, RTS_B
  x0, P0, Q, dts, ki, zs, Rs, eas = scan_log(torch, dev, gen, T, B,
                                              torch.float32)
  ins = [a.clone().requires_grad_() for a in (Q, Rs, x0, P0, zs)]
  Qg, Rg, xg, Pg, zg = ins
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  _, (xp, Pp, _, _) = vmap(
      lambda x, P, z: scan_fn({}, x, P, Qg, dts, ki, z, Rg, eas),
      in_dims=(0, 0, 1))(xg, Pg, zg)
  nll = innovation_nll(torch, spec, SCAN_KINDS, ki, xp, Pp, zg, Rg, eas)
  torch.cuda.synchronize()
  t1 = time.perf_counter()
  grads = torch.autograd.grad(nll, ins)
  torch.cuda.synchronize()
  t2 = time.perf_counter()
  flips = int(gs.stream_bank_scan_adjoint.gate_flips.sum())
  require(bool(torch.isfinite(nll)), f"the log's NLL is finite: {nll}")
  require(all(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
              for g in grads), "the gradients through the log are finite "
          "and nonzero")
  require(flips == 0, f"kernel 10 followed every gate decision of kernel "
          f"9 without a flip: {flips}")
  log(f"gradient through the log (scan_fn vmapped, B={B} x T={T} live steps, "
      f"float32): NLL {float(nll.detach()):.6g}; forward + NLL "
      f"{(t1 - t0) * 1e3:.1f} ms, backward (kernel 10 and the NLL's) {(t2 - t1) * 1e3:.1f} ms "
      f"(host clock, first call, with the build's load); largest gradient "
      + ", ".join(f"{n} {float(g.abs().max()):.4g}" for n, g in zip(
          ("Q", "Rs", "x0", "P0", "zs"), grads))
      + f"; gate flips {flips}")
  return {}


def offline_path(torch, dev, gen):
  """Phase 1, offline smoother and migration, all on the card: (a) the
  full-Q live bank; (b) a live log through the scan stream for RTS_B
  lanes; (c) rts_smooth and rts_smooth_parallel on lane 0; (d) the bank
  smoother over every lane; (e) float64 refinement; (f) the gains step
  against torch.linalg; (g) the migration demo and its smoother."""
  import dataclasses

  from torch.func import vmap

  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import entry_slab, generic_scan as gs, lane_bank
  from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank
  from rednose_tpu_torch.runtime.scan import (
      build_scan_stream,
      build_scan_stream_reference,
  )
  from rednose_tpu_torch.smoothing import rts

  f32 = dict(dtype=torch.float32, device=dev)

  def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out

  # (a) the live bank with an off-diagonal Q: kernels 6 and 4
  bank = LiveKalmanBank(batch=LIVE_B, Q=full_q(), device=dev)
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, FQ_T)
  ms_m, _ = timed(lambda: bank.run_mixed(np.full(FQ_T, 0.01), kind_idx,
                                         zs_m, kinds))
  pos = torch.as_tensor(LiveKalman.initial_x[0:3], **f32)
  zs = pos + 5.0 * torch.randn((FQ_T, LIVE_B, 3), generator=gen, device=dev)
  ms_r, _ = timed(lambda: bank.run(np.full(FQ_T, 0.01), zs))
  rng = np.random.RandomState(SEED + 5)
  t_base = bank.t
  for i in (1, 2, 3, 5, 6, 4, 7, 8):  # the 6th call arrives late
    z = LiveKalman.initial_x[0:3] + rng.normal(0, 5.0, (LIVE_B, 3))
    require(bank.observe(t_base + 0.01 * i, K.ECEF_POS, z) is not None,
            f"full-Q observe {i} applied")
  require(abs(bank.t - (t_base + 0.08)) < 1e-9, "full-Q bank time")
  require(bank.observe(t_base - 5.0, K.ECEF_POS, z) is None,
          "a too-old full-Q observation is dropped")
  torch.cuda.synchronize()
  require(bool(torch.isfinite(bank._x).all()
               and torch.isfinite(bank._P).all()), "full-Q bank finite")
  require(torch.equal(bank._P, bank._P.transpose(0, 1)),
          "full-Q bank P symmetric")
  require(int(bank.diverged().sum()) == 0, "full-Q bank: no diverged lane")
  sd = torch.diagonal(bank._P, dim1=0, dim2=1)[:, 0:3].sqrt()
  err = (bank._x[0:3] - pos[:, None]).abs().T
  require(bool((err < 8.0 * sd + 5.0).all()),
          "the full-Q bank keeps the position")
  log(f"full-Q live bank B={LIVE_B}: run_mixed T={FQ_T} {ms_m:.3f} ms, run "
      f"T={FQ_T} {ms_r:.3f} ms (host clock, first calls), 8 observe; "
      f"position sigma {float(sd.mean()):.4g} m, max error "
      f"{float(err.max()):.4g} m")

  # (b) bench.py:363-400's live log (ECEF_POS and NO_ROT in turn, dt
  # 0.01) through the scan stream, RTS_B lanes at once (lane 0 is the
  # single log, the others other noise draws): kernel 9, one launch
  spec = LiveKalman.build_spec()
  scan_fn, _ = build_scan_stream(spec, SCAN_KINDS)
  T, B = RTS_T, RTS_B
  x0, P0, Q32, dts_t, ki, zs, Rs, eas = scan_log(torch, dev, gen, T, B,
                                                  torch.float32)
  lanes = vmap(lambda x, P, z: scan_fn({}, x, P, Q32, dts_t, ki, z, Rs, eas),
               in_dims=(0, 0, 1))
  n = gs.stream_bank_scan.launches
  ms_scan, (_, stacks) = timed(lambda: lanes(x0, P0, zs))
  require(gs.stream_bank_scan.launches == n + 1,
          "the scan stream launched kernel 9 once for every lane")
  require(all(bool(torch.isfinite(a).all()) for a in stacks),
          "the scan stream's stacks are finite")
  # the same log again, timed with CUDA events (the first call's host
  # clock includes the build's load)
  start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
  start.record()
  lanes(x0, P0, zs)
  end.record()
  torch.cuda.synchronize()
  ms_events = start.elapsed_time(end)
  log(f"scan stream (runtime/scan.build_scan_stream, vmapped, kernel 9): "
      f"B={B} lanes x T={T} live steps, float32, {ms_scan:.1f} ms (host "
      f"clock, first call, with its build's load), "
      f"{B * T / ms_scan * 1e3:.1f} filter-steps/s; again {ms_events:.1f} "
      f"ms (CUDA events), {ms_events / T * 1e3:.3f} us a step, "
      f"{B * T / ms_events * 1e3:.1f} filter-steps/s")
  # the plain scan's predict takes the spec's closed-form F (F_lane); the
  # same spec without it takes jacfwd of the error dynamics: both on the
  # first F_LANE_T steps of the same lanes, in the order a b b a
  ms_f, x_f = {"F_lane": [], "jacfwd": []}, {}
  for label in F_LANE_ORDER:
    sp = spec if label == "F_lane" else dataclasses.replace(spec, F_lane=None)
    fn, _ = build_scan_stream_reference(sp, SCAN_KINDS)
    ms, ((x_f[label], _), _) = timed(lambda: vmap(
        lambda x, P, z: fn({}, x, P, Q32, dts_t[:F_LANE_T], ki[:F_LANE_T], z,
                           Rs[:F_LANE_T], eas[:F_LANE_T]),
        in_dims=(0, 0, 1))(x0, P0, zs[:F_LANE_T]))
    ms_f[label].append(ms)
  log(f"plain scan stream predict's F, B={B} x T={F_LANE_T} (host clock, "
      f"a b b a): F_lane {ms_f['F_lane']} ms ("
      f"{min(ms_f['F_lane']) / F_LANE_T:.3f} ms a step), jacfwd "
      f"{ms_f['jacfwd']} ms ({min(ms_f['jacfwd']) / F_LANE_T:.3f} ms a "
      f"step); final states differ by "
      f"{float((x_f['F_lane'] - x_f['jacfwd']).abs().max()):.4g}")

  # (c) lane 0 smoothed sequentially and in parallel; both against the
  # float64 sequential smoother of the same stacks, scaled per component
  # (tests/test_rts_live.py:131-152): the parallel one-shot's error at
  # most 3x the float32 sequential smoother's own + 1e-6
  t64 = (1 + np.arange(T)) * 0.01
  t = torch.as_tensor(t64, **f32)
  dts = torch.as_tensor(np.diff(t64), **f32)
  lane0 = tuple(a[0] for a in stacks)
  ms_seq, (xs_s, _) = timed(lambda: rts.rts_smooth(
      spec, {}, *lane0, t, norm_quats=True, dts=dts))
  ms_par, (xs_p, Ps_p) = timed(lambda: rts.rts_smooth_parallel(
      spec, {}, *lane0, t, norm_quats=True, dts=dts))
  ms_o, (oracle, _) = timed(lambda: rts.rts_smooth(
      spec, {}, *(a.double() for a in lane0),
      torch.as_tensor(t64, dtype=torch.float64, device=dev),
      norm_quats=True))
  scale = oracle.abs().amax(dim=0).clamp(min=1.0)
  err_seq = float(((oracle - xs_s.double()).abs() / scale).max())
  err_par = float(((oracle - xs_p.double()).abs() / scale).max())
  require(bool(torch.isfinite(xs_p).all() and torch.isfinite(Ps_p).all()),
          "lane 0's parallel smoothing finite")
  require(err_par < 3.0 * err_seq + 1e-6,
          f"parallel float32 within 3x the sequential's error: {err_par} "
          f"vs {err_seq}")
  log(f"smoother, lane 0 (T={T}, float32, norm_quats): rts_smooth "
      f"{ms_seq:.1f} ms ({T / ms_seq * 1e3:.1f} smoothed steps/s), "
      f"rts_smooth_parallel {ms_par:.1f} ms ({T / ms_par * 1e3:.1f} "
      f"smoothed steps/s) (host clock, first calls); the float64 "
      f"sequential oracle {ms_o:.1f} ms; scaled error against it: "
      f"sequential {err_seq:.4g}, parallel {err_par:.4g} (bound "
      f"{3.0 * err_seq + 1e-6:.4g})")

  # (d) every lane smoothed in one call; three lanes held against
  # rts_smooth_parallel of the lane alone
  torch.cuda.reset_peak_memory_stats(dev)
  ms_b, (xs_b, Ps_b) = timed(lambda: rts.rts_smooth_parallel_bank(
      spec, {}, *stacks, t.expand(B, T), norm_quats=True,
      dts=dts.expand(B, T - 1)))
  peak = torch.cuda.max_memory_allocated(dev)
  stack_bytes = sum(a.numel() * a.element_size() for a in stacks)
  for lane in (0, B // 2, B - 1):
    xl, Pl = rts.rts_smooth_parallel(spec, {}, *(a[lane] for a in stacks),
                                     t, norm_quats=True, dts=dts)
    ex = float(((xs_b[lane] - xl).abs()
                / xl.abs().amax(dim=0).clamp(min=1.0)).max())
    ep = float((Ps_b[lane] - Pl).abs().max() / Pl.abs().max())
    log(f"bank smoother lane {lane} against rts_smooth_parallel alone: "
        f"state {ex:.4g}, covariance {ep:.4g} (scaled; tolerance "
        f"{BANK_SMOOTH_TOL})")
    require(ex <= BANK_SMOOTH_TOL and ep <= BANK_SMOOTH_TOL,
            f"bank smoother lane {lane} equals its lane alone")
  log(f"bank smoother (rts_smooth_parallel_bank) B={B} x T={T}, float32: "
      f"{ms_b:.1f} ms (host clock, first call), "
      f"{B * T / ms_b * 1e3:.1f} smoothed steps/s; stacks "
      f"{stack_bytes / 2**30:.2f} GiB, peak device memory "
      f"{peak / 2**30:.2f} GiB")
  del xs_b, Ps_b

  # (e) float64 refinement on the card: the cold log, refine = 8 against
  # the sequential smoother
  spec, stacks64, ts = refine_log(torch, dev, gen)
  q = stacks64[2][:, 3:7]
  require(float((q.amax(dim=0) - q.amin(dim=0)).max()) > 0.3,
          "the refinement log rotates")
  xs_s, Ps_s = rts.rts_smooth(spec, {}, *stacks64, ts, norm_quats=True)
  ms_ref, (xs_r, Ps_r) = timed(lambda: rts.rts_smooth_parallel(
      spec, {}, *stacks64, ts, norm_quats=True, refine=REFINE))
  _, (xs_0, _) = timed(lambda: rts.rts_smooth_parallel(
      spec, {}, *stacks64, ts, norm_quats=True, refine=0))
  dev_r = float((xs_s - xs_r).abs().max())
  log(f"float64 refinement (T={REFINE_T} cold log): refine={REFINE} "
      f"{ms_ref:.1f} ms, state deviation from sequential {dev_r:.4g} "
      f"(tolerance {REFINE_TOL}), covariance "
      f"{float((Ps_s - Ps_r).abs().max()):.4g}; one-shot "
      f"{float((xs_s - xs_0).abs().max()):.4g}")
  require(dev_r < REFINE_TOL, "refine = 8 converges to the sequential")
  # both offline launches of kernel 9 ran its tile (design 1)
  for name, (call, dtype) in stream_calls().items():
    src = call.source(dtype)
    info = _build.generated_info(src)
    spills = [ln.split("info    :")[-1].strip() for ln in
              _build.generated_ptxas(src).splitlines() if "spill" in ln]
    log(f"{name}, {str(dtype).split('.')[-1]}: design "
        f"{'tile' if info['design'] else 'global'}, W={info['warps']} "
        f"warps, {info['smem_bytes']} B of shared memory a block, "
        f"{info['blocks_per_sm']} blocks an SM, {info['registers']} "
        f"registers, {info['local_bytes']} B of stack a thread; ptxas "
        f"{spills}")
    require(info["design"] == 1
            and info["warps"] == entry_slab.TILE_ROLES_STREAM,
            f"{name} runs the tile at W = TILE_ROLES_STREAM: {info}")

  # (f) the gains step over every lane: solve P_{k+1|k} X = F_k P_k^T
  # through the blocked lane Cholesky, and through torch.linalg on the
  # same batch
  spec = LiveKalman.build_spec()
  xf, Pp, Pf = stacks[2], stacks[1], stacks[3]
  N = B * (T - 1)
  F = spec.F_lane({}, xf[:, :-1].reshape(N, -1).T,
                  dts.repeat(B))                       # (22, 22, N)
  Pk = Pf[:, :-1].reshape(N, 22, 22).permute(1, 2, 0)
  Pk1 = Pp[:, 1:].reshape(N, 22, 22).permute(1, 2, 0).contiguous()
  rhs = lane_bank._mm_t(F, Pk)
  Pk1_b = Pk1.permute(2, 0, 1).contiguous()
  rhs_b = rhs.permute(2, 0, 1).contiguous()
  ms_g, X = timed_run(lambda: lane_bank.cho_solve_lane_blocked(
      lane_bank.cholesky_lane_blocked(Pk1), rhs), 3)
  ms_l, X_l = timed_run(lambda: torch.cholesky_solve(
      rhs_b, torch.linalg.cholesky(Pk1_b)), 3)
  gains_err = float((X.permute(2, 0, 1) - X_l).abs().max()
                    / X_l.abs().max())
  log(f"gains step, {N} systems of 22 (B={B} x T-1={T - 1}), float32: "
      f"cholesky_lane_blocked + cho_solve_lane_blocked {ms_g:.3f} ms, "
      f"torch.linalg.cholesky + torch.cholesky_solve {ms_l:.3f} ms (CUDA "
      f"events, mean of 3); max difference {gains_err:.4g} of the largest "
      "entry")
  require(gains_err < 1e-3, "the blocked lane Cholesky solves the gains")
  del X, X_l, rhs, rhs_b, F, Pk1, Pk1_b, stacks

  # (g) the migration demo on the card, then its smoother
  from rednose_tpu_torch.examples.run_compat_migration import (
      MigratedKinematicKalman,
  )

  np.random.seed(0)
  kf = MigratedKinematicKalman(device=dev)
  ts_k = np.arange(0, 5, step=0.01)
  x, estimates = 0.0, []
  t0 = time.perf_counter()
  for tk, v in zip(ts_k, np.sin(ts_k * 5)):
    estimates.append(kf.predict_and_observe(tk, 1, [np.random.normal(x,
                                                                     0.1)]))
    x += v * 0.01
  torch.cuda.synchronize()
  ms_k = (time.perf_counter() - t0) * 1e3
  require(kf.filter.x.is_cuda, "the migrated filter runs on the card")
  require(abs(kf.x[0] - -0.010866289677966417) < 1e-7
          and abs(kf.x[1] - -0.8553720537261753) < 1e-7,
          f"the migrated filter hits the reference's goldens: {kf.x}")
  ms_sm, smoothed = timed(lambda: kf.filter.rts_smooth(estimates))
  xs_k = np.stack([s[0] for s in smoothed])
  require(len(smoothed) == len(estimates) and np.isfinite(xs_k).all(),
          "the migrated filter's smoother")
  log(f"migration demo (compat.EKF_sym_pyx, sympy kinematic filter, "
      f"float64 on the card): {len(ts_k)} observations {ms_k:.1f} ms, "
      f"final x {kf.x.tolist()} (the reference's goldens to 1e-7); "
      f"rts_smooth {ms_sm:.1f} ms")
  return {}


def compare_scan(torch, dev, gen, reps=5):
  """Phase 2, kernel 9 (the log scan, in tile form) against its plain
  version (build_scan_stream_reference) and against its global form (one
  thread a lane, P in global memory: the design before the tile, the same
  emitted phases) on RTS_B lanes of the offline path's live log over
  SCAN_CMP_T steps, scan_fn vmapped over the lanes, every stacked
  predicted and posterior state and the final one compared in sigmas
  (stream_err): float64 from the prior within SCAN64_TOL, also on the
  first lane alone and on the first SCAN_RAGGED_B (a ragged second
  block), and planted faults (Q's largest diagonal entry halved, Rs
  scaled by 1.01, Rs shifted by one step, which turns the lanes NaN:
  run-time values, the same build) beyond it; float32 from the state the
  float64 kernel reaches in SCAN_WARM steps, within GEN_TOL, timed (the
  kernel the mean of reps calls, CUDA events; the plain version one run);
  the tile against its global form within the same limits. Both forms
  also as raw launches in turns (global, tile, tile, global) at
  SCAN_CMP_T and at RTS_T (a float32 log from the prior). The bound: the
  emitted operations of a step (global form, the log's two kinds in
  turn) at the float32 peak, or the bytes of the inputs and of the
  stacks. Returns its row."""
  from torch.func import vmap

  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.runtime.scan import (
      build_scan_stream,
      build_scan_stream_reference,
  )

  spec = LiveKalman.build_spec()
  kernel, _ = build_scan_stream(spec, SCAN_KINDS)
  plain, _ = build_scan_stream_reference(spec, SCAN_KINDS)
  call = stream_calls()["live log scan (kernel 9)"][0]
  T, B = SCAN_CMP_T, RTS_B

  def run(fn, x0, P0, Q, dts, ki, zs, Rs, eas):
    """scan_fn vmapped over the lanes, its result bank-minor."""
    (x, P), (xp, Pp, xq, Pq) = vmap(
        lambda x, P, z: fn({}, x, P, Q, dts, ki, z, Rs, eas),
        in_dims=(0, 0, 1))(x0, P0, zs)
    return (x.T, P.permute(1, 2, 0), xp.permute(1, 2, 0),
            Pp.permute(1, 2, 3, 0), xq.permute(1, 2, 0),
            Pq.permute(1, 2, 3, 0))

  def raw(form, x0, P0, Q, dts, ki, zs, Rs, eas):
    """A raw launch of the tile or the global form on the same inputs."""
    return stream_launch(
        call.source(x0.dtype, tile=form == "tile"), call,
        x0.T.contiguous(), P0.permute(1, 2, 0).contiguous(),
        zs.transpose(1, 2).contiguous(), dts, ki, Rs)

  def err(out, ref, lanes=None):
    """stream_err of out from ref (on its first `lanes` lanes)."""
    return stream_err(spec, out, ref if lanes is None
                      else tuple(a[..., :lanes] for a in ref))

  log64 = scan_log(torch, dev, gen, SCAN_WARM + T, B, torch.float64)
  x0, P0, Q, dts, ki, zs, Rs, eas = log64
  head = (x0, P0, Q, dts[:T], ki[:T], zs[:T], Rs[:T], eas[:T])
  ref64 = run(plain, *head)
  out64 = run(kernel, *head)
  e64, g64 = err(out64, ref64), err(out64, raw("global", *head)())
  e_lanes = {b: err(run(kernel, x0[:b], P0[:b], *head[2:5], zs[:T, :b],
                        *head[6:]), ref64, b) for b in (1, SCAN_RAGGED_B)}
  Qf = Q.clone()
  i = int(torch.diagonal(Qf).argmax())
  Qf[i, i] *= 0.5
  faults = {f"Q[{i},{i}] halved": run(kernel, x0, P0, Qf, *head[3:]),
            "Rs x 1.01": run(kernel, *head[:6], 1.01 * Rs[:T], eas[:T]),
            "Rs shifted by one step": run(
                kernel, *head[:6], torch.roll(Rs[:T], 1, 0), eas[:T])}
  fault_err = {name: err(out, ref64) for name, out in faults.items()}
  log(f"stream_bank_scan [live log B={B} T={T}, float64 from the prior]: "
      f"{e64:.4g} sigma (tolerance {SCAN64_TOL}); "
      + ", ".join(f"first {b} lane{'s' if b > 1 else ''} {e:.4g}"
                  for b, e in e_lanes.items())
      + f"; against its global form {g64:.4g} sigma; planted faults "
      + ", ".join(f"{k} {v:.4g}" for k, v in fault_err.items())
      + f" sigma, each must exceed {SCAN64_TOL}, with no extra build")
  require(max(e64, g64, *e_lanes.values()) <= SCAN64_TOL
          and min(fault_err.values()) > SCAN64_TOL,
          "kernel 9 holds in float64 at B = 1, SCAN_RAGGED_B and RTS_B, "
          "against its global form, and the planted faults fail")
  # float32 from the state the float64 kernel reaches in SCAN_WARM steps
  xw, Pw = run(kernel, x0, P0, Q, dts[:SCAN_WARM], ki[:SCAN_WARM],
               zs[:SCAN_WARM], Rs[:SCAN_WARM], eas[:SCAN_WARM])[:2]
  tail = [a[SCAN_WARM:].float() if torch.is_tensor(a) else a[SCAN_WARM:]
          for a in (dts, ki, zs, Rs, eas)]
  case = (xw.T.float(), Pw.permute(2, 0, 1).float(), Q.float(), *tail)
  ms, out32 = timed_run(lambda: run(kernel, *case), reps)
  plain_ms, ref32 = timed_run(lambda: run(plain, *case), 1)
  e32 = err(out32, ref32)
  g32 = err(out32, raw("global", *case)())
  ops = step_ops(call.counting_source(), SCAN_KINDS, "mixed") * T * B
  nbytes = io_bytes([case, out32], 4)
  bound_ms, bound_by = bound(nbytes, ops)
  log(f"stream_bank_scan [live log B={B} T={T}, float32 from the float64 "
      f"kernel's state after {SCAN_WARM} steps]: kernel {ms:.4f} ms, plain "
      f"{plain_ms:.4f} ms, bound {bound_ms:.4g} ms ({bound_by}; "
      f"{ops / (T * B):,.0f} emitted operations a step); {e32:.4g} sigma, "
      f"against its global form {g32:.4g} sigma (tolerance {GEN_TOL}) -> "
      f"{'ok' if max(e32, g32) <= GEN_TOL else 'FAIL'}")
  require(max(e32, g32) <= GEN_TOL, "kernel 9 holds in float32 from a "
          "converged state, against the plain version and its global form")
  # both forms as raw launches, in turns, at T and at RTS_T from the prior
  long = scan_log(torch, dev, gen, RTS_T, B, torch.float32)
  turns = {}
  for n, args, k in ((T, case, reps), (RTS_T, long, 1)):
    launches = {form: raw(form, *args) for form in ("global", "tile")}
    turns[n] = {"global": [], "tile": []}
    for form in ("global", "tile", "tile", "global"):
      turns[n][form].append(timed_run(launches[form], k)[0])
    del launches
  log(f"stream_bank_scan raw launches in turns (global, tile, tile, "
      f"global), B={B}, float32: " + "; ".join(
          f"T={n}: global form {t['global']} ms, tile {t['tile']} ms "
          f"({min(t['tile']) / n * 1e3:.3f} us a step)"
          for n, t in turns.items()))
  return [dict(
      name="stream_bank_scan", route="cuda",
      source="rednose_tpu_torch/csrc/generic_scan.cuh",
      replaces="rednose_tpu/runtime/scan.py:90 scan_fn (an XLA program, jit "
               "of one lax.scan with a lax.switch; not Pallas)",
      max_abs_err=max(float((a - b).abs().max())
                      for a, b in zip(out32, ref32)),
      ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
      shape=f"live log B={B} T={T}, float32")]


def compare_scan_grad(torch, dev, gen, reps=3):
  """Phase 2, kernel 10 (the log scan's adjoint, the backward of scan_fn's
  custom op) against autograd through its plain version
  (build_scan_stream_reference) on RTS_B lanes of the offline path's live
  log over SCAN_CMP_T steps, scan_fn vmapped over the lanes, the loss a
  random weighting of all six outputs, the gradients of x0, P0, Q, dts, zs
  and Rs (P0's, Q's and Rs's symmetric parts) each in relative error (the
  largest difference over the plain gradient's largest entry): float64
  from the prior within GRAD64_TOL, and planted faults (Rs x 1.01, Q's
  largest diagonal entry halved: the kernel's gradient at other inputs)
  beyond it; float32 from the state the float64 kernel 9 reaches in
  SCAN_WARM steps within GRAD32_TOL, the same faults beyond it; the gated
  live spec's log from that state, every GRAD_FAR-th lane's positions
  GRAD_FAR_M off, float64 and float32 within their limits, with steps
  rejected by the forward; no gate flip on any log. Timed: the backward
  (host clock after a synchronise, one run each, the plain one the row's
  plain time); kernel 10 alone wrapped (stream_bank_scan_adjoint, CUDA
  events, mean of reps) and raw (adjoint_launch) at SCAN_CMP_T and RTS_T
  (a float32 log from the prior, kernel 9's stacks, random cotangents).
  The bound: the adjoint's emitted operations a step (the log's two kinds
  in turn) at the float32 peak, or the compulsory bytes (adjoint_bytes).
  Each variant's registers,
  stack and spills. Returns its row."""
  from torch.func import vmap

  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import generic_scan as gs
  from rednose_tpu_torch.runtime.live_bank import gated_live_spec
  from rednose_tpu_torch.runtime.scan import (
      build_scan_stream,
      build_scan_stream_reference,
  )

  spec = LiveKalman.build_spec()
  kernel, _ = build_scan_stream(spec, SCAN_KINDS)
  plain, _ = build_scan_stream_reference(spec, SCAN_KINDS)
  gkernel, _ = build_scan_stream(gated_live_spec(), SCAN_KINDS)
  gplain, _ = build_scan_stream_reference(gated_live_spec(), SCAN_KINDS)
  calls = adjoint_calls()
  call = calls["live log adjoint (kernel 10)"][0]
  T, B, dx, de = SCAN_CMP_T, RTS_B, spec.dim_x, spec.dim_err
  names = ("x0", "P0", "Q", "dts", "zs", "Rs")

  def grads(fn, W, x0, P0, Q, dts, ki, zs, Rs, eas):
    """(gradients by names, backward ms, rejected lane-steps): autograd
    through fn vmapped over the lanes, the loss W's weighting of the six
    outputs; a step is rejected where P's diagonal leaves the update as
    predicted."""
    ins = [a.detach().clone().requires_grad_()
           for a in (x0, P0, Q, dts, zs, Rs)]
    X0, PP0, QQ, DT, ZS, RR = ins
    (x, P), st = vmap(lambda xl, Pl, zl: fn({}, xl, Pl, QQ, DT, ki, zl, RR,
                                            eas),
                      in_dims=(0, 0, 1))(X0, PP0, ZS)
    loss = sum((o * w).sum() for o, w in zip((x, P, *st), W))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = list(torch.autograd.grad(loss, ins))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    for i in (1, 2, 5):
      g[i] = g[i] + g[i].transpose(-1, -2)
    diag = lambda a: torch.diagonal(a.detach(), dim1=-2, dim2=-1)  # noqa: E731
    rejected = int((diag(st[1]) == diag(st[3])).all(-1).sum())
    return dict(zip(names, g)), ms, rejected

  def rel(a, b):
    return {n: float(((a[n] - b[n]).abs().max() / b[n].abs().max())
                     .nan_to_num(nan=float("inf"))) for n in names}

  def weights(dtype):
    return [torch.randn(s, generator=gen, device=dev, dtype=dtype) for s in (
        (B, dx), (B, de, de), (B, T, dx), (B, T, de, de), (B, T, dx),
        (B, T, de, de))]

  def flips():
    return int(gs.stream_bank_scan_adjoint.gate_flips.sum())

  def planted(W, args, ref):
    """The largest relative error against ref of kernel 10's gradients at
    planted faults of args: Rs x 1.01, Q's largest diagonal entry
    halved."""
    Qf = args[2].clone()
    i = int(torch.diagonal(Qf).argmax())
    Qf[i, i] *= 0.5
    runs = {"Rs x 1.01": (*args[:6], 1.01 * args[6], args[7]),
            f"Q[{i},{i}] halved": (*args[:2], Qf, *args[3:])}
    return {k: max(rel(grads(kernel, W, *a)[0], ref).values())
            for k, a in runs.items()}

  def said(errs):
    return ", ".join(f"{n} {e:.4g}" for n, e in errs.items())

  log64 = scan_log(torch, dev, gen, SCAN_WARM + T, B, torch.float64)
  x0, P0, Q, dts, ki, zs, Rs, eas = log64
  head = (x0, P0, Q, dts[:T], ki[:T], zs[:T], Rs[:T], eas[:T])
  W64 = weights(torch.float64)
  g64, _, _ = grads(kernel, W64, *head)
  f64 = flips()
  r64, plain64_ms, _ = grads(plain, W64, *head)
  e64 = rel(g64, r64)
  fault_err = planted(W64, head, r64)
  log(f"kernel 10 [live log B={B} T={T}, float64 from the prior]: relative "
      f"error {said(e64)} (tolerance {GRAD64_TOL}); gate flips {f64}; "
      f"planted faults {said(fault_err)}, each must exceed {GRAD64_TOL}, "
      "with no extra build")
  require(max(e64.values()) <= GRAD64_TOL and f64 == 0
          and min(fault_err.values()) > GRAD64_TOL,
          "kernel 10 holds in float64 against autograd through the plain "
          "version, without a gate flip, and the planted faults fail")
  # float32 from the state the float64 kernel 9 reaches in SCAN_WARM steps
  with torch.no_grad():
    (xw, Pw), _ = vmap(lambda xl, Pl, zl: kernel(
        {}, xl, Pl, Q, dts[:SCAN_WARM], ki[:SCAN_WARM], zl, Rs[:SCAN_WARM],
        eas[:SCAN_WARM]), in_dims=(0, 0, 1))(x0, P0, zs[:SCAN_WARM])
  tail = [a[SCAN_WARM:].float() if torch.is_tensor(a) else a[SCAN_WARM:]
          for a in (dts, ki, zs, Rs, eas)]
  case = (xw.float(), Pw.float(), Q.float(), *tail)
  W32 = [w.float() for w in W64]
  g32, kernel_bw_ms, _ = grads(kernel, W32, *case)
  f32 = flips()
  r32, plain_ms, _ = grads(plain, W32, *case)
  e32 = rel(g32, r32)
  fault32 = planted(W32, case, r32)
  log(f"kernel 10 [live log B={B} T={T}, float32 from the float64 kernel's "
      f"state after {SCAN_WARM} steps]: relative error {said(e32)} "
      f"(tolerance {GRAD32_TOL}); gate flips {f32}; planted faults "
      f"{said(fault32)}, each must exceed {GRAD32_TOL}; backward "
      f"{kernel_bw_ms:.1f} ms through kernel 10, {plain_ms:.1f} ms through "
      "the plain version (host clock, one run each)")
  require(max(e32.values()) <= GRAD32_TOL and f32 == 0
          and min(fault32.values()) > GRAD32_TOL,
          "kernel 10 holds in float32 from a converged state, and the "
          "planted faults fail")
  # the gated live spec from the same state, outliers on every
  # GRAD_FAR-th lane: the gate rejects their positions
  far = zs[SCAN_WARM:].clone()
  far[0::2, ::GRAD_FAR] += GRAD_FAR_M
  for dtype, W, tol in ((torch.float64, W64, GRAD64_TOL),
                        (torch.float32, W32, GRAD32_TOL)):
    args = [a.to(dtype) if torch.is_tensor(a) else a for a in (
        xw, Pw, Q, dts[SCAN_WARM:], ki[SCAN_WARM:], far, Rs[SCAN_WARM:],
        eas[SCAN_WARM:])]
    g, _, rejected = grads(gkernel, W, *args)
    fg = flips()
    r, _, rejected_plain = grads(gplain, W, *args)
    e = rel(g, r)
    log(f"kernel 10 [gated live log B={B} T={T}, "
        f"{str(dtype).split('.')[-1]} from the float64 kernel's state after "
        f"{SCAN_WARM} steps, every {GRAD_FAR}th lane's positions "
        f"{GRAD_FAR_M} m off]: relative error {said(e)} (tolerance {tol}); "
        f"rejected lane-steps {rejected} (the plain version {rejected_plain}"
        f"); gate flips {fg}")
    require(max(e.values()) <= tol and fg == 0 and rejected > 0,
            "kernel 10 follows the forward's gate decisions: steps rejected, "
            "no flip, gradients within the limit")

  # kernel 10 alone, wrapped and raw, at T and at RTS_T from the prior
  def bank_case(args):
    """Kernel 9's stacks of args (scan_fn's layout) and random cotangents,
    all bank-minor: (x0, P0, zs, dts, ki, Rs, stacks, cotangents)."""
    x0_, P0_, _, dts_, ki_, zs_, Rs_, _ = args
    x0b, P0b = x0_.T.contiguous(), P0_.permute(1, 2, 0).contiguous()
    zsb = zs_.transpose(1, 2).contiguous()
    stacks = stream_launch(fwd_call.source(torch.float32), fwd_call, x0b,
                           P0b, zsb, dts_, ki_, Rs_)()[2:]
    cots = [torch.randn(a.shape, generator=gen, device=dev)
            for a in (x0b, P0b, *stacks)]
    return x0b, P0b, zsb, dts_, ki_, Rs_, stacks, cots

  fwd_call = stream_calls()["live log scan (kernel 9)"][0]
  long = scan_log(torch, dev, gen, RTS_T, B, torch.float32)
  src = call.source(torch.float32)
  times, shapes = {}, {}
  for n, args in ((T, case), (RTS_T, long)):
    x0b, P0b, zsb, dts_, ki_, Rs_, stacks, cots = bank_case(args)
    ki32 = torch.as_tensor(ki_, device=dev).to(torch.int32)
    prm = torch.zeros(1, device=dev)
    Qd = torch.as_tensor(call.Q, dtype=torch.float32, device=dev)
    k = reps if n == T else 2
    wrapped, out = timed_run(lambda: gs.stream_bank_scan_adjoint(
        call, x0b, P0b, zsb, dts_, ki32, Rs_, None, prm, Qd, *stacks,
        *cots), k)
    raw, _ = timed_run(adjoint_launch(src, call, x0b, P0b, zsb, dts_, ki_,
                                      Rs_, stacks, cots), k)
    times[n] = (wrapped, raw)
    shapes[n] = adjoint_bytes(call, np.asarray(ki_), B, 4)
    del stacks, cots, out
  ops_step = step_ops(call.counting_source(), SCAN_KINDS, "mixed")
  bounds = {n: bound(shapes[n], ops_step * n * B) for n in times}
  bound_ms, bound_by = bounds[T]
  for name, (c, dtype) in calls.items():
    s = c.source(dtype)
    info = _build.generated_info(s)
    spills = [ln.split("info    :")[-1].strip() for ln in
              _build.generated_ptxas(s).splitlines()
              if "spill" in ln or "nvcc" in ln]
    log(f"{name}, {str(dtype).split('.')[-1]}: design "
        f"{'tile' if info['design'] else 'global'}, {info['threads']} threads "
        f"a block, {info['blocks_per_sm']} blocks an SM, {info['registers']} "
        f"registers, {info['local_bytes']} B of stack a thread; "
        f"{len(s.splitlines())} lines; ptxas {spills}")
  log(f"stream_bank_scan_adjoint (kernel 10) [live log B={B}, float32]: "
      + "; ".join(f"T={n}: wrapped {w:.4f} ms, raw {r:.4f} ms (CUDA events), "
                  f"{r / n * 1e3:.3f} us a step, bound {bounds[n][0]:.4g} ms "
                  f"({bounds[n][1]})" for n, (w, r) in times.items())
      + f"; {ops_step:,.0f} emitted operations a step; plain version "
      f"(autograd through build_scan_stream_reference, T={T}) {plain_ms:.1f} "
      "ms")
  return [dict(
      name="stream_bank_scan_adjoint", route="cuda",
      source="rednose_tpu_torch/csrc/stream_adjoint.cuh",
      replaces="jax.grad of rednose_tpu/runtime/scan.py:90 scan_fn (XLA's "
               "transpose of the lax.scan; not Pallas)",
      max_abs_err=max(float((g32[n] - r32[n]).abs().max()) for n in names),
      ms=times[T][0], plain_ms=plain_ms, bound_ms=bound_ms,
      bound_by=bound_by, shape=f"live log B={B} T={T}, float32")]


def ml_sim(T, q_true, seed):
  """tests/test_differentiable._sim: a 1-D constant-velocity truth with
  velocity noise q_true * 0.01 a step, measured with noise 0.1. Returns
  the measurements."""
  rng = np.random.default_rng(seed)
  xs, v, x = np.zeros((T,)), 0.0, 0.0
  for k in range(T):
    v += rng.normal(0, q_true * 0.01)
    x += v * 0.01
    xs[k] = x
  return xs + rng.normal(0, 0.1, T)


def ml_tuning(torch, dev):
  """Phase 2, the maximum-likelihood tuning of tests/test_differentiable.py
  on the card through kernels 9 and 10: the kinematic filter's innovation
  NLL (mean over ML_T steps, from scan_fn's predicted stacks) under
  Q = diag(0.1^2, exp(log q)), ML_STEPS momentum steps from log 1e-4 and
  log 1e4, float64; each gradient one launch of kernel 9 and one of
  kernel 10. Both estimates within ML_RATIO of each other in log and
  within ML_BAND of the ML optimum 0.2."""
  from rednose_tpu_torch.models.kinematic import (
      KinematicKalman,
      ObservationKind as KK,
  )
  from rednose_tpu_torch.ops import generic_scan as gs
  from rednose_tpu_torch.runtime.scan import (
      build_scan_stream,
      build_scan_stream_reference,
  )

  f = dict(dtype=torch.float64, device=dev)
  z = torch.as_tensor(ml_sim(ML_T, 2.0, 1), **f)
  fn, _ = build_scan_stream(KinematicKalman.build_spec(), (KK.POSITION,))
  x0 = torch.as_tensor(KinematicKalman.initial_x, **f)
  P0 = torch.as_tensor(np.diag(KinematicKalman.initial_P_diag), **f)
  dts, ki = torch.full((ML_T,), 0.01, **f), np.zeros(ML_T, np.int32)
  Rs, eas = torch.full((ML_T, 1, 1), 0.1**2, **f), torch.zeros((ML_T, 1), **f)

  def nll_grad(log_q):
    lq = log_q.clone().requires_grad_()
    Q = torch.diag(torch.stack([torch.full((), 0.1**2, **f), torch.exp(lq)]))
    _, (xp, Pp, _, _) = fn({}, x0, P0, Q, dts, ki, z[:, None], Rs, eas)
    S = Pp[:, 0, 0] + 0.1**2
    nll = (0.5 * (torch.log(S) + (z - xp[:, 0]) ** 2 / S)).mean()
    return torch.autograd.grad(nll, lq)[0]

  def fit(log_q0, lr=2.0, momentum=0.9):
    log_q, m = torch.tensor(log_q0, **f), torch.zeros((), **f)
    for _ in range(ML_STEPS):
      m = momentum * m + nll_grad(log_q)
      log_q = log_q - lr * m
    return float(torch.exp(0.5 * log_q))

  n9, n10 = gs.stream_bank_scan.launches, gs.stream_bank_scan_adjoint.launches
  r = build_scan_stream_reference.launches
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  est_lo, est_hi = fit(np.log(1e-4)), fit(np.log(1e4))
  secs = time.perf_counter() - t0
  k9, k10 = (gs.stream_bank_scan.launches - n9,
             gs.stream_bank_scan_adjoint.launches - n10)
  truth = 2.0 * 0.01 / np.sqrt(0.01)
  log(f"ML noise tuning (kinematic, T={ML_T}, {ML_STEPS} momentum steps from "
      f"q = 1e-4 and 1e4, float64): estimates {est_lo:.6g} and {est_hi:.6g} "
      f"(ML optimum {truth:.4g}; log-ratio {abs(np.log(est_lo / est_hi)):.4g},"
      f" limit {ML_RATIO}); kernel 9 {k9} launches, kernel 10 {k10}; "
      f"{secs:.1f} s (host clock), {secs / (2 * ML_STEPS) * 1e3:.2f} ms a "
      "gradient")
  require(k9 == k10 == 2 * ML_STEPS
          and build_scan_stream_reference.launches == r,
          "each gradient of the ML tuning is one launch of kernel 9 and one "
          "of kernel 10, and no run of the plain version")
  require(abs(np.log(est_lo / est_hi)) < ML_RATIO
          and ML_BAND[0] * truth < est_lo < ML_BAND[1] * truth,
          f"the ML tuning recovers q from both starts: {est_lo}, {est_hi}")


def full_q_data(torch, x, T, kinds, R_list, noise, gen, far_every=0,
                dt=0.01):
  """A schedule cycling through `kinds` (kind_idx t % len(kinds)) for the
  bank state x (23, B), moved to a constant 1 m/s on each axis (angular
  velocity and acceleration 0): each kind's z is its h at the lane's
  state at that step (the position carried forward by the velocity; the
  rest stays) plus `noise` of the kind's sigma (from R_list); on every
  far_every-th lane the ECEF_POS rows sit FAR_SIGMA sigmas off. Returns
  (x, kind_idx (T,) int32, zs (T, 3, B)), in x's dtype."""
  from torch.func import vmap

  from rednose_tpu_torch.models.live import (
      ObservationKind as K,
      build_live_spec,
  )

  spec = build_live_spec()
  dev, B = x.device, x.shape[1]
  x = x.clone()
  x[7:10], x[10:13], x[17:20] = 1.0, 0.0, 0.0
  xs = x.double().T
  H = torch.zeros((len(kinds), B, 3), dtype=torch.float64, device=dev)
  sig = torch.zeros((len(kinds), 3), dtype=torch.float64, device=dev)
  for i, k in enumerate(kinds):
    om = spec.obs[k]
    H[i, :, :om.dz] = vmap(lambda xx: om.h({}, xx, None).reshape(-1))(xs)
    sig[i, :om.dz] = torch.as_tensor(np.sqrt(np.diag(np.atleast_2d(
        R_list[i]))), device=dev)
  kind_idx = np.arange(T) % len(kinds)
  ki = torch.as_tensor(kind_idx, device=dev)
  zs = H[ki] + noise * sig[ki][:, None, :] * torch.randn(
      (T, B, 3), generator=gen, device=dev, dtype=torch.float64)
  i = kinds.index(K.ECEF_POS)
  rows = ki == i
  step = torch.arange(1, T + 1, dtype=torch.float64, device=dev)
  zs[rows] += (dt * step[rows])[:, None, None] * xs[None, :, 7:10]
  if far_every:
    far = torch.arange(B, device=dev) % far_every == 0
    zs[rows[:, None] & far[None, :]] += FAR_SIGMA * sig[i]
  return (x, torch.as_tensor(kind_idx, dtype=torch.int32, device=dev),
          zs.to(x.dtype).permute(0, 2, 1).contiguous())


def compare_full_q(torch, dev, gen, hand_states, reps=5):
  """Phase 2, the full-Q variants against their plain versions at T =
  CMP_T from kernel 3's converged state, float32 at GEN_TOL (the live
  spec rows' limit): kernel 4 and kernel 6 as the main path makes them
  (kernel 6 on the main path's 4-kind cycle and on all 8 live kinds), and
  their gate=True variants on data far past the gate on every FAR_EVERY-th
  lane, where the gate must act. Then kernel 6 over the 8 kinds in double
  at LIVE64_TOL, with planted faults (each unit left out: its R scaled by
  1e12; Q's velocity-acceleration coupling dropped, scaled by 1e-9, or
  halved; run-time values, the same build) that must exceed it."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.ops import generic_scan as gs
  from rednose_tpu_torch.runtime.live_bank import LIVE_KINDS

  calls = full_q_calls()
  c4 = calls["live full Q run (kernel 4)"]
  c6 = calls["live full Q run_mixed / observe (kernel 6)"]
  g4, g6 = full_q_cmp_calls().values()
  live_spec = c4.spec
  f32 = dict(dtype=torch.float32, device=dev)
  dts = torch.full((CMP_T,), 0.01, **f32)
  x, P = hand_states["live_bank_scan_mixed"][:2]
  rows, checks = [], []
  zs = (torch.as_tensor(LiveKalman.initial_x[0:3], **f32)[:, None]
        + 5.0 * torch.randn((CMP_T, 3, GEN_B), generator=gen,
                            device=dev)).contiguous()
  kw4 = dict(spec=live_spec, kind=K.ECEF_POS, Q=c4.Q, R=c4.R_list[0],
             gate=False, structure=c4.structure)
  row, _, _ = kernel_vs_plain(
      "generic_bank_scan", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:199", live_spec, gs.generic_bank_scan,
      gs.generic_bank_scan_reference, (x, P, zs, dts), kw4,
      f"live spec, full Q, B={GEN_B} T={CMP_T}, from kernel 3's state",
      step_ops(c4.counting_source(), (K.ECEF_POS,)) * CMP_T * GEN_B,
      checks=checks, reps=reps)
  rows.append(row)
  kinds, kind_idx, zs_m = mixed_schedule(torch, dev, gen, CMP_T)
  ki = torch.as_tensor([LIVE_KINDS.index(kinds[i]) for i in kind_idx],
                       dtype=torch.int32, device=dev)
  kw6 = dict(spec=live_spec, kinds=LIVE_KINDS, Q=c6.Q, R_list=c6.R_list,
             gate=False, structure=c6.structure)
  row, _, _ = kernel_vs_plain(
      "generic_bank_scan_mixed", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:250", live_spec,
      gs.generic_bank_scan_mixed, gs.generic_bank_scan_mixed_reference,
      (x, P, zs_m.permute(0, 2, 1).contiguous(), dts, ki), kw6,
      f"live spec, full Q, B={GEN_B} T={CMP_T}, 4 of its 8 kinds, from "
      "kernel 3's state",
      step_ops(c6.counting_source(), kinds, "mixed") * CMP_T * GEN_B,
      checks=checks, reps=reps)
  rows.append(row)

  # every unit of the 8-kind variant: the camera translation with an
  # explicit R, as run_mixed's R_by_kind gives it
  R8 = [CAM_TRANS_R * np.eye(3) if k == K.CAMERA_ODO_TRANSLATION else R
        for k, R in zip(LIVE_KINDS, c6.R_list)]
  kw8 = kw6 | dict(R_list=R8)
  x8, ki8, zs8 = full_q_data(torch, x, CMP_T, LIVE_KINDS, R8, 1.0, gen)
  ops8 = step_ops(c6.counting_source(), LIVE_KINDS, "mixed") * CMP_T * GEN_B
  row, _, _ = kernel_vs_plain(
      "generic_bank_scan_mixed", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:250", live_spec,
      gs.generic_bank_scan_mixed, gs.generic_bank_scan_mixed_reference,
      (x8, P, zs8, dts, ki8), kw8,
      f"live spec, full Q, B={GEN_B} T={CMP_T}, all 8 kinds, from kernel "
      "3's state at 1 m/s", ops8, checks=checks, reps=reps)
  rows.append(row)

  # the gate=True variants: far lanes must come out of the gate other
  # than out of the same plain version with the gate off
  far = torch.arange(GEN_B, device=dev) % FAR_EVERY == 0
  gated = (
      ("generic_bank_scan", "rednose_tpu/ops/pallas_bank.py:199", g4,
       gs.generic_bank_scan, gs.generic_bank_scan_reference,
       (K.ECEF_POS,), dict(spec=g4.spec, kind=K.ECEF_POS, Q=g4.Q,
                           R=g4.R_list[0], structure=g4.structure)),
      ("generic_bank_scan_mixed", "rednose_tpu/ops/pallas_bank.py:250", g6,
       gs.generic_bank_scan_mixed, gs.generic_bank_scan_mixed_reference,
       LIVE_KINDS, dict(spec=g6.spec, kinds=LIVE_KINDS, Q=g6.Q, R_list=R8,
                        structure=g6.structure)))
  for name, replaces, call, kernel, plain, gkinds, kw in gated:
    R_list = [kw["R"]] if "R" in kw else kw["R_list"]
    xg, kig, zsg = full_q_data(torch, x, CMP_T, gkinds, R_list, GATE_NOISE,
                               gen, far_every=FAR_EVERY)
    args = (xg, P, zsg, dts) + ((kig,) if len(gkinds) > 1 else ())
    mode = "mixed" if len(gkinds) > 1 else "single"
    row, _, out_p = kernel_vs_plain(
        name, "rednose_tpu_torch/csrc/generic_scan.cuh", replaces,
        live_spec, kernel, plain, args, kw | dict(gate=True),
        f"live spec, full Q, gate on, B={GEN_B} T={CMP_T}, {len(gkinds)} "
        f"kind(s), ECEF_POS {FAR_SIGMA:g} sigma off on every "
        f"{FAR_EVERY}th lane", step_ops(call.counting_source(), gkinds,
                                         mode) * CMP_T * GEN_B,
        checks=checks, reps=reps)
    rows.append(row)
    open_ = plain(*args, **(kw | dict(spec=live_spec, gate=False)))
    moved = lane_errs(out_p, open_, live_spec)
    ok = bool((moved[far] > 1.0).all()) and float(moved[~far].max()) <= \
        GEN_TOL
    log(f"{name} gate on [{len(gkinds)} kind(s)]: against the gate off, "
        f"far lanes moved min {float(moved[far].min()):.4g} sigma (must "
        f"exceed 1), near lanes max {float(moved[~far].max()):.4g} sigma "
        f"(must stay within {GEN_TOL}: no near lane gated) "
        f"-> {'ok' if ok else 'FAIL'}")
    checks.append((f"{name} gate on rejects the far lanes only", ok))

  # kernel 6's full-Q variant in double over the 8 kinds, and planted
  # faults beyond LIVE64_TOL with no extra build
  x64, ki64, zs64 = full_q_data(torch, x.double(), CMP_T, LIVE_KINDS, R8,
                                1.0, gen)
  args64 = (x64, P.double(), zs64, dts.double(), ki64)
  _, _, ref64 = kernel_vs_plain(
      "generic_bank_scan_mixed", "", "", live_spec,
      gs.generic_bank_scan_mixed, gs.generic_bank_scan_mixed_reference,
      args64, kw8, f"live spec, full Q, B={GEN_B} T={CMP_T}, all 8 kinds, "
      "float64", ops8, tol=LIVE64_TOL, checks=checks, reps=reps)
  builds = _build.generated_launcher.cache_info().currsize
  faults = {}
  for u, k in enumerate(LIVE_KINDS):
    faults[f"unit {u} (kind {int(k)}) left out"] = kw8 | dict(
        R_list=[R * (1e12 if j == u else 1.0) for j, R in enumerate(R8)])
  for label, scale in (("dropped", 1e-9), ("halved", 0.5)):
    Qf = full_q()
    for i in range(3):
      Qf[6 + i, 16 + i] = Qf[16 + i, 6 + i] = Qf[6 + i, 16 + i] * scale
    faults[f"Q's velocity-acceleration coupling {label}"] = kw8 | dict(Q=Qf)
  miss = {name: float(lane_errs(gs.generic_bank_scan_mixed(*args64, **kw),
                                ref64, live_spec).max())
          for name, kw in faults.items()}
  least = min(miss, key=miss.get)
  ok = (miss[least] > LIVE64_TOL
        and _build.generated_launcher.cache_info().currsize == builds)
  for name, m in miss.items():
    log(f"  planted fault, {name}: {m:.4g} sigma")
  log(f"generic_bank_scan_mixed planted faults [live spec, full Q, 8 kinds, "
      f"float64]: {len(miss)} faults, the least visible ({least}) at "
      f"{miss[least]:.4g} sigma, must exceed {LIVE64_TOL}, with no extra "
      f"build -> {'ok' if ok else 'FAIL'}")
  checks.append(("full-Q planted faults beyond the limit", ok))
  require(all(ok for _, ok in checks),
          f"the full-Q kernels agree with their plain versions: {checks}")
  return rows


# ------------------------------------------------------------- examples

# the port's ten examples (rednose_tpu_torch/examples), each at its own
# sizes, and the launches each must make on the card: none in the seven
# single-filter examples (run_loc's engine half among them) and in
# run_bank (the plain runtime/bank); kernel 6 in run_loc's bank_demo;
# kernel 3 in run_mixed_bank; kernel 6 with frames in run_msckf_bank's
# run_mixed and kernel 7 in its observe_frame calls (2 in order, a late
# one that replays the second: 2 launches, a too-old one dropped)
EXAMPLES = {
    "run_kinematic": {}, "run_live": {}, "run_car": {},
    "run_loc": {"generic_bank_scan_mixed": 1},
    "run_compat_migration": {}, "run_msckf": {"compute_pos_batch": 20},
    "run_vo_pipeline": {"compute_pos_batch": 3},
    "run_mixed_bank": {"live_bank_scan_mixed": 1},
    "run_msckf_bank": {"generic_bank_scan_mixed": 1, "vo_bank_scan": 4},
    "run_bank": {},
}


def example_calls(torch, dev):
  """The generic calls of the bank examples, as their banks make them, with
  the dtype each runs: run_loc's bank_demo (kernel 6 on loc, float32),
  run_msckf_bank's run_mixed (kernel 6 with camera frames on msckf_eskf)
  and observe_frame (kernel 7), float64."""
  from rednose_tpu_torch.examples import run_loc, run_msckf_bank as mb
  from rednose_tpu_torch.models.loc import LocKalman
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
  from rednose_tpu_torch.runtime.generic_bank import KalmanBank
  from rednose_tpu_torch.runtime.msckf_bank import MSCKFBank

  def defaults(bank, kinds):
    return [bank._normalize_R(k, bank._default_R(k)) for k in kinds]

  loc = KalmanBank(LocKalman, batch=run_loc.BANK_B, device=dev)
  kinds = run_loc.bank_demo_data()[0]
  _, xs, kinds_m, *_ = mb.data()
  bank = MSCKFBank(MSCKFEskf, batch=mb.B, dtype=torch.float64, x0=xs,
                   device=dev)
  fk = (bank.feature_kind,)
  return {
      "run_loc bank_demo (kernel 6, loc)": (
          loc._call("mixed", kinds, defaults(loc, kinds)), torch.float32),
      "run_msckf_bank run_mixed (kernel 6 with frames)": (
          bank._call("mixed", kinds_m, defaults(bank, kinds_m)),
          torch.float64),
      "run_msckf_bank observe_frame (kernel 7)": (
          bank._call("frame", fk, defaults(bank, fk)), torch.float64),
  }


def examples_path(torch, dev, launches):
  """Phase 1, the examples: each example's main(device="cuda"), the launch
  counts set to 0 just before it and read just after it (added to
  `launches`); its own asserts hold and it launches exactly its kernels
  (EXAMPLES). Wall time on the host clock after a synchronise. Returns
  {example: its numbers}."""
  import importlib

  from rednose_tpu_torch.examples import kernel_wrappers

  wrappers = kernel_wrappers()
  out = {}
  for name, expected in EXAMPLES.items():
    mod = importlib.import_module(f"rednose_tpu_torch.examples.{name}")
    for w in wrappers:
      w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out[name] = mod.main(device=str(dev))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {w.__name__: w.launches for w in wrappers if w.launches}
    log(f"example {name}: {ms:.1f} ms (host clock, first call, after a "
        f"synchronise), launches {counts}")
    require(counts == expected,
            f"example {name} launched {counts}, expected {expected}")
    for w in wrappers:
      launches[w.__name__] = launches.get(w.__name__, 0) + w.launches
  require(out["run_loc"]["launches"] == EXAMPLES["run_loc"],
          "run_loc's engine half launched no kernel")
  require(out["run_mixed_bank"]["launches"] == EXAMPLES["run_mixed_bank"]
          and out["run_msckf_bank"]["launches"] == EXAMPLES["run_msckf_bank"],
          "the bank examples report the kernels they launched")
  return out


# the eighth path's ranks: two Gloo ranks sharing the one card (NCCL takes
# one rank a device)
SHARD_RANKS = 2


def sharded_path(torch, dev, card, launches, sources):
  """Phase 1, the sharded bank (parallel/sharding.py, the cases of
  parallel/dryrun.py at its "full" widths): each case's unsharded call
  first (the references, not counted), then the launch counts set to 0
  and (a) one rank in this process on make_bank_mesh() (a one-rank
  "cpu:gloo,cuda:nccl" group, as a user with one card gets it) and (b)
  SHARD_RANKS Gloo ranks spawned on the card, each on its block of every
  bank; each rank's counts come back with its results and are added to
  `launches`. Every kernel case launches its kernel once a rank on B/n
  lanes and, gathered, equals the unsharded launch bitwise; the RMSE
  (1-D and multislice) and the time-sharded smoother within dryrun's
  tolerances. The ranks load the prebuilt variants (dryrun.require_built)
  and never build. Prints (a)'s and (b)'s wall times and each rank's
  CUDA-event time for each kernel case, the ranks sharing the card."""
  import torch.distributed as dist

  from rednose_tpu_torch.examples import kernel_wrappers
  from rednose_tpu_torch.parallel import dryrun, sharding

  names = tuple(dryrun.CASES)
  generic = [n for n in names if dryrun.CASES[n].inputs in (
      "generic_live", "car", "mixed_live", "vio", "epoch", "vo")]
  require({dryrun.kernel_call(n).source() for n in generic}
          <= set(sources.values()),
          "the sharded path's generic variants are among the prebuilt ones")
  t0 = time.perf_counter()
  refs = dryrun.unsharded_outputs("full", dev, names)
  log(f"sharded path: the unsharded references in "
      f"{time.perf_counter() - t0:.1f} s")
  wrappers = kernel_wrappers()
  for w in wrappers:
    w.launches = 0
  t0 = time.perf_counter()
  mesh = sharding.make_bank_mesh()
  res = dryrun.run_cases(mesh, sharding.make_multislice_mesh(1), "full",
                         names, keep_outputs=True)
  wall_a = time.perf_counter() - t0
  counts = {w.__name__: w.launches for w in wrappers if w.launches}
  dryrun.verify([dict(res, rank=0)], "full", refs, dev)
  log(f"sharded path (a), one rank in this process ({dist.get_backend()}, "
      f"mesh of {mesh.size()}): every case equal to the unsharded call, "
      f"{wall_a:.1f} s (host clock); launches {counts}")
  t0 = time.perf_counter()
  results = dryrun.spawn_ranks(SHARD_RANKS, "cuda", "full", names)
  wall_b = time.perf_counter() - t0
  rows = dryrun.verify(results, "full", refs, dev)
  require({r["device"] for r in results} == {"cuda:0"},
          "both ranks ran on cuda:0")
  for r in results:
    for name in names:
      for k, n in r[name]["counts"].items():
        counts[k] = counts.get(k, 0) + n
  for w in wrappers:
    w.launches = counts.get(w.__name__, 0)
    launches[w.__name__] = launches.get(w.__name__, 0) + w.launches
  log(f"sharded path (b), {SHARD_RANKS} Gloo ranks sharing the card "
      f"({card}): spawn to results {wall_b:.1f} s (host clock; by rank, "
      f"group, meshes and emission "
      + " / ".join(f"{r['setup_s']:.1f}" for r in results)
      + " s, inputs "
      + " / ".join(f"{sum(r[n]['inputs_s'] for n in names):.1f}"
                   for r in results)
      + f" s); every case equal to the unsharded call; launches with "
      f"(a)'s {counts}")
  for row in rows:
    errs = ", ".join(f"{k} {v:.3g}" for k, v in row["errs"].items() if v)
    ms = ("" if row["ms"][0] is None else ", CUDA-event ms by rank "
          + " / ".join(f"{m:.4f}" for m in row["ms"]))
    log(f"  {row['case']}: {row['lanes']} of {row['batch']} lanes a rank"
        f"{', ' + row['kernel'] + ' once a rank' if row['kernel'] else ''}"
        f"{ms}, wall s by rank "
        + " / ".join(f"{w:.3f}" for w in row["wall_s"])
        + (f"; relative errors {errs}" if errs else "; exact"))
  return counts


def compare_examples(torch, dev, reps=10):
  """Phase 2, the examples' variants against their plain versions, on each
  example's own data and state, in sigmas (utils/compare.py), each timed
  wrapped and raw (at the example's T and at T = 1) with its design:
  kernel 6 on loc (run_loc's bank_demo, B = 64, T = 16): its float64
  build against the float64 plain version within LOC64_TOL, the float32
  agreement printed (loc in float32 at ECEF scale: see LOC64_TOL); kernel
  6 with camera frames on msckf_eskf in float64 (run_msckf_bank's
  run_mixed, B = 64, T = 24) within MSCKF64_TOL; kernel 7 in float64 at
  T = 1 (its late observe_frame) from the plain version's state after that
  run_mixed, within MSCKF64_TOL. Returns the rows."""
  from rednose_tpu_torch import _build
  from rednose_tpu_torch.examples import run_loc, run_msckf_bank as mb
  from rednose_tpu_torch.models.loc import LocKalman
  from rednose_tpu_torch.models.msckf_eskf import MSCKFEskf
  from rednose_tpu_torch.ops import generic_scan as gs

  calls = example_calls(torch, dev)
  rows, checks = [], []

  def mixed_kw(call, eas):
    return dict(spec=call.spec, kinds=call.kinds, Q=call.Q,
                R_list=call.R_list, structure=call.structure, eas=eas)

  def bank0(model, xs, dtype):
    d = dict(dtype=dtype, device=dev)
    return (torch.as_tensor(xs.T, **d).contiguous(),
            torch.as_tensor(np.diag(model.initial_P_diag), **d)[
                :, :, None].repeat(1, 1, xs.shape[0]))

  def raw(name, call, dtype, args, eas, ki):
    x, P, zs, dts = args[:4]
    src = call.source(dtype)

    def launch(n):
      return generic_launch(src, call, x, P, zs[:n], dts[:n], eas[:n],
                            None, None if ki is None else ki[:n])

    T = dts.shape[0]
    ms = {n: timed_run(launch(n), 20 if n == 1 else 5)[0] for n in (T, 1)}
    log(variant_line(name, _build.generated_info(src), x.shape[-1], ms))

  # kernel 6 on loc: bank_demo's data from LocKalman's x0 and P0
  name = "run_loc bank_demo (kernel 6, loc)"
  call = calls[name][0]
  kinds, kind_idx, zs, eas, _ = run_loc.bank_demo_data()
  B, T = run_loc.BANK_B, run_loc.BANK_T
  ki = torch.as_tensor(kind_idx, dtype=torch.int32, device=dev)
  ops = step_ops(call.counting_source(), kinds, "mixed") * T * B

  def loc_args(dtype):
    d = dict(dtype=dtype, device=dev)
    x, P = bank0(LocKalman, np.tile(LocKalman.initial_x, (B, 1)), dtype)
    return ((x, P, torch.as_tensor(zs, **d).transpose(1, 2).contiguous(),
             torch.full((T,), 0.1, **d), ki),
            torch.as_tensor(eas, **d).transpose(1, 2).contiguous())

  (args32, eas32), (args64, eas64) = loc_args(torch.float32), \
      loc_args(torch.float64)
  row, _, _ = kernel_vs_plain(
      "generic_bank_scan_mixed", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:250", call.spec,
      gs.generic_bank_scan_mixed, gs.generic_bank_scan_mixed_reference,
      args64, mixed_kw(call, eas64),
      f"loc B={B} T={T} pseudorange / rate, bank_demo, float64", ops,
      LOC64_TOL, checks=checks, reps=reps)
  rows.append(row)
  out_k = gs.generic_bank_scan_mixed(*args32, **mixed_kw(call, eas32))
  out_p = gs.generic_bank_scan_mixed_reference(*args32,
                                               **mixed_kw(call, eas32))
  e = lane_errs(out_k, out_p, call.spec)
  ms32, _ = timed_run(lambda: gs.generic_bank_scan_mixed(
      *args32, **mixed_kw(call, eas32)), reps)
  log(f"generic_bank_scan_mixed [loc B={B} T={T}, bank_demo, float32, the "
      f"example's variant]: kernel {ms32:.4f} ms wrapped, vs plain max "
      f"{float(e.max()):.4g} sigma, median {float(e.median()):.4g} "
      "(printed, not held: float32 at ECEF scale)")
  raw(name, call, torch.float32, args32, eas32, ki)
  raw(name + ", float64", call, torch.float64, args64, eas64, ki)

  # kernel 6 with frames on msckf_eskf, float64: run_msckf_bank's data
  name = "run_msckf_bank run_mixed (kernel 6 with frames)"
  call = calls[name][0]
  _, xs, kinds, kind_idx, zs, eas, pos = mb.data()
  T = kind_idx.shape[0]
  f64 = dict(dtype=torch.float64, device=dev)
  ki = torch.as_tensor(kind_idx, dtype=torch.int32, device=dev)
  eas_m = torch.as_tensor(eas, **f64).transpose(1, 2).contiguous()
  args = (*bank0(MSCKFEskf, xs, torch.float64),
          torch.as_tensor(zs, **f64).transpose(1, 2).contiguous(),
          torch.full((T,), mb.DT, **f64), ki)
  row, _, out_p = kernel_vs_plain(
      "generic_bank_scan_mixed", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:250", call.spec,
      gs.generic_bank_scan_mixed, gs.generic_bank_scan_mixed_reference,
      args, mixed_kw(call, eas_m),
      f"msckf_eskf B={mb.B} T={T} frames + fixes, run_msckf_bank, float64",
      step_ops(call.counting_source(), kinds, "mixed") * T * mb.B,
      MSCKF64_TOL, checks=checks, reps=reps)
  rows.append(row)
  raw(name, call, torch.float64, args, eas_m, ki)

  # kernel 7 at T = 1 from there: the late frame
  name = "run_msckf_bank observe_frame (kernel 7)"
  call = calls[name][0]
  spec = call.spec
  z = torch.as_tensor(mb.frame_obs(spec, pos + 1.5 * mb.TRUTH_V * mb.DT),
                      **f64)
  zs7 = z[None, :, None].repeat(1, 1, mb.B)
  eas7 = torch.as_tensor(mb.LANDMARK, **f64)[None, :, None].repeat(
      1, 1, mb.B)
  dts7 = torch.full((1,), 0.5 * mb.DT, **f64)
  row, _, _ = kernel_vs_plain(
      "vo_bank_scan", "rednose_tpu_torch/csrc/generic_scan.cuh",
      "rednose_tpu/ops/pallas_bank.py:755", spec, gs.vo_bank_scan,
      gs.vo_bank_scan_reference, (*out_p, zs7, eas7, dts7),
      dict(spec=spec, kind=call.kinds[0], Q=call.Q, R=call.R_list[0],
           structure=call.structure),
      f"msckf_eskf B={mb.B} T=1 late frame, run_msckf_bank, float64",
      step_ops(call.counting_source(), call.kinds) * mb.B, MSCKF64_TOL,
      checks=checks, reps=20)
  rows.append(row)
  src = call.source(torch.float64)
  x1, P1 = out_p
  ms = timed_run(generic_launch(src, call, x1, P1, zs7, dts7, eas7), 20)[0]
  log(variant_line(name, _build.generated_info(src), mb.B, {1: ms}).split(
      "; raw launches")[0] + f"; raw launch B={mb.B} T=1 {ms:.4f} ms")
  bad = [name for name, ok in checks if not ok]
  require(not bad, f"the examples' variants agree with their plain "
          f"versions: {bad}")

  # kernel 3 at run_mixed_bank's shape, B = 512 (16 tiles on 132 SMs),
  # from its bank's first state on its data: timed, not held (float32
  # from the 10-rad attitude prior; see compare_kernels)
  from rednose_tpu_torch.examples import run_mixed_bank as rb
  from rednose_tpu_torch.models.live import LiveKalman
  from rednose_tpu_torch.ops import live_scan
  from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank

  bank = LiveKalmanBank(batch=rb.B, device=dev)
  f32 = dict(dtype=torch.float32, device=dev)
  kind_idx, zs = rb.data()
  zs = torch.as_tensor(zs, **f32).permute(0, 2, 1).contiguous()
  dts = torch.full((rb.T,), 0.01, **f32)
  ki = torch.as_tensor(kind_idx, dtype=torch.int32, device=dev)
  R = torch.stack([torch.as_tensor(LiveKalman.obs_noise[k], **f32)
                   for k in rb.KINDS])
  args = (bank._x, bank._P, zs, dts, ki, rb.KINDS, R, bank._q_diag)
  ms, out = timed_run(lambda: live_scan.live_bank_scan_mixed(*args), reps)
  raw = {n: timed_run(kernel3_launch(
      _build.library(), bank._x, bank._P, zs[:n], dts[:n], ki[:n], rb.KINDS,
      R, bank._q_diag), 20 if n == 1 else 5)[0] for n in (rb.T, 1)}
  ops = hand_kernel_ops(bank.spec)["live_bank_scan_mixed"] * rb.B * rb.T
  bound_ms, bound_by = bound(io_bytes([args, out], 4), ops)
  log(f"live_bank_scan_mixed [run_mixed_bank B={rb.B} T={rb.T}, 4 kinds]: "
      f"kernel {ms:.4f} ms wrapped, raw T={rb.T} {raw[rb.T]:.4f} ms, T=1 "
      f"{raw[1]:.4f} ms; bound {bound_ms:.4g} ms ({bound_by})")
  return rows


def profiler_phase(torch, dev):
  """utils/profiling on the card: a trace (CPU and CUDA activity) around
  run_mixed_bank's main and 20 LiveKalman.predict_and_observe calls,
  written into build/chip_smoke_trace and read back: kernel 3's CUDA
  kernel and the live step's predict and update scopes (core/step.py)
  must be in it. Then finite_or_nan_flag on a bank's state under CUDA's
  sync debug mode set to raise: no host sync inside it."""
  import glob
  import shutil

  from rednose_tpu_torch import _build
  from rednose_tpu_torch.examples import run_mixed_bank
  from rednose_tpu_torch.models.live import LiveKalman, ObservationKind as K
  from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank
  from rednose_tpu_torch.utils import profiling

  logdir = _build.BUILD_DIR.parent / "chip_smoke_trace"
  shutil.rmtree(logdir, ignore_errors=True)
  kf = LiveKalman(device=dev)
  rng = np.random.RandomState(SEED + 11)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  with profiling.trace(str(logdir)):
    run_mixed_bank.main(device=str(dev))
    for i in range(20):
      kf.predict_and_observe(0.1 * (i + 1), K.ECEF_POS, [
          LiveKalman.initial_x[0:3] + rng.normal(0, 1.0, 3)])
    torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) * 1e3
  files = glob.glob(str(logdir / "*.pt.trace.json"))
  require(len(files) == 1, f"the profiler wrote one trace: {files}")
  with open(files[0]) as f:
    events = json.load(f)["traceEvents"]
  names = {e.get("name", "") for e in events}
  k3 = sorted({e["name"] for e in events if e.get("cat") == "kernel"
               and "live_bank_scan_mixed_kernel" in e.get("name", "")})
  updates = sorted(n for n in names if n.startswith("rednose/live/update_"))
  n_kernels = sum(e.get("cat") == "kernel" for e in events)
  log(f"profiler trace ({ms:.1f} ms with the profiler on, host clock): "
      f"{len(events)} events, {n_kernels} CUDA kernel events; kernel 3 "
      f"{k3}; scopes rednose/live/predict "
      f"{'rednose/live/predict' in names}, {updates}")
  require(k3, "kernel 3's CUDA kernel is in the trace")
  require("rednose/live/predict" in names and updates,
          "the live step's predict and update scopes are in the trace")
  bank = LiveKalmanBank(batch=run_mixed_bank.B, device=dev)
  kind_idx, zs = run_mixed_bank.data()
  bank.run_mixed(np.full(run_mixed_bank.T, 0.01), kind_idx, zs,
                 run_mixed_bank.KINDS)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    flag = profiling.finite_or_nan_flag({"x": bank._x, "P": bank._P})
  finally:
    torch.cuda.set_sync_debug_mode("default")
  require(flag.is_cuda and flag.shape == () and bool(flag),
          "finite_or_nan_flag: a finite bank, flagged on the card")
  log("finite_or_nan_flag on the bank state: True, a 0-d tensor on the "
      "card, no host sync inside it (sync debug mode 'error')")


def full_q_stream_path(torch, dev, gen):
  """Phase 1, the full-Q live bank with streamed R: LiveKalmanBank(batch=
  LIVE_B, Q=full_q()) in float64, run_mixed over FQ_T steps of the 4-kind
  cycle with the camera rotation's per-step variances streamed (r_stream,
  the noise each camera-odometry measurement carries): the plain full-Q
  slab on the card, the JAX reference's own route, and no kernel. Held
  against the same call on the CPU on the first STREAM_CPU_B lanes within
  LIVE64_TOL sigma, and healthy as the offline path's bank."""
  from rednose_tpu_torch.models.live import (
      LiveKalman,
      ObservationKind as K,
      build_live_spec,
  )
  from rednose_tpu_torch.runtime.live_bank import LiveKalmanBank

  kinds, kind_idx, zs = mixed_schedule(torch, dev, gen, FQ_T)
  r_stream = ((0.05 + 0.01 * torch.rand((FQ_T, 3), generator=gen,
                                        device=dev)) ** 2).double().cpu()
  kw = dict(r_stream=r_stream.numpy(), stream_kinds=(K.CAMERA_ODO_ROTATION,))
  dts = np.full(FQ_T, 0.01)
  bank = LiveKalmanBank(batch=LIVE_B, Q=full_q(), dtype=torch.float64,
                        device=dev)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  bank.run_mixed(dts, kind_idx, zs.double(), kinds, **kw)
  torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) * 1e3
  n = STREAM_CPU_B
  cpu = LiveKalmanBank(batch=n, Q=full_q(), dtype=torch.float64,
                       device="cpu")
  cpu.run_mixed(dts, kind_idx, zs[:, :n].double().cpu(), kinds, **kw)
  e = float(lane_errs((bank._x[:, :n].cpu(), bank._P[..., :n].cpu()),
                      (cpu._x, cpu._P), build_live_spec()).max())
  require(e <= LIVE64_TOL, f"the card's full-Q streamed-R bank agrees with "
          f"the CPU's: {e:.4g} sigma")
  require(bool(torch.isfinite(bank._x).all()
               and torch.isfinite(bank._P).all()), "streamed-R bank finite")
  require(torch.equal(bank._P, bank._P.transpose(0, 1)),
          "streamed-R bank P symmetric")
  require(int(bank.diverged().sum()) == 0,
          "streamed-R bank: no diverged lane")
  pos = torch.as_tensor(LiveKalman.initial_x[0:3], **dict(
      dtype=torch.float64, device=dev))
  sd = torch.diagonal(bank._P, dim1=0, dim2=1)[:, 0:3].sqrt()
  err = (bank._x[0:3] - pos[:, None]).abs().T
  require(bool((err < 8.0 * sd + 5.0).all()),
          "the streamed-R bank keeps the position")
  log(f"full-Q live bank with streamed R (camera rotation), B={LIVE_B}, "
      f"float64: run_mixed T={FQ_T} {ms:.1f} ms (host clock, plain full-Q "
      f"slab on the card); first {n} lanes against the CPU {e:.4g} sigma "
      f"(tolerance {LIVE64_TOL}); position sigma {float(sd.mean()):.4g} m, "
      f"max error {float(err.max()):.4g} m")
  return {}


# ------------------------------------------------------------- user specs

@functools.lru_cache(maxsize=None)
def user_setups():
  """name -> (spec, x0, P_diag, Q, obs_noise) of each user spec the path
  runs (one spec object each, so its variants are emitted once)."""
  from rednose_tpu_torch.models import user_specs as us

  out = {}
  for seed, dim, dz in USER_RANDOM:
    spec, x0, P_diag, Q, R = us.random_setup(seed, dim, dz)
    out[spec.name] = (spec, x0, P_diag, Q, {1: R})
  out["battery"] = (us.battery_spec(), us.BATTERY_X0, us.BATTERY_P_DIAG,
                    us.BATTERY_Q, us.BATTERY_R)
  return out


def user_calls():
  """name -> the KernelCall of each variant the user-spec path launches,
  as KalmanBank makes it."""
  from rednose_tpu_torch.models import user_specs as us
  from rednose_tpu_torch.ops import generic_scan as gs, sparsity

  calls = {}
  for name, (spec, x0, _, Q, noise) in user_setups().items():
    st = sparsity.structure_for(spec, x0)
    if name != "battery":
      calls[f"{name} run / observe (kernel 4)"] = gs.KernelCall(
          spec, "single", (1,), Q=Q, R_list=(noise[1],), structure=st)
      continue
    for label, mode, kinds in (
        ("run_mixed (kernel 6)", "mixed", us.BATTERY_KINDS),
        ("run_epochs (kernel 5)", "epoch", us.BATTERY_SLOTS)):
      calls[f"battery {label}"] = gs.KernelCall(
          spec, mode, kinds, Q=Q, R_list=[noise[k] for k in kinds],
          structure=st)
  return calls


def user_anchored(torch, spec, kinds, xs, R, rng):
  """Measurements (n, .., B, 3), rows padded, and anchors (n, .., B, 3)
  of the battery's kinds[i] at states xs[i] (n, .., B, 8): a range to an
  anchor about 50 m from the lane, no anchor for the others."""
  from rednose_tpu_torch.models import user_specs as us

  zs, eas = torch.zeros_like(xs[..., :3]), torch.zeros_like(xs[..., :3])
  for k in set(kinds):
    rows = [i for i, kk in enumerate(kinds) if kk == k]
    ea = None
    if k == us.RANGE:
      ea = eas[rows] = xs[rows, ..., :3] + torch.as_tensor(
          50.0 * rng.randn(*xs[rows].shape[:-1], 3), dtype=xs.dtype,
          device=xs.device)
    z = us.measure(spec, k, xs[rows], R[k], rng, ea)
    zs[rows, ..., :z.shape[-1]] = z
  return zs, eas


def user_spec_path(torch, dev):
  """Phase 1, user specs: KalmanBank(spec=...) as a user calls it, on the
  random specs (run, observe) and the battery (run_mixed, run_epochs).
  Returns, per variant of user_calls(), the bank's state after its run
  and CMP_T steps of new consistent data for the comparison."""
  from rednose_tpu_torch.models import user_specs as us
  from rednose_tpu_torch.runtime.generic_bank import KalmanBank

  rng = np.random.RandomState(SEED + 11)
  B, T, dt = GEN_B, USER_T, USER_DT
  f64 = dict(dtype=torch.float64, device=dev)
  out = {}

  def healthy(name, bank, truth, held=True):
    torch.cuda.synchronize()
    require(bool(torch.isfinite(bank._x).all()
                 and torch.isfinite(bank._P).all()), f"{name} finite")
    require(torch.equal(bank._P, bank._P.transpose(0, 1)),
            f"{name} P symmetric")
    require(int(bank.diverged().sum()) == 0, f"{name}: no diverged lane")
    sd = torch.diagonal(bank._P, dim1=0, dim2=1).T.double().sqrt()
    far = ((bank._x.double() - truth.T).abs() / sd).max(dim=0).values
    share = float((far <= USER_FAR).double().mean())
    log(f"  {name}: {share:.6f} of lanes within {USER_FAR} sigmas of their "
        f"truth in every component (median lane's worst component "
        f"{float(far.median()):.4g} sigmas)")
    require(share >= USER_TRACK or not held,
            f"{name}: at least {USER_TRACK} of the lanes track their truth")

  def cmp_truth(spec, x, Q, n=CMP_T):
    """n steps of a truth from each lane's estimate x (dim_x, B)."""
    return us.simulate(spec, x.T.double(), Q, n, dt, rng, dev)[1:]

  def quiet(R):
    return {k: USER_CMP_NOISE**2 * np.asarray(r) for k, r in R.items()}

  def timed(fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3

  calls = user_calls()
  for name, (spec, x0, P_diag, Q, noise) in user_setups().items():
    battery = name == "battery"
    n = 2 * T if battery else T + USER_OBS
    # the battery's truths start 2 m, 0.1 rad, 0.1 m/s and 0.01 rad/s
    # apart: their headings stay off the wrap at 0 / 2 pi
    spread = (np.r_[2.0 * np.ones(3), 0.1, 0.1, 0.01 * np.ones(3)]
              if battery else 0.3)
    truth0 = x0 + spread * rng.randn(B, spec.dim_x)
    t0 = time.perf_counter()
    truth = us.simulate(spec, truth0, Q, n, dt, rng, dev)
    est0 = truth0 + np.sqrt(P_diag) * rng.randn(B, spec.dim_x)
    bank = KalmanBank(spec=spec, x0=est0, P_diag=P_diag, Q=Q,
                      obs_noise=noise, batch=B, device=dev)
    prior = (bank._x, bank._P)   # the runs replace them, never write them
    log(f"user spec {name} (dim {spec.dim_x}), B={B}: truth of {n} "
        f"steps in {time.perf_counter() - t0:.1f} s (host clock)")
    dts = np.full(T, dt)
    if not battery:
      R = noise[1]
      zs = us.measure(spec, 1, truth[1:T + 1], R, rng)
      ms = timed(lambda: bank.run(dts, zs, 1))
      healthy(f"{name} after run", bank, truth[T], held=False)
      t_base = bank.t
      t1 = time.perf_counter()
      for i in (1, 2, 3, 5, 6, 4, 7, 8):          # the 4th is late
        z = us.measure(spec, 1, truth[T + i], R, rng).cpu().numpy()
        require(bank.observe(t_base + dt * i, 1, z) is not None,
                f"{name} observe {i} applied")
      torch.cuda.synchronize()
      ms_obs = (time.perf_counter() - t1) * 1e3
      require(abs(bank.t - (t_base + USER_OBS * dt)) < 1e-9,
              f"{name} bank time after observe")
      require(bank.observe(t_base - 5.0, 1, z) is None,
              f"{name}: a too-old observation is dropped")
      healthy(f"{name} after observe", bank, truth[n], held=False)
      log(f"user spec {name}: run T={T} {ms:.3f} ms, then {USER_OBS} "
          f"observe calls {ms_obs:.3f} ms (host clock, first calls)")
      zc = us.measure(spec, 1, cmp_truth(spec, prior[0], Q, USER_RAND_CMP_T),
                      quiet(noise)[1], rng)
      out[f"{name} run / observe (kernel 4)"] = dict(
          x=prior[0], P=prior[1], zs=zc.transpose(1, 2).contiguous(),
          eas=None, ki=None)
      continue
    kinds, slots = us.BATTERY_KINDS, us.BATTERY_SLOTS
    ki = np.arange(T) % len(kinds)
    sched = [kinds[i] for i in ki]
    zs, eas = user_anchored(torch, spec, sched, truth[1:T + 1], noise, rng)
    ms = timed(lambda: bank.run_mixed(dts, ki, zs, kinds, eas=eas))
    healthy("battery after run_mixed", bank, truth[T])
    x_mixed, P_mixed = bank._x, bank._P
    zc, ec = user_anchored(torch, spec, [kinds[i % 3] for i in range(CMP_T)],
                           cmp_truth(spec, x_mixed, Q), quiet(noise), rng)
    out["battery run_mixed (kernel 6)"] = dict(
        x=x_mixed, P=P_mixed, zs=zc.transpose(1, 2).contiguous(),
        eas=ec.transpose(1, 2).contiguous(),
        ki=torch.as_tensor(np.arange(CMP_T) % 3, dtype=torch.int32,
                           device=dev))
    # an epoch's slots along the first axis, then back behind time
    ep = truth[None, T + 1:2 * T + 1].expand(len(slots), -1, -1, -1)
    zs, eas = (a.transpose(0, 1) for a in user_anchored(
        torch, spec, slots, ep, noise, rng))
    ms_e = timed(lambda: bank.run_epochs(dts, zs, slots, eas=eas))
    healthy("battery after run_epochs", bank, truth[2 * T])
    log(f"user spec battery: run_mixed T={T} over kinds {kinds} {ms:.3f} "
        f"ms, run_epochs T={T} of slots {slots} {ms_e:.3f} ms (host clock, "
        f"first calls)")
    ep = cmp_truth(spec, bank._x, Q)[None].expand(len(slots), -1, -1, -1)
    zc, ec = (a.transpose(0, 1) for a in user_anchored(
        torch, spec, slots, ep, quiet(noise), rng))
    out["battery run_epochs (kernel 5)"] = dict(
        x=bank._x, P=bank._P, zs=zc.transpose(-1, -2).contiguous(),
        eas=ec.transpose(-1, -2).contiguous(), ki=None)
    del truth
  require(set(out) == set(calls), "every user-spec variant ran")
  return out


def compare_user_specs(torch, dev, states, reps=5):
  """Phase 2, user specs: each variant of user_calls() against its plain
  version from the main path's state on its new data (user_spec_path),
  float32 at GEN_TOL and the double build at USER64_TOL, planted faults
  beyond it with no extra build; its nvcc time, registers and spills, its
  launch shape and raw-launch times at its T and at T = 1, and its
  bound."""
  import re

  from rednose_tpu_torch import _build
  from rednose_tpu_torch.ops import generic_scan as gs

  fns = {"single": (gs.generic_bank_scan, gs.generic_bank_scan_reference),
         "mixed": (gs.generic_bank_scan_mixed,
                   gs.generic_bank_scan_mixed_reference),
         "epoch": (gs.generic_bank_scan_epoch,
                   gs.generic_bank_scan_epoch_reference)}
  checks = []
  for name, call in user_calls().items():
    st, spec, mode = states[name], call.spec, call.mode
    kernel, plain = fns[mode]
    kinds = {"single": "kind", "mixed": "kinds", "epoch": "slot_kinds"}[mode]
    Rs = ({"R": call.R_list[0]} if mode == "single"
          else {"R_list": call.R_list})

    def kw_of(Q, R_kw, dtype):
      kw = dict(spec=spec, Q=Q, structure=call.structure, **R_kw)
      kw[kinds] = call.kinds[0] if mode == "single" else call.kinds
      if st["eas"] is not None:
        kw["eas"] = st["eas"].to(dtype)
      return kw

    T = st["zs"].shape[0]

    def args_of(dtype):
      dts = torch.full((T,), USER_DT, dtype=dtype, device=dev)
      a = (st["x"].to(dtype), st["P"].to(dtype), st["zs"].to(dtype), dts)
      return a if st["ki"] is None else a + (st["ki"],)

    ops = step_ops(call.counting_source(), call.kinds, mode) * T * GEN_B
    for dtype in (torch.float32, torch.float64):
      src = call.source(dtype)
      ptx = _build.generated_ptxas(src)
      regs = re.findall(r"Used (\d+) registers", ptx)
      spill = re.findall(r"(\d+) bytes spill stores", ptx)
      wall = re.findall(r"nvcc wall time ([\d.]+) s", ptx)
      log(f"user spec {name} [{str(dtype).split('.')[-1]}]: "
          f"{len(src.splitlines())} emitted lines, nvcc {wall[-1]} s "
          f"(beside the others), registers {regs}, spill stores {spill}")
    args32 = args_of(torch.float32)
    kernel_vs_plain(kernel.__name__, "", "", spec, kernel, plain, args32,
                    kw_of(call.Q, Rs, torch.float32),
                    f"user spec {name} B={GEN_B} T={T}, float32", ops,
                    checks=checks, reps=reps)
    src = call.source(torch.float32)
    kw32 = kw_of(call.Q, Rs, torch.float32)
    raw = {n: timed_run(generic_launch(
        src, call, args32[0], args32[1], args32[2][:n], args32[3][:n],
        eas=None if st["eas"] is None else kw32["eas"][:n],
        kind_idx=None if st["ki"] is None else st["ki"][:n]),
        20 if n == 1 else 5)[0] for n in (T, 1)}
    log(variant_line(f"user spec {name}", _build.generated_info(src),
                     GEN_B, raw))
    args64 = args_of(torch.float64)
    _, _, ref64 = kernel_vs_plain(
        kernel.__name__, "", "", spec, kernel, plain, args64,
        kw_of(call.Q, Rs, torch.float64),
        f"user spec {name} B={GEN_B} T={T}, float64", ops,
        tol=USER64_TOL, checks=checks, reps=reps)
    builds = _build.generated_launcher.cache_info().currsize
    faults = {"Q dropped": (call.Q * 1e-9, Rs)}
    for u, k in enumerate(call.kinds):
      Rf = [R * (1e12 if j == u else 1.0) for j, R in enumerate(call.R_list)]
      faults[f"unit {u} (kind {k}) left out"] = (
          call.Q, {"R": Rf[0]} if mode == "single" else {"R_list": Rf})
    miss = {f: float(lane_errs(kernel(*args64, **kw_of(
        Q, R_kw, torch.float64)), ref64, spec).max())
            for f, (Q, R_kw) in faults.items()}
    least = min(miss, key=miss.get)
    ok = (miss[least] > USER64_TOL
          and _build.generated_launcher.cache_info().currsize == builds)
    log(f"{kernel.__name__} planted faults [user spec {name}, float64]: "
        f"{len(miss)} faults, the least visible ({least}) at "
        f"{miss[least]:.4g} sigma, must exceed {USER64_TOL}, with no extra "
        f"build -> {'ok' if ok else 'FAIL'}")
    checks.append((f"user spec {name} planted faults beyond the limit", ok))
  bad = [name for name, ok in checks if not ok]
  require(not bad, f"the user-spec kernels agree with their plain versions "
                   f"and the planted faults show: {bad}")


def flops_report_phase(card, rows):
  """Write this run's kernel times (every row: name, shape, wrapped ms,
  plain ms, bound ms) to build/chip_smoke_times.json with the card's line,
  and run tools/flops_report on them; its lines are logged."""
  import pathlib

  root = pathlib.Path(__file__).resolve().parent
  path = root / "build" / "chip_smoke_times.json"
  path.parent.mkdir(parents=True, exist_ok=True)
  with open(path, "w") as f:
    json.dump({"card": card, "rows": [
        {k: r[k] for k in ("name", "shape", "ms", "plain_ms", "bound_ms")}
        for r in rows]}, f, indent=1)
  rep = subprocess.run(
      [sys.executable, "-m", "rednose_tpu_torch.tools.flops_report",
       "--times", str(path)], cwd=root, capture_output=True, text=True,
      timeout=600)
  for line in rep.stdout.splitlines():
    log(f"  flops_report: {line}")
  require(rep.returncode == 0 and "sustained on" in rep.stdout,
          f"tools/flops_report ran on this run's times: {rep.stderr[-2000:]}")


def main():
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
          file=sys.stderr)
    return 1
  from concurrent.futures import ThreadPoolExecutor

  from rednose_tpu_torch import _build
  from rednose_tpu_torch.msckf import triangulation
  from rednose_tpu_torch.ops import generic_scan, kinematic_scan, live_scan
  from rednose_tpu_torch.runtime import scan

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  card = card_line()
  log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
  dev = torch.device("cuda", 0)
  # csrc/*.cu in a thread; each emitted variant's nvcc starts once its
  # source is emitted, at most NVCC_JOBS at once, so that the emitting
  # thread keeps a core of its own; kernel 10's first (its nvcc is the
  # longest)
  t0 = time.perf_counter()
  nvcc_jobs = max(1, (os.cpu_count() or 2) - 1)
  with ThreadPoolExecutor(1) as pool, ThreadPoolExecutor(nvcc_jobs) as nvcc:
    static = pool.submit(_build.build)
    started = {}

    def start(group):
      """Start nvcc on each source of group (name -> source) not started
      yet; returns group."""
      for src in group.values():
        if src not in started:
          started[src] = nvcc.submit(_build.build_generated_many, [src])
      return group

    # kernel 10: the tenth path's variant; the comparison's and the ML
    # tuning's below
    adj = adjoint_calls()
    path_adjoint = "live log adjoint (kernel 10)"
    adj_sources = start({name: call.source(dtype)
                         for name, (call, dtype) in adj.items()})
    live_spec = generic_models()[3]
    ex_calls = example_calls(torch, dev)
    u_calls = user_calls()
    sources = (start(generic_sources(live_spec)) | start(msckf_sources())
               | start(vio_sources())
               | start({f"examples: {name}": call.source(dtype)
                        for name, (call, dtype) in ex_calls.items()})
               | start({f"user specs: {name}": call.source()
                        for name, call in u_calls.items()})
               | start({name: call.source(dtype)
                        for name, (call, dtype) in stream_calls().items()}))
    sources[path_adjoint] = adj_sources[path_adjoint]
    # the comparison phase's own variants: kernels 5, 6 and 7 in double,
    # and the camera-frame variants' global form (tile_vs_global)
    cmp_sources = {name: src for name, src in adj_sources.items()
                   if name != path_adjoint}
    cmp_sources |= {"loc run_epochs, float64 (kernel 5)":
                    loc_epoch_call().source(torch.float64),
                    "live run_mixed, float64 (kernel 6)":
                    live_mixed_call().source(torch.float64),
                    "live full Q run_mixed, float64 (kernel 6)":
                    full_q_calls()["live full Q run_mixed / observe "
                                   "(kernel 6)"].source(torch.float64)}
    cmp_sources |= {name: c.source()
                    for name, c in full_q_cmp_calls().items()}
    cmp_sources["examples: run_loc bank_demo, float64 (kernel 6, loc)"] = \
        ex_calls["run_loc bank_demo (kernel 6, loc)"][0].source(torch.float64)
    cmp_sources |= {f"user specs: {name}, float64": call.source(torch.float64)
                    for name, call in u_calls.items()}
    live_log_call = stream_calls()["live log scan (kernel 9)"][0]
    cmp_sources["live log scan (kernel 9), float64"] = live_log_call.source(
        torch.float64)
    for dtype in (torch.float32, torch.float64):
      cmp_sources[f"live log scan (kernel 9), "
                  f"{str(dtype).split('.')[-1]} global form"] = \
          live_log_call.source(dtype, tile=False)
    start(cmp_sources)
    for model in msckf_models():
      for name, call in (("run_frames", msckf_call(model)),
                         ("run_mixed with frames", vio_call(model))):
        kernel = "kernel 7" if call.mode == "frame" else "kernel 6"
        cmp_sources[f"{model.name} {name}, float64 ({kernel})"] = \
            call.source(torch.float64)
        cmp_sources[f"{model.name} {name}, global form ({kernel})"] = \
            call.source(tile=False)
        if is_tile(call.source(torch.float64)):
          cmp_sources[f"{model.name} {name}, float64 global form "
                      f"({kernel})"] = call.source(torch.float64, tile=False)
        start(cmp_sources)
    t_emit = time.perf_counter() - t0
    for build in started.values():
      build.result()
    lib = static.result()
  log(f"kernels built in {time.perf_counter() - t0:.1f} s (emitting the "
      f"{len(sources) + len(cmp_sources)} generic variants took "
      f"{t_emit:.1f} s): {lib.name}")
  for line in _build.ptxas_report().splitlines():
    if "registers" in line or "spill" in line or "Compiling" in line:
      log(f"  ptxas: {line.strip()}")
  for name, src in (sources | cmp_sources).items():
    log(f"  emitted, {name}: {len(src.splitlines())} lines")
    for line in _build.generated_ptxas(src).splitlines():
      if "registers" in line or "spill" in line or "nvcc" in line:
        log(f"  ptxas, {name}: {line.strip()}")

  gens = []
  for i in range(7):
    # each path draws from a generator of its own, so a path sees the same
    # data whether or not the others run
    gens.append(torch.Generator(device=dev))
    gens[-1].manual_seed(SEED + i)
  k, g = kinematic_scan, generic_scan
  paths = (
      ("kinematic and live", lambda: main_path(torch, dev, gens[0]),
       (k.kinematic_bank_scan, live_scan.live_bank_scan,
        live_scan.live_bank_scan_mixed)),
      ("generic bank", lambda: generic_main_path(torch, dev, gens[1]),
       (g.generic_bank_scan, g.generic_bank_scan_epoch,
        g.generic_bank_scan_mixed)),
      ("MSCKF bank", lambda: msckf_main_path(torch, dev, gens[2]),
       (g.vo_bank_scan, g.generic_bank_scan)),
      # the VIO path launches kernel 6 (camera-frame branch) and kernel 8
      # (the store's and the pipeline's triangulations) and no other
      ("VIO", lambda: vio_main_path(torch, dev, gens[3]),
       (g.generic_bank_scan_mixed, triangulation.compute_pos_batch)),
      # the full-Q live bank runs kernels 4 and 6, never 2 and 3; the log
      # scan kernel 9; the smoother and the front end run plain torch on
      # the card
      ("offline smoother and migration",
       lambda: offline_path(torch, dev, gens[4]),
       (g.generic_bank_scan, g.generic_bank_scan_mixed,
        g.stream_bank_scan)),
      # a full Q with streamed R runs the plain full-Q slab: no kernel
      ("full-Q streamed R", lambda: full_q_stream_path(torch, dev, gens[5]),
       ()),
  )
  # kernel 10 runs on the tenth path only
  wrappers = {w for _, _, ws in paths for w in ws} | {
      g.stream_bank_scan_adjoint}
  launches, states = {w.__name__: 0 for w in wrappers}, []
  # the plain versions of kernels 8 and 9: on the main paths only the
  # offline path's F_lane / jacfwd timing runs the plain scan
  plains = {triangulation.compute_pos_batch_reference: 0,
            scan.build_scan_stream_reference: len(F_LANE_ORDER)}
  for p in plains:
    p.launches = 0
  for name, drive, expected in paths:
    for w in wrappers:
      w.launches = 0
    states.append(drive())
    counts = {w.__name__: w.launches for w in wrappers}
    log(f"{name} path launches: {counts}")
    require(all(counts[w.__name__] > 0 for w in expected),
            f"every kernel of the {name} path launched: {counts}")
    if name in ("VIO", "offline smoother and migration",
                "full-Q streamed R"):
      require(all(counts[w.__name__] == 0 for w in wrappers
                  if w not in expected),
              f"the {name} path launched only its kernels: {counts}")
    for w in wrappers:
      launches[w.__name__] += counts[w.__name__]
  # the seventh path: the ten examples, the counts zeroed around each
  examples_path(torch, dev, launches)
  # the eighth: the sharded bank, in this process and on two ranks
  t0 = time.perf_counter()
  counts = sharded_path(torch, dev, card, launches, sources)
  expected = {live_scan.live_bank_scan, g.generic_bank_scan,
              g.generic_bank_scan_epoch, g.generic_bank_scan_mixed,
              g.vo_bank_scan}
  require(set(counts) == {w.__name__ for w in expected},
          f"the sharded path launched kernels 2, 4, 5, 6 and 7 and no "
          f"other: {counts}")
  log(f"sharded path: {time.perf_counter() - t0:.1f} s (host clock), "
      f"{card}")
  # the ninth: user specs (KalmanBank(spec=...)) on kernels 4, 5 and 6
  t0 = time.perf_counter()
  for w in wrappers:
    w.launches = 0
  user_states = user_spec_path(torch, dev)
  counts = {w.__name__: w.launches for w in wrappers}
  log(f"user-spec path launches: {counts}; "
      f"{time.perf_counter() - t0:.1f} s (host clock)")
  expected = {g.generic_bank_scan, g.generic_bank_scan_epoch,
              g.generic_bank_scan_mixed}
  require(all(counts[w.__name__] > 0 for w in expected)
          and all(counts[w.__name__] == 0 for w in wrappers
                  if w not in expected),
          f"the user-spec path launched kernels 4, 5 and 6 and no other: "
          f"{counts}")
  for w in wrappers:
    launches[w.__name__] += counts[w.__name__]
  # the tenth: the gradient through the offline log, kernels 9 and 10
  t0 = time.perf_counter()
  for w in wrappers:
    w.launches = 0
  grad_path(torch, dev, gens[6])
  counts = {w.__name__: w.launches for w in wrappers}
  log(f"gradient path launches: {counts}; "
      f"{time.perf_counter() - t0:.1f} s (host clock)")
  expected = {g.stream_bank_scan: 1, g.stream_bank_scan_adjoint: 1}
  require(all(counts[w.__name__] == expected.get(w, 0) for w in wrappers),
          f"the gradient path launched kernel 9 once, kernel 10 once and no "
          f"other: {counts}")
  for w in wrappers:
    launches[w.__name__] += counts[w.__name__]
  require(_build.generated_launcher.cache_info().currsize
          == len(set(sources.values())),
          "the main paths loaded exactly the prebuilt generic variants")
  plain_runs = {p.__name__: p.launches for p in plains}
  log(f"plain versions of kernels 8 and 9 run on the main paths: "
      f"{plain_runs}")
  require(all(p.launches == n for p, n in plains.items()),
          f"no main path ran the plain version of kernel 8 or 9 (the plain "
          f"scan only in the F_lane timing): {plain_runs}")

  live_states, generic_states = states[:2]
  rows = compare_kernels(torch, dev, gens[0], live_states, live_spec)
  rows += compare_generic(torch, dev, gens[1], generic_states, live_states)
  rows += compare_full_q(torch, dev, gens[4], live_states)
  kernel_variants(torch, dev, gens[1], live_spec, generic_states)
  rows += compare_msckf(torch, dev, gens[2])
  rows += compare_vio(torch, dev, gens[3])
  rows += compare_triangulation(torch, states[3])
  rows += compare_scan(torch, dev, gens[4])
  rows += compare_scan_grad(torch, dev, gens[6])
  ml_tuning(torch, dev)
  compare_user_specs(torch, dev, user_states)
  example_rows = compare_examples(torch, dev)
  profiler_phase(torch, dev)
  flops_report_phase(card, rows + example_rows)
  # no one PyTorch call computes a fused T-step filter scan or a batch of
  # Gauss-Newton triangulations: library_ms null
  print(json.dumps({"kernels": [
      {k: r[k] for k in ("name", "route", "source", "replaces")}
      | {"launches": launches[r["name"]], "max_abs_err": r["max_abs_err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None} for r in rows]}))
  print(card_line())
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
